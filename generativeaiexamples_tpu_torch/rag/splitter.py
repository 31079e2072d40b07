"""Token-window text splitter with a dependency-free token counter.

The port's copy of `ApproxTokenizer`, `TokenTextSplitter` and
`get_text_splitter` from generativeaiexamples_tpu/rag/splitter.py (the
splitter of the developer_rag ingest path: chunk_size - 2 tokens, 200
overlap). The recursive-character splitter serves pipelines that are
not ported yet.
"""

from __future__ import annotations

import re
from typing import List, Sequence


class ApproxTokenizer:
    """Dependency-free token counter: ~GPT-style tokens via word/punct
    split; close enough for context budgeting when no tokenizer.json is
    available (hermetic tests, dev mode)."""

    _re = re.compile(r"\w+|[^\w\s]")

    def encode(self, text: str) -> List[str]:
        return self._re.findall(text)

    def decode(self, toks: Sequence[str]) -> str:
        out = ""
        for t in toks:
            if out and (t[0].isalnum() or t[0] == "_"):
                out += " "
            out += t
        return out


class TokenTextSplitter:
    """Split into chunks of <= chunk_size tokens with overlap, preferring
    sentence boundaries (reference behavior: token-window split)."""

    def __init__(self, chunk_size: int = 508, chunk_overlap: int = 200,
                 tokenizer=None):
        if chunk_overlap >= chunk_size:
            raise ValueError("chunk_overlap must be < chunk_size")
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.tk = tokenizer or ApproxTokenizer()

    def count(self, text: str) -> int:
        return len(self.tk.encode(text))

    def split(self, text: str) -> List[str]:
        ids = self.tk.encode(text)
        if not ids:
            return []
        step = self.chunk_size - self.chunk_overlap
        chunks = []
        for start in range(0, len(ids), step):
            window = ids[start: start + self.chunk_size]
            chunks.append(self.tk.decode(window).strip())
            if start + self.chunk_size >= len(ids):
                break
        return [c for c in chunks if c]


def get_text_splitter(config, tokenizer=None) -> TokenTextSplitter:
    """From AppConfig.text_splitter (parity: utils.py:321-331 — note the
    reference subtracts 2 from chunk_size for special tokens)."""
    return TokenTextSplitter(
        chunk_size=max(8, config.text_splitter.chunk_size - 2),
        chunk_overlap=config.text_splitter.chunk_overlap,
        tokenizer=tokenizer,
    )
