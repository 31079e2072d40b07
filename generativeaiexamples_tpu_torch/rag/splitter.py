"""Text splitters: token-window and recursive-character.

The port's copy of generativeaiexamples_tpu/rag/splitter.py: the
token-window splitter of the core pipelines' ingest path (chunk_size - 2
tokens, 200 overlap) with a dependency-free token counter, and the
recursive-character splitter (1000 / 100 characters) of the multimodal
pipeline.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence


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


class RecursiveCharacterSplitter:
    """LangChain-style recursive split on ["\\n\\n", "\\n", ". ", " ", ""]."""

    def __init__(self, chunk_size: int = 1000, chunk_overlap: int = 100,
                 separators: Optional[Sequence[str]] = None):
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.separators = list(separators or ["\n\n", "\n", ". ", " ", ""])

    def split(self, text: str) -> List[str]:
        return [c.strip() for c in self._split(text, 0) if c.strip()]

    def _split(self, text: str, depth: int) -> List[str]:
        if len(text) <= self.chunk_size:
            return [text]
        if depth >= len(self.separators):
            return self._window(text)
        sep = self.separators[depth]
        if sep == "":
            return self._window(text)
        parts = text.split(sep)
        chunks: List[str] = []
        cur = ""
        for part in parts:
            candidate = (cur + sep + part) if cur else part
            if len(candidate) <= self.chunk_size:
                cur = candidate
            else:
                if cur:
                    chunks.append(cur)
                if len(part) > self.chunk_size:
                    chunks.extend(self._split(part, depth + 1))
                    cur = ""
                else:
                    cur = part
        if cur:
            chunks.append(cur)
        return self._overlap(chunks, sep)

    def _window(self, text: str) -> List[str]:
        step = self.chunk_size - self.chunk_overlap
        return [text[i: i + self.chunk_size]
                for i in range(0, len(text), step)]

    def _overlap(self, chunks: List[str], sep: str) -> List[str]:
        if self.chunk_overlap <= 0 or len(chunks) < 2:
            return chunks
        out = [chunks[0]]
        for prev, cur in zip(chunks, chunks[1:]):
            tail = prev[-self.chunk_overlap:]
            cut = tail.find(sep)
            if 0 <= cut < len(tail) - 1:
                tail = tail[cut + len(sep):]
            out.append((tail + sep + cur) if tail else cur)
        return out


def get_text_splitter(config, tokenizer=None) -> TokenTextSplitter:
    """From AppConfig.text_splitter (parity: utils.py:321-331 — note the
    reference subtracts 2 from chunk_size for special tokens)."""
    return TokenTextSplitter(
        chunk_size=max(8, config.text_splitter.chunk_size - 2),
        chunk_overlap=config.text_splitter.chunk_overlap,
        tokenizer=tokenizer,
    )
