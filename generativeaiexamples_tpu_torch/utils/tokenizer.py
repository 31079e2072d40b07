"""Tokenizers for the port: the hermetic byte tokenizer.

The port's own copy of `ByteTokenizer`, `StreamDetokenizer` and the
"byte" branch of `load_tokenizer` from generativeaiexamples_tpu's
utils/tokenizer.py (the HF tokenizer comes with checkpoint loading,
ROADMAP A.10).
"""

from __future__ import annotations

from typing import Dict, List, Sequence


class ByteTokenizer:
    """Hermetic byte-level tokenizer: ids 0-255 are raw bytes, then
    specials. Lets the engine/server stack run with random models (no
    tokenizer.json, no network)."""

    def __init__(self, specials: Sequence[str] = ("<pad>", "<bos>", "<eos>")):
        self.specials = {s: 256 + i for i, s in enumerate(specials)}
        self.pad_id = self.specials.get("<pad>", 256)
        self.bos_id = self.specials.get("<bos>", 257)
        self.eos_id = self.specials.get("<eos>", 258)
        self.eos_ids = {self.eos_id}
        self.vocab_size = 256 + len(specials)

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8", errors="replace"))
        return ([self.bos_id] if add_bos else []) + ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if i < 256)
        return data.decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: Sequence[Dict[str, str]],
                            add_generation_prompt: bool = True) -> str:
        parts = [f"<|{m['role']}|>\n{m['content']}\n" for m in messages]
        if add_generation_prompt:
            parts.append("<|assistant|>\n")
        return "".join(parts)


class StreamDetokenizer:
    """Incremental detokenization for SSE streaming: emits only complete
    UTF-8 text, holding back bytes/tokens that might merge with the next
    token. O(1) amortized per token: only a bounded tail window of ids is
    ever re-decoded."""

    WINDOW = 16

    def __init__(self, tokenizer):
        self.tk = tokenizer
        self.window: List[int] = []
        self.prev = ""  # decode(window) as of the last emit

    def push(self, token_id: int) -> str:
        self.window.append(token_id)
        cur = self.tk.decode(self.window)
        if cur.endswith("�"):  # incomplete utf-8 tail; wait for more
            return ""
        new = cur[len(self.prev):]
        if len(self.window) > self.WINDOW:
            self.window = self.window[-4:]
            self.prev = self.tk.decode(self.window)
        else:
            self.prev = cur
        return new


def load_tokenizer(name: str = "byte"):
    """"byte" (or "" / "test") -> ByteTokenizer. HF tokenizers come with
    checkpoint loading (ROADMAP A.10)."""
    if name in ("", "byte", "test"):
        return ByteTokenizer()
    raise NotImplementedError(
        f"tokenizer {name!r}: only the byte tokenizer is ported; HF "
        f"tokenizers arrive with checkpoint loading (ROADMAP A.10)")
