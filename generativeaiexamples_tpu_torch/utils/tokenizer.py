"""Tokenizers for the port: HF `tokenizer.json` and the hermetic bytes.

The port's own copy of generativeaiexamples_tpu's utils/tokenizer.py:
`HFTokenizer` (over `tokenizers`, imported when one is built),
`ByteTokenizer`, `StreamDetokenizer` and `load_tokenizer`, with its gate
for weights-only snapshots.
"""

from __future__ import annotations

import glob
import json
import logging
import os
from typing import Dict, List, Optional, Sequence

_LOG = logging.getLogger(__name__)


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


class HFTokenizer:
    """Wrapper over a HF `tokenizers.Tokenizer` (tokenizer.json)."""

    LLAMA3_EOS = ("<|eot_id|>", "<|end_of_text|>")

    def __init__(self, path: str):
        from tokenizers import Tokenizer

        f = path if path.endswith(".json") else os.path.join(path, "tokenizer.json")
        self.tk = Tokenizer.from_file(f)
        self.vocab_size = self.tk.get_vocab_size()
        self.bos_id = self._first_id(("<|begin_of_text|>", "<s>", "<bos>"))
        self.eos_id = self._first_id(self.LLAMA3_EOS + ("</s>", "<eos>"))
        # Every eos variant ends generation (Llama 3 emits <|eot_id|> or
        # <|end_of_text|> depending on context).
        self.eos_ids = {i for i in (
            self.tk.token_to_id(n) for n in
            self.LLAMA3_EOS + ("</s>", "<eos>")) if i is not None}
        self.pad_id = self._first_id(("<pad>", "<|finetune_right_pad_id|>")) or 0
        # BERT-style specials (embedder/reranker tokenizers)
        self.cls_id = self._first_id(("[CLS]",))
        self.sep_id = self._first_id(("[SEP]",))

    def _first_id(self, names) -> Optional[int]:
        for n in names:
            i = self.tk.token_to_id(n)
            if i is not None:
                return i
        return None

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = self.tk.encode(text, add_special_tokens=False).ids
        if add_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return self.tk.decode(list(ids), skip_special_tokens=True)

    def apply_chat_template(self, messages, add_generation_prompt=True) -> str:
        """Llama 3 instruct format."""
        out = ["<|begin_of_text|>"]
        for m in messages:
            out.append(f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
                       f"{m['content']}<|eot_id|>")
        if add_generation_prompt:
            out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        return "".join(out)


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


def load_tokenizer(name_or_path: str = "byte"):
    """"byte" (or "" / "test") -> ByteTokenizer; else the HF tokenizer of
    a snapshot directory or a tokenizer.json file. A directory with model
    weights but no tokenizer.json falls back to the byte tokenizer only
    when its config.json's vocab_size is at most 512 (a byte-sized
    vocabulary) or GAIE_BYTE_TOKENIZER_FALLBACK=1; otherwise it raises,
    as does a path with neither a tokenizer nor weights."""
    if name_or_path in ("", "byte", "test"):
        return ByteTokenizer()
    f = (name_or_path if name_or_path.endswith(".json")
         else os.path.join(name_or_path, "tokenizer.json"))
    if os.path.isfile(f):
        return HFTokenizer(name_or_path)
    has_weights = os.path.isdir(name_or_path) and (
        glob.glob(os.path.join(name_or_path, "*.safetensors"))
        or glob.glob(os.path.join(name_or_path, "*.bin")))
    if not has_weights:
        raise FileNotFoundError(
            f"no tokenizer.json under {name_or_path!r} (and no model "
            f"weights found there to justify a byte-tokenizer fallback)")
    # A real vocabulary served through the byte tokenizer would boot and
    # emit garbage text: gate on the checkpoint's own vocab_size, with an
    # explicit escape hatch.
    vocab = None
    cfg_path = os.path.join(name_or_path, "config.json")
    if os.path.isfile(cfg_path):
        try:
            with open(cfg_path) as fh:
                vocab = json.load(fh).get("vocab_size")
        except (OSError, ValueError):
            vocab = None
    byte_ok = vocab is not None and vocab <= 512
    if not byte_ok and os.environ.get("GAIE_BYTE_TOKENIZER_FALLBACK",
                                      "0") != "1":
        raise FileNotFoundError(
            f"no tokenizer.json under {name_or_path!r}, and its "
            f"config.json vocab_size ({vocab}) is not byte-compatible "
            f"(<= 512) — serving it through the byte tokenizer would "
            f"produce garbage text. Provide the tokenizer, or set "
            f"GAIE_BYTE_TOKENIZER_FALLBACK=1 to override knowingly.")
    _LOG.warning("weights-only checkpoint %s has no tokenizer.json; using "
                 "the byte tokenizer (vocab_size=%s)", name_or_path, vocab)
    return ByteTokenizer()
