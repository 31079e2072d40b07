"""Hermetic fake connectors: the chain server runs with no weights and no
network (model_engine echo / hash / overlap).

The port's copy of generativeaiexamples_tpu/connectors/fakes.py. They
stand in for the LLM, the embedder and the reranker only: the chain's
device (EngineHub) and a device store still resolve to CUDA unless the
caller asks for the CPU.
"""

from __future__ import annotations

import hashlib
import re
from typing import Iterator, Sequence

import numpy as np

from generativeaiexamples_tpu_torch.connectors.base import ChatBase, Message


class EchoLLM(ChatBase):
    """Deterministic text: replies describing the last user message.
    `script` can inject canned replies matched by substring — enough to
    drive agent pipelines (JSON tool calls) in tests."""

    def __init__(self, script=None, prefix: str = "ECHO: "):
        self.script = list(script or [])  # [(pattern, reply)]
        self.prefix = prefix
        self.calls: list = []

    def stream_chat(self, messages: Sequence[Message], *, temperature=0.2,
                    top_p=0.7, max_tokens=1024, stop=()) -> Iterator[str]:
        self.calls.append(list(messages))
        last = next((m["content"] for m in reversed(messages)
                     if m["role"] == "user"), "")
        for pat, reply in self.script:
            if pat in last or any(pat in m["content"] for m in messages):
                text = reply
                break
        else:
            text = f"{self.prefix}{last[:200]}"
        # stream in word pieces like a real engine
        for i, piece in enumerate(re.split(r"(\s+)", text)):
            if piece:
                yield piece


class HashEmbedder:
    """Deterministic embeddings with USEFUL geometry: bag-of-words hash
    projection, L2-normalized — texts sharing words are close, so
    retrieval tests exercise real ranking behavior."""

    def __init__(self, dim: int = 64):
        self.dim = dim

    def _vec(self, text: str) -> np.ndarray:
        v = np.zeros((self.dim,), np.float32)
        for w in re.findall(r"\w+", text.lower()):
            h = int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
            v[h % self.dim] += 1.0
        n = np.linalg.norm(v)
        return v / n if n else v

    def embed_documents(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self._vec(t) for t in texts]) if len(texts) else \
            np.zeros((0, self.dim), np.float32)

    def embed_query(self, text: str) -> np.ndarray:
        return self._vec(text)

    def embed_queries(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self._vec(t) for t in texts]) if len(texts) else \
            np.zeros((0, self.dim), np.float32)


class OverlapReranker:
    """Scores by word overlap — a monotone stand-in for a cross-encoder."""

    def score(self, query: str, passages: Sequence[str]) -> np.ndarray:
        qw = set(re.findall(r"\w+", query.lower()))
        out = []
        for p in passages:
            pw = set(re.findall(r"\w+", p.lower()))
            out.append(len(qw & pw) / max(len(qw | pw), 1))
        return np.asarray(out, np.float32)
