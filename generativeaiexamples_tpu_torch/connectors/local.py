"""In-process connectors: pipelines -> the port's engines, no HTTP hop.

The port's copy of generativeaiexamples_tpu/connectors/local.py: the
chat stream runs inside an `llm.local` span, and the engine's
`engine.generate` span is parented onto the caller's trace context.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

from generativeaiexamples_tpu_torch.connectors.base import ChatBase, Message
from generativeaiexamples_tpu_torch.obs.tracing import (
    current_context, traced_llm_stream)
from generativeaiexamples_tpu_torch.serving.openai_server import StopStream


class LocalEngineLLM(ChatBase):
    """ChatLLM over an in-process serving.engine.LLMEngine: the chat
    template, the engine's token stream, then stop-string matching. A
    request the engine fails (finish_reason "error") raises, so the chain
    server sends its error frame instead of a silently short answer."""

    def __init__(self, engine, tokenizer=None):
        self.engine = engine
        self.tokenizer = tokenizer or engine.tokenizer

    def stream_chat(self, messages: Sequence[Message], *, temperature=0.2,
                    top_p=0.7, max_tokens=1024, stop=()) -> Iterator[str]:
        yield from traced_llm_stream(
            "llm.local", self._stream(messages, temperature, top_p,
                                      max_tokens, stop),
            {"max_tokens": max_tokens, "temperature": temperature})

    def _stream(self, messages, temperature, top_p, max_tokens, stop
                ) -> Iterator[str]:
        text = self.tokenizer.apply_chat_template(messages,
                                                  add_generation_prompt=True)
        ids = self.tokenizer.encode(text)
        matcher = StopStream(list(stop))
        for ev in self.engine.generate_stream(
                ids, max_new_tokens=max_tokens, temperature=temperature,
                top_p=top_p, trace_context=current_context()):
            if ev.get("finish_reason") == "error":
                raise RuntimeError("the engine failed the request")
            piece, hit = matcher.push(ev["text"])
            if piece:
                yield piece
            if hit:
                return
        tail = matcher.flush()
        if tail:
            yield tail


class LocalEmbedder:
    """Embedder over an in-process serving.encoders.EmbeddingEngine."""

    def __init__(self, engine):
        self.engine = engine

    @property
    def dim(self) -> int:
        return self.engine.dim

    def embed_documents(self, texts: Sequence[str]) -> np.ndarray:
        return self.engine.embed(list(texts), is_query=False)

    def embed_query(self, text: str) -> np.ndarray:
        return self.engine.embed([text], is_query=True)[0]

    def embed_queries(self, texts: Sequence[str]) -> np.ndarray:
        return self.engine.embed(list(texts), is_query=True)


class LocalReranker:
    def __init__(self, engine):
        self.engine = engine

    def score(self, query: str, passages: Sequence[str]) -> np.ndarray:
        return self.engine.score(query, passages)
