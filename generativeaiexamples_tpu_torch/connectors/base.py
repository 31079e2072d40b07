"""Connector protocols: what pipelines talk to.

The port's copy of generativeaiexamples_tpu/connectors/base.py, implemented
by (a) the in-process engines (connectors/local.py), (b) any
OpenAI-compatible remote URL (connectors/openai_http.py), (c) the
hermetic fakes and the lexical embedder (connectors/fakes.py,
connectors/lexical.py), selected by config `model_engine`. Pipelines
never know which one they got.
"""

from __future__ import annotations

from typing import Dict, Iterator, Protocol, Sequence

import numpy as np

Message = Dict[str, str]  # {"role": ..., "content": ...}


class ChatLLM(Protocol):
    def stream_chat(self, messages: Sequence[Message], *, temperature: float = 0.2,
                    top_p: float = 0.7, max_tokens: int = 1024,
                    stop: Sequence[str] = ()) -> Iterator[str]:
        """Yield response text deltas."""
        ...

    def chat(self, messages: Sequence[Message], **kw) -> str:
        ...


class Embedder(Protocol):
    dim: int

    def embed_documents(self, texts: Sequence[str]) -> np.ndarray:
        ...

    def embed_query(self, text: str) -> np.ndarray:
        ...

    def embed_queries(self, texts: Sequence[str]) -> np.ndarray:
        """Batched query embedding: one engine dispatch for all of
        multi-query retrieval's variants (Retriever.retrieve_batch)."""
        ...


class Reranker(Protocol):
    def score(self, query: str, passages: Sequence[str]) -> np.ndarray:
        ...


class ChatBase:
    """chat() in terms of stream_chat() for all implementations."""

    def chat(self, messages, **kw) -> str:
        return "".join(self.stream_chat(messages, **kw))
