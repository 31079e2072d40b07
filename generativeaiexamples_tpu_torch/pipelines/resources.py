"""Shared pipeline resources: connectors, store, splitter, retriever.

The port's copy of generativeaiexamples_tpu/pipelines/resources.py,
without cross-request micro-batching and without the conversation-memory
store (multi_turn_rag's, not ported yet: ROADMAP A.11). Connectors and
the store can be injected; otherwise they are built from the config
over `hub`'s in-process engines.
"""

from __future__ import annotations

from typing import Dict, Optional

from generativeaiexamples_tpu_torch.config.schema import (
    AppConfig, check_supported)
from generativeaiexamples_tpu_torch.connectors import factory
from generativeaiexamples_tpu_torch.rag.retriever import Retriever
from generativeaiexamples_tpu_torch.rag.splitter import get_text_splitter
from generativeaiexamples_tpu_torch.rag.vectorstore import create_vector_store


class Resources:
    def __init__(self, config: AppConfig, *, hub: Optional[factory.EngineHub]
                 = None, llm=None, embedder=None, reranker=None, store=None):
        self.config = check_supported(config)
        self.hub = hub if hub is not None else factory.EngineHub(config)
        self.llm = llm if llm is not None else factory.get_llm(config,
                                                               self.hub)
        self.embedder = (embedder if embedder is not None
                         else factory.get_embedder(config, self.hub))
        self.reranker = (reranker if reranker is not None
                         else factory.get_reranker(config, self.hub))
        dim = getattr(self.embedder, "dim", config.embeddings.dimensions)
        self.store = store if store is not None else create_vector_store(
            config, dim=dim, device=self.hub.device)
        self.splitter = get_text_splitter(config)
        self.retriever = Retriever(
            self.store, self.embedder,
            top_k=config.retriever.top_k,
            score_threshold=config.retriever.score_threshold,
            max_context_tokens=config.retriever.max_context_tokens,
            reranker=self.reranker,
            # ranked_hybrid becomes the default retrieval path when the
            # config asks for it AND a reranker exists.
            default_hybrid=(config.retriever.nr_pipeline == "ranked_hybrid"
                            and self.reranker is not None),
        )
        self.extras: Dict = {}  # pipeline-private state
