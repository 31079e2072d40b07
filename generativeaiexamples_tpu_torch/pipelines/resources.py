"""Shared pipeline resources: connectors, stores, splitter, retriever.

The port's copy of generativeaiexamples_tpu/pipelines/resources.py.
Connectors and both stores (the documents' and the conversation
memory's) can be injected; otherwise they are built from the config
(over `hub`'s in-process engines for `model_engine: tpu`). With
`serving.microbatch_enabled` the embedder, the reranker and the
document store coalesce concurrent callers into one dispatch each
(serving/batcher.py); the conversation-memory store never does. A
`mesh` (parallel/mesh.py) shards both device stores' indexes over its
"tensor" axis, as the JAX package's does.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from generativeaiexamples_tpu_torch.config.schema import (
    AppConfig, check_supported)
from generativeaiexamples_tpu_torch.connectors import factory
from generativeaiexamples_tpu_torch.rag.retriever import Retriever
from generativeaiexamples_tpu_torch.rag.splitter import get_text_splitter
from generativeaiexamples_tpu_torch.rag.vectorstore import create_vector_store
from generativeaiexamples_tpu_torch.serving import batcher as mb


class Resources:
    def __init__(self, config: AppConfig, *, hub: Optional[factory.EngineHub]
                 = None, llm=None, embedder=None, reranker=None, store=None,
                 conv_store=None, mesh=None):
        self.config = check_supported(config)
        self.hub = hub if hub is not None else factory.EngineHub(config)
        self.llm = llm if llm is not None else factory.get_llm(config,
                                                               self.hub)
        self.embedder = (embedder if embedder is not None
                         else factory.get_embedder(config, self.hub))
        self.reranker = (reranker if reranker is not None
                         else factory.get_reranker(config, self.hub))
        dim = getattr(self.embedder, "dim", config.embeddings.dimensions)
        # Cross-request micro-batching: in-process engines batch at the
        # bucketed forward, other embedders get the connector-level
        # wrapper (embed_queries), fake and remote rerankers stay as
        # they are.
        sv = config.serving
        if sv.microbatch_enabled:
            self.embedder = mb.enable_embedder_microbatch(
                self.embedder, max_batch=sv.microbatch_max_batch,
                max_wait_us=sv.microbatch_max_wait_us)
            self.reranker = mb.enable_reranker_microbatch(
                self.reranker, max_batch=sv.microbatch_max_batch,
                max_wait_us=sv.microbatch_max_wait_us)
        # The document store is durable when persist_dir is configured
        # (loads existing data now, saves on every mutation).
        self.store = store if store is not None else create_vector_store(
            config, dim=dim, device=self.hub.device,
            persist_dir=config.vector_store.persist_dir, mesh=mesh)
        # The conversation-memory store (multi_turn_rag) is ephemeral: in
        # this process, never persisted, even when the document store is
        # an external server.
        self.conv_store = (conv_store if conv_store is not None else
                           create_vector_store(config, dim=dim,
                                               device=self.hub.device,
                                               ephemeral=True, mesh=mesh))
        if sv.microbatch_enabled and hasattr(self.store,
                                             "enable_microbatch"):
            # Document store only: conversation memory is per-request
            # scratch far below coalescing scale.
            self.store.enable_microbatch(
                max_batch=sv.microbatch_max_batch,
                max_wait_us=sv.microbatch_max_wait_us)
        # A lexical embedder that starts with an empty DF table in front
        # of a non-empty durable store (no persisted snapshot) rebuilds
        # its IDF state from the stored chunk text. The micro-batch
        # wrapper delegates through `.inner`.
        lex = getattr(self.embedder, "inner", self.embedder)
        if getattr(lex, "n_docs", None) == 0 \
                and hasattr(lex, "fit_documents") \
                and hasattr(self.store, "snapshot_docs") \
                and len(self.store):
            lex.fit_documents(
                [d["text"] for d in self.store.snapshot_docs()])
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
        # Guards the lazy build of shared pipeline state (the knowledge
        # graph).
        self._lock = threading.Lock()
        self.extras: Dict = {}  # pipeline-private state (CSV registry, VLM)
