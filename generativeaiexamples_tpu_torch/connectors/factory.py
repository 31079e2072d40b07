"""Connector factory: config -> ChatLLM / Embedder / Reranker.

Counterpart of generativeaiexamples_tpu/connectors/factory.py:
`model_engine` selects the implementation and `server_url` the remote,
as in the JAX factory: the in-process engines (`tpu`, the JAX config's
name), the hermetic fakes (echo, hash, overlap), the lexical embedder
and the OpenAI-compatible HTTP clients. `EngineHub` owns the in-process
engines: it builds them lazily through the launcher (from the config's
weights paths, or random init at the launcher's geometries) or takes
engines handed to it, so one engine can serve both an OpenAI server and
the chain. Unlike the JAX hub it is not a process-wide singleton: the
caller makes one and passes it on. The hub resolves its device whatever
the connectors are (CUDA unless the caller asks for the CPU).
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from generativeaiexamples_tpu_torch.config.schema import AppConfig
from generativeaiexamples_tpu_torch.connectors.local import (
    LocalEmbedder, LocalEngineLLM, LocalReranker)
from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device


class EngineHub:
    """Owner of the in-process engines (LLM, embedder, reranker)."""

    def __init__(self, config: AppConfig, *, llm=None, embed=None,
                 rerank=None, device: DeviceLike = None,
                 model_size: Optional[str] = None):
        self.config = config
        self.device = resolve_device(device)
        self.model_size = model_size
        self._llm, self._embed, self._rerank = llm, embed, rerank
        self._owns_llm = llm is None
        self._encoders_built = embed is not None and rerank is not None
        self._build_lock = threading.Lock()

    def llm_engine(self):
        with self._build_lock:
            if self._llm is None:
                from generativeaiexamples_tpu_torch.serving.__main__ import (
                    build_engine)

                size = self.model_size or (
                    "8b" if self.device.type == "cuda" else "tiny")
                self._llm = build_engine(size, self.device,
                                         engine_cfg=self.config.engine).start()
            return self._llm

    def _encoders(self):
        """Each encoder loads its own snapshot (and tokenizer) from
        `embeddings.weights_path` / `reranker.weights_path`, as the JAX
        hub's launcher does; without one it is random-init while the LLM
        is, and None beside a loaded LLM. Engines handed in are kept."""
        with self._build_lock:
            if not self._encoders_built:
                from generativeaiexamples_tpu_torch.serving.__main__ import (
                    build_encoders)

                cfg = self.config
                emb, rr = build_encoders(
                    self.device,
                    embed_path="" if self._embed else
                    cfg.embeddings.weights_path,
                    rerank_path="" if self._rerank else
                    cfg.reranker.weights_path,
                    random_init=not cfg.engine.weights_path)
                self._embed = self._embed or emb
                self._rerank = self._rerank or rr
                self._encoders_built = True
            return self._embed, self._rerank

    def embed_engine(self):
        return self._encoders()[0]

    def rerank_engine(self):
        return self._encoders()[1]

    def close(self) -> None:
        """Stop the LLM engine if this hub built it."""
        if self._owns_llm and self._llm is not None:
            self._llm.stop()


def get_llm(config: AppConfig, hub: EngineHub):
    """`llm.model_engine`: echo/test (the hermetic fake), openai/nim/remote
    (or any engine but tpu with a server_url: an OpenAI-compatible
    server), tpu (the hub's in-process engine, or its server at
    server_url)."""
    eng = config.llm.model_engine
    if eng in ("echo", "test"):
        from generativeaiexamples_tpu_torch.connectors.fakes import EchoLLM

        return EchoLLM()
    if eng in ("openai", "nim", "remote") or config.llm.server_url:
        from generativeaiexamples_tpu_torch.connectors.openai_http import (
            OpenAIChatLLM)

        return OpenAIChatLLM(config.llm.server_url
                             or "http://localhost:8000/v1",
                             model=config.llm.model_name)
    if eng == "tpu":
        return LocalEngineLLM(hub.llm_engine())
    raise ValueError(f"unknown llm.model_engine {eng!r}")


def get_embedder(config: AppConfig, hub: EngineHub):
    """`embeddings.model_engine`: hash/test (the hermetic fake),
    lexical/tfidf/bm25 (hashed TF-IDF, its DF table persisted beside a
    durable store), openai/nim/remote (or a server_url), tpu (the hub's
    in-process engine)."""
    ecfg = config.embeddings
    eng = ecfg.model_engine
    if eng in ("hash", "test"):
        from generativeaiexamples_tpu_torch.connectors.fakes import (
            HashEmbedder)

        return HashEmbedder(dim=ecfg.dimensions)
    if eng in ("lexical", "tfidf", "bm25"):
        from generativeaiexamples_tpu_torch.connectors.lexical import (
            LexicalEmbedder)

        persist = config.vector_store.persist_dir
        return LexicalEmbedder(
            dim=ecfg.dimensions,
            persist_path=(os.path.join(persist, "lexical_df.json")
                          if persist else None))
    if eng in ("openai", "nim", "remote") or ecfg.server_url:
        from generativeaiexamples_tpu_torch.connectors.openai_http import (
            OpenAIEmbedder)

        return OpenAIEmbedder(ecfg.server_url or "http://localhost:8000/v1",
                              model=ecfg.model_name, dim=ecfg.dimensions)
    if eng == "tpu":
        embed = hub.embed_engine()
        if embed is None:
            raise RuntimeError(
                "no in-process embedding engine (embeddings.weights_path "
                "unset with a real LLM); set embeddings.model_engine=hash "
                "(or lexical) or provide weights")
        return LocalEmbedder(embed)
    raise ValueError(f"unknown embeddings.model_engine {eng!r}")


def get_reranker(config: AppConfig, hub: EngineHub):
    """None unless reranker.enabled; then `reranker.model_engine`:
    overlap/test (the hermetic fake), openai/nim/remote (or a
    server_url), else the hub's in-process engine (None when it has
    none)."""
    if not config.reranker.enabled:
        return None
    eng = config.reranker.model_engine
    if eng in ("overlap", "test"):
        from generativeaiexamples_tpu_torch.connectors.fakes import (
            OverlapReranker)

        return OverlapReranker()
    if eng in ("openai", "nim", "remote") or config.reranker.server_url:
        from generativeaiexamples_tpu_torch.connectors.openai_http import (
            OpenAIReranker)

        return OpenAIReranker(config.reranker.server_url
                              or "http://localhost:8000/v1",
                              model=config.reranker.model_name)
    rr = hub.rerank_engine()
    return LocalReranker(rr) if rr is not None else None
