"""Connector factory: config -> ChatLLM / Embedder / Reranker.

Counterpart of generativeaiexamples_tpu/connectors/factory.py for the
in-process engine value (`model_engine: tpu`, the JAX config's name).
`EngineHub` owns the in-process engines: it builds them lazily through
the launcher (from the config's weights paths, or random init at the
launcher's geometries) or takes engines handed to it, so one engine can
serve both an OpenAI server and the chain.
Unlike the JAX hub it is not a process-wide singleton: the caller makes
one and passes it on. The remote OpenAI connectors, the hermetic fakes
and the lexical embedder are not ported yet (ROADMAP A.11).
"""

from __future__ import annotations

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


def _in_process(section: str, engine: str, server_url: str) -> None:
    if engine != "tpu" or server_url:
        raise ValueError(
            f"{section}.model_engine={engine!r} / server_url="
            f"{server_url!r}: only the in-process engine ('tpu') is "
            f"ported; remote, fake and lexical connectors are ROADMAP A.11")


def get_llm(config: AppConfig, hub: EngineHub):
    _in_process("llm", config.llm.model_engine, config.llm.server_url)
    return LocalEngineLLM(hub.llm_engine())


def get_embedder(config: AppConfig, hub: EngineHub):
    _in_process("embeddings", config.embeddings.model_engine,
                config.embeddings.server_url)
    embed = hub.embed_engine()
    if embed is None:
        raise RuntimeError(
            "no in-process embedding engine (embeddings.weights_path "
            "unset with a real LLM); set embeddings.model_engine=hash "
            "or provide weights")
    return LocalEmbedder(embed)


def get_reranker(config: AppConfig, hub: EngineHub):
    if not config.reranker.enabled:
        return None
    _in_process("reranker", config.reranker.model_engine,
                config.reranker.server_url)
    rr = hub.rerank_engine()
    return LocalReranker(rr) if rr is not None else None
