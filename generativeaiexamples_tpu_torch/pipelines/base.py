"""Pipeline interface + registry.

The port's copy of generativeaiexamples_tpu/pipelines/base.py: every
pipeline implements llm_chain / rag_chain / ingest_docs, optionally
document_search / get_documents / delete_documents, and registers under
a name the chain server picks (config or EXAMPLE_NAME). The shared
answer-quality helpers honour `retriever.query_augmentation` (rewrite |
hyde | multi_query, comma-combinable) and `retriever.fact_check`.
"""

from __future__ import annotations

import abc
import logging
from typing import Dict, Generator, List, Type

from generativeaiexamples_tpu_torch.rag import augmentation as aug

_LOG = logging.getLogger(__name__)
_REGISTRY: Dict[str, Type["BaseExample"]] = {}


def register_example(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        cls.example_name = name
        return cls
    return deco


def get_example_class(name: str) -> Type["BaseExample"]:
    # Import the built-in pipelines so their registrations run.
    import generativeaiexamples_tpu_torch.pipelines as _p  # noqa: F401

    if name not in _REGISTRY:
        raise KeyError(f"unknown example {name!r}; known: {sorted(_REGISTRY)}"
                       f" (the other pipelines are ROADMAP A.11(f))")
    return _REGISTRY[name]


def list_examples() -> List[str]:
    import generativeaiexamples_tpu_torch.pipelines as _p  # noqa: F401

    return sorted(_REGISTRY)


class BaseExample(abc.ABC):
    """One RAG pipeline. Instances are cheap (heavy state lives in the
    shared resource container passed in)."""

    example_name = "base"

    def __init__(self, resources):
        self.res = resources  # pipelines.resources.Resources

    @abc.abstractmethod
    def llm_chain(self, query: str, chat_history: List[Dict[str, str]],
                  **llm_settings) -> Generator[str, None, None]:
        """Answer without retrieval."""

    @abc.abstractmethod
    def rag_chain(self, query: str, chat_history: List[Dict[str, str]],
                  **llm_settings) -> Generator[str, None, None]:
        """Answer grounded in the knowledge base."""

    @abc.abstractmethod
    def ingest_docs(self, filepath: str, filename: str) -> None:
        """Ingest one uploaded document."""

    def retrieve_with_augmentation(self, query: str, chat_history):
        """(possibly rewritten) query + hits through the CONFIGURED
        retrieval path (ranked_hybrid included), honouring
        retriever.query_augmentation: rewrite | hyde | multi_query,
        comma-combinable. Unknown modes warn and are ignored."""
        rcfg = self.res.config.retriever
        modes = {m.strip() for m in rcfg.query_augmentation.split(",")
                 if m.strip()}
        unknown = modes - {"rewrite", "hyde", "multi_query"}
        if unknown:
            _LOG.warning("unknown query_augmentation modes ignored: %s "
                         "(valid: rewrite, hyde, multi_query)",
                         sorted(unknown))
            modes -= unknown
        if not modes:
            return query, self.res.retriever.retrieve_default(query)
        q = query
        if "rewrite" in modes:
            q = aug.query_rewriting(self.res.llm, q, chat_history)
        variants = [q]
        if "hyde" in modes:
            variants.append(aug.augment_query_generated(self.res.llm, q))
        if "multi_query" in modes:
            variants.extend(aug.augment_multiple_query(self.res.llm, q))
        # Every variant scores in ONE embed_queries call and ONE
        # search_batch dispatch (retrieve_multi), RRF-fused.
        return q, self.res.retriever.retrieve_multi(variants,
                                                    top_k=rcfg.top_k)

    def answer_with_fact_check(self, query: str, context: str, token_iter
                               ) -> Generator[str, None, None]:
        """Stream `token_iter`; with retriever.fact_check on, buffer it
        and append the guardrail's verdict."""
        if not self.res.config.retriever.fact_check:
            yield from token_iter
            return
        answer = "".join(token_iter)
        yield answer
        yield "\n\n[fact-check] "
        yield from aug.fact_check(self.res.llm, context, query, answer,
                                  max_tokens=512)

    # optional interface (server probes these)
    def document_search(self, content: str, num_docs: int) -> List[Dict]:
        raise NotImplementedError

    def get_documents(self) -> List[str]:
        raise NotImplementedError

    def delete_documents(self, filenames: List[str]) -> bool:
        raise NotImplementedError
