"""Pipeline interface + registry.

The port's copy of generativeaiexamples_tpu/pipelines/base.py: every
pipeline implements llm_chain / rag_chain / ingest_docs, optionally
document_search / get_documents / delete_documents, and registers under
a name the chain server picks (config or EXAMPLE_NAME). Query
augmentation and fact checking are refused by the config
(config/schema.py: ROADMAP A.11), so the shared helpers below take their
off paths only.
"""

from __future__ import annotations

import abc
from typing import Dict, Generator, List, Type

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
                       f" (the other pipelines are ROADMAP A.11)")
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
        """(query, hits) through the CONFIGURED retrieval path
        (ranked_hybrid included). Augmentation modes are refused by the
        config, so the query passes through unchanged."""
        return query, self.res.retriever.retrieve_default(query)

    def answer_with_fact_check(self, query: str, context: str, token_iter
                               ) -> Generator[str, None, None]:
        """Stream `token_iter` (retriever.fact_check is refused by the
        config, so no verdict is appended)."""
        yield from token_iter

    # optional interface (server probes these)
    def document_search(self, content: str, num_docs: int) -> List[Dict]:
        raise NotImplementedError

    def get_documents(self) -> List[str]:
        raise NotImplementedError

    def delete_documents(self, filenames: List[str]) -> bool:
        raise NotImplementedError
