"""Multi-turn RAG with conversation memory (reference:
examples/multi_turn_rag/chains.py).

The port's copy of generativeaiexamples_tpu/pipelines/multi_turn_rag.py.

Two vector stores: documents + a `conv_store` holding past turns
(chains.py:45-58). Each rag_chain call retrieves from BOTH (context +
relevant history, chains.py:158-167), answers with the multi-turn
template, then writes the turn back into memory (save_memory_and_get_
output parity, chains.py:60-68).
"""

from __future__ import annotations

import logging
from typing import Dict, Generator, List

from generativeaiexamples_tpu_torch.pipelines.base import BaseExample, register_example
from generativeaiexamples_tpu_torch.pipelines.developer_rag import QAChatbot

_LOG = logging.getLogger(__name__)


@register_example("multi_turn_rag")
class MultiTurnChatbot(QAChatbot):
    """Inherits ingest/document management from the QA pipeline; overrides
    the chat path with conversation memory."""

    def _history_context(self, query: str, k: int = 2) -> str:
        try:
            res = self.res.conv_store.search(
                self.res.embedder.embed_query(query), top_k=k)
            return "\n".join(r.text for r in res)
        except Exception:
            _LOG.exception("conversation memory retrieval failed")
            return ""

    def _save_turn(self, query: str, answer: str) -> None:
        text = f"User: {query}\nAssistant: {answer}"
        try:
            self.res.conv_store.add(
                [text], self.res.embedder.embed_documents([text]),
                [{"filename": "__conversation__"}])
        except Exception:
            _LOG.exception("conversation memory write failed")

    def rag_chain(self, query: str, chat_history, **llm_settings
                  ) -> Generator[str, None, None]:
        query, results = self.retrieve_with_augmentation(query, chat_history)
        results = self.res.retriever.limit_tokens(results)
        context = "\n\n".join(r.text for r in results)
        history = self._history_context(query)
        template = self.res.config.prompts.multi_turn_rag_template
        system = template.format(input=query, context=context, history=history)
        messages = [{"role": "system", "content": system},
                    {"role": "user", "content": query}]
        pieces: List[str] = []

        def capture():
            for piece in self.res.llm.stream_chat(messages, **llm_settings):
                pieces.append(piece)
                yield piece

        # Guardrail verdict (if configured) streams after the answer but
        # only the answer itself is written back to conversation memory.
        yield from self.answer_with_fact_check(query, context, capture())
        self._save_turn(query, "".join(pieces))

    def llm_chain(self, query: str, chat_history, **llm_settings
                  ) -> Generator[str, None, None]:
        pieces: List[str] = []
        for piece in super().llm_chain(query, chat_history, **llm_settings):
            pieces.append(piece)
            yield piece
        self._save_turn(query, "".join(pieces))
