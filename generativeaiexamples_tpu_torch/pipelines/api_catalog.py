"""Plain chat-RAG pipeline (reference: examples/nvidia_api_catalog/
chains.py — LangChain against API-catalog endpoints).

The port's copy of generativeaiexamples_tpu/pipelines/api_catalog.py.

Distinctive behavior vs developer_rag: context is stuffed into the USER
message rather than the system prompt (chains.py:129-141), chat history
rides along, and retrieval falls back to thresholdless search
(chains.py:120-127).
"""

from __future__ import annotations

from typing import Generator

from generativeaiexamples_tpu_torch.pipelines.base import register_example
from generativeaiexamples_tpu_torch.pipelines.developer_rag import QAChatbot


@register_example("api_catalog")
class APICatalogChat(QAChatbot):
    def rag_chain(self, query: str, chat_history, **llm_settings
                  ) -> Generator[str, None, None]:
        query, results = self.retrieve_with_augmentation(query, chat_history)
        results = self.res.retriever.limit_tokens(results)
        context = "\n\n".join(r.text for r in results)
        system = self.res.config.prompts.chat_template
        user = (f"Answer the question using the context below.\n\n"
                f"Context:\n{context}\n\nQuestion: {query}" if context
                else query)
        messages = ([{"role": "system", "content": system}]
                    + list(chat_history) + [{"role": "user", "content": user}])
        yield from self.answer_with_fact_check(
            query, context,
            self.res.llm.stream_chat(messages, **llm_settings))
