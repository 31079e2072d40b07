"""Knowledge-graph RAG pipeline (reference:
experimental/knowledge_graph_rag/backend/, routers/chat.py:35-70).

The port's copy of generativeaiexamples_tpu/pipelines/knowledge_graph.py.

Ingest: split -> embed + store (vector path) AND parallel LLM triple
extraction into the entity graph. Answer: extract query entities, pull
their depth-2 graph neighborhood, combine with vector retrieval, ground
the LLM in both ("combined RAG" — the mode the reference's evaluation
router shows winning). Falls back to the reference's disclaimer context
when the graph has nothing for the query (routers/chat.py:61-63).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Generator, List

from generativeaiexamples_tpu_torch.pipelines.base import (
    BaseExample, register_example)

_LOG = logging.getLogger(__name__)

NO_GRAPH_CONTEXT = (
    "No graph triples were available to extract from the knowledge "
    "graph. Always provide a disclaimer if you know the answer to the "
    "user's question, since it is not grounded in the knowledge you are "
    "provided from the graph."
)


@register_example("knowledge_graph")
class KnowledgeGraphRAG(BaseExample):
    @property
    def graph(self):
        """Entity graph, shared across instances via Resources (heavy
        state lives there, pipeline instances are per-request); loaded
        from persist_dir when the vector store persists too. Init is
        locked — concurrent first-ingests must not each build a graph
        and drop the loser's triples."""
        res = self.res
        if getattr(res, "kg_graph", None) is None:
            with res._lock:
                if getattr(res, "kg_graph", None) is None:
                    from generativeaiexamples_tpu_torch.kg.graph import EntityGraph

                    path = self._persist_path()
                    if path and os.path.exists(path):
                        res.kg_graph = EntityGraph.load(path)
                        _LOG.info("loaded knowledge graph: %d triples",
                                  len(res.kg_graph))
                    else:
                        res.kg_graph = EntityGraph()
        return res.kg_graph

    def _persist_path(self) -> str:
        pdir = self.res.config.vector_store.persist_dir
        return os.path.join(pdir, "knowledge_graph.json") if pdir else ""

    def _persist_graph(self) -> None:
        path = self._persist_path()
        if path:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self.graph.save(path)

    # -- ingestion ----------------------------------------------------------

    def ingest_docs(self, filepath: str, filename: str) -> None:
        from generativeaiexamples_tpu_torch.kg.extraction import process_documents
        from generativeaiexamples_tpu_torch.rag.documents import load_document

        docs = load_document(filepath, filename)
        if not docs:
            raise ValueError(f"no extractable text in {filename}")
        chunks: List[str] = []
        metas: List[Dict] = []
        for d in docs:
            for c in self.res.splitter.split(d.text):
                chunks.append(c)
                metas.append({**d.metadata, "filename": filename})
        if not chunks:
            raise ValueError(f"document {filename} produced no chunks")
        embs = self.res.embedder.embed_documents(chunks)
        self.res.store.add(chunks, embs, metas)
        triples = process_documents(chunks, self.res.llm)
        self.graph.add_triples(triples)
        self._persist_graph()
        _LOG.info("ingested %s: %d chunks, %d triples",
                  filename, len(chunks), len(triples))

    # -- answering ----------------------------------------------------------

    def _graph_context(self, query: str) -> str:
        from generativeaiexamples_tpu_torch.kg.extraction import (
            extract_query_entities)

        entities = extract_query_entities(self.res.llm, query)
        triplets: List[str] = []
        for e in entities:
            triplets.extend(self.graph.get_entity_knowledge(e, depth=2))
        if not triplets:
            return ""
        return ("Here are the relationships from the knowledge graph: "
                + "\n".join(dict.fromkeys(triplets)))  # dedup, keep order

    def rag_chain(self, query: str, chat_history, **llm_settings
                  ) -> Generator[str, None, None]:
        query, hits = self.retrieve_with_augmentation(query, chat_history)
        hits = self.res.retriever.limit_tokens(hits) if hits else []
        parts = []
        if hits:
            parts.append("Here are the relevant passages from the "
                         "knowledge base: \n\n"
                         + "\n".join(h.text for h in hits))
        graph_ctx = self._graph_context(query)
        if graph_ctx:
            parts.append(graph_ctx)
        context = "\n\n".join(parts) if parts else NO_GRAPH_CONTEXT
        system = self.res.config.prompts.chat_template
        messages = [{"role": "system", "content": system},
                    {"role": "user",
                     "content": f"Context: {context}\n\nUser query: {query}"}]
        yield from self.answer_with_fact_check(
            query, context,
            self.res.llm.stream_chat(messages, **llm_settings))

    def llm_chain(self, query: str, chat_history, **llm_settings
                  ) -> Generator[str, None, None]:
        system = self.res.config.prompts.chat_template
        messages = ([{"role": "system", "content": system}]
                    + list(chat_history)
                    + [{"role": "user", "content": query}])
        yield from self.res.llm.stream_chat(messages, **llm_settings)

    # -- optional surface ----------------------------------------------------

    def document_search(self, content: str, num_docs: int) -> List[Dict]:
        results = self.res.retriever.retrieve(content, top_k=num_docs,
                                              with_threshold=False)
        return [{"content": r.text,
                 "filename": r.metadata.get("filename", ""),
                 "score": r.score} for r in results]

    def get_documents(self) -> List[str]:
        return self.res.store.list_documents()

    def delete_documents(self, filenames: List[str]) -> bool:
        return self.res.store.delete_documents(filenames) > 0
