"""Knowledge-graph RAG: triple extraction, entity graph, eval router.

The port's copy of generativeaiexamples_tpu/kg/ (the reference's
experimental/knowledge_graph_rag/backend/): LLM triple extraction over
document chunks, an in-process entity graph with depth-bounded
neighbourhood expansion, graph+vector combined answering, and the
text-vs-graph-vs-combined evaluation router.
"""

from generativeaiexamples_tpu_torch.kg.extraction import (
    extract_triples, process_documents)
from generativeaiexamples_tpu_torch.kg.graph import EntityGraph, Triple

__all__ = ["EntityGraph", "Triple", "extract_triples", "process_documents"]
