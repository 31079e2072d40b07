"""Incremental text accumulation for streaming transcripts.

Counterpart of generativeaiexamples_tpu/streaming/accumulator.py, on the
port's splitter and vector store: per-source rolling buffers; each
update re-chunks buffer + new text, sends every full chunk to the vector
store and the time index, and keeps the tail in the buffer so chunk
boundaries never split across POSTs.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from generativeaiexamples_tpu_torch.rag.splitter import RecursiveCharacterSplitter
from generativeaiexamples_tpu_torch.streaming.timestamps import TimestampDatabase


class StreamingStore:
    """Embed + store adapter: add_docs() on ingest, search() at answer
    time, over a host `MemoryVectorStore` unless a store is given."""

    def __init__(self, embedder, store=None):
        from generativeaiexamples_tpu_torch.rag.vectorstore import MemoryVectorStore

        self.embedder = embedder
        dim = getattr(embedder, "dim", None) or len(
            np.asarray(embedder.embed_query("probe")).ravel())
        self.store = store if store is not None else MemoryVectorStore(dim)

    def add_docs(self, docs, source_id: str) -> None:
        if not docs:
            return
        embs = self.embedder.embed_documents(docs)
        self.store.add(docs, embs, metadatas=[{"source_id": source_id}
                                              for _ in docs])

    def search(self, question: str, max_entries: int = 4):
        hits = self.store.search(self.embedder.embed_query(question),
                                 top_k=max_entries)
        return hits


class TextAccumulator:
    """Rolling per-source accumulator (accumulator.py:35-47)."""

    def __init__(self, db_interface: StreamingStore,
                 chunk_size: int = 256, chunk_overlap: int = 32,
                 timestamp_db: Optional[TimestampDatabase] = None):
        self.splitter = RecursiveCharacterSplitter(
            chunk_size=chunk_size, chunk_overlap=chunk_overlap)
        self.accumulators: Dict[str, str] = {}
        self.timestamp_db = timestamp_db or TimestampDatabase()
        self.db_interface = db_interface
        self._lock = threading.Lock()  # concurrent POSTs per source

    def update(self, source_id: str, text: str) -> Dict[str, str]:
        """Append text; embed every chunk that reached full size, keep
        the tail buffered. Returns the reference's status payload."""
        with self._lock:
            buf = self.accumulators.get(source_id, "")
            docs = self.splitter.split(f"{buf} {text}".strip())
            if not docs:
                return {"status": "Added 0 entries"}
            self.accumulators[source_id], new_docs = docs[-1], docs[:-1]
        if new_docs:
            self.timestamp_db.insert_docs(new_docs, source_id)
            self.db_interface.add_docs(new_docs, source_id)
        return {"status": f"Added {len(new_docs)} entries"}

    def flush(self, source_id: str) -> int:
        """Force the tail buffer out (stream end — the reference leaves
        the tail stranded until more text arrives)."""
        with self._lock:
            tail = self.accumulators.pop(source_id, "").strip()
        if not tail:
            return 0
        self.timestamp_db.insert_docs([tail], source_id)
        self.db_interface.add_docs([tail], source_id)
        return 1
