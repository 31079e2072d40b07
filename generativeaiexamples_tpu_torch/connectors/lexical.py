"""Model-free lexical embedder: hashed TF-IDF vectors.

The port's copy of generativeaiexamples_tpu/connectors/lexical.py:

- Documents embed as L2-normalized sublinear-TF feature-hash vectors.
- Queries embed the same way, with each term additionally weighted by
  an IDF learned from every document embedded so far, so the
  query->document cosine approximates a normalized TF-IDF match
  (BM25-lite). Document vectors themselves stay IDF-free: stores
  persist them, and reweighting history is not possible there.

The IDF state (`_df`/`_n_docs`) is learned at ingest time. With
`persist_path` set (the factory derives it from
`vector_store.persist_dir`), the DF counters persist beside the store
(atomic temp + os.replace) and reload at construction; `fit_documents`
rebuilds them from stored chunk text when no snapshot exists. An
IDF-less embed_query logs one warning rather than degrading silently.
The JSON snapshot is the JAX embedder's format: either package loads
the other's. Selected by APP_EMBEDDINGS_MODELENGINE=lexical (or tfidf,
bm25).
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import re
import time
from collections import Counter
from typing import Optional, Sequence

import numpy as np

_LOG = logging.getLogger(__name__)

_TOKEN = re.compile(r"\w+")

MIN_DIM = 16
# DF-snapshot write throttle: rewriting the whole vocabulary dict once
# per embed batch would put O(batches x vocab) serialization on the
# ingest hot path. Between forced flushes (flush_state, called at
# ingest completion) a snapshot lands at most every few seconds or
# every few thousand docs, whichever comes first — a crash loses at
# most that window of DF counts, which shifts IDF weights negligibly.
PERSIST_MIN_INTERVAL_S = 2.0
PERSIST_DOC_STEP = 4096


class LexicalEmbedder:
    """Hashed TF-IDF embedder (see module docstring)."""

    def __init__(self, dim: int = 1024,
                 persist_path: Optional[str] = None):
        if int(dim) < MIN_DIM:
            raise ValueError(
                f"embeddings.dimensions={dim} is too small for the "
                f"lexical engine (hash buckets; minimum {MIN_DIM}) — "
                f"raise the configured dimension")
        self.dim = int(dim)
        self._df: Counter = Counter()
        self._n_docs = 0
        self._warned_no_idf = False
        self._last_persist_t = 0.0  # monotonic; 0 -> first write always
        self._persisted_docs = 0
        self.persist_path = persist_path or None
        if self.persist_path and os.path.isfile(self.persist_path):
            self.load_state(self.persist_path)

    @staticmethod
    def _terms(text: str):
        return _TOKEN.findall(text.lower())

    def _bucket(self, term: str) -> int:
        h = int.from_bytes(hashlib.md5(term.encode()).digest()[:4], "little")
        return h % self.dim

    def _vec(self, text: str, idf: bool) -> np.ndarray:
        v = np.zeros((self.dim,), np.float32)
        tf = Counter(self._terms(text))
        for term, n in tf.items():
            w = 1.0 + math.log(n)
            if idf and self._n_docs:
                df = self._df.get(term, 0)
                w *= max(0.0, math.log(
                    1.0 + (self._n_docs - df + 0.5) / (df + 0.5)))
            v[self._bucket(term)] += w
        norm = np.linalg.norm(v)
        return v / norm if norm else v

    def embed_documents(self, texts: Sequence[str]) -> np.ndarray:
        for t in texts:
            self._df.update(set(self._terms(t)))
        self._n_docs += len(texts)
        if len(texts):
            self._persist()
        if not len(texts):
            return np.zeros((0, self.dim), np.float32)
        return np.stack([self._vec(t, idf=False) for t in texts])

    def fit_documents(self, texts: Sequence[str]) -> None:
        """Learn DF counts WITHOUT producing vectors — how a restarted
        query-serving process rebuilds IDF state from the chunk text
        already sitting in a durable store (no persisted snapshot
        needed)."""
        for t in texts:
            self._df.update(set(self._terms(t)))
        self._n_docs += len(texts)
        if len(texts):
            self._persist()

    def _maybe_warn_no_idf(self) -> None:
        if self._n_docs or self._warned_no_idf:
            return
        self._warned_no_idf = True
        _LOG.warning(
            "LexicalEmbedder.embed_query with an empty DF table: falling "
            "back to plain TF weighting (retrieval quality will diverge "
            "from the evaluated TF-IDF space). Persist the DF state "
            "(vector_store.persist_dir) or rebuild it via fit_documents().")

    def embed_query(self, text: str) -> np.ndarray:
        self._maybe_warn_no_idf()
        return self._vec(text, idf=True)

    def embed_queries(self, texts: Sequence[str]) -> np.ndarray:
        if len(texts):
            self._maybe_warn_no_idf()
        return np.stack([self._vec(t, idf=True) for t in texts]) \
            if len(texts) else np.zeros((0, self.dim), np.float32)

    # -- DF-state persistence ----------------------------------------------

    @property
    def n_docs(self) -> int:
        return self._n_docs

    def save_state(self, path: str) -> None:
        """Atomic snapshot of the DF counters (temp + os.replace — a
        crash mid-write never corrupts the previous snapshot)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        payload = {"dim": self.dim, "n_docs": self._n_docs,
                   "df": dict(self._df)}
        # Unique tmp per writer: an ingest process and a query-serving
        # process rebuilding DF at startup can both persist to the same
        # path, and a shared fixed tmp name would let their in-flight
        # writes interleave into corrupt JSON.
        tmp = f"{path}.{os.getpid()}.{id(self):x}.tmp"
        try:
            with open(tmp, "w") as fh:
                json.dump(payload, fh)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def load_state(self, path: str) -> bool:
        """Reload a DF snapshot; a snapshot from a different hash width
        is ignored (its buckets would not line up)."""
        try:
            with open(path) as fh:
                payload = json.load(fh)
        except (OSError, ValueError):
            _LOG.warning("unreadable lexical DF snapshot at %s — starting "
                         "with an empty DF table", path)
            return False
        if int(payload.get("dim", -1)) != self.dim:
            _LOG.warning(
                "lexical DF snapshot at %s was written for dim=%s, this "
                "embedder is dim=%d — ignoring it", path,
                payload.get("dim"), self.dim)
            return False
        self._df = Counter({str(k): int(v)
                            for k, v in payload.get("df", {}).items()})
        self._n_docs = int(payload.get("n_docs", 0))
        return True

    def _persist(self, force: bool = False) -> None:
        if not self.persist_path:
            return
        now = time.monotonic()
        if not force \
                and now - self._last_persist_t < PERSIST_MIN_INTERVAL_S \
                and self._n_docs - self._persisted_docs < PERSIST_DOC_STEP:
            return
        self.save_state(self.persist_path)
        self._last_persist_t = now
        self._persisted_docs = self._n_docs

    def flush_state(self) -> None:
        """Force-write any DF counts the throttle held back (the
        ingest pipeline calls this at completion)."""
        if self.persist_path and self._persisted_docs != self._n_docs:
            self._persist(force=True)
