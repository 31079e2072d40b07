"""Milvus vector store over the RESTful v2 API (standard library only).

The port's copy of generativeaiexamples_tpu/rag/milvus_store.py: a
client of an external Milvus server (v2.4+: POST /v2/vectordb/...) over
`urllib`, so no pymilvus or gRPC wheels are needed. Interface-compatible
with MemoryVectorStore (add / search / list_documents /
delete_documents / __len__ / snapshot_docs), selected by
`vector_store.name: milvus` and `vector_store.url`. Connection failures
raise at construction with an actionable message. It runs no kernel:
the server does the search.
"""

from __future__ import annotations

import json
import logging
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence

import numpy as np

from generativeaiexamples_tpu_torch.rag.vectorstore import SearchResult

_LOG = logging.getLogger(__name__)


class MilvusError(RuntimeError):
    pass


class MilvusVectorStore:
    """Chunk store backed by an external Milvus server (HTTP v2 API).

    Rows: auto-id primary key + `vector` + dynamic fields
    {text, filename, meta} (metadata round-trips as JSON in `meta`).
    """

    def __init__(self, url: str, dim: int, collection: str = "gaie_chunks",
                 metric: str = "IP", token: str = "", timeout: float = 10.0):
        if not url:
            raise MilvusError(
                "vector_store.name=milvus requires vector_store.url "
                "(e.g. http://localhost:19530); no URL configured")
        self.url = url.rstrip("/")
        if not self.url.startswith("http"):
            self.url = "http://" + self.url
        self.dim = dim
        self.collection = collection
        self.metric = metric.upper()
        self.token = token
        self.timeout = timeout
        self._ensure_collection()

    # -- wire --------------------------------------------------------------

    def _post(self, path: str, body: Dict) -> Dict:
        req = urllib.request.Request(
            self.url + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json",
                     **({"Authorization": f"Bearer {self.token}"}
                        if self.token else {})},
            method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = json.loads(resp.read().decode())
        except urllib.error.URLError as e:
            raise MilvusError(
                f"Milvus server unreachable at {self.url} ({e}). Start one "
                f"(deploy/compose/vectordb.yaml) or switch "
                f"vector_store.name to 'memory'/'tpu'") from e
        code = payload.get("code", 0)
        if code not in (0, 200):
            raise MilvusError(
                f"Milvus {path} failed: code={code} "
                f"message={payload.get('message', '')!r}")
        return payload

    # -- schema ------------------------------------------------------------

    def _ensure_collection(self) -> None:
        has = self._post("/v2/vectordb/collections/has",
                         {"collectionName": self.collection})
        if has.get("data", {}).get("has"):
            return
        self._post("/v2/vectordb/collections/create", {
            "collectionName": self.collection,
            "dimension": self.dim,
            "metricType": self.metric,
            "idType": "Int64",
            "autoID": True,
            "enableDynamicField": True,
            "vectorFieldName": "vector",
        })
        _LOG.info("milvus: created collection %s (dim=%d, %s)",
                  self.collection, self.dim, self.metric)

    # -- store interface ---------------------------------------------------

    def add(self, texts: Sequence[str], embeddings: np.ndarray,
            metadatas: Optional[Sequence[Dict]] = None) -> List[int]:
        embeddings = np.asarray(embeddings, np.float32)
        assert embeddings.shape == (len(texts), self.dim), embeddings.shape
        metadatas = metadatas or [{} for _ in texts]
        rows = [{
            "vector": emb.tolist(),
            "text": t,
            "filename": str(m.get("filename", "")),
            "meta": json.dumps(dict(m)),
        } for t, emb, m in zip(texts, embeddings, metadatas)]
        out = self._post("/v2/vectordb/entities/insert",
                         {"collectionName": self.collection, "data": rows})
        self._invalidate()
        ids = out.get("data", {}).get("insertIds", [])
        return [int(i) for i in ids] if ids else list(range(len(texts)))

    def search(self, query_embedding: np.ndarray, top_k: int = 4,
               score_threshold: Optional[float] = None) -> List[SearchResult]:
        q = np.asarray(query_embedding, np.float32)
        out = self._post("/v2/vectordb/entities/search", {
            "collectionName": self.collection,
            "data": [q.tolist()],
            "annsField": "vector",
            "limit": int(top_k),
            "outputFields": ["text", "filename", "meta"],
        })
        hits = out.get("data", []) or []
        results = []
        for h in hits:
            score = float(h.get("distance", h.get("score", 0.0)))
            if score_threshold is not None:
                # IP/COSINE scores are similarities (bigger = better);
                # L2 is a distance (smaller = better), so the cut flips.
                if self.metric == "L2":
                    if score > score_threshold:
                        continue
                elif score < score_threshold:
                    continue
            try:
                meta = json.loads(h.get("meta") or "{}")
            except (TypeError, json.JSONDecodeError):
                meta = {}
            if h.get("filename") and "filename" not in meta:
                meta["filename"] = h["filename"]
            results.append(SearchResult(h.get("text", ""), score, meta))
        return results

    def list_documents(self) -> List[str]:
        out = self._post("/v2/vectordb/entities/query", {
            "collectionName": self.collection,
            "filter": 'filename != ""',
            "outputFields": ["filename"],
            "limit": 16384,
        })
        return sorted({r.get("filename", "") for r in out.get("data", [])
                       if r.get("filename")})

    def delete_documents(self, filenames: Sequence[str]) -> int:
        names = [str(n) for n in filenames]
        if not names:
            return 0
        # json.dumps escapes quotes/backslashes/control chars in a way the
        # Milvus filter parser does not understand — reject such names up
        # front instead of emitting a filter that silently matches nothing.
        # (ensure_ascii=False below keeps plain non-ASCII names intact.)
        bad = [n for n in names
               if '"' in n or "\\" in n or any(ord(c) < 0x20 for c in n)]
        if bad:
            raise ValueError(
                f"filenames containing quotes, backslashes or control "
                f"characters cannot be used in a Milvus delete filter: "
                f"{bad!r}")
        # Count the matching rows BEFORE deleting (one filtered query):
        # Milvus applies deletes asynchronously, so a count(*) taken
        # right after the delete may still see the rows and a
        # before/after diff would report 0 for a successful delete.
        flt = f"filename in {json.dumps(names, ensure_ascii=False)}"
        probe = self._post("/v2/vectordb/entities/query", {
            "collectionName": self.collection,
            "filter": flt,
            "outputFields": ["count(*)"],
        }).get("data", [])
        matching = int(probe[0].get("count(*)", 0)) if probe else 0
        out = self._post("/v2/vectordb/entities/delete", {
            "collectionName": self.collection,
            "filter": flt,
        })
        self._invalidate()
        dc = (out.get("data") or {}).get("deleteCount")
        return int(dc) if dc is not None else matching

    def __len__(self) -> int:
        out = self._post("/v2/vectordb/entities/query", {
            "collectionName": self.collection,
            "filter": "",
            "outputFields": ["count(*)"],
        })
        data = out.get("data", [])
        if data and "count(*)" in data[0]:
            return int(data[0]["count(*)"])
        return len(data)

    def _invalidate(self) -> None:
        self._docs_cache = None

    def snapshot_docs(self):
        """Doc dump for the hybrid retriever's lexical leg (bounded —
        external stores beyond this size should rely on dense-only).

        Cached between mutations made THROUGH this client: the hybrid
        retriever calls snapshot_docs per query, and a full-collection
        HTTP dump per chat turn would dwarf the retrieval itself.
        Mutations from other processes are not observed until this
        process next mutates — acceptable for the lexical re-ranking
        leg (dense retrieval always sees the live server)."""
        cached = getattr(self, "_docs_cache", None)
        if cached is not None:
            return cached
        out = self._post("/v2/vectordb/entities/query", {
            "collectionName": self.collection,
            "filter": "",
            "outputFields": ["text", "filename", "meta"],
            "limit": 16384,
        })
        docs = []
        for r in out.get("data", []):
            try:
                meta = json.loads(r.get("meta") or "{}")
            except (TypeError, json.JSONDecodeError):
                meta = {}
            docs.append({"text": r.get("text", ""), "metadata": meta})
        self._docs_cache = docs
        return docs
