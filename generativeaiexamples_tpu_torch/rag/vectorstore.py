"""Vector stores: exact MIPS over host numpy or device memory.

Counterpart of the exact (flat) stores of
generativeaiexamples_tpu/rag/vectorstore.py:

- `MemoryVectorStore`: numpy matmul top-k on the host.
- `DeviceVectorStore`: the counterpart of `TPUVectorStore` with
  `index_type="flat"`. The rows live on the device (CUDA unless the
  caller asks for the CPU) and nowhere else; rows added since the last
  search are folded into the device matrix lazily at the next search
  (`_refresh_flat`), and every search is one `ops.topk.mips_topk`
  dispatch. There is no host copy to scan.

Documents carry {text, metadata{filename, ...}}; deletion is by
filename. IVF, int8 rows, the tiered index (ROADMAP A.18), persistence,
micro-batching and the external milvus / pgvector stores (ROADMAP A.11)
are not ported; `create_vector_store` refuses them by name.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from generativeaiexamples_tpu_torch.config.schema import check_supported
from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device
from generativeaiexamples_tpu_torch.ops.topk import mips_topk


@dataclass
class SearchResult:
    text: str
    score: float
    metadata: Dict = field(default_factory=dict)


class MemoryVectorStore:
    """Exact cosine/IP search over an [N, D] host matrix. Thread-safe."""

    def __init__(self, dim: int, metric: str = "ip"):
        self.dim = dim
        self.metric = metric  # "ip" (normalized embeddings) or "cosine"
        self._vecs = np.zeros((0, dim), np.float32)
        self._docs: List[Dict] = []
        self._lock = threading.RLock()
        self._n_searches = 0
        self._n_batched = 0

    # -- ingest ------------------------------------------------------------

    def _check_rows(self, texts: Sequence[str], embeddings) -> None:
        if tuple(embeddings.shape) != (len(texts), self.dim):
            raise ValueError(f"embeddings {tuple(embeddings.shape)} for "
                             f"{len(texts)} texts of dim {self.dim}")

    def add(self, texts: Sequence[str], embeddings: np.ndarray,
            metadatas: Optional[Sequence[Dict]] = None) -> List[int]:
        embeddings = np.asarray(embeddings, np.float32)
        self._check_rows(texts, embeddings)
        metadatas = metadatas or [{} for _ in texts]
        with self._lock:
            base = len(self._docs)
            self._vecs = np.concatenate([self._vecs, embeddings])
            for t, m in zip(texts, metadatas):
                self._docs.append({"text": t, "metadata": dict(m)})
            return list(range(base, base + len(texts)))

    # -- search ------------------------------------------------------------

    def _scores(self, query: np.ndarray) -> np.ndarray:
        q = np.asarray(query, np.float32)
        if self.metric == "cosine":
            qn = q / max(np.linalg.norm(q), 1e-12)
            dn = self._vecs / np.clip(
                np.linalg.norm(self._vecs, axis=1, keepdims=True), 1e-12, None)
            return dn @ qn
        return self._vecs @ q

    def search(self, query_embedding: np.ndarray, top_k: int = 4,
               score_threshold: Optional[float] = None) -> List[SearchResult]:
        return self._search_one(query_embedding, top_k, score_threshold)

    def _search_one(self, query_embedding: np.ndarray, top_k: int = 4,
                    score_threshold: Optional[float] = None
                    ) -> List[SearchResult]:
        with self._lock:
            if not self._docs:
                return []
            self._n_searches += 1
            return self._topk_from_scores(self._scores(query_embedding),
                                          top_k, score_threshold)

    def search_batch(self, query_embeddings: np.ndarray, top_k: int = 4,
                     score_threshold: Optional[float] = None
                     ) -> List[List[SearchResult]]:
        """Score ALL queries ([Q, D]) in one pass; result lists align with
        the query order. A single-row batch takes the single-query path,
        so batched and sequential results are identical."""
        qs = np.asarray(query_embeddings, np.float32)
        if qs.ndim != 2:
            raise ValueError(f"query_embeddings must be [Q, D], got "
                             f"{qs.shape}")
        return self._search_batch_direct(qs, top_k, score_threshold)

    def _search_batch_direct(self, qs: np.ndarray, top_k: int,
                             score_threshold: Optional[float]
                             ) -> List[List[SearchResult]]:
        if len(qs) == 1:
            return [self._search_one(qs[0], top_k=top_k,
                                     score_threshold=score_threshold)]
        with self._lock:
            if not self._docs:
                return [[] for _ in qs]
            self._n_batched += 1
            self._n_searches += len(qs)
            if self.metric == "cosine":
                qn = qs / np.clip(np.linalg.norm(qs, axis=1, keepdims=True),
                                  1e-12, None)
                dn = self._vecs / np.clip(
                    np.linalg.norm(self._vecs, axis=1, keepdims=True),
                    1e-12, None)
                all_scores = qn @ dn.T
            else:
                all_scores = qs @ self._vecs.T
            return [self._topk_from_scores(row, top_k, score_threshold)
                    for row in all_scores]

    def _topk_from_scores(self, scores, top_k, score_threshold):
        k = min(top_k, len(scores))
        idx = np.argpartition(scores, -k)[-k:]
        idx = idx[np.argsort(scores[idx])[::-1]]
        out = []
        for i in idx:
            s = float(scores[i])
            if score_threshold is not None and s < score_threshold:
                continue
            d = self._docs[i]
            out.append(SearchResult(d["text"], s, dict(d["metadata"])))
        return out

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict:
        """Counters the chain server surfaces at /metrics (the JAX
        store's keys; the ANN and tiering gauges stay at their exact-store
        values)."""
        with self._lock:
            return {
                "backend": type(self).__name__,
                "index": "flat",
                "ntotal": len(self._docs),
                "searches": self._n_searches,
                "batched_searches": self._n_batched,
                "ann_probes": 0,
                "ann_scanned_rows": 0,
                "ann_recall_est": None,
                "index_rebuilds": 0,
                "tiered": False,
                "hbm_resident_fraction": None,
                "pager_hbm_hit_rate": None,
                "tier_promotions": 0,
                "tier_demotions": 0,
                "background_errors": 0,
            }

    # -- document management ----------------------------------------------

    def list_documents(self) -> List[str]:
        with self._lock:
            return sorted({d["metadata"].get("filename", "")
                           for d in self._docs if d["metadata"].get("filename")})

    def _kept_rows(self, filenames: Sequence[str]) -> List[int]:
        names = set(filenames)
        return [i for i, d in enumerate(self._docs)
                if d["metadata"].get("filename") not in names]

    def delete_documents(self, filenames: Sequence[str]) -> int:
        with self._lock:
            keep = self._kept_rows(filenames)
            removed = len(self._docs) - len(keep)
            self._vecs = self._vecs[keep] if keep else np.zeros(
                (0, self.dim), np.float32)
            self._docs = [self._docs[i] for i in keep]
            return removed

    def __len__(self) -> int:
        return len(self._docs)

    def snapshot_docs(self):
        """Consistent copy of the doc list for lock-free downstream use
        (hybrid retrieval's lexical leg)."""
        with self._lock:
            return list(self._docs)


class DeviceVectorStore(MemoryVectorStore):
    """Exact flat MIPS with the rows on the device (the counterpart of
    TPUVectorStore's flat index). `add` accepts numpy arrays or tensors
    (a tensor already on the device is never copied through the host);
    the device matrix is rebuilt from the pending rows at the next
    search."""

    def __init__(self, dim: int, metric: str = "ip",
                 device: DeviceLike = None):
        super().__init__(dim, metric)
        self.device = resolve_device(device)
        self._vecs = None  # no host copy: the rows live on the device
        self._rows = torch.zeros((0, dim), dtype=torch.float32,
                                 device=self.device)
        self._pending: List[torch.Tensor] = []  # added since the refresh
        self._flat: Optional[torch.Tensor] = None  # normalized rows

    def add(self, texts: Sequence[str], embeddings,
            metadatas: Optional[Sequence[Dict]] = None) -> List[int]:
        rows = torch.as_tensor(embeddings).to(device=self.device,
                                              dtype=torch.float32)
        self._check_rows(texts, rows)
        metadatas = metadatas or [{} for _ in texts]
        with self._lock:
            base = len(self._docs)
            self._pending.append(rows)
            self._flat = None
            self._docs.extend({"text": t, "metadata": dict(m)}
                              for t, m in zip(texts, metadatas))
            return list(range(base, base + len(texts)))

    def delete_documents(self, filenames: Sequence[str]) -> int:
        with self._lock:
            keep = self._kept_rows(filenames)
            removed = len(self._docs) - len(keep)
            if removed:
                self._refresh_flat()
                idx = torch.as_tensor(keep, dtype=torch.long,
                                      device=self.device)
                self._rows = self._rows.index_select(0, idx)
                self._docs = [self._docs[i] for i in keep]
                self._flat = None
            return removed

    def rows(self) -> torch.Tensor:
        """The stored rows [N, D] f32 on the device (pending adds folded
        in), as added: not normalized."""
        with self._lock:
            self._refresh_flat()
            return self._rows

    # -- device index lifecycle -------------------------------------------

    def _refresh_flat(self) -> None:
        """Lock held. Fold pending rows into the device matrix and
        (re)build the normalized search matrix after a mutation."""
        if self._pending:
            self._rows = torch.cat([self._rows, *self._pending])
            self._pending = []
        if self._flat is None:
            self._flat = (self._rows / torch.linalg.vector_norm(
                self._rows, dim=1, keepdim=True).clamp(min=1e-12)
                if self.metric == "cosine" else self._rows)

    # -- search ------------------------------------------------------------

    def _prep_query(self, q: np.ndarray) -> torch.Tensor:
        q = torch.as_tensor(np.asarray(q, np.float32)).to(self.device)
        if self.metric == "cosine":
            q = q / torch.linalg.vector_norm(q, dim=-1,
                                             keepdim=True).clamp(min=1e-12)
        return q

    def _device_search(self, qs: torch.Tensor, k: int):
        """One device dispatch for [Q, D] queries -> host (scores, ids)."""
        scores, idx = mips_topk(qs, self._flat, k)
        return scores.cpu().numpy(), idx.cpu().numpy()

    def _collect(self, scores, idx, score_threshold) -> List[SearchResult]:
        out = []
        for s, i in zip(scores, idx):
            if score_threshold is not None and float(s) < score_threshold:
                continue
            d = self._docs[int(i)]
            out.append(SearchResult(d["text"], float(s), dict(d["metadata"])))
        return out

    def _search_one(self, query_embedding: np.ndarray, top_k: int = 4,
                    score_threshold: Optional[float] = None
                    ) -> List[SearchResult]:
        with self._lock:
            if not self._docs:
                return []
            self._refresh_flat()
            self._n_searches += 1
            q = self._prep_query(query_embedding)
            k = min(top_k, len(self._docs))
            scores, idx = self._device_search(q[None, :], k)
            return self._collect(scores[0], idx[0], score_threshold)

    def _search_batch_direct(self, qs: np.ndarray, top_k: int,
                             score_threshold: Optional[float]
                             ) -> List[List[SearchResult]]:
        """All queries scored in ONE device dispatch."""
        with self._lock:
            if not self._docs:
                return [[] for _ in qs]
            self._refresh_flat()
            self._n_batched += 1
            self._n_searches += len(qs)
            k = min(top_k, len(self._docs))
            scores, idx = self._device_search(self._prep_query(qs), k)
            return [self._collect(s, i, score_threshold)
                    for s, i in zip(scores, idx)]


def create_vector_store(config, dim: Optional[int] = None,
                        device: DeviceLike = None):
    """Factory from AppConfig.vector_store. `memory` is the host store;
    `tpu` and `native` (the JAX config's names, kept so configs are
    shared) are the device store. Anything else, and every knob the port
    does not honour (`check_supported`), is refused by name."""
    vs = check_supported(config).vector_store
    dim = dim or config.embeddings.dimensions
    if vs.name in ("tpu", "native"):
        return DeviceVectorStore(dim, device=device)
    if vs.name == "memory":
        return MemoryVectorStore(dim)
    if vs.name in ("milvus", "pgvector"):
        raise ValueError(f"vector_store.name={vs.name!r}: the external "
                         f"stores are not ported yet (ROADMAP A.11)")
    raise ValueError(f"vector_store.name={vs.name!r} is not a bundled "
                     f"store; use one of memory | tpu | native")
