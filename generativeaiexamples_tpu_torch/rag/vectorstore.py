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
filename. With `persist_dir` a store is durable, in the JAX store's
format (`save` / `load`): `vectors.npz` (the f32 rows under "vecs",
compressed) and `docs.jsonl` (one document a line), each written to a
temporary file and moved into place, so a crash mid-save leaves the
previous snapshot whole. The store loads the directory at construction
and saves it after every add and delete. A directory saved by either
package loads in the other.

Both stores are `MicroBatchHost`s (serving/batcher.py): with
`enable_microbatch`, concurrent single-query `search` calls funnel into
one `search_batch` dispatch. `create_vector_store` also builds the
external milvus (rag/milvus_store.py) and pgvector
(rag/pgvector_store.py) stores, and the ephemeral in-process store of
conversation memory. IVF, int8 rows and the tiered index
(ROADMAP A.18) are not ported; `create_vector_store` refuses them by
name.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from generativeaiexamples_tpu_torch.config.schema import check_supported
from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device
from generativeaiexamples_tpu_torch.ops.topk import mips_topk
from generativeaiexamples_tpu_torch.serving.batcher import (
    MicroBatcher, MicroBatcherClosed, MicroBatchHost)


@dataclass
class SearchResult:
    text: str
    score: float
    metadata: Dict = field(default_factory=dict)


def _atomic_replace(path: str, write_fn) -> None:
    """Write via `write_fn(tmp_path)`, then os.replace into place: a crash
    mid-write leaves the previous file intact."""
    tmp = path + ".tmp"
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class MemoryVectorStore(MicroBatchHost):
    """Exact cosine/IP search over an [N, D] host matrix. Thread-safe.
    Durable with `persist_dir` (module docstring)."""

    def __init__(self, dim: int, metric: str = "ip",
                 persist_dir: Optional[str] = None):
        self.dim = dim
        self.metric = metric  # "ip" (normalized embeddings) or "cosine"
        self._vecs = np.zeros((0, dim), np.float32)
        self._docs: List[Dict] = []
        self._lock = threading.RLock()
        self._n_searches = 0
        self._n_batched = 0
        self.persist_dir = persist_dir or None
        if self.persist_dir:
            self._load_from(self.persist_dir)

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
            self._persist()
            return list(range(base, base + len(texts)))

    # -- cross-request micro-batching (serving/batcher.py) -----------------

    def _build_microbatcher(self, max_batch, max_wait_us) -> MicroBatcher:
        """enable_microbatch() funnels concurrent single-query search()
        callers through the one-dispatch search_batch path: N callers
        inside the window pay one GEMM and one top-k instead of N.
        Grouped by (top_k, score_threshold), so a group is exactly one
        batch call."""
        return MicroBatcher(
            f"search[{type(self).__name__}]", self._search_group,
            max_batch=max_batch or 16, max_wait_us=max_wait_us,
            bucket_fn=lambda item: (item[1], item[2]))

    def _search_group(self, items) -> List[List[SearchResult]]:
        """Batcher dispatch: items are (query [D], top_k, threshold)
        sharing one (top_k, threshold) key. A lone caller takes the
        single-query path. Unlike the JAX store, whose jitted search pads
        a group to a ladder of batch shapes, eager torch runs any [Q, D]
        shape as is, so there is no padding to hide from results or
        counters."""
        top_k, thr = items[0][1], items[0][2]
        if len(items) == 1:
            return [self._search_one(items[0][0], top_k, thr)]
        qs = np.stack([np.asarray(it[0], np.float32) for it in items])
        return self._search_batch_direct(qs, top_k, thr)

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
        b = self._batcher  # read once: a racing disable must not crash
        if b is not None:
            try:
                return b.submit((np.asarray(query_embedding, np.float32),
                                 top_k, score_threshold))
            except MicroBatcherClosed:
                pass  # raced a disable/re-enable: serve direct
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
        so batched and sequential results are identical. Already one
        dispatch: never enters the micro-batcher."""
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
            self._persist()
            return removed

    def __len__(self) -> int:
        return len(self._docs)

    def snapshot_docs(self):
        """Consistent copy of the doc list for lock-free downstream use
        (hybrid retrieval's lexical leg)."""
        with self._lock:
            return list(self._docs)

    # -- persistence -------------------------------------------------------

    def _host_rows(self) -> np.ndarray:
        """Lock held. The rows [N, D] f32 as a host array."""
        return self._vecs

    def _set_rows(self, rows: np.ndarray) -> None:
        """Lock held. Replace the rows with `rows` [N, D] f32."""
        self._vecs = rows

    def save(self, path: str) -> None:
        """Write the store to directory `path` (created if missing)."""
        with self._lock:
            os.makedirs(path, exist_ok=True)
            vecs, docs = self._host_rows(), list(self._docs)

            def write_vecs(tmp):
                with open(tmp, "wb") as fh:
                    np.savez_compressed(fh, vecs=vecs)

            def write_docs(tmp):
                with open(tmp, "w") as fh:
                    for d in docs:
                        fh.write(json.dumps(d) + "\n")

            _atomic_replace(os.path.join(path, "vectors.npz"), write_vecs)
            _atomic_replace(os.path.join(path, "docs.jsonl"), write_docs)

    @classmethod
    def load(cls, path: str, dim: int, metric: str = "ip", **kwargs):
        """A new store holding what `save` wrote to `path`."""
        store = cls(dim, metric, **kwargs)
        store._load_from(path)
        return store

    def _load_from(self, path: str) -> None:
        """Replace the contents with the snapshot at `path`, if it holds
        one; rows of another width raise."""
        vp = os.path.join(path, "vectors.npz")
        dp = os.path.join(path, "docs.jsonl")
        if not (os.path.isfile(vp) and os.path.isfile(dp)):
            return
        with self._lock:
            with np.load(vp) as z:
                loaded = z["vecs"].astype(np.float32)
            if loaded.size and loaded.shape[1] != self.dim:
                raise ValueError(
                    f"persisted store at {path} holds {loaded.shape[1]}-dim "
                    f"vectors but this store is configured for "
                    f"dim={self.dim}; re-ingest the corpus or fix "
                    f"embeddings.dimensions")
            with open(dp) as fh:
                docs = [json.loads(ln) for ln in fh if ln.strip()]
            self._set_rows(loaded.reshape(-1, self.dim))
            self._docs = docs

    def _persist(self) -> None:
        """Lock held. Save to `persist_dir` when the store has one."""
        if self.persist_dir:
            self.save(self.persist_dir)


class DeviceVectorStore(MemoryVectorStore):
    """Exact flat MIPS with the rows on the device (the counterpart of
    TPUVectorStore's flat index). `add` accepts numpy arrays or tensors
    (a tensor already on the device is never copied through the host);
    the device matrix is rebuilt from the pending rows at the next
    search."""

    def __init__(self, dim: int, metric: str = "ip",
                 device: DeviceLike = None,
                 persist_dir: Optional[str] = None):
        self.device = resolve_device(device)
        self._rows = torch.zeros((0, dim), dtype=torch.float32,
                                 device=self.device)
        self._pending: List[torch.Tensor] = []  # added since the refresh
        self._flat: Optional[torch.Tensor] = None  # normalized rows
        super().__init__(dim, metric, persist_dir)
        self._vecs = None  # no host copy: the rows live on the device

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
            self._persist()
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
            self._persist()
            return removed

    def _host_rows(self) -> np.ndarray:
        self._refresh_flat()
        return self._rows.cpu().numpy()

    def _set_rows(self, rows: np.ndarray) -> None:
        self._rows = torch.from_numpy(rows).to(self.device)
        self._pending = []
        self._flat = None

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
                        device: DeviceLike = None,
                        persist_dir: Optional[str] = None,
                        ephemeral: bool = False):
    """Factory from AppConfig.vector_store. `memory` is the host store;
    `tpu` and `native` (the JAX config's names, kept so configs are
    shared) are the device store; either is durable at `persist_dir`
    (usually config.vector_store.persist_dir). `milvus` and `pgvector`
    are external servers at `vector_store.url` (durable server-side) and
    fail loudly without one. Anything else, and every knob the port does
    not honour (`check_supported`), is refused by name.

    `ephemeral=True` marks a per-process scratch store (conversation
    memory): it is never persisted, and under milvus or pgvector it stays
    in-process as a `MemoryVectorStore`, so private conversation turns
    never land in the shared document collection."""
    vs = check_supported(config).vector_store
    dim = dim or config.embeddings.dimensions
    if ephemeral:
        persist_dir = None
    if vs.name == "milvus" and not ephemeral:
        from generativeaiexamples_tpu_torch.rag.milvus_store import (
            MilvusVectorStore)

        return MilvusVectorStore(vs.url, dim)
    if vs.name == "pgvector" and not ephemeral:
        from generativeaiexamples_tpu_torch.rag.pgvector_store import (
            PgVectorStore)

        return PgVectorStore(vs.url, dim)
    if vs.name in ("tpu", "native"):
        return DeviceVectorStore(dim, device=device, persist_dir=persist_dir)
    if vs.name in ("memory", "milvus", "pgvector"):
        return MemoryVectorStore(dim, persist_dir=persist_dir)
    raise ValueError(f"vector_store.name={vs.name!r} is not a bundled "
                     f"store; use one of memory | tpu | native | milvus | "
                     f"pgvector")
