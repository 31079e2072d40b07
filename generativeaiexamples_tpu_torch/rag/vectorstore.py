"""Vector stores: exact MIPS over host numpy or device memory, and the
device IVF ANN index.

Counterpart of generativeaiexamples_tpu/rag/vectorstore.py:

- `MemoryVectorStore`: numpy matmul top-k on the host.
- `DeviceVectorStore`: the counterpart of `TPUVectorStore`, scoring on
  the device (CUDA unless the caller asks for the CPU). With
  `index_type="flat"` (the default) the rows live on the device and
  nowhere else; rows added since the last search are folded into the
  device matrix lazily at the next search, and every search is one
  `ops.topk.mips_topk` dispatch. With `index_type="ivf"` the rows live
  in host memory, as the JAX store's do, and the device holds a flat
  mirror only while the store serves exact search; the clustered index
  of `ops/ivf.py` trains once the corpus passes IVF_MIN_ROWS (on a
  background thread when the search comes from the micro-batcher),
  streaming the host rows through the device in chunks, and once it is
  installed the device holds its table and nothing of the corpus. Adds
  are assigned without retraining, deletes and 50% growth retrain,
  `quantize_int8` stores int8 rows, and `tiered` pages partitions
  between device memory, host RAM and a disk spill (`ops/tiered.py`), so
  `hbm_budget_mb` bounds what the index holds there. The recall gauge's
  exact scan runs on the host over a snapshot of the rows.

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
conversation memory (always flat, as in JAX). With an IVF index the
store also writes `ivf.npz` (centroids and assignments) beside the
snapshot, in the JAX store's format, so a reload in either package skips
k-means.

With a `mesh` (parallel/mesh.py) the device store shards its index over
the mesh axis `shard_axis`, in this process, as the JAX store does: flat
search is `ops.topk.ShardedMIPSIndex` (contiguous row blocks), ivf
`ops.ivf.ShardedIVFIndex` (rows round-robin; rows added to a live
sharded index are folded in by an off-lock re-layout, not a scatter).
The rows then live on the host, and the shards hold the device copies.
The tiered index is single-device and refused beside a mesh.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from generativeaiexamples_tpu_torch.config.schema import check_supported
from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device
from generativeaiexamples_tpu_torch.ops.ivf import to_host
from generativeaiexamples_tpu_torch.ops.topk import (
    ShardedMIPSIndex, mips_topk)
from generativeaiexamples_tpu_torch.serving.batcher import (
    MicroBatcher, MicroBatcherClosed, MicroBatchHost)

_LOG = logging.getLogger(__name__)


@dataclass
class SearchResult:
    text: str
    score: float
    metadata: Dict = field(default_factory=dict)


# Below this corpus size an IVF index buys nothing (one coarse scan would
# cost as much as the exact matmul): the store stays on the exact path
# and trains lazily once the corpus grows past it.
IVF_MIN_ROWS = 256
# Retrain when the corpus grew by this fraction since training: the
# centroids no longer describe the data (incremental adds only assign).
IVF_REBUILD_GROWTH = 0.5
# Every Nth ANN search also runs the exact scorer and folds top-k overlap
# into the running ann_recall_est gauge.
RECALL_SAMPLE_EVERY = 32


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
            return [self._search_one(items[0][0], top_k, thr,
                                     defer_async=True)]
        qs = np.stack([np.asarray(it[0], np.float32) for it in items])
        return self._search_batch_direct(qs, top_k, thr, defer_async=True)

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
                    score_threshold: Optional[float] = None,
                    defer_async: bool = False) -> List[SearchResult]:
        """`defer_async` (the micro-batcher's dispatcher) moves slow
        post-search work off the calling thread: a no-op here (see
        DeviceVectorStore)."""
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
                             score_threshold: Optional[float],
                             defer_async: bool = False
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
            self._save_extra(path)

    def _save_extra(self, path: str) -> None:
        """Lock held. Hook for index sidecars (DeviceVectorStore's
        ivf.npz)."""

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
            self._load_extra(path)

    def _load_extra(self, path: str) -> None:
        """Lock held. Hook for index sidecars (DeviceVectorStore's
        ivf.npz)."""

    def _persist(self) -> None:
        """Lock held. Save to `persist_dir` when the store has one."""
        if self.persist_dir:
            self.save(self.persist_dir)


class DeviceVectorStore(MemoryVectorStore):
    """Same interface; the scoring runs on the device (the counterpart of
    TPUVectorStore). `add` accepts numpy arrays or tensors. A flat store
    keeps its rows on the device (a tensor already there is never copied
    through the host) and rebuilds the device matrix from the pending
    rows at the next search; an ivf store keeps them on the host (module
    docstring).

    `index_type="flat"` (the default) is exact MIPS. `index_type="ivf"`
    trains a k-means clustered index (ops/ivf.py) once the corpus passes
    IVF_MIN_ROWS: searches scan only the top-`nprobe` of `nlist`
    partitions, an add assigns its rows without retraining or moving the
    corpus, deletes (row ids shift) and >50% growth trigger a rebuild,
    and `quantize_int8` stores int8 rows + per-row scales. `tiered=True`
    (ivf only) swaps in the demand-paged TieredIVFIndex (ops/tiered.py):
    the device holds only the most-probed partitions inside
    `hbm_budget_mb`, the rest pages through a host-RAM warm cache and an
    mmap'd disk spill, adds land in warm tail slots, and a single-flight
    background pass (kicked after searches) promotes and demotes
    partitions and compacts tails. Its gauges ride `stats()`. With a
    `mesh` the index is sharded over its `shard_axis` (module docstring)
    and the store's device defaults to that axis's first device."""

    def __init__(self, dim: int, metric: str = "ip",
                 device: DeviceLike = None,
                 persist_dir: Optional[str] = None, *, mesh=None,
                 shard_axis: str = "tensor",
                 index_type: str = "flat", nlist: int = 64,
                 nprobe: int = 16, quantize_int8: bool = False,
                 tiered: bool = False, hbm_budget_mb: int = 256,
                 ram_budget_mb: int = 1024,
                 spill_dir: Optional[str] = None,
                 pager_ema_decay: float = 0.98):
        if index_type not in ("flat", "ivf"):
            raise ValueError(
                f"index_type={index_type!r} not supported; use flat | ivf")
        if tiered and index_type != "ivf":
            raise ValueError(
                "vector_store.tiered requires index_type=ivf (the tiered "
                "index pages IVF partitions; there is no tiered flat scan)")
        if tiered and mesh is not None:
            raise ValueError(
                "vector_store.tiered is single-device (HBM is the hot "
                "CACHE tier); unset the mesh or tiered")
        self.mesh = mesh
        self.shard_axis = shard_axis
        if device is None and mesh is not None:
            from generativeaiexamples_tpu_torch.parallel.mesh import (
                axis_devices)

            device = axis_devices(mesh, shard_axis)[0]
        self.device = resolve_device(device)
        # Where the rows live: the device for an unsharded flat store (its
        # only copy), else the host (the index holds its own tables, or
        # the shards their blocks, on the devices).
        self._home = self.device if index_type == "flat" and mesh is None \
            else torch.device("cpu")
        # Host rows of a CUDA store are pinned: the trainer streams them
        # through the card several times.
        self._pin = self._home.type == "cpu" and self.device.type == "cuda"
        self._rows = torch.zeros((0, dim), dtype=torch.float32,
                                 device=self._home)
        self._pending: List[torch.Tensor] = []  # added since the refresh
        # The exact path's device matrix (normalized rows for cosine), or
        # with a mesh its ShardedMIPSIndex.
        self._flat = None
        self.tiered = bool(tiered)
        self.hbm_budget_mb = int(hbm_budget_mb)
        self.ram_budget_mb = int(ram_budget_mb)
        self._spill_dir_cfg = spill_dir or None
        self._spill_dir_tmp = None  # made lazily for ephemeral stores
        self.pager_ema_decay = float(pager_ema_decay)
        self.index_type = index_type
        self.nlist = int(nlist)
        self.nprobe = int(nprobe)
        self.quantize_int8 = bool(quantize_int8)
        self._ivf = None
        self._ivf_synced_rows = 0   # rows already in the index
        self._ivf_trained_rows = 0  # corpus size when centroids trained
        self._ivf_stale = False     # row ids shifted (delete) -> rebuild
        self._loaded_ivf_state = None  # persisted centroids/assignments
        self._dirty = True
        self._ann_probes = 0
        self._ann_scanned = 0
        self._rebuilds = 0
        self._recall_sum = 0.0
        self._recall_n = 0
        self._pending_sample = None
        self._pending_sidecar = None
        # Single-flight state for the dispatcher-offloaded slow work
        # (_flush_slow_work / _kick_training_async): one worker at a
        # time, samples dropped when busy, the latest sidecar latched.
        self._slow_lock = threading.Lock()
        self._slow_busy = False
        self._slow_next_sidecar = None
        self._train_busy = False
        # Errors swallowed on background threads (trainer, slow worker,
        # tier maintenance): logged AND counted, since a daemon thread
        # has no caller to propagate to.
        self._bg_errors = 0
        # Serializes every ivf.npz write and unlink (the atomic-replace
        # temporary name is fixed).
        self._sidecar_lock = threading.Lock()
        self.recall_sample_every = RECALL_SAMPLE_EVERY
        super().__init__(dim, metric, persist_dir)
        self._vecs = None  # the rows are `_rows`, on `_home`

    def add(self, texts: Sequence[str], embeddings,
            metadatas: Optional[Sequence[Dict]] = None) -> List[int]:
        rows = self._homed(torch.as_tensor(embeddings))
        self._check_rows(texts, rows)
        metadatas = metadatas or [{} for _ in texts]
        with self._lock:
            base = len(self._docs)
            self._pending.append(rows)
            self._dirty = True
            self._docs.extend({"text": t, "metadata": dict(m)}
                              for t, m in zip(texts, metadatas))
            self._persist()
            return list(range(base, base + len(texts)))

    def delete_documents(self, filenames: Sequence[str]) -> int:
        with self._lock:
            keep = self._kept_rows(filenames)
            removed = len(self._docs) - len(keep)
            if removed:
                self._fold_pending()
                idx = torch.as_tensor(keep, dtype=torch.long,
                                      device=self._home)
                self._rows = self._rows.index_select(0, idx)
                self._docs = [self._docs[i] for i in keep]
                self._flat = None
                self._dirty = True
                # Row ids shifted: every partition assignment is invalid,
                # a not-yet-consumed persisted snapshot included. (A
                # no-op delete keeps the index: nothing moved.)
                self._ivf_stale = True
                self._loaded_ivf_state = None
            if not self._docs and self._ivf is not None:
                # Emptied out: drop the index now (an empty store never
                # refreshes, so stats would keep reporting a live index).
                self._ivf = None
                self._ivf_stale = False
                self._ivf_synced_rows = 0
            self._persist()
            return removed

    def _host_rows(self) -> np.ndarray:
        """Lock held. The rows [N, D] f32 (pending adds folded in) as a
        host array. The base class's save calls it inside `self._lock`;
        taking the RLock again costs nothing and keeps the fold's writes
        provably locked from this class's side too."""
        with self._lock:
            self._fold_pending()
            return self._rows.cpu().numpy()

    def _set_rows(self, rows: np.ndarray) -> None:
        """Lock held. Replace the rows with `rows` [N, D] f32 (the base
        class's load calls it inside `self._lock`, re-taken here as in
        `_host_rows`)."""
        with self._lock:
            self._rows = torch.from_numpy(rows).to(self._home)
            self._pending = []
            self._flat = None
            self._dirty = True

    def rows(self) -> torch.Tensor:
        """The stored rows [N, D] f32 (pending adds folded in), as added:
        not normalized. On the device for a flat store, on the host for
        an ivf one."""
        with self._lock:
            self._fold_pending()
            return self._rows

    # -- device index lifecycle -------------------------------------------

    def _homed(self, rows: torch.Tensor) -> torch.Tensor:
        """`rows` as f32 on `_home` (pinned host memory for a CUDA ivf
        store)."""
        if not self._pin:
            return rows.to(device=self._home, dtype=torch.float32)
        out = torch.empty(rows.shape, dtype=torch.float32, pin_memory=True)
        return out.copy_(rows)

    def _fold_pending(self) -> None:
        """Lock held. Fold pending rows into the rows. `_rows` is
        replaced, never written in place, so a reference taken earlier
        (the trainer's, the recall sample's) stays a consistent
        snapshot."""
        if self._pending:
            parts = [p for p in (self._rows, *self._pending) if len(p)]
            if not parts:
                pass  # only empty adds
            elif self._pin and len(parts) == 1:
                self._rows = parts[0]  # already a copy of its own
            elif self._pin:
                out = torch.empty((sum(len(p) for p in parts), self.dim),
                                  dtype=torch.float32, pin_memory=True)
                self._rows = torch.cat(parts, out=out)
            else:
                self._rows = torch.cat(parts)
            self._pending = []
            self._flat = None

    def _refresh_flat(self) -> None:
        """Lock held. The exact path's device matrix (normalized rows for
        cosine): the rows themselves for a flat store, a device mirror of
        the host rows for an ivf store (dropped when the index installs,
        as the JAX store drops its `_device_index`); with a mesh, a
        ShardedMIPSIndex over them."""
        self._fold_pending()
        if self._flat is None:
            if self.mesh is not None:
                self._flat = ShardedMIPSIndex(
                    self._normalized(self._rows), self.mesh, self.shard_axis)
            else:
                self._flat = self._normalized(self._rows.to(self.device))

    def _normalized(self, rows: torch.Tensor) -> torch.Tensor:
        if self.metric == "cosine":
            return rows / torch.linalg.vector_norm(
                rows, dim=1, keepdim=True).clamp(min=1e-12)
        return rows

    def _refresh(self) -> None:
        """Lock held (the search paths call it inside the store lock);
        everything here stays cheap: slow (re)builds go through the
        off-lock trainer."""
        if not self._dirty:
            return
        self._fold_pending()
        wants_ivf = (self.index_type == "ivf"
                     and len(self._docs) >= IVF_MIN_ROWS)
        if wants_ivf and self._ivf is not None and not self._ivf_stale:
            self._sync_ivf_incremental()
        if wants_ivf and self._ivf is not None and not self._ivf_stale:
            self._flat = None  # the exact mirror is superseded: freed
            # A sharded index lagging the corpus (its re-layout is
            # off-lock work) keeps the dirty flag: this query serves the
            # rows it has; the next search's trainer folds the tail in.
            self._dirty = self._ivf_synced_rows < len(self._docs)
            return
        # Exact path: no index wanted, corpus below the floor, or the
        # index is stale or untrained (training happens outside the lock
        # in _maybe_train_ivf; this is the correct fallback meanwhile).
        if wants_ivf and self._ivf is not None:
            # Dropping a live index (overflow or a raced mutation): the
            # retrain happens at the next search's trainer; count the
            # rebuild here, where it is forced.
            self._rebuilds += 1
        self._ivf = None
        self._ivf_stale = False
        self._ivf_synced_rows = 0
        self._refresh_flat()
        self._dirty = False

    def _sync_ivf_incremental(self) -> None:
        """Lock held. Fold rows added since the last sync into the index
        (one assign matmul + a tail-slot scatter, or tail slots of the
        tiered index). An add that would skew a partition past the
        table's growth cap is refused by the index: mark stale so the
        next search retrains off-lock. A sharded index's sync re-gathers
        the corpus, so it runs through the off-lock trainer instead
        (_ivf_wants_relayout): a no-op here."""
        from generativeaiexamples_tpu_torch.ops.ivf import ShardedIVFIndex

        n = len(self._docs)
        if n <= self._ivf_synced_rows or isinstance(self._ivf,
                                                    ShardedIVFIndex):
            return
        new = self._normalized(self._rows[self._ivf_synced_rows:])
        if not self._ivf.add(new):
            self._ivf_stale = True  # rebuild at the next search
            return
        self._ivf_synced_rows = n
        if self.persist_dir:
            # The add-time save removed the lagging sidecar; it is current
            # again now (written after the lock drops).
            self._pending_sidecar = self._ivf.state()

    def _ivf_needs_train(self) -> bool:
        """Lock held. True when a (re)train is due: no index yet, row ids
        shifted (delete or overflow), >50% growth since training, or a
        skewed table (padding = wasted refine bandwidth)."""
        n = len(self._docs)
        if self.index_type != "ivf" or n < IVF_MIN_ROWS:
            return False
        if self._ivf is None or self._ivf_stale:
            return True
        if self._ivf_trained_rows and \
                (n - self._ivf_trained_rows) / self._ivf_trained_rows \
                > IVF_REBUILD_GROWTH:
            return True
        return self._ivf.max_list_len > 4 * max(1, n // self._ivf.nlist)

    def _ivf_wants_relayout(self) -> bool:
        """Lock held. A live SHARDED index lagging the corpus: folding
        rows in means rebuilding the per-shard tables (a corpus
        re-gather), which happens off-lock like training."""
        from generativeaiexamples_tpu_torch.ops.ivf import ShardedIVFIndex

        return (isinstance(self._ivf, ShardedIVFIndex)
                and not self._ivf_stale
                and self._ivf_synced_rows < len(self._docs))

    def _kick_training_async(self) -> None:
        """Run _maybe_train_ivf on a background thread (single-flight).
        The micro-batcher's one dispatcher thread must not stall every
        queued search behind k-means; until the install lands, searches
        serve the exact or stale path (always correct)."""
        with self._lock:
            needed = self._ivf_needs_train() or self._ivf_wants_relayout()
        if not needed:
            return
        with self._slow_lock:
            if self._train_busy:
                return
            self._train_busy = True

        def run():
            try:
                self._maybe_train_ivf()
            except Exception:
                # No caller to propagate to: log + count; the next search
                # kicks training again.
                _LOG.exception("background IVF training failed")
                with self._slow_lock:
                    self._bg_errors += 1
            finally:
                with self._slow_lock:
                    self._train_busy = False

        threading.Thread(target=run, name="vectorstore-ivf-train",
                         daemon=True).start()

    def _maybe_train_ivf(self) -> None:
        """Train or rebuild the IVF index WITHOUT holding the store lock:
        k-means over a snapshot of the device rows runs for seconds at
        scale, and concurrent searches and ingests must not queue behind
        it; the result installs under the lock. A delete racing the build
        voids the snapshot's assignments (seen through _ivf_stale) and is
        retried; adds during the build are fine (the next search folds
        them in). A live sharded index lagging the corpus is re-laid out
        here from its own centroids and assignments (the tail assigned,
        a full retrain on skew)."""
        from generativeaiexamples_tpu_torch.ops.ivf import (
            IVFIndex, ShardedIVFIndex, as_rows, extend_assignments)

        if self.index_type != "ivf":
            return
        sidecar = None
        for _ in range(3):
            with self._lock:
                needs = self._ivf_needs_train()
                relayout = not needs and self._ivf_wants_relayout()
                if not needs and not relayout:
                    break
                rebuilding = needs and self._ivf is not None
                self._fold_pending()
                rows = self._rows
                n = len(rows)
                trained_rows = self._ivf_trained_rows
                if relayout:
                    # The live index's training, as it is; only the tail
                    # rows need assigning.
                    state = dict(self._ivf.state())
                elif rebuilding:
                    self._loaded_ivf_state = None
                    state = {}
                else:
                    state = self._loaded_ivf_state or {}
                    if state.get("assignments") is not None and \
                            len(state["assignments"]) != n:
                        state = {}  # snapshot predates later mutations
                self._ivf_stale = False  # building against this snapshot
            # -- slow part: no lock held --------------------------------
            norm = self._normalized(rows)
            if relayout:
                grown = extend_assignments(
                    norm[len(state["assignments"]):],
                    as_rows(state["centroids"], self.device),
                    state["assignments"],
                    4 * max(1, n // len(state["centroids"])))
                if grown is None:
                    # Hot-partition skew: a full retrain instead.
                    state, relayout, rebuilding = {}, False, True
                else:
                    state["assignments"] = grown
            # Partitions need enough rows to be worth probing: clamp
            # nlist so the average list holds >= 8 rows.
            nlist = max(1, min(self.nlist, n // 8))
            kw = dict(nprobe=self.nprobe, quantize_int8=self.quantize_int8,
                      centroids=state.get("centroids"),
                      assignments=state.get("assignments"))
            if self.tiered:
                from generativeaiexamples_tpu_torch.ops.tiered import (
                    TieredIVFIndex)

                built = TieredIVFIndex(
                    norm, nlist, hbm_budget_bytes=self.hbm_budget_mb << 20,
                    ram_budget_bytes=self.ram_budget_mb << 20,
                    spill_dir=self._tier_spill_dir(),
                    ema_decay=self.pager_ema_decay, device=self.device,
                    **kw)
            elif self.mesh is not None:
                built = ShardedIVFIndex(norm, nlist, self.mesh,
                                        self.shard_axis, **kw)
            else:
                built = IVFIndex(norm, nlist, device=self.device, **kw)
            with self._lock:
                if self._ivf_stale or len(self._docs) < n:
                    continue  # a delete raced the build: retry
                self._ivf = built
                self._ivf_synced_rows = n
                self._ivf_trained_rows = (trained_rows or n) if relayout \
                    else n
                self._flat = None
                # Rows added during the build are not in the snapshot:
                # the next refresh folds them in.
                self._dirty = True
                if rebuilding:
                    self._rebuilds += 1
                if self.persist_dir:
                    # Training happens at search time, not mutation time:
                    # persist the sidecar (outside the lock, below) so a
                    # restart reloads the centroids.
                    sidecar = built.state()
                break
        else:
            # Deletes keep racing the trainer: this query serves the
            # exact path; a later search tries again.
            return
        if sidecar is not None:
            self._write_sidecar(sidecar)

    def _tier_spill_dir(self) -> str:
        """Where the tiered index spills cold partition blocks: the
        configured spill_dir > a `tiered/` subdirectory of persist_dir >
        a per-store temporary directory, removed when the store is
        collected (an ephemeral corpus still needs a cold tier)."""
        if self._spill_dir_cfg:
            return self._spill_dir_cfg
        if self.persist_dir:
            return os.path.join(self.persist_dir, "tiered")
        if self._spill_dir_tmp is None:
            import shutil
            import tempfile
            import weakref

            self._spill_dir_tmp = tempfile.mkdtemp(prefix="gaie_tiered_")
            weakref.finalize(self, shutil.rmtree, self._spill_dir_tmp,
                             ignore_errors=True)
        return self._spill_dir_tmp

    def _maybe_kick_tier_maintenance(self) -> None:
        """Hand the tiered index's pager and compactor one single-flight
        background pass when it says work is due. Called after the store
        lock drops (the pass installs under the index's own tier
        lock)."""
        ivf = self._ivf
        if ivf is not None and hasattr(ivf, "maintenance_due") \
                and ivf.maintenance_due():
            ivf.kick_maintenance(on_error=self._note_bg_error)

    def _note_bg_error(self) -> None:
        with self._slow_lock:
            self._bg_errors += 1

    # -- search ------------------------------------------------------------

    def _prep_query(self, q: np.ndarray) -> torch.Tensor:
        q = torch.as_tensor(np.asarray(q, np.float32)).to(self.device)
        if self.metric == "cosine":
            q = q / torch.linalg.vector_norm(q, dim=-1,
                                             keepdim=True).clamp(min=1e-12)
        return q

    def _device_search(self, qs: torch.Tensor, k: int):
        """Lock held. One device search of [Q, D] queries -> host
        (scores, ids); updates the ANN counters. Every
        recall_sample_every-th search queues a recall sample that the
        caller runs after releasing the lock."""
        if self._ivf is not None:
            scores, idx, scanned = self._ivf.search(qs, k)
            idx = to_host(idx)
            self._ann_probes += len(qs) * self._ivf.nprobe
            self._ann_scanned += scanned
            if self._n_searches % self.recall_sample_every == 0:
                # _rows (host) is replaced on mutation, never written in
                # place: the reference is a snapshot to scan off the lock.
                self._pending_sample = (qs[0].clone(), idx[0].copy(), k,
                                        self._rows)
            return to_host(scores), idx
        if self.mesh is not None:
            scores, idx = self._flat.search(qs, k)
        else:
            scores, idx = mips_topk(qs, self._flat, k)
        return scores.cpu().numpy(), idx.cpu().numpy()

    def _pop_pending(self):
        """Lock held. The queued recall sample and sidecar, cleared."""
        out = self._pending_sample, self._pending_sidecar
        self._pending_sample = self._pending_sidecar = None
        return out

    def _collect(self, scores, idx, score_threshold) -> List[SearchResult]:
        out = []
        for s, i in zip(scores, idx):
            i = int(i)
            # IVF pads short candidate sets with id -1 / -inf.
            if i < 0 or i >= len(self._docs) or not np.isfinite(s):
                continue
            if score_threshold is not None and float(s) < score_threshold:
                continue
            d = self._docs[i]
            out.append(SearchResult(d["text"], float(s), dict(d["metadata"])))
        return out

    def _search_one(self, query_embedding: np.ndarray, top_k: int = 4,
                    score_threshold: Optional[float] = None,
                    defer_async: bool = False) -> List[SearchResult]:
        # Slow k-means runs before the lock; from the micro-batcher's
        # dispatcher it goes to a background thread instead.
        if defer_async:
            self._kick_training_async()
        else:
            self._maybe_train_ivf()
        with self._lock:
            if not self._docs:
                return []
            self._refresh()
            self._n_searches += 1
            q = self._prep_query(query_embedding)
            k = min(top_k, len(self._docs))
            scores, idx = self._device_search(q[None, :], k)
            out = self._collect(scores[0], idx[0], score_threshold)
            sample, sidecar = self._pop_pending()
        self._flush_slow_work(sample, sidecar, asynchronously=defer_async)
        self._maybe_kick_tier_maintenance()
        return out

    def _search_batch_direct(self, qs: np.ndarray, top_k: int,
                             score_threshold: Optional[float],
                             defer_async: bool = False
                             ) -> List[List[SearchResult]]:
        """All queries scored in ONE device search (one matmul for flat,
        one probe + refine for IVF)."""
        if defer_async:
            self._kick_training_async()
        else:
            self._maybe_train_ivf()
        with self._lock:
            if not self._docs:
                return [[] for _ in qs]
            self._refresh()
            self._n_batched += 1
            self._n_searches += len(qs)
            k = min(top_k, len(self._docs))
            scores, idx = self._device_search(self._prep_query(qs), k)
            out = [self._collect(s, i, score_threshold)
                   for s, i in zip(scores, idx)]
            sample, sidecar = self._pop_pending()
        self._flush_slow_work(sample, sidecar, asynchronously=defer_async)
        self._maybe_kick_tier_maintenance()
        return out

    # -- slow post-search work ---------------------------------------------

    def _flush_slow_work(self, sample, sidecar, *,
                         asynchronously: bool = False) -> None:
        """The recall sample's exact scan and the ivf.npz write: inline on
        a caller's thread, on a SINGLE-FLIGHT worker from the
        micro-batcher's dispatcher (which must keep draining searches).
        While a worker runs, new samples are dropped (a sampled gauge
        loses nothing) and the newest sidecar is latched for it."""
        if sample is None and sidecar is None:
            return
        if asynchronously:
            with self._slow_lock:
                if self._slow_busy:
                    if sidecar is not None:
                        self._slow_next_sidecar = sidecar  # latest wins
                    return
                self._slow_busy = True
            threading.Thread(
                target=self._slow_worker, args=(sample, sidecar),
                name="vectorstore-slow-work", daemon=True).start()
            return
        if sidecar is not None:
            self._write_sidecar(sidecar)
        if sample:
            self._run_recall_sample(*sample)

    def _slow_worker(self, sample, sidecar) -> None:
        try:
            while True:
                self._flush_slow_work(sample, sidecar)
                with self._slow_lock:
                    sidecar = self._slow_next_sidecar
                    self._slow_next_sidecar = None
                    if sidecar is None:
                        self._slow_busy = False
                        return
                sample = None  # only the latched sidecar remains
        except BaseException as e:
            with self._slow_lock:
                self._slow_busy = False
                # Drop the latch too: a later worker must not write this
                # now-stale sidecar over a newer one.
                self._slow_next_sidecar = None
                if isinstance(e, Exception):
                    self._bg_errors += 1
            if not isinstance(e, Exception):
                raise  # KeyboardInterrupt / SystemExit: never swallowed
            _LOG.exception("vectorstore slow worker failed "
                           "(recall sample / sidecar write dropped)")

    def _run_recall_sample(self, q: torch.Tensor, ann_idx: np.ndarray,
                           k: int, rows: torch.Tensor) -> None:
        """Fold one exact-vs-ANN overlap@k sample into the recall gauge:
        the exact scan runs where the rows snapshot lies (the host, as in
        the JAX store), outside the store lock (row norms divide the
        scores for cosine; no normalized copy of the corpus)."""
        scores = torch.matmul(rows, q.to(rows.device))
        if self.metric == "cosine":
            scores = scores / torch.linalg.vector_norm(
                rows, dim=1).clamp(min=1e-12)
        kk = min(k, len(scores))
        truth = set(torch.topk(scores, kk).indices.cpu().tolist())
        got = [int(i) for i in ann_idx[:kk] if 0 <= int(i) < len(scores)]
        with self._lock:
            self._recall_sum += len(truth.intersection(got)) \
                / max(1, len(truth))
            self._recall_n += 1

    # -- persistence -------------------------------------------------------

    def _dump_ivf_state(self, path: str, state: Dict) -> None:
        """The one ivf.npz writer (atomic, serialized by _sidecar_lock):
        save(), the deferred search-path writer and the trainer all go
        through it, in the JAX store's format."""
        with self._sidecar_lock:
            os.makedirs(path, exist_ok=True)

            def write(tmp):
                with open(tmp, "wb") as fh:
                    np.savez_compressed(fh, **state)

            _atomic_replace(os.path.join(path, "ivf.npz"), write)

    def _write_sidecar(self, state: Dict) -> None:
        """Persist IVF training state (no store lock: `state` is a
        snapshot). A racing mutation-save may remove or replace the file:
        benign, the loader checks row counts."""
        if self.persist_dir:
            self._dump_ivf_state(self.persist_dir, state)

    def _save_extra(self, path: str) -> None:
        """Lock held. The trained IVF state next to the corpus, so a
        reload skips k-means; removed instead when the index lags the
        corpus (the loader would mis-assign)."""
        ip = os.path.join(path, "ivf.npz")
        if self._ivf is None or self._ivf_synced_rows != len(self._docs):
            with self._sidecar_lock:  # vs an in-flight sidecar write
                if os.path.exists(ip):
                    os.unlink(ip)
            return
        self._dump_ivf_state(path, self._ivf.state())

    def _load_extra(self, path: str) -> None:
        """Lock held. Accept a persisted ivf.npz that matches the corpus
        and the configured index geometry (the index takes nlist from the
        loaded centroids, so a stale shape would pin an old nlist)."""
        ip = os.path.join(path, "ivf.npz")
        if self.index_type != "ivf" or not os.path.isfile(ip):
            return
        with np.load(ip) as z:
            state = {"centroids": z["centroids"].astype(np.float32),
                     "assignments": z["assignments"].astype(np.int32)}
        expected_nlist = max(1, min(self.nlist, len(self._docs) // 8))
        if len(state["assignments"]) == len(self._docs) and \
                state["centroids"].shape == (expected_nlist, self.dim):
            self._loaded_ivf_state = state

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict:
        # _bg_errors is guarded by _slow_lock; read it under that lock,
        # taken before (never inside) the store lock.
        with self._slow_lock:
            bg_errors = self._bg_errors
        with self._lock:
            out = super().stats()
            live = "ivf" if self._ivf is not None else "flat"
            if self.index_type == "ivf" and live == "flat":
                live = "flat(ivf pending)"  # corpus below IVF_MIN_ROWS
            out.update({
                "index": live,
                "nlist": self._ivf.nlist if self._ivf is not None else None,
                "nprobe": self.nprobe,
                "quantize_int8": self.quantize_int8,
                "ann_probes": self._ann_probes,
                "ann_scanned_rows": self._ann_scanned,
                "ann_recall_est": (round(self._recall_sum / self._recall_n, 4)
                                   if self._recall_n else None),
                "index_rebuilds": self._rebuilds,
                "background_errors": bg_errors,
                "tiered": self.tiered,
            })
            ivf = self._ivf
        # Pager gauges read OFF the store lock: the index has its own tier
        # lock, and searches take store -> tier.
        if ivf is not None and hasattr(ivf, "tier_stats"):
            ts = ivf.tier_stats()
            out.update({"index": "ivf_tiered", **{key: ts[key] for key in (
                "hbm_resident_fraction", "pager_hbm_hit_rate",
                "tier_promotions", "tier_demotions", "tier_compactions",
                "tier_tail_rows", "tier_warm_bytes", "tier_spill_bytes",
                "tier_hot_slots", "hbm_resident_rows")}})
        return out


def create_vector_store(config, dim: Optional[int] = None,
                        device: DeviceLike = None,
                        persist_dir: Optional[str] = None,
                        ephemeral: bool = False, *, mesh=None,
                        shard_axis: str = "tensor"):
    """Factory from AppConfig.vector_store. `memory` is the host store;
    `tpu` and `native` (the JAX config's names, kept so configs are
    shared) are the device store, with every index knob of the config
    (`index_type`, `nlist`, `nprobe`, `quantize_int8`, `tiered`,
    `hbm_budget_mb`, `ram_budget_mb`, `spill_dir`, `pager_ema_decay`);
    either is durable at `persist_dir` (usually
    config.vector_store.persist_dir). `milvus` and `pgvector` are
    external servers at `vector_store.url` (durable server-side) and fail
    loudly without one. Anything else, and every knob the port does not
    honour (`check_supported`), is refused by name. A `mesh` shards the
    device store's index over `shard_axis` (DeviceVectorStore).

    `ephemeral=True` marks a per-process scratch store (conversation
    memory): it is never persisted, stays on the exact flat path (far
    below IVF scale), and under milvus or pgvector it stays in-process as
    a `MemoryVectorStore`, so private conversation turns never land in
    the shared document collection."""
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
        if ephemeral:
            return DeviceVectorStore(dim, device=device, mesh=mesh,
                                     shard_axis=shard_axis)
        return DeviceVectorStore(
            dim, device=device, persist_dir=persist_dir, mesh=mesh,
            shard_axis=shard_axis,
            index_type=vs.index_type, nlist=vs.nlist, nprobe=vs.nprobe,
            quantize_int8=vs.quantize_int8, tiered=vs.tiered,
            hbm_budget_mb=vs.hbm_budget_mb, ram_budget_mb=vs.ram_budget_mb,
            spill_dir=vs.spill_dir or None,
            pager_ema_decay=vs.pager_ema_decay)
    if vs.name in ("memory", "milvus", "pgvector"):
        return MemoryVectorStore(dim, persist_dir=persist_dir)
    raise ValueError(f"vector_store.name={vs.name!r} is not a bundled "
                     f"store; use one of memory | tpu | native | milvus | "
                     f"pgvector")
