"""IVF (inverted-file) approximate MIPS on the device.

Counterpart of generativeaiexamples_tpu/ops/ivf.py, which is plain `jnp`
there (einsums, `lax.top_k`, gathers, `segment_sum`; no Pallas kernel),
so the port is plain torch: `torch.matmul`, `index_select`, `torch.bmm`
and `torch.topk`. The classic two-stage shape, entirely on the device:

1. train: k-means centroids over the corpus (Lloyd iterations, each a
   [N,D]x[D,nlist] matmul plus a segment sum), then a capacity-balanced
   assignment (each row to its nearest centroid with room, cap 1.25x the
   mean list size), which bounds the padded refine width and leaves tail
   headroom for incremental adds.
2. search: coarse [Q,D]x[D,nlist] centroid scan -> top-`nprobe`
   partitions a query -> gather only those partitions' row blocks -> one
   batched refine matmul -> top-k.

Storage is partition-blocked, `db3 [nlist, max_len, D]` with a
local->global row-id map `g3` (pad = -1); int8 rows (per-row symmetric
amax/127 scales) store the corpus at 1/4 of the f32 bytes.

Two layouts, mirroring `ops/topk.py`:
- `IVFIndex`: single-device; `add()` assigns new rows with one
  [M,D]x[D,nlist] matmul and scatters them into partition tail slots.
- `ShardedIVFIndex`: corpus rows round-robin over a mesh axis
  (parallel/mesh.py `axis_devices`, one process as in JAX), every shard
  holding a full [nlist, max_len_local, D] table of its rows (shared
  centroids and assignments). Each shard probes the same `nprobe`
  partitions over its rows and keeps a local top-k; the
  [Q, n_shards * k] candidates are copied to the first shard's device,
  concatenated and reduced, as `ShardedMIPSIndex` does.

What differs from the JAX arithmetic, and why:
- The segment sum of a Lloyd step is a chunked one-hot matmul, not an
  `index_add_`: CUDA adds with atomics in no fixed order, so two
  trainings would give centroids that differ in the last bits. A matmul
  of one shape sums in one order, so one seed gives one set of centroids.
- k-means draws its initial rows with a `torch.Generator` seeded from
  `seed` (torch cannot reproduce `jax.random.choice`); `init=` takes
  given initial centroids instead.
- The coarse scan and every top-k run in fixed tiles of
  `ops.topk.QUERY_TILE` queries (the last padded), and the refine scores
  each query with one matrix-vector product of a fixed shape, so a query
  alone and the same query in a coalesced batch probe the same
  partitions and score the same rows with the same arithmetic. The
  refine gathers only the real queries' probed blocks.
- `torch.topk` leaves ties unordered; `_topk` (`ops.topk.ordered_topk`)
  orders them by the lower index, as `lax.top_k` does.
- The corpus need not lie on the device: training, assignment and the
  table build take it in SCAN_ROWS chunks from wherever it lies (a host
  corpus streams through the device, never held there whole), and the
  index keeps only its table.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device
from generativeaiexamples_tpu_torch.ops.quant import div127
from generativeaiexamples_tpu_torch.ops.topk import (
    ordered_topk as _topk, stored_rows, tiled_scores as _tiled_scores,
    tiled_topk as _tiled_topk)

# Balanced-assignment capacity: cap each partition at this multiple of
# the mean list size (padding bound + incremental-add headroom).
BALANCE_CAP = 1.25
# Nearest centroids considered per row before the overflow fallback.
BALANCE_CANDIDATES = 8
# Rows one training or assignment scan takes at once (bounds the
# [rows, nlist] distance block, the one-hot block of a Lloyd step and the
# chunk a host corpus streams to the device in).
SCAN_ROWS = 65536


def compute_device(x, device: DeviceLike = None) -> torch.device:
    """Where work on `x` runs: `device` when given, else a tensor's own
    device, else CUDA (unless the caller asks for the CPU)."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def as_rows(x, device: DeviceLike = None) -> torch.Tensor:
    """`x` ([N, D] numpy or tensor) as f32 on `device` (a tensor's own
    device when not given; CUDA for numpy, unless the caller asks for the
    CPU)."""
    return stored_rows(x).to(compute_device(x, device))


def _chunks(data: torch.Tensor, device: torch.device, rows: int = SCAN_ROWS):
    """(offset, chunk) pairs of `data` in `rows`-row chunks, each as f32
    on `device` (no copy for a chunk already there)."""
    for lo in range(0, data.shape[0], rows):
        yield lo, data[lo:lo + rows].to(device=device, dtype=torch.float32)


def to_host(x) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- k-means training --------------------------------------------------------


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2 distances, [N,D] x [K,D] -> [N,K] via one
    matmul (the |x|^2 term is rank-constant and dropped)."""
    c2 = torch.sum(c * c, dim=1)
    return c2 - 2.0 * torch.matmul(x, c.T)


def _kmeans_step(data: torch.Tensor, centroids: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration on the centroids' device, `data` taken in
    chunks from wherever it lies: (new centroids [K, D], assignments
    [N])."""
    k, dev = centroids.shape[0], centroids.device
    sums = torch.zeros_like(centroids)
    assign = torch.empty((data.shape[0],), dtype=torch.long, device=dev)
    ids = torch.arange(k, device=dev)[:, None]
    for lo, x in _chunks(data, dev):
        a = torch.argmin(_sq_dists(x, centroids), dim=1)
        assign[lo:lo + len(x)] = a
        sums += torch.matmul((a[None, :] == ids).float(), x)
    counts = torch.bincount(assign, minlength=k).float()[:, None]
    # Empty partitions keep their old centroid (standard Lloyd fallback).
    new_c = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                        centroids)
    return new_c, assign


def assign_partitions(data: torch.Tensor, centroids: torch.Tensor
                      ) -> torch.Tensor:
    """Nearest-centroid assignment, [M,D] -> [M] int32 on the centroids'
    device (`data` taken in chunks from wherever it lies): the whole cost
    of an incremental add."""
    dev = centroids.device
    return torch.cat([torch.argmin(_sq_dists(x, centroids), dim=1)
                      for _, x in _chunks(data, dev)]).to(torch.int32) \
        if len(data) else torch.zeros((0,), dtype=torch.int32, device=dev)


def extend_assignments(new_rows, centroids: torch.Tensor, assignments,
                       cap: float) -> Optional[np.ndarray]:
    """`assignments` with `new_rows` appended, each to its nearest
    centroid (one matmul, no retraining), or None when a partition would
    then hold more than `cap` rows: hot-partition skew, on which the
    caller retrains. ShardedIVFIndex.add and the store's re-layout of a
    lagging index share it, each with its own cap (JAX's two rules)."""
    tail = to_host(assign_partitions(new_rows, centroids)).astype(np.int32)
    out = np.concatenate([np.asarray(assignments, np.int32), tail])
    if np.bincount(out, minlength=len(centroids)).max() > cap:
        return None
    return out


def kmeans_fit(data, nlist: int, *, iters: int = 8, seed: int = 0,
               generator: Optional[torch.Generator] = None,
               init: Optional[torch.Tensor] = None,
               device: DeviceLike = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means: (centroids [nlist, D] f32, assignments [N] int32),
    both on `compute_device(data, device)`; a corpus lying elsewhere (the
    host) streams through it in chunks. `nlist` is clamped to N. The
    initial centroids are `init`, else `nlist` distinct rows drawn with
    `generator` (a CPU generator seeded from `seed` when not given)."""
    dev = compute_device(data, device)
    data = stored_rows(data)
    n = data.shape[0]
    nlist = max(1, min(int(nlist), n))
    if init is None:
        g = generator or torch.Generator().manual_seed(int(seed))
        pick = torch.randperm(n, generator=g)[:nlist].to(data.device)
        c = data.index_select(0, pick).to(dev)
    else:
        c = as_rows(init, dev)
    for _ in range(max(1, iters)):
        c, _ = _kmeans_step(data, c)
    return c, assign_partitions(data, c)


def rank_round_assign(order: np.ndarray, best: np.ndarray, nlist: int,
                      cap: int) -> np.ndarray:
    """Capacity-capped assignment over precomputed candidate lists.

    `order` [N, c] holds each row's `c` nearest centroids
    (nearest-first), `best` [N] its nearest distance. Vectorized rank
    rounds: round r offers every still-unplaced row its r-th nearest
    centroid; within a partition, slots go to rows in best-distance
    priority order. Rows whose every candidate is full land on the
    globally emptiest partition (rare). The JAX package's numpy, as is."""
    n, candidates = order.shape
    counts = np.zeros(nlist, np.int64)
    out = np.full(n, -1, np.int32)
    pending = np.argsort(best, kind="stable")  # row ids, priority order
    for r in range(candidates):
        if not len(pending):
            break
        cand = order[pending, r].astype(np.int64)
        sort_idx = np.argsort(cand, kind="stable")  # keeps priority order
        sp = cand[sort_idx]
        grp_start = np.searchsorted(sp, np.arange(nlist))
        pos_in_grp = np.arange(len(sp)) - grp_start[sp]
        take = pos_in_grp < (cap - counts)[sp]
        rows = pending[sort_idx[take]]
        out[rows] = sp[take].astype(np.int32)
        counts += np.bincount(sp[take], minlength=nlist)
        pending = pending[out[pending] < 0]
    for i in pending:  # all `candidates` nearest were full (rare)
        p = int(np.argmin(counts))
        out[i] = p
        counts[p] += 1
    return out


def centroid_candidates(data, centroids, *,
                        candidates: int = BALANCE_CANDIDATES,
                        chunk: int = SCAN_ROWS
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-`candidates` nearest centroids a row, computed in bounded
    chunks on the centroids' device (a tensor's; else the corpus's, else
    CUDA): (order [N, c] int32 nearest-first, best [N] f32 nearest
    squared distance), brought to the host. Only these [N, c] candidates
    cross to the host from the device, never the corpus."""
    centroids = as_rows(centroids, None if isinstance(
        centroids, torch.Tensor) else compute_device(data))
    data = stored_rows(data)
    c = min(candidates, len(centroids))
    n = len(data)
    order = np.empty((n, c), np.int32)
    best = np.empty((n,), np.float32)
    for lo, x in _chunks(data, centroids.device, chunk):
        neg, idx = _topk(-_sq_dists(x, centroids), c)
        order[lo:lo + chunk] = to_host(idx.to(torch.int32))
        best[lo:lo + chunk] = to_host(-neg[:, 0])
    return order, best


def balanced_assign(data, centroids, *, cap_factor: float = BALANCE_CAP,
                    candidates: int = BALANCE_CANDIDATES) -> np.ndarray:
    """Capacity-capped assignment [N] int32 (host): rows claim their
    nearest centroid in best-distance order; a full partition spills the
    row to its next nearest with room (then to the globally emptiest).
    Bounds every list at cap_factor * N/nlist."""
    n, nlist = len(data), len(centroids)
    cap = int(cap_factor * n / nlist) + 1
    order, best = centroid_candidates(data, centroids,
                                      candidates=candidates)
    return rank_round_assign(order, best, nlist, cap)


# -- int8 row quantization (ops/quant.py idiom, per-row scales) --------------


def quantize_rows(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 over the trailing (feature) axis: scale =
    amax/127, divided by a device tensor (`div127`) so the codes are bit
    for bit the JAX package's. Returns (q int8 [..., D], s f32 [...])."""
    vf = v.float()
    amax = vf.abs().amax(dim=-1)
    s = torch.clamp(div127(amax), min=1e-8)
    q = torch.round(vf / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


# -- the two-stage search ----------------------------------------------------


def _refine(q, pids, db, scales, gids_tab, k: int, slot_of=None):
    """Score the probed partitions' rows for each query and keep its top
    k. q [Q,D]; pids [Q,P] partition ids; db [S,M,D] f32 or int8 (+ scales
    [S,M] when int8, else None); gids_tab [S,M] int32 global ids (pad =
    -1); `slot_of` [nlist] int32 maps a partition to its row of db (-1 =
    not resident, masked), the identity when None. Each query gathers
    only its own probed blocks and scores them with one [P*M, D] x [D]
    product, the same shape alone or in a batch. Returns (scores [Q,kk],
    ids [Q,kk] int64, valid-row count over the Q queries); padded and
    non-resident slots come back as -inf / id -1."""
    n, p = pids.shape
    m, dim = db.shape[1], db.shape[2]
    if slot_of is None:
        rows, resident = pids.long(), None
    else:
        slots = slot_of[pids]
        resident = slots >= 0
        rows = torch.where(resident, slots, torch.zeros_like(slots)).long()
    g = gids_tab[rows]
    valid = g >= 0 if resident is None else (g >= 0) & resident[:, :, None]
    valid = valid.reshape(n, p * m)
    g = torch.where(valid, g.reshape(n, -1), torch.full_like(
        g.reshape(n, -1), -1))
    if n:
        sc = torch.stack([torch.mv(db[r].reshape(p * m, dim).float(), qi)
                          for r, qi in zip(rows, q)])
    else:
        sc = q.new_zeros((0, p * m))
    if scales is not None:
        sc = sc * scales[rows].reshape(n, -1)
    sc = torch.where(valid, sc, torch.full_like(sc, -torch.inf))
    best, pos = _tiled_topk(sc, min(k, p * m))
    return best, g.gather(1, pos).long(), int(valid.sum())


def coarse_probes(q: torch.Tensor, centroids: torch.Tensor,
                  nprobe: int) -> torch.Tensor:
    """The coarse scan: each query's top-`nprobe` partitions [Q, P]."""
    _, pids = _tiled_topk(_tiled_scores(q, centroids),
                          min(nprobe, centroids.shape[0]))
    return pids


def _score_probed(q, centroids, db3, scales3, g3, k: int, nprobe: int):
    """Coarse [Q,D]x[D,nlist] scan -> top-`nprobe` partition block gather
    -> batched refine matmul (+ int8 dequant) -> pad-masked top-k.
    Returns (scores [Q,kk], row ids [Q,kk], scanned-row count)."""
    pids = coarse_probes(q, centroids, nprobe)
    return _refine(q, pids, db3, scales3, g3, k)


def _partition_lists(assign: np.ndarray, nlist: int):
    """Bucket row ids by partition in one argsort + searchsorted pass.
    Rows within a list stay in ascending order. The JAX package's numpy,
    as is."""
    order = np.argsort(assign, kind="stable")
    sorted_a = assign[order]
    bounds = np.searchsorted(sorted_a, np.arange(nlist + 1))
    lists = [order[bounds[p]:bounds[p + 1]] for p in range(nlist)]
    max_len = max(1, int(np.diff(bounds).max(initial=0)))
    return lists, max_len


def _tail_slots(a: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The tail slot of each new row (in row order) of a partition that
    already holds `counts[p]` rows: `counts[a[i]]` plus the rows of the
    same partition ahead of row i."""
    order = np.argsort(a, kind="stable")
    sa = a[order].astype(np.int64)
    start = np.searchsorted(sa, sa, side="left")
    slots = np.empty(len(a), np.int64)
    slots[order] = counts[sa] + (np.arange(len(a)) - start)
    return slots


def _gather_blocks(rows: torch.Tensor, gids: np.ndarray, quantize: bool,
                   device: torch.device, chunk_rows: int = SCAN_ROWS):
    """Blocks [B, W, D] on `device` of `rows` (wherever they lie) by the
    id map `gids` [B, W] (pad = -1 -> zero rows), gathered where the rows
    lie in bounded chunks of blocks: f32, or int8 codes + [B, W] scales
    when `quantize`."""
    b, w = gids.shape
    dim = rows.shape[1]
    db = torch.empty((b, w, dim), dtype=torch.int8 if quantize
                     else torch.float32, device=device)
    sc = torch.empty((b, w), dtype=torch.float32, device=device) \
        if quantize else None
    g = torch.from_numpy(np.ascontiguousarray(gids, np.int64))
    step = max(1, chunk_rows // max(1, w))
    for lo in range(0, b, step):
        gi = g[lo:lo + step]
        blk = rows.index_select(0, gi.clamp(min=0).reshape(-1).to(
            rows.device)).to(device).reshape(gi.shape[0], w, dim)
        blk = blk.masked_fill((gi < 0).to(device)[:, :, None], 0.0)
        if quantize:
            db[lo:lo + step], sc[lo:lo + step] = quantize_rows(blk)
        else:
            db[lo:lo + step] = blk
    return db, sc


class IVFIndex:
    """Single-device IVF index over an [N,D] corpus.

    Pass `centroids`/`assignments` (e.g. from a persisted snapshot) to
    skip training. `vectors` (numpy, or a tensor on the host or the
    device) is never copied to the device whole: training and the table
    build stream it in chunks, and the index keeps only its table;
    `add()` moves only the new rows. Lives on `device` (CUDA unless the
    caller asks for the CPU; a tensor's own device when not given)."""

    def __init__(self, vectors, nlist: int, *, nprobe: int = 16,
                 quantize_int8: bool = False, train_iters: int = 8,
                 seed: int = 0, centroids=None, assignments=None,
                 device: DeviceLike = None):
        self.device = compute_device(vectors, device)
        rows = stored_rows(vectors)
        self.dim = int(rows.shape[1])
        self.nprobe = int(nprobe)
        self.quantize_int8 = bool(quantize_int8)
        if centroids is None or assignments is None:
            centroids, _ = kmeans_fit(rows, nlist, iters=train_iters,
                                      seed=seed, device=self.device)
            assignments = balanced_assign(rows, centroids)
        self.centroids = as_rows(centroids, self.device)
        self.nlist = int(self.centroids.shape[0])
        self._assign = np.asarray(to_host(assignments), np.int32)
        self.n_rows = int(rows.shape[0])
        self._build_tables(rows)

    def _build_tables(self, rows: torch.Tensor) -> None:
        lists, ml = _partition_lists(self._assign, self.nlist)
        self.max_list_len = ml
        self._list_len = np.array([len(l) for l in lists], np.int64)
        g3 = np.full((self.nlist, ml), -1, np.int32)
        for p, l in enumerate(lists):
            g3[p, :len(l)] = l
        self._g3 = torch.from_numpy(g3).to(self.device)
        self._db3, self._scales3 = _gather_blocks(
            rows, g3, self.quantize_int8, self.device)

    def table_bytes(self) -> int:
        """Device bytes of the partition table (rows, scales, id map)."""
        return sum(t.numel() * t.element_size()
                   for t in (self._db3, self._scales3, self._g3)
                   if t is not None)

    def add(self, new_vectors, max_grow_factor: float = 4.0) -> bool:
        """Assign new rows to existing partitions (one matmul) and scatter
        them into partition tail slots on the device: no retrain, no
        corpus re-transfer. Tables widen (a device-side pad) only when a
        partition outgrows its headroom. Returns False WITHOUT mutating
        anything when the add would skew a partition past max_grow_factor
        x the mean list size (the padded table is max_len wide for every
        partition); the owning store retrains instead."""
        new = as_rows(new_vectors, self.device)
        m = len(new)
        if not m:
            return True
        a = to_host(assign_partitions(new, self.centroids))
        slots = _tail_slots(a, self._list_len)
        counts = self._list_len + np.bincount(a, minlength=self.nlist)
        need = int(counts.max())
        cap = max_grow_factor * max(1.0, (self.n_rows + m) / self.nlist)
        if need > self.max_list_len and need > cap:
            return False
        self._list_len = counts
        if need > self.max_list_len:
            pad = need - self.max_list_len
            self._db3 = torch.cat([self._db3, self._db3.new_zeros(
                (self.nlist, pad, self.dim))], dim=1)
            self._g3 = torch.cat([self._g3, self._g3.new_full(
                (self.nlist, pad), -1)], dim=1)
            if self._scales3 is not None:
                self._scales3 = torch.cat([self._scales3,
                                           self._scales3.new_zeros(
                                               (self.nlist, pad))], dim=1)
            self.max_list_len = need
        gids = torch.arange(self.n_rows, self.n_rows + m, dtype=torch.int32,
                            device=self.device)
        pa = torch.from_numpy(a.astype(np.int64)).to(self.device)
        sa = torch.from_numpy(slots).to(self.device)
        # In place (the JAX `.at[].set` copies the table): the owning
        # store runs add and search under one lock.
        if self.quantize_int8:
            q, s = quantize_rows(new)
            self._db3.index_put_((pa, sa), q)
            self._scales3.index_put_((pa, sa), s)
        else:
            self._db3.index_put_((pa, sa), new)
        self._g3.index_put_((pa, sa), gids)
        self._assign = np.concatenate([self._assign, a.astype(np.int32)])
        self.n_rows += m
        return True

    def search(self, queries, k: int, nprobe: Optional[int] = None):
        """queries [Q,D] -> (scores [Q,kk], global row ids [Q,kk] int64,
        both on the device; n_scanned_rows int). Padded slots: -inf
        score, id -1."""
        nprobe = int(nprobe or self.nprobe)
        return _score_probed(as_rows(queries, self.device), self.centroids,
                             self._db3, self._scales3, self._g3, k, nprobe)

    def state(self) -> dict:
        """Persistable training state (the corpus itself lives with the
        owning store)."""
        return {"centroids": to_host(self.centroids).copy(),
                "assignments": np.asarray(self._assign).copy()}


# -- sharded variant ---------------------------------------------------------


class ShardedIVFIndex:
    """IVF with corpus rows round-robin over the mesh axis `axis`.

    Every shard holds the full partition structure (shared centroids and
    assignments) over ITS rows: a local [nlist, max_len_local, D] table
    (f32, or int8 codes with scales) on its device. A search runs the
    two-stage search on each shard (the same coarse scan, so the same
    `nprobe` partitions, over ~1/n_shards of each list), keeps a local
    top-k, and reduces the [Q, n_shards * k] candidates with a final
    top-k on the first shard's device. The candidate set equals the
    single-device index's on the same centroids and assignments, so the
    results match up to float ordering. `vectors` may lie on the host or
    a device; the shards' tables are gathered from it in chunks."""

    def __init__(self, vectors, nlist: int, mesh, axis: str = "tensor", *,
                 nprobe: int = 16, quantize_int8: bool = False,
                 train_iters: int = 8, seed: int = 0, centroids=None,
                 assignments=None):
        from generativeaiexamples_tpu_torch.parallel.mesh import (
            axis_devices)

        self.mesh, self.axis = mesh, axis
        self.devices = axis_devices(mesh, axis)
        self.device = self.devices[0]
        self.n_shards = len(self.devices)
        rows = stored_rows(vectors)
        self.dim = int(rows.shape[1])
        self.nprobe = int(nprobe)
        self.quantize_int8 = bool(quantize_int8)
        if centroids is None or assignments is None:
            centroids, _ = kmeans_fit(rows, nlist, iters=train_iters,
                                      seed=seed, device=self.device)
            assignments = balanced_assign(rows, centroids)
        self.centroids = as_rows(centroids, self.device)
        self.nlist = int(self.centroids.shape[0])
        self._assign = np.asarray(to_host(assignments), np.int32)
        self.n_rows = int(rows.shape[0])
        self._build_layout(rows)

    def _build_layout(self, rows: torch.Tensor) -> None:
        """Each shard's table from `rows` (the whole corpus, old rows
        first): rows s, s + S, s + 2S, ... bucketed by partition, padded
        to the longest list of any shard."""
        S, nlist = self.n_shards, self.nlist
        ml = 1
        per_shard_lists = []
        for s in range(S):
            ids = np.arange(s, self.n_rows, S)  # round-robin split
            local_lists, local_ml = _partition_lists(self._assign[ids], nlist)
            per_shard_lists.append([ids[l] for l in local_lists])
            ml = max(ml, local_ml)
        self.max_list_len = ml
        self._shards = []
        for dev, lists in zip(self.devices, per_shard_lists):
            g3 = np.full((nlist, ml), -1, np.int32)
            for p, l in enumerate(lists):
                g3[p, :len(l)] = l
            db3, scales3 = _gather_blocks(rows, g3, self.quantize_int8, dev)
            self._shards.append((self.centroids.to(dev), db3, scales3,
                                 torch.from_numpy(g3).to(dev)))

    def table_bytes(self) -> int:
        """Device bytes of every shard's table (rows, scales, id map)."""
        return sum(t.numel() * t.element_size()
                   for shard in self._shards for t in shard[1:]
                   if t is not None)

    def add(self, new_vectors, all_vectors,
            max_grow_factor: float = 4.0) -> bool:
        """Assign new rows WITHOUT retraining (one matmul), then rebuild
        the sharded layout from the whole corpus (`all_vectors`, old rows
        first): the per-shard tables change shape under the round-robin
        split, so unlike `IVFIndex.add` this re-gathers the corpus, while
        centroids and assignments are kept. Returns False without
        mutating when a partition would grow past max_grow_factor x the
        mean list size (the store retrains instead)."""
        new = stored_rows(new_vectors)
        if not len(new):
            return True
        n_total = self.n_rows + len(new)
        grown = extend_assignments(
            new, self.centroids, self._assign,
            max_grow_factor * max(1.0, n_total / self.nlist))
        if grown is None:
            return False
        self._assign = grown
        rows = stored_rows(all_vectors)
        self.n_rows = int(rows.shape[0])
        self._build_layout(rows)
        return True

    def search(self, queries, k: int, nprobe: Optional[int] = None):
        """queries [Q,D] -> (scores [Q,kk], global row ids [Q,kk] int64,
        both on the first shard's device; n_scanned_rows int summed over
        the shards). Padded slots: -inf score, id -1."""
        nprobe = int(nprobe or self.nprobe)
        q = stored_rows(queries)
        best, ids, scanned = [], [], 0
        for centroids, db3, scales3, g3 in self._shards:
            b, g, n = _score_probed(q.to(centroids.device), centroids, db3,
                                    scales3, g3, k, nprobe)
            best.append(b.to(self.device))
            ids.append(g.to(self.device))
            scanned += n
        top, pos = _tiled_topk(torch.cat(best, dim=1),
                               min(k, self.n_shards * best[0].shape[1]))
        return top, torch.cat(ids, dim=1).gather(1, pos), scanned

    def state(self) -> dict:
        """Persistable training state: the JAX index's format."""
        return {"centroids": to_host(self.centroids).copy(),
                "assignments": np.asarray(self._assign).copy()}
