"""Tiered IVF ANN: demand-paged partitions across device memory / host
RAM / disk.

Counterpart of generativeaiexamples_tpu/ops/tiered.py (plain `jnp` there,
no Pallas kernel; plain torch here). `ops/ivf.py` serves while the whole
partition table fits in device memory; past that, device memory stops
being the home of the corpus and becomes a CACHE over it, the
SPANN/DiskANN memory-disk hybrid shape:

    hot   centroids (always) + the most-probed partitions' row blocks,
          resident on the device in the ops/ivf.py partition-blocked
          layout (optionally int8 + per-row scales);
    warm  partition base blocks in host RAM — a budgeted cache over
          the spill file, plus per-partition TAIL slots where live
          writes land (adds never touch the device);
    cold  the full partition-blocked corpus in an mmap'd spill file
          on disk, rewritten crash-safely (temp + os.replace) by
          background compaction.

Search stays ONE logical operation: one device pass runs the coarse
centroid scan and refines every probed partition that is resident;
probes that miss refine on the host against the warm/cold rows of the
same snapshot, and the two candidate sets merge into one top-k. A miss
is therefore slower, never wrong — recall is residency-independent,
only latency pages.

Residency is driven by a demand pager: every probe feeds a per-
partition EMA of probe frequency (decayed per search), and a single-
flight background maintenance thread promotes the hottest non-resident
partitions over the coldest resident ones (with hysteresis, so the
boundary doesn't thrash) and folds tails into the spill file once they
grow past a fraction of the corpus. Promotion, demotion and compaction
all build off-lock and install under the tier lock — searches never
stall behind a tier move, mirroring the store's off-lock trainer.

Deletes are not handled here: the owning store marks the whole index
stale on delete and retrains, exactly as it does for `IVFIndex`.

The host side (spill file, warm cache, tails, EMA, host refine, merge,
the pager's plans) is the JAX package's numpy, kept as it is, so the
spill file is byte for byte JAX's for the same corpus and assignments.
The device side scores each query with one fixed-shape product (ops/ivf.py
`_refine`), and every tier move builds new device tensors and installs
them under the lock, never writing a table that a search may hold.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from generativeaiexamples_tpu_torch.device import DeviceLike
from generativeaiexamples_tpu_torch.ops.ivf import (
    BALANCE_CAP, _partition_lists, _refine, as_rows, assign_partitions,
    centroid_candidates, coarse_probes, compute_device, kmeans_fit,
    quantize_rows, rank_round_assign, stored_rows, to_host)

_LOG = logging.getLogger(__name__)

# Tail rows (live writes not yet folded into the spill file) that
# trigger background compaction, as a fraction of the corpus and an
# absolute floor (tiny corpora should not churn the spill file).
COMPACT_TAIL_FRAC = 0.08
COMPACT_MIN_ROWS = 4096
# Pager misses observed since the last rebalance before another
# rebalance round is due (promotion is useless while everything hits).
REBALANCE_MIN_MISSES = 32
# A non-resident partition's EMA must beat the coldest resident one by
# this factor to displace it — hysteresis so the hot/cold boundary
# doesn't thrash when two partitions trade probes.
PROMOTE_HYSTERESIS = 1.25
# Tier moves per rebalance round (bounds each round's device scatter).
MAX_SWAPS_PER_ROUND = 16
# Rows k-means trains on at most; assignment always covers every row
# (chunked device scans). Sampling keeps the training transfer and the
# Lloyd matmuls bounded when the corpus is 10M+.
TRAIN_SAMPLE_ROWS = 1 << 21
# Rows one spill write takes from the corpus at once (bounds the host
# transient of a device corpus's copy-out).
SPILL_CHUNK_ROWS = 1 << 16

SPILL_FILE = "tiered_spill.dat"


def _pow2(n: int) -> int:
    return 1 << max(0, int(n - 1)).bit_length() if n > 1 else 1


def _tiered_search(q, centroids, hot_db, hot_scales, hot_gids, part2slot,
                   k: int, nprobe: int):
    """One device pass: coarse [Q,D]x[D,nlist] scan -> top-nprobe
    partitions -> refine the RESIDENT ones against the compacted hot
    table. Non-resident probes come back masked (-inf / id -1) and as
    `pids` for the host-side refine. q [Q,D]; hot_db [H,W,D] f32 or int8
    (+ hot_scales [H,W] when int8, else None); hot_gids [H,W] int32
    global ids (pad = -1); part2slot [nlist] int32 (-1 = not resident).
    Returns (scores [Q,kk], ids [Q,kk], pids [Q,P], hot rows scanned)."""
    pids = coarse_probes(q, centroids, nprobe)
    best, ids, scanned = _refine(q, pids, hot_db, hot_scales, hot_gids, k,
                                 slot_of=part2slot)
    return best, ids, pids, scanned


class TieredIVFIndex:
    """IVF index whose partitions page between device memory, host RAM
    and disk.

    Interface-compatible with `IVFIndex` where the owning store cares:
    `search(queries, k)` -> (scores, global ids, scanned rows),
    `add(new_vectors)` -> bool (False = skew guard fired, retrain),
    `state()` -> persistable {centroids, assignments}, plus `nprobe`,
    `nlist`, `max_list_len` attributes. Extra surface: `tier_stats()`
    counters, `maintenance_due()` + `kick_maintenance()` for the
    single-flight background pager/compactor.

    `hbm_budget_bytes` bounds the device-resident table (centroids are
    always resident and excluded from the budget); `ram_budget_bytes`
    bounds the warm cache over the spill file. Live adds land in warm
    tail slots only — no device traffic — and are host-refined on
    every probe of their partition until compaction folds them in.
    `vectors` may be numpy or a tensor on the host or the device; it is
    never copied to the device whole (training streams it in chunks, the
    spill is written from where it lies). The hot tier lives on `device`
    (CUDA unless the caller asks for the CPU; a tensor's own device when
    not given).
    """

    def __init__(self, vectors: np.ndarray, nlist: int, *,
                 nprobe: int = 16, quantize_int8: bool = False,
                 hbm_budget_bytes: int = 256 << 20,
                 ram_budget_bytes: int = 1024 << 20,
                 spill_dir: str, ema_decay: float = 0.98,
                 train_iters: int = 8, seed: int = 0,
                 centroids: Optional[np.ndarray] = None,
                 assignments: Optional[np.ndarray] = None,
                 train_sample_rows: int = TRAIN_SAMPLE_ROWS,
                 device: DeviceLike = None):
        self.device = compute_device(vectors, device)
        vectors = stored_rows(vectors)
        self.dim = int(vectors.shape[1])
        self.nprobe = int(nprobe)
        self.quantize_int8 = bool(quantize_int8)
        self.hbm_budget_bytes = int(hbm_budget_bytes)
        self.ram_budget_bytes = int(ram_budget_bytes)
        self.ema_decay = float(ema_decay)
        self.spill_dir = spill_dir
        os.makedirs(spill_dir, exist_ok=True)
        if centroids is None or assignments is None:
            centroids, assignments = self._train(
                vectors, nlist, train_iters, seed, train_sample_rows)
        self.centroids_np = np.array(to_host(centroids), np.float32)
        self.centroids = torch.from_numpy(self.centroids_np).to(self.device)
        self.nlist = int(self.centroids_np.shape[0])
        self._assign = np.asarray(to_host(assignments), np.int32)
        self.n_rows = int(vectors.shape[0])

        # One lock guards ALL tier state below (residency maps, warm
        # cache, tails, EMA, counters, maintenance flags). Slow work —
        # spill writes, device transfers — always happens off-lock on
        # snapshots and installs under it.
        self._lock = threading.Lock()
        self._epoch = 0          # bumped by compaction installs
        self._mnt_busy = False   # single-flight maintenance gate

        # counters (lock-held)
        self._promotions = 0
        self._demotions = 0
        self._compactions = 0
        self._probe_hits = 0
        self._probe_misses = 0
        self._host_scanned = 0
        self._misses_since_rebalance = 0
        self._bg_errors = 0

        self._tails: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}
        self._tail_rows_total = 0
        self._warm: Dict[int, np.ndarray] = {}
        self._warm_bytes = 0

        with self._lock:  # construction is single-threaded; held for
            # uniformity with every later writer of tier state
            self._build_base(vectors)
            # Probe-frequency prior before any query lands: partition
            # size (uniform queries probe populous partitions more
            # often), so the initial hot fill is the best guess
            # available.
            mean = max(1.0, self.n_rows / self.nlist)
            self._ema = self._base_lens.astype(np.float64) / mean
            self._init_hot()

    # -- training ----------------------------------------------------------

    def _train(self, vectors: torch.Tensor, nlist: int, iters: int,
               seed: int, sample_rows: int):
        n = len(vectors)
        nlist = max(1, min(int(nlist), n))
        if n > sample_rows:
            rng = np.random.default_rng(seed)
            pick = rng.choice(n, sample_rows, replace=False)
            sample = vectors.index_select(0, torch.from_numpy(pick).to(
                vectors.device))
        else:
            sample = vectors
        cents, _ = kmeans_fit(sample, nlist, iters=iters, seed=seed,
                              device=self.device)
        order, best = centroid_candidates(vectors, cents)
        cap = int(BALANCE_CAP * n / len(cents)) + 1
        return to_host(cents), rank_round_assign(order, best, len(cents),
                                                 cap)

    # -- base (spill-backed) layout ----------------------------------------

    def _build_base(self, vectors: torch.Tensor) -> None:
        """Partition-block the corpus and write it to the spill file.
        Lock held (construction-time; __init__ wraps the build)."""
        lists, ml = _partition_lists(self._assign, self.nlist)
        self._base_lens = np.array([len(l) for l in lists], np.int64)
        self._base_off = np.concatenate(
            [[0], np.cumsum(self._base_lens)]).astype(np.int64)
        # Global ids in spill-row order; the spill row range of
        # partition p is [_base_off[p], _base_off[p+1]).
        self._base_gids = (np.concatenate(lists) if lists
                           else np.zeros((0,), np.int64)).astype(np.int32)
        self.max_list_len = max(ml, 1)
        self._spill_path = os.path.join(self.spill_dir, SPILL_FILE)
        gids = self._base_gids

        def fill(mm):
            # Partition-ordered gather (on the rows' device) straight into
            # the map, chunked so the copy-out transient stays bounded.
            for lo in range(0, len(gids), SPILL_CHUNK_ROWS):
                idx = torch.from_numpy(gids[lo:lo + SPILL_CHUNK_ROWS].astype(
                    np.int64)).to(vectors.device)
                mm[lo:lo + len(idx)] = to_host(vectors.index_select(0, idx))

        self._mm = self._write_spill(len(gids), fill)

    def _write_spill(self, n_rows: int, fill_fn) -> np.ndarray:
        """Crash-safe spill rewrite: `fill_fn(mm)` assembles the rows
        DIRECTLY into a temp memmap (never the whole corpus in an
        in-RAM array — at the 10M design point that transient alone
        would outweigh the warm tier's whole RAM budget), then
        os.replace into place — a crash mid-write leaves the previous
        spill (and any live mapping of it) intact. Returns the READ
        mapping of the data, opened on the temp path BEFORE the
        replace: mappings follow inodes, not names, so a superseded
        index generation replacing the shared final path later (a
        store retrain's new index racing the old one's still-running
        compaction on the same spill_dir) can never swap bytes under
        this generation's reader. The temp name is unique per writer
        for the same reason — two generations' in-flight writes must
        not interleave."""
        tmp = f"{self._spill_path}.{os.getpid()}.{id(self):x}.tmp"
        try:
            if n_rows:
                mm = np.memmap(tmp, np.float32, "w+",
                               shape=(n_rows, self.dim))
                fill_fn(mm)
                mm.flush()
                del mm
                reader = np.memmap(tmp, np.float32, "r",
                                   shape=(n_rows, self.dim))
            else:
                with open(tmp, "wb"):
                    pass
                reader = np.zeros((0, self.dim), np.float32)
            os.replace(tmp, self._spill_path)
            return reader
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    @staticmethod
    def _base_block(p: int, mm: np.ndarray, off: np.ndarray,
                    warm: Dict[int, np.ndarray]) -> np.ndarray:
        """Base rows of partition `p` from ONE snapshot generation —
        `warm` must be the dict captured under the lock alongside
        `mm`/`off` (the caller decides whether to cache the result via
        _warm_insert)."""
        blk = warm.get(p)
        if blk is not None:
            return blk
        lo, hi = int(off[p]), int(off[p + 1])
        return np.array(mm[lo:hi])  # cold read: copy out of the mmap

    def _warm_insert(self, p: int, blk: np.ndarray, epoch: int) -> None:
        """Lock held. Cache a partition's base block in RAM, evicting
        the coldest cached partitions to stay under ram_budget_bytes.
        `epoch` is the generation the block was read from: a block from
        a superseded base is dropped rather than cached (it would pair
        with the NEW generation's gids on a later read)."""
        if self._epoch != epoch or blk.nbytes > self.ram_budget_bytes \
                or p in self._warm:
            return
        while self._warm and \
                self._warm_bytes + blk.nbytes > self.ram_budget_bytes:
            victim = min(self._warm, key=lambda q: self._ema[q])
            self._warm_bytes -= self._warm.pop(victim).nbytes
        if self._warm_bytes + blk.nbytes <= self.ram_budget_bytes:
            self._warm[p] = blk
            self._warm_bytes += blk.nbytes

    # -- hot (device) tier -------------------------------------------------

    def _slot_bytes(self, width: int) -> int:
        per_row = (self.dim + 4 if self.quantize_int8
                   else self.dim * 4) + 4  # rows (+scale) + gid
        return width * per_row

    def _init_hot(self) -> None:
        """Size the device table from the device budget and promote the
        top-prior partitions into it. Lock held (construction-time;
        __init__ wraps the build)."""
        self._hot_width = _pow2(self.max_list_len)
        budget_slots = self.hbm_budget_bytes // max(
            1, self._slot_bytes(self._hot_width))
        h = int(max(1, min(self.nlist, budget_slots)))
        self._hot_slots = h
        self._slot_part = np.full(h, -1, np.int32)
        self._p2s = np.full(self.nlist, -1, np.int32)
        db = np.zeros((h, self._hot_width, self.dim), np.float32)
        gids = np.full((h, self._hot_width), -1, np.int32)
        fill = [int(p) for p in np.argsort(-self._ema)
                if self._base_lens[p] <= self._hot_width][:h] \
            if budget_slots else []
        for s, p in enumerate(fill):
            lo, hi = int(self._base_off[p]), int(self._base_off[p + 1])
            db[s, :hi - lo] = self._mm[lo:hi]
            gids[s, :hi - lo] = self._base_gids[lo:hi]
            self._slot_part[s] = p
            self._p2s[p] = s
        self._hot_gids = self._dev(gids)
        self._hot_db, self._hot_scales = self._hot_table(db)
        self._p2s_dev = self._dev(self._p2s)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a new tensor on the index's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _hot_table(self, db: np.ndarray):
        """Host blocks [H, W, D] f32 -> the device table: f32, or int8
        codes + [H, W] scales."""
        dev = self._dev(db)
        if self.quantize_int8:
            return quantize_rows(dev)
        return dev, None

    # -- live writes -------------------------------------------------------

    def add(self, new_vectors: np.ndarray,
            max_grow_factor: float = 4.0) -> bool:
        """Land new rows in warm-tier tail slots: one assign matmul,
        ZERO device-table traffic — background compaction folds tails
        into the spill file and refreshed hot blocks later. Returns
        False without mutating when the add would skew a partition past
        max_grow_factor x the mean total list size (same guard as
        IVFIndex.add; the owning store retrains instead)."""
        new = stored_rows(new_vectors)
        m = len(new)
        if not m:
            return True
        new_vectors = to_host(new)
        a = to_host(assign_partitions(new, self.centroids))
        with self._lock:
            counts = self._total_lens() + np.bincount(a,
                                                      minlength=self.nlist)
            need = int(counts.max())
            cap = max_grow_factor * max(1.0, (self.n_rows + m) / self.nlist)
            if need > self.max_list_len and need > cap:
                return False
            order = np.argsort(a, kind="stable")
            gids = (self.n_rows + np.arange(m)).astype(np.int32)
            sa = a[order]
            bounds = np.searchsorted(sa, np.arange(self.nlist + 1))
            for p in np.unique(sa):
                lo, hi = bounds[p], bounds[p + 1]
                rows = order[lo:hi]
                self._tails.setdefault(int(p), []).append(
                    (new_vectors[rows], gids[rows]))
            self._assign = np.concatenate([self._assign, a])
            self.n_rows += m
            self._tail_rows_total += m
            self.max_list_len = max(self.max_list_len, need)
            return True

    def _total_lens(self) -> np.ndarray:
        """Lock held. Base + tail length per partition."""
        lens = self._base_lens.copy()
        for p, chunks in self._tails.items():
            lens[p] += sum(len(r) for r, _ in chunks)
        return lens

    # -- search ------------------------------------------------------------

    # graftlint: hot-path
    def search(self, queries, k: int, nprobe: Optional[int] = None):
        """queries [Q,D] -> (scores [Q,kk], global ids [Q,kk], scanned
        rows). One device pass refines the resident probed
        partitions; missed partitions (and every probed partition's
        tail rows) refine on the host against the same snapshot, and
        the candidate sets merge — one logical search, no stall on any
        tier move."""
        nprobe = int(nprobe or self.nprobe)
        q_dev = as_rows(queries, self.device)
        qs = to_host(q_dev)
        with self._lock:
            hot_db, hot_scales = self._hot_db, self._hot_scales
            hot_gids, p2s_dev = self._hot_gids, self._p2s_dev
            p2s = self._p2s.copy()
            mm, off, base_gids = self._mm, self._base_off, self._base_gids
            # The warm DICT travels with the epoch: _compact rebinds
            # self._warm to a fresh dict when it installs a new base,
            # so every block reachable through THIS reference matches
            # THIS (mm, off, base_gids) snapshot — mixing generations
            # would pair a new-length block with old-length gids. Tails
            # snapshot HERE too: a compaction landing mid-search splices
            # consumed tails out, and rows folded into a base this
            # search cannot see would vanish from its view entirely.
            warm, epoch = self._warm, self._epoch
            tails_all = {p: list(chunks)
                         for p, chunks in self._tails.items()}
        best, gids, pids, hot_rows = _tiered_search(
            q_dev, self.centroids, hot_db, hot_scales, hot_gids, p2s_dev, k,
            nprobe)
        best = to_host(best)
        gids = to_host(gids)
        pids = to_host(pids)
        probed = np.unique(pids)
        hit_mask = p2s[pids] >= 0
        with self._lock:
            self._ema *= self.ema_decay
            np.add.at(self._ema, pids.ravel(), 1.0)
            hits = int(hit_mask.sum())
            self._probe_hits += hits
            self._probe_misses += pids.size - hits
            self._misses_since_rebalance += pids.size - hits
        tails = {int(p): tails_all.get(int(p), []) for p in probed}
        host_sc, host_id, host_rows = self._host_refine(
            qs, pids, hit_mask, tails, mm, off, base_gids, warm, epoch)
        scores, ids = self._merge(best, gids, host_sc, host_id, k)
        with self._lock:
            self._host_scanned += host_rows
        return scores, ids, hot_rows + host_rows

    def _host_refine(self, qs, pids, hit_mask, tails, mm, off, base_gids,
                     warm, epoch):
        """Score every probed partition's host-side rows: base rows for
        probes that missed the device, tail rows for every probe. Runs OFF the
        tier lock on ONE snapshot generation (`warm`/`epoch` captured
        with `mm`/`off`/`base_gids` — see search()); scans each
        partition once for all the queries that probed it. Returns
        per-query candidate lists + the host row count."""
        q_of: Dict[int, List[int]] = {}
        miss_parts = set()
        for qi in range(len(pids)):
            for j, p in enumerate(pids[qi]):
                p = int(p)
                q_of.setdefault(p, []).append(qi)
                if not hit_mask[qi, j]:
                    miss_parts.add(p)
        host_sc: List[List[np.ndarray]] = [[] for _ in range(len(qs))]
        host_id: List[List[np.ndarray]] = [[] for _ in range(len(qs))]
        scanned = 0
        to_cache = []
        for p, qis in q_of.items():
            rows, gid_chunks = [], []
            if p in miss_parts:
                was_warm = warm.get(p) is not None
                blk = self._base_block(p, mm, off, warm)
                if len(blk):
                    rows.append(blk)
                    gid_chunks.append(base_gids[int(off[p]):int(off[p + 1])])
                if not was_warm and len(blk):
                    to_cache.append((p, blk))
            for t_rows, t_gids in tails.get(p, ()):
                rows.append(t_rows)
                gid_chunks.append(t_gids)
            if not rows:
                continue
            block = np.concatenate(rows) if len(rows) > 1 else rows[0]
            gid = np.concatenate(gid_chunks) if len(gid_chunks) > 1 \
                else gid_chunks[0]
            sub = np.unique(np.asarray(qis))
            sc = block @ qs[sub].T              # [rows, len(sub)]
            scanned += len(block) * len(sub)
            for col, qi in enumerate(sub):
                host_sc[qi].append(sc[:, col])
                host_id[qi].append(gid)
        if to_cache:
            with self._lock:
                for p, blk in to_cache:
                    self._warm_insert(p, blk, epoch)
        return host_sc, host_id, scanned

    @staticmethod
    def _merge(best, gids, host_sc, host_id, k: int):
        """Per-query top-k over the device (hot) and host candidate
        sets. Padded device slots (-inf / -1) lose to any real row."""
        q = len(best)
        out_s = np.full((q, k), -np.inf, np.float32)
        out_i = np.full((q, k), -1, np.int64)
        for qi in range(q):
            sc = [best[qi]]
            ids = [gids[qi]]
            sc.extend(host_sc[qi])
            ids.extend(host_id[qi])
            sc = np.concatenate(sc)
            ids = np.concatenate([np.asarray(i, np.int64) for i in ids])
            kk = min(k, len(sc))
            top = np.argpartition(sc, -kk)[-kk:]
            top = top[np.argsort(sc[top])[::-1]]
            out_s[qi, :kk] = sc[top]
            out_i[qi, :kk] = ids[top]
        return out_s, out_i

    # -- demand pager / compaction (single-flight background) --------------

    def maintenance_due(self) -> bool:  # graftlint: ignore[GL202]
        """Cheap, lock-free peek (racy reads of ints are fine — worst
        case one extra no-op kick, and kick_maintenance re-checks
        single-flight under the lock): compaction or a pager rebalance
        is warranted. The lock-free reads are the point, hence the
        GL202 suppression."""
        if self._mnt_busy:
            return False
        if self._tail_rows_total > max(COMPACT_MIN_ROWS,
                                       COMPACT_TAIL_FRAC * self.n_rows):
            return True
        return (self._misses_since_rebalance >= REBALANCE_MIN_MISSES
                and self._hot_slots < self.nlist)

    def kick_maintenance(self, on_error=None) -> bool:
        """Run one maintenance pass (compact + rebalance) on a
        background thread, single-flight — the same off-lock install
        idiom as the store's background trainer. Returns True when a
        worker was started."""
        with self._lock:
            if self._mnt_busy:
                return False
            self._mnt_busy = True

        def run():
            try:
                self.run_maintenance()
            except Exception:
                # Maintenance has no caller to propagate to; a silent
                # crash would freeze the pager with no signal. Log +
                # count (and tell the owner); the next search re-kicks.
                _LOG.exception("tiered-index maintenance failed")
                with self._lock:
                    self._bg_errors += 1
                if on_error is not None:
                    on_error()
            finally:
                with self._lock:
                    self._mnt_busy = False

        threading.Thread(target=run, name="tiered-ivf-maintenance",
                         daemon=True).start()
        return True

    def wait_maintenance(self, timeout: float = 10.0) -> bool:
        """Block until the single-flight maintenance worker is idle.
        Tests and smoke gates drain before teardown (a daemon worker
        mid-device-op at interpreter exit aborts the runtime); the
        serving path never calls this."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._mnt_busy:
                    return True
            time.sleep(0.01)
        return False

    def run_maintenance(self) -> None:
        """One synchronous maintenance pass (tests call this directly;
        kick_maintenance runs it on the single-flight worker)."""
        with self._lock:
            compact = self._tail_rows_total > max(
                COMPACT_MIN_ROWS, COMPACT_TAIL_FRAC * self.n_rows)
        if compact:
            self._compact()
        self._rebalance()

    def _compact(self) -> None:
        """Fold tails into the spill file: snapshot under the lock,
        rewrite the spill off-lock (temp + os.replace), install under
        the lock, then refresh the hot tier from the new base. Adds
        that land DURING the rewrite stay in their tail slots — the
        snapshot records how many chunks it consumed per partition."""
        with self._lock:
            epoch = self._epoch
            mm, off, base_gids = self._mm, self._base_off, self._base_gids
            consumed = {p: len(chunks) for p, chunks in self._tails.items()}
            tails = {p: list(self._tails[p][:n])
                     for p, n in consumed.items()}
            # Part of the same snapshot: a concurrent install mutates
            # _base_lens under the lock, and an off-lock copy here
            # could pair stale lengths with the fresh offsets above.
            new_lens = self._base_lens.copy()
        for p, chunks in tails.items():
            new_lens[p] += sum(len(r) for r, _ in chunks)
        new_off = np.concatenate([[0], np.cumsum(new_lens)]).astype(np.int64)
        n0 = int(new_off[-1])
        gids = np.empty((n0,), np.int32)

        def fill(rows):
            # Old base + consumed tails, assembled block by block
            # straight into the temp memmap.
            for p in range(self.nlist):
                lo = int(new_off[p])
                blo, bhi = int(off[p]), int(off[p + 1])
                rows[lo:lo + bhi - blo] = mm[blo:bhi]
                gids[lo:lo + bhi - blo] = base_gids[blo:bhi]
                lo += bhi - blo
                for t_rows, t_gids in tails.get(p, ()):
                    rows[lo:lo + len(t_rows)] = t_rows
                    gids[lo:lo + len(t_gids)] = t_gids
                    lo += len(t_rows)

        new_mm = self._write_spill(n0, fill)
        with self._lock:
            if self._epoch != epoch:
                return  # a competing install won; this snapshot is stale
            self._base_lens = new_lens
            self._base_off = new_off
            self._base_gids = gids
            self._mm = new_mm
            folded = 0
            for p, n in consumed.items():
                del self._tails[p][:n]
                folded += sum(len(r) for r, _ in tails[p])
                if not self._tails[p]:
                    del self._tails[p]
            self._tail_rows_total -= folded
            self.max_list_len = int(self._total_lens().max(initial=1))
            # Warm blocks and hot slots mirror the OLD base; drop both
            # ATOMICALLY with the install. The hot table in particular
            # must not stay mapped: its blocks lack the rows this
            # install just folded out of the tails, so a resident
            # probe would skip host refine AND miss them on device —
            # freshly-ingested rows silently vanishing from results.
            # Demoting every slot here keeps the window correct (all
            # probes refine on host against the new base, slower never
            # wrong) until _refill_hot installs the refreshed table.
            self._warm = {}
            self._warm_bytes = 0
            resident = [int(p) for p in self._slot_part if p >= 0]
            self._slot_part = np.full(self._hot_slots, -1, np.int32)
            self._p2s = np.full(self.nlist, -1, np.int32)
            self._p2s_dev = self._dev(self._p2s)
            self._epoch += 1
            self._compactions += 1
        self._refill_hot(resident)

    def _refill_hot(self, want: List[int]) -> None:
        """Rebuild the device table from the current base for the given
        partitions (post-compaction refresh). Builds off-lock from a
        base snapshot, installs under the lock; the width ladder may
        grow (power-of-two), which re-sizes the slot count to budget."""
        with self._lock:
            epoch = self._epoch
            mm, off, base_gids = self._mm, self._base_off, self._base_gids
            lens = self._base_lens.copy()
        width = _pow2(int(lens.max(initial=1)))
        budget_slots = self.hbm_budget_bytes // max(1,
                                                    self._slot_bytes(width))
        h = int(max(1, min(self.nlist, budget_slots)))
        keep = [p for p in want if lens[p] <= width][:h]
        db = np.zeros((h, width, self.dim), np.float32)
        gids = np.full((h, width), -1, np.int32)
        slot_part = np.full(h, -1, np.int32)
        p2s = np.full(self.nlist, -1, np.int32)
        for s, p in enumerate(keep):
            lo, hi = int(off[p]), int(off[p + 1])
            db[s, :hi - lo] = mm[lo:hi]
            gids[s, :hi - lo] = base_gids[lo:hi]
            slot_part[s] = p
            p2s[p] = s
        hot_gids = self._dev(gids)
        hot_db, hot_scales = self._hot_table(db)
        p2s_dev = self._dev(p2s)
        with self._lock:
            if self._epoch != epoch:
                return
            self._hot_width, self._hot_slots = width, h
            self._hot_db, self._hot_scales = hot_db, hot_scales
            self._hot_gids = hot_gids
            self._slot_part, self._p2s = slot_part, p2s
            self._p2s_dev = p2s_dev

    def _rebalance(self) -> None:
        """One pager round: promote the hottest non-resident partitions
        over the coldest resident ones (hysteresis-gated), free slots
        first. Blocks build and scatter off-lock; the new table
        installs under the lock unless a compaction raced it."""
        with self._lock:
            epoch = self._epoch
            mm, off, base_gids = self._mm, self._base_off, self._base_gids
            ema = self._ema.copy()
            p2s = self._p2s.copy()
            slot_part = self._slot_part.copy()
            width = self._hot_width
            lens = self._base_lens.copy()
            hot_db, hot_scales = self._hot_db, self._hot_scales
            hot_gids = self._hot_gids
            self._misses_since_rebalance = 0
        cands = [int(p) for p in np.argsort(-ema)
                 if p2s[p] < 0 and 0 < lens[p] <= width]
        free = [int(s) for s in np.flatnonzero(slot_part < 0)]
        occupied = [int(s) for s in np.flatnonzero(slot_part >= 0)]
        occupied.sort(key=lambda s: ema[slot_part[s]])  # coldest first
        plan: List[Tuple[int, int, int]] = []  # (slot, new part, old part)
        demoted = 0
        for p in cands[:MAX_SWAPS_PER_ROUND]:
            if free:
                plan.append((free.pop(), p, -1))
            elif occupied and \
                    ema[p] > PROMOTE_HYSTERESIS * ema[slot_part[occupied[0]]]:
                s = occupied.pop(0)
                plan.append((s, p, int(slot_part[s])))
                demoted += 1
            else:
                break
        if not plan:
            return
        blocks = np.zeros((len(plan), width, self.dim), np.float32)
        bgids = np.full((len(plan), width), -1, np.int32)
        for i, (_, p, _) in enumerate(plan):
            lo, hi = int(off[p]), int(off[p + 1])
            blocks[i, :hi - lo] = mm[lo:hi]
            bgids[i, :hi - lo] = base_gids[lo:hi]
        # New tensors (index_copy is out of place): a search holding the
        # old table keeps reading it unchanged.
        slots = self._dev(np.array([s for s, _, _ in plan], np.int64))
        qb, sb = self._hot_table(blocks)
        new_db = hot_db.index_copy(0, slots, qb)
        new_scales = hot_scales.index_copy(0, slots, sb) \
            if sb is not None else None
        new_gids = hot_gids.index_copy(0, slots, self._dev(bgids))
        for s, p, old in plan:
            slot_part[s] = p
            p2s[p] = s
            if old >= 0:
                p2s[old] = -1
        p2s_dev = self._dev(p2s)
        with self._lock:
            if self._epoch != epoch or self._hot_db is not hot_db:
                return  # compaction/refill raced: drop this round
            self._hot_db, self._hot_scales = new_db, new_scales
            self._hot_gids = new_gids
            self._slot_part, self._p2s = slot_part, p2s
            self._p2s_dev = p2s_dev
            self._promotions += len(plan)
            self._demotions += demoted

    # -- observability / persistence ---------------------------------------

    def tier_stats(self) -> Dict:
        with self._lock:
            resident = self._slot_part[self._slot_part >= 0]
            hot_rows = int(self._base_lens[resident].sum()) \
                if len(resident) else 0
            probes = self._probe_hits + self._probe_misses
            return {
                "hbm_resident_rows": hot_rows,
                "hbm_resident_fraction": round(
                    hot_rows / self.n_rows, 4) if self.n_rows else 0.0,
                "pager_hbm_hit_rate": round(
                    self._probe_hits / probes, 4) if probes else None,
                "pager_probe_hits": self._probe_hits,
                "pager_probe_misses": self._probe_misses,
                "tier_promotions": self._promotions,
                "tier_demotions": self._demotions,
                "tier_compactions": self._compactions,
                "tier_tail_rows": self._tail_rows_total,
                "tier_warm_bytes": self._warm_bytes,
                "tier_spill_bytes": int(self._base_off[-1]) * self.dim * 4,
                "tier_hot_slots": self._hot_slots,
                "tier_hot_width": self._hot_width,
                "tier_host_scanned_rows": self._host_scanned,
                "tier_bg_errors": self._bg_errors,
            }

    def state(self) -> Dict:
        """Persistable training state (same sidecar contract as
        IVFIndex — the corpus itself lives with the owning store)."""
        with self._lock:
            return {"centroids": self.centroids_np.copy(),
                    "assignments": self._assign.copy()}
