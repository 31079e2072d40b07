"""Session KV pager: tier prefix-cache pages device -> host RAM -> disk.

Counterpart of generativeaiexamples_tpu/serving/kv_pager.py, without its
multi-host slice mode and dispatch log (ROADMAP A.17).

Every cached prefix page pins a page of the device pool; with the pager
the device becomes the hot tier of three, so a paused conversation costs
next to no device memory while its resume stays a page gather, not a
re-prefill.

Tiers (per page, geometry fixed by the engine's pool):

- DEVICE: a live pool page.
- HOST: a budgeted host-RAM store (``engine.kv_host_budget_mb``) of
  preallocated page-shaped numpy slabs. Bytes move verbatim: a bf16
  pool's pages are kept as their raw 16-bit patterns (numpy has no
  bfloat16), an int8 pool's as codes plus narrow scales, so a demote ->
  promote round trip is bit-identical to never having left the device.
- DISK: an mmap'd spill file of fixed-size page records, grown in place
  and compacted crash-safely (temp file + ``os.replace``): a crash
  mid-rewrite leaves the previous file, and any live mapping of it,
  intact.

The radix tree is the pager's index: each node carries a tier tag and a
tier-local handle (serving/prefix_cache.py `_Node`), so a match finds a
session's prefix wherever its bytes live.

- Eviction DEMOTES: `PagedPrefixCache` routes `RadixTree.evict`'s
  frontier pops into one batched `engine_model.pool_to_pages` gather per
  span and a blocking device -> host read, so the allocator's reclaim
  hook parks cold sessions instead of deleting their KV.
- A match PROMOTES: the engine's `_lookup_prefix` calls
  `PagedPrefixCache.promote`, which re-seats every non-resident page of
  the matched path with one `engine_model.pages_to_pool` scatter.
- Host -> disk spill and spill compaction run on a single-flight
  background worker that touches only numpy and the file (no CUDA call);
  its errors are logged and counted.

Threading: the tree, the allocator and every promote/demote entry point
belong to the scheduler thread. The tier lock covers what the background
worker shares with it: host and spill slot tables, node tier flips, pins
and the counters. All device work (the demotion gather, the promotion
scatter, decode) runs on the scheduler thread's one stream, so a page
freed by demotion is rewritten only after the gather that read it.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import threading
import time
import weakref
from collections import OrderedDict
from typing import Callable, List, Optional

import numpy as np
import torch

from generativeaiexamples_tpu_torch.serving import engine_model
from generativeaiexamples_tpu_torch.serving.kv_cache import PageAllocator
from generativeaiexamples_tpu_torch.serving.prefix_cache import (
    TIER_DEVICE, TIER_DISK, TIER_HOST, TIER_PENDING, RadixPrefixCache)

_LOG = logging.getLogger(__name__)

# Always-present /metrics keys: EngineMetrics.snapshot() emits zeros for
# every one of them when the pager is off.
KV_PAGER_KEYS = (
    "kv_demotions", "kv_promotions", "kv_promote_tokens",
    "kv_host_pages", "kv_spill_pages", "kv_host_bytes", "kv_spill_bytes",
    "kv_spill_writes", "kv_spill_compactions", "kv_forced_drops",
    "kv_pager_errors",
)

# Spill file sizing: the first growth allocates this many records, later
# growths double; compaction runs once dead records (freed by promotion)
# number at least half of this and outnumber the live ones.
SPILL_MIN_SLOTS = 64

# Pool dtypes numpy lacks travel as the integer type of the same width:
# the host and disk tiers hold their raw bits.
_RAW_DTYPES = {torch.bfloat16: torch.int16, torch.float16: torch.int16}


def _pow2(n: int) -> int:
    w = 1
    while w < n:
        w *= 2
    return w


def gather_spans(n: int, max_batch_pages: int):
    """Yield (lo, hi) spans covering ``range(n)`` pages so each batched
    gather or scatter stays at most the power-of-two-rounded
    ``max_batch_pages`` wide (0 = one span): every width is one of the
    power-of-two widths the engine's warmup ran."""
    if n <= 0:
        return
    maxw = _pow2(max(1, n))
    if max_batch_pages:
        maxw = min(maxw, _pow2(max_batch_pages))
    for lo in range(0, n, maxw):
        yield lo, min(n, lo + maxw)


class KVPager:
    """Three-tier page store and the background spill/compaction worker.

    Owns no tree structure: `PagedPrefixCache` drives it with node
    objects whose ``tier``/``handle``/``page`` fields this class flips
    under the tier lock (the only state the background worker shares
    with the scheduler thread).
    """

    def __init__(self, pool, *, host_budget_mb: int = 256,
                 spill_dir: str = "", max_batch_pages: int = 0):
        # Page geometry from the live pool: codes [2, L, KH, ps, Hd] per
        # page ([0] = k, [1] = v) in the pool dtype (int8 codes for a
        # quantized pool, which also carries [2, L, KH, ps] f32 scales).
        if pool.quantized:
            _, L, KH, _, ps, Hd = pool.kv.shape
            self.pool_dtype = torch.int8
            self.scales_shape: Optional[tuple] = (2, L, KH, ps)
        else:
            L, KH, _, ps, Hd = pool.k.shape
            self.pool_dtype = pool.k.dtype
            self.scales_shape = None
        self.device = (pool.kv if pool.quantized else pool.k).device
        self._raw_dtype = _RAW_DTYPES.get(self.pool_dtype, self.pool_dtype)
        self.codes_dtype = torch.empty((), dtype=self._raw_dtype).numpy().dtype
        self.codes_shape = (2, L, KH, ps, Hd)
        self.page_size = ps
        self.quantized = bool(pool.quantized)
        self._codes_bytes = int(np.prod(self.codes_shape)
                                * self.codes_dtype.itemsize)
        self._scales_bytes = (int(np.prod(self.scales_shape) * 4)
                              if self.scales_shape else 0)
        self._rec_bytes = self._codes_bytes + self._scales_bytes
        # Largest gather/scatter per dispatch (0 = unbounded): the engine
        # passes max_pages.
        self.max_batch_pages = max(0, int(max_batch_pages))
        n_host = max(0, int(host_budget_mb) * (1 << 20) // self._rec_bytes)
        self.n_host_slots = n_host
        self._host_codes = np.zeros((n_host,) + self.codes_shape,
                                    self.codes_dtype)
        self._host_scales = (np.zeros((n_host,) + self.scales_shape,
                                      np.float32)
                             if self.scales_shape else None)
        # Tier lock: host/spill slot tables, node tier flips, pins,
        # counters -- everything the background worker shares with the
        # scheduler thread.
        self._lock = threading.Lock()
        self._host_free: List[int] = list(range(n_host - 1, -1, -1))
        # slot -> node in demotion order: the spill worker's LRU (a
        # promoted slot leaves the dict; re-demotion re-enters at the end).
        self._host_lru: "OrderedDict[int, object]" = OrderedDict()
        # Cold tier: one file per pager (two engines may share
        # kv_spill_dir), records in free slots of the current mapping.
        self._ephemeral = not spill_dir
        self._spill_dir = spill_dir or tempfile.mkdtemp(prefix="kv_pager_")
        os.makedirs(self._spill_dir, exist_ok=True)
        self._spill_path = os.path.join(
            self._spill_dir, f"kv_pages.{os.getpid()}.{id(self):x}.bin")
        self._spill_mm: Optional[np.memmap] = None
        self._spill_slots = 0
        self._spill_free: List[int] = []
        self._spill_nodes: dict = {}  # slot -> node
        # Records freed by promotion or reattach since the last
        # compaction (never-used growth slots are not dead).
        self._spill_dead = 0
        self._pins: set = set()       # id(node) immune to demote/spill
        self._compacting = False      # a rewrite is copying the old mmap
        self._busy = False            # single-flight worker gate
        self._demotions = 0
        self._promotions = 0
        self._promote_tokens = 0
        self._spill_writes = 0
        self._compactions = 0
        self._forced_drops = 0
        self._bg_errors = 0
        if self._ephemeral:
            weakref.finalize(self, shutil.rmtree, self._spill_dir,
                             ignore_errors=True)

    # -- host <-> device ----------------------------------------------------

    def _staging(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        """A host buffer for moving pages: pinned when the pool is on the
        card, so the copy runs at the bus rate into memory that is already
        mapped. PyTorch's pinned-memory cache hands a block out again only
        after the copies queued from it have completed."""
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        """A device tensor's raw bytes as numpy; returns once the copy has
        landed (the demotion barrier)."""
        t = t.view(_RAW_DTYPES.get(t.dtype, t.dtype))
        host = self._staging(t.shape, t.dtype)
        host.copy_(t)
        return host.numpy()

    # -- pins (the scheduler pins a matched path for the promote window) ---

    def pin(self, nodes) -> None:
        with self._lock:
            self._pins.update(id(n) for n in nodes)

    def unpin(self, nodes) -> None:
        with self._lock:
            self._pins.difference_update(id(n) for n in nodes)

    def is_pinned(self, node) -> bool:
        with self._lock:
            return id(node) in self._pins

    # -- demotion (scheduler thread, called from PagedPrefixCache) ---------

    def demote(self, pool, nodes) -> List:
        """Move `nodes`' pages device -> host (or straight to disk when
        the host tier is full): one batched pool_to_pages gather per span,
        a blocking read to the host, then slot writes and tier flips under
        the lock. The caller releases the device pages only after this
        returns. Returns the nodes that could NOT be stored (forced drops:
        host full while a compaction holds the spill); the caller
        destroys those."""
        dropped: List = []
        for lo, hi in gather_spans(len(nodes), self.max_batch_pages):
            batch = nodes[lo:hi]
            row = np.zeros((_pow2(len(batch)),), np.int64)  # pad: sink 0
            row[:len(batch)] = [n.page for n in batch]
            codes, scales = engine_model.pool_to_pages(
                pool, torch.from_numpy(row).to(self.device))
            fetched = self._to_host(codes)
            fetched_s = self._to_host(scales) if scales is not None else None
            with self._lock:
                stored = 0
                for i, node in enumerate(batch):
                    if self._store_locked(node, fetched[i],
                                          None if fetched_s is None
                                          else fetched_s[i]):
                        stored += 1
                    else:
                        dropped.append(node)
                self._demotions += stored
        self._maybe_kick()
        return dropped

    def _store_locked(self, node, codes: np.ndarray,
                      scales: Optional[np.ndarray]) -> bool:
        """Lock held. Park one page's bytes in the warmest tier with room:
        a host slot, else a direct spill record. False only when neither
        can take it (compaction holds the spill file)."""
        if self._host_free:
            slot = self._host_free.pop()
            self._host_codes[slot] = codes
            if self._host_scales is not None:
                self._host_scales[slot] = scales
            node.tier, node.handle = TIER_HOST, slot
            self._host_lru[slot] = node
            return True
        if self._compacting:
            self._forced_drops += 1
            return False
        slot = self._spill_alloc_locked()
        self._spill_write_locked(slot, codes, scales)
        node.tier, node.handle = TIER_DISK, slot
        self._spill_nodes[slot] = node
        return True

    # -- promotion (scheduler thread, called from PagedPrefixCache) --------

    def promote_into(self, pool, nodes, pages: List[int]):
        """Re-seat `nodes`' bytes into freshly allocated pool `pages`:
        staging copy under the lock (host slabs / spill mmap -> one
        page-major buffer), then one pages_to_pool scatter. Tier flips and
        slot frees happen only after the scatter was issued, so a failure
        leaves every node in its cold tier (the caller releases the
        pages). Returns the pool."""
        n = len(nodes)
        w = _pow2(n)
        codes_t = self._staging((w,) + self.codes_shape, self._raw_dtype)
        scales_t = (self._staging((w,) + self.scales_shape, torch.float32)
                    if self.scales_shape else None)
        codes = codes_t.numpy()
        scales = scales_t.numpy() if scales_t is not None else None
        codes[n:] = 0  # padding rows: written to the sink
        if scales is not None:
            scales[n:] = 0
        row = np.zeros((w,), np.int64)
        row[:n] = pages
        with self._lock:
            for i, node in enumerate(nodes):
                if node.tier == TIER_HOST:
                    codes[i] = self._host_codes[node.handle]
                    if scales is not None:
                        scales[i] = self._host_scales[node.handle]
                elif node.tier == TIER_DISK:
                    self._spill_read_locked(node.handle, codes[i],
                                            None if scales is None
                                            else scales[i])
                else:
                    raise RuntimeError(
                        f"promote of a tier-{node.tier} node")
        dev = self.device
        pool = engine_model.pages_to_pool(
            pool,
            codes_t.to(dev, non_blocking=True).view(self.pool_dtype),
            None if scales_t is None else scales_t.to(dev,
                                                      non_blocking=True),
            torch.from_numpy(row).to(dev))
        with self._lock:
            for node, page in zip(nodes, pages):
                self._free_cold_locked(node)
                node.tier, node.page, node.handle = TIER_DEVICE, page, None
            self._promotions += n
            self._promote_tokens += n * self.page_size
        # Promotions free spill slots without a demotion to kick the
        # worker: check here too, or dead records linger.
        self._maybe_kick()
        return pool

    def reattach(self, node, page: int) -> bool:
        """A re-played prompt re-inserted a chunk whose node had been
        demoted: adopt its fresh device `page` as the node's payload and
        free the cold copy (no promotion). False when the node is not in
        a cold tier."""
        with self._lock:
            if node.tier not in (TIER_HOST, TIER_DISK):
                return False
            self._free_cold_locked(node)
            node.tier, node.page, node.handle = TIER_DEVICE, page, None
        self._maybe_kick()
        return True

    def discard(self, node) -> None:
        """Free a node's cold-tier storage (node destroyed or its demotion
        failed); device and pending nodes are a no-op."""
        with self._lock:
            self._free_cold_locked(node)
            node.handle = None

    def _free_cold_locked(self, node) -> None:
        """Lock held. Release a cold node's slot: host slab back to the
        free list, or spill record marked dead."""
        if node.tier == TIER_HOST:
            self._host_lru.pop(node.handle, None)
            self._host_free.append(node.handle)
        elif node.tier == TIER_DISK:
            self._spill_nodes.pop(node.handle, None)
            self._spill_free.append(node.handle)
            self._spill_dead += 1

    def count_error(self) -> None:
        with self._lock:
            self._bg_errors += 1

    # -- spill file (cold tier) --------------------------------------------

    def _spill_alloc_locked(self) -> int:
        """Lock held. A free spill slot, growing the file when none
        remain."""
        if not self._spill_free:
            self._spill_grow_locked(max(SPILL_MIN_SLOTS,
                                        self._spill_slots * 2))
        return self._spill_free.pop()

    def _spill_write_locked(self, slot: int, codes: np.ndarray,
                            scales: Optional[np.ndarray]) -> None:
        rec = self._spill_mm[slot]
        cb = self._codes_bytes
        rec[:cb] = np.ascontiguousarray(codes).reshape(-1).view(np.uint8)
        if scales is not None:
            rec[cb:] = np.ascontiguousarray(scales).reshape(-1).view(
                np.uint8)
        self._spill_writes += 1

    def _spill_read_locked(self, slot: int, codes_out: np.ndarray,
                           scales_out: Optional[np.ndarray]) -> None:
        rec = self._spill_mm[slot]
        cb = self._codes_bytes
        codes_out[...] = rec[:cb].view(self.codes_dtype).reshape(
            self.codes_shape)
        if scales_out is not None:
            scales_out[...] = rec[cb:].view(np.float32).reshape(
                self.scales_shape)

    def _spill_grow_locked(self, new_slots: int) -> None:
        """Lock held. Extend the spill file in place: growth only appends
        slots, so old records are never touched and a sparse truncate is
        crash-safe (a crash leaves a longer file whose extra slots are
        unused; the slot table is in memory). It runs on the scheduler
        thread (the direct-spill fallback), so it copies nothing; the
        temp + os.replace rewrite is compaction's, on the worker."""
        if self._spill_mm is not None:
            self._spill_mm.flush()
            self._spill_mm = None
        if not os.path.exists(self._spill_path):
            with open(self._spill_path, "wb"):
                pass
        os.truncate(self._spill_path, new_slots * self._rec_bytes)
        self._spill_mm = np.memmap(self._spill_path, np.uint8, "r+",
                                   shape=(new_slots, self._rec_bytes))
        self._spill_free.extend(range(new_slots - 1,
                                      self._spill_slots - 1, -1))
        self._spill_slots = new_slots

    # -- background spill / compaction (single-flight) ---------------------

    def _host_high_water(self) -> int:
        return self.n_host_slots - max(1, self.n_host_slots // 8)

    def maintenance_due(self) -> bool:
        """Lock-free peek (a racy read costs at most one no-op kick; the
        worker re-checks under the lock): the host tier is near its
        budget, or the spill file is mostly dead records."""
        if self._busy:
            return False
        if self.n_host_slots and (self.n_host_slots - len(self._host_free)
                                  > self._host_high_water()):
            return True
        return self._compact_due()

    def _compact_due(self) -> bool:
        return (self._spill_dead >= SPILL_MIN_SLOTS // 2
                and self._spill_dead > len(self._spill_nodes))

    def _maybe_kick(self) -> None:
        if self.maintenance_due():
            self.kick_maintenance()

    def kick_maintenance(self) -> bool:
        """Run one maintenance pass (host -> disk spill, then compaction)
        on a background thread, single-flight. True when a worker was
        started."""
        with self._lock:
            if self._busy:
                return False
            self._busy = True

        def run():
            try:
                self._run_maintenance()
            except Exception:
                # No caller to raise to: log and count; the next
                # demotion kicks again.
                _LOG.exception("kv-pager maintenance failed")
                with self._lock:
                    self._bg_errors += 1
            finally:
                with self._lock:
                    self._busy = False

        threading.Thread(target=run, name="kv-pager-maintenance",
                         daemon=True).start()
        return True

    def wait_maintenance(self, timeout: float = 10.0) -> bool:
        """Wait up to `timeout` seconds for the worker to be idle; True
        when it is."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._busy:
                    return True
            time.sleep(0.005)
        return False

    def _run_maintenance(self) -> None:
        """One pass: spill host-LRU pages down to the low-water mark (one
        page per lock hold, so the scheduler's demote/promote interleave),
        then compact the spill file if it is mostly dead."""
        low_water = self.n_host_slots - max(1, self.n_host_slots // 4)
        while True:
            with self._lock:
                used = self.n_host_slots - len(self._host_free)
                if used <= max(0, low_water) or not self._host_lru:
                    break
                victim = next(((slot, node)
                               for slot, node in self._host_lru.items()
                               if id(node) not in self._pins), None)
                if victim is None:
                    break  # everything left is pinned mid-promotion
                slot, node = victim
                spill_slot = self._spill_alloc_locked()
                self._spill_write_locked(
                    spill_slot, self._host_codes[slot],
                    None if self._host_scales is None
                    else self._host_scales[slot])
                node.tier, node.handle = TIER_DISK, spill_slot
                self._spill_nodes[spill_slot] = node
                self._host_lru.pop(slot)
                self._host_free.append(slot)
        with self._lock:
            compact = self._compact_due()
        if compact:
            self._compact()

    def _compact(self) -> None:
        """Rewrite the spill with live records only. Snapshot under the
        lock, copy the old mapping off the lock (new spill writes are
        refused while `_compacting`: the demotion fallback force-drops
        instead), install the new mapping and remapped handles under the
        lock. Crash-safe: temp + os.replace, the old file intact until
        the replace."""
        with self._lock:
            snap = list(self._spill_nodes.items())  # [(slot, node)]
            old_mm = self._spill_mm
            self._compacting = True
        try:
            new_slots = max(SPILL_MIN_SLOTS, _pow2(2 * max(1, len(snap))))
            tmp = f"{self._spill_path}.tmp"
            try:
                mm = np.memmap(tmp, np.uint8, "w+",
                               shape=(new_slots, self._rec_bytes))
                for j, (slot, _) in enumerate(snap):
                    mm[j] = old_mm[slot]
                mm.flush()
                del mm
                reader = np.memmap(tmp, np.uint8, "r+",
                                   shape=(new_slots, self._rec_bytes))
                os.replace(tmp, self._spill_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            with self._lock:
                nodes = {}
                for j, (slot, node) in enumerate(snap):
                    if node.tier == TIER_DISK and node.handle == slot:
                        node.handle = j
                        nodes[j] = node
                    # else: promoted or reattached mid-compaction; its
                    # copied record is dead in the new file.
                self._spill_mm = reader
                self._spill_slots = new_slots
                self._spill_nodes = nodes
                self._spill_free = [s for s in range(new_slots - 1, -1, -1)
                                    if s not in nodes]
                self._spill_dead = 0
                self._compactions += 1
        finally:
            with self._lock:
                self._compacting = False

    # -- surfaces ----------------------------------------------------------

    def stats(self) -> dict:
        """The KV_PAGER_KEYS counters and gauges (EngineMetrics.snapshot
        and /metrics read this)."""
        with self._lock:
            host_pages = self.n_host_slots - len(self._host_free)
            spill_pages = len(self._spill_nodes)
            return {
                "kv_demotions": self._demotions,
                "kv_promotions": self._promotions,
                "kv_promote_tokens": self._promote_tokens,
                "kv_host_pages": host_pages,
                "kv_spill_pages": spill_pages,
                "kv_host_bytes": host_pages * self._rec_bytes,
                "kv_spill_bytes": spill_pages * self._rec_bytes,
                "kv_spill_writes": self._spill_writes,
                "kv_spill_compactions": self._compactions,
                "kv_forced_drops": self._forced_drops,
                "kv_pager_errors": self._bg_errors,
            }

    def close(self) -> None:
        """Drain the worker (a bounded wait) and drop the spill mapping;
        an ephemeral spill dir is removed."""
        if not self.wait_maintenance():
            _LOG.warning("kv-pager close: maintenance still running")
        with self._lock:
            self._spill_mm = None
            self._spill_nodes = {}
            self._spill_free = []
            self._spill_slots = 0
        if self._ephemeral:
            shutil.rmtree(self._spill_dir, ignore_errors=True)


class PagedPrefixCache(RadixPrefixCache):
    """Radix prefix cache whose eviction DEMOTES through the KV pager
    instead of destroying: the tree stays the index for every tier,
    `evict()` frees device pages by parking their bytes host-side
    (selection runs on the LRU heap over the device FRONTIER, then one
    gather moves the whole set), and `promote()` re-seats a matched
    path's non-resident pages with one scatter. Scheduler-thread-owned
    like its base; cross-thread state lives in the pager behind the tier
    lock."""

    def __init__(self, allocator: PageAllocator, page_size: int,
                 capacity_pages: int, pager: KVPager,
                 pool_ref: Callable):
        super().__init__(allocator, page_size, capacity_pages)
        self.pager = pager
        self._pool_ref = pool_ref  # the engine's current pool
        self._pending_demote: List = []

    # -- eviction = demotion -----------------------------------------------

    def _frontier(self, node) -> bool:
        # Demote only device nodes with no device children: the resident
        # set stays closed under ancestors, so a matched path is always
        # [device...][cold...] and promotion is contiguous.
        return node.tier == TIER_DEVICE and node.dev_children == 0

    def _evictable(self, node) -> bool:
        return (node.tier == TIER_DEVICE
                and self.allocator.refcount(node.page) == 1
                and not self.pager.is_pinned(node))

    def _evict_node(self, node) -> None:
        # No "evict" report: the prefix is still servable; only a forced
        # drop reports.
        node.tier = TIER_PENDING
        parent = node.parent
        parent.dev_children -= 1
        self._n_pages -= 1
        self._pending_demote.append(node)
        if parent is not self.root and self._frontier(parent):
            self._heap_push(parent)

    def evict(self, n_pages: int) -> int:
        freed = super().evict(n_pages)
        self._flush_demotions()
        return freed

    def _flush_demotions(self) -> None:
        """Move every selected page's bytes off the device, then hand the
        device pages back to the allocator (the caller is usually its own
        reclaim hook, so the free list must have grown on return)."""
        nodes, self._pending_demote = self._pending_demote, []
        if not nodes:
            return
        try:
            dropped = self.pager.demote(self._pool_ref(), nodes)
        except Exception:
            # The gather or the read failed: destroy instead, so the
            # allocator still gets its pages -- losing cold KV beats
            # failing live admissions.
            _LOG.exception("kv-pager demotion failed; dropping %d pages",
                           len(nodes))
            self.pager.count_error()
            dropped = nodes
        for node in dropped:
            self._destroy_pending(node)
        self.allocator.release([n.page for n in nodes])

    def _destroy_pending(self, node) -> None:
        """A selected node whose bytes could not be stored: remove it from
        the tree (its cold descendants become unreachable and free their
        storage too: a broken chain must never match)."""
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self.pager.discard(n)
            n.children = {}
        if self._reporting():
            self._report("evict", self._path_ids(node))
        del node.parent.children[node.key]
        node.parent = None

    # -- promotion ---------------------------------------------------------

    def promote(self, pool, path_nodes):
        """Make every node of a matched path device-resident: allocate
        pool pages for the cold suffix (the alloc may reclaim-demote OTHER
        cold sessions; the path is pinned so it cannot demote itself),
        then one pages_to_pool scatter. Raises MemoryError when the
        allocator cannot cover the cold pages even after reclaim; the
        caller falls back to the resident prefix."""
        nonres = [n for n in path_nodes if n.tier != TIER_DEVICE]
        if not nonres:
            return pool
        self.pager.pin(path_nodes)
        try:
            pages = self.allocator.alloc(len(nonres))
            try:
                pool = self.pager.promote_into(pool, nonres, pages)
            except BaseException:
                self.allocator.release(pages)
                raise
        finally:
            self.pager.unpin(path_nodes)
        for node in nonres:
            node.parent.dev_children += 1
            self._n_pages += 1
            self._heap_push(node)
        return pool

    # -- overrides keeping the plain cache's semantics tier-aware ----------

    def _on_existing(self, node, payload) -> None:
        # A re-played prompt over a demoted chunk: adopt the fresh device
        # page in place (no promotion).
        if payload is None:
            return
        if self.pager.reattach(node, payload):
            self._adopt(payload)
            node.parent.dev_children += 1
            self._n_pages += 1
            self._heap_push(node)

    def match(self, ids) -> List[int]:
        """Device-RESIDENT page ids of the longest cached prefix (the
        leading device run: cold nodes have no pool page). The engine's
        pager path uses match_nodes + promote instead."""
        pages = []
        for n in self.match_nodes(ids):
            if n.tier != TIER_DEVICE:
                break
            pages.append(n.page)
        return pages

    def reclaimable(self) -> int:
        """Device pages evict() could DEMOTE right now: pendant device
        subtrees in which every device node's page is referenced only by
        the tree (cold children never block: they hold no device
        pages)."""
        count = 0

        def visit(node) -> bool:
            nonlocal count
            oks = [visit(c) for c in list(node.children.values())
                   if c.tier == TIER_DEVICE]
            if node is self.root:
                return False
            if all(oks) and self.allocator.refcount(node.page) == 1 \
                    and not self.pager.is_pinned(node):
                count += 1
                return True
            return False

        for child in list(self.root.children.values()):
            if child.tier == TIER_DEVICE:
                visit(child)
        return count
