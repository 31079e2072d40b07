"""Radix-tree prefix KV cache: cross-request KV reuse at page granularity.

Counterpart of generativeaiexamples_tpu/serving/prefix_cache.py, kept as
the port's own copy (the port imports nothing of the JAX package). Pure
Python: it holds page ids, never tensors.

RAG traffic shares prefixes: every pipeline prepends the same system
prompt, multi-turn chats replay the conversation so far, and popular
queries retrieve the same context chunks. A host-side radix tree keyed
on page-size token-id chunks maps prompt prefixes to ref-counted pages
of the engine's page pool, so a prompt whose prefix is cached prefills
only its suffix.

- `RadixTree`: the payload-generic core. One node per FULL page of token
  ids, longest-prefix match, dedup insert, LRU eviction under a capacity
  budget. It knows nothing about device pages (the fleet router's
  shadow trees, ROADMAP A.16, will reuse it with no payloads).
- `RadixPrefixCache(RadixTree)`: binds the core to the PageAllocator.
  Node payloads are pool page ids, the tree holds one reference per
  cached page, and a leaf is evictable only while no live sequence reads
  its page (refcount == 1). An optional `reporter` callback receives
  admissions and evictions as token-id paths.

Partial tail pages are never cached. The tree is owned by the engine's
scheduler thread; no locking. Eviction is LRU over frontier nodes through
one persistent heap (never a walk over every leaf): `trim()` keeps the
tree under its capacity after inserts, and the allocator's `reclaim`
hook calls `evict()` when live traffic runs short of free pages. The KV
pager (serving/kv_pager.py) overrides the frontier and eviction hooks so
that eviction demotes a page's bytes to host RAM or disk instead.

The engine's admission calls `match()` for the longest cached prefix,
adopts those pages (`SequencePages.adopt`), seeds a scratch cache from
them (`engine_model.pool_to_cache`) and prefills only the suffix;
completed prefills call `insert()`.
"""

from __future__ import annotations

import heapq
from typing import Callable, List, Optional, Sequence

from generativeaiexamples_tpu_torch.serving.kv_cache import PageAllocator

# KV residency tiers (serving/kv_pager.py). Every node is born
# TIER_DEVICE (its payload is a live pool page); the pager's demotion
# flips cold nodes to TIER_HOST (budgeted host-RAM copy) and TIER_DISK
# (mmap'd spill record), promotion flips them back. TIER_PENDING marks
# a node selected for demotion whose bytes have not yet left the
# device (never matched, never re-selected). Plain caches only ever
# see TIER_DEVICE.
TIER_DEVICE = 0
TIER_HOST = 1
TIER_DISK = 2
TIER_PENDING = 3


class _Node:
    __slots__ = ("key", "page", "children", "parent", "last_used",
                 "tier", "handle", "dev_children")

    def __init__(self, key, page, parent):
        self.key = key          # tuple of page_size token ids (root: None)
        self.page = page        # payload: pool page id (shadow trees: None)
        self.parent = parent
        self.children: dict = {}
        self.last_used = 0
        # KV pager residency (inert for plain caches / shadow trees):
        # which tier holds this node's KV bytes, the tier-local handle
        # (host slot / spill slot; None on device — `page` is the
        # device handle), and how many children are device-resident
        # (the pager demotes only the device FRONTIER — device nodes
        # with no device children — so the resident set stays closed
        # under ancestors and a matched path promotes contiguously).
        self.tier = TIER_DEVICE
        self.handle = None
        self.dev_children = 0


class RadixTree:
    """Payload-generic radix tree over page-size token-id chunks.

    Subclasses bind the payload semantics through three hooks:
    `_adopt(payload)` when a new node takes one, `_release(node)` when
    a node is evicted, and `_evictable(node)` gating LRU eviction.
    The base class is fully functional with `None` payloads (the
    fleet router's shadow trees, ROADMAP A.16, will use it so).
    """

    def __init__(self, page_size: int, capacity_pages: int):
        self.page_size = page_size
        # Budget for pages the tree holds (referenced or not); trim()
        # LRU-evicts down to it after inserts. External pressure (the
        # allocator's reclaim hook) can shrink the resident set further
        # at any time.
        self.capacity_pages = max(0, int(capacity_pages))
        self.root = _Node(None, 0, None)
        self._clock = 0   # monotonic LRU clock (no wall time needed)
        self._n_pages = 0
        self.evictions = 0  # total pages evicted (engine mirrors this)
        # Lazily-invalidated LRU heap over eviction-frontier nodes,
        # REUSED across evict() calls (the old per-call rebuild walked
        # every leaf on the scheduler thread per reclaim — O(tree) per
        # alloc shortfall, and the KV pager calls evict far more
        # often). Entries are (last_used-at-push, seq, node); a popped
        # entry whose node was since touched re-enters with its fresh
        # timestamp, one that stopped being a frontier node is dropped
        # (it re-enters when an eviction re-exposes it), so the
        # EFFECTIVE order is identical to a fresh heap over current
        # timestamps — pinned by test against the rebuild-per-call
        # reference.
        self._heap: list = []
        self._heap_seq = 0

    @property
    def n_cached_pages(self) -> int:
        return self._n_pages

    # -- payload hooks (subclasses override) -------------------------------

    def _adopt(self, payload) -> None:
        """A new node is about to take `payload` (cache: retain page)."""

    def _release(self, node: _Node) -> None:
        """`node` was evicted (cache: release its page)."""

    def _evictable(self, node: _Node) -> bool:
        """May evict() free this leaf right now? (cache: refcount==1)."""
        return True

    def _frontier(self, node: _Node) -> bool:
        """Is `node` currently on the eviction frontier? Base trees
        evict leaves; the KV pager's cache demotes device-resident
        nodes with no device-resident children instead."""
        return not node.children

    def _evict_node(self, node: _Node) -> None:
        """Evict one frontier node. Base: unlink it from the tree and
        release its payload (the plain cache destroys). The pager's
        cache overrides this to DEMOTE the node's KV to a colder tier
        while the node stays in the tree as the pager's index."""
        if self._reporting():
            self._report("evict", self._path_ids(node))
        parent = node.parent
        del parent.children[node.key]
        node.parent = None  # dead marker: stale heap entries drop it
        if node.tier == TIER_DEVICE:
            parent.dev_children -= 1
        self._release(node)
        self._n_pages -= 1
        if parent is not self.root and self._frontier(parent):
            self._heap_push(parent)

    def _on_existing(self, node: _Node, payload) -> None:
        """insert() walked onto an already-present chunk. Base: no-op
        (dedup — the duplicate payload stays with the caller). The
        pager's cache re-adopts the fresh device payload when the
        existing node had been demoted, so a re-played prompt makes
        its prefix resident again without a promotion dispatch."""

    def _reporting(self) -> bool:
        """Is anyone listening? Report ARGUMENTS (token-id tuples,
        root-walk paths) are only built when this is True, so the
        reporter-less scheduler hot path pays nothing."""
        return False

    def _report(self, kind: str, ids: tuple) -> None:
        """Eviction/insert event hook (cache: the `reporter` callback).
        Base tree: no-op."""

    # -- internals ---------------------------------------------------------

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_used = self._clock

    def _heap_push(self, node: _Node) -> None:
        """Queue `node` for LRU consideration at its CURRENT
        timestamp. Touches after the push do not re-queue — evict()
        re-sorts a stale entry when it surfaces (lazy decrease-key)."""
        self._heap_seq += 1
        heapq.heappush(self._heap, (node.last_used, self._heap_seq, node))

    def _chunks(self, ids: Sequence[int]):
        ps = self.page_size
        for i in range(0, len(ids) - ps + 1, ps):
            yield tuple(ids[i:i + ps])

    def _leaves(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                yield n

    def _path_ids(self, node: _Node) -> tuple:
        """Token ids spelling the path root -> node (the prefix whose
        last page this node caches)."""
        keys = []
        while node is not self.root:
            keys.append(node.key)
            node = node.parent
        return tuple(t for key in reversed(keys) for t in key)

    # -- public API (owner thread only) ------------------------------------

    def match_nodes(self, ids: Sequence[int]) -> List[_Node]:
        """Longest cached page-granular prefix of `ids` -> node list
        (node i holds tokens ids[i*ps:(i+1)*ps]). Touches the whole
        matched path so hot prefixes stay resident."""
        node, out = self.root, []
        for chunk in self._chunks(ids):
            child = node.children.get(chunk)
            if child is None:
                break
            self._touch(child)
            out.append(child)
            node = child
        return out

    def insert(self, ids: Sequence[int],
               pages: Optional[Sequence] = None) -> int:
        """Register chunk i of `ids` -> pages[i] (payload; None for
        payload-less trees). Chunks already present keep their existing
        node — dedup: the duplicate payload stays with the caller.
        Returns the number of nodes newly created."""
        node, new, walked = self.root, 0, 0
        for i, chunk in enumerate(self._chunks(ids)):
            if pages is not None and i >= len(pages):
                break
            child = node.children.get(chunk)
            created = child is None
            if created:
                payload = pages[i] if pages is not None else None
                self._adopt(payload)
                child = _Node(chunk, payload, node)
                node.children[chunk] = child
                node.dev_children += 1
                self._n_pages += 1
                new += 1
            else:
                self._on_existing(child,
                                  pages[i] if pages is not None else None)
            self._touch(child)
            if created:
                self._heap_push(child)
            node = child
            walked = i + 1
        if walked and self._reporting():
            self._report("insert", tuple(ids[: walked * self.page_size]))
        return new

    def evict(self, n_pages: int) -> int:
        """Free up to n_pages LRU frontier pages that pass
        `_evictable`, releasing (or, in the pager's cache, demoting)
        their payloads. Returns the count actually freed
        (live-referenced chains are skipped).

        Runs off the persistent lazy heap: pops validate that the
        entry's node is still in the tree, still on the frontier, and
        still carries the queued timestamp (touched nodes re-enter at
        their fresh time before being acted on), so eviction order is
        exactly LRU over current timestamps — O(log n) per considered
        node instead of an O(tree) leaf walk per call. Entries skipped
        only for being live-referenced re-enter for the next call."""
        freed = 0
        skipped = []
        heap = self._heap
        while heap and freed < n_pages:
            t, seq, node = heapq.heappop(heap)
            if node.parent is None or not self._frontier(node):
                # Evicted since queued, or no longer frontier (gained a
                # child / was demoted). A node that becomes frontier
                # again is re-pushed at that transition.
                continue
            if node.last_used != t:
                self._heap_push(node)  # touched since queued: re-sort
                continue
            if not self._evictable(node):
                skipped.append((t, seq, node))
                continue
            self._evict_node(node)
            freed += 1
        for entry in skipped:
            heapq.heappush(heap, entry)
        self.evictions += freed
        return freed

    def trim(self) -> int:
        """LRU-evict down to the capacity budget; returns pages freed."""
        over = self._n_pages - self.capacity_pages
        return self.evict(over) if over > 0 else 0


class RadixPrefixCache(RadixTree):
    """Page-granular radix tree over prompt token ids -> pool pages."""

    def __init__(self, allocator: PageAllocator, page_size: int,
                 capacity_pages: int):
        super().__init__(page_size, capacity_pages)
        self.allocator = allocator
        self.root.page = 0  # the sink page
        # Admission/eviction report hook (the fleet router's shadow
        # trees, ROADMAP A.16): called on the scheduler thread with
        # ("insert"|"evict", token_id_tuple) — must be cheap and never
        # raise. None (the default, single-engine mode) is free.
        self.reporter: Optional[Callable[[str, tuple], None]] = None

    # -- payload hooks ------------------------------------------------------

    def _adopt(self, payload) -> None:
        self.allocator.retain([payload])

    def _release(self, node: _Node) -> None:
        self.allocator.release([node.page])

    def _evictable(self, node: _Node) -> bool:
        # refcount > 1: a live sequence still reads this page.
        return self.allocator.refcount(node.page) == 1

    def _reporting(self) -> bool:
        return self.reporter is not None

    def _report(self, kind: str, ids: tuple) -> None:
        self.reporter(kind, ids)

    # -- public API (scheduler thread only) --------------------------------

    def match(self, ids: Sequence[int]) -> List[int]:
        """Longest cached page-granular prefix of `ids` -> page list
        (pages[i] holds tokens ids[i*ps:(i+1)*ps])."""
        return [n.page for n in self.match_nodes(ids)]

    def reclaimable(self) -> int:
        """Pages evict() could free RIGHT NOW: maximal pendant subtrees
        in which every node's page is referenced only by the tree. Used
        by the engine's starvation reaper so a slot is never cut with
        'length' while evictable cached pages could back it."""
        count = 0

        def visit(node: _Node) -> bool:
            nonlocal count
            # list() forces evaluation of every child (no short-circuit):
            # siblings' counts must accrue even when one child is pinned.
            oks = [visit(c) for c in list(node.children.values())]
            if node is self.root:
                return False
            if all(oks) and self.allocator.refcount(node.page) == 1:
                count += 1
                return True
            return False

        visit(self.root)
        return count
