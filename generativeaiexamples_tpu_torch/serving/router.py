"""Prefix-locality request router over data-parallel engine replicas.

The port's own copy of generativeaiexamples_tpu/serving/router.py (pure
Python over the port's `serving/prefix_cache.RadixTree`): the same
scores, placements and counters for the same reports and submits.

One engine in one process tops out at one chip's (or one TP slice's)
decode bandwidth; the millions-of-users topology is N data-parallel
replicas behind a router (serving/fleet.py). Load-only balancing wastes
the replicas' KV caches: a follow-up conversation turn or a repeated
RAG template re-prefills from token zero on whichever replica the
round-robin lands on, even though some replica already holds its
prefix KV. Cache-aware placement is the load-bearing trick in modern
multi-replica serving — SGLang's radix-tree cache-aware scheduling and
Mooncake's KV-centric request routing both beat load-only balancing by
a wide margin — and the radix prefix cache gives this router the
exact signal for free.

Placement (PrefixLocalityRouter.place, the fleet dispatch hot path):

1. **Session affinity** — a request carrying a session id (OpenAI
   `user` field / `x-session-id` header) goes back to the replica that
   served the session within `fleet.affinity_ttl_s`. Conversations are
   the dominant shared-prefix shape; affinity answers without touching
   the shadow trees.
2. **Prefix locality** — every replica has a SHADOW radix tree (the
   same page-granular machinery as serving/prefix_cache.py, payloads
   dropped) mirroring what that replica's real cache holds, fed by the
   engine's admission/eviction reports. The router scores
   `matched_tokens - load_penalty_tokens * queue_depth` and takes the
   best positive hit: locality wins until the owning replica is so
   deep that re-prefilling elsewhere is cheaper.
3. **Stable-hash fallback** — no session, no cached prefix: hash the
   prompt's first page of token ids onto the admitting replicas, so
   identical cold templates converge on one replica (seeding future
   locality) without any coordination. A hash choice more than
   `_OVERLOAD_SLACK` requests deeper than the shallowest replica is
   overridden to least-loaded — the hash must never pile a hot
   template onto a drowning replica.

Shadow consistency: replicas report `("insert", ids)` when a prefill's
pages land in their radix cache and `("evict", ids)` per page LRU-
evicted (prefix_cache.py reporter hook, scheduler thread). Reports are
queued lock-free and drained at the next placement; a replica without
a real prefix cache self-feeds its shadow at placement time (the
router then tracks what the replica WOULD have cached). Drain/evict
drops the replica's whole shadow (`router_rebalances`).

Counters (always present in /metrics — 0, never absent, when the
fleet is off; the engine-counter convention): router_requests,
router_prefix_hits, router_hit_tokens, router_affinity_hits,
router_rebalances, replica_evictions, router_requeued, per-replica
queue depth.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import deque
from typing import Dict, List, Sequence

from generativeaiexamples_tpu_torch.serving.prefix_cache import RadixTree
from generativeaiexamples_tpu_torch.serving.qos import (
    TIER_LOAD_WEIGHT, normalize_tier)

# A stable-hash choice this many queued requests deeper than the
# shallowest admitting replica falls back to least-loaded.
_OVERLOAD_SLACK = 4

# The router's scalar counters — the ONE list behind the "always
# present, 0 when the fleet is off" convention: Router.snapshot()
# reads these attributes, and EngineMetrics.snapshot() emits the same
# keys as zeros so /metrics keeps one schema across topologies
# (router_queue_depth, the lone non-scalar, rides alongside as {}).
ROUTER_COUNTER_KEYS = (
    "router_requests", "router_prefix_hits", "router_hit_tokens",
    "router_affinity_hits", "router_rebalances", "replica_evictions",
    "router_requeued", "router_disagg_plans",
)

# Replica roles (fleet.replica_roles / serving/disagg.py): a
# "prefill"-role replica runs prefill stages only and NEVER receives
# decode placements; "decode" and "mixed" replicas serve normal
# traffic. With no prefill-role replicas the fleet is colocated and
# placement is byte-identical to the role-less router.
REPLICA_ROLES = ("prefill", "decode", "mixed")


class ShadowRadixTree(RadixTree):
    """Per-replica shadow of a replica's prefix cache: the RadixTree
    core with no payloads (every leaf always evictable). Owned by the
    router; all access under the router's lock."""

    def match_tokens(self, ids: Sequence[int]) -> int:
        """Length in tokens of the longest shadowed prefix of `ids`."""
        return len(self.match_nodes(ids)) * self.page_size

    def remove_path(self, ids: Sequence[int]) -> int:
        """Apply an eviction report: drop the node at the page-granular
        path `ids` AND its subtree (the real cache evicts leaf-first,
        but a self-fed shadow may run deeper than the real tree).
        Unknown paths are ignored. Returns nodes removed."""
        node = self.root
        for chunk in self._chunks(ids):
            node = node.children.get(chunk)
            if node is None:
                return 0
        removed = 0
        parent = node.parent
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            # Mark every removed node DEAD (parent=None): the base
            # tree's persistent eviction heap validates entries by
            # `parent is None`, and an out-of-band removal that left
            # the pointer set would let a stale entry pass — evict()
            # would then re-delete the node's key (KeyError), or worse
            # delete a re-inserted live twin.
            n.parent = None
            removed += 1
        del parent.children[node.key]
        parent.dev_children -= 1
        if parent is not self.root and self._frontier(parent):
            # The removal may have turned the parent into a frontier
            # leaf: without a re-push it could linger unevictable (its
            # old heap entry was discarded while it had children) and
            # trim() would evict fresher nodes instead.
            self._heap_push(parent)
        self._n_pages -= removed
        self.evictions += removed
        return removed


class ReplicaState:
    """Router-side view of one replica: shadow tree, queue accounting,
    admission flag. Mutated only under the router's lock (the fleet
    calls in with its own state transitions)."""

    def __init__(self, rid: str, page_size: int, shadow_capacity: int,
                 self_feed: bool, role: str = "mixed"):
        self.rid = rid
        self.shadow = ShadowRadixTree(page_size, shadow_capacity)
        # Replica admits new placements (False while draining/evicted).
        self.admitting = True
        # Disagg role (REPLICA_ROLES): "prefill" keeps this replica
        # out of decode placement entirely.
        self.role = role
        # Live requests routed here and not yet finished, and their
        # undelivered token budget (the in-flight token load signal).
        self.inflight = 0
        self.pending_tokens = 0
        # Per-tier split of `inflight` (serving/qos.py tiers): the
        # locality score weighs queued latency-tier requests heavier
        # than batch backlog — tier pressure, not just raw depth.
        self.inflight_tier: Dict[str, int] = {}
        # No real prefix cache on the replica -> the router feeds the
        # shadow itself at placement time.
        self.self_feed = self_feed
        self.reports: deque = deque()  # (kind, ids) from the engine


class PrefixLocalityRouter:
    """Scores replicas by prefix-cache locality, queue depth and
    session affinity; owns the shadow trees and the router counters.

    Thread model: `place()` runs on server request threads; report
    queues are appended by engine scheduler threads (deque.append is
    atomic) and drained under `self._lock`, which also guards every
    ReplicaState and the affinity map.
    """

    def __init__(self, page_size: int, policy: str = "prefix",
                 affinity_ttl_s: float = 300.0,
                 load_penalty_tokens: int = 256,
                 shadow_capacity_pages: int = 4096):
        if policy not in ("prefix", "least_load", "round_robin"):
            raise ValueError(f"unknown fleet.router_policy {policy!r}")
        self.page_size = page_size
        self.policy = policy
        self.affinity_ttl_s = affinity_ttl_s
        self.load_penalty_tokens = load_penalty_tokens
        self.shadow_capacity_pages = shadow_capacity_pages
        self._lock = threading.Lock()
        self._replicas: Dict[str, ReplicaState] = {}
        self._affinity: Dict[str, tuple] = {}  # session -> (rid, expiry)
        self._rr_next = 0  # round_robin cursor
        # Counters (reads are lock-free: ints under the GIL, writers
        # hold the lock).
        self.router_requests = 0
        self.router_prefix_hits = 0
        self.router_hit_tokens = 0
        self.router_affinity_hits = 0
        self.router_rebalances = 0
        self.replica_evictions = 0
        self.router_requeued = 0
        self.router_disagg_plans = 0

    # -- replica registry (fleet calls; state transitions) -----------------

    def add_replica(self, rid: str, self_feed: bool,
                    role: str = "mixed") -> None:
        if role not in REPLICA_ROLES:
            raise ValueError(f"unknown replica role {role!r}")
        with self._lock:
            self._replicas[rid] = ReplicaState(
                rid, self.page_size, self.shadow_capacity_pages, self_feed,
                role=role)

    def set_role(self, rid: str, role: str) -> None:
        if role not in REPLICA_ROLES:
            raise ValueError(f"unknown replica role {role!r}")
        with self._lock:
            self._replicas[rid].role = role

    def roles(self) -> Dict[str, str]:
        with self._lock:
            return {rid: st.role for rid, st in self._replicas.items()}

    def reporter_for(self, rid: str):
        """Admission/eviction report sink for one replica's radix cache
        (prefix_cache.py `reporter`): lock-free append on the engine's
        scheduler thread, drained at the next placement."""
        state = self._replicas[rid]

        def report(kind: str, ids: tuple) -> None:
            state.reports.append((kind, ids))

        return report

    def set_admitting(self, rid: str, admitting: bool) -> None:
        with self._lock:
            self._replicas[rid].admitting = admitting

    def drop_shadow(self, rid: str) -> None:
        """Drain/evict rebalance: the replica's cache contents are gone
        (or going); start its shadow over so stale locality can't pull
        traffic to a replica that no longer holds the KV."""
        with self._lock:
            st = self._replicas[rid]
            st.shadow = ShadowRadixTree(self.page_size,
                                        self.shadow_capacity_pages)
            st.reports.clear()
            self._affinity = {k: v for k, v in self._affinity.items()
                              if v[0] != rid}
            self.router_rebalances += 1

    # -- load accounting (fleet stream hooks) ------------------------------

    def note_submitted(self, rid: str, est_tokens: int,
                       tier: str = "standard") -> None:
        with self._lock:
            st = self._replicas[rid]
            st.inflight += 1
            st.pending_tokens += est_tokens
            tier = normalize_tier(tier)
            st.inflight_tier[tier] = st.inflight_tier.get(tier, 0) + 1

    def note_progress(self, rid: str, tokens: int) -> None:
        with self._lock:
            st = self._replicas.get(rid)
            if st is not None:
                st.pending_tokens = max(0, st.pending_tokens - tokens)

    def note_finished(self, rid: str, leftover_tokens: int,
                      tier: str = "standard") -> None:
        with self._lock:
            st = self._replicas.get(rid)
            if st is not None:
                st.inflight = max(0, st.inflight - 1)
                st.pending_tokens = max(0, st.pending_tokens
                                        - leftover_tokens)
                tier = normalize_tier(tier)
                st.inflight_tier[tier] = max(
                    0, st.inflight_tier.get(tier, 0) - 1)

    def note_evicted(self, rid: str) -> None:
        with self._lock:
            self.replica_evictions += 1

    def note_requeued(self) -> None:
        with self._lock:
            self.router_requeued += 1

    def queue_depths(self) -> Dict[str, int]:
        with self._lock:
            return {rid: st.inflight for rid, st in self._replicas.items()}

    def tier_queue_depths(self) -> Dict[str, Dict[str, int]]:
        """Per-replica, per-tier in-flight depth (the exported tier-
        pressure signal behind _score's weighting)."""
        with self._lock:
            return {rid: dict(st.inflight_tier)
                    for rid, st in self._replicas.items()}

    # -- placement (the fleet dispatch hot path) ---------------------------

    def _apply_reports(self, st: ReplicaState) -> None:
        """Drain one replica's admission/eviction reports into its
        shadow. Lock held."""
        while st.reports:
            kind, ids = st.reports.popleft()
            if kind == "insert":
                st.shadow.insert(ids)
                st.shadow.trim()
            elif kind == "evict":
                st.shadow.remove_path(ids)

    def _score(self, st: ReplicaState, ids: Sequence[int]) -> tuple:
        """(score, matched_tokens) for one admitting replica. Lock
        held. Score units are tokens: cached-prefix tokens this replica
        would skip, minus a queue-depth penalty — locality wins until
        the owning replica is deep enough that prefilling elsewhere is
        cheaper. Depth is TIER-WEIGHTED (serving/qos.py
        TIER_LOAD_WEIGHT): queued latency-tier requests repel new
        placements harder than batch backlog; all-standard traffic
        weighs exactly like the raw count, so tier-less deployments
        score byte-identically."""
        matched = st.shadow.match_tokens(ids)
        return (matched - self.load_penalty_tokens
                * self._tier_pressure(st), matched)

    def _tier_pressure(self, st: ReplicaState) -> int:
        """Lock held. Tier-weighted queue depth; falls back to the raw
        count when no per-tier accounting has been reported."""
        if not st.inflight_tier:
            return st.inflight
        return sum(n * TIER_LOAD_WEIGHT.get(t, 1)
                   for t, n in st.inflight_tier.items())

    # graftlint: hot-path
    def place(self, ids: Sequence[int], session: str = "") -> str:
        """Pick the replica for a prompt. Raises LookupError when no
        replica admits (the fleet maps it to 503). Prefill-role
        replicas (disagg) are never decode candidates — they only see
        the prefill stages place_disagg hands them."""
        with self._lock:
            for st in self._replicas.values():
                self._apply_reports(st)
            cands = [st for st in self._replicas.values()
                     if st.admitting and st.role != "prefill"]
            if not cands:
                raise LookupError("no admitting decode-capable replica")
            return self._place_locked(cands, ids, session)

    # graftlint: hot-path
    def place_disagg(self, ids: Sequence[int], session: str = ""):
        """Two-stage disagg plan: (prefill_rid, decode_rid). The
        decode replica is chosen by the NORMAL scoring (affinity,
        locality, load) over decode-capable replicas — placement
        bookkeeping included, so the caller must NOT call place()
        again for this request — and the prefill stage goes to the
        least-pressured prefill-role replica. Returns

        - (prefill_rid, decode_rid): run the two-stage path;
        - ("", decode_rid): serve colocated on decode_rid (the decode
          replica already shadows the full-page prefix, or the prompt
          has no full page — a transfer would move nothing);
        - None: no admitting prefill-role AND decode-capable split
          exists; the caller uses plain place().
        """
        full = (len(ids) // self.page_size) * self.page_size
        with self._lock:
            for st in self._replicas.values():
                self._apply_reports(st)
            prefills = [st for st in self._replicas.values()
                        if st.admitting and st.role == "prefill"]
            decodes = [st for st in self._replicas.values()
                       if st.admitting and st.role != "prefill"]
            if not prefills or not decodes:
                return None
            # Shadow coverage BEFORE placement bookkeeping: a
            # self-feeding decode shadow absorbs this very prompt
            # inside _place_locked, which would read as full coverage.
            pre = {st.rid: st.shadow.match_tokens(ids) for st in decodes}
            drid = self._place_locked(decodes, ids, session)
            if full <= 0 or pre[drid] >= full:
                return "", drid
            prid = min(prefills,
                       key=lambda s: (self._tier_pressure(s),
                                      s.pending_tokens, s.rid)).rid
            self.router_disagg_plans += 1
            return prid, drid

    def _place_locked(self, cands: List[ReplicaState],
                      ids: Sequence[int], session: str) -> str:
        """Lock held. Score + pick over `cands` with full placement
        bookkeeping (request count, affinity pin, self-feed, prefix-
        hit counters) — shared by place() and place_disagg()."""
        now = time.monotonic()
        self.router_requests += 1
        chosen, matched = self._choose(cands, ids, session, now)
        if session:
            if len(self._affinity) > 65536:  # TTL-expired entries
                self._affinity = {k: v for k, v in
                                  self._affinity.items() if v[1] > now}
            self._affinity[session] = (chosen.rid,
                                       now + self.affinity_ttl_s)
        if chosen.self_feed:
            # No real cache on the replica: shadow what it WOULD
            # cache so repeats still converge.
            chosen.shadow.insert(ids)
            chosen.shadow.trim()
        if matched > 0:
            self.router_prefix_hits += 1
            self.router_hit_tokens += matched
        return chosen.rid

    def _choose(self, cands: List[ReplicaState], ids: Sequence[int],
                session: str, now: float) -> tuple:
        """Lock held. -> (ReplicaState, matched_tokens_credited)."""
        if self.policy == "round_robin":
            self._rr_next += 1
            return cands[self._rr_next % len(cands)], 0
        if self.policy == "least_load":
            return min(cands, key=lambda s: (s.inflight, s.pending_tokens,
                                             s.rid)), 0
        # policy == "prefix"
        if session:
            aff = self._affinity.get(session)
            if aff is not None and aff[1] > now:
                for st in cands:
                    if st.rid == aff[0]:
                        self.router_affinity_hits += 1
                        # Credit the locality the affinity implies so
                        # hit-rate reflects warm turns, not just
                        # shadow-scored ones.
                        return st, st.shadow.match_tokens(ids)
        scored = [(self._score(st, ids), st) for st in cands]
        (best_score, best_matched), best = max(
            scored, key=lambda t: (t[0][0], t[0][1], t[1].rid))
        # Locality wins only while the skipped-prefill tokens outweigh
        # how much deeper the owning replica is than the shallowest one
        # (equivalently: its score beats the best achievable load-only
        # score). Past that, re-prefilling elsewhere is cheaper.
        floor = min(st.inflight for st in cands)
        if best_matched > 0 and \
                best_score > -self.load_penalty_tokens * floor:
            return best, best_matched
        # Cold prompt: stable hash of the first page of ids keeps
        # identical templates converging on one replica.
        ordered = sorted(cands, key=lambda s: s.rid)
        h = zlib.crc32(" ".join(
            str(t) for t in ids[: self.page_size]).encode())
        choice = ordered[h % len(ordered)]
        if choice.inflight - floor > _OVERLOAD_SLACK:
            choice = min(cands, key=lambda s: (s.inflight,
                                               s.pending_tokens, s.rid))
        return choice, 0

    # -- counters ----------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = {k: getattr(self, k)
                                      for k in ROUTER_COUNTER_KEYS}
            out["router_queue_depth"] = {rid: st.inflight for rid, st in
                                         self._replicas.items()}
            out["router_tier_depth"] = {rid: dict(st.inflight_tier)
                                        for rid, st in
                                        self._replicas.items()}
            return out
