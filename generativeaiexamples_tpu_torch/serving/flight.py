"""Engine flight recorder: per-beat scheduler timeline, exponential
latency histograms, Chrome-trace export.

The port's own copy of generativeaiexamples_tpu/serving/flight.py (pure
numpy; the port imports nothing of the JAX package), with the same event
kinds, record layouts, histogram bounds and export formats, so a
timeline or a scrape reads the same from either engine.

The engine's aggregate counters (EngineMetrics) answer "how much"; the
flight recorder answers "where did the time go". One compact record per
scheduling beat (a landed decode block) and one per request lifecycle
event, written by the SCHEDULER THREAD ONLY into preallocated numpy
ring buffers: O(1) append, no locks, no allocation per beat, cheap
enough to stay on in production (chip_smoke.py measures its host time
per beat). On top of it:

- `ExpHistogram`: exponential-bucket latency histograms (TTFT, e2e,
  queue wait per tier, beat gap, promote ms/page), mergeable across
  engines, exportable in native Prometheus histogram form, always
  present in `EngineMetrics.snapshot()`.
- `chrome_trace()`: the rings rendered as Chrome trace-event JSON
  (Perfetto loads it directly): one process lane per engine, one slice
  per beat (dispatch -> host-ready), request spans correlated to beats
  via rid, instant markers for the known gap causes (admission retry,
  pager promote/demote, prefill chunks).
- `scripts/analyze_timeline.py` reads that JSON and splits wall time
  into device-busy / host-gap / idle with named gap causes.

The engine writes the QoS events (EV_QOS_PICK / PAUSE / RESUME) and, on
an importing replica, EV_KV_TRANSFER; a fleet serves one lane per local
replica plus its control-plane lane ("fleet", where a rolling upgrade
writes EV_UPGRADE) on /debug/timeline. EV_SCALE_* and EV_CHAOS are kept
as constants so the trace schema is the same: their writers, the
autoscaler and the chaos harness, are not ported yet (ROADMAP A.16).

Thread model (deliberately lock-free): every `record_*` call happens on
the engine scheduler thread (submit-time events are recorded
RETROACTIVELY at admission pop, stamped with `req.submit_time`, so no
server thread ever writes). Readers (`/metrics`, `/debug/timeline`)
copy the rings without a lock; each row carries a double sequence
stamp (`seq` written first, `seq2` last) and snapshot() drops rows
whose stamps disagree or fall outside the live window: a torn row is
skipped, never mis-read. `ExpHistogram` is single-writer the same way
(observe() on the scheduler thread, snapshot() copies).
"""

from __future__ import annotations

import bisect
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from generativeaiexamples_tpu_torch.serving.qos import TIERS

# -- lifecycle event kinds ---------------------------------------------------

EV_SUBMIT = 1          # request entered the waiting queue (ts=submit_time)
EV_QOS_PICK = 2        # weighted-fair scheduler picked it (engine.qos)
EV_ADMIT = 3           # slot reserved; a = queue wait ms, slot set
EV_PREFILL_DISPATCH = 4  # bucketed prefill group dispatched; a = prompt len
EV_PREFILL_CHUNK = 5   # one chunk fed (a = tokens; b = 1 on a fused rider)
EV_FIRST_TOKEN = 6     # first token emitted; a = ttft ms, b = ms after
#                        its block landed on the host
EV_RETIRE = 7          # slot retired; code = reason, a = tokens, b = e2e ms
EV_ADMIT_RETRY = 8     # admission failed on page exhaustion (requeued)
EV_QOS_PAUSE = 9       # long prefill paused for a latency-tier TTFT phase
EV_QOS_RESUME = 10     # ... and resumed
EV_KV_PROMOTE = 11     # pager promote (a = pages, b = ms)
EV_KV_DEMOTE = 12      # pager/cache reclaim demotion (a = pages)
# Elastic-fleet control events (the autoscaler and chaos injector, ROADMAP
# A.16 in the port, and the fleet's rolling upgrade). These are NOT
# written into an engine's recorder: each controller owns its own
# single-writer recorder lane, so the scheduler-thread-only invariant
# above holds per ring. aux carries the replica id; a = active-replica
# count after the action.
EV_SCALE_UP = 13       # autoscaler activated/spawned a replica
EV_SCALE_DOWN = 14     # autoscaler parked a replica (warm/cold)
EV_SCALE_WAKE = 15     # submit-time wake of a parked fleet (a = 1)
EV_UPGRADE = 16        # one replica rolled (b = drain+swap ms)
EV_CHAOS = 17          # chaos injection (aux = "<kind>:<rid>")
# Disaggregated prefill/decode (serving/disagg.py): KV pages imported
# from a prefill-role replica (a = pages, b = import ms). Written by
# the IMPORTING engine's scheduler thread (the transfer runs as a
# control op), so the single-writer ring invariant holds and the
# analyzer attributes the beat gap it causes to "disagg".
EV_KV_TRANSFER = 18

EVENT_NAMES = {
    EV_SUBMIT: "submit", EV_QOS_PICK: "qos_pick", EV_ADMIT: "admit",
    EV_PREFILL_DISPATCH: "prefill_dispatch",
    EV_PREFILL_CHUNK: "prefill_chunk", EV_FIRST_TOKEN: "first_token",
    EV_RETIRE: "retire", EV_ADMIT_RETRY: "admission_retry",
    EV_QOS_PAUSE: "qos_pause", EV_QOS_RESUME: "qos_resume",
    EV_KV_PROMOTE: "kv_promote", EV_KV_DEMOTE: "kv_demote",
    EV_SCALE_UP: "scale_up", EV_SCALE_DOWN: "scale_down",
    EV_SCALE_WAKE: "scale_wake", EV_UPGRADE: "upgrade",
    EV_CHAOS: "chaos", EV_KV_TRANSFER: "kv_transfer",
}

# Retire reason codes (EV_RETIRE.code); anything unknown maps to -1.
RETIRE_CODES = {"stop": 0, "length": 1, "error": 2, "cancelled": 3}
RETIRE_NAMES = {v: k for k, v in RETIRE_CODES.items()}

# Gap-cause instants the analyzer attributes host gaps to, in priority
# order (a gap containing several causes is charged to the first).
GAP_CAUSE_KINDS = (EV_QOS_PAUSE, EV_KV_PROMOTE, EV_KV_TRANSFER,
                   EV_ADMIT_RETRY, EV_PREFILL_CHUNK, EV_KV_DEMOTE)

# Fleet control-plane instants: rendered on the timeline (cat "fleet",
# so a TTFT spike can be eyeballed against the scale/upgrade/chaos
# event that caused it) but deliberately NOT gap causes — a replica's
# host gap is never *explained* by another replica being scaled.
FLEET_INSTANT_KINDS = (EV_SCALE_UP, EV_SCALE_DOWN, EV_SCALE_WAKE,
                       EV_UPGRADE, EV_CHAOS)

BEAT_DTYPE = np.dtype([
    # seq opens the record, seq2 CLOSES it and sits LAST in memory:
    # snapshot copies read fields in address order, so a row whose
    # stamps agree was fully written before the copy reached it (the
    # per-record seqlock).
    ("seq", "<i8"),
    ("t_dispatch", "<f8"),    # perf_counter when the block's dispatch returned
    ("t_ready", "<f8"),       # when its results reached the host
    ("t_prev_ready", "<f8"),  # previous beat's t_ready (0 on the first)
    # StepPlan lattice point of the landed dispatch.
    ("decode_k", "<i2"), ("spec_k", "<i2"), ("tree_branches", "<i2"),
    ("rider_width", "<i4"), ("rider_s_total", "<i4"),
    ("spec_state", "?"), ("fused_rider", "?"), ("qos_paused", "?"),
    # Busy slots and waiting-queue depth per QoS tier at landing.
    ("busy_latency", "<i2"), ("busy_standard", "<i2"), ("busy_batch", "<i2"),
    ("wait_latency", "<i2"), ("wait_standard", "<i2"), ("wait_batch", "<i2"),
    ("tokens_emitted", "<i4"),
    # Pager pages moved since the previous beat (scheduler-side moves).
    ("kv_demote_pages", "<i4"), ("kv_promote_pages", "<i4"),
    ("seq2", "<i8"),
])

EVENT_DTYPE = np.dtype([
    ("seq", "<i8"),
    ("ts", "<f8"), ("kind", "<u1"), ("tier", "<u1"),
    ("code", "<i2"), ("slot", "<i2"),
    ("a", "<f8"), ("b", "<f8"),
    ("seq2", "<i8"),
])

# Always-present /metrics keys the recorder contributes (zeros when the
# recorder is off — the repo-wide counter convention).
FLIGHT_KEYS = ("flight_beats", "flight_events", "flight_enabled")

# Always-present histogram keys in EngineMetrics.snapshot() (each maps
# to an ExpHistogram snapshot dict; zero-count dicts when idle).
# QoS tiers by rank (serving/qos.py): a request's tier id is its index.
TIER_STANDARD = TIERS.index("standard")

HIST_KEYS = (
    "hist_ttft_ms", "hist_e2e_ms",
    "hist_queue_wait_ms_latency", "hist_queue_wait_ms_standard",
    "hist_queue_wait_ms_batch",
    "hist_beat_gap_ms", "hist_kv_promote_ms_per_page",
    "hist_kv_transfer_ms_per_page",
)


# ---------------------------------------------------------------------------
# Exponential-bucket histogram
# ---------------------------------------------------------------------------


def default_bounds(lo: float = 0.01, hi: float = 6e7,
                   factor: float = math.sqrt(2.0)) -> Tuple[float, ...]:
    """Geometric bucket upper bounds in ms: 10 us .. ~16.6 h by
    sqrt(2) steps (~52 buckets). One FIXED scheme everywhere so fleet
    merges are element-wise sums, never bucket realignment."""
    out = []
    b = lo
    while b < hi:
        out.append(round(b, 6))
        b *= factor
    return tuple(out)


_DEFAULT_BOUNDS = default_bounds()


class ExpHistogram:
    """Exponential-bucket histogram: O(log buckets) observe into a
    preallocated int64 array, no allocation, single-writer lock-free
    (the scheduler thread observes; scrapes copy).

    snapshot() is JSON-ready and Prometheus-shaped: per-bucket counts
    keyed by their string upper bound, plus count/sum and interpolated
    p50/p95/p99 estimates (exact enough for dashboards; the bucket
    scheme bounds the relative error at sqrt(2))."""

    __slots__ = ("bounds", "counts", "count", "total")

    def __init__(self, bounds: Tuple[float, ...] = _DEFAULT_BOUNDS):
        self.bounds = bounds
        self.counts = np.zeros(len(bounds) + 1, np.int64)  # +overflow
        self.count = 0
        self.total = 0.0

    # graftlint: hot-path
    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.count += 1
        self.total += value

    def snapshot(self) -> Dict[str, Any]:
        # Read count/total BEFORE copying the bucket array: observe()
        # increments the bucket first, so a scrape racing a writer can
        # only see count <= sum(buckets) — the reverse order would let
        # a {count: 1, buckets: {}} snapshot send hist_quantile to the
        # top bound (~12 h) for that scrape.
        count, total = self.count, self.total
        counts = self.counts.copy()
        snap = {
            "count": count,
            "sum": round(total, 3),
            "buckets": {str(b): int(c)
                        for b, c in zip(self.bounds, counts) if c},
            "overflow": int(counts[-1]),
        }
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            snap[key] = hist_quantile(snap, q, bounds=self.bounds)
        return snap


def zero_hist_snapshot() -> Dict[str, Any]:
    """The always-present empty-histogram shape (same keys a live one
    emits), for metrics objects with no histogram backing."""
    return {"count": 0, "sum": 0.0, "buckets": {}, "overflow": 0,
            "p50": None, "p95": None, "p99": None}


def hist_quantile(snap: Dict[str, Any], q: float,
                  bounds: Tuple[float, ...] = _DEFAULT_BOUNDS
                  ) -> Optional[float]:
    """Interpolated quantile estimate from a histogram snapshot dict
    (None when empty). Works on merged/JSON-round-tripped snapshots."""
    total = int(snap.get("count") or 0)
    if total <= 0:
        return None
    # Bucket keys may be a subset (zero buckets omitted); walk the full
    # bound scheme so interpolation has a stable lower edge. Clamp the
    # target to the actual bucket mass: a foreign/merged snapshot whose
    # count outruns its buckets must not walk off the top bound.
    bdict = snap.get("buckets") or {}
    mass = sum(int(v) for v in bdict.values()) \
        + int(snap.get("overflow") or 0)
    if mass <= 0:
        return None
    target = min(q * total, mass)
    seen = 0.0
    prev_bound = 0.0
    for b in bounds:
        c = int(bdict.get(str(b), 0))
        if c and seen + c >= target:
            frac = (target - seen) / c
            return round(prev_bound + (b - prev_bound) * frac, 4)
        seen += c
        prev_bound = b
    return round(prev_bound, 4)  # overflow bucket: clamp to the top bound


def merge_hist_snapshots(snaps: List[Optional[Dict[str, Any]]]
                         ) -> Dict[str, Any]:
    """Element-wise merge of histogram snapshot dicts (missing/None
    entries contribute nothing) — the fleet aggregation primitive. All
    in-repo histograms share one bound scheme, so merge is a sum."""
    out = zero_hist_snapshot()
    buckets: Dict[str, int] = {}
    for s in snaps:
        if not isinstance(s, dict):
            continue
        out["count"] += int(s.get("count") or 0)
        out["sum"] = round(out["sum"] + float(s.get("sum") or 0.0), 3)
        out["overflow"] += int(s.get("overflow") or 0)
        for k, v in (s.get("buckets") or {}).items():
            buckets[k] = buckets.get(k, 0) + int(v)
    out["buckets"] = buckets
    for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
        out[key] = hist_quantile(out, q)
    return out


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Single-writer ring buffers for beat records and request
    lifecycle events. `enabled=False` keeps the object (and its
    always-present stats()) but turns every append into one branch."""

    def __init__(self, ring_size: int = 4096, enabled: bool = True):
        self.ring_size = max(64, int(ring_size))
        self.event_ring = self.ring_size * 4
        self.enabled = bool(enabled)
        self._beats = np.zeros(self.ring_size, BEAT_DTYPE)
        self._beats["seq"] = -1
        self._beats["seq2"] = -2
        self._events = np.zeros(self.event_ring, EVENT_DTYPE)
        self._events["seq"] = -1
        self._events["seq2"] = -2
        # Per-slot rid / aux strings parallel to the event ring
        # (assignment into a preallocated list: no per-event growth).
        self._event_rids: List[str] = [""] * self.event_ring
        self._event_aux: List[str] = [""] * self.event_ring
        self._n_beats = 0
        self._n_events = 0

    def set_enabled(self, enabled: bool) -> None:
        """Runtime toggle (chip_smoke.py uses it for the on-vs-off
        overhead run). Existing ring contents are kept."""
        self.enabled = bool(enabled)

    # -- writers (engine scheduler thread ONLY) ----------------------------

    # graftlint: hot-path
    def record_beat(self, t_dispatch: float, t_ready: float,
                    t_prev_ready: float, decode_k: int, spec_k: int,
                    tree_branches: int, rider_width: int,
                    rider_s_total: int, spec_state: bool,
                    fused_rider: bool, qos_paused: bool,
                    busy: Tuple[int, int, int],
                    wait: Tuple[int, int, int], tokens_emitted: int,
                    kv_demote_pages: int, kv_promote_pages: int) -> None:
        if not self.enabled:
            return
        seq = self._n_beats
        row = self._beats[seq % self.ring_size]
        row["seq"] = seq          # stamp FIRST ...
        row["t_dispatch"] = t_dispatch
        row["t_ready"] = t_ready
        row["t_prev_ready"] = t_prev_ready
        row["decode_k"] = decode_k
        row["spec_k"] = spec_k
        row["tree_branches"] = tree_branches
        row["rider_width"] = rider_width
        row["rider_s_total"] = rider_s_total
        row["spec_state"] = spec_state
        row["fused_rider"] = fused_rider
        row["qos_paused"] = qos_paused
        row["busy_latency"], row["busy_standard"], row["busy_batch"] = busy
        row["wait_latency"], row["wait_standard"], row["wait_batch"] = wait
        row["tokens_emitted"] = tokens_emitted
        row["kv_demote_pages"] = kv_demote_pages
        row["kv_promote_pages"] = kv_promote_pages
        row["seq2"] = seq         # ... and LAST: readers drop torn rows
        self._n_beats = seq + 1

    # graftlint: hot-path
    def record_event(self, kind: int, ts: float, rid: str = "",
                     tier: int = 1, code: int = 0, slot: int = -1,
                     a: float = 0.0, b: float = 0.0,
                     aux: str = "") -> None:
        if not self.enabled:
            return
        seq = self._n_events
        i = seq % self.event_ring
        row = self._events[i]
        row["seq"] = seq
        row["ts"] = ts
        row["kind"] = kind
        row["tier"] = tier
        row["code"] = code
        row["slot"] = slot
        row["a"] = a
        row["b"] = b
        self._event_rids[i] = rid
        self._event_aux[i] = aux
        row["seq2"] = seq
        self._n_events = seq + 1

    # -- readers (any thread; lock-free torn-row-tolerant copies) ----------

    def _snapshot_ring(self, arr: np.ndarray, head: int, size: int
                       ) -> np.ndarray:
        copy = arr.copy()
        lo = max(0, head - size)
        seq = copy["seq"]
        ok = (seq == copy["seq2"]) & (seq >= lo) & (seq < head) \
            & (seq % size == np.arange(size))
        out = copy[ok]
        return out[np.argsort(out["seq"], kind="stable")]

    def snapshot_beats(self) -> np.ndarray:
        """Valid beat records, oldest first (up to ring_size)."""
        return self._snapshot_ring(self._beats, self._n_beats,
                                   self.ring_size)

    def snapshot_events(self) -> List[Dict[str, Any]]:
        """Valid lifecycle events as dicts, oldest first."""
        head = self._n_events
        rows = self._snapshot_ring(self._events, head, self.event_ring)
        out = []
        for r in rows:
            seq = int(r["seq"])
            i = seq % self.event_ring
            rid, aux = self._event_rids[i], self._event_aux[i]
            live = self._events[i]
            if int(live["seq"]) != seq or int(live["seq2"]) != seq:
                # The writer lapped this slot between the array copy
                # and the string reads: rid/aux now belong to a NEWER
                # event (the strings live outside the seqlocked row).
                # The live `seq` check is what catches a lap IN
                # PROGRESS — the writer stamps seq BEFORE the strings,
                # so new strings imply a new live seq even while seq2
                # still holds the old value. Drop the row rather than
                # mis-attribute it.
                continue
            out.append({
                "seq": seq, "ts": float(r["ts"]),
                "kind": int(r["kind"]), "tier": int(r["tier"]),
                "code": int(r["code"]), "slot": int(r["slot"]),
                "a": float(r["a"]), "b": float(r["b"]),
                "rid": rid, "aux": aux,
            })
        return out

    def stats(self) -> Dict[str, int]:
        """Always-present recorder counters (FLIGHT_KEYS)."""
        return {"flight_beats": self._n_beats,
                "flight_events": self._n_events,
                "flight_enabled": int(self.enabled)}


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto-loadable)
# ---------------------------------------------------------------------------

# tid layout inside each replica lane: 0 = beat slices, 1 = scheduler
# instants (gap causes), 16 + slot = request spans (a slot serves one
# request at a time, so spans on one tid never overlap).
TID_BEATS = 0
TID_SCHED = 1
TID_REQ_BASE = 16


def plan_label(decode_k: int, spec_k: int, tree_branches: int,
               rider_width: int, spec_state: bool) -> str:
    """Human label for a StepPlan lattice point (timeline slice names)."""
    if decode_k == 0:
        return f"chunk W={rider_width}"
    parts = [f"decode K={decode_k}"]
    if spec_state:
        parts.append("spec-fallback")
    elif spec_k:
        parts.append(f"spec k={spec_k}"
                     + (f" tree={tree_branches}" if tree_branches > 1
                        else ""))
    if rider_width:
        parts.append(f"rider W={rider_width}")
    return " ".join(parts)


def _beat_events(pid: int, beats: np.ndarray,
                 base: float) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    for b in beats:
        t_d = float(b["t_dispatch"]) - base
        t_r = float(b["t_ready"]) - base
        prev = float(b["t_prev_ready"])
        prev = prev - base if prev else 0.0
        host_gap_ms = max(0.0, (t_d - prev) * 1e3) if prev else 0.0
        # Slice = the VISIBLE device interval: pipelined dispatches
        # overlap the previous block's readback, so the slice starts
        # at max(dispatch, previous ready) — lanes stay non-
        # overlapping (Perfetto-clean) and the union still equals
        # device-busy time. The raw dispatch stamp rides in args.
        t_vis = max(t_d, prev)
        # Round the ENDPOINTS and subtract (rounding ts and dur
        # independently would let adjacent slices overlap by one
        # rounding ulp and break strict nesting).
        ts_us = round(t_vis * 1e6, 1)
        dur_us = max(0.0, round(round(t_r * 1e6, 1) - ts_us, 1))
        out.append({
            "name": plan_label(int(b["decode_k"]), int(b["spec_k"]),
                               int(b["tree_branches"]),
                               int(b["rider_width"]),
                               bool(b["spec_state"])),
            "cat": "beat", "ph": "X", "pid": pid, "tid": TID_BEATS,
            "ts": ts_us, "dur": dur_us,
            "args": {
                "seq": int(b["seq"]),
                "t_dispatch_us": round(t_d * 1e6, 1),
                "tokens_emitted": int(b["tokens_emitted"]),
                "host_gap_ms": round(host_gap_ms, 3),
                "busy": {"latency": int(b["busy_latency"]),
                         "standard": int(b["busy_standard"]),
                         "batch": int(b["busy_batch"])},
                "waiting": {"latency": int(b["wait_latency"]),
                            "standard": int(b["wait_standard"]),
                            "batch": int(b["wait_batch"])},
                "fused_rider": bool(b["fused_rider"]),
                "qos_paused": bool(b["qos_paused"]),
                "kv_demote_pages": int(b["kv_demote_pages"]),
                "kv_promote_pages": int(b["kv_promote_pages"]),
            },
        })
    return out


def _request_events(pid: int, events: List[Dict[str, Any]],
                    base: float) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    by_rid: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        kind = ev["kind"]
        if kind in GAP_CAUSE_KINDS or kind == EV_QOS_RESUME \
                or kind in FLEET_INSTANT_KINDS:
            out.append({
                "name": EVENT_NAMES.get(kind, str(kind)),
                # Fleet control events get their own category: the
                # analyzer charges host gaps to "gap-cause" instants
                # only, and a scale decision is context, not a cause.
                "cat": ("fleet" if kind in FLEET_INSTANT_KINDS
                        else "gap-cause"),
                "ph": "i", "s": "t",
                "pid": pid, "tid": TID_SCHED,
                "ts": round((ev["ts"] - base) * 1e6, 1),
                "args": {"rid": ev["rid"], "a": ev["a"], "b": ev["b"],
                         "aux": ev["aux"]},
            })
        rid = ev["rid"]
        if not rid:
            continue
        rec = by_rid.setdefault(rid, {"marks": {}, "slot": -1,
                                      "tier": ev["tier"], "aux": ""})
        rec["marks"].setdefault(kind, ev)
        if kind == EV_ADMIT:
            rec["slot"] = ev["slot"]
        if kind == EV_RETIRE:
            rec["aux"] = ev["aux"]
            rec["marks"][EV_RETIRE] = ev  # latest retire wins
    for rid, rec in by_rid.items():
        marks = rec["marks"]
        t1 = max(ev["ts"] for ev in marks.values())
        tid = TID_REQ_BASE + max(0, rec["slot"])
        retire = marks.get(EV_RETIRE)
        tier = TIERS[rec["tier"]] if rec["tier"] < len(TIERS) else "standard"
        args: Dict[str, Any] = {"rid": rid, "tier": tier,
                                "open": retire is None}
        if retire is not None:
            args["finish_reason"] = RETIRE_NAMES.get(retire["code"],
                                                     str(retire["code"]))
            args["tokens_generated"] = int(retire["a"])
        if rec["aux"]:
            args["trace_id"] = rec["aux"]  # rid <-> trace correlation

        def us(t: float) -> float:
            return round((t - base) * 1e6, 1)

        sub, adm = marks.get(EV_SUBMIT), marks.get(EV_ADMIT)
        # The queued phase is an ASYNC span (ph b/e keyed by rid):
        # queued requests overlap each other — and a request queued
        # while its future slot still served the previous occupant
        # would overlap that occupant's span — so the queue phase
        # cannot live on a synchronous X track without breaking strict
        # nesting. Perfetto renders async pairs on their own rows.
        if sub is not None:
            q_end = adm["ts"] if adm is not None else t1
            out.append({"name": "queue_wait", "cat": "queue", "ph": "b",
                        "id": rid, "pid": pid, "tid": TID_SCHED,
                        "ts": us(sub["ts"]),
                        "args": {"rid": rid, "tier": tier}})
            out.append({"name": "queue_wait", "cat": "queue", "ph": "e",
                        "id": rid, "pid": pid, "tid": TID_SCHED,
                        "ts": us(max(q_end, sub["ts"]))})
        if adm is None:
            continue  # never admitted: queue span + instants only
        # The request's X span starts at ADMIT: slot occupancy is
        # exclusive from admit to retire (the scheduler retires a slot
        # before re-admitting into it), so per-slot tracks nest
        # strictly.
        out.append({"name": f"req {rid}" if rid else "req", "cat": "request",
                    "ph": "X", "pid": pid, "tid": tid,
                    "ts": us(adm["ts"]),
                    "dur": max(0.0, round(us(t1) - us(adm["ts"]), 1)),
                    "args": args})
        first = marks.get(EV_FIRST_TOKEN)
        if first and first["ts"] >= adm["ts"]:
            out.append({"name": "ttft", "cat": "request", "ph": "X",
                        "pid": pid, "tid": tid,
                        "ts": us(adm["ts"]),
                        "dur": round(us(first["ts"]) - us(adm["ts"]), 1),
                        "args": {"rid": rid,
                                 "ttft_ms": round(first["a"], 2)}})
    return out


def chrome_trace(recorders: Dict[str, FlightRecorder]) -> Dict[str, Any]:
    """Render one or more recorders (replica name -> recorder) as a
    Chrome trace-event JSON dict. Perfetto / chrome://tracing load the
    serialized form directly; one process lane per replica."""
    events: List[Dict[str, Any]] = []
    snaps = {name: (rec.snapshot_beats(), rec.snapshot_events())
             for name, rec in recorders.items()}
    # Rebase every timestamp onto the earliest one across all lanes:
    # perf_counter's origin is arbitrary and huge, and microsecond
    # rounding at that magnitude would wobble adjacent slices; local
    # replicas share one clock, so one base aligns the lanes. The min
    # scans EVERY stamp, not just the oldest-by-seq entries — submit
    # events are stamped retroactively with the request's submit
    # time, so under QoS reordering a later-seq event can carry the
    # earliest timestamp (a first-entry base would go negative).
    stamps = [float(b["t_dispatch"]) for bs, _ in snaps.values()
              for b in bs]
    stamps += [ev["ts"] for _, evs in snaps.values() for ev in evs]
    base = min(stamps) if stamps else 0.0
    for pid, name in enumerate(sorted(snaps)):
        beats, evs = snaps[name]
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": f"replica {name}"}})
        for tid, tname in ((TID_BEATS, "scheduler beats"),
                           (TID_SCHED, "scheduler events")):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": tname}})
        events.extend(_beat_events(pid, beats, base))
        events.extend(_request_events(pid, evs, base))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def spans_nest(trace: Dict[str, Any]) -> bool:
    """Validate the export invariant: per (pid, tid) lane, synchronous
    X slices are pairwise disjoint or strictly contained (async b/e
    pairs — the queue phase — are exempt by design; they overlap).
    One shared checker for chip_smoke.py and tests — two drifting
    copies of a nesting invariant would enforce different contracts."""
    lanes: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}
    for ev in trace["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        lanes.setdefault((ev["pid"], ev["tid"]), []).append(
            (ev["ts"], ev["ts"] + ev.get("dur", 0.0)))
    for spans in lanes.values():
        # Parent-first: same start -> widest span sorts first, so a
        # child starting inside a parent must also END inside it.
        spans.sort(key=lambda s: (s[0], -s[1]))
        eps = 0.05  # half the 0.1 us rounding quantum
        for i, (lo_a, hi_a) in enumerate(spans):
            for lo_b, hi_b in spans[i + 1:]:
                if lo_b >= hi_a - eps:
                    break  # disjoint (sorted)
                if hi_b > hi_a + eps:
                    return False  # overlaps without containment
    return True


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_PROM_SANITIZE = str.maketrans({c: "_" for c in "-.:/ "})


def _prom_name(key: str, prefix: str) -> str:
    name = f"{prefix}_{key}".translate(_PROM_SANITIZE)
    return "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in name)


def _is_hist_snapshot(v: Any) -> bool:
    return isinstance(v, dict) and "buckets" in v and "count" in v


def prometheus_text(snap: Dict[str, Any], prefix: str = "gaie") -> str:
    """Render a metrics snapshot dict as Prometheus text exposition
    (format 0.0.4): scalars become gauges, flat str->number dicts
    become labelled gauges (`{key="..."}`), histogram snapshot dicts
    become native Prometheus histograms (cumulative `_bucket{le=}`,
    `_sum`, `_count`). Deep-nested values (per_replica) are skipped —
    scrape each replica's own /metrics for those."""
    lines: List[str] = []
    for key in sorted(snap):
        v = snap[key]
        name = _prom_name(key[5:] if key.startswith("hist_") else key,
                          prefix)
        if _is_hist_snapshot(v):
            lines.append(f"# TYPE {name} histogram")
            cum = 0
            buckets = v.get("buckets") or {}
            for b in sorted(buckets, key=float):
                cum += int(buckets[b])
                lines.append(f'{name}_bucket{{le="{float(b):g}"}} {cum}')
            cum += int(v.get("overflow") or 0)
            lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{name}_sum {float(v.get('sum') or 0.0):g}")
            lines.append(f"{name}_count {int(v.get('count') or 0)}")
        elif isinstance(v, bool):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {int(v)}")
        elif isinstance(v, (int, float)):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {v:g}")
        elif isinstance(v, dict):
            flat = {k: x for k, x in v.items()
                    if isinstance(x, (int, float)) and not isinstance(x, bool)}
            if not flat:
                continue  # nested non-numeric (per_replica): skipped
            lines.append(f"# TYPE {name} gauge")
            for k in sorted(flat):
                lines.append(f'{name}{{key="{k}"}} {flat[k]:g}')
        # None / strings / lists: no Prometheus representation
    return "\n".join(lines) + "\n"
