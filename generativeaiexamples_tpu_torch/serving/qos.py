"""SLO-aware multi-tenant QoS: tiers, weighted-fair admission,
edge load-shedding, and the trace-driven goodput harness.

The port's own copy of generativeaiexamples_tpu/serving/qos.py (pure
Python; the port imports nothing of the JAX package): the same tiers,
pick order, shedding decisions and seeded traces.

The engine's admission queue is FIFO and every bench workload is a
uniform burst — which measures peak tok/s and nothing else. At
production traffic shapes (bursty, heavy-tailed, multi-tenant) the
metric that matters is **goodput under SLO**: the fraction of requests
that meet their tier's TTFT / inter-token-gap targets, per tier. A
single tenant's long-prompt flood must not starve latency-sensitive
callers, and overload must surface as fast 429s at the edge rather
than unbounded queueing (Orca gives iteration-level scheduling points,
Sarathi-style chunking gives the preemption boundary; this module is
the policy layer on top).

Three tiers (`latency` / `standard` / `batch`), requested per call via
the body `priority` field or `x-priority` header; tenant identity
rides the OpenAI `user` field / `x-tenant-id` header (the same keys
the fleet router reads for session affinity). Unknown tiers normalize
to `standard`, so the tier system is opt-in per request.

Pieces:

- `TierScheduler` — weighted-fair admission order over the engine's
  waiting queue (serving/engine.py `_admit_waiting` consults it when
  `engine.qos` is on): among tiers with waiting requests, pick the one
  with the least service-per-weight (estimated tokens admitted /
  tier weight), then the least-served tenant within it, then FIFO.
  Latency gets `qos_weight_latency` of the admission bandwidth but
  batch's weight is never zero — the starvation bound is structural,
  not a timer.
- `EdgeAdmission` — per-tier in-flight bounds at the HTTP edge
  (serving/openai_server.py): past the bound a request is shed with
  429 + Retry-After BEFORE it queues on the engine, so overload costs
  the caller one RTT instead of an unbounded wait.
- `bursty_trace` / `run_trace_on_engine` / `goodput` — the seeded,
  replayable load harness behind chip_smoke.py's QoS run and the
  tests: Poisson(+burst) arrivals, bounded-Pareto prompt/output
  lengths, per-tier SLO evaluation.

Thread model: `TierScheduler` is engine-scheduler-thread-only (called
under the engine's waiting lock). `EdgeAdmission` takes its own lock
(server request handlers race). The harness helpers spawn their own
submit/collect threads.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

TIERS = ("latency", "standard", "batch")
DEFAULT_TIER = "standard"
TIER_RANK = {t: i for i, t in enumerate(TIERS)}

# Router-side load weighting: a replica's queued latency-tier requests
# discourage new placements twice as hard as standard traffic (they are
# the ones an extra neighbor hurts most). All-standard traffic weighs
# exactly like the raw queue depth, so tier-less deployments score
# byte-identically to the pre-QoS router.
TIER_LOAD_WEIGHT = {"latency": 2, "standard": 1, "batch": 1}


def normalize_tier(value) -> str:
    """Map a request's priority string onto a known tier (unknown /
    empty -> standard, so the field is optional everywhere)."""
    v = str(value or "").strip().lower()
    return v if v in TIER_RANK else DEFAULT_TIER


def request_tier(req) -> str:
    return normalize_tier(getattr(req, "priority", ""))


def tier_id(tier_or_req) -> int:
    """Compact tier tag for fixed-width records (the flight recorder's
    beat/event rows store tiers as uint8): the tier's index into
    TIERS. Accepts a tier string or a request object."""
    tier = (tier_or_req if isinstance(tier_or_req, str)
            else request_tier(tier_or_req))
    return TIER_RANK.get(normalize_tier(tier), TIER_RANK[DEFAULT_TIER])


class TierScheduler:
    """Weighted-fair admission order for the engine's waiting queue.

    Service accounting is in ESTIMATED tokens (prompt + max_new) charged
    at admission: the scheduler cannot know acceptance/eos ahead of
    time, and an estimate charged consistently to every tier keeps the
    ratios honest. Per-tenant accounting breaks ties inside a tier so
    one tenant's flood cannot starve its tier-mates.

    Idle tiers earn NO credit (start-time fair queuing): a tier that
    arrives after being idle is floored to the scheduler's virtual time
    (the busiest tier's normalized service), so an hour of latency-only
    traffic does not buy a later batch flood an hour of strict
    priority. The floor is applied only on the idle -> backlogged
    transition; deficits earned while continuously backlogged are kept,
    which is what guarantees batch its weighted share under sustained
    latency pressure.

    Scheduler-thread-only (the engine calls in while holding its
    waiting lock); no locking of its own.
    """

    # Bound the per-tenant map: past this, the least-served half is
    # dropped (they re-enter at 0, i.e. gain priority — the safe
    # direction for an accounting reset).
    MAX_TENANTS = 4096
    # pick() scans at most this many queue entries: weighted fairness
    # applies within the head window and requests beyond it enter the
    # window in FIFO order, so one pop is O(window) no matter how deep
    # an unbounded (edge-shedding off) queue grows.
    PICK_WINDOW = 512

    def __init__(self, weights: Optional[Dict[str, int]] = None):
        base = {"latency": 8, "standard": 4, "batch": 1}
        if weights:
            base.update({normalize_tier(t): int(w)
                         for t, w in weights.items()})
        # A zero/negative weight would re-create the starvation the
        # scheduler exists to prevent; floor at 1.
        self.weights = {t: max(1, int(base.get(t, 1))) for t in TIERS}
        self.served = {t: 0.0 for t in TIERS}
        self.tenant_served: Dict[str, int] = {}
        # Virtual time: the max normalized service any tier has
        # reached; newly-backlogged tiers are floored to it.
        self.vtime = 0.0
        self._backlogged: frozenset = frozenset()

    def pick(self, waiting: Sequence) -> int:
        """Index (into `waiting`) of the next request to admit: the
        least-served-per-weight tier, then the least-served tenant
        within it, then arrival order."""
        by_tier: Dict[str, List[int]] = {}
        for i, req in enumerate(waiting):
            if i >= self.PICK_WINDOW:
                break
            by_tier.setdefault(request_tier(req), []).append(i)
        present = frozenset(by_tier)
        for t in present - self._backlogged:  # graftlint: ignore[GL703] order-independent: each tier's credit is reset in isolation, so set iteration order cannot change any pick
            # Idle -> backlogged: no credit for the idle period.
            self.served[t] = max(self.served[t],
                                 self.vtime * self.weights[t])
        self._backlogged = present
        tier = min(by_tier, key=lambda t: (self.served[t] / self.weights[t],
                                           TIER_RANK[t]))
        return min(by_tier[tier],
                   key=lambda i: (self.tenant_served.get(
                       str(getattr(waiting[i], "tenant_id", "") or ""), 0),
                       i))

    # Runs under the engine's waiting lock on the scheduler thread.
    # graftlint: hot-path
    def note_admitted(self, req) -> None:
        """Charge one admission's estimated tokens to its tier+tenant."""
        est = max(1, len(getattr(req, "prompt_ids", []) or [])
                  + int(getattr(req, "max_new_tokens", 1) or 1))
        tier = request_tier(req)
        self.served[tier] += est
        self.vtime = max(self.vtime, self.served[tier] / self.weights[tier])
        tenant = str(getattr(req, "tenant_id", "") or "")
        self.tenant_served[tenant] = self.tenant_served.get(tenant, 0) + est
        if len(self.tenant_served) > self.MAX_TENANTS:
            keep = sorted(self.tenant_served.items(),
                          key=lambda kv: -kv[1])[: self.MAX_TENANTS // 2]
            self.tenant_served = dict(keep)


class EdgeAdmission:
    """Per-tier in-flight bounds at the HTTP edge: past the bound,
    shed with 429 + Retry-After instead of queueing on the engine.

    Always constructed (the /metrics keys must exist — 0, never absent
    — whether shedding is configured or not); `enabled=False` admits
    everything while still tracking per-tier depth."""

    def __init__(self, bounds: Optional[Dict[str, int]] = None,
                 retry_after_s: float = 1.0, enabled: bool = False):
        bounds = bounds or {}
        self.enabled = enabled
        self.retry_after_s = max(0.0, float(retry_after_s))
        # 0 = unbounded for that tier.
        self.bounds = {t: max(0, int(bounds.get(t, 0))) for t in TIERS}
        self._lock = threading.Lock()
        self._depth = {t: 0 for t in TIERS}
        self._shed = {t: 0 for t in TIERS}

    # Runs on every server request thread before engine submit.
    # graftlint: hot-path
    def try_admit(self, tier: str) -> Optional[float]:
        """None = admitted (caller MUST release()); a float = shed,
        the Retry-After hint in seconds."""
        tier = normalize_tier(tier)
        with self._lock:
            bound = self.bounds[tier]
            if self.enabled and bound > 0 and self._depth[tier] >= bound:
                self._shed[tier] += 1
                return self.retry_after_s
            self._depth[tier] += 1
            return None

    def release(self, tier: str) -> None:
        tier = normalize_tier(tier)
        with self._lock:
            self._depth[tier] = max(0, self._depth[tier] - 1)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = {
                f"qos_shed_{t}": self._shed[t] for t in TIERS}
            out["qos_shed_total"] = sum(self._shed.values())
            out["qos_edge_depth"] = dict(self._depth)
            return out


# -- trace harness ---------------------------------------------------------


@dataclasses.dataclass
class TraceRequest:
    """One arrival in a replayable multi-tenant trace."""

    t: float  # arrival offset from trace start, seconds
    tenant: str
    tier: str
    prompt_len: int
    max_new_tokens: int


def _bounded_pareto(rng, alpha: float, lo: int, hi: int) -> int:
    """Heavy-tailed int in [lo, hi] (Pareto body, hard cap — real
    prompt/output length distributions are heavy-tailed but the engine
    has hard context bounds)."""
    return int(min(hi, lo * (1.0 - rng.random()) ** (-1.0 / alpha)))


def bursty_trace(seed: int = 0, horizon_s: float = 6.0,
                 latency_rps: float = 3.0, burst_every_s: float = 1.5,
                 burst_size: int = 3, batch_requests: int = 16,
                 batch_prompt: tuple = (1.4, 48, 220),
                 batch_out: tuple = (1.6, 16, 48),
                 latency_prompt: tuple = (1.8, 6, 24),
                 latency_out: tuple = (1.8, 4, 12)) -> List[TraceRequest]:
    """The canned bursty multi-tenant trace: one batch-tier tenant
    floods `batch_requests` heavy-tailed long jobs at t=0 (the
    production failure shape — a single tenant's long-prompt dump),
    while two latency-tier tenants arrive as a Poisson process with
    periodic bursts on top. Seeded and fully replayable: the same seed
    yields the same arrivals, lengths and budgets.

    The (alpha, lo, hi) triples parameterize bounded-Pareto prompt /
    output lengths per tier."""
    import random

    rng = random.Random(seed)
    trace: List[TraceRequest] = []
    for i in range(batch_requests):
        trace.append(TraceRequest(
            t=rng.random() * 0.2, tenant="tenant-flood", tier="batch",
            prompt_len=_bounded_pareto(rng, *batch_prompt),
            max_new_tokens=_bounded_pareto(rng, *batch_out)))
    t = 0.0
    while True:
        t += rng.expovariate(latency_rps)
        if t >= horizon_s:
            break
        trace.append(TraceRequest(
            t=t, tenant=rng.choice(("tenant-chat-a", "tenant-chat-b")),
            tier="latency",
            prompt_len=_bounded_pareto(rng, *latency_prompt),
            max_new_tokens=_bounded_pareto(rng, *latency_out)))
    b = burst_every_s
    while b < horizon_s:
        for _ in range(burst_size):
            trace.append(TraceRequest(
                t=b + rng.random() * 0.05, tenant="tenant-chat-a",
                tier="latency",
                prompt_len=_bounded_pareto(rng, *latency_prompt),
                max_new_tokens=_bounded_pareto(rng, *latency_out)))
        b += burst_every_s
    trace.sort(key=lambda r: r.t)
    return trace


def run_trace_on_engine(engine, trace: Sequence[TraceRequest],
                        edge: Optional[EdgeAdmission] = None,
                        time_scale: float = 1.0, vocab: int = 250,
                        seed: int = 0,
                        timeout_s: float = 300.0) -> List[Dict]:
    """Replay a trace against an engine-shaped object (`submit()` +
    GenRequest streams): arrivals on schedule (scaled by time_scale),
    one collector thread per request. With an EdgeAdmission, requests
    past their tier bound are shed at submit time (the server-side 429,
    minus the HTTP hop). Returns one result dict per trace item:
    {tier, tenant, shed, error, ttft_s, gap_p95_s, wall_s, tokens}."""
    import random

    from generativeaiexamples_tpu_torch.serving.engine import GenRequest

    rng = random.Random(seed ^ 0x5EED)
    results: List[Dict] = [None] * len(trace)  # type: ignore[list-item]
    threads: List[threading.Thread] = []

    def collect(idx: int, item: TraceRequest, req: GenRequest,
                t_submit: float) -> None:
        times: List[float] = []
        error = False
        while True:
            try:
                ev = req.stream.get(timeout=timeout_s)
            except Exception:
                error = True
                break
            if ev.get("token_id", -1) >= 0:
                times.append(time.perf_counter())
            if ev.get("finished"):
                error = ev.get("finish_reason") == "error"
                break
        gaps = sorted(b - a for a, b in zip(times, times[1:]))
        results[idx] = {
            "tier": item.tier, "tenant": item.tenant, "shed": False,
            "error": error,
            "ttft_s": (times[0] - t_submit) if times else None,
            "gap_p95_s": (gaps[int(0.95 * (len(gaps) - 1))]
                          if gaps else 0.0),
            "wall_s": ((times[-1] if times else time.perf_counter())
                       - t_submit),
            "tokens": len(times),
        }

    t0 = time.perf_counter()
    for idx, item in enumerate(trace):
        delay = item.t * time_scale - (time.perf_counter() - t0)
        if delay > 0:
            time.sleep(delay)
        if edge is not None and edge.try_admit(item.tier) is not None:
            results[idx] = {"tier": item.tier, "tenant": item.tenant,
                            "shed": True, "error": False, "ttft_s": None,
                            "gap_p95_s": None, "wall_s": 0.0, "tokens": 0}
            continue
        req = GenRequest(
            prompt_ids=[rng.randrange(1, vocab)
                        for _ in range(item.prompt_len)],
            max_new_tokens=item.max_new_tokens,
            priority=item.tier, tenant_id=item.tenant,
            session_id=item.tenant)
        t_submit = time.perf_counter()
        try:
            engine.submit(req)
        except Exception:
            if edge is not None:
                edge.release(item.tier)
            results[idx] = {"tier": item.tier, "tenant": item.tenant,
                            "shed": False, "error": True, "ttft_s": None,
                            "gap_p95_s": None, "wall_s": 0.0, "tokens": 0}
            continue
        th = threading.Thread(target=collect,
                              args=(idx, item, req, t_submit), daemon=True)
        th.start()
        if edge is not None:
            orig = th
            # release the edge slot when the stream closes

            def done(t=orig, tier=item.tier):
                t.join()
                edge.release(tier)

            threads.append(threading.Thread(target=done, daemon=True))
            threads[-1].start()
        else:
            threads.append(th)
    for th in threads:
        th.join(timeout=timeout_s)
    return [r for r in results if r is not None]


def goodput(results: Sequence[Dict],
            slos: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """Per-tier goodput under SLO: the fraction of OFFERED requests in
    each tier that met every target in slos[tier] (keys: ttft_s,
    gap_p95_s, wall_s — absent keys don't constrain). Shed and errored
    requests count against goodput — a 429 is honest, but it is not a
    served request."""
    by_tier: Dict[str, List[Dict]] = {}
    for r in results:
        by_tier.setdefault(r["tier"], []).append(r)
    out: Dict[str, float] = {}
    for tier, rows in by_tier.items():
        slo = slos.get(tier, {})
        good = 0
        for r in rows:
            if r["shed"] or r["error"] or r["ttft_s"] is None:
                continue
            if "ttft_s" in slo and r["ttft_s"] > slo["ttft_s"]:
                continue
            if "gap_p95_s" in slo and (r["gap_p95_s"] or 0.0) \
                    > slo["gap_p95_s"]:
                continue
            if "wall_s" in slo and r["wall_s"] > slo["wall_s"]:
                continue
            good += 1
        out[tier] = good / len(rows) if rows else 0.0
    return out
