"""SLO-guarded fleet autoscaler: the elastic control loop over an
EngineFleet.

The port's own copy of generativeaiexamples_tpu/serving/autoscaler.py,
decision for decision. A background controller polls the fleet's cheap
load signals (the router's per-replica, per-tier in-flight depths,
weighted as placement weighs them: serving/qos.py TIER_LOAD_WEIGHT) and
drives the fleet's own topology verbs:

- **scale up**: pressure above `up_depth` weighted requests per active
  replica for `up_ticks` consecutive polls first WAKES a warm spare
  (`fleet.restore`: its engine is started and warmed), then falls back
  to SPAWNING one (bounded by `max_replicas`): `engine_factory` builds an
  in-process engine (on the card, over the served weight tree) wrapped
  in a LocalReplica, or `replica_factory` launches an engine-server
  process (fleet.spawn_process_replica).
- **scale down**: pressure below `down_depth` for `down_ticks` polls
  drains the least-loaded active replica into the warm pool
  (`fleet.park`, engine kept running); beyond the `warm_pool` target it
  parks COLD (engine stopped).
- **scale to zero**: with `scale_to_zero` and a fully idle signal even
  the last active replica parks; demand wakes the fleet through
  `wake_for_submit` (EngineFleet.submit calls it instead of failing).
- **latency signals**: the last poll window's latency-tier queue-wait
  p95 and TTFT p95 (deltas of the engines' histograms) past
  `up_queue_wait_p95_ms` / `up_ttft_p95_ms` count as up-pressure,
  attributed to the role pool (prefill / decode) that was worst.

Thrash control is structural: consecutive-poll counters that any
crossing resets, and a shared `cooldown_s` after every action.
`tick(now=...)` is a pure decision step over an injectable clock and
signal, so the hysteresis is testable without threads or engines.

Every decision lands in the controller's own flight-recorder lane
("autoscaler" in fleet.extra_flight_lanes; this thread is its only
writer) and in the always-present `autoscale_ups` / `downs` / `wakes`
counters (fleet.FleetOps).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from generativeaiexamples_tpu_torch.serving.flight import (
    EV_SCALE_DOWN, EV_SCALE_UP, EV_SCALE_WAKE, FlightRecorder,
    merge_hist_snapshots)
from generativeaiexamples_tpu_torch.serving.fleet import LocalReplica
from generativeaiexamples_tpu_torch.serving.qos import TIER_LOAD_WEIGHT

_LOG = logging.getLogger(__name__)

# Replica states the scaler may wake (restore) for demand, in
# preference order: a warm spare restores instantly (engine already
# running + warmed), a cold-parked one pays an engine restart.
# Deliberately NOT included: "drained" (an operator drain or a
# rolling upgrade owns that replica — restoring it would restart an
# engine the upgrade path just joined), "draining", "evicted".
_WAKEABLE = ("warm", "parked")


class FleetAutoscaler:
    """Elastic controller for an EngineFleet (attaches itself).

    `signal_fn` (tests): overrides the pressure probe; must return
    (weighted_depth_total, active_replica_count).
    """

    def __init__(self, fleet, engine_factory: Optional[Callable] = None,
                 replica_factory: Optional[Callable] = None,
                 min_replicas: int = 1, max_replicas: int = 4,
                 warm_pool: int = 1, interval_s: float = 2.0,
                 up_depth: float = 8.0, down_depth: float = 1.0,
                 up_ticks: int = 2, down_ticks: int = 5,
                 cooldown_s: float = 20.0, scale_to_zero: bool = False,
                 drain_timeout_s: float = 30.0,
                 signal_fn: Optional[Callable] = None,
                 up_queue_wait_p95_ms: float = 0.0,
                 up_ttft_p95_ms: float = 0.0,
                 hist_fn: Optional[Callable] = None):
        self.fleet = fleet
        self.engine_factory = engine_factory
        # Process-per-replica spawn lane: a callable
        # (rid, role) -> started, ready replica (fleet.py
        # spawn_process_replica). When set it REPLACES the
        # engine_factory lane — scale-up launches a subprocess per
        # replica instead of building an in-process engine.
        self.replica_factory = replica_factory
        self.min_replicas = max(0, int(min_replicas))
        self.max_replicas = max(1, int(max_replicas))
        self.warm_pool = max(0, int(warm_pool))
        self.interval_s = max(0.05, float(interval_s))
        self.up_depth = float(up_depth)
        self.down_depth = float(down_depth)
        self.up_ticks = max(1, int(up_ticks))
        self.down_ticks = max(1, int(down_ticks))
        self.cooldown_s = max(0.0, float(cooldown_s))
        self.scale_to_zero = bool(scale_to_zero)
        self.drain_timeout_s = float(drain_timeout_s)
        self._signal_fn = signal_fn
        # Latency-histogram scale-up signals: per-poll DELTA p95 of
        # latency-tier queue wait / TTFT across active local replicas,
        # role-attributed so the prefill and decode pools scale
        # independently under disagg.
        # 0 disables each (depth only).
        self.up_queue_wait_p95_ms = float(up_queue_wait_p95_ms)
        self.up_ttft_p95_ms = float(up_ttft_p95_ms)
        # hist_fn (tests): -> [(rid, role, {"queue_wait": snap,
        # "ttft": snap})] replacing the live engine-histogram reads.
        self._hist_fn = hist_fn
        # (rid, key) -> last cumulative snapshot (tick thread only).
        self._prev_hists: Dict = {}
        # Role pool behind the latest up-pressure ("" = none/any) and
        # the last observed delta p95s, for health() and the hot-role
        # spare/spawn preference. Written under _lock.
        self._hot_role = ""
        self._last_delta_p95: Dict[str, Optional[float]] = {
            "queue_wait": None, "ttft": None}
        # Decision state (all under _lock; wake_for_submit races tick).
        self._lock = threading.Lock()
        self._above = 0
        self._below = 0
        self._last_action_t = float("-inf")
        self._spawned = 0
        self._last_decision = "init"
        # Wake notes from submit threads, drained into the flight lane
        # by the NEXT tick so the recorder stays single-writer (the
        # router-report deque idiom: append is thread-safe, the tick
        # thread is the only consumer).
        self._pending_wakes: deque = deque()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.flight = FlightRecorder(ring_size=64)
        fleet.extra_flight_lanes["autoscaler"] = self.flight
        fleet.attach_autoscaler(self)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetAutoscaler":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._ensure_warm_pool()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fleet-autoscaler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            if self._thread.is_alive():
                # Same contract as engine/fleet stop: counted, never
                # silently dropped.
                _LOG.warning("autoscaler thread still alive after "
                             "join timeout")
                self.fleet.ops.note_stuck_join()
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                # Never silent: a sick control loop must show
                # up in the log, and must not die of one bad poll.
                _LOG.exception("autoscaler tick failed")

    # -- signal ------------------------------------------------------------

    def _signal(self):
        """(tier-weighted in-flight depth across active replicas,
        active replica count). Cheap: one router lock, no engine or
        HTTP touches."""
        if self._signal_fn is not None:
            return self._signal_fn()
        depths = self.fleet.router.tier_queue_depths()
        active = [r for r in self.fleet.replicas if r.state == "active"]
        total = 0.0
        for r in active:
            for tier, n in depths.get(r.rid, {}).items():
                total += n * TIER_LOAD_WEIGHT.get(tier, 1)
        return total, len(active)

    def _role_pressures(self) -> Dict[str, float]:
        """Tier-weighted depth PER ACTIVE REPLICA for each role pool —
        the role-aware view of _signal (disagg: a drowning prefill
        pool must not be masked by idle decode replicas averaging the
        fleet-wide pressure down)."""
        depths = self.fleet.router.tier_queue_depths()
        totals: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        for r in self.fleet.replicas:
            if r.state != "active":
                continue
            role = getattr(r, "role", "mixed")
            counts[role] = counts.get(role, 0) + 1
            for tier, n in depths.get(r.rid, {}).items():
                totals[role] = totals.get(role, 0.0) \
                    + n * TIER_LOAD_WEIGHT.get(tier, 1)
        return {role: totals.get(role, 0.0) / max(1, counts[role])
                for role in counts}

    # -- latency-histogram signal ------------------------------------------

    def _hist_snapshots(self):
        """[(rid, role, {"queue_wait": snap, "ttft": snap})] for every
        active LOCAL replica (remote replicas' histograms ride their
        own autoscalers). Cheap: single-writer histogram copies, no
        HTTP."""
        if self._hist_fn is not None:
            return self._hist_fn()
        out = []
        for r in self.fleet.replicas:
            if r.state != "active" or not isinstance(r, LocalReplica):
                continue
            hists = r.engine.metrics.hists
            out.append((r.rid, getattr(r, "role", "mixed"), {
                "queue_wait": hists["queue_wait_ms_latency"].snapshot(),
                "ttft": hists["ttft_ms"].snapshot()}))
        return out

    @staticmethod
    def _hist_delta(cur: Dict, prev: Optional[Dict]) -> Optional[Dict]:
        """Bucket-wise difference of two cumulative histogram
        snapshots — the per-poll window view. None on the first
        sighting (recording the baseline; old history must not fire
        the signal at attach time)."""
        if prev is None:
            return None
        pb = prev.get("buckets") or {}
        buckets = {}
        for k, v in (cur.get("buckets") or {}).items():
            d = int(v) - int(pb.get(k, 0))
            if d > 0:
                buckets[k] = d
        return {"count": max(0, int(cur.get("count") or 0)
                             - int(prev.get("count") or 0)),
                "sum": max(0.0, float(cur.get("sum") or 0.0)
                           - float(prev.get("sum") or 0.0)),
                "overflow": max(0, int(cur.get("overflow") or 0)
                                - int(prev.get("overflow") or 0)),
                "buckets": buckets}

    def _latency_pressure(self):
        """-> (hot, role): True when the last poll window's latency-
        tier queue-wait p95 (or TTFT p95) exceeds its threshold; role
        is the pool whose merged delta was worst (role-aware scale-up
        under disagg). Tick thread only (owns _prev_hists)."""
        if self.up_queue_wait_p95_ms <= 0 and self.up_ttft_p95_ms <= 0:
            return False, ""
        per_role: Dict[str, Dict[str, list]] = {}
        for rid, role, snaps in self._hist_snapshots():
            for key, cur in snaps.items():
                delta = self._hist_delta(cur,
                                         self._prev_hists.get((rid, key)))
                self._prev_hists[(rid, key)] = cur
                if delta is not None and delta["count"] > 0:
                    per_role.setdefault(role, {}).setdefault(
                        key, []).append(delta)
        hot, hot_role, worst = False, "", 0.0
        last: Dict[str, Optional[float]] = {"queue_wait": None,
                                            "ttft": None}
        for key, thresh in (("queue_wait", self.up_queue_wait_p95_ms),
                            ("ttft", self.up_ttft_p95_ms)):
            for role, by_key in per_role.items():
                if key not in by_key:
                    continue
                p95 = merge_hist_snapshots(by_key[key])["p95"]
                if p95 is None:
                    continue
                last[key] = max(last[key] or 0.0, p95)
                if thresh > 0 and p95 >= thresh and p95 > worst:
                    hot, hot_role, worst = True, role, p95
        with self._lock:
            self._last_delta_p95 = last
        return hot, hot_role

    # -- the decision step (unit-testable: injected clock + signal) --------

    def tick(self, now: Optional[float] = None) -> str:
        """One control-loop pass. Returns the decision taken
        ("up" | "down" | "hold"), for tests and logs.

        Takes the decision lock only around the counter math — the
        actions themselves run unlocked, because a scale-down drains
        (blocking up to drain_timeout_s) and a spawn builds an
        engine, and both wake_for_submit (the submit hot path) and
        health() (/health) need the same lock meanwhile."""
        now = time.monotonic() if now is None else now
        self._drain_wake_notes()
        total, active = self._signal()
        pressure = total / max(1, active)
        # Second scale-up signal: latency-histogram drift over the
        # last poll window (0-thresholds keep it inert). Role-aware:
        # the hot role steers which spare wakes / what role a spawn
        # gets, so prefill and decode pools scale independently.
        lat_hot, lat_role = self._latency_pressure()
        hot_role = lat_role
        if not hot_role and active > 0:
            roles = self._role_pressures()
            if len(roles) > 1:
                worst = max(roles, key=lambda k: roles[k])
                if roles[worst] >= self.up_depth:
                    hot_role = worst
        with self._lock:
            self._hot_role = hot_role
            # A single drowning role pool (hot_role from depth) counts
            # as up-pressure even when idle pools average the fleet-
            # wide signal below the threshold.
            if active > 0 and (pressure >= self.up_depth or lat_hot
                               or bool(hot_role)):
                self._above += 1
                self._below = 0
            elif total == 0 or pressure <= self.down_depth:
                self._below += 1
                self._above = 0
            else:
                # Mid-band: hysteresis demands CONSECUTIVE evidence.
                self._above = 0
                self._below = 0
            # A fully parked fleet under any demand at all must wake
            # even though pressure/active is degenerate.
            wants_up = (self._above >= self.up_ticks
                        or (active == 0 and total > 0))
            in_cooldown = now - self._last_action_t < self.cooldown_s
            action = "hold"
            if wants_up and not in_cooldown:
                action = "up"
            elif (self._below >= self.down_ticks and not in_cooldown
                  and active > self._floor(total)):
                action = "down"
        decision = "hold"
        if action == "up" and self._scale_up(now, active):
            decision = "up"
        elif action == "down" and self._scale_down(now, active):
            decision = "down"
        with self._lock:
            self._last_decision = decision
        return decision

    def _floor(self, total_depth: float) -> int:
        """Minimum admitting replicas right now: min_replicas, except
        a fully idle fleet with scale_to_zero may park everything
        (demand wakes it via wake_for_submit)."""
        if self.scale_to_zero and total_depth == 0:
            return 0
        return max(1, self.min_replicas)

    # -- actions (tick thread; take the lock only for fast state) ----------

    def _pick_spare(self):
        """Best wakeable spare: warm (instant) before cold-parked
        (engine restart), preferring a spare whose role matches the
        hot pool (mixed spares serve any pool). Caller holds the
        lock."""
        cands = [r for r in self.fleet.replicas if r.state in _WAKEABLE]
        if not cands:
            return None
        hot = self._hot_role

        def role_rank(r) -> int:
            role = getattr(r, "role", "mixed")
            if not hot or role == hot:
                return 0
            return 1 if role == "mixed" else 2

        return min(cands, key=lambda r: (role_rank(r),
                                         _WAKEABLE.index(r.state), r.rid))

    def _scale_up(self, now: float, active: int) -> bool:
        """Wake a warm spare (fast — pick + restore under the lock,
        so a racing wake_for_submit cannot grab the same one) or
        spawn a replica (slow — the engine build runs unlocked)."""
        with self._lock:
            cand = self._pick_spare()
            if cand is not None:
                self.fleet.restore(cand.rid)
                rid = cand.rid
            elif ((self.engine_factory is not None
                   or self.replica_factory is not None)
                  and len(self.fleet.replicas) < self.max_replicas):
                rid = None
            else:
                return False
            # Reserve the action window up front: even a spawn that
            # fails consumed this cooldown (no hot-looping a broken
            # factory).
            self._above = 0
            self._last_action_t = now
        if rid is None:
            rid = self._spawn(admitting=True)
            if rid is None:
                return False
        self.fleet.ops.note_scale_up()
        self.flight.record_event(EV_SCALE_UP, time.perf_counter(),
                                 aux=rid, a=float(active + 1))
        _LOG.info("autoscale up: %s (active %d -> %d)", rid, active,
                  active + 1)
        return True

    def _scale_down(self, now: float, active: int) -> bool:
        """Drain the least-loaded active replica into the warm pool
        (cold past the pool target). The drain blocks up to
        drain_timeout_s and runs UNLOCKED — the victim leaves the
        wakeable states the moment park() starts draining it, so a
        racing wake cannot pick it, and health()/wake_for_submit stay
        responsive throughout."""
        with self._lock:
            depths = self.fleet.router.queue_depths()
            actives = [r for r in self.fleet.replicas
                       if r.state == "active"]
            if not actives:
                return False
            # Role-aware: never drain the LAST active replica of a
            # role pool while another pool keeps multiple (disagg must
            # not lose its only prefill — or only decode — replica to
            # a fleet-wide idle signal).
            by_role: Dict[str, int] = {}
            for r in actives:
                role = getattr(r, "role", "mixed")
                by_role[role] = by_role.get(role, 0) + 1
            cands = [r for r in actives
                     if len(by_role) <= 1
                     or by_role[getattr(r, "role", "mixed")] > 1]
            victim = min(cands or actives,
                         key=lambda r: (depths.get(r.rid, 0), r.rid))
            cold = sum(1 for r in self.fleet.replicas
                       if r.state == "warm") >= self.warm_pool
            # Reserve the window before the blocking drain (a failed
            # park consumed its shot; retry after cooldown).
            self._below = 0
            self._last_action_t = now
        if not self.fleet.park(victim.rid, timeout_s=self.drain_timeout_s,
                               cold=cold):
            return False  # drain didn't empty: replica was re-admitted
        self.fleet.ops.note_scale_down()
        self.flight.record_event(EV_SCALE_DOWN, time.perf_counter(),
                                 aux=victim.rid, a=float(active - 1),
                                 b=1.0 if cold else 0.0)
        _LOG.info("autoscale down: parked %s %s (active %d -> %d)",
                  victim.rid, "cold" if cold else "warm", active,
                  active - 1)
        return True

    def _spawn(self, admitting: bool) -> Optional[str]:
        """Build + register a fresh replica. Runs on the controller
        thread OUTSIDE the decision lock — spawning is the slow
        scale-up lane, waking the warm pool the fast one. Two lanes:
        replica_factory launches a process-per-replica worker
        (subprocess + readiness probe, already started when it
        returns); engine_factory builds an in-process engine wrapped
        in a LocalReplica."""
        with self._lock:
            self._spawned += 1
            rid = f"as{self._spawned}"
            role = self._hot_role or "mixed"
        if self.replica_factory is not None:
            try:
                replica = self.replica_factory(rid, role)
            except Exception:
                # Never silent: a dead spawn lane must show up,
                # and the reserved cooldown stops hot-looping it.
                _LOG.exception("autoscaler replica_factory failed")
                return None
            replica.role = role
        else:
            try:
                engine = self.engine_factory()
            except Exception:
                _LOG.exception("autoscaler engine_factory failed")
                return None
            replica = LocalReplica(rid, engine)
            replica.role = role  # joins the hot pool (disagg roles)
            replica.start()
        self.fleet.add_replica(replica, admitting=admitting)
        return rid

    def _ensure_warm_pool(self) -> None:
        """Pre-warm the configured pool at start(): spawn parked-warm
        replicas until `warm_pool` non-active spares exist (needs a
        spawn lane and max_replicas headroom)."""
        if self.engine_factory is None and self.replica_factory is None:
            return
        while True:
            with self._lock:
                spares = sum(1 for r in self.fleet.replicas
                             if r.state == "warm")
                if (spares >= self.warm_pool
                        or len(self.fleet.replicas) >= self.max_replicas):
                    return
            if self._spawn(admitting=False) is None:
                return

    # -- demand wake (server request threads) ------------------------------

    def wake_for_submit(self) -> bool:
        """Called by EngineFleet.submit when NO replica admits: restore
        one parked/warm replica for the demand that just arrived.
        Bypasses cooldown — refusing demand to honor a timer would be
        scale-to-zero without the wake half. Returns True when a
        replica was restored (the caller retries placement once)."""
        with self._lock:
            cand = self._pick_spare()
            if cand is None:
                return False
            self.fleet.restore(cand.rid)
            self._last_action_t = time.monotonic()
            self.fleet.ops.note_wake()
            # Flight events are recorded by the tick thread only (the
            # ring is single-writer); queue the note.
            self._pending_wakes.append((time.perf_counter(), cand.rid))
        _LOG.info("autoscale wake: %s restored for demand", cand.rid)
        return True

    def _drain_wake_notes(self) -> None:
        while self._pending_wakes:
            ts, rid = self._pending_wakes.popleft()
            self.flight.record_event(EV_SCALE_WAKE, ts, aux=rid, a=1.0)

    # -- surfaces ----------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        """fleet_health()'s "autoscale" subsection."""
        states: Dict[str, int] = {}
        for r in self.fleet.replicas:
            states[r.state] = states.get(r.state, 0) + 1
        with self._lock:
            return {"enabled": True,
                    "running": (self._thread is not None
                                and self._thread.is_alive()),
                    "replica_states": states,
                    "min_replicas": self.min_replicas,
                    "max_replicas": self.max_replicas,
                    "warm_pool": self.warm_pool,
                    "scale_to_zero": self.scale_to_zero,
                    "last_decision": self._last_decision,
                    "spawned": self._spawned,
                    # Latency-histogram signal (0-thresholds = off)
                    # and the role pool behind the latest pressure.
                    "latency_signal": {
                        "up_queue_wait_p95_ms": self.up_queue_wait_p95_ms,
                        "up_ttft_p95_ms": self.up_ttft_p95_ms,
                        "last_delta_p95": dict(self._last_delta_p95),
                    },
                    "hot_role": self._hot_role}
