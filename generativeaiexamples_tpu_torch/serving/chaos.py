"""Chaos harness: seeded fault injection for the serving fleet.

The port's own copy of generativeaiexamples_tpu/serving/chaos.py, pick
for pick (the same seeded `random.Random`). It injects production failure
shapes into a live fleet on a schedule, deterministically (seeded picks,
fixed event times), so a trace replay (serving/qos.py
run_trace_on_engine) measures what survives a replica kill, a probe
blackhole, a slow replica and submit-time faults.

Injector kinds (ChaosEvent.kind):

- ``kill``: stop the replica's engine under the fleet (a crashed
  process). The health probe needs `health_fail_threshold` consecutive
  failures to evict; then requests not yet started requeue to survivors
  (tier, tenant and session kept) and mid-stream ones end with an error.
- ``blackhole``: the replica's health probe answers dead for
  `duration_s` while it keeps serving (a partitioned probe path).
  Shorter than K probe periods it must NOT evict.
- ``slow``: `magnitude` extra seconds at every scheduler iteration
  (engine.chaos_beat_delay_s): sick but alive.
- ``submit_error``: the replica's submit raises for `duration_s`; the
  fleet must unwind its tracking and surface the error, leaking no
  record.

Every injection is counted (ChaosStats: the always-present
chaos_injected_* keys of /metrics, live once attached) and recorded in
the monkey's own flight lane ("chaos" on /debug/timeline).

Threads: `run_schedule` starts ONE injector thread that owns every
mutation and the flight ring; `wait` joins it and undoes what is left.
Every injection but kill is reversible.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from typing import Dict, List, Optional, Sequence

from generativeaiexamples_tpu_torch.serving.fleet import (
    CHAOS_KEYS, EngineFleet)
from generativeaiexamples_tpu_torch.serving.flight import (
    EV_CHAOS, FlightRecorder)

_LOG = logging.getLogger(__name__)


class ChaosSubmitError(RuntimeError):
    """Injected submit-time fault (the ``submit_error`` injector)."""


class ChaosStats:
    """Injection counters with a snapshot, so the always-present counter
    contract covers them: the fleet surfaces these in /metrics while a
    monkey is attached."""

    def __init__(self):
        self._lock = threading.Lock()
        self.chaos_injected_kills = 0
        self.chaos_injected_blackholes = 0
        self.chaos_injected_slow_beats = 0
        self.chaos_injected_submit_errors = 0

    def note_kill(self) -> None:
        with self._lock:
            self.chaos_injected_kills += 1

    def note_blackhole(self) -> None:
        with self._lock:
            self.chaos_injected_blackholes += 1

    def note_slow(self) -> None:
        with self._lock:
            self.chaos_injected_slow_beats += 1

    def note_submit_error(self) -> None:
        with self._lock:
            self.chaos_injected_submit_errors += 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {k: getattr(self, k) for k in CHAOS_KEYS}


@dataclasses.dataclass
class ChaosEvent:
    """One scheduled injection. `t` is seconds from schedule start
    (scaled by the harness time_scale, like trace arrivals); empty
    `rid` picks a seeded random active local replica at fire time."""

    t: float
    kind: str  # kill | blackhole | slow | submit_error
    rid: str = ""
    duration_s: float = 0.0
    magnitude: float = 0.0  # slow: beat delay seconds

    def __post_init__(self):
        if self.kind not in ("kill", "blackhole", "slow", "submit_error"):
            raise ValueError(f"unknown chaos kind {self.kind!r}")


class ChaosMonkey:
    """Seeded fault injector bound to one fleet. Deterministic: the
    same seed + schedule fires the same faults at the same replicas."""

    def __init__(self, fleet: EngineFleet, seed: int = 0):
        self.fleet = fleet
        self.rng = random.Random(seed ^ 0xC4A05)
        self.stats = ChaosStats()
        self.flight = FlightRecorder(ring_size=64)
        fleet.extra_flight_lanes["chaos"] = self.flight
        fleet.attach_chaos(self.stats)
        # (undo_at_t, fn) for reversible injections, owned by the
        # injector thread; undo_all() drains leftovers after join.
        self._undos: List = []
        self._thread: Optional[threading.Thread] = None

    # -- target selection --------------------------------------------------

    def _pick(self, rid: str):
        # An explicit rid targets ANY replica type (blackhole /
        # submit_error work on remotes and test fakes too); the
        # seeded random pick stays local-and-active — kill/slow need
        # an in-process engine to reach.
        if rid:
            return self.fleet._by_rid.get(rid)
        cands = [r for r in self.fleet.local_replicas()
                 if r.state == "active"]
        return self.rng.choice(cands) if cands else None

    def _record(self, kind: str, rid: str) -> None:
        self.flight.record_event(EV_CHAOS, time.perf_counter(),
                                 aux=f"{kind}:{rid}")

    # -- injectors ---------------------------------------------------------

    def inject(self, ev: ChaosEvent, now: float = 0.0) -> Optional[str]:
        """Fire one event; returns the targeted rid (None = no
        target). Reversible injections queue their undo at
        now + duration_s."""
        replica = self._pick(ev.rid)
        if replica is None:
            _LOG.warning("chaos %s: no eligible replica", ev.kind)
            return None
        rid = replica.rid
        if ev.kind == "kill":
            _LOG.warning("chaos kill: stopping %s's engine", rid)
            try:
                replica.engine.stop()
            except Exception:
                _LOG.exception("chaos kill of %s raised", rid)
            self.stats.note_kill()
        elif ev.kind == "blackhole":
            orig = replica.healthy
            replica.healthy = lambda: False  # type: ignore[method-assign]
            self._undos.append((now + ev.duration_s,
                                lambda: setattr(replica, "healthy", orig)))
            self.stats.note_blackhole()
        elif ev.kind == "slow":
            replica.engine.chaos_beat_delay_s = float(ev.magnitude)
            self._undos.append(
                (now + ev.duration_s,
                 lambda: setattr(replica.engine, "chaos_beat_delay_s", 0.0)))
            self.stats.note_slow()
        elif ev.kind == "submit_error":
            orig_submit = replica.submit

            def bad_submit(req):
                raise ChaosSubmitError(
                    f"injected submit fault on {rid}")

            replica.submit = bad_submit  # type: ignore[method-assign]
            self._undos.append((now + ev.duration_s,
                                lambda: setattr(replica, "submit",
                                                orig_submit)))
            self.stats.note_submit_error()
        self._record(ev.kind, rid)
        return rid

    def _apply_due_undos(self, now: float) -> None:
        due = [u for u in self._undos if u[0] <= now]
        self._undos = [u for u in self._undos if u[0] > now]
        for _, fn in due:
            fn()

    def undo_all(self) -> None:
        """Restore every reversible injection (schedule teardown)."""
        undos, self._undos = self._undos, []
        for _, fn in undos:
            fn()

    # -- schedule runner ---------------------------------------------------

    def run_schedule(self, events: Sequence[ChaosEvent],
                     time_scale: float = 1.0) -> threading.Thread:
        """Fire `events` on their schedule (t scaled by time_scale,
        mirroring run_trace_on_engine) from a dedicated injector
        thread; returns the thread (join it, then call undo_all())."""
        ordered = sorted(events, key=lambda e: e.t)

        def loop():
            t0 = time.perf_counter()
            for ev in ordered:
                while True:
                    now = time.perf_counter() - t0
                    self._apply_due_undos(now)
                    delay = ev.t * time_scale - now
                    if delay <= 0:
                        break
                    time.sleep(min(delay, 0.01))
                self.inject(ev, now=time.perf_counter() - t0)
            # Sleep out the longest pending undo so transient faults
            # restore on schedule even after the last injection.
            while self._undos:
                now = time.perf_counter() - t0
                self._apply_due_undos(now)
                if self._undos:
                    time.sleep(0.01)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="chaos-monkey")
        self._thread.start()
        return self._thread

    def wait(self, timeout_s: float = 60.0) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            if self._thread.is_alive():
                _LOG.warning("chaos thread still alive after join timeout")
                self.fleet.ops.note_stuck_join()
            self._thread = None
        self.undo_all()


def run_chaos_trace(fleet: EngineFleet, trace, events: Sequence[ChaosEvent],
                    monkey: Optional[ChaosMonkey] = None, edge=None,
                    time_scale: float = 1.0, seed: int = 0,
                    timeout_s: float = 300.0):
    """Replay a qos.bursty_trace-style trace against a fleet WHILE a
    chaos schedule fires. Returns (results, monkey): results in
    run_trace_on_engine's shape, the monkey carrying stats and the
    "chaos" flight lane. The undo-scaled
    clock matches the trace clock, so an event at t=1.0 lands mid-
    burst of an arrival at t=1.0."""
    from generativeaiexamples_tpu_torch.serving.qos import run_trace_on_engine

    monkey = monkey or ChaosMonkey(fleet, seed=seed)
    monkey.run_schedule(events, time_scale=time_scale)
    try:
        results = run_trace_on_engine(fleet, trace, edge=edge,
                                      time_scale=time_scale, seed=seed,
                                      timeout_s=timeout_s)
    finally:
        monkey.wait(timeout_s=timeout_s)
    return results, monkey


def classify(results: Sequence[Dict]) -> Dict[str, int]:
    """Outcome buckets for the chaos gates. "lost" = errored with ZERO
    tokens delivered — a request the fleet should have requeued or
    honestly rejected; the kill gate requires it to be 0.
    "midstream" = errored after tokens flowed — the unavoidable
    casualties of a real replica death (their KV died with it)."""
    out = {"completed": 0, "shed": 0, "midstream": 0, "lost": 0}
    for r in results:
        if r["shed"]:
            out["shed"] += 1
        elif not r["error"]:
            out["completed"] += 1
        elif r["tokens"] > 0:
            out["midstream"] += 1
        else:
            out["lost"] += 1
    return out
