"""Port parity: the elastic autoscaler (serving/autoscaler.py).

The JAX package's tests/test_autoscaler.py cases (hysteresis, cooldown,
scale to zero and the demand wake, warm before cold, spawn and
`max_replicas`, the surfaces, the latency-histogram signal and its role
attribution) run on both packages' `FleetAutoscaler` over fake replicas,
each with an injected clock and signal: both must pass every case. A
parity case drives the two over the same fake fleets and one seeded
signal (depth and latency samples), tick by tick: the decisions, the
counters, the replica states, the flight lanes and `health()` are equal.
`build_fleet` wires the autoscaler from the [fleet] section with the
in-process spawn lane (`build_llm`'s engine_factory: engines over the
same weight tree) and the process lane (a monkeypatched
`spawn_process_replica`). End to end on the tiny f32 model: a burst
wakes the warm spare and spawns a third replica, idle parks replicas
down to `min_replicas`, and every stream equals the offline JAX greedy
oracle. No JAX `LLMEngine` is built.
"""

import random
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.serving import autoscaler as jas
from generativeaiexamples_tpu.serving import engine as jeng_mod
from generativeaiexamples_tpu.serving import fleet as jfleet
from generativeaiexamples_tpu.serving import flight as jflight
from generativeaiexamples_tpu.utils.tokenizer import ByteTokenizer as JTok
from generativeaiexamples_tpu_torch.config.schema import load_config
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.serving import autoscaler as tas
from generativeaiexamples_tpu_torch.serving import fleet as tfleet
from generativeaiexamples_tpu_torch.serving import flight as tflight
from generativeaiexamples_tpu_torch.serving.engine import (
    GenRequest, LLMEngine)
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

PS = 8
# (autoscaler module, fleet module, flight module, GenRequest, tokenizer)
IMPLS = {"jax": (jas, jfleet, jflight, jeng_mod.GenRequest, JTok),
         "port": (tas, tfleet, tflight, GenRequest, ByteTokenizer)}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


class FakeReplica:
    def __init__(self, rid):
        self.rid = rid
        self.state = "active"
        self.has_prefix_cache = False
        self.submitted = []
        self.alive = True
        self.started = 0
        self.stopped = 0

    def set_reporter(self, fn):
        pass

    def submit(self, req):
        self.submitted.append(req)

    def healthy(self):
        return self.alive

    def start(self):
        self.started += 1

    def stop(self):
        self.stopped += 1

    def warmup(self, **kw):
        pass

    def metrics_snapshot(self):
        return {}


class _Signal:
    """Injected (weighted total depth, active count); active from the
    fleet."""

    def __init__(self, fleet):
        self.fleet = fleet
        self.total = 0.0

    def __call__(self):
        active = sum(1 for r in self.fleet.replicas if r.state == "active")
        return self.total, active


def make(impl, n=2, **kw):
    scaler_mod, fleet_mod, _, _, tok = impl
    fleet = fleet_mod.EngineFleet([FakeReplica(f"r{i}") for i in range(n)],
                                  tok(), PS)
    sig = _Signal(fleet)
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("warm_pool", 1)
    kw.setdefault("up_depth", 8.0)
    kw.setdefault("down_depth", 1.0)
    kw.setdefault("up_ticks", 2)
    kw.setdefault("down_ticks", 3)
    kw.setdefault("cooldown_s", 10.0)
    scaler = scaler_mod.FleetAutoscaler(fleet, signal_fn=sig, **kw)
    return fleet, scaler, sig


# -- hysteresis ---------------------------------------------------------------


def test_oscillating_signal_never_flaps(impl):
    fleet, scaler, sig = make(impl)
    fleet.park("r1")
    t = 0.0
    for i in range(20):
        sig.total = 100.0 if i % 2 == 0 else 0.0
        assert scaler.tick(now=t) == "hold"
        t += 1.0
    snap = fleet.metrics.snapshot()
    assert snap["autoscale_ups"] == 0 and snap["autoscale_downs"] == 0


def test_mid_band_resets_both_counters(impl):
    fleet, scaler, sig = make(impl)
    fleet.park("r1")
    sig.total = 100.0
    assert scaler.tick(now=0.0) == "hold"
    sig.total = 4.0
    assert scaler.tick(now=1.0) == "hold"
    sig.total = 100.0
    assert scaler.tick(now=2.0) == "hold"
    assert scaler.tick(now=3.0) == "up"


def test_sustained_pressure_scales_up_once_then_cooldown(impl):
    fleet, scaler, sig = make(impl)
    fleet.park("r1")
    sig.total = 100.0
    assert scaler.tick(now=0.0) == "hold"
    assert scaler.tick(now=1.0) == "up"
    assert fleet._by_rid["r1"].state == "active"
    assert scaler.tick(now=2.0) == "hold"
    assert scaler.tick(now=3.0) == "hold"
    assert scaler.tick(now=12.0) == "hold"  # no spare, no spawn lane
    assert fleet.metrics.snapshot()["autoscale_ups"] == 1


def test_sustained_idle_scales_down_after_down_ticks(impl):
    fleet, scaler, sig = make(impl, n=3, cooldown_s=0.0)
    sig.total = 0.0
    for t in range(2):
        assert scaler.tick(now=float(t)) == "hold"
    assert scaler.tick(now=2.0) == "down"
    assert sorted(r.state for r in fleet.replicas) == \
        ["active", "active", "warm"]
    for t in range(3, 5):
        scaler.tick(now=float(t))
    assert scaler.tick(now=5.0) == "down"
    assert sorted(r.state for r in fleet.replicas) == \
        ["active", "parked", "warm"]
    parked = next(r for r in fleet.replicas if r.state == "parked")
    assert parked.stopped == 1


def test_min_replicas_floor_holds(impl):
    fleet, scaler, sig = make(impl, n=2, cooldown_s=0.0, down_ticks=1)
    sig.total = 0.5
    scaler.tick(now=0.0)
    assert sum(r.state == "active" for r in fleet.replicas) == 1
    for t in range(1, 6):
        assert scaler.tick(now=float(t)) == "hold"
    assert sum(r.state == "active" for r in fleet.replicas) == 1


# -- scale to zero and the demand wake ----------------------------------------


def test_fully_idle_fleet_parks_last_replica_and_wakes_on_demand(impl):
    gen_request, flight_mod = impl[3], impl[2]
    fleet, scaler, sig = make(impl, n=1, scale_to_zero=True, cooldown_s=0.0,
                              down_ticks=2)
    sig.total = 0.0
    scaler.tick(now=0.0)
    assert scaler.tick(now=1.0) == "down"
    assert all(r.state != "active" for r in fleet.replicas)
    req = gen_request(prompt_ids=[1] * 16, max_new_tokens=4)
    fleet.submit(req)
    assert fleet._by_rid["r0"].state == "active"
    assert fleet._by_rid["r0"].submitted == [req]
    assert fleet.metrics.snapshot()["autoscale_wakes"] == 1
    scaler.tick(now=2.0)
    evs = scaler.flight.snapshot_events()
    assert any(e["kind"] == flight_mod.EV_SCALE_WAKE for e in evs)


def test_parked_fleet_under_demand_wakes_via_tick_too(impl):
    fleet, scaler, sig = make(impl, n=1, scale_to_zero=True, cooldown_s=0.0)
    fleet.park("r0")
    sig.total = 1.0
    assert scaler.tick(now=0.0) == "up"
    assert fleet._by_rid["r0"].state == "active"


# -- spawn and the warm pool --------------------------------------------------


def test_scale_up_prefers_warm_over_spawn(impl):
    spawned = []
    fleet, scaler, sig = make(impl, engine_factory=lambda: spawned.append(1))
    fleet.park("r1")
    sig.total = 100.0
    scaler.tick(now=0.0)
    assert scaler.tick(now=1.0) == "up"
    assert fleet._by_rid["r1"].state == "active"
    assert not spawned


def test_scale_up_spawns_when_no_spare(impl, monkeypatch):
    fleet, scaler, sig = make(impl, n=1, cooldown_s=0.0,
                              engine_factory=lambda: object())
    monkeypatch.setattr(impl[0], "LocalReplica",
                        lambda rid, eng: FakeReplica(rid))
    sig.total = 100.0
    scaler.tick(now=0.0)
    assert scaler.tick(now=1.0) == "up"
    assert fleet._by_rid["as1"].state == "active"
    assert fleet._by_rid["as1"].started == 1
    assert len(fleet.replicas) == 2
    assert fleet.metrics.snapshot()["autoscale_ups"] == 1


def test_scale_up_without_spare_or_factory_holds(impl):
    fleet, scaler, sig = make(impl, n=1, engine_factory=None)
    sig.total = 100.0
    scaler.tick(now=0.0)
    assert scaler.tick(now=1.0) == "hold"
    assert fleet.metrics.snapshot()["autoscale_ups"] == 0


def test_max_replicas_caps_spawn(impl, monkeypatch):
    fleet, scaler, sig = make(impl, n=2, max_replicas=2, cooldown_s=0.0,
                              engine_factory=lambda: object())
    monkeypatch.setattr(impl[0], "LocalReplica",
                        lambda rid, eng: FakeReplica(rid))
    sig.total = 100.0
    scaler.tick(now=0.0)
    assert scaler.tick(now=1.0) == "hold"
    assert len(fleet.replicas) == 2


def test_failing_factory_is_logged_and_holds(impl, caplog):
    def broken():
        raise RuntimeError("no memory left")

    fleet, scaler, sig = make(impl, n=1, cooldown_s=0.0,
                              engine_factory=broken)
    sig.total = 100.0
    scaler.tick(now=0.0)
    assert scaler.tick(now=1.0) == "hold"
    assert "engine_factory failed" in caplog.text
    assert len(fleet.replicas) == 1


def test_warm_pool_is_prefilled_at_start(impl, monkeypatch):
    monkeypatch.setattr(impl[0], "LocalReplica",
                        lambda rid, eng: FakeReplica(rid))
    fleet, scaler, sig = make(impl, n=1, warm_pool=2, max_replicas=4,
                              engine_factory=lambda: object(),
                              interval_s=30.0)
    scaler.start()
    try:
        assert sorted(r.state for r in fleet.replicas) == \
            ["active", "warm", "warm"]
        assert [r.rid for r in fleet.replicas] == ["r0", "as1", "as2"]
    finally:
        scaler.stop()


# -- surfaces -----------------------------------------------------------------


def test_counters_always_present(impl):
    fleet, _, _ = make(impl)
    snap = fleet.metrics.snapshot()
    for k in impl[1].FLEET_OPS_KEYS + impl[1].CHAOS_KEYS + (
            "stuck_thread_joins",):
        assert snap[k] == 0, k


def test_flight_lane_and_health_section(impl):
    flight_mod = impl[2]
    fleet, scaler, sig = make(impl, cooldown_s=0.0)
    fleet.park("r1")
    sig.total = 100.0
    scaler.tick(now=0.0)
    scaler.tick(now=1.0)
    recs = fleet.flight_recorders()
    assert "autoscaler" in recs and "fleet" in recs
    evs = recs["autoscaler"].snapshot_events()
    assert [e["kind"] for e in evs] == [flight_mod.EV_SCALE_UP]
    assert evs[0]["aux"] == "r1"
    trace = flight_mod.chrome_trace(recs)
    insts = [e for e in trace["traceEvents"] if e.get("ph") == "i"]
    assert any(e["name"] == "scale_up" and e["cat"] == "fleet"
               for e in insts)
    health = fleet.fleet_health()
    assert health["autoscale"]["enabled"] is True
    assert health["autoscale"]["last_decision"] == "up"
    assert health["autoscale"]["replica_states"]["active"] == 2


def test_start_stop_lifecycle_joins_thread(impl):
    fleet, scaler, _ = make(impl, interval_s=0.05)
    scaler.start()
    assert scaler._thread.is_alive()
    scaler.stop()
    assert scaler._thread is None
    assert fleet.metrics.snapshot()["stuck_thread_joins"] == 0


def test_wake_for_submit_with_no_spare_is_false(impl):
    _, scaler, _ = make(impl, n=1)
    assert scaler.wake_for_submit() is False


def test_warm_spare_wakes_before_cold_parked(impl):
    fleet, scaler, sig = make(impl, n=3, cooldown_s=0.0)
    fleet.park("r0", cold=True)
    fleet.park("r1")
    sig.total = 100.0
    scaler.tick(now=0.0)
    assert scaler.tick(now=1.0) == "up"
    assert fleet._by_rid["r1"].state == "active"
    assert fleet._by_rid["r0"].state == "parked"


def test_drained_replica_is_not_wakeable(impl):
    fleet, scaler, sig = make(impl, n=2)
    fleet.drain("r0", timeout_s=1.0)
    fleet.drain("r1", timeout_s=1.0)
    assert scaler.wake_for_submit() is False
    sig.total = 100.0
    scaler.tick(now=0.0)
    assert scaler.tick(now=1.0) == "hold"
    assert all(r.state == "drained" for r in fleet.replicas)


def test_concurrent_wakes_restore_exactly_available_spares(impl):
    fleet, scaler, _ = make(impl, n=3, scale_to_zero=True)
    for r in list(fleet.replicas):
        fleet.park(r.rid)
    results = []
    threads = [threading.Thread(
        target=lambda: results.append(scaler.wake_for_submit()))
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert sum(results) == 3
    assert fleet.metrics.snapshot()["autoscale_wakes"] == 3
    assert all(r.state == "active" for r in fleet.replicas)


# -- the latency-histogram signal ---------------------------------------------


def _hist_snap(flight_mod, samples_ms):
    h = flight_mod.ExpHistogram()
    for v in samples_ms:
        h.observe(v)
    return h.snapshot()


def _make_hist(impl, hists, **kw):
    def hist_fn():
        return [(rid, role, {"queue_wait": _hist_snap(impl[2], qw),
                             "ttft": _hist_snap(impl[2], tt)})
                for rid, role, qw, tt in hists]

    kw.setdefault("cooldown_s", 0.0)
    kw.setdefault("up_ticks", 1)
    return make(impl, hist_fn=hist_fn, **kw)


def test_queue_wait_delta_p95_scales_up(impl):
    hists = [["r0", "mixed", [], []]]
    fleet, scaler, sig = _make_hist(impl, hists, up_queue_wait_p95_ms=100.0)
    fleet.park("r1")
    sig.total = 2.0
    hists[0][2].extend([500.0] * 10)
    assert scaler.tick(now=0.0) == "hold"  # the baseline
    assert scaler.tick(now=1.0) == "hold"  # no new samples
    hists[0][2].extend([400.0] * 10)
    assert scaler.tick(now=2.0) == "up"
    assert fleet._by_rid["r1"].state == "active"
    assert scaler.health()["latency_signal"]["last_delta_p95"][
        "queue_wait"] > 100.0


def test_ttft_delta_p95_scales_up(impl):
    hists = [["r0", "mixed", [], []]]
    fleet, scaler, sig = _make_hist(impl, hists, up_ttft_p95_ms=200.0)
    fleet.park("r1")
    sig.total = 2.0
    assert scaler.tick(now=0.0) == "hold"
    hists[0][3].extend([900.0] * 8)
    assert scaler.tick(now=1.0) == "up"


def test_fast_window_stays_quiet(impl):
    hists = [["r0", "mixed", [], []]]
    fleet, scaler, sig = _make_hist(impl, hists, up_queue_wait_p95_ms=100.0,
                                    up_ttft_p95_ms=100.0)
    fleet.park("r1")
    sig.total = 2.0
    assert scaler.tick(now=0.0) == "hold"
    hists[0][2].extend([5.0] * 50)
    hists[0][3].extend([8.0] * 50)
    assert scaler.tick(now=1.0) == "hold"
    assert fleet.metrics.snapshot()["autoscale_ups"] == 0


def test_signal_is_role_attributed(impl):
    hists = [["r0", "prefill", [], []], ["r1", "decode", [], []]]
    fleet, scaler, sig = _make_hist(impl, hists, n=4,
                                    up_queue_wait_p95_ms=100.0)
    fleet.set_replica_role("r0", "prefill")
    fleet.set_replica_role("r1", "decode")
    fleet.set_replica_role("r3", "prefill")
    fleet.park("r2")
    fleet.park("r3")
    sig.total = 2.0
    assert scaler.tick(now=0.0) == "hold"
    hists[0][2].extend([800.0] * 10)
    assert scaler.tick(now=1.0) == "up"
    assert fleet._by_rid["r3"].state == "active"
    assert fleet._by_rid["r2"].state != "active"
    assert scaler.health()["hot_role"] == "prefill"


def test_scale_down_keeps_last_replica_of_each_role(impl):
    fleet, scaler, sig = make(impl, n=3, cooldown_s=0.0, down_ticks=1)
    fleet.set_replica_role("r0", "prefill")
    fleet.set_replica_role("r1", "decode")
    fleet.set_replica_role("r2", "decode")
    sig.total = 0.0
    assert scaler.tick(now=0.0) == "down"
    assert fleet._by_rid["r0"].state == "active"
    assert sorted(fleet._by_rid[r].state for r in ("r1", "r2")) == \
        ["active", "warm"]


def test_live_histogram_reads_of_local_engines(impl):
    """Without hist_fn the scaler reads each active local replica's
    engine histograms (queue_wait_ms_latency, ttft_ms)."""
    scaler_mod, fleet_mod, flight_mod = impl[:3]

    class _Metrics:
        def __init__(self):
            self.hists = {"queue_wait_ms_latency": flight_mod.ExpHistogram(),
                          "ttft_ms": flight_mod.ExpHistogram()}

    class _Engine:
        def __init__(self):
            self.metrics = _Metrics()
            self._running = True

        def start(self):
            pass

        def stop(self):
            pass

    engines = [_Engine(), _Engine()]
    reps = [fleet_mod.LocalReplica(f"r{i}", e) for i, e in enumerate(engines)]
    fleet = fleet_mod.EngineFleet(reps, impl[4](), PS)
    sig = _Signal(fleet)
    fleet.park("r1")
    scaler = scaler_mod.FleetAutoscaler(
        fleet, signal_fn=sig, up_ticks=1, cooldown_s=0.0,
        up_queue_wait_p95_ms=50.0)
    sig.total = 1.0
    assert scaler.tick(now=0.0) == "hold"
    for _ in range(10):
        engines[0].metrics.hists["queue_wait_ms_latency"].observe(300.0)
    assert scaler.tick(now=1.0) == "up"
    assert fleet._by_rid["r1"].state == "active"


# -- tick-by-tick parity ------------------------------------------------------


def _script(seed, n_ticks=80):
    """A seeded signal: depth totals in bursts and lulls, and latency
    samples now and then."""
    rng = random.Random(seed)
    out = []
    # Every script holds bursts and lulls of 10 ticks, in a seeded order.
    levels = rng.sample([0.0, 0.5, 3.0, 12.0, 40.0, 0.0, 40.0, 0.0], 8)
    for i in range(n_ticks):
        level = levels[i // 10 % len(levels)]
        total = max(0.0, level + rng.choice([-1.0, 0.0, 0.0, 1.0]))
        busy = level >= 12.0 and rng.random() < 0.5
        qw = [rng.uniform(1, 400) for _ in range(rng.randrange(6))] \
            if busy else []
        tt = [rng.uniform(1, 900) for _ in range(rng.randrange(4))] \
            if busy else []
        out.append((total, rng.random() < 0.05, qw, tt))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("scale_to_zero", [False, True])
def test_decisions_equal_jax_tick_by_tick(monkeypatch, seed, scale_to_zero):
    script = _script(seed)
    runs = {}
    for name, impl in IMPLS.items():
        monkeypatch.setattr(impl[0], "LocalReplica",
                            lambda rid, eng: FakeReplica(rid))
        samples = {"qw": [], "tt": []}

        def hist_fn(impl=impl, samples=samples):
            return [("r0", "mixed", {
                "queue_wait": _hist_snap(impl[2], samples["qw"]),
                "ttft": _hist_snap(impl[2], samples["tt"])})]

        fleet, scaler, sig = make(
            impl, n=2, max_replicas=4, warm_pool=1, cooldown_s=2.0,
            up_ticks=2, down_ticks=3, scale_to_zero=scale_to_zero,
            engine_factory=lambda: object(), hist_fn=hist_fn,
            up_queue_wait_p95_ms=250.0, up_ttft_p95_ms=700.0)
        trail = []
        for i, (total, wake, qw, tt) in enumerate(script):
            sig.total = total
            samples["qw"].extend(qw)
            samples["tt"].extend(tt)
            if wake:
                scaler.wake_for_submit()
            decision = scaler.tick(now=float(i))
            health = scaler.health()
            health.pop("running")
            trail.append((decision,
                          sorted((r.rid, r.state) for r in fleet.replicas),
                          health))
        snap = fleet.metrics.snapshot()
        counters = {k: snap[k] for k in ("autoscale_ups", "autoscale_downs",
                                         "autoscale_wakes")}
        lane = [(e["kind"], e["aux"], e["a"], e["b"])
                for e in scaler.flight.snapshot_events()]
        runs[name] = (trail, counters, lane)
    assert runs["port"][0] == runs["jax"][0]
    assert runs["port"][1] == runs["jax"][1]
    assert runs["port"][2] == runs["jax"][2]
    decisions = [d for d, _, _ in runs["port"][0]]
    assert "up" in decisions and "down" in decisions


# -- build_fleet's spawn lanes ------------------------------------------------


def test_process_spawn_lane_through_build_fleet(monkeypatch):
    calls = []

    def fake_spawn(rid, **kw):
        calls.append((rid, kw))
        return FakeReplica(rid)

    monkeypatch.setattr(tfleet, "spawn_process_replica", fake_spawn)
    cfg = load_config(env={
        "APP_FLEET_REPLICAURLS": "http://127.0.0.1:9",
        "APP_FLEET_AUTOSCALE": "true", "APP_FLEET_AUTOSCALESPAWN": "process",
        "APP_FLEET_AUTOSCALEWARMPOOL": "0",
        "APP_FLEET_AUTOSCALECOOLDOWNS": "0",
        "APP_FLEET_AUTOSCALESPAWNREADYTIMEOUTS": "33",
        "APP_FLEET_CHAOS": "true", "APP_FLEET_CHAOSSEED": "5"})
    fleet = tfleet.build_fleet(cfg, tokenizer=ByteTokenizer(),
                               spawn_kw={"model_size": "tiny",
                                         "device": "cpu"})
    scaler = fleet.autoscaler
    assert isinstance(scaler, tas.FleetAutoscaler)
    assert scaler.engine_factory is None and scaler.replica_factory
    scaler._signal_fn = lambda: (100.0, 1)
    scaler.tick(now=0.0)
    assert scaler.tick(now=1.0) == "up"
    rid, kw = calls[0]
    assert rid == "as1" and kw["role"] == "mixed"
    assert kw["model_size"] == "tiny" and kw["device"] == "cpu"
    assert kw["ready_timeout_s"] == 33.0
    # The child serves one engine: its fleet, autoscaler and chaos off.
    assert kw["env"] == {"APP_FLEET_REPLICAS": "1",
                         "APP_FLEET_REPLICAURLS": "",
                         "APP_FLEET_AUTOSCALE": "false",
                         "APP_FLEET_CHAOS": "false"}
    assert fleet._by_rid["as1"].state == "active"
    # The chaos monkey is armed and idle: counters live, lane registered.
    assert fleet.chaos_monkey is not None
    assert fleet.chaos_stats is fleet.chaos_monkey.stats
    assert set(fleet.flight_recorders()) >= {"autoscaler", "chaos", "fleet"}
    assert fleet.fleet_health()["chaos"] == {"enabled": True}


def test_jax_build_fleet_wires_the_same_controllers():
    """The same [fleet] section gives the JAX fleet and the port's the
    same autoscaler settings."""
    from generativeaiexamples_tpu.config.wizard import load_config as jload

    env = {"APP_FLEET_REPLICAURLS": "http://127.0.0.1:9",
           "APP_FLEET_AUTOSCALE": "true", "APP_FLEET_AUTOSCALEMAXREPLICAS": "3",
           "APP_FLEET_AUTOSCALEUPDEPTH": "4.5", "APP_FLEET_CHAOS": "true"}
    t = tfleet.build_fleet(load_config(env=env), tokenizer=ByteTokenizer())
    j = jfleet.build_fleet(jload(path="", env=env), tokenizer=JTok())
    names = ("min_replicas", "max_replicas", "warm_pool", "interval_s",
             "up_depth", "down_depth", "up_ticks", "down_ticks",
             "cooldown_s", "scale_to_zero", "up_queue_wait_p95_ms",
             "up_ttft_p95_ms")
    assert {n: getattr(t.autoscaler, n) for n in names} == \
        {n: getattr(j.autoscaler, n) for n in names}
    assert t.chaos_monkey.rng.random() == j.chaos_monkey.rng.random()


# -- end to end on the tiny model ---------------------------------------------

VOCAB = 259
ECFG = dict(max_batch_size=2, max_seq_len=256, page_size=PS,
            prefill_buckets=(16, 32), kv_dtype="float32",
            decode_steps_per_dispatch=2, prefix_cache=True)


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(vocab_size=VOCAB)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    tparams = convert.llama_params_from_numpy(np_tree, "cpu", torch.float32)
    return jcfg, jparams, tl.LlamaConfig.tiny(vocab_size=VOCAB), tparams


def _greedy(models, prompt, n_new):
    jcfg, jparams = models[:2]
    out = jl.greedy_generate(jparams, jcfg, jnp.asarray([prompt], jnp.int32),
                             n_new, use_pallas=False)
    toks = np.asarray(out)[0, len(prompt):].tolist()
    eos = ByteTokenizer().eos_id
    return toks[:toks.index(eos) + 1] if eos in toks else toks


def _collect(req, timeout=120):
    toks = []
    while True:
        ev = req.stream.get(timeout=timeout)
        if ev["token_id"] >= 0:
            toks.append(ev["token_id"])
        if ev["finished"]:
            assert ev["finish_reason"] != "error"
            return toks


def test_build_llm_engine_factory_shares_the_weight_tree():
    from generativeaiexamples_tpu_torch.serving.__main__ import build_llm

    cfg = load_config(env={
        "APP_FLEET_REPLICAS": "2", "APP_FLEET_AUTOSCALE": "true",
        "APP_FLEET_AUTOSCALEMAXREPLICAS": "3",
        "APP_FLEET_AUTOSCALEINTERVALS": "30",
        "APP_ENGINE_MAXBATCHSIZE": "2", "APP_ENGINE_MAXSEQLEN": "128",
        "APP_ENGINE_PAGESIZE": "8", "APP_ENGINE_PREFILLBUCKETS": "[16]"})
    fleet = build_llm(cfg, "tiny", "cpu", warmup=False)
    try:
        # start() filled the warm pool from the engine factory: a third
        # replica, parked warm, over the same tensors on the same device.
        assert [(r.rid, r.state) for r in fleet.replicas] == \
            [("r0", "active"), ("r1", "active"), ("as1", "warm")]
        engines = [r.engine for r in fleet.replicas]
        assert engines[2].params is engines[0].params
        assert engines[2].device == engines[0].device
        assert engines[2].pool.k.data_ptr() != engines[0].pool.k.data_ptr()
        assert fleet.fleet_health()["autoscale"]["spawned"] == 1
    finally:
        fleet.stop()


def test_burst_wakes_spawns_and_idle_parks_streams_equal_greedy(models):
    """The chip smoke's elastic check at tiny size: r1 parked warm, a
    burst wakes it and spawns a third replica through engine_factory,
    idle parks down to min_replicas; every stream equals the offline JAX
    greedy oracle."""
    _, _, tcfg, tparams = models

    def factory():
        return LLMEngine(tparams, tcfg, ByteTokenizer(), ECFG, device="cpu")

    reps = [tfleet.LocalReplica(f"r{i}", factory()) for i in range(2)]
    fleet = tfleet.EngineFleet(reps, ByteTokenizer(), PS).start()
    scaler = tas.FleetAutoscaler(
        fleet, engine_factory=factory, min_replicas=1, max_replicas=3,
        warm_pool=1, interval_s=0.05, up_depth=2.0, down_depth=0.5,
        up_ticks=2, down_ticks=3, cooldown_s=0.2)
    fleet.park("r1")
    scaler.start()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 256, 10 + 3 * i).tolist() for i in range(12)]
    try:
        reqs = []
        for p in prompts:
            req = GenRequest(prompt_ids=p, max_new_tokens=12)
            fleet.submit(req)
            reqs.append(req)
        got = [_collect(r) for r in reqs]
        deadline = time.monotonic() + 60
        while (sum(r.state == "active" for r in fleet.replicas) > 1
               and time.monotonic() < deadline):
            time.sleep(0.05)
        snap = fleet.metrics.snapshot()
        assert snap["autoscale_ups"] >= 1
        assert snap["autoscale_downs"] >= 1
        assert sum(r.state == "active" for r in fleet.replicas) == 1
        lane = [e["kind"] for e in scaler.flight.snapshot_events()]
        assert tflight.EV_SCALE_UP in lane and tflight.EV_SCALE_DOWN in lane
    finally:
        fleet.stop()
    assert got == [_greedy(models, p, 12) for p in prompts]
