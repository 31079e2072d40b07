"""Port parity: the chaos harness (serving/chaos.py).

The JAX package's tests/test_chaos.py injector cases (unknown kinds, a
blackhole shorter than K probes that does not evict and one that
outlives them, a submit fault that unwinds the fleet's tracking, the
seeded pick, the restore-versus-evict race) run on both packages over
fake replicas. The seeded picks equal JAX's for the same seed and
replica list, pick for pick, and `classify` gives the same buckets on
the same results. On the port's tiny f32 engines: the slow injector sets
and restores the beat delay and the engine serves after it; a kill in
the middle of a bursty trace loses no request that was not already
streaming, every completed stream equals the offline JAX greedy oracle,
and the server's /metrics and /health show the injections. No JAX
`LLMEngine` is built.
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
from generativeaiexamples_tpu.serving import chaos as jchaos
from generativeaiexamples_tpu.serving import engine as jeng_mod
from generativeaiexamples_tpu.serving import fleet as jfleet
from generativeaiexamples_tpu.utils.tokenizer import ByteTokenizer as JTok
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.serving import chaos as tchaos
from generativeaiexamples_tpu_torch.serving import fleet as tfleet
from generativeaiexamples_tpu_torch.serving.engine import (
    GenRequest, LLMEngine)
from generativeaiexamples_tpu_torch.serving.openai_server import OpenAIServer
from generativeaiexamples_tpu_torch.serving.qos import bursty_trace
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

PS = 8
# (chaos module, fleet module, GenRequest, tokenizer)
IMPLS = {"jax": (jchaos, jfleet, jeng_mod.GenRequest, JTok),
         "port": (tchaos, tfleet, GenRequest, ByteTokenizer)}


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

    def set_reporter(self, fn):
        pass

    def submit(self, req):
        self.submitted.append(req)

    def healthy(self):
        return self.alive

    def start(self):
        pass

    def stop(self):
        pass

    def warmup(self, **kw):
        pass

    def metrics_snapshot(self):
        return {}


def _fake_fleet(impl, threshold=2):
    fakes = [FakeReplica("r0"), FakeReplica("r1")]
    fleet = impl[1].EngineFleet(fakes, impl[3](), PS,
                                health_fail_threshold=threshold).start()
    return fleet, fakes


def test_unknown_kind_rejected(impl):
    with pytest.raises(ValueError):
        impl[0].ChaosEvent(t=0.0, kind="meteor")


def test_blackhole_shorter_than_k_probes_does_not_evict(impl):
    mod = impl[0]
    fleet, fakes = _fake_fleet(impl, threshold=2)
    try:
        monkey = mod.ChaosMonkey(fleet, seed=0)
        monkey.inject(mod.ChaosEvent(t=0.0, kind="blackhole", rid="r0",
                                     duration_s=5.0))
        assert fleet.check_health()["r0"] is False
        assert fakes[0].state == "active"
        monkey.undo_all()
        assert fleet.check_health()["r0"] is True
        assert fleet.fleet_health()["replicas"]["r0"]["probe_fails"] == 0
        monkey.inject(mod.ChaosEvent(t=0.0, kind="blackhole", rid="r0",
                                     duration_s=5.0))
        fleet.check_health()
        fleet.check_health()
        assert fakes[0].state == "evicted"
        snap = fleet.metrics.snapshot()
        assert snap["chaos_injected_blackholes"] == 2
        assert snap["replica_evictions"] == 1
        monkey.undo_all()
    finally:
        fleet.stop()


def test_submit_error_unwinds_tracking(impl):
    mod = impl[0]
    fleet, fakes = _fake_fleet(impl)
    try:
        monkey = mod.ChaosMonkey(fleet, seed=0)
        for rid in ("r0", "r1"):
            monkey.inject(mod.ChaosEvent(t=0.0, kind="submit_error",
                                         rid=rid, duration_s=5.0))
        req = impl[2](prompt_ids=[3] * 16, max_new_tokens=4)
        with pytest.raises(mod.ChaosSubmitError):
            fleet.submit(req)
        assert sum(len(d) for d in fleet._records.values()) == 0
        assert all(v == 0 for v in fleet.router.queue_depths().values())
        assert fleet.metrics.snapshot()["chaos_injected_submit_errors"] == 2
        monkey.undo_all()
        req2 = impl[2](prompt_ids=[3] * 16, max_new_tokens=4)
        fleet.submit(req2)
        assert any(req2 in f.submitted for f in fakes)
    finally:
        fleet.stop()


def test_schedule_runs_and_undoes_on_time(impl):
    mod = impl[0]
    fleet, fakes = _fake_fleet(impl)
    try:
        monkey = mod.ChaosMonkey(fleet, seed=0)
        orig = fakes[1].healthy
        monkey.run_schedule([
            mod.ChaosEvent(t=0.05, kind="blackhole", rid="r1",
                           duration_s=0.05),
            mod.ChaosEvent(t=0.0, kind="submit_error", rid="r0",
                           duration_s=0.02)])
        monkey.wait(timeout_s=10)
        assert fakes[1].healthy == orig
        assert fakes[0].submit.__func__ is FakeReplica.submit
        evs = monkey.flight.snapshot_events()
        assert [e["aux"] for e in evs] == ["submit_error:r0",
                                           "blackhole:r1"]
    finally:
        fleet.stop()


def test_restore_and_evict_race_stays_consistent(impl):
    fleet, fakes = _fake_fleet(impl, threshold=1)
    errs = []
    barrier = threading.Barrier(2)

    def run(fn):
        try:
            barrier.wait(timeout=10)
            for _ in range(25):
                fn("r0")
        except Exception as e:  # pragma: no cover - the assertion
            errs.append(e)

    threads = [threading.Thread(target=run, args=(fleet.evict,)),
               threading.Thread(target=run, args=(fleet.restore,))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    try:
        assert not errs
        assert fakes[0].state in ("active", "evicted")
        fleet.restore("r0")
        req = impl[2](prompt_ids=[2] * 16, max_new_tokens=4)
        fleet.submit(req)
        assert any(req in f.submitted for f in fakes)
        assert sum(len(d) for d in fleet._records.values()) == 1
    finally:
        fleet.stop()


# -- seeded picks and classify, port against JAX ------------------------------


def _picks(impl, seed, n_replicas, park=()):
    reps = [impl[1].LocalReplica(f"r{i}", object()) for i in range(n_replicas)]
    fleet = impl[1].EngineFleet(reps, impl[3](), PS)
    for rid in park:
        fleet._by_rid[rid].state = "warm"
    monkey = impl[0].ChaosMonkey(fleet, seed=seed)
    return [monkey._pick("").rid for _ in range(12)]


@pytest.mark.parametrize("seed", [0, 7, 42, 2 ** 31 - 1])
@pytest.mark.parametrize("n_replicas,park", [(2, ()), (3, ()),
                                             (5, ("r1", "r3"))])
def test_seeded_picks_equal_jax(seed, n_replicas, park):
    want = _picks(IMPLS["jax"], seed, n_replicas, park)
    assert _picks(IMPLS["port"], seed, n_replicas, park) == want
    assert _picks(IMPLS["port"], seed, n_replicas, park) == want
    assert not set(want) & set(park)


def test_classify_equals_jax():
    rng = random.Random(3)
    results = [{"shed": rng.random() < 0.2, "error": rng.random() < 0.3,
                "tokens": rng.choice([0, 0, 3, 12])} for _ in range(200)]
    assert tchaos.classify(results) == jchaos.classify(results)
    assert tchaos.classify([]) == {"completed": 0, "shed": 0,
                                   "midstream": 0, "lost": 0}


def test_stats_snapshot_keys_equal_jax():
    assert set(tchaos.ChaosStats().snapshot()) == \
        set(jchaos.ChaosStats().snapshot()) == set(tfleet.CHAOS_KEYS)


# -- real engines (tiny f32, CPU) ---------------------------------------------

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


def _fleet(models, n=2, **kw):
    _, _, tcfg, tparams = models
    engines = [LLMEngine(tparams, tcfg, ByteTokenizer(), ECFG, device="cpu")
               for _ in range(n)]
    reps = [tfleet.LocalReplica(f"r{i}", e) for i, e in enumerate(engines)]
    kw.setdefault("health_fail_threshold", 1)
    return tfleet.EngineFleet(reps, ByteTokenizer(), PS, **kw).start(), engines


def _collect(req, timeout=120):
    toks = []
    while True:
        ev = req.stream.get(timeout=timeout)
        if ev["token_id"] >= 0:
            toks.append(ev["token_id"])
        if ev["finished"]:
            return toks, ev["finish_reason"]


def test_slow_injector_sets_and_restores_beat_delay(models):
    fleet, engines = _fleet(models, n=1)
    try:
        monkey = tchaos.ChaosMonkey(fleet, seed=0)
        th = monkey.run_schedule([tchaos.ChaosEvent(
            t=0.0, kind="slow", rid="r0", duration_s=0.15, magnitude=0.02)])
        deadline = time.monotonic() + 5
        while engines[0].chaos_beat_delay_s == 0.0:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        th.join(timeout=10)
        monkey.wait(timeout_s=10)
        assert engines[0].chaos_beat_delay_s == 0.0
        assert fleet.metrics.snapshot()["chaos_injected_slow_beats"] == 1
        prompt = [5] * 16
        req = GenRequest(prompt_ids=prompt, max_new_tokens=4)
        fleet.submit(req)
        toks, reason = _collect(req)
        assert reason != "error" and toks == _greedy(models, prompt, 4)
    finally:
        fleet.stop()


def test_slow_replica_beats_are_slower(models):
    """A slow event stretches the replica's beats by about its delay."""
    fleet, engines = _fleet(models, n=1)
    try:
        engines[0].chaos_beat_delay_s = 0.03
        req = GenRequest(prompt_ids=[7] * 12, max_new_tokens=9)
        t0 = time.perf_counter()
        fleet.submit(req)
        _collect(req)
        assert time.perf_counter() - t0 >= 4 * 0.03
    finally:
        engines[0].chaos_beat_delay_s = 0.0
        fleet.stop()


def test_kill_mid_trace_loses_nothing_not_midstream(models):
    fleet, engines = _fleet(models, health_interval_s=0.05,
                            health_fail_threshold=2)
    # Every request and its delivered tokens, seen at the fleet's tracked
    # stream (the trace's collectors read the same events).
    seen, lock = {}, threading.Lock()
    on_event = fleet._on_event

    def tap(rec, ev):
        with lock:
            entry = seen.setdefault(id(rec.req), [rec.req, [], None])
            if ev.get("token_id", -1) >= 0:
                entry[1].append(ev["token_id"])
            if ev.get("finished"):
                entry[2] = ev.get("finish_reason")
        on_event(rec, ev)

    fleet._on_event = tap
    try:
        trace = bursty_trace(seed=5, horizon_s=1.5, latency_rps=2.0,
                             batch_requests=4, batch_prompt=(1.4, 24, 64),
                             batch_out=(1.6, 8, 24))
        results, monkey = tchaos.run_chaos_trace(
            fleet, trace, [tchaos.ChaosEvent(t=0.5, kind="kill")], seed=7,
            timeout_s=120.0)
        buckets = tchaos.classify(results)
        assert buckets["lost"] == 0
        assert buckets["completed"] >= 1
        assert sum(buckets.values()) == len(trace)
        snap = fleet.metrics.snapshot()
        assert snap["chaos_injected_kills"] == 1
        assert snap["replica_evictions"] == 1
        evs = fleet.extra_flight_lanes["chaos"].snapshot_events()
        assert any(e["aux"].startswith("kill:") for e in evs)
        # The server's surfaces show the injection.
        app = OpenAIServer(llm_engine=fleet)
        assert app.metrics()[1]["chaos_injected_kills"] == 1
        assert app.health()[1]["fleet"]["chaos"] == {"enabled": True}
        completed = [(req, toks) for req, toks, reason in seen.values()
                     if reason not in (None, "error")]
        assert len(completed) == buckets["completed"]
        for req, toks in completed:
            assert toks == _greedy(models, list(req.prompt_ids),
                                   req.max_new_tokens)
    finally:
        fleet.stop()
