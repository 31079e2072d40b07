"""Port parity: SLO-aware QoS (serving/qos.py) and the engine's QoS half.

The module: tier normalization, `TierScheduler.pick` sequences over the
same seeded waiting queues, `EdgeAdmission` decisions and snapshots over
the same op scripts, `bursty_trace(seed)` and `goodput` against the JAX
package's copy. The engine (tiny f32 model on the CPU): with `engine.qos`
its admission order equals the JAX `TierScheduler`'s over the same waiting
list (FIFO with it off); a batch-tier long prefill paused for a
latency-tier TTFT phase resumes byte-identical to the offline JAX greedy
stream; the flight recorder carries each request's tier; the tier gauges
and `/metrics` keys. No JAX `LLMEngine` is built.
"""

import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.serving import qos as jqos
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.serving import flight as tf
from generativeaiexamples_tpu_torch.serving import qos as tqos
from generativeaiexamples_tpu_torch.serving.engine import (
    GenRequest, LLMEngine)
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

VOCAB = 259
ECFG = dict(max_batch_size=2, max_seq_len=128, page_size=8,
            prefill_buckets=(16, 32), kv_dtype="float32",
            decode_steps_per_dispatch=2)


class _Req:
    """A waiting-queue entry with the fields the scheduler reads."""

    def __init__(self, priority, tenant_id, n_prompt, max_new):
        self.priority = priority
        self.tenant_id = tenant_id
        self.prompt_ids = [1] * n_prompt
        self.max_new_tokens = max_new


def test_tier_helpers_equal_jax():
    for v in ("latency", "LATENCY ", "standard", "batch", "", None, "x", 3):
        assert tqos.normalize_tier(v) == jqos.normalize_tier(v)
        assert tqos.tier_id(tqos.normalize_tier(v)) == \
            jqos.tier_id(jqos.normalize_tier(v))
    for name in ("TIERS", "DEFAULT_TIER", "TIER_RANK", "TIER_LOAD_WEIGHT"):
        assert getattr(tqos, name) == getattr(jqos, name), name
    assert tf.TIERS == jqos.TIERS


@pytest.mark.parametrize("weights", [None, {"latency": 2, "batch": 0},
                                     {"standard": 9}])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pick_sequences_equal_jax(seed, weights):
    """Arrivals and admissions interleave on a seeded queue; both
    schedulers must pick the same index every time and keep the same
    service accounting."""
    rng = random.Random(seed)
    sched = [tqos.TierScheduler(weights), jqos.TierScheduler(weights)]
    queues = [[], []]
    picks = []
    for _ in range(400):
        if rng.random() < 0.55 or not queues[0]:
            args = (rng.choice(("latency", "standard", "batch", "odd")),
                    rng.choice(("a", "b", "c", "")), rng.randrange(1, 300),
                    rng.randrange(1, 64))
            for q in queues:
                q.append(_Req(*args))
            continue
        got = [s.pick(q) for s, q in zip(sched, queues)]
        assert got[0] == got[1]
        for s, q in zip(sched, queues):
            s.note_admitted(q.pop(got[0]))
        picks.append(got[0])
        assert sched[0].served == sched[1].served
        assert sched[0].tenant_served == sched[1].tenant_served
        assert sched[0].vtime == sched[1].vtime
    assert len(set(picks)) > 3


def test_pick_window_and_tenant_cap_equal_jax():
    for m in (tqos, jqos):
        s = m.TierScheduler()
        q = [_Req("batch", "t", 1, 1)] * m.TierScheduler.PICK_WINDOW + [
            _Req("latency", "t", 1, 1)]
        assert s.pick(q) == 0  # the latency entry is past the window
        for i in range(m.TierScheduler.MAX_TENANTS + 1):
            s.note_admitted(_Req("standard", f"t{i}", 1, i))
        assert len(s.tenant_served) == m.TierScheduler.MAX_TENANTS // 2


@pytest.mark.parametrize("enabled", [True, False])
def test_edge_admission_equal_jax(enabled):
    rng = random.Random(7)
    bounds = {"latency": 2, "standard": 0, "batch": 3}
    edges = [m.EdgeAdmission(bounds, retry_after_s=2.5, enabled=enabled)
             for m in (tqos, jqos)]
    for _ in range(300):
        tier = rng.choice(("latency", "standard", "batch", "junk"))
        if rng.random() < 0.6:
            got = [e.try_admit(tier) for e in edges]
        else:
            got = [e.release(tier) for e in edges]
        assert got[0] == got[1]
        assert edges[0].snapshot() == edges[1].snapshot()
    if enabled:
        assert edges[0].snapshot()["qos_shed_total"] > 0


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_bursty_trace_and_goodput_equal_jax(seed):
    ours = tqos.bursty_trace(seed=seed)
    theirs = jqos.bursty_trace(seed=seed)
    assert [vars(r) for r in ours] == [vars(r) for r in theirs]
    rng = random.Random(seed)
    results = [{"tier": r.tier, "shed": rng.random() < 0.1,
                "error": rng.random() < 0.05,
                "ttft_s": rng.random() if rng.random() < 0.95 else None,
                "gap_p95_s": rng.random() * 0.1, "wall_s": rng.random() * 3}
               for r in ours]
    slos = {"latency": {"ttft_s": 0.5, "gap_p95_s": 0.05},
            "batch": {"wall_s": 2.0}}
    assert tqos.goodput(results, slos) == jqos.goodput(results, slos)


# -- the engine's QoS half ---------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(vocab_size=VOCAB)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.llama_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jcfg, jparams, tl.LlamaConfig.tiny(vocab_size=VOCAB), tparams


def _greedy(models, prompt, n_new):
    jcfg, jparams, _, _ = models
    out = jl.greedy_generate(jparams, jcfg, jnp.asarray([prompt], jnp.int32),
                             n_new, use_pallas=False)
    toks = np.asarray(out)[0, len(prompt):].tolist()
    eos = ByteTokenizer().eos_id
    return toks[:toks.index(eos) + 1] if eos in toks else toks


def _engine(models, **kw):
    _, _, tcfg, tparams = models
    return LLMEngine(tparams, tcfg, ByteTokenizer(), {**ECFG, **kw},
                     device="cpu")


def _collect(req, timeout=120):
    out = []
    while True:
        ev = req.stream.get(timeout=timeout)
        if ev["token_id"] >= 0:
            out.append(ev["token_id"])
        if ev["finished"]:
            return out, ev["finish_reason"]


def _queue(seed, n=12):
    rng = random.Random(seed)
    return [GenRequest(prompt_ids=[rng.randrange(1, 256)
                                   for _ in range(rng.randrange(3, 14))],
                       max_new_tokens=rng.randrange(1, 4),
                       priority=rng.choice(("latency", "standard", "batch")),
                       tenant_id=rng.choice(("a", "b")),
                       request_id=f"q{i}")
            for i in range(n)]


@pytest.mark.parametrize("qos", [True, False], ids=["qos", "fifo"])
def test_engine_admission_order_equals_jax_scheduler(models, qos):
    """One slot: every admission pops one request from the full waiting
    list, so the engine's admission order is the scheduler's pick order
    over that list (arrival order with QoS off)."""
    eng = _engine(models, max_batch_size=1, qos=qos,
                  qos_weight_latency=5, qos_weight_batch=2)
    reqs = _queue(3)
    for r in reqs:
        eng.submit(r)
    assert eng.metrics.qos_queue_depth == {
        t: sum(r.priority == t for r in reqs) for t in jqos.TIERS}
    eng.start()
    try:
        for r in reqs:
            _collect(r)
    finally:
        eng.stop()
    events = eng.flight.snapshot_events()
    admits = [e["rid"] for e in events if e["kind"] == tf.EV_ADMIT]
    if qos:
        sched = jqos.TierScheduler({"latency": 5, "standard": 4,
                                    "batch": 2})
        waiting, want = list(reqs), []
        while waiting:
            r = waiting.pop(sched.pick(waiting))
            sched.note_admitted(r)
            want.append(r.request_id)
    else:
        want = [r.request_id for r in reqs]
    assert admits == want
    assert eng.metrics.qos_queue_depth == dict.fromkeys(jqos.TIERS, 0)
    picks = [e for e in events if e["kind"] == tf.EV_QOS_PICK]
    assert len(picks) == (len(reqs) if qos else 0)
    tiers = {e["rid"]: jqos.TIERS[e["tier"]] for e in events
             if e["kind"] == tf.EV_ADMIT}
    assert tiers == {r.request_id: r.priority for r in reqs}


def test_paused_long_prefill_resumes_byte_identical(models):
    """A batch-tier prompt beyond the largest bucket is chunk-prefilling
    when a latency-tier request's TTFT phase begins: the prefill pauses
    (qos_preemptions, EV_QOS_PAUSE / EV_QOS_RESUME, a paused beat) and its
    stream equals the offline JAX greedy stream, as does the latency
    request's."""
    rng = np.random.default_rng(4)
    long_p = rng.integers(1, 256, 90).tolist()
    short_p = rng.integers(1, 256, 6).tolist()
    eng = _engine(models, qos=True)
    long_r = GenRequest(prompt_ids=long_p, max_new_tokens=8,
                        priority="batch", request_id="long")
    short_r = GenRequest(prompt_ids=short_p, max_new_tokens=8,
                         priority="latency", request_id="short")
    eng.submit(long_r)
    eng.submit(short_r)
    eng.start()
    try:
        long_out, _ = _collect(long_r)
        short_out, _ = _collect(short_r)
    finally:
        eng.stop()
    assert long_out == _greedy(models, long_p, 8)
    assert short_out == _greedy(models, short_p, 8)
    assert eng.metrics.qos_preemptions >= 1
    kinds = [e["kind"] for e in eng.flight.snapshot_events()
             if e["rid"] == "long"]
    assert tf.EV_QOS_PAUSE in kinds and tf.EV_QOS_RESUME in kinds
    assert any(b["qos_paused"] for b in eng.flight.snapshot_beats())
    snap = eng.metrics.snapshot()
    assert snap["qos_preemptions"] == eng.metrics.qos_preemptions
    assert snap["hist_queue_wait_ms_latency"]["count"] == 1
    assert snap["hist_queue_wait_ms_batch"]["count"] == 1


def test_qos_off_never_pauses_and_keys_are_present(models):
    eng = _engine(models)
    assert eng.qos is None
    snap = eng.metrics.snapshot()
    assert snap["qos_preemptions"] == 0
    assert snap["qos_queue_depth"] == dict.fromkeys(jqos.TIERS, 0)


def test_run_trace_on_engine_serves_every_request(models):
    """The harness on the port's engine: a scaled-down trace, every
    request answered (or shed at the edge), tiers kept."""
    trace = tqos.bursty_trace(seed=0, horizon_s=0.5, batch_requests=3,
                              batch_prompt=(1.4, 8, 40),
                              batch_out=(1.6, 2, 6),
                              latency_prompt=(1.8, 4, 12),
                              latency_out=(1.8, 2, 4))
    eng = _engine(models, qos=True).start()
    edge = tqos.EdgeAdmission({"batch": 2}, enabled=True)
    try:
        res = tqos.run_trace_on_engine(eng, trace, edge=edge,
                                       time_scale=0.2, vocab=250,
                                       timeout_s=60)
    finally:
        eng.stop()
    assert len(res) == len(trace)
    assert [r["tier"] for r in res] == [t.tier for t in trace]
    assert all(r["shed"] or (not r["error"] and r["tokens"] >= 1)
               for r in res)
    assert edge.snapshot()["qos_edge_depth"] == dict.fromkeys(jqos.TIERS, 0)
    good = tqos.goodput(res, {"latency": {"ttft_s": 60.0}})
    assert set(good) == {t.tier for t in trace}


def test_waiting_gauge_follows_concurrent_submits(models):
    eng = _engine(models)
    threads = [threading.Thread(target=eng.submit, args=(GenRequest(
        prompt_ids=[5, 6], priority=t),)) for t in
        ("latency", "batch", "batch", "nope")]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert eng.metrics.qos_queue_depth == {"latency": 1, "standard": 1,
                                           "batch": 2}
