"""Port parity: the serving fleet (serving/fleet.py) and its surfaces.

Fake-replica lifecycle cases (eviction and requeue, the mid-stream error
event, unavailability, requeue fidelity of tier, tenant and session, the
probe threshold, the HTTP probe's short deadline, stuck joins, the
disagg stage's fast bail-out and decode-load reservation) run on the JAX
package's `EngineFleet` and the port's alike: both must pass each case.
End to end on the tiny f32 model (CPU): a 2-replica port fleet's N-thread
greedy streams equal the single port engine's and the offline JAX greedy
oracle's; conversation turns hit the replica holding their KV; drain,
evict and restore; two-stage disagg streams equal colocated ones over the
host bounce, the device path and pipelined windows, for f32, bf16 and
int8 pools, and a forced transfer failure falls back on the same stream;
a spawned port server works as a ProcessReplica; the JAX package's own
HttpReplica client exports from and imports into port servers (the same
wire). Surfaces: the key sets of `FleetMetrics.snapshot()`, `/health`'s
`fleet` / `qos` sections and `/metrics` equal JAX's (an `EngineFleet`
over fake replicas on both sides); a config file with `fleet.replicas:
2` builds a fleet. No JAX `LLMEngine` is built.
"""

import asyncio
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.serving import engine as jeng_mod
from generativeaiexamples_tpu.serving import fleet as jfleet
from generativeaiexamples_tpu.serving import openai_server as jserver
from generativeaiexamples_tpu.utils.tokenizer import ByteTokenizer as JTok
from generativeaiexamples_tpu_torch.config.schema import load_config
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.ops.quant import quantize_llama_params
from generativeaiexamples_tpu_torch.serving import engine as teng_mod
from generativeaiexamples_tpu_torch.serving import fleet as tfleet
from generativeaiexamples_tpu_torch.serving.__main__ import build_llm
from generativeaiexamples_tpu_torch.serving.engine import (
    GenRequest, LLMEngine)
from generativeaiexamples_tpu_torch.serving.openai_server import (
    OpenAIServer, make_http_server)
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

PS = 8
VOCAB = 259
ECFG = dict(max_batch_size=2, max_seq_len=256, page_size=PS,
            prefill_buckets=(16, 32), kv_dtype="float32",
            decode_steps_per_dispatch=2, prefix_cache=True)
# (fleet module, GenRequest class, tokenizer class) of each side.
IMPLS = {"jax": (jfleet, jeng_mod.GenRequest, JTok),
         "port": (tfleet, GenRequest, ByteTokenizer)}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


def collect(req, timeout=120):
    toks = []
    while True:
        ev = req.stream.get(timeout=timeout)
        if ev["token_id"] >= 0:
            toks.append(ev["token_id"])
        if ev["finished"]:
            return toks, ev["finish_reason"]


def run_one(target, prompt, session="", max_new=8, **kw):
    req = GenRequest(prompt_ids=list(prompt), max_new_tokens=max_new,
                     session_id=session, **kw)
    target.submit(req)
    toks, reason = collect(req)
    assert reason != "error"
    return toks


# -- fake replicas (both packages) --------------------------------------------


class FakeReplica:
    def __init__(self, rid):
        self.rid = rid
        self.state = "active"
        self.has_prefix_cache = False
        self.submitted = []
        self.alive = True
        self.stopped = False

    def set_reporter(self, fn):
        pass

    def submit(self, req):
        self.submitted.append(req)

    def healthy(self):
        return self.alive

    def start(self):
        pass

    def stop(self):
        self.stopped = True

    def warmup(self, **kw):
        pass

    def metrics_snapshot(self):
        return {}


def _fake_fleet(impl, threshold=1, **kw):
    mod, _, tok = impl
    fakes = [FakeReplica("r0"), FakeReplica("r1")]
    return mod.EngineFleet(fakes, tok(), PS, health_fail_threshold=threshold,
                           **kw).start(), fakes


def test_dead_replica_evicted_and_waiting_request_requeued(impl):
    fleet, fakes = _fake_fleet(impl)
    req = impl[1](prompt_ids=[3] * 24, max_new_tokens=8)
    fleet.submit(req)
    victim = next(f for f in fakes if f.submitted)
    other = next(f for f in fakes if not f.submitted)
    victim.alive = False
    health = fleet.check_health()
    assert health[victim.rid] is False and health[other.rid] is True
    assert victim.state == "evicted" and victim.stopped
    assert other.submitted == [req]
    snap = fleet.metrics.snapshot()
    assert (snap["replica_evictions"], snap["router_requeued"],
            snap["router_rebalances"]) == (1, 1, 1)
    for _ in range(4):
        r = impl[1](prompt_ids=[4] * 24, max_new_tokens=8)
        fleet.submit(r)
        assert r in other.submitted


def test_midstream_request_gets_the_error_event(impl):
    fleet, fakes = _fake_fleet(impl)
    req = impl[1](prompt_ids=[5] * 24, max_new_tokens=8)
    fleet.submit(req)
    victim = next(f for f in fakes if f.submitted)
    other = next(f for f in fakes if not f.submitted)
    req.stream.put({"text": "x", "token_id": 7, "finished": False,
                    "finish_reason": None})
    victim.alive = False
    fleet.check_health()
    assert req not in other.submitted
    assert collect(req, timeout=5) == ([7], "error")
    assert req.cancelled


def test_all_replicas_down_is_unavailable(impl):
    fleet, fakes = _fake_fleet(impl)
    for f in fakes:
        f.alive = False
    fleet.check_health()
    with pytest.raises(impl[0].FleetUnavailableError):
        fleet.submit(impl[1](prompt_ids=[1] * 8))


def test_requeue_keeps_tier_tenant_and_repins_affinity(impl):
    fleet, fakes = _fake_fleet(impl)
    req = impl[1](prompt_ids=[3] * 24, max_new_tokens=8, priority="latency",
                  tenant_id="acme", session_id="sess-1")
    fleet.submit(req)
    victim = next(f for f in fakes if f.submitted)
    other = next(f for f in fakes if not f.submitted)
    assert fleet.router._affinity["sess-1"][0] == victim.rid
    victim.alive = False
    fleet.check_health()
    assert other.submitted == [req]
    assert req.priority == "latency" and req.tenant_id == "acme"
    assert fleet.router.tier_queue_depths()[other.rid] == {"latency": 1}
    assert fleet.router._affinity["sess-1"][0] == other.rid
    req2 = impl[1](prompt_ids=[3] * 24, max_new_tokens=8,
                   priority="latency", session_id="sess-1")
    fleet.submit(req2)
    assert req2 in other.submitted


def test_eviction_needs_k_consecutive_failures(impl):
    fleet, fakes = _fake_fleet(impl, threshold=3)
    fakes[0].alive = False
    for i in range(2):
        fleet.check_health()
        assert fakes[0].state == "active"
        assert fleet.fleet_health()["replicas"]["r0"]["probe_fails"] == i + 1
    fleet.check_health()
    assert fakes[0].state == "evicted"
    # One slow poll cannot kill a replica: a success resets the count.
    fleet2, fakes2 = _fake_fleet(impl, threshold=3)
    fakes2[0].alive = False
    fleet2.check_health()
    fleet2.check_health()
    fakes2[0].alive = True
    fleet2.check_health()
    assert fleet2.fleet_health()["replicas"]["r0"]["probe_fails"] == 0


def test_http_probe_uses_its_short_deadline(impl):
    rep = impl[0].HttpReplica("h0", "http://127.0.0.1:9", timeout_s=300.0,
                              probe_timeout_s=0.2)
    t0 = time.monotonic()
    assert rep.healthy() is False
    assert time.monotonic() - t0 < 5.0
    assert rep.healthy() is False and rep._probe_fails == 2


def test_fleet_sums_stuck_joins(impl):
    class StuckFake(FakeReplica):
        def metrics_snapshot(self):
            return {"stuck_thread_joins": 2}

    mod, _, tok = impl
    fleet = mod.EngineFleet([StuckFake("r0"), FakeReplica("r1")], tok(), PS)
    assert fleet.metrics.snapshot()["stuck_thread_joins"] == 2
    fleet.ops.note_stuck_join()
    assert fleet.metrics.snapshot()["stuck_thread_joins"] == 3


def test_prefill_stage_bails_fast_when_replica_evicted(impl):
    mod, gen, tok = impl
    fakes = [FakeReplica("r0"), FakeReplica("r1")]
    fakes[0].role, fakes[1].role = "prefill", "decode"
    fleet = mod.EngineFleet(fakes, tok(), PS, disagg=True,
                            disagg_prefill_timeout_s=30.0).start()
    req = gen(prompt_ids=[3] * 24, max_new_tokens=4)

    def evict_soon():
        time.sleep(0.3)
        with fleet._lock:
            fakes[0].state = "evicted"

    threading.Thread(target=evict_soon).start()
    t0 = time.monotonic()
    fleet.submit(req)
    assert time.monotonic() - t0 < 10.0
    assert fleet.metrics.snapshot()["disagg_fallbacks"] == 1
    assert req in fakes[1].submitted


def test_decode_load_reserved_during_stage_window(impl):
    mod, gen, tok = impl
    fakes = [FakeReplica("r0"), FakeReplica("r1")]
    fakes[0].role, fakes[1].role = "prefill", "decode"
    fleet = mod.EngineFleet(fakes, tok(), PS, disagg=True).start()
    seen = {}

    def spy(prid, drid, req):
        seen["depth"] = fleet.router.queue_depths()[drid]
        return False

    fleet._run_disagg_stages = spy
    fleet.submit(gen(prompt_ids=[6] * 24, max_new_tokens=4))
    assert seen["depth"] == 1
    assert fleet.router.queue_depths()["r1"] == 1


def test_sse_parser_and_counter_lists_equal_jax():
    lines = [b"data: {\"a\": 1}\n", b"\n", b": ping\n", b"data: [DONE]\n",
             b"data: {\"b\": 2}\n"]
    assert list(tfleet.sse_json_events(lines)) == list(
        jfleet.sse_json_events(lines)) == [{"a": 1}]
    for name in ("_COUNTER_KEYS", "FLEET_OPS_KEYS", "CHAOS_KEYS"):
        assert getattr(tfleet, name) == getattr(jfleet, name), name


# -- surfaces ------------------------------------------------------------------


class _Query:
    query = {}


def _jax_server_payloads(fleet):
    srv = jserver.OpenAIServer(llm_engine=fleet)
    health = json.loads(asyncio.run(srv.handle_health(_Query())).text)
    metrics = json.loads(asyncio.run(srv.handle_metrics(_Query())).text)
    return health, metrics


def test_fleet_surfaces_key_sets_equal_jax():
    """FleetMetrics.snapshot(), /health's fleet and qos sections and the
    /metrics keys over a fleet of fake replicas, port against JAX."""
    fleets = {name: _fake_fleet(IMPLS[name], disagg=True)[0]
              for name in IMPLS}
    t_snap = fleets["port"].metrics.snapshot()
    j_snap = fleets["jax"].metrics.snapshot()
    assert set(t_snap) == set(j_snap)
    j_health, j_metrics = _jax_server_payloads(fleets["jax"])
    app = OpenAIServer(llm_engine=fleets["port"])
    status, t_health = app.health()
    assert status == 200
    assert t_health["fleet"] == j_health["fleet"]
    assert t_health["qos"] == j_health["qos"]
    assert set(app.metrics()[1]) == set(j_metrics)


def test_single_engine_surfaces_cover_jax_keys():
    """One engine: /metrics carries every JAX key (compiled plan variants
    included: always 0 on the eager engine), and /health has the
    always-present fleet and qos sections."""
    j = set(jeng_mod.EngineMetrics().snapshot())
    t = set(teng_mod.EngineMetrics().snapshot())
    assert j - t == set()
    assert teng_mod.EngineMetrics().snapshot()["plan_variants_compiled"] == 0
    srv = jserver.OpenAIServer()
    j_health = json.loads(asyncio.run(srv.handle_health(_Query())).text)
    _, t_health = OpenAIServer().health()
    assert t_health["fleet"] == j_health["fleet"] == {
        "enabled": False, "replicas": {}}
    assert t_health["qos"] == j_health["qos"]


# -- end to end on the tiny model ---------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(vocab_size=VOCAB)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    tparams = convert.llama_params_from_numpy(np_tree, "cpu", torch.float32)
    q8 = quantize_llama_params(convert.llama_params_from_numpy(
        np_tree, "cpu", torch.float32), "cpu")
    return jcfg, jparams, tl.LlamaConfig.tiny(vocab_size=VOCAB), tparams, q8


_GREEDY = {}


def _greedy(models, prompt, n_new):
    key = (tuple(prompt), n_new)
    if key not in _GREEDY:
        jcfg, jparams = models[:2]
        out = jl.greedy_generate(jparams, jcfg,
                                 jnp.asarray([prompt], jnp.int32), n_new,
                                 use_pallas=False)
        toks = np.asarray(out)[0, len(prompt):].tolist()
        eos = ByteTokenizer().eos_id
        _GREEDY[key] = toks[:toks.index(eos) + 1] if eos in toks else toks
    return _GREEDY[key]


def _engine(models, kind="float32", **kw):
    _, _, tcfg, tparams, q8 = models
    cfg = {**ECFG, "kv_dtype": kind, **kw}
    if kind == "int8":
        cfg.update(quantize_weights="int8", page_size=16)
    return LLMEngine(q8 if kind == "int8" else tparams, tcfg,
                     ByteTokenizer(), cfg, device="cpu")


def _fleet(models, n=2, kind="float32", roles=None, **kw):
    engines = [_engine(models, kind) for _ in range(n)]
    reps = [tfleet.LocalReplica(f"r{i}", e) for i, e in enumerate(engines)]
    return tfleet.EngineFleet(reps, ByteTokenizer(),
                              engines[0].pool.page_size,
                              replica_roles=roles, **kw).start(), engines


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, 20 + 7 * i).tolist() for i in range(n)]


def test_nthread_streams_equal_single_engine_and_jax(models):
    prompts = _prompts(6)
    single = _engine(models).start()
    try:
        want = [run_one(single, p) for p in prompts]
    finally:
        single.stop()
    assert want == [_greedy(models, p, 8) for p in prompts]
    fleet, engines = _fleet(models)
    try:
        got = [None] * len(prompts)
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, run_one(fleet, prompts[i]))) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert got == want
        snap = fleet.metrics.snapshot()
        assert snap["router_requests"] == len(prompts)
        assert all(v == 0 for v in snap["router_queue_depth"].values())
        assert all(e.metrics.tokens_out > 0 for e in engines)
    finally:
        fleet.stop()


def test_conversation_turn_hits_the_replica_with_its_kv(models):
    fleet, engines = _fleet(models)
    try:
        turn1 = [11] * 40
        out1 = run_one(fleet, turn1, session="s1")
        run_one(fleet, turn1 + out1 + [13] * 8, session="s1")
        snap = fleet.metrics.snapshot()
        assert snap["router_prefix_hits"] >= 1
        assert snap["router_hit_tokens"] >= 40
        assert sum(e.metrics.prefix_hits for e in engines) == 1
        assert snap["prefix_hits"] == 1
    finally:
        fleet.stop()


def test_drain_evict_requeue_and_restore(models):
    fleet, engines = _fleet(models, router_policy="round_robin",
                            health_fail_threshold=1)
    try:
        # Graceful drain: the stream in flight finishes whole.
        req = GenRequest(prompt_ids=[9] * 24, max_new_tokens=32)
        fleet.submit(req)
        rid = next(r for r, d in fleet.router.queue_depths().items() if d)
        assert fleet.drain(rid, timeout_s=120.0)
        toks, reason = collect(req, timeout=5)
        assert len(toks) == 32 and reason == "length"
        assert fleet.fleet_health()["replicas"][rid]["state"] == "drained"
        fleet.restore(rid)
        # A request queued on a dead engine is requeued to the survivor
        # (tier kept) and purged, so restore() cannot replay it.
        engines[0].stop()
        reqs = [GenRequest(prompt_ids=[i + 3] * 16, max_new_tokens=6,
                           priority="batch", tenant_id="t") for i in range(2)]
        for r in reqs:
            fleet.submit(r)
        assert len(engines[0].waiting) == 1
        assert fleet.check_health()["r0"] is False
        assert not engines[0].waiting
        fleet.restore("r0")
        assert engines[0]._running and engines[0]._thread.is_alive()
        for r in reqs:
            toks, reason = collect(r)
            assert toks and reason != "error" and r.stream.empty()
            assert r.priority == "batch" and r.tenant_id == "t"
        assert fleet.metrics.snapshot()["router_requeued"] == 1
        tiers = {e["tier"] for e in engines[1].flight.snapshot_events()
                 if e["kind"] == 3}
        assert 2 in tiers  # the batch tier reached the survivor's records
    finally:
        fleet.stop()


ROUTES = {"host": {}, "device": {"disagg_device_path": True},
          "pipelined": {"disagg_pipeline": True,
                        "disagg_transfer_chunk_pages": 2}}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_two_stage_streams_equal_colocated(models, kind, route):
    """The prefill replica prefills, its pages move to the decode replica,
    which serves the prompt from the transferred prefix: the stream equals
    the single engine's (and, f32, the offline JAX greedy stream)."""
    ps = 16 if kind == "int8" else PS
    prompts = [np.random.default_rng(s).integers(1, 256, n).tolist()
               for s, n in ((1, 3 * ps + 5), (2, 40), (3, 5 * ps + 1))]
    single = _engine(models, kind).start()
    try:
        want = [run_one(single, p) for p in prompts]
    finally:
        single.stop()
    if kind == "float32":
        assert want == [_greedy(models, p, 8) for p in prompts]
    fleet, engines = _fleet(models, kind=kind,
                            roles={"r0": "prefill", "r1": "decode"},
                            disagg=True, **ROUTES[route])
    try:
        got = [run_one(fleet, p) for p in prompts]
        fleet._disagg_transfer.drain(timeout_s=30)
        assert got == want
        snap = fleet.metrics.snapshot()
        assert snap["disagg_requests"] == len(prompts)
        assert snap["disagg_fallbacks"] == 0
        assert snap["disagg_device_fallbacks"] == 0
        assert snap["kv_transfer_pages"] > 0
        assert (snap["kv_transfer_device_pages"] > 0) == (route == "device")
        assert engines[1].metrics.prefix_hits == len(prompts)
        assert engines[0].metrics.tokens_out == len(prompts)
        health = fleet.fleet_health()
        assert health["disagg"]["enabled"] is True
        assert health["replicas"]["r0"]["role"] == "prefill"
    finally:
        fleet.stop()


def test_transfer_failure_falls_back_on_the_same_stream(models):
    prompt = [9] * 24
    want = _greedy(models, prompt, 8)
    fleet, engines = _fleet(models, roles={"r0": "prefill", "r1": "decode"},
                            disagg=True)

    def broken(ids, codes, scales, timeout_s=60.0, first_page=0):
        raise RuntimeError("injected transfer fault")

    fleet._by_rid["r1"].import_kv_pages = broken
    try:
        assert run_one(fleet, prompt) == want
        snap = fleet.metrics.snapshot()
        assert snap["disagg_fallbacks"] == 1
        assert snap["kv_transfer_pages"] == 0
    finally:
        fleet.stop()


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_pipelined_one_page_windows_admit_early(models, kind):
    """JAX's tests/test_disagg.py pipelined case on the port: 1-page
    windows, so the decode replica admits before the last window lands
    (early admits counted, more transfer windows than plans, no
    fallback). f32 and int8 streams equal the single engine's (f32: and
    the offline JAX greedy oracle). A bf16 pool rounds the k/v a hit
    reads back, so a bf16 stream follows the length of the hit it took:
    it equals a single engine that took the same hit (the same holds for
    any bf16 prefix hit, and in the JAX engine)."""
    ps = 16 if kind == "int8" else PS
    prompts = [[(7 * i + j) % 250 + 1 for j in range(3 * ps + 2 * i)]
               for i in range(3)]
    single = _engine(models, kind).start()
    try:
        want = [run_one(single, p) for p in prompts]
    finally:
        single.stop()
    if kind == "float32":
        assert want == [_greedy(models, p, 8) for p in prompts]
    fleet, engines = _fleet(models, kind=kind,
                            roles={"r0": "prefill", "r1": "decode"},
                            disagg=True, disagg_pipeline=True,
                            disagg_transfer_chunk_pages=1)
    hits = []
    try:
        got = []
        for p in prompts:
            before = engines[1].metrics.prefix_hit_tokens
            got.append(run_one(fleet, p))
            hits.append(engines[1].metrics.prefix_hit_tokens - before)
        fleet._disagg_transfer.drain(timeout_s=30)
        snap = fleet.metrics.snapshot()
        assert snap["router_disagg_plans"] == len(prompts)
        assert snap["kv_transfer_chunks"] > snap["router_disagg_plans"]
        assert snap["disagg_early_admits"] > 0
        assert snap["disagg_fallbacks"] == 0
        assert snap["disagg_transfer_ms"] > 0
        assert engines[1].metrics.prefix_hits == len(prompts)
    finally:
        fleet.stop()
    if kind != "bfloat16":
        assert got == want
        return
    for p, hit, stream in zip(prompts, hits, got):
        ref = _engine(models, kind).start()
        try:
            # Cache the hit's full pages. Where every page landed before
            # the admit, the hit is the whole prompt but its last token.
            whole = hit == len(p) - 1
            run_one(ref, p if whole else p[:hit] + [1])
            assert run_one(ref, p) == stream
            assert ref.metrics.prefix_hit_tokens == hit
        finally:
            ref.stop()


def test_min_prompt_tokens_keeps_shorts_on_the_decode_pool(models):
    fleet, engines = _fleet(models, roles={"r0": "prefill", "r1": "decode"},
                            disagg=True, disagg_min_prompt_tokens=64)
    try:
        assert run_one(fleet, [4] * 24)
        snap = fleet.metrics.snapshot()
        assert snap["router_disagg_plans"] == 0
        assert engines[0].metrics.tokens_out == 0
        assert engines[1].metrics.tokens_out > 0
    finally:
        fleet.stop()


def test_fleet_timeline_has_a_lane_per_replica_and_the_control_lane(
        models):
    fleet, engines = _fleet(models)
    try:
        run_one(fleet, [5] * 12)
        lanes = OpenAIServer(fleet)._flight_lanes()
        assert set(lanes) == {"r0", "r1", "fleet"}
        status, trace = OpenAIServer(fleet).timeline()
        names = {e["args"]["name"] for e in trace["traceEvents"]
                 if e.get("ph") == "M" and e["name"] == "process_name"}
        assert {"replica r0", "replica r1", "replica fleet"} <= names
    finally:
        fleet.stop()


# -- HTTP: process replicas and the JAX package's client ----------------------


def _serve(app):
    httpd = make_http_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def test_jax_http_replica_client_talks_to_port_servers(models):
    """The JAX package's HttpReplica (pure HTTP, no JAX engine) exports
    pages from one port server and imports them into another, and its
    SSE proxy streams a port server's completion through a JAX fleet."""
    a, b = _engine(models, "bfloat16").start(), _engine(
        models, "bfloat16").start()
    (ha, url_a), (hb, url_b) = _serve(OpenAIServer(a)), _serve(
        OpenAIServer(b))
    try:
        prompt = np.random.default_rng(7).integers(1, 256, 4 * PS + 3)
        prompt = prompt.tolist()
        want = run_one(a, prompt)
        codes, scales, n_tok = jfleet.HttpReplica("a", url_a).export_kv_pages(
            prompt)
        local, _, n_local = a.export_prefix_pages(prompt)
        assert n_tok == n_local == 4 * PS and scales is None
        assert str(codes.dtype) == "bfloat16"
        assert np.array_equal(codes.view(np.int16),
                              local.view(torch.int16).numpy())
        assert jfleet.HttpReplica("b", url_b).import_kv_pages(
            prompt[:n_tok], codes, scales) == 4
        assert run_one(b, prompt) == want
        assert b.metrics.prefix_hits == 1
        jf = jfleet.EngineFleet([jfleet.HttpReplica("h0", url_b)], JTok(), PS)
        req = jeng_mod.GenRequest(prompt_ids=prompt, max_new_tokens=8)
        jf.submit(req)
        # The proxy forwards text chunks (token id 0 each) and the finish.
        _, reason = collect(req)
        assert reason == "length"
    finally:
        for h in (ha, hb):
            h.shutdown()
            h.server_close()
        a.stop()
        b.stop()


def test_process_replica_over_a_spawned_port_server(models, tmp_path):
    env = {"APP_ENGINE_PREFIXCACHE": "true", "APP_ENGINE_PAGESIZE": "8",
           "APP_ENGINE_MAXSEQLEN": "256", "APP_ENGINE_MAXBATCHSIZE": "2",
           "APP_ENGINE_PREFILLBUCKETS": "[16, 64]",
           "APP_ENGINE_DTYPE": "float32", "APP_ENGINE_KVDTYPE": "float32",
           "PYTHONPATH": os.path.dirname(os.path.dirname(
               os.path.abspath(__file__)))}
    rep = tfleet.spawn_process_replica("p0", model_size="tiny",
                                       device="cpu", env=env, warm=False,
                                       ready_timeout_s=240.0)
    try:
        assert rep.healthy()
        fleet = tfleet.EngineFleet([rep], ByteTokenizer(), PS).start()
        req = GenRequest(prompt_ids=[5, 6, 7, 8] * 5, max_new_tokens=6)
        fleet.submit(req)
        toks, reason = collect(req)
        assert reason == "length" and toks
        assert fleet.metrics.snapshot()["per_replica"]["p0"][
            "tokens_generated"] == 6
    finally:
        rep.stop()
    assert rep.proc.poll() is not None
    assert rep.healthy() is False


# -- config --------------------------------------------------------------------


def test_config_file_fleet_section_builds_a_fleet(tmp_path):
    path = tmp_path / "deploy.yaml"
    path.write_text(yaml.safe_dump({
        "engine": {"page_size": 8, "max_seq_len": 128, "max_batch_size": 2,
                   "prefill_buckets": [16, 32], "prefix_cache": True},
        "fleet": {"replicas": 2, "replica_roles": "prefill,decode",
                  "disagg": True, "router_policy": "least_load",
                  "health_interval_s": 0.0}}))
    cfg = load_config(env={"APP_CONFIG_FILE": str(path)})
    assert cfg.fleet.replicas == 2 and cfg.fleet.disagg
    llm = build_llm(cfg, "tiny", "cpu", warmup=False)
    try:
        assert isinstance(llm, tfleet.EngineFleet)
        assert [r.rid for r in llm.replicas] == ["r0", "r1"]
        assert llm.router.roles() == {"r0": "prefill", "r1": "decode"}
        assert llm.router.policy == "least_load" and llm.disagg
        e0, e1 = (r.engine for r in llm.replicas)
        assert e0.params is e1.params and e0.pool is not e1.pool
        req = GenRequest(prompt_ids=[3] * 20, max_new_tokens=4)
        llm.submit(req)
        assert collect(req)[1] == "length"
    finally:
        llm.stop()
    # replicas 0 + URLs: a router-only process, no engine.
    cfg = load_config(env={"APP_FLEET_REPLICAS": "0",
                           "APP_FLEET_REPLICAURLS": "http://127.0.0.1:9"})
    llm = build_llm(cfg, "tiny", "cpu", warmup=False)
    try:
        assert [r.rid for r in llm.replicas] == ["h0"]
        assert llm.device is None and llm.ecfg is None
        status, body = OpenAIServer(llm).kv_export({"prompt": [1, 2]})
        assert status == 501
    finally:
        llm.stop()


def test_launch_counts_are_exact_under_concurrent_threads(monkeypatch):
    """Fleet replicas launch from their own scheduler threads: LAUNCHES
    counts every launch (the count is taken under a lock)."""
    from generativeaiexamples_tpu_torch import kernels

    monkeypatch.setitem(kernels._FUNCS, "paged_attention", lambda *a: 0)
    monkeypatch.setattr(kernels, "LAUNCHES", dict(kernels.LAUNCHES))
    kernels.reset_launches()

    def hammer():
        for _ in range(20000):
            kernels.launch("paged_attention")

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert kernels.LAUNCHES["paged_attention"] == 80000


def test_rolling_upgrade_swaps_every_engine_and_writes_its_lane(models):
    """rolling_upgrade swaps each local replica's engine in turn (drain,
    swap, restore) with no failed stream; the fleet's control lane gets
    one EV_UPGRADE a replica and the new engines serve."""
    fleet, engines = _fleet(models)
    try:
        prompt = [7] * 20
        want = run_one(fleet, prompt)
        made = []

        def factory(old):
            made.append(_engine(models))
            return made[-1]

        out = fleet.rolling_upgrade(factory, drain_timeout_s=30.0)
        assert out["replicas_rolled"] == 2 and out["failed_streams"] == 0
        assert [r.engine for r in fleet.replicas] == made
        assert all(e._running for e in made)
        ups = [e for e in fleet.control_flight.snapshot_events()
               if e["kind"] == 16]
        assert [e["aux"] for e in ups] == ["r0", "r1"]
        assert run_one(fleet, prompt) == want
        snap = fleet.metrics.snapshot()
        assert snap["upgrade_rolls"] == 1
        assert snap["upgrade_replicas_rolled"] == 2
    finally:
        fleet.stop()
        for e in engines:
            e.stop()


def test_rolling_upgrade_never_starts_a_half_warmed_engine(models,
                                                           monkeypatch):
    """A warmup that fails in a rolling upgrade (here a CUDA graph
    capture, made to raise) reaches the caller: the replica whose new
    engine it was leaves placement evicted and unstarted, and the
    fleet serves on the replica the roll had not reached."""
    from generativeaiexamples_tpu_torch.serving import step_graphs

    def boom(self, plan, flags):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(step_graphs.StepGraphs, "capture", boom)
    fleet, engines = _fleet(models)
    try:
        prompt = [7] * 20
        want = run_one(fleet, prompt)
        made = []

        def factory(old):
            e = _engine(models)
            # The captured lattice of a warmed CUDA engine, on the CPU.
            e._graphs = object.__new__(step_graphs.StepGraphs)
            made.append(e)
            return e

        with pytest.raises(RuntimeError, match="capture failed"):
            fleet.rolling_upgrade(factory, drain_timeout_s=30.0,
                                  warmup=True)
        assert len(made) == 1 and not made[0]._running
        assert fleet.replicas[0].state == "evicted"
        assert fleet.replicas[1].engine is engines[1]
        assert run_one(fleet, prompt) == want
    finally:
        fleet.stop()
        for e in engines:
            e.stop()
