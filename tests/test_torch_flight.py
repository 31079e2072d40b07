"""Port parity: the flight recorder (serving/flight.py), the engine's
latency histograms and the server's timeline and Prometheus routes.

The port's flight.py is its own copy of the JAX module (pure numpy). The
same observe / record_beat / record_event calls go to both; histogram
snapshots, quantiles, merges, the Chrome trace JSON, the Prometheus text
and the plan labels must be EQUAL (exact: both are the same float64 and
string arithmetic). The ring tests mirror tests/test_flight.py's. The
engine tests drive the port's engine inline through `_land_next_block`
(the beat writer), as the JAX tests drive theirs; no JAX `LLMEngine` is
built. `ttft_p50_ms` / `ttft_p95_ms` are read from the TTFT histogram as
the JAX engine reads them (before, the port took an order statistic of a
sliding window: 30 / 40 ms on TTFTs of 10, 20, 30 and 40 ms where JAX
reads 20.48 / 39.76).
"""

import json
import os
import sys
import threading
import urllib.request

import numpy as np
import pytest
from test_torch_fused_prefill import (
    LONG_PROMPT, _engine, _ids, _idle, _jax_greedy)

from generativeaiexamples_tpu.serving import flight as jf
from generativeaiexamples_tpu.serving import qos as jqos
from generativeaiexamples_tpu.serving.engine import (
    EngineMetrics as JEngineMetrics)
from generativeaiexamples_tpu_torch.serving import flight as tf
from generativeaiexamples_tpu_torch.serving.engine import (
    EngineMetrics, GenRequest)
from generativeaiexamples_tpu_torch.serving.openai_server import (
    OpenAIServer, make_http_server)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from scripts.analyze_timeline import analyze  # noqa: E402


def _beat_kwargs(i: float):
    return dict(t_dispatch=i, t_ready=i + 0.5, t_prev_ready=i - 0.5,
                decode_k=2, spec_k=0, tree_branches=0, rider_width=0,
                rider_s_total=0, spec_state=False, fused_rider=False,
                qos_paused=False, busy=(0, 1, 0), wait=(0, 0, 0),
                tokens_emitted=3, kv_demote_pages=0, kv_promote_pages=0)


# -- the module against JAX's -----------------------------------------------


def test_schema_constants_equal_jax():
    for name in ("EVENT_NAMES", "RETIRE_CODES", "RETIRE_NAMES",
                 "GAP_CAUSE_KINDS", "FLEET_INSTANT_KINDS", "FLIGHT_KEYS",
                 "HIST_KEYS", "TID_BEATS", "TID_SCHED", "TID_REQ_BASE"):
        assert getattr(tf, name) == getattr(jf, name), name
    for name in [n for n in dir(jf) if n.startswith("EV_")]:
        assert getattr(tf, name) == getattr(jf, name), name
    assert tf.BEAT_DTYPE == jf.BEAT_DTYPE
    assert tf.EVENT_DTYPE == jf.EVENT_DTYPE
    assert tf.default_bounds() == jf.default_bounds()
    assert tf.TIERS == jqos.TIERS
    assert tf.TIER_STANDARD == jqos.tier_id("standard")
    assert tf.zero_hist_snapshot() == jf.zero_hist_snapshot()


def _samples(seed):
    rng = np.random.default_rng(seed)
    vals = rng.lognormal(mean=3.0, sigma=2.0, size=600).tolist()
    # The edges: below the first bound, on a bound, past the last one.
    return vals + [0.0, 0.005, 0.01, 1.0, 6e7, 1e9]


@pytest.mark.parametrize("seed", [0, 1])
def test_histograms_quantiles_and_merge_equal_jax(seed):
    th, jh = tf.ExpHistogram(), jf.ExpHistogram()
    for v in _samples(seed):
        th.observe(v)
        jh.observe(v)
    ts, js = th.snapshot(), jh.snapshot()
    assert ts == js
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert tf.hist_quantile(ts, q) == jf.hist_quantile(js, q)
    other = tf.ExpHistogram()
    for v in _samples(seed + 10)[:50]:
        other.observe(v)
    # JSON round trip, a foreign shape and None entries merge alike.
    parts = [json.loads(json.dumps(ts)), other.snapshot(), None,
             {"count": 3, "sum": 1.0, "buckets": {}}]
    assert tf.merge_hist_snapshots(parts) == jf.merge_hist_snapshots(parts)


def _fill(mod):
    """The same record calls into one recorder of module `mod`: two
    requests (one with a rider prefill and a trace id), beats of every
    lattice kind, gap causes and a lapped event ring."""
    rec = mod.FlightRecorder(ring_size=64)
    t = 1000.0
    rec.record_event(mod.EV_SUBMIT, t, rid="req-a", tier=1, a=3.0)
    rec.record_event(mod.EV_ADMIT, t + 0.002, rid="req-a", slot=0, a=2.0)
    rec.record_event(mod.EV_PREFILL_DISPATCH, t + 0.003, rid="req-a",
                     slot=0, a=3.0)
    rec.record_event(mod.EV_SUBMIT, t + 0.01, rid="req-b", a=200.0)
    rec.record_event(mod.EV_ADMIT, t + 0.011, rid="req-b", slot=1, a=1.0)
    plans = [(2, 0, 0, 0, False), (2, 2, 0, 16, False), (1, 2, 3, 16, False),
             (2, 0, 0, 0, True), (0, 0, 0, 16, False), (8, 3, 4, 512, False)]
    for i in range(70):
        k, sk, tb, rw, ss = plans[i % len(plans)]
        lo = t + 0.02 + i * 0.01
        rec.record_beat(t_dispatch=lo, t_ready=lo + 0.007,
                        t_prev_ready=lo - 0.003 if i else 0.0, decode_k=k,
                        spec_k=sk, tree_branches=tb, rider_width=rw,
                        rider_s_total=rw * 4, spec_state=ss,
                        fused_rider=bool(rw), qos_paused=False,
                        busy=(0, 2, 0), wait=(0, i % 3, 0),
                        tokens_emitted=k, kv_demote_pages=i % 2,
                        kv_promote_pages=0)
        if i % 7 == 3:
            rec.record_event(mod.EV_PREFILL_CHUNK, lo + 0.008, rid="req-b",
                             a=16.0, b=1.0)
    rec.record_event(mod.EV_KV_PROMOTE, t + 0.3, a=4.0, b=2.5)
    rec.record_event(mod.EV_KV_DEMOTE, t + 0.31, a=2.0)
    rec.record_event(mod.EV_ADMIT_RETRY, t + 0.32, rid="req-c", a=1.0)
    rec.record_event(mod.EV_FIRST_TOKEN, t + 0.05, rid="req-a", a=50.0)
    rec.record_event(mod.EV_FIRST_TOKEN, t + 0.6, rid="req-b", a=590.0)
    rec.record_event(mod.EV_RETIRE, t + 0.7, rid="req-a", code=1, a=8.0,
                     b=700.0, aux="ab" * 16)
    rec.record_event(mod.EV_RETIRE, t + 0.72, rid="req-b", code=0, a=4.0,
                     b=710.0)
    return rec


def test_chrome_trace_equals_jax_and_nests():
    ours = json.dumps(tf.chrome_trace({"engine": _fill(tf)}), sort_keys=True)
    theirs = json.dumps(jf.chrome_trace({"engine": _fill(jf)}),
                        sort_keys=True)
    assert ours == theirs
    trace = json.loads(ours)
    assert tf.spans_nest(trace) and jf.spans_nest(trace)
    names = {e["name"] for e in trace["traceEvents"]}
    assert "decode K=2 spec k=2 rider W=16" in names
    assert "decode K=1 spec k=2 tree=3 rider W=16" in names
    # The snapshots themselves match too (beats: every field).
    assert (_fill(tf).snapshot_beats() == _fill(jf).snapshot_beats()).all()
    assert _fill(tf).snapshot_events() == _fill(jf).snapshot_events()
    assert _fill(tf).stats() == _fill(jf).stats()


def test_spans_nest_agrees_with_jax_on_a_broken_trace():
    trace = tf.chrome_trace({"engine": _fill(tf)})
    bad = json.loads(json.dumps(trace))
    beat = next(e for e in bad["traceEvents"] if e.get("cat") == "beat")
    # Starts inside a beat slice and ends past it: overlap, no nesting.
    bad["traceEvents"].append({"name": "x", "ph": "X", "pid": 0, "tid": 0,
                               "ts": beat["ts"] + beat["dur"] / 2,
                               "dur": beat["dur"]})
    assert tf.spans_nest(bad) is False
    assert jf.spans_nest(bad) is False


def test_prometheus_text_equals_jax():
    th = tf.ExpHistogram()
    for v in _samples(3)[:40]:
        th.observe(v)
    snap = {"tokens_generated": 42, "tokens_per_sec": 1.5,
            "flight_enabled": True, "ttft_p50_ms": None,
            "queue": {"latency": 1, "batch": 0, "flag": True},
            "hist_ttft_ms": th.snapshot(),
            "hist_e2e_ms": tf.zero_hist_snapshot(),
            "per_replica": {"r0": {"nested": {}}}, "name": "x"}
    assert tf.prometheus_text(snap) == jf.prometheus_text(snap)
    assert tf.prometheus_text(snap, prefix="app") == jf.prometheus_text(
        snap, prefix="app")


def test_plan_labels_equal_jax():
    for args in [(k, sk, tb, rw, ss) for k in (0, 1, 8) for sk in (0, 3)
                 for tb in (0, 1, 4) for rw in (0, 512)
                 for ss in (False, True)]:
        assert tf.plan_label(*args) == jf.plan_label(*args), args
    assert tf.plan_label(2, 3, 4, 512, False) == \
        "decode K=2 spec k=3 tree=4 rider W=512"


# -- the rings (tests/test_flight.py's TestRing) ------------------------------


class TestRing:
    def test_wrap_keeps_last_ring_size_records_in_order(self):
        rec = tf.FlightRecorder(ring_size=64)
        for i in range(3 * 64 + 7):
            rec.record_beat(**_beat_kwargs(float(i)))
        beats = rec.snapshot_beats()
        assert len(beats) == 64
        assert beats["seq"].tolist() == list(range(3 * 64 + 7 - 64,
                                                   3 * 64 + 7))
        assert rec.stats()["flight_beats"] == 3 * 64 + 7

    def test_event_ring_wrap_and_rid_slots(self):
        rec = tf.FlightRecorder(ring_size=64)  # event ring = 256
        for i in range(300):
            rec.record_event(tf.EV_SUBMIT, float(i), rid=f"r{i}")
        evs = rec.snapshot_events()
        assert len(evs) == 256
        assert evs[0]["rid"] == "r44" and evs[-1]["rid"] == "r299"
        assert evs[-1]["seq"] == 299

    def test_disabled_recorder_records_nothing_but_stats_present(self):
        rec = tf.FlightRecorder(ring_size=64, enabled=False)
        rec.record_beat(**_beat_kwargs(1.0))
        rec.record_event(tf.EV_SUBMIT, 1.0, rid="x")
        assert len(rec.snapshot_beats()) == 0
        assert rec.snapshot_events() == []
        assert rec.stats() == {"flight_beats": 0, "flight_events": 0,
                               "flight_enabled": 0}

    def test_runtime_toggle(self):
        rec = tf.FlightRecorder(ring_size=64, enabled=False)
        rec.set_enabled(True)
        rec.record_beat(**_beat_kwargs(1.0))
        assert rec.stats()["flight_beats"] == 1
        rec.set_enabled(False)
        rec.record_beat(**_beat_kwargs(2.0))
        assert rec.stats()["flight_beats"] == 1

    def test_single_writer_reader_race_yields_only_valid_rows(self):
        """Readers snapshotting during live writes never see a torn row:
        seqs strictly increasing, fields of one record coherent, and an
        event's rid belongs to its own seq."""
        rec = tf.FlightRecorder(ring_size=64)
        stop = threading.Event()
        errors = []

        def writer():
            i = 0
            while not stop.is_set():
                rec.record_beat(**_beat_kwargs(float(i)))
                rec.record_event(tf.EV_SUBMIT, float(i), rid=f"r{i}")
                i += 1

        def reader():
            try:
                for _ in range(300):
                    beats = rec.snapshot_beats()
                    seqs = beats["seq"].tolist()
                    assert seqs == sorted(seqs)
                    assert len(set(seqs)) == len(seqs)
                    assert np.allclose(beats["t_ready"],
                                       beats["t_dispatch"] + 0.5)
                    for ev in rec.snapshot_events():
                        assert ev["rid"] == f"r{ev['seq']}"
            except Exception as e:  # surfaced on the main thread
                errors.append(e)

        w = threading.Thread(target=writer)
        rs = [threading.Thread(target=reader) for _ in range(2)]
        w.start()
        for r in rs:
            r.start()
        for r in rs:
            r.join()
        stop.set()
        w.join()
        assert not errors, errors


# -- the TTFT percentiles (the repair) ----------------------------------------


@pytest.mark.parametrize("ttfts", [
    [10.0, 20.0, 30.0, 40.0],
    np.random.default_rng(7).lognormal(4.0, 1.0, 500).tolist()],
    ids=["four", "seeded"])
def test_ttft_percentiles_equal_jax(ttfts):
    ours, theirs = EngineMetrics(), JEngineMetrics()
    hist = jf.ExpHistogram()
    for ms in ttfts:
        ours.record_ttft(ms)
        theirs.record_ttft(ms)
        hist.observe(ms)
    snap, jsnap = ours.snapshot(), theirs.snapshot()
    want = hist.snapshot()
    assert snap["ttft_p50_ms"] == jsnap["ttft_p50_ms"] == want["p50"]
    assert snap["ttft_p95_ms"] == jsnap["ttft_p95_ms"] == want["p95"]
    assert snap["hist_ttft_ms"] == jsnap["hist_ttft_ms"]
    assert ours.last_ttft_ms == ttfts[-1]
    if len(ttfts) == 4:
        assert (snap["ttft_p50_ms"], snap["ttft_p95_ms"]) == (20.48, 39.7603)


def test_snapshot_keys_include_jax_flight_and_hist_keys():
    snap = EngineMetrics().snapshot()
    assert snap["ttft_p50_ms"] is None and snap["ttft_p95_ms"] is None
    for key in jf.FLIGHT_KEYS:
        assert snap[key] == 0
    for key in jf.HIST_KEYS:
        assert snap[key] == jf.zero_hist_snapshot()


# -- the engine's recorder ------------------------------------------------------


def _drive(eng, reqs, max_iters=600):
    """Inline scheduler iterations through `_land_next_block` (the beat
    writer); each request in `reqs` is (beats to wait, request). Returns
    the number of landed blocks."""
    landed = 0
    pending = list(reqs)
    for i in range(max_iters):
        while pending and pending[0][0] <= i:
            eng.submit(pending.pop(0)[1])
        eng._admit_waiting()
        eng._advance_long_prefills()
        eng._emit_ready_first_tokens()
        while (len(eng._inflight) < eng.pipeline_depth
               and any(s is not None for s in eng.slots)):
            if not eng._dispatch_decode():
                break
        if eng._inflight:
            eng._land_next_block()
            landed += 1
        if not pending and _idle(eng):
            return landed
    raise AssertionError("engine did not go idle")


def _composed(recorder=True, **kw):
    """A short stream and, two beats in, the 200-token prompt on a
    speculative engine with composed plans."""
    eng = _engine(speculative_k=2, fused_prefill=True, step_plans=True,
                  decode_steps_per_dispatch=2, flight_recorder=recorder,
                  **kw)
    short = GenRequest(prompt_ids=[5, 6, 7], max_new_tokens=120)
    long_req = GenRequest(prompt_ids=list(LONG_PROMPT), max_new_tokens=4)
    landed = _drive(eng, [(0, short), (2, long_req)])
    return eng, short, long_req, landed


def _kinds_by_rid(eng):
    out = {}
    for ev in eng.flight.snapshot_events():
        out.setdefault(ev["rid"], []).append(ev)
    return out


class TestEngineRecorder:
    def test_beats_events_and_histograms(self):
        eng, short, long_req, landed = _composed()
        snap = eng.metrics.snapshot()
        assert snap["flight_enabled"] == 1
        assert snap["flight_beats"] == landed >= 1
        beats = eng.flight.snapshot_beats()
        assert len(beats) == landed
        assert (beats["t_ready"] >= beats["t_dispatch"]).all()
        labels = {tf.plan_label(int(b["decode_k"]), int(b["spec_k"]),
                                int(b["tree_branches"]),
                                int(b["rider_width"]), bool(b["spec_state"]))
                  for b in beats}
        assert "decode K=2 spec k=2 rider W=16" in labels
        assert int(beats["fused_rider"].sum()) == 13
        # Tokens emitted at landings; a prefill-sampled first token may
        # reach its stream outside a beat (two requests: at most 2).
        emitted = int(beats["tokens_emitted"].sum())
        assert snap["tokens_generated"] - 2 <= emitted \
            <= snap["tokens_generated"]
        by_rid = _kinds_by_rid(eng)
        E = tf
        assert [e["kind"] for e in by_rid[short.request_id]] == [
            E.EV_SUBMIT, E.EV_ADMIT, E.EV_PREFILL_DISPATCH,
            E.EV_FIRST_TOKEN, E.EV_RETIRE]
        long_evs = by_rid[long_req.request_id]
        assert [e["kind"] for e in long_evs] == (
            [E.EV_SUBMIT, E.EV_ADMIT] + [E.EV_PREFILL_CHUNK] * 13
            + [E.EV_FIRST_TOKEN, E.EV_RETIRE])
        chunks = [e for e in long_evs if e["kind"] == E.EV_PREFILL_CHUNK]
        assert all(e["b"] == 1.0 for e in chunks)  # every chunk rode
        assert sum(e["a"] for e in chunks) == 200
        retire = long_evs[-1]
        assert retire["code"] == tf.RETIRE_CODES["length"]
        assert retire["a"] == 4.0
        assert all(e["tier"] == tf.TIER_STANDARD for e in long_evs)
        for key, n in (("hist_ttft_ms", 2), ("hist_e2e_ms", 2),
                       ("hist_queue_wait_ms_standard", 2),
                       ("hist_beat_gap_ms", landed - 1)):
            assert snap[key]["count"] == n, key
        assert snap["hist_queue_wait_ms_latency"]["count"] == 0
        assert snap["ttft_p50_ms"] == snap["hist_ttft_ms"]["p50"]

    def test_lane_chunks_are_not_riders(self):
        """Plans off: the chunked lane feeds the prompt, b = 0."""
        eng = _engine(speculative_k=2, fused_prefill=True,
                      decode_steps_per_dispatch=2)
        long_req = GenRequest(prompt_ids=list(LONG_PROMPT), max_new_tokens=4)
        _drive(eng, [(0, GenRequest(prompt_ids=[5, 6, 7],
                                    max_new_tokens=40)), (2, long_req)])
        chunks = [e for e in _kinds_by_rid(eng)[long_req.request_id]
                  if e["kind"] == tf.EV_PREFILL_CHUNK]
        assert chunks and all(e["b"] == 0.0 for e in chunks)
        assert not eng.flight.snapshot_beats()["fused_rider"].any()

    def test_recorder_off_zeros_keys_present_streams_identical(self):
        on, s_on, l_on, _ = _composed(recorder=True)
        off, s_off, l_off, _ = _composed(recorder=False)
        short = _ids(s_on)
        assert short == _ids(s_off) and len(short) == 120
        assert _ids(l_on) == _ids(l_off) == _jax_greedy(LONG_PROMPT, 4)
        snap = off.metrics.snapshot()
        for key in tf.FLIGHT_KEYS:
            assert snap[key] == 0, key
        assert len(off.flight.snapshot_beats()) == 0
        assert off.flight.snapshot_events() == []
        # The histograms are metrics, not the ring: still live.
        assert snap["hist_ttft_ms"]["count"] == 2
        assert set(jf.HIST_KEYS) <= set(snap)

    def test_timeline_analyzer_attribution_is_complete(self):
        eng, _, _, _ = _composed()
        trace = json.loads(json.dumps(tf.chrome_trace({"engine":
                                                       eng.flight})))
        assert tf.spans_nest(trace)
        rep = analyze(trace, host_gap_ms=50.0)
        assert rep["overall"]["attributed_pct"] == pytest.approx(100.0,
                                                                 abs=0.5)
        cats = rep["overall"]["categories"]
        assert cats["device_busy"]["ms"] > 0
        # The JAX renderer gives the same JSON on the same rows.
        mirror = jf.FlightRecorder(ring_size=eng.flight.ring_size)
        for b in eng.flight.snapshot_beats():
            mirror.record_beat(
                **{f: b[f].item() for f in (
                    "t_dispatch", "t_ready", "t_prev_ready", "decode_k",
                    "spec_k", "tree_branches", "rider_width",
                    "rider_s_total", "spec_state", "fused_rider",
                    "qos_paused", "tokens_emitted", "kv_demote_pages",
                    "kv_promote_pages")},
                busy=tuple(b[f"busy_{t}"].item() for t in jqos.TIERS),
                wait=tuple(b[f"wait_{t}"].item() for t in jqos.TIERS))
        for ev in eng.flight.snapshot_events():
            mirror.record_event(ev["kind"], ev["ts"], rid=ev["rid"],
                                tier=ev["tier"], code=ev["code"],
                                slot=ev["slot"], a=ev["a"], b=ev["b"],
                                aux=ev["aux"])
        assert json.dumps(jf.chrome_trace({"engine": mirror})) == \
            json.dumps(tf.chrome_trace({"engine": eng.flight}))


# -- the server -------------------------------------------------------------------


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, dict(r.headers), r.read().decode()


@pytest.mark.parametrize("recorder", [True, False], ids=["on", "off"])
def test_server_timeline_prometheus_and_health(recorder):
    eng = _engine(flight_recorder=recorder).start()
    app = OpenAIServer(llm_engine=eng)
    httpd = make_http_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        got = [e["token_id"] for e in eng.generate_stream([5, 6, 7],
                                                          max_new_tokens=6)
               if e["token_id"] >= 0]
        assert len(got) == 6
        status, _, body = _get(base, "/debug/timeline")
        trace = json.loads(body)
        assert status == 200 and trace["displayTimeUnit"] == "ms"
        assert tf.spans_nest(trace)
        names = {e["name"] for e in trace["traceEvents"]}
        assert ("ttft" in names) == recorder
        status, headers, text = _get(base, "/metrics?format=prometheus")
        assert status == 200
        assert headers["Content-Type"].startswith("text/plain")
        assert headers["X-Prometheus-Exposition-Version"] == "0.0.4"
        for key in jf.HIST_KEYS:
            assert f"# TYPE gaie_{key[5:]} histogram" in text, key
        assert "gaie_ttft_ms_count 1" in text
        status, _, body = _get(base, "/metrics")
        snap = json.loads(body)
        # The JAX exposition of the same JSON snapshot is the same text,
        # up to the live gauges that moved between the two scrapes.
        live = ("gaie_tokens_per_sec", "gaie_kernel_launches")
        assert [ln for ln in jf.prometheus_text(snap).splitlines()
                if not ln.startswith(live)] == [
            ln for ln in text.splitlines() if not ln.startswith(live)]
        assert set(jf.FLIGHT_KEYS) <= set(snap)
        assert snap["flight_enabled"] == int(recorder)
        status, _, body = _get(base, "/health")
        section = json.loads(body)["flight_recorder"]
        assert section == {
            "enabled": recorder, "lanes": 1, "timeline": "/debug/timeline",
            "flight_beats": snap["flight_beats"],
            "flight_events": snap["flight_events"]}
        assert (section["flight_beats"] > 0) == recorder
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.stop()


def test_health_section_without_an_engine():
    status, health = OpenAIServer().health()
    assert status == 200
    assert health["flight_recorder"] == {
        "enabled": False, "flight_beats": 0, "flight_events": 0,
        "lanes": 0, "timeline": "/debug/timeline"}
    assert OpenAIServer().timeline() == (200, tf.chrome_trace({}))


def test_pager_moves_are_recorded():
    """With the prefix cache and the pager: reclaim demotions and a
    resumed session's promotion are events (pages in `a`, promote ms in
    `b`), the beats carry the pages moved, and the promote ms a page
    histogram counts each promotion (JAX engine.py:2495-2580)."""
    import jax
    import torch

    from generativeaiexamples_tpu.models import llama as jl
    from generativeaiexamples_tpu_torch.models import convert
    from generativeaiexamples_tpu_torch.models import llama as tl
    from generativeaiexamples_tpu_torch.serving.engine import LLMEngine
    from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

    jcfg = jl.LlamaConfig.tiny(vocab_size=259)
    tparams = convert.llama_params_from_numpy(
        jax.tree.map(np.asarray, jl.init_params(jcfg,
                                                jax.random.PRNGKey(0))),
        "cpu", torch.float32)
    # One slot, 5 usable pages of 8: each 16-token prompt + 4 new tokens
    # needs 3, so the next distinct prompt demotes the last one's pages.
    eng = LLMEngine(tparams, tl.LlamaConfig.tiny(vocab_size=259),
                    ByteTokenizer(),
                    dict(max_batch_size=1, max_seq_len=32, page_size=8,
                         prefill_buckets=(16,), kv_dtype="float32",
                         decode_steps_per_dispatch=2, prefix_cache=True,
                         prefix_cache_capacity=1.0, kv_pager=True,
                         kv_host_budget_mb=4), n_pages=6,
                    device="cpu").start()
    prompts = [np.random.default_rng(s).integers(0, 256, 16).tolist()
               for s in range(4)]
    try:
        for p in prompts + prompts[:1]:
            for _ in eng.generate_stream(p, max_new_tokens=4):
                pass
        snap = eng.metrics.snapshot()
    finally:
        eng.stop()
    events = eng.flight.snapshot_events()
    demotes = [e for e in events if e["kind"] == tf.EV_KV_DEMOTE]
    promotes = [e for e in events if e["kind"] == tf.EV_KV_PROMOTE]
    assert snap["kv_promotions"] > 0 and snap["prefix_evictions"] > 0
    assert sum(e["a"] for e in demotes) == snap["prefix_evictions"]
    assert len(promotes) == snap["hist_kv_promote_ms_per_page"]["count"] \
        >= 1
    assert sum(e["b"] for e in promotes) == pytest.approx(
        snap["kv_promote_ms"])
    beats = eng.flight.snapshot_beats()
    assert 0 < beats["kv_demote_pages"].sum() <= snap["prefix_evictions"]
    assert beats["kv_promote_pages"].sum() == sum(e["a"] for e in promotes)
    trace = tf.chrome_trace({"engine": eng.flight})
    rep = analyze(trace)
    assert rep["overall"]["attributed_pct"] == pytest.approx(100.0, abs=0.5)
