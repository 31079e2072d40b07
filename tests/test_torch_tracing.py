"""Port parity: obs/tracing.py and its span sites (chain server,
retriever, LLM connector, engine).

Both packages' tracers run the built-in mini backend (neither machine has
the OpenTelemetry SDK; `setup` falls back to it, and the tests pin it).
The same scripted calls go through the JAX module and the port's: W3C
traceparent parse / extract / inject, span trees (names, parents,
attributes, events), GenerationSpan's TTFT, traced_llm_stream's counts
and the export-error counter. Then the port's chain server on the echo
and hash fakes (`--device cpu`) against the JAX chain server on the same
fakes, and the port engine's `engine.generate` span.
"""

import asyncio
import io
import json
import threading
import time
import urllib.request
import uuid

import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.obs import tracing as jtr
from generativeaiexamples_tpu_torch.obs import tracing as ttr

TRACE = "0af7651916cd43dd8448eb211c80319c"
PARENT = "b7ad6b7169203331"
HEADER = {"traceparent": f"00-{TRACE}-{PARENT}-01"}


@pytest.fixture
def both():
    """Both tracers on, each with a MemoryExporter; off again after."""
    jexp, texp = jtr.MemoryExporter(), ttr.MemoryExporter()
    assert jtr.setup(exporter=jexp) and ttr.setup(exporter=texp)
    assert jtr._BACKEND == ttr._BACKEND == "mini"
    yield jexp, texp
    jtr._ENABLED = ttr._ENABLED = False


def _tree(spans):
    """(name, parent name, attributes without the host metrics, event
    names) per span, in finish order; parents resolved by span id."""
    by_id = {s.context.span_id: s.name for s in spans}
    out = []
    for s in spans:
        parent = by_id.get(s.parent.span_id, "<remote>") if s.parent \
            else None
        attrs = {k: v for k, v in s.attributes.items()
                 if not k.startswith("system.") and "ms" not in k}
        out.append((s.name, parent, attrs, [e.name for e in s.events]))
    return out


@pytest.mark.parametrize("value", [
    f"00-{TRACE}-{PARENT}-01", f"  00-{TRACE}-{PARENT}-00 ", "garbage",
    "00-zz-11-01", f"00-{TRACE}-{PARENT}", ""])
def test_traceparent_parse_and_extract_match_jax(both, value):
    want, got = (jtr._parse_traceparent(value),
                 ttr._parse_traceparent(value))
    assert (want is None) == (got is None)
    if want is not None:
        assert (got.trace_id, got.span_id) == (want.trace_id, want.span_id)
    for hdrs in ({"traceparent": value}, {"Traceparent": value}):
        want, got = jtr.extract_context(hdrs), ttr.extract_context(hdrs)
        assert (want is None) == (got is None)
        if want is not None:
            assert got.trace_id == want.trace_id
            assert got.span_id == want.span_id


def test_inject_round_trip_matches_jax(both):
    for mod in (jtr, ttr):
        assert mod.inject_context({}) == {}  # nothing attached
        tok = mod.attach_context(mod.extract_context(HEADER))
        try:
            assert mod.inject_context({}) == {
                "traceparent": f"00-{TRACE}-{PARENT}-01"}
            with mod.span("child") as sp:
                out = mod.inject_context({"x": "1"})
                assert out["x"] == "1"
                assert out["traceparent"] == (
                    f"00-{TRACE}-{sp.context.span_id:016x}-01")
                assert mod.current_context() is sp.context
        finally:
            mod.detach_context(tok)
        assert mod.current_context() is None


def test_disabled_tracing_is_a_no_op_in_both():
    jtr._ENABLED = ttr._ENABLED = False
    for mod in (jtr, ttr):
        assert mod.extract_context(HEADER) is None
        assert mod.inject_context({}) == {}
        assert mod.current_context() is None
        assert mod.attach_context(object()) is None
        with mod.span("x", {"a": 1}) as sp:
            sp.set_attribute("b", 2)
            sp.add_event("e")
        ms = mod.ManualSpan("m")
        ms.set_attribute("k", 1)
        ms.end()
        assert mod.span_trace_id(ms) == ""
        assert list(mod.traced_llm_stream("s", iter(["a", "b"]))) == \
            ["a", "b"]
    assert not ttr.is_enabled()
    assert ttr.ManualSpan("m").context() is None


def _script(mod):
    """The same span calls through either module."""
    tok = mod.attach_context(mod.extract_context(HEADER))
    try:
        with mod.span("outer", {"top_k": 4}) as sp:
            sp.set_attribute("n_results", 3)
            with mod.span("inner") as sp2:
                sp2.add_event("tick", {"i": 1})
            ms = mod.ManualSpan("manual", context=mod.current_context(),
                                attributes={"prompt_tokens": 7})
            ms.add_event("first_token", {"ttft_ms": 1.0})
            ms.set_attribute("tokens_generated", 5)
            tid = mod.span_trace_id(ms)
            ms.end()
            ms.end()  # a second end is a no-op
        gs = mod.GenerationSpan("generate", context=mod.current_context())
        with gs:
            gs.on_token()
            gs.on_token()
    finally:
        mod.detach_context(tok)
    return tid


def test_span_trees_and_attributes_match_jax(both):
    jexp, texp = both
    assert _script(jtr) == _script(ttr) == TRACE
    want, got = _tree(jexp.get_finished_spans()), _tree(
        texp.get_finished_spans())
    assert got == want
    assert [n for n, *_ in got] == ["inner", "manual", "outer", "generate"]
    assert all(s.context.trace_id == int(TRACE, 16)
               for s in texp.get_finished_spans())
    gen = texp.get_finished_spans()[-1]
    assert gen.attributes["tokens_generated"] == 2
    assert gen.attributes["ttft_ms"] >= 0
    assert [e.name for e in gen.events] == ["first_token"]
    # ManualSpan.end() carries the host metrics JAX attaches.
    manual = texp.get_finished_spans()[1]
    jmanual = jexp.get_finished_spans()[1]
    assert {k for k in manual.attributes if k.startswith("system.")} == \
        {k for k in jmanual.attributes if k.startswith("system.")}
    assert manual.attributes["system.memory_rss_mb"] > 0


def test_manual_span_context_parents_a_child(both):
    """The port's ManualSpan.context(), which the chain server attaches
    on the chain thread: spans opened under it are its children."""
    _, texp = both
    parent = ttr.ManualSpan("generate", context=ttr.extract_context(HEADER))
    tok = ttr.attach_context(parent.context())
    try:
        with ttr.span("retriever.retrieve"):
            pass
    finally:
        ttr.detach_context(tok)
    parent.end()
    child, gen = texp.get_finished_spans()
    assert child.parent.span_id == gen.context.span_id
    assert child.context.trace_id == gen.context.trace_id == int(TRACE, 16)


@pytest.mark.parametrize("pieces", [["ab", "c", "", "def"], [], ["x"]])
def test_traced_llm_stream_counts_match_jax(both, pieces):
    jexp, texp = both
    for mod in (jtr, ttr):
        assert list(mod.traced_llm_stream(
            "llm.local", iter(pieces), {"max_tokens": 9})) == pieces
    want, got = jexp.get_finished_spans(), texp.get_finished_spans()
    assert _tree(got) == _tree(want)
    sp = got[-1]
    assert sp.attributes["chunks"] == len(pieces)
    assert sp.attributes["chars"] == sum(map(len, pieces))
    assert sp.attributes["max_tokens"] == 9
    assert [e.name for e in sp.events] == (["first_token"] if pieces
                                          else [])


def test_trace_export_errors_count_like_jax(both):
    jexp, texp = both

    class Broken:
        def export(self, spans):
            raise OSError("collector down")

    j0, t0 = jtr.trace_export_errors(), ttr.trace_export_errors()
    jtr._TRACER.exporters.append(Broken())
    ttr._TRACER.exporters.append(Broken())
    try:
        for mod in (jtr, ttr):
            with mod.span("a"):
                pass
            mod.ManualSpan("b").end()
            mod.note_trace_error("set_attribute(x)")
    finally:
        jtr._TRACER.exporters.pop()
        ttr._TRACER.exporters.pop()
    assert ttr.trace_export_errors() - t0 == \
        jtr.trace_export_errors() - j0 == 3
    # The healthy exporter still got both spans.
    assert [s.name for s in texp.get_finished_spans()] == ["a", "b"]


def test_setup_reads_config_and_env_like_jax(monkeypatch):
    from generativeaiexamples_tpu.config.wizard import load_config as jload
    from generativeaiexamples_tpu_torch.config.schema import load_config

    jtr._ENABLED = ttr._ENABLED = False
    off = {}
    assert not jtr.setup(jload(path="", env=off))
    assert not ttr.setup(load_config(env=off))
    on = {"APP_TRACING_ENABLED": "true"}
    try:
        assert jtr.setup(jload(path="", env=on))
        assert ttr.setup(load_config(env=on))
        assert ttr._BACKEND == "mini" and ttr.is_enabled()
        # Never downgraded by a later setup with tracing off.
        assert ttr.setup(load_config(env=off))
    finally:
        jtr._ENABLED = ttr._ENABLED = False
    monkeypatch.setenv("ENABLE_TRACING", "1")
    try:
        assert jtr.setup() and ttr.setup()
    finally:
        jtr._ENABLED = ttr._ENABLED = False


def test_system_metrics_match_jax_keys():
    want, got = jtr.get_system_metrics(), ttr.get_system_metrics()
    assert set(got) == set(want)
    assert got["system.memory_rss_mb"] > 0


# -- the chain server ---------------------------------------------------


def _port_server(tmp_path):
    from generativeaiexamples_tpu_torch.api import server as tapi
    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.connectors.factory import EngineHub

    cfg = load_config(env={"APP_LLM_MODELENGINE": "echo",
                           "APP_EMBEDDINGS_MODELENGINE": "hash",
                           "APP_EMBEDDINGS_DIMENSIONS": "64"})
    app = tapi.ChainServer(cfg, hub=EngineHub(cfg, device="cpu"),
                           upload_dir=str(tmp_path / "up"))
    httpd = tapi.make_http_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return app, httpd, th, f"http://127.0.0.1:{httpd.server_address[1]}"


DOC = "Tracing test document text about retrieval spans.\n\n" * 4


def _port_generate(base, headers):
    boundary = uuid.uuid4().hex
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"d.txt\"\r\nContent-Type: text/plain\r\n\r\n{DOC}"
            f"\r\n--{boundary}--\r\n").encode()
    urllib.request.urlopen(urllib.request.Request(
        base + "/documents", data=body, headers={
            "Content-Type": f"multipart/form-data; boundary={boundary}"}),
        timeout=60).read()
    req = urllib.request.Request(base + "/generate", data=json.dumps({
        "messages": [{"role": "user", "content": "what text?"}],
        "use_knowledge_base": True}).encode(), headers=headers)
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read().decode()


def _jax_generate(tmp_path, headers):
    from aiohttp.test_utils import TestClient, TestServer

    import aiohttp
    from generativeaiexamples_tpu.api.server import ChainServer
    from generativeaiexamples_tpu.config.wizard import load_config
    from generativeaiexamples_tpu.connectors.fakes import (
        EchoLLM, HashEmbedder)
    from generativeaiexamples_tpu.pipelines.base import get_example_class
    from generativeaiexamples_tpu.pipelines.resources import Resources

    cfg = load_config(path="", env={})
    res = Resources(cfg, llm=EchoLLM(), embedder=HashEmbedder(64),
                    reranker=None)
    srv = ChainServer(cfg, example=get_example_class("developer_rag")(res),
                      upload_dir=str(tmp_path / "jup"))

    async def run():
        client = TestClient(TestServer(srv.app))
        await client.start_server()
        try:
            form = aiohttp.FormData()
            form.add_field("file", io.BytesIO(DOC.encode()),
                           filename="d.txt")
            assert (await client.post("/documents", data=form)).status \
                == 200
            r = await client.post("/generate", json={
                "messages": [{"role": "user", "content": "what text?"}],
                "use_knowledge_base": True}, headers=headers)
            return (await r.read()).decode()
        finally:
            await client.close()

    return asyncio.run(run())


def _frames(raw):
    return [json.loads(ln[6:]) for ln in raw.splitlines()
            if ln.startswith("data: ")]


def _pieces(raw):
    return [(f["choices"][0]["message"]["content"],
             f["choices"][0]["finish_reason"]) for f in _frames(raw)]


def test_chain_server_generate_spans_match_jax(both, tmp_path):
    """/generate on echo + hash with a traceparent: the same spans as the
    JAX server (generate with its attributes, retriever.retrieve with
    n_results) in the caller's trace, and the same frames."""
    jexp, texp = both
    want_raw = _jax_generate(tmp_path, HEADER)
    app, httpd, th, base = _port_server(tmp_path)
    try:
        got_raw = _port_generate(base, HEADER)
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
        app.close()
    strip = _pieces(want_raw)
    assert _pieces(got_raw) == strip
    spans = {}
    for name, exp in (("jax", jexp), ("port", texp)):
        spans[name] = {s.name: s for s in exp.get_finished_spans()}
        gen = spans[name]["generate"]
        assert f"{gen.context.trace_id:032x}" == TRACE
        assert gen.attributes["use_knowledge_base"] is True
        assert gen.attributes["tokens_generated"] == len(strip) - 1
        assert gen.attributes["ttft_ms"] >= 0
        assert gen.attributes["request_id"] == _frames(
            want_raw if name == "jax" else got_raw)[0]["id"]
        ret = spans[name]["retriever.retrieve"]
        assert ret.context.trace_id == gen.context.trace_id
        assert ret.attributes == {"top_k": 4, "n_results": 1}
    assert set(spans["port"]) == set(spans["jax"]) == {
        "generate", "retriever.retrieve"}
    # The port parents the chain's spans onto `generate` (JAX onto the
    # caller's span, which it attaches instead).
    pg, pr = spans["port"]["generate"], spans["port"]["retriever.retrieve"]
    assert pr.parent.span_id == pg.context.span_id
    assert spans["jax"]["retriever.retrieve"].parent.span_id == \
        int(PARENT, 16)


def test_chain_server_links_spans_without_a_traceparent(both, tmp_path):
    """No header: generate starts a trace and the retriever joins it."""
    _, texp = both
    app, httpd, th, base = _port_server(tmp_path)
    try:
        _port_generate(base, {})
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
        app.close()
    spans = {s.name: s for s in texp.get_finished_spans()}
    assert spans["retriever.retrieve"].context.trace_id == \
        spans["generate"].context.trace_id != int(TRACE, 16)


# -- the engine and the LLM connector ---------------------------------


@pytest.fixture(scope="module")
def tiny_engine():
    from generativeaiexamples_tpu_torch.models import llama as tl
    from generativeaiexamples_tpu_torch.serving.engine import LLMEngine
    from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

    cfg = tl.LlamaConfig.tiny(vocab_size=259)
    eng = LLMEngine(tl.init_params(cfg, "cpu", torch.Generator().manual_seed(
        0)), cfg, ByteTokenizer(), dict(max_batch_size=2, max_seq_len=64,
                                        page_size=8, prefill_buckets=(16,)),
        device="cpu").start()
    yield eng
    eng.stop()


def _engine_span(exporter):
    """The engine.generate span, once the scheduler thread has closed it
    (it retires the slot just after putting the stream's last event)."""
    deadline = time.time() + 10
    while time.time() < deadline:
        spans = [s for s in exporter.get_finished_spans()
                 if s.name == "engine.generate"]
        if spans:
            return spans[-1]
        time.sleep(0.005)
    raise AssertionError("no engine.generate span")


@pytest.mark.parametrize("n_prompt, chunked", [(3, False), (40, True)])
def test_engine_generate_span(both, tiny_engine, n_prompt, chunked):
    """One engine.generate span a request (mirroring tests/test_wiring.py's
    engine test): prompt_tokens, tokens_generated, a first_token TTFT
    event and the host metrics, parented onto the request's context; a
    prompt beyond the bucket carries chunked_prefill."""
    _, texp = both
    ctx = ttr.extract_context(HEADER)
    events = list(tiny_engine.generate_stream(
        list(range(1, n_prompt + 1)), max_new_tokens=4, trace_context=ctx,
        request_id="r1"))
    assert events[-1]["finished"]
    sp = _engine_span(texp)
    assert sp.attributes["prompt_tokens"] == n_prompt
    assert sp.attributes["tokens_generated"] == sum(
        e["token_id"] >= 0 for e in events)
    assert sp.attributes["request_id"] == "r1"
    assert sp.attributes.get("chunked_prefill", False) is chunked
    assert [e.name for e in sp.events] == ["first_token"]
    assert sp.events[0].attributes["ttft_ms"] >= 0
    assert sp.attributes["system.memory_rss_mb"] > 0
    assert sp.parent.span_id == int(PARENT, 16)
    assert sp.context.trace_id == int(TRACE, 16)
    # No device counters on the CPU (the card's come from its allocator).
    assert not any(k.startswith("device.") for k in sp.attributes)
    assert tiny_engine.metrics.snapshot()["trace_export_errors"] == \
        ttr.trace_export_errors()


def test_local_llm_spans_share_the_callers_trace(both, tiny_engine):
    """LocalEngineLLM: an llm.local span (chunks, chars, a first_token
    event) and the engine's span, both in the attached context's trace."""
    from generativeaiexamples_tpu_torch.connectors.local import (
        LocalEngineLLM)

    _, texp = both
    tok = ttr.attach_context(ttr.extract_context(HEADER))
    try:
        text = LocalEngineLLM(tiny_engine).chat(
            [{"role": "user", "content": "hi"}], max_tokens=5)
    finally:
        ttr.detach_context(tok)
    eng = _engine_span(texp)
    llm = {s.name: s for s in texp.get_finished_spans()}["llm.local"]
    assert llm.context.trace_id == eng.context.trace_id == int(TRACE, 16)
    assert llm.attributes["chars"] == len(text)
    assert llm.attributes["max_tokens"] == 5
    assert eng.attributes["tokens_generated"] >= 1


def test_engine_spans_off_cost_nothing(tiny_engine):
    """With tracing off the engine makes no spans and reads no device
    counters; the snapshot still has trace_export_errors."""
    jtr._ENABLED = ttr._ENABLED = False
    before = tiny_engine._memstats_tick
    list(tiny_engine.generate_stream([1, 2, 3], max_new_tokens=2))
    assert tiny_engine._memstats_tick == before
    snap = tiny_engine.metrics.snapshot()
    assert isinstance(snap["trace_export_errors"], int)
    assert np.isscalar(snap["trace_export_errors"])
