"""Port parity: ui/{server,chat_client}.py, utils/sse.py,
streaming/asr.py and utils/http.py.

The JAX package's aiohttp `PlaygroundServer` and the port's run in
front of the same stub chain server (the port's ChainServer over echo
and hash fakes, on a local port, one fresh stub a package) through the
same request sequence: every route's status and JSON body, the pages,
the SSE frames of /api/chat, the voice routes over the fake ASR / TTS
and the websocket transcribe exchange must be equal. The clients'
request bodies, captured by a stub, are byte-equal to the JAX clients'
(`requests`) but for the multipart boundary.
"""

import asyncio
import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import aiohttp
import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from generativeaiexamples_tpu.streaming import asr as jasr
from generativeaiexamples_tpu.ui import chat_client as jcc
from generativeaiexamples_tpu.ui import server as jsrv
from generativeaiexamples_tpu_torch.streaming import asr as tasr
from generativeaiexamples_tpu_torch.ui import chat_client as tcc
from generativeaiexamples_tpu_torch.ui import server as tsrv
from generativeaiexamples_tpu_torch.utils import http as thttp
from generativeaiexamples_tpu_torch.utils import sse as tsse

PKGS = {"jax": (jsrv, jcc, jasr), "port": (tsrv, tcc, tasr)}


def _stub_chain(tmp_path):
    """The port's chain server (developer_rag over EchoLLM and a hash
    embedder) on 127.0.0.1: (base url, stop)."""
    from generativeaiexamples_tpu_torch.api.server import (
        ChainServer, make_http_server)
    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
    from generativeaiexamples_tpu_torch.connectors.fakes import (
        EchoLLM, HashEmbedder)
    from generativeaiexamples_tpu_torch.pipelines.base import (
        get_example_class)
    from generativeaiexamples_tpu_torch.pipelines.resources import Resources

    cfg = load_config(path="", env={})
    res = Resources(cfg, hub=EngineHub(cfg, device="cpu"), llm=EchoLLM(),
                    embedder=HashEmbedder(64), reranker=None)
    app = ChainServer(cfg, example=get_example_class("developer_rag")(res),
                      upload_dir=str(tmp_path))
    httpd = make_http_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()

    def stop():
        httpd.shutdown()
        httpd.server_close()
        app.close()

    return f"http://127.0.0.1:{httpd.server_address[1]}", stop


def _frames(raw: bytes):
    return [json.loads(ln[6:]) for ln in raw.decode().split("\n\n")
            if ln.startswith("data: ")]


TONE = (np.sin(np.arange(16000) / 10) * 8000).astype(np.int16)


async def _drive(pkg, tmp_path, monkeypatch):
    """Every route of one package's playground, in one sequence: a list
    of (step, status, body) records."""
    srv_mod, cc_mod, asr_mod = PKGS[pkg]
    base, stop = _stub_chain(tmp_path / f"{pkg}_up")
    asr = asr_mod.FakeASR(script=["what is a chip", "interim words",
                                  "final words"])
    feedback = tmp_path / f"{pkg}_feedback.jsonl"
    server = srv_mod.PlaygroundServer(cc_mod.ChatClient(base, "m"), asr=asr,
                                      tts=asr_mod.FakeTTS(),
                                      feedback_path=str(feedback))
    ui = TestClient(TestServer(server.app))
    await ui.start_server()
    out = []

    async def rec(step, r, kind="json"):
        body = await r.read()
        if kind == "json":
            body = json.loads(body)
        elif kind == "sse":
            body = _frames(body)
        elif kind == "wav":
            body = (r.headers["Content-Type"], body)
        out.append((step, r.status, body))

    try:
        for page in ("/", "/converse", "/kb", "/static/converse.js"):
            await rec(page, await ui.get(page), "raw")
        await rec("health", await ui.get("/health"))
        await rec("chat", await ui.post("/api/chat", json={
            "query": "hello proxy", "use_knowledge_base": False,
            "max_tokens": 64}), "sse")
        await rec("chat_empty", await ui.post("/api/chat", json={
            "query": "  "}))
        await rec("chat_bad", await ui.post(
            "/api/chat", data=b"{not json",
            headers={"Content-Type": "application/json"}))
        form = aiohttp.FormData()
        form.add_field("file", b"Kernels stream pages into shared memory. "
                       b"The splitter chunks documents by tokens.",
                       filename="kernels.txt", content_type="text/plain")
        await rec("upload", await ui.post("/api/documents", data=form))
        await rec("upload_no_form", await ui.post("/api/documents",
                                                  data=b"x"))
        await rec("list", await ui.get("/api/documents"))
        await rec("search", await ui.post("/api/search", json={
            "query": "shared memory pages", "top_k": 2}))
        await rec("chat_kb", await ui.post("/api/chat", json={
            "query": "what streams pages?", "use_knowledge_base": True}),
            "sse")
        await rec("delete_none", await ui.delete("/api/documents"))
        await rec("delete", await ui.delete(
            "/api/documents?filename=kernels.txt"))
        await rec("list_after", await ui.get("/api/documents"))
        await rec("voice", await ui.get("/api/voice"))
        await rec("transcribe", await ui.post(
            "/api/transcribe", data=asr_mod.pcm_to_wav_bytes(TONE, 16000),
            headers={"Content-Type": "audio/wav"}))
        await rec("transcribe_bad", await ui.post("/api/transcribe",
                                                  data=b"RIFFjunk"))
        await rec("speech", await ui.post(
            "/api/speech", json={"text": "a chip is fast",
                                 "sample_rate": 8000}), "wav")
        await rec("speech_empty", await ui.post("/api/speech",
                                                json={"text": ""}))
        await rec("speech_bad", await ui.post(
            "/api/speech", json={"text": "x", "sample_rate": "fast"}))
        for i, fb in enumerate(({"rating": 1, "query": "q", "response": "r",
                                 "use_knowledge_base": True},
                                {"rating": 3}, {"rating": "x"})):
            await rec(f"feedback{i}", await ui.post("/api/feedback",
                                                    json=fb))
        rows = [json.loads(ln) for ln in feedback.read_text().splitlines()]
        out.append(("feedback_rows", 0, [{k: v for k, v in r.items()
                                          if k != "ts"} for r in rows]))

        # The websocket: one interim result while the take streams, then
        # the final transcript of the whole take.
        ws = await ui.ws_connect("/api/transcribe/ws")
        await ws.send_json({"rate": 16000})
        await ws.send_bytes(b"\x01")
        msgs = [await ws.receive_json(timeout=10)]
        await ws.send_bytes(TONE.astype("<i2").tobytes())
        msgs.append(await ws.receive_json(timeout=10))
        await ws.send_json({"end": True})
        msgs.append(await ws.receive_json(timeout=10))
        await ws.close()
        out.append(("ws", 0, msgs))
    finally:
        await ui.close()
        stop()
    return out


def test_playground_routes_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("VOICE_INTERIM_INTERVAL_S", "0")
    got = asyncio.run(_drive("port", tmp_path, monkeypatch))
    want = asyncio.run(_drive("jax", tmp_path, monkeypatch))
    assert [s for s, _, _ in got] == [s for s, _, _ in want]
    for g, w in zip(got, want):
        assert g == w, g[0]
    by = {s: (st, b) for s, st, b in got}
    assert by["chat"][1][-1] == {"done": True, "context": []}
    assert "hello proxy" in "".join(f.get("content", "")
                                    for f in by["chat"][1])
    assert by["chat_kb"][1][-1]["context"]
    assert by["list"][1] == {"documents": ["kernels.txt"]}
    assert by["ws"][1] == [
        {"error": "binary frames must be int16 PCM (even byte length)"},
        {"text": "interim words", "final": False},
        {"text": "final words", "final": True}]
    assert by["speech"][1][0] == "audio/wav"
    assert [by[f"feedback{i}"][0] for i in range(3)] == [200, 422, 422]


def test_voice_routes_without_clients_equal_jax(tmp_path):
    async def run(pkg):
        srv_mod, cc_mod, _ = PKGS[pkg]
        ui = TestClient(TestServer(srv_mod.PlaygroundServer(
            cc_mod.ChatClient("http://127.0.0.1:9", "m"),
            feedback_path=str(tmp_path / "f.jsonl")).app))
        await ui.start_server()
        try:
            out = []
            for method, path, kw in (
                    ("get", "/api/voice", {}),
                    ("post", "/api/transcribe", {"data": b"x"}),
                    ("post", "/api/speech", {"json": {"text": "x"}}),
                    ("get", "/health", {}),
                    ("post", "/api/search", {"json": {"query": "x"}}),
                    ("get", "/api/documents", {})):
                r = await getattr(ui, method)(path, **kw)
                out.append((path, r.status, await r.json()))
            ws = await ui.ws_connect("/api/transcribe/ws")
            out.append(("ws", 0, await ws.receive_json(timeout=10)))
            await ws.close()
            return out
        finally:
            await ui.close()

    assert asyncio.run(run("port")) == asyncio.run(run("jax"))


# -- the clients' request bodies ----------------------------------------------


class _Capture:
    """A stdlib HTTP stub that records each request and answers from a
    route table."""

    def __init__(self, routes):
        self.seen = []
        cap = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _do(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                cap.seen.append((self.command, self.path,
                                 self.headers.get("Content-Type"), body,
                                 self.headers.get("traceparent")))
                status, ctype, payload = routes(self.command, self.path)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            do_GET = do_POST = do_DELETE = _do

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _unboundary(ctype, body):
    """A multipart body with its random boundary replaced."""
    if not ctype or "boundary=" not in ctype:
        return ctype, body
    b = ctype.split("boundary=")[1].encode()
    return ctype.split("boundary=")[0], body.replace(b, b"BOUNDARY")


def _chain_routes(method, path):
    if path.startswith("/generate"):
        frames = [{"choices": [{"message": {"content": t},
                                "finish_reason": ""}]} for t in ("a", "b")]
        frames.append({"choices": [{"message": {"content": ""},
                                    "finish_reason": "[DONE]"}]})
        return 200, "text/event-stream", b"".join(
            b"data: " + json.dumps(f).encode() + b"\n\n" for f in frames)
    if path.startswith("/search"):
        return 200, "application/json", json.dumps(
            {"chunks": [{"content": "c", "filename": "f", "score": 0.5}]}
        ).encode()
    if path.startswith("/documents") and method == "GET":
        return 200, "application/json", b'{"documents": ["f.txt"]}'
    return 200, "application/json", b'{"message": "ok"}'


def test_chat_client_sends_the_jax_bodies(tmp_path):
    doc = tmp_path / "notes.txt"
    doc.write_text("some notes")
    results = {}
    for pkg, mod in (("jax", jcc), ("port", tcc)):
        cap = _Capture(_chain_routes)
        try:
            c = mod.ChatClient(cap.base + "/", "m")
            got = [c.health(), c.search("what is it", top_k=3),
                   list(c.predict("hi", True, num_tokens=7, stop=["x"])),
                   c.upload_documents([str(doc)]),
                   c.delete_documents("notes one.txt"),
                   c.get_uploaded_documents()]
        finally:
            cap.close()
        results[pkg] = (got, [(m, p, *_unboundary(ct, b), tp)
                              for m, p, ct, b, tp in cap.seen])
    assert results["port"] == results["jax"]
    got, seen = results["port"]
    assert got[2] == ["a", "b", None]
    assert [(m, p) for m, p, *_ in seen] == [
        ("GET", "/health"), ("POST", "/search"), ("POST", "/generate"),
        ("POST", "/documents"), ("DELETE", "/documents?filename=notes+one.txt"),
        ("GET", "/documents")]


def test_chat_client_failures_equal_jax(tmp_path):
    def failing(method, path):
        if path.startswith("/documents") and method == "POST":
            return 400, "application/json", b'{"detail": "bad file"}'
        if path.startswith("/documents") and method == "GET":
            return 500, "application/json", b'{"message": "store down"}'
        return 500, "application/json", b"{}"

    doc = tmp_path / "x.txt"
    doc.write_text("x")
    results = {}
    for pkg, mod in (("jax", jcc), ("port", tcc)):
        cap = _Capture(failing)
        try:
            c = mod.ChatClient(cap.base, "m")
            out = [c.health(), c.search("q"), list(c.predict("q", False)),
                   c.delete_documents("x")]
            for fn in (lambda: c.upload_documents([str(doc)]),
                       c.get_uploaded_documents):
                with pytest.raises(ValueError) as e:
                    fn()
                out.append(str(e.value))
        finally:
            cap.close()
        # Nothing listens on port 9: unreachable, not an error.
        unreachable = mod.ChatClient("http://127.0.0.1:9", "m")
        out += [unreachable.health(), unreachable.get_uploaded_documents()]
        results[pkg] = out
    assert results["port"] == results["jax"]
    assert results["port"][4:6] == ["bad file", "store down"]


def test_voice_clients_send_the_jax_bodies():
    rate24 = 24000
    reply = jasr.pcm_to_wav_bytes(
        (np.sin(np.arange(2400) / 7) * 9000).astype(np.int16), rate24)

    def routes(method, path):
        if path.endswith("/transcriptions"):
            return 200, "application/json", b'{"text": "heard"}'
        return 200, "audio/wav", reply

    results = {}
    for pkg, mod in (("jax", jasr), ("port", tasr)):
        cap = _Capture(routes)
        try:
            a = mod.HTTPASRClient(cap.base + "/", "whisper-x", api_key="k")
            t = mod.HTTPTTSClient(cap.base, "tts-x", "nova")
            out = [a.transcribe(TONE[:800], 16000),
                   t.synthesize("say this", sample_rate=rate24),
                   t.synthesize("say this", sample_rate=22050)]
        finally:
            cap.close()
        results[pkg] = (out, [(m, p, *_unboundary(ct, b))
                              for m, p, ct, b, _ in cap.seen])
    (gout, gseen), (wout, wseen) = results["port"], results["jax"]
    assert gseen == wseen
    assert gout[0] == wout[0] == "heard"
    np.testing.assert_array_equal(gout[1], wout[1])
    # The resampled reply: the same polyphase filter in numpy and XLA,
    # whose float32 sums may round a sample to the next integer.
    assert gout[2].shape == wout[2].shape and gout[2].dtype == np.int16
    assert int(np.abs(gout[2].astype(np.int32)
                      - wout[2].astype(np.int32)).max()) <= 1


def test_wav_helpers_and_fakes_equal_jax():
    for rate in (8000, 16000, 44100):
        assert tasr.pcm_to_wav_bytes(TONE, rate) == \
            jasr.pcm_to_wav_bytes(TONE, rate)
    stereo = np.stack([TONE, TONE // 3], axis=1).reshape(-1)
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes(stereo.astype(np.int16).tobytes())
    for data in (tasr.pcm_to_wav_bytes(TONE, 16000), buf.getvalue()):
        gp, gr = tasr.wav_bytes_to_pcm(data)
        wp, wr = jasr.wav_bytes_to_pcm(data)
        assert gr == wr
        np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(tasr.FakeTTS().synthesize("a b c", 8000),
                                  jasr.FakeTTS().synthesize("a b c", 8000))
    ga, wa = tasr.FakeASR(["x", "y"]), jasr.FakeASR(["x", "y"])
    for pcm in (np.zeros(100, np.int16), TONE, TONE, TONE):
        assert ga.transcribe(pcm, 16000) == wa.transcribe(pcm, 16000)
    assert ga.calls == wa.calls == 4


def test_create_voice_clients_follows_the_config():
    from generativeaiexamples_tpu.config.wizard import load_config as jload
    from generativeaiexamples_tpu_torch.config.schema import load_config

    for env in ({}, {"APP_VOICE_ASRSERVERURL": "http://a:1"},
                {"APP_VOICE_TTSSERVERURL": "http://t:2",
                 "APP_VOICE_TTSVOICE": "echo"}):
        got = tasr.create_voice_clients(load_config(path="", env=env))
        want = jasr.create_voice_clients(jload(path="", env=env))
        assert [type(c).__name__ if c else None for c in got] == \
            [type(c).__name__ if c else None for c in want]
        for g, w in zip(got, want):
            if g is not None:
                assert vars(g) == vars(w)
    assert tasr.create_voice_clients(object()) == (None, None)


def test_multipart_body_matches_requests():
    import requests

    files = [("file", ("a b.txt", b"\x00bytes\r\n", "text/plain")),
             ("other", ('q"x.bin', b"", None))]
    body, ctype = thttp.multipart_body({"model": "m", "n": 3}, files,
                                       boundary="B0UND")
    req = requests.Request(
        "POST", "http://x/", data={"model": "m", "n": 3},
        files=[(n, (f, b, c) if c else (f, b)) for n, (f, b, c) in files]
    ).prepare()
    wb = req.headers["Content-Type"].split("boundary=")[1]
    assert body == req.body.replace(wb.encode(), b"B0UND")
    assert ctype == "multipart/form-data; boundary=B0UND"
    assert thttp.json_body({"a": [1, "é"]}) == json.dumps(
        {"a": [1, "é"]}).encode()


# -- SSE -------------------------------------------------------------------


def test_sse_frames_equal_jax():
    from generativeaiexamples_tpu.utils import sse as jsse

    def gen():
        yield "a"
        yield None
        yield "b"
        raise RuntimeError("boom")

    async def run(mod):
        async def handler(request):
            return await mod.stream_sse(
                request, gen, map_item=lambda c: {"content": c} if c else None,
                final_payload=lambda: {"done": True})

        app = web.Application()
        app.router.add_get("/s", handler)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.get("/s")
            return r.status, dict(r.headers)["Content-Type"], await r.read()
        finally:
            await client.close()

    got, want = asyncio.run(run(tsse)), asyncio.run(run(jsse))
    assert got == want
    assert _frames(got[2]) == [{"content": "a"}, {"content": "b"},
                               {"content": "[error] boom"}, {"done": True}]


def test_sse_client_disconnect_cancels_the_generator():
    """The client reads two frames and goes away: the pump stops at the
    next item and close()s the generator, which would otherwise run
    forever."""
    state = {"yielded": 0, "closed": threading.Event()}

    def endless():
        try:
            while True:
                state["yielded"] += 1
                time.sleep(0.01)
                yield "tok"
        finally:
            state["closed"].set()

    async def run():
        async def handler(request):
            return await tsse.stream_sse(request, endless)

        app = web.Application()
        app.router.add_get("/s", handler)
        server = TestServer(app)
        await server.start_server()
        try:
            reader, writer = await asyncio.open_connection(server.host,
                                                           server.port)
            writer.write(b"GET /s HTTP/1.1\r\nHost: x\r\n\r\n")
            await writer.drain()
            seen = b""
            while seen.count(b"data: ") < 2:
                seen += await asyncio.wait_for(reader.read(1024), 10)
            writer.close()
            await asyncio.to_thread(state["closed"].wait, 10)
        finally:
            await server.close()

    asyncio.run(run())
    assert state["closed"].is_set()
    n = state["yielded"]
    time.sleep(0.1)
    assert state["yielded"] == n  # nothing runs after the close


def test_ui_launcher_keeps_the_jax_flags():
    import inspect

    from generativeaiexamples_tpu.ui import __main__ as jmain
    from generativeaiexamples_tpu_torch.ui import __main__ as tmain

    def flags(mod):
        src = inspect.getsource(mod.main)
        return re.findall(r'add_argument\(\s*"([^"]+)"(?:,\s*"([^"]+)")?',
                          src)

    assert flags(tmain) == flags(jmain)
    assert os.path.isdir(tsrv.STATIC_DIR)
    assert sorted(os.listdir(tsrv.STATIC_DIR)) == sorted(
        os.listdir(jsrv.STATIC_DIR))
