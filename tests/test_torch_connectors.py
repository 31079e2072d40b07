"""Port parity: the connectors (connectors/fakes.py, lexical.py,
openai_http.py, factory.py).

The hermetic fakes and the lexical embedder give the JAX package's
outputs for the same inputs (the fakes and lexical vectors bit for bit);
the lexical DF snapshot written by either package loads in the other.
The OpenAI-compatible clients (the port's on urllib, the JAX package's on
requests) talk to one local http.server stub that speaks SSE,
/embeddings and /ranking: both send the same request bodies and return
the same results. The factory picks the implementation per model_engine
and server_url as the JAX factory does.
"""

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from generativeaiexamples_tpu.connectors import fakes as jfakes
from generativeaiexamples_tpu.connectors import factory as jfactory
from generativeaiexamples_tpu.connectors import lexical as jlex
from generativeaiexamples_tpu.connectors import openai_http as jhttp
from generativeaiexamples_tpu_torch.config.schema import load_config
from generativeaiexamples_tpu_torch.connectors import factory as tfactory
from generativeaiexamples_tpu_torch.connectors import fakes as tfakes
from generativeaiexamples_tpu_torch.connectors import lexical as tlex
from generativeaiexamples_tpu_torch.connectors import openai_http as thttp
from generativeaiexamples_tpu_torch.connectors.factory import EngineHub

TEXTS = ["The MXU is a systolic array for matrix multiplication.",
         "Bananas are yellow; apples are red, green or yellow.",
         "HBM feeds the matrix units at high bandwidth bandwidth.",
         "", "Ünïcödé words and numbers 42 and 42."]


def test_hash_embedder_matches_jax():
    for dim in (16, 64):
        ours, theirs = tfakes.HashEmbedder(dim), jfakes.HashEmbedder(dim)
        np.testing.assert_array_equal(ours.embed_documents(TEXTS),
                                      theirs.embed_documents(TEXTS))
        np.testing.assert_array_equal(ours.embed_queries(TEXTS),
                                      theirs.embed_queries(TEXTS))
        np.testing.assert_array_equal(ours.embed_query(TEXTS[0]),
                                      theirs.embed_query(TEXTS[0]))
        assert ours.embed_documents([]).shape == (0, dim)


def test_echo_llm_and_overlap_reranker_match_jax():
    script = [("weather", "It is sunny."), ("tool", '{"tool": "x"}')]
    for args in ((), (script,), (script, "> ")):
        ours, theirs = tfakes.EchoLLM(*args), jfakes.EchoLLM(*args)
        for msgs in ([{"role": "user", "content": "hello  there world"}],
                     [{"role": "system", "content": "use a tool"},
                      {"role": "user", "content": "what weather?"}],
                     [{"role": "system", "content": "x"}]):
            assert list(ours.stream_chat(msgs)) == list(
                theirs.stream_chat(msgs))
            assert ours.chat(msgs, max_tokens=5) == theirs.chat(msgs)
        assert ours.calls == theirs.calls
    got = tfakes.OverlapReranker().score("yellow matrix units", TEXTS)
    want = jfakes.OverlapReranker().score("yellow matrix units", TEXTS)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32


def test_lexical_vectors_match_jax():
    ours, theirs = tlex.LexicalEmbedder(64), jlex.LexicalEmbedder(64)
    # An empty DF table: plain TF weighting in both.
    np.testing.assert_array_equal(ours.embed_query("matrix"),
                                  theirs.embed_query("matrix"))
    np.testing.assert_array_equal(ours.embed_documents(TEXTS),
                                  theirs.embed_documents(TEXTS))
    assert ours.n_docs == theirs.n_docs == len(TEXTS)
    np.testing.assert_array_equal(ours.embed_queries(TEXTS[:3]),
                                  theirs.embed_queries(TEXTS[:3]))
    ours.fit_documents(["yellow yellow"])
    theirs.fit_documents(["yellow yellow"])
    np.testing.assert_array_equal(ours.embed_query("yellow matrix"),
                                  theirs.embed_query("yellow matrix"))
    assert ours.embed_queries([]).shape == (0, 64)
    with pytest.raises(ValueError, match="too small"):
        tlex.LexicalEmbedder(8)


@pytest.mark.parametrize("writer, reader", [
    pytest.param(jlex, tlex, id="jax-to-port"),
    pytest.param(tlex, jlex, id="port-to-jax"),
    pytest.param(tlex, tlex, id="port-to-port")])
def test_lexical_df_snapshot_loads_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "store" / "lexical_df.json")
    w = writer.LexicalEmbedder(64, persist_path=path)
    w.embed_documents(TEXTS)
    w.flush_state()
    r = reader.LexicalEmbedder(64, persist_path=path)
    assert r.n_docs == len(TEXTS)
    np.testing.assert_array_equal(r.embed_query("yellow matrix"),
                                  w.embed_query("yellow matrix"))
    # A snapshot of another hash width is ignored.
    assert reader.LexicalEmbedder(32, persist_path=path).n_docs == 0
    assert not reader.LexicalEmbedder(64).load_state(str(tmp_path / "nope"))


# -- the OpenAI-compatible clients against one stub -----------------------


class _Stub(BaseHTTPRequestHandler):
    """/v1/chat/completions (SSE), /v1/embeddings, /v1/ranking; records
    each request's path, headers and body."""

    requests = []

    def log_message(self, *a):
        pass

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        type(self).requests.append((self.path, self.headers.get(
            "Authorization"), self.headers.get("Content-Type"), body))
        if self.path == "/v1/chat/completions":
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.end_headers()
            pieces = ["Hel", "lo", "", " wörld"]
            for p in pieces:
                frame = {"choices": [{"delta": {"content": p}}]}
                self.wfile.write(f"data: {json.dumps(frame)}\n\n".encode())
            self.wfile.write(b": keep-alive\n\ndata: {not json}\n\n")
            self.wfile.write(b'data: {"choices": [{"delta": {}}]}\n\n')
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.write(b'data: {"choices": [{"delta": '
                             b'{"content": "after done"}}]}\n\n')
            return
        if self.path == "/v1/embeddings":
            data = [{"index": i, "embedding": [float(len(t)), i + 0.5, -1.0]}
                    for i, t in enumerate(body["input"])]
            payload = {"data": data[::-1]}  # out of order on purpose
        elif self.path == "/v1/ranking":
            payload = {"rankings": [
                {"index": i, "logit": float(len(p["text"])) / 10}
                for i, p in reversed(list(enumerate(body["passages"])))]}
        else:
            self.send_response(404)
            self.end_headers()
            return
        raw = json.dumps(payload).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)


@pytest.fixture(scope="module")
def stub():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}/v1/"
    httpd.shutdown()
    httpd.server_close()
    th.join(timeout=10)


def _both(fn):
    """fn(module) for the JAX clients then the port's: (results,
    requests) of each."""
    out = []
    for mod in (jhttp, thttp):
        _Stub.requests = []
        res = fn(mod)
        out.append((res, list(_Stub.requests)))
    return out


def _same_requests(a, b):
    assert len(a) == len(b)
    for (pa, aa, ca, ba), (pb, ab, cb, bb) in zip(a, b):
        assert (pa, aa, ba) == (pb, ab, bb)
        assert ca == cb == "application/json"


@pytest.mark.parametrize("key", ["", "sk-test"])
def test_chat_stream_matches_jax(stub, key):
    msgs = [{"role": "user", "content": "hi"}]

    def run(mod):
        llm = mod.OpenAIChatLLM(stub, model="m", api_key=key)
        return (list(llm.stream_chat(msgs, temperature=0.1, top_p=0.9,
                                     max_tokens=7, stop=["\n"])),
                llm.chat(msgs))

    (want, wreq), (got, greq) = _both(run)
    assert got == want == (["Hel", "lo", " wörld"], "Hello wörld")
    _same_requests(greq, wreq)
    assert greq[0][3] == {"model": "m", "messages": msgs,
                          "temperature": 0.1, "top_p": 0.9,
                          "max_tokens": 7, "stream": True, "stop": ["\n"]}
    assert "stop" not in greq[1][3]


def test_embedder_and_reranker_match_jax(stub):
    texts = [f"text {'x' * i}" for i in range(5)]

    def run(mod):
        emb = mod.OpenAIEmbedder(stub, model="e", dim=3, batch=2)
        rr = mod.OpenAIReranker(stub, model="r", api_key="k")
        return (emb.embed_documents(texts), emb.embed_queries(texts[:3]),
                emb.embed_query("q"), rr.score("q", texts))

    (want, wreq), (got, greq) = _both(run)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.float32
    _same_requests(greq, wreq)
    assert [r[3].get("input_type") for r in greq[:3]] == ["passage"] * 3
    assert greq[-1][3] == {"model": "r", "query": {"text": "q"},
                           "passages": [{"text": t} for t in texts]}


def test_http_errors_raise(stub):
    import urllib.error

    bad = stub.replace("/v1/", "/nope/")
    with pytest.raises(urllib.error.HTTPError):
        thttp.OpenAIEmbedder(bad).embed_query("x")


def test_chat_stream_is_traced(stub):
    from generativeaiexamples_tpu_torch.obs import tracing

    exp = tracing.MemoryExporter()
    assert tracing.setup(exporter=exp)
    try:
        assert thttp.OpenAIChatLLM(stub, model="m").chat(
            [{"role": "user", "content": "hi"}]) == "Hello wörld"
    finally:
        tracing._ENABLED = False
    sp = exp.get_finished_spans()[-1]
    assert sp.name == "llm.openai"
    assert (sp.attributes["chunks"], sp.attributes["chars"]) == (3, 11)
    assert sp.attributes["model"] == "m"


# -- the factory -------------------------------------------------------------


def _kinds(config, hub):
    """(llm, embedder, reranker) class names the port's factory picks."""
    return tuple(type(x).__name__ if x is not None else None for x in (
        tfactory.get_llm(config, hub), tfactory.get_embedder(config, hub),
        tfactory.get_reranker(config, hub)))


def _jkinds(env):
    from generativeaiexamples_tpu.config.wizard import load_config as jload

    cfg = jload(path="", env=env)
    return tuple(type(x).__name__ if x is not None else None for x in (
        jfactory.get_llm(cfg), jfactory.get_embedder(cfg),
        jfactory.get_reranker(cfg)))


@pytest.mark.parametrize("env", [
    {"APP_LLM_MODELENGINE": "echo", "APP_EMBEDDINGS_MODELENGINE": "hash"},
    {"APP_LLM_MODELENGINE": "test", "APP_EMBEDDINGS_MODELENGINE": "test",
     "APP_RERANKER_ENABLED": "true", "APP_RERANKER_MODELENGINE": "overlap"},
    {"APP_LLM_MODELENGINE": "echo", "APP_EMBEDDINGS_MODELENGINE": "lexical",
     "APP_RERANKER_ENABLED": "true", "APP_RERANKER_MODELENGINE": "test"},
    {"APP_LLM_MODELENGINE": "openai", "APP_EMBEDDINGS_MODELENGINE": "nim",
     "APP_RERANKER_ENABLED": "true", "APP_RERANKER_MODELENGINE": "remote"},
    {"APP_LLM_MODELENGINE": "tpu", "APP_LLM_SERVERURL": "http://h:1/v1",
     "APP_EMBEDDINGS_MODELENGINE": "tpu",
     "APP_EMBEDDINGS_SERVERURL": "http://h:1/v1",
     "APP_RERANKER_ENABLED": "true", "APP_RERANKER_SERVERURL": "http://h:1",
     "APP_RERANKER_MODELENGINE": "tpu"},
    {"APP_LLM_MODELENGINE": "custom", "APP_LLM_SERVERURL": "http://h:1/v1",
     "APP_EMBEDDINGS_MODELENGINE": "bm25"},
], ids=["echo-hash", "test-fakes", "lexical", "remote", "tpu-with-urls",
        "url-selects-remote"])
def test_factory_dispatch_matches_jax(env):
    cfg = load_config(env=env)
    hub = EngineHub(cfg, device="cpu")  # never asked for an engine here
    assert _kinds(cfg, hub) == _jkinds(env)
    assert hub._llm is None and not hub._encoders_built


def test_factory_details_and_refusals(tmp_path):
    cfg = load_config(env={"APP_LLM_MODELENGINE": "nim",
                           "APP_EMBEDDINGS_MODELENGINE": "tfidf",
                           "APP_EMBEDDINGS_DIMENSIONS": "128",
                           "APP_VECTORSTORE_PERSISTDIR": str(tmp_path)})
    hub = EngineHub(cfg, device="cpu")
    llm = tfactory.get_llm(cfg, hub)
    assert llm.base_url == "http://localhost:8000/v1"
    assert llm.model == "llama3-8b-instruct"
    lex = tfactory.get_embedder(cfg, hub)
    assert lex.dim == 128
    assert lex.persist_path == str(tmp_path / "lexical_df.json")
    assert tfactory.get_reranker(cfg, hub) is None  # reranker off
    for section, env in (("llm", "APP_LLM_MODELENGINE"),
                         ("embeddings", "APP_EMBEDDINGS_MODELENGINE")):
        bad = load_config(env={env: "mystery"})
        get = tfactory.get_llm if section == "llm" else tfactory.get_embedder
        with pytest.raises(ValueError, match=f"unknown {section}"):
            get(bad, EngineHub(bad, device="cpu"))


def test_factory_advice_for_a_missing_embedder_works(tmp_path):
    """The error for a loaded LLM without encoder weights names
    model_engine=hash, and that setting then builds."""
    cfg = load_config(env={})
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, weights_path=str(tmp_path)))
    hub = EngineHub(cfg, llm=object(), device="cpu")
    with pytest.raises(RuntimeError, match="model_engine=hash"):
        tfactory.get_embedder(cfg, hub)
    fixed = dataclasses.replace(cfg, embeddings=dataclasses.replace(
        cfg.embeddings, model_engine="hash"))
    emb = tfactory.get_embedder(fixed, hub)
    assert isinstance(emb, tfakes.HashEmbedder)
    assert emb.dim == cfg.embeddings.dimensions


def test_hermetic_chain_resources_still_resolve_the_device(monkeypatch):
    """echo + hash need no engine, but the hub (and the device store)
    still resolve CUDA unless given the CPU."""
    import torch

    from generativeaiexamples_tpu_torch.pipelines.resources import Resources
    from generativeaiexamples_tpu_torch.rag.vectorstore import (
        DeviceVectorStore)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = {"APP_LLM_MODELENGINE": "echo",
           "APP_EMBEDDINGS_MODELENGINE": "hash",
           "APP_VECTORSTORE_NAME": "tpu"}
    cfg = load_config(env=env)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Resources(cfg)
    res = Resources(cfg, hub=EngineHub(cfg, device="cpu"))
    assert isinstance(res.llm, tfakes.EchoLLM)
    assert isinstance(res.store, DeviceVectorStore)
    assert res.store.device.type == "cpu"
