"""Port parity of the slice as a whole: the developer_rag chain behind the
port's ChainServer, on the CPU, against the JAX package's chain.

Both sides use the same carried weights: a tiny f32 Llama (JAX init,
vocabulary 259 so the byte tokenizer's <eos> exists), the JAX launcher's
hermetic tiny BERT embedder and reranker (ranked_hybrid retrieval is
live). The port serves over HTTP from its device store; the JAX side is
its `QAChatbot` over a `TPUVectorStore` fed by its `EmbeddingEngine`,
with an offline `greedy_generate` on the prompt its chain builds (no JAX
LLMEngine: see tests/test_torch_chunked_prefill.py). The RAG prompt is
longer than the engine's largest bucket, so the answer goes through
chunked prefill. Ids and texts must be equal, scores within f32 atol
1e-4, and the streamed answer equal to the oracle's text.
"""

import dataclasses
import json
import threading
import types
import urllib.error
import urllib.request
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.config.schema import AppConfig as JAppConfig
from generativeaiexamples_tpu.connectors.local import (
    LocalEmbedder as JLocalEmbedder, LocalReranker as JLocalReranker)
from generativeaiexamples_tpu.models import bert as jb
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.pipelines.developer_rag import (
    QAChatbot as JQAChatbot)
from generativeaiexamples_tpu.pipelines.resources import (
    Resources as JResources)
from generativeaiexamples_tpu.rag.vectorstore import TPUVectorStore
from generativeaiexamples_tpu.serving.encoders import (
    EmbeddingEngine as JEmbed, RerankEngine as JRerank)
from generativeaiexamples_tpu.utils.tokenizer import (
    ByteTokenizer as JTok, StreamDetokenizer as JDetok)
from generativeaiexamples_tpu_torch.api import server as tapi
from generativeaiexamples_tpu_torch.config.schema import load_config
from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
from generativeaiexamples_tpu_torch.connectors.local import LocalEngineLLM
from generativeaiexamples_tpu_torch.models import bert as tb
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.pipelines.resources import Resources
from generativeaiexamples_tpu_torch.rag.vectorstore import DeviceVectorStore
from generativeaiexamples_tpu_torch.serving.encoders import (
    EmbeddingEngine, RerankEngine)
from generativeaiexamples_tpu_torch.serving.engine import LLMEngine
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

ATOL = 1e-4
ECFG = dict(max_batch_size=4, max_seq_len=2048, page_size=16,
            prefill_buckets=(64, 256))
CHAIN = {"text_splitter": {"chunk_size": 40, "chunk_overlap": 10},
         "reranker": {"enabled": True}, "embeddings": {"dimensions": 32}}
EMPTY_KB = ("No response generated from LLM, make sure your query is "
            "relevant to the ingested document.")
WORDS = ("matrix memory bandwidth kernel tensor cache page token prompt "
         "engine retrieval vector search answer model layer").split()


def _corpus(seed, n_sentences=40):
    rng = np.random.default_rng(seed)
    return " ".join(" ".join(rng.choice(WORDS, rng.integers(5, 12)))
                    .capitalize() + "." for _ in range(n_sentences))


class _CaptureLLM:
    """JAX-side chat connector that records the messages it is given."""

    def __init__(self):
        self.messages = None

    def stream_chat(self, messages, **kw):
        self.messages = list(messages)
        return iter(())


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    jcfg = jl.LlamaConfig.tiny(vocab_size=259)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(11))
    teng = LLMEngine(convert.llama_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32),
        tl.LlamaConfig.tiny(vocab_size=259), ByteTokenizer(), ECFG,
        device="cpu").start()
    ecfg = jb.BertConfig.tiny(vocab_size=512)
    rcfg = dataclasses.replace(ecfg, n_labels=1, normalize=False)
    eparams = jb.init_params(ecfg, jax.random.PRNGKey(1))
    rparams = jb.init_params(rcfg, jax.random.PRNGKey(2))

    def carried(p):
        return convert.bert_params_from_numpy(jax.tree.map(np.asarray, p),
                                              "cpu", torch.float32)

    temb = EmbeddingEngine(carried(eparams), tb.BertConfig.tiny(512),
                           ByteTokenizer(), device="cpu")
    trr = RerankEngine(carried(rparams), dataclasses.replace(
        tb.BertConfig.tiny(512), n_labels=1, normalize=False),
        ByteTokenizer(), device="cpu")
    config = load_config(env={}, overrides={
        **CHAIN, "vector_store": {"name": "tpu"}})
    hub = EngineHub(config, llm=teng, embed=temb, rerank=trr, device="cpu")
    app = tapi.ChainServer(config, hub=hub, upload_dir=str(
        tmp_path_factory.mktemp("uploads")))
    httpd = tapi.make_http_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()

    jconfig = JAppConfig()
    jconfig = dataclasses.replace(jconfig, **{
        sec: dataclasses.replace(getattr(jconfig, sec), **kw)
        for sec, kw in CHAIN.items()})
    capture = _CaptureLLM()
    jres = JResources(jconfig, llm=capture,
                      embedder=JLocalEmbedder(JEmbed(eparams, ecfg, JTok(),
                                                     use_pallas=False)),
                      reranker=JLocalReranker(JRerank(rparams, rcfg, JTok(),
                                                      use_pallas=False)),
                      store=TPUVectorStore(32))
    yield {"base": f"http://127.0.0.1:{httpd.server_address[1]}",
           "app": app, "jchain": JQAChatbot(jres), "capture": capture,
           "jcfg": jcfg, "jparams": jparams,
           "tmp": tmp_path_factory.mktemp("docs")}
    httpd.shutdown()
    httpd.server_close()
    th.join(timeout=10)
    app.close()
    teng.stop()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=300)


def _get(url, method="GET"):
    req = urllib.request.Request(url, method=method)
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _upload(base, filename, text):
    boundary = uuid.uuid4().hex
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{filename}\"\r\nContent-Type: text/plain\r\n\r\n"
            f"{text}\r\n--{boundary}--\r\n").encode()
    req = urllib.request.Request(
        base + "/documents", data=body,
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _generate(base, query, **kw):
    body = {"messages": [{"role": "user", "content": query}], **kw}
    frames = []
    with _post(base + "/generate", body) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: "):
                frames.append(json.loads(line[6:]))
    assert frames[-1]["choices"][0]["finish_reason"] == "[DONE]"
    assert len({f["id"] for f in frames}) == 1
    return "".join(f["choices"][0]["message"]["content"] for f in frames)


def test_empty_knowledge_base_short_circuit_and_health(sides):
    base = sides["base"]
    assert _generate(base, "what is a page?", use_knowledge_base=True,
                     max_tokens=4) == EMPTY_KB
    assert _get(base + "/health") == (200, {"message": "Service is up."})
    status, metrics = _get(base + "/metrics")
    assert metrics["vector_store"]["backend"] == "DeviceVectorStore"
    assert metrics["microbatch"] == {}


def test_ingest_search_generate_delete_match_jax(sides):
    base, jchain = sides["base"], sides["jchain"]
    files = {"alpha.txt": _corpus(1), "beta.md": _corpus(2)}
    for name, text in files.items():
        assert _upload(base, name, text) == {
            "message": f"File {name} uploaded successfully"}
        path = sides["tmp"] / name
        path.write_text(text)
        jchain.ingest_docs(str(path), name)
    assert _get(base + "/documents") == (200, {"documents": sorted(files)})
    assert len(sides["app"].example.res.store) == len(jchain.res.store) > 10

    for query in ("matrix kernel bandwidth", "token page cache"):
        with _post(base + "/search", {"query": query, "top_k": 5}) as r:
            got = json.loads(r.read())["chunks"]
        want = jchain.document_search(query, 5)
        assert [(c["content"], c["filename"]) for c in got] == \
            [(c["content"], c["filename"]) for c in want]
        np.testing.assert_allclose([c["score"] for c in got],
                                   [c["score"] for c in want], atol=ATOL,
                                   rtol=0)

    query, n_new = "How does the engine use page memory", 24
    list(jchain.rag_chain(query, [], temperature=0.0, max_tokens=n_new))
    tk = JTok()
    ids = tk.encode(tk.apply_chat_template(sides["capture"].messages,
                                           add_generation_prompt=True))
    assert len(ids) > ECFG["prefill_buckets"][-1]  # chunked prefill
    out = jl.greedy_generate(sides["jparams"], sides["jcfg"],
                             jnp.asarray([ids], jnp.int32), n_new,
                             use_pallas=False)
    detok, want = JDetok(tk), ""
    for t in np.asarray(out)[0, len(ids):].tolist():
        if t == tk.eos_id:
            break
        want += detok.push(t)
    assert want  # a non-empty answer, so the comparison says something
    assert _generate(base, query, use_knowledge_base=True, temperature=0,
                     max_tokens=n_new) == want

    assert _get(base + "/documents?filename=alpha.txt", "DELETE") == (
        200, {"message": "Deleted alpha.txt"})
    assert _get(base + "/documents") == (200, {"documents": ["beta.md"]})
    for path, method, code in (("/documents?filename=alpha.txt", "DELETE",
                                404), ("/documents", "DELETE", 422),
                               ("/nope", "GET", 404)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + path, method)
        assert e.value.code == code


def test_generate_without_knowledge_base_and_bad_bodies(sides):
    base = sides["base"]
    text = _generate(base, "hello", use_knowledge_base=False, max_tokens=3,
                     temperature=0)
    assert isinstance(text, str)
    for body in ({"messages": []}, {"foo": 1}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/generate", body)
        assert e.value.code == 422
    req = urllib.request.Request(
        base + "/documents", data=b"x",
        headers={"Content-Type": "multipart/form-data; boundary=zz"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 422
    assert tapi.sanitize("<b>\x00hi</b>") == "&lt;b&gt;hi&lt;/b&gt;"


class _FailingEngine:
    """An engine that fails every request, as LLMEngine does when a
    prefill, a chunk or a decode block raises."""

    tokenizer = ByteTokenizer()

    def generate_stream(self, prompt_ids, **kw):
        yield {"text": "", "token_id": -1, "finished": True,
               "finish_reason": "error"}


def test_engine_failure_reaches_the_client_as_an_error_frame(tmp_path):
    """A failed request is not a short answer: the connector raises and
    the chain server streams its error frame before [DONE]."""
    with pytest.raises(RuntimeError, match="engine failed"):
        list(LocalEngineLLM(_FailingEngine()).stream_chat(
            [{"role": "user", "content": "hi"}]))
    cfg = load_config(env={}, overrides={"vector_store": {"name": "tpu"}})
    ecfg = tb.BertConfig.tiny(512)
    emb = EmbeddingEngine(tb.init_params(ecfg, "cpu"), ecfg, ByteTokenizer(),
                          device="cpu")
    app = tapi.ChainServer(cfg, hub=EngineHub(
        cfg, llm=_FailingEngine(), embed=emb, device="cpu"),
        upload_dir=str(tmp_path))
    try:
        frames = [json.loads(f.decode()[len("data: "):])
                  for f in app.generate_frames("hi", [], False,
                                               {"max_tokens": 4})]
    finally:
        app.close()
    texts = [f["choices"][0]["message"]["content"] for f in frames]
    assert texts[0].startswith("Error from chain server")
    assert "RuntimeError" in texts[0]
    assert frames[-1]["choices"][0]["finish_reason"] == "[DONE]"


def test_resources_build_store_and_hybrid_from_config():
    cfg = load_config(env={}, overrides={"vector_store": {"name": "tpu"}})
    tk = ByteTokenizer()
    ecfg = tb.BertConfig.tiny(512)
    emb = EmbeddingEngine(tb.init_params(ecfg, "cpu"), ecfg, tk,
                          device="cpu")
    hub = EngineHub(cfg, llm=types.SimpleNamespace(tokenizer=tk), embed=emb,
                    device="cpu")
    res = Resources(cfg, hub=hub)
    assert isinstance(res.store, DeviceVectorStore)
    assert res.store.dim == 32 and res.reranker is None
    assert not res.retriever.default_hybrid


def test_app_config_defaults_and_env_overlay_match_jax():
    """The port's chain sections keep the JAX config's names and defaults
    (prompt texts included), and the APP_<SECTION>_<FIELD> overlay reads
    the same variables the same way."""
    from generativeaiexamples_tpu.config.wizard import load_config as jload

    port, jax_cfg = load_config(env={}), JAppConfig()
    for f in dataclasses.fields(port):
        if f.name == "engine":
            continue  # the port's EngineConfig is its own slice
        ours = dataclasses.asdict(getattr(port, f.name))
        theirs = dataclasses.asdict(getattr(jax_cfg, f.name))
        assert {k: theirs[k] for k in ours} == ours, f.name
    env = {"APP_RETRIEVER_TOPK": "7", "APP_VECTORSTORE_NAME": "tpu",
           "APP_RERANKER_ENABLED": "true",
           "APP_RETRIEVER_SCORETHRESHOLD": "0.5",
           "APP_TEXTSPLITTER_CHUNKSIZE": "100",
           "APP_ENGINE_PREFILLBUCKETS": "[64, 128]"}
    ours, theirs = load_config(env=env), jload(path="", env=env)
    for sec, name in (("retriever", "top_k"), ("vector_store", "name"),
                      ("reranker", "enabled"),
                      ("retriever", "score_threshold"),
                      ("text_splitter", "chunk_size"),
                      ("engine", "prefill_buckets")):
        assert getattr(getattr(ours, sec), name) == getattr(
            getattr(theirs, sec), name), (sec, name)
    for var, item in (("APP_VECTORSTORE_INDEXTYPE", "A.18"),
                      ("APP_ENGINE_STEPPLANS", "A.14")):
        value = "ivf" if "INDEX" in var else "true"
        with pytest.raises(ValueError, match=item):
            load_config(env={var: value})
    # Query augmentation, fact check, micro-batching, tracing and the
    # decode K cap are ported: read as the JAX wizard reads them.
    env = {"APP_RETRIEVER_QUERYAUGMENTATION": "rewrite,hyde",
           "APP_RETRIEVER_FACTCHECK": "true",
           "APP_SERVING_MICROBATCHENABLED": "1",
           "APP_SERVING_MICROBATCHMAXBATCH": "8",
           "APP_TRACING_ENABLED": "true",
           "APP_ENGINE_PREFILLDECODEKCAP": "4"}
    ours, theirs = load_config(env=env), jload(path="", env=env)
    for sec, name in (("retriever", "query_augmentation"),
                      ("retriever", "fact_check"),
                      ("serving", "microbatch_enabled"),
                      ("serving", "microbatch_max_batch"),
                      ("tracing", "enabled"),
                      ("engine", "prefill_decode_k_cap")):
        assert getattr(getattr(ours, sec), name) == getattr(
            getattr(theirs, sec), name), (sec, name)
    with pytest.raises(ValueError, match="unknown config"):
        load_config(env={}, overrides={"retriever": {"nope": 1}})
    # A JAX-only variable left at its default passes.
    assert load_config(env={"APP_ENGINE_SPECULATIVEK": "0"}) == port
