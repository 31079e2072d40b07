"""Port parity of the slice as a whole: the multi_turn_rag chain behind
the port's ChainServer on the CPU, two turns, against the JAX package's
chain.

Both sides carry the same weights (tests/test_torch_rag.py's: a tiny f32
Llama with vocabulary 259, the JAX launcher's tiny BERT embedder and
reranker, so ranked_hybrid retrieval is live). The port serves over HTTP
from two device stores on the CPU, the documents' and the conversation
memory's. The JAX side is its `MultiTurnChatbot` over `TPUVectorStore`s
fed by its `EmbeddingEngine`; its LLM answers each prompt the chain
builds with the offline `greedy_generate` (no JAX LLMEngine: see
tests/test_torch_chunked_prefill.py), so each side saves its own answer
into its own memory. Each turn's system prompt must be equal, each
streamed answer equal to the oracle's text byte for byte, and the
conversation stores equal in text, with history-search scores within
f32 atol 1e-4.
"""

import dataclasses
import threading

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
from generativeaiexamples_tpu.pipelines.multi_turn_rag import (
    MultiTurnChatbot as JMultiTurn)
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
from generativeaiexamples_tpu_torch.models import bert as tb
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.rag.vectorstore import DeviceVectorStore
from generativeaiexamples_tpu_torch.serving.encoders import (
    EmbeddingEngine, RerankEngine)
from generativeaiexamples_tpu_torch.serving.engine import LLMEngine
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer
from test_torch_rag import (  # the developer_rag slice test's helpers
    ATOL, CHAIN, ECFG, _corpus, _generate, _get, _upload)

N_NEW = 16
TURNS = ("How does the engine use page memory?",
         "What did I ask about the engine just now?")


class _OracleLLM:
    """JAX-side chat connector: records each call's messages and answers
    with the offline greedy_generate of their chat prompt."""

    def __init__(self, params, cfg):
        self.params, self.cfg, self.calls = params, cfg, []

    def stream_chat(self, messages, *, max_tokens=1024, **kw):
        self.calls.append(list(messages))
        tk = JTok()
        ids = tk.encode(tk.apply_chat_template(messages,
                                               add_generation_prompt=True))
        out = jl.greedy_generate(self.params, self.cfg,
                                 jnp.asarray([ids], jnp.int32), max_tokens,
                                 use_pallas=False)
        detok, text = JDetok(tk), ""
        for t in np.asarray(out)[0, len(ids):].tolist():
            if t == tk.eos_id:
                break
            text += detok.push(t)
        yield text


class _Recording:
    """Port-side wrapper of the chain's LLM connector that records the
    messages of each call."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def stream_chat(self, messages, **kw):
        self.calls.append(list(messages))
        yield from self.inner.stream_chat(messages, **kw)


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
    app = tapi.ChainServer(config, hub=hub, example_name="multi_turn_rag",
                           upload_dir=str(tmp_path_factory.mktemp("up")))
    app.example.res.llm = _Recording(app.example.res.llm)
    httpd = tapi.make_http_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()

    jconfig = JAppConfig()
    jconfig = dataclasses.replace(jconfig, **{
        sec: dataclasses.replace(getattr(jconfig, sec), **kw)
        for sec, kw in CHAIN.items()})
    oracle = _OracleLLM(jparams, jcfg)
    jres = JResources(jconfig, llm=oracle,
                      embedder=JLocalEmbedder(JEmbed(eparams, ecfg, JTok(),
                                                     use_pallas=False)),
                      reranker=JLocalReranker(JRerank(rparams, rcfg, JTok(),
                                                      use_pallas=False)),
                      store=TPUVectorStore(32), conv_store=TPUVectorStore(32))
    yield {"base": f"http://127.0.0.1:{httpd.server_address[1]}",
           "app": app, "jchain": JMultiTurn(jres), "oracle": oracle,
           "tmp": tmp_path_factory.mktemp("docs")}
    httpd.shutdown()
    httpd.server_close()
    th.join(timeout=10)
    app.close()
    teng.stop()


def _history(res, query, k=2):
    """The conversation store's hits for `query`: (texts, scores)."""
    hits = res.conv_store.search(res.embedder.embed_query(query), top_k=k)
    return [h.text for h in hits], [h.score for h in hits]


def test_two_turns_match_jax(sides):
    base, jchain, oracle = sides["base"], sides["jchain"], sides["oracle"]
    res = sides["app"].example.res
    assert isinstance(res.conv_store, DeviceVectorStore)
    assert res.conv_store.device.type == "cpu"
    for name, seed in (("alpha.txt", 1), ("beta.md", 2)):
        text = _corpus(seed)
        _upload(base, name, text)
        path = sides["tmp"] / name
        path.write_text(text)
        jchain.ingest_docs(str(path), name)
    assert len(res.store) == len(jchain.res.store) > 10

    answers = []
    for turn, query in enumerate(TURNS):
        want = "".join(jchain.rag_chain(query, [], temperature=0.0,
                                        max_tokens=N_NEW))
        got = _generate(base, query, use_knowledge_base=True, temperature=0,
                        max_tokens=N_NEW)
        answers.append(got)
        # The prompt the chain built, then the answer byte for byte.
        assert res.llm.calls[turn] == oracle.calls[turn]
        assert got == want
        assert len(res.conv_store) == len(jchain.res.conv_store) == turn + 1
    assert any(answers)  # a non-empty answer: the comparison says something

    saved = [d["text"] for d in res.conv_store.snapshot_docs()]
    assert saved == [d["text"] for d in jchain.res.conv_store.snapshot_docs()]
    assert saved == [f"User: {q}\nAssistant: {a}"
                     for q, a in zip(TURNS, answers)]
    # The second turn's prompt carries the first turn's saved text, in
    # both packages.
    for calls in (res.llm.calls, oracle.calls):
        assert saved[0] in calls[1][0]["content"]
        assert "Conversation history:\n" + saved[0] in calls[1][0]["content"]
    np.testing.assert_allclose(res.conv_store.rows().numpy(),
                               jchain.res.conv_store._vecs, atol=ATOL,
                               rtol=0)
    for query in (*TURNS, "engine memory"):
        got_t, got_s = _history(res, query)
        want_t, want_s = _history(jchain.res, query)
        assert got_t == want_t
        np.testing.assert_allclose(got_s, want_s, atol=ATOL, rtol=0)
    status, metrics = _get(base + "/metrics")
    assert metrics["conv_store"]["backend"] == "DeviceVectorStore"
    assert metrics["conv_store"]["ntotal"] == 2
    assert metrics["vector_store"]["ntotal"] == len(res.store)
