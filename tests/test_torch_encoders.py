"""Port parity: serving/encoders.py (EmbeddingEngine, RerankEngine) and
their OpenAI routes.

Both packages' engines run the same carried weights over the same texts
with the byte tokenizer. The texts' lengths span every bucket and more
texts than one batch holds, so length sorting, bucketing, padding rows
and the batch split all take part. The JAX engines run their XLA path on
the CPU. f32 atol 1e-4 on embeddings and scores.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import bert as jb
from generativeaiexamples_tpu.serving.encoders import (
    EmbeddingEngine as JEmbed, RerankEngine as JRerank)
from generativeaiexamples_tpu.utils.tokenizer import ByteTokenizer as JTok
from generativeaiexamples_tpu_torch.models import bert as tb
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.serving import openai_server as tos
from generativeaiexamples_tpu_torch.serving.encoders import (
    EmbeddingEngine, RerankEngine)
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

ATOL = 1e-4
GEOM = dict(vocab_size=512, dim=128, n_layers=2, n_heads=2, mlp_dim=256,
            max_position=128)
rng = np.random.default_rng(0)
TEXTS = ["".join(chr(97 + int(c)) if c < 26 else " " for c in
                 rng.integers(0, 30, n)) for n in
         (3, 150, 40, 7, 90, 31, 128, 12, 60, 200)]


def _carried(n_labels, seed):
    jcfg = jb.BertConfig(**GEOM, n_labels=n_labels,
                         normalize=not n_labels)
    tcfg = tb.BertConfig(**GEOM, n_labels=n_labels, normalize=not n_labels)
    jparams = jb.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = convert.bert_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def embedders():
    jcfg, jparams, tcfg, tparams = _carried(0, seed=1)
    return (JEmbed(jparams, jcfg, JTok(), max_batch=4, use_pallas=False),
            EmbeddingEngine(tparams, tcfg, ByteTokenizer(), max_batch=4,
                            device="cpu"))


@pytest.fixture(scope="module")
def rerankers():
    jcfg, jparams, tcfg, tparams = _carried(1, seed=2)
    return (JRerank(jparams, jcfg, JTok(), max_batch=4, use_pallas=False),
            RerankEngine(tparams, tcfg, ByteTokenizer(), max_batch=4,
                         device="cpu"))


@pytest.mark.parametrize("is_query", [False, True])
def test_embed_matches_jax(embedders, is_query):
    jeng, teng = embedders
    assert teng.buckets == jeng.buckets == [32, 128, 128]
    got = teng.embed(TEXTS, is_query=is_query)
    want = jeng.embed(TEXTS, is_query=is_query)
    assert got.dtype == np.float32 and got.shape == (len(TEXTS), 128)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_embed_query_and_empty(embedders):
    jeng, teng = embedders
    np.testing.assert_allclose(teng.embed_query("where is it?"),
                               jeng.embed_query("where is it?"), atol=ATOL,
                               rtol=0)
    assert teng.embed([]).shape == (0, 128)
    assert teng.dim == 128


def test_rerank_score_matches_jax(rerankers):
    jeng, teng = rerankers
    query = "relevant passages about " + TEXTS[2]
    got = teng.score(query, TEXTS)
    np.testing.assert_allclose(got, jeng.score(query, TEXTS), atol=ATOL,
                               rtol=0)
    assert got.shape == (len(TEXTS),) and got.dtype == np.float32
    assert teng.score(query, []).shape == (0,)


def test_engines_refuse_what_they_do_not_take(embedders):
    cfg = tb.BertConfig.tiny()
    params = tb.init_params(cfg, "cpu")
    with pytest.raises(ValueError, match="n_labels"):
        RerankEngine(params, cfg, ByteTokenizer(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A.11"):
        embedders[1].enable_microbatch()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=60)


def test_openai_embeddings_and_ranking_routes(embedders, rerankers):
    jemb, temb = embedders
    jrr, trr = rerankers
    app = tos.OpenAIServer(None, temb, trr)
    httpd = tos.make_http_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with _post(base + "/v1/embeddings",
                   {"input": TEXTS[:3], "input_type": "query"}) as r:
            body = json.loads(r.read())
        assert body["object"] == "list" \
            and body["model"] == tos.EMBED_MODEL_NAME
        assert [d["index"] for d in body["data"]] == [0, 1, 2]
        np.testing.assert_allclose(
            np.array([d["embedding"] for d in body["data"]]),
            jemb.embed(TEXTS[:3], is_query=True), atol=ATOL, rtol=0)
        with _post(base + "/v1/ranking", {
                "query": {"text": "q"},
                "passages": [{"text": t} for t in TEXTS[:4]]}) as r:
            ranks = json.loads(r.read())["rankings"]
        want = jrr.score("q", TEXTS[:4])
        assert [x["index"] for x in ranks] == list(np.argsort(-want))
        np.testing.assert_allclose([x["logit"] for x in ranks],
                                   np.sort(want)[::-1], atol=ATOL, rtol=0)
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            health = json.loads(r.read())
        assert health["engines"] == {"llm": False, "embedding": True,
                                     "reranking": True}
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/v1/ranking", {"query": {}, "passages": []})
        assert e.value.code == 422
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
