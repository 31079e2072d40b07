"""Port parity: cross-request micro-batching (serving/batcher.py) and its
wiring into the encoders, the stores, Resources and the chain server.

The MicroBatcher cases of tests/test_microbatch.py run against both
packages' batchers. Then both packages' encoder engines and stores over
the same weights (JAX init carried across with models/convert.py) and
rows: N threads at once with the batcher on give the vectors, scores and
ids the direct calls give (f32, atol 1e-5; the port's batched and direct
calls bit for bit), in fewer forwards, and the batcher counts them as the
JAX batcher does. Then the config knobs, Resources and /metrics.
"""

import dataclasses
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import bert as jb
from generativeaiexamples_tpu.rag.vectorstore import (
    MemoryVectorStore as JMemory, TPUVectorStore as JDevice)
from generativeaiexamples_tpu.serving import batcher as jbatch
from generativeaiexamples_tpu.serving.encoders import (
    EmbeddingEngine as JEmbed, RerankEngine as JRerank)
from generativeaiexamples_tpu.utils.tokenizer import ByteTokenizer as JTok
from generativeaiexamples_tpu_torch.config.schema import load_config
from generativeaiexamples_tpu_torch.models import bert as tb
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.rag.vectorstore import (
    DeviceVectorStore, MemoryVectorStore)
from generativeaiexamples_tpu_torch.serving import batcher as tbatch
from generativeaiexamples_tpu_torch.serving.encoders import (
    EmbeddingEngine, RerankEngine)
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

ATOL = 1e-5
WAIT_US = 200_000  # long window: thread skew on a slow host still merges
PACKAGES = [pytest.param(jbatch, id="jax"), pytest.param(tbatch, id="port")]


def _hammer(n, fn):
    """fn(i) on n threads released together; the results in order."""
    out, errs = [None] * n, []
    bar = threading.Barrier(n)

    def run(i):
        try:
            bar.wait()
            out[i] = fn(i)
        except BaseException as e:  # surfaced in the test thread
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    if errs:
        raise errs[0]
    return out


# -- the batcher (tests/test_microbatch.py's cases, both packages) ------


@pytest.mark.parametrize("mb", PACKAGES)
class TestMicroBatcher:
    def test_coalesces_concurrent_callers(self, mb):
        batches = []

        def fn(items):
            batches.append(list(items))
            return [x * 10 for x in items]

        b = mb.MicroBatcher("t", fn, max_batch=16, max_wait_us=WAIT_US)
        assert _hammer(8, b.submit) == [i * 10 for i in range(8)]
        snap = b.stats.snapshot()
        assert snap["submitted"] == 8 and snap["dispatches"] < 8
        assert snap["dispatches_saved"] == 8 - snap["dispatches"]
        assert snap["mean_batch_size"] > 1
        assert sum(len(g) for g in batches) == 8

    def test_bucket_keys_never_mix(self, mb):
        batches = []

        def fn(items):
            batches.append(list(items))
            return items

        b = mb.MicroBatcher("t", fn, max_batch=16, max_wait_us=WAIT_US,
                            bucket_fn=lambda x: x % 2)
        _hammer(10, b.submit)
        assert all(len({x % 2 for x in g}) == 1 for g in batches)

    def test_max_batch_caps_group_size(self, mb):
        batches = []

        def fn(items):
            batches.append(list(items))
            return items

        b = mb.MicroBatcher("t", fn, max_batch=4, max_wait_us=WAIT_US)
        _hammer(10, b.submit)
        assert all(len(g) <= 4 for g in batches)

    def test_submit_many_preserves_order(self, mb):
        b = mb.MicroBatcher("t", lambda xs: [x + 1 for x in xs],
                            max_batch=4, max_wait_us=0,
                            bucket_fn=lambda x: x % 3)
        assert b.submit_many(list(range(9))) == [i + 1 for i in range(9)]
        assert b.submit_many([]) == []

    def test_error_propagates_and_is_counted(self, mb):
        def fn(items):
            raise RuntimeError("boom")

        b = mb.MicroBatcher("t", fn, max_batch=16, max_wait_us=WAIT_US)
        with pytest.raises(RuntimeError, match="boom"):
            _hammer(4, b.submit)
        snap = b.stats.snapshot()
        assert snap["dispatch_errors"] == snap["dispatches"] > 0

    def test_result_length_mismatch_is_an_error(self, mb):
        b = mb.MicroBatcher("t", lambda xs: [1], max_batch=8,
                            max_wait_us=WAIT_US)
        with pytest.raises(RuntimeError, match="results"):
            _hammer(3, b.submit)

    def test_submit_after_close_raises(self, mb):
        b = mb.MicroBatcher("t", lambda xs: xs, max_batch=4, max_wait_us=0)
        assert b.submit("x") == "x"
        assert b.stats.snapshot()["dispatch_errors"] == 0
        b.close()
        with pytest.raises(mb.MicroBatcherClosed, match="closed"):
            b.submit("y")

    def test_rejects_bad_max_batch(self, mb):
        with pytest.raises(ValueError):
            mb.MicroBatcher("t", lambda xs: xs, max_batch=0)


def test_batcher_stress_no_lost_results_or_counts():
    """More threads than cores, a short switch interval, keyed groups and
    a disable racing the submitters: every caller gets its own result
    (through the batcher or, once it is closed, the direct path) and the
    counters add up."""
    import sys

    def fn(items):
        return [(x, x * x) for x in items]

    b = tbatch.MicroBatcher("stress", fn, max_batch=7, max_wait_us=50,
                            bucket_fn=lambda x: x % 3)
    direct = []

    def call(i):
        out = []
        for j in range(40):
            x = i * 1000 + j
            try:
                out.append(b.submit(x))
            except tbatch.MicroBatcherClosed:
                direct.append(x)
                out.append(fn([x])[0])
            if i == 0 and j == 30:
                b.close()
        return out

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = _hammer(24, call)
    finally:
        sys.setswitchinterval(old)
    for i, out in enumerate(got):
        assert out == [(i * 1000 + j, (i * 1000 + j) ** 2)
                       for j in range(40)]
    snap = b.stats.snapshot()
    assert snap["submitted"] == 24 * 40 - len(direct)
    assert snap["dispatches"] + snap["dispatches_saved"] == \
        snap["submitted"]
    assert snap["max_batch_size"] <= 7 and snap["dispatch_errors"] == 0


def test_sequential_dispatch_stats_match_jax():
    """A deterministic sequence (no threads): both packages' counters and
    snapshot keys agree exactly."""
    snaps = []
    for mb in (jbatch, tbatch):
        b = mb.MicroBatcher("t", lambda xs: xs, max_batch=4, max_wait_us=0,
                            bucket_fn=lambda x: x % 2)
        for items in ([1], [2, 4, 6, 8, 10], [3, 5]):
            b.submit_many(items)
        snap = b.stats.snapshot()
        snap.pop("queue_wait_p50_ms")
        snap.pop("queue_wait_p99_ms")
        snaps.append(snap)
    assert snaps[1] == snaps[0]
    assert snaps[1]["submitted"] == 8


# -- the encoders, on carried weights -----------------------------------

GEOM = dict(vocab_size=512, dim=64, n_layers=2, n_heads=2, mlp_dim=128,
            max_position=128)


def _carried(n_labels, seed):
    jcfg = jb.BertConfig(**GEOM, n_labels=n_labels, normalize=not n_labels)
    tcfg = tb.BertConfig(**GEOM, n_labels=n_labels, normalize=not n_labels)
    jparams = jb.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = convert.bert_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def embedders():
    jcfg, jparams, tcfg, tparams = _carried(0, seed=1)
    return (JEmbed(jparams, jcfg, JTok(), max_batch=8, use_pallas=False),
            EmbeddingEngine(tparams, tcfg, ByteTokenizer(), max_batch=8,
                            device="cpu"))


@pytest.fixture(scope="module")
def rerankers():
    jcfg, jparams, tcfg, tparams = _carried(1, seed=2)
    return (JRerank(jparams, jcfg, JTok(), max_batch=8, use_pallas=False),
            RerankEngine(tparams, tcfg, ByteTokenizer(), max_batch=8,
                         device="cpu"))


QUERIES = [f"query number {i} about subject {i % 3}" for i in range(12)]


def test_concurrent_embed_query_matches_direct_and_jax(embedders):
    jeng, teng = embedders
    want = np.stack([jeng.embed_query(t) for t in QUERIES])
    direct = np.stack([teng.embed_query(t) for t in QUERIES])
    np.testing.assert_allclose(direct, want, atol=ATOL, rtol=0)
    teng.forwards = 0
    teng.enable_microbatch(max_batch=16, max_wait_us=WAIT_US)
    try:
        got = np.stack(_hammer(len(QUERIES),
                               lambda i: teng.embed_query(QUERIES[i])))
        snap = teng.microbatch_stats()
    finally:
        teng.disable_microbatch()
    # Same [max_batch, S] forward, rows independent: bit for bit.
    assert np.array_equal(got, direct)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert snap["submitted"] == len(QUERIES)
    assert snap["dispatches"] < len(QUERIES)
    # A dispatch's rows pack max_batch (8) a forward.
    assert snap["dispatches"] <= teng.forwards < len(QUERIES)
    assert snap["mean_batch_size"] > 1
    assert teng.microbatch_stats() is None


def test_whole_call_is_one_item_like_jax(embedders):
    """A multi-text call is ONE submitted item in both packages: counters
    read in caller units, and a lone wide call saves nothing."""
    texts = [f"doc {i} " * (i % 5 + 1) for i in range(20)]
    snaps = []
    for eng in embedders:
        want = eng.embed(texts)
        eng.enable_microbatch(max_batch=8, max_wait_us=WAIT_US)
        try:
            got = eng.embed(texts)
            snaps.append(eng.microbatch_stats())
        finally:
            eng.disable_microbatch()
        assert np.array_equal(want, got)
    for s in snaps:
        s.pop("queue_wait_p50_ms")
        s.pop("queue_wait_p99_ms")
    assert snaps[1] == snaps[0]
    assert snaps[1]["submitted"] == 1 and snaps[1]["dispatches_saved"] == 0
    np.testing.assert_allclose(embedders[1].embed(texts),
                               embedders[0].embed(texts), atol=ATOL, rtol=0)


def test_short_calls_never_ride_long_buckets(embedders):
    _, teng = embedders
    texts = ["ab"] * 6 + ["x" * 60]  # buckets 32 and 128
    want = [teng.embed([t])[0] for t in texts]
    teng.enable_microbatch(max_batch=16, max_wait_us=WAIT_US)
    try:
        got = _hammer(len(texts), lambda i: teng.embed([texts[i]])[0])
        snap = teng.microbatch_stats()
    finally:
        teng.disable_microbatch()
    assert np.array_equal(np.stack(want), np.stack(got))
    assert snap["dispatches"] >= 2 and snap["max_batch_size"] <= 6


def test_closed_batcher_falls_back_to_the_same_forward(embedders):
    _, teng = embedders
    want = teng.embed_query("race me")
    b = teng.enable_microbatch(max_batch=8, max_wait_us=WAIT_US)
    try:
        b.close()  # a disable racing this caller
        got = teng.embed_query("race me")
    finally:
        teng.disable_microbatch()
    assert np.array_equal(want, got)


def test_concurrent_rerank_sets_split_back_and_match_jax(rerankers):
    jeng, teng = rerankers
    passages = [f"passage {i} with some words" for i in range(6)]
    jobs = [(f"question {i}", passages[: 3 + i % 3]) for i in range(8)]
    want = [jeng.score(q, ps) for q, ps in jobs]
    direct = [teng.score(q, ps) for q, ps in jobs]
    teng.forwards = 0
    teng.enable_microbatch(max_batch=16, max_wait_us=WAIT_US)
    try:
        got = _hammer(len(jobs), lambda i: teng.score(*jobs[i]))
        snap = teng.microbatch_stats()
    finally:
        teng.disable_microbatch()
    for w, d, g in zip(want, direct, got):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
        np.testing.assert_allclose(g, d, atol=ATOL, rtol=0)
        assert g.dtype == np.float32
    assert snap["submitted"] == len(jobs)
    assert snap["dispatches"] < snap["submitted"]
    # 32 pairs packed 8 a forward beat 8 sets of 3-5 pairs a forward each.
    assert teng.forwards < len(jobs)


# -- the stores ------------------------------------------------------------


def _rows(seed, n, dim):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    return vecs / np.linalg.norm(vecs, axis=1, keepdims=True), rng


@pytest.mark.parametrize("ours, theirs", [
    pytest.param(MemoryVectorStore, JMemory, id="memory"),
    pytest.param(lambda d: DeviceVectorStore(d, device="cpu"), JDevice,
                 id="device")])
def test_concurrent_search_matches_sequential_and_jax(ours, theirs):
    vecs, rng = _rows(0, 300, 16)
    tstore, jstore = ours(16), theirs(16)
    for st in (tstore, jstore):
        st.add([f"t{i}" for i in range(300)], vecs)
    queries = rng.standard_normal((16, 16)).astype(np.float32)
    want = [jstore.search(q, top_k=3) for q in queries]
    base = tstore.stats()
    tstore.enable_microbatch(max_batch=16, max_wait_us=WAIT_US)
    try:
        got = _hammer(16, lambda i: tstore.search(queries[i], top_k=3))
        snap = tstore.microbatch_stats()
    finally:
        tstore.disable_microbatch()
    for w, g in zip(want, got):
        assert [r.text for r in g] == [r.text for r in w]
        np.testing.assert_allclose([r.score for r in g],
                                   [r.score for r in w], atol=ATOL)
    assert snap["submitted"] == 16 and snap["dispatches"] < 16
    after = tstore.stats()
    # No padding: each caller is one search, each dispatch one batch.
    assert after["searches"] - base["searches"] == 16
    assert after["batched_searches"] - base["batched_searches"] <= \
        snap["dispatches"]
    assert tstore.microbatch_stats() is None


def test_search_group_keys_and_empty_store():
    vecs, rng = _rows(1, 64, 8)
    store = DeviceVectorStore(8, device="cpu")
    store.add([f"t{i}" for i in range(64)], vecs)
    q = rng.standard_normal((8,)).astype(np.float32)
    store.enable_microbatch(max_batch=16, max_wait_us=WAIT_US)
    try:
        got = _hammer(8, lambda i: store.search(q, top_k=1 + i % 2))
        out = store.search_batch(rng.standard_normal((4, 8)), top_k=2)
        submitted = store.microbatch_stats()["submitted"]
    finally:
        store.disable_microbatch()
    assert [len(r) for r in got] == [1 + i % 2 for i in range(8)]
    assert len(out) == 4 and submitted == 8  # search_batch stays direct
    empty = DeviceVectorStore(8, device="cpu")
    empty.enable_microbatch(max_batch=16, max_wait_us=WAIT_US)
    try:
        got = _hammer(3, lambda i: empty.search(np.ones(8, np.float32),
                                                top_k=2))
    finally:
        empty.disable_microbatch()
    assert got == [[], [], []] and empty.stats()["searches"] == 0


# -- the connector wrapper, config, Resources and /metrics ---------------


def test_connector_wrapper_matches_jax():
    from generativeaiexamples_tpu.connectors.fakes import (
        HashEmbedder as JHash)
    from generativeaiexamples_tpu_torch.connectors.fakes import HashEmbedder

    inner, jinner = HashEmbedder(32), JHash(32)
    wrapped = tbatch.enable_embedder_microbatch(inner, max_batch=16,
                                                max_wait_us=WAIT_US)
    assert isinstance(wrapped, tbatch.MicroBatchedEmbedder)
    got = np.stack(_hammer(12, lambda i: wrapped.embed_query(QUERIES[i])))
    assert np.array_equal(got, np.stack([jinner.embed_query(q)
                                         for q in QUERIES]))
    snap = wrapped.microbatch_stats()
    assert snap["submitted"] == 12 and snap["dispatches"] < 12
    assert wrapped.dim == 32
    assert np.array_equal(wrapped.embed_queries(QUERIES),
                          inner.embed_queries(QUERIES))
    assert tbatch.enable_reranker_microbatch(None) is None
    assert tbatch.microbatch_stats_of(None) is None


def test_engine_embedder_batched_at_engine_level(embedders):
    from generativeaiexamples_tpu_torch.connectors.local import LocalEmbedder

    conn = LocalEmbedder(embedders[1])
    try:
        assert tbatch.enable_embedder_microbatch(
            conn, max_batch=8, max_wait_us=1000) is conn
        assert tbatch.microbatch_stats_of(conn) is not None
    finally:
        embedders[1].disable_microbatch()


@pytest.mark.parametrize("source", ["env", "file"])
def test_microbatch_config_matches_jax(tmp_path, source):
    from generativeaiexamples_tpu.config.wizard import load_config as jload

    knobs = {"microbatch_enabled": True, "microbatch_max_batch": 32,
             "microbatch_max_wait_us": 500, "executor_workers": 8}
    if source == "env":
        env = {"APP_SERVING_MICROBATCHENABLED": "true",
               "APP_SERVING_MICROBATCHMAXBATCH": "32",
               "APP_SERVING_MICROBATCHMAXWAITUS": "500",
               "APP_SERVING_EXECUTORWORKERS": "8"}
    else:
        path = tmp_path / "c.json"
        path.write_text(json.dumps({"serving": knobs}))
        env = {"APP_CONFIG_FILE": str(path)}
    ours, theirs = load_config(env=env).serving, jload(env=env).serving
    assert {k: getattr(ours, k) for k in knobs} == knobs == {
        k: getattr(theirs, k) for k in knobs}
    default = load_config(env={}).serving
    assert (default.microbatch_enabled, default.microbatch_max_batch,
            default.microbatch_max_wait_us) == (False, 16, 2000)


def test_resources_and_chain_server_wiring(embedders, rerankers, tmp_path):
    """microbatch_enabled batches the hub's encoders and the device store;
    the chain server floors its executor at 2 x max_batch and /metrics
    serves the three stages; off, /metrics' microbatch is empty."""
    from generativeaiexamples_tpu_torch.api import server as tapi
    from generativeaiexamples_tpu_torch.connectors.factory import EngineHub

    emb, rr = embedders[1], rerankers[1]
    over = {"vector_store": {"name": "tpu"}, "reranker": {"enabled": True},
            "embeddings": {"dimensions": 64},
            "llm": {"model_engine": "echo"}}
    on = load_config(env={}, overrides={**over, "serving": {
        "microbatch_enabled": True, "microbatch_max_batch": 40,
        "executor_workers": 4}})
    hub = EngineHub(on, embed=emb, rerank=rr, device="cpu")
    app = tapi.ChainServer(on, hub=hub, upload_dir=str(tmp_path / "up"))
    httpd = tapi.make_http_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        res = app.example.res
        assert app._executor._max_workers == 80
        assert emb._batcher is not None and rr._batcher is not None
        assert res.store._batcher is not None
        res.store.add(["alpha beta", "gamma delta"],
                      emb.embed(["alpha beta", "gamma delta"]))
        req = urllib.request.Request(base + "/search", data=json.dumps(
            {"query": "alpha", "top_k": 1}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            assert len(json.loads(r.read())["chunks"]) == 1
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            mb = json.loads(r.read())["microbatch"]
        assert set(mb) == {"embed", "rerank", "search"}
        # The rows' embed call and the query's; the query's search.
        assert mb["embed"]["submitted"] == 2
        assert mb["search"]["submitted"] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
        app.close()
        for obj in (emb, rr, app.example.res.store):
            obj.disable_microbatch()
    off = dataclasses.replace(on, serving=dataclasses.replace(
        on.serving, microbatch_enabled=False))
    app = tapi.ChainServer(off, hub=EngineHub(off, embed=emb, rerank=rr,
                                              device="cpu"),
                           upload_dir=str(tmp_path / "up2"))
    try:
        assert app._executor._max_workers == 4
        assert app.metrics()[1]["microbatch"] == {}
    finally:
        app.close()
