"""Port parity: ops/ivf.py and the IVF life cycle of rag/vectorstore.py.

The same seed-made numpy corpora go through the JAX package's `ops/ivf.py`
and `TPUVectorStore` (jitted jnp on the CPU) and the port's `ops/ivf.py`
and `DeviceVectorStore` (torch on the CPU). Stated tolerances:

- a Lloyd step and k-means from equal initial centroids: centroids within
  atol 1e-5, assignments equal; `assign_partitions`, `centroid_candidates`
  and `balanced_assign` on equal centroids: equal; `rank_round_assign`,
  `_partition_lists` and `quantize_rows`: bit for bit;
- `IVFIndex` built from equal centroids and assignments (f32 and int8):
  ids equal, scores within atol 1e-5, scanned counts, tail slots,
  widening, the skew guard and `state()` equal;
- the store: `stats()` equal to JAX's in the flat, pending and ivf states
  (`backend` names each package's class), `ivf.npz` loads across the
  packages without training.

Then every case of tests/test_ann.py on the port's store (the sharded
index's: tests/test_torch_sharded_index.py).
"""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.ops import ivf as jivf
from generativeaiexamples_tpu.rag import vectorstore as jvs
from generativeaiexamples_tpu_torch.ops import ivf as tivf
from generativeaiexamples_tpu_torch.rag import vectorstore as vs_mod
from generativeaiexamples_tpu_torch.rag.vectorstore import (
    DeviceVectorStore, MemoryVectorStore)

DIM = 32
N_CLUSTERS = 48
SEED = 7
ATOL = 1e-5


def _clustered(n, dim=DIM, n_clusters=N_CLUSTERS, sigma=0.15, seed=SEED):
    """Synthetic clustered corpus (unit-norm rows), tests/test_ann.py's;
    queries drawn near cluster centers."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    data = centers[rng.integers(0, n_clusters, n)] + \
        sigma * rng.standard_normal((n, dim)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    return data.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _fill(store, vecs, filename="corpus.txt"):
    store.add([f"chunk-{i}" for i in range(len(vecs))], vecs,
              [{"filename": filename, "row": i} for i in range(len(vecs))])


def _store(**kw):
    return DeviceVectorStore(DIM, device="cpu", **kw)


def _ivf_store(vecs, **kw):
    kw.setdefault("index_type", "ivf")
    store = _store(**kw)
    _fill(store, vecs)
    return store


def _recall(store, flat_store, queries, k=4):
    hits = 0.0
    for q in queries:
        got = {r.text for r in store.search(q, top_k=k)}
        truth = {r.text for r in flat_store.search(q, top_k=k)}
        hits += len(got & truth) / max(1, len(truth))
    return hits / len(queries)


def _jax_init(data, nlist, seed=0):
    """The initial centroids JAX's kmeans_fit draws."""
    idx = jax.random.choice(jax.random.PRNGKey(seed), len(data), (nlist,),
                            replace=False)
    return np.asarray(data)[np.asarray(idx)]


# -- the training steps, against JAX ------------------------------------


class TestTrainingParity:
    def test_lloyd_step_matches_jax(self):
        data = _clustered(1024)
        init = _jax_init(data, 16)
        jc, ja = jivf._kmeans_step(jnp.asarray(data), jnp.asarray(init))
        tc, ta = tivf._kmeans_step(_t(data), _t(init))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))

    def test_lloyd_step_keeps_an_empty_partitions_centroid(self):
        data = _clustered(256)
        init = np.concatenate([data[:7], np.full((1, DIM), 9.0, np.float32)])
        jc, _ = jivf._kmeans_step(jnp.asarray(data), jnp.asarray(init))
        tc, ta = tivf._kmeans_step(_t(data), _t(init))
        assert not (ta.numpy() == 7).any()
        np.testing.assert_array_equal(tc.numpy()[7], init[7])
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL,
                                   rtol=0)

    def test_kmeans_fit_from_jax_init_matches_jax(self):
        data = _clustered(2048, sigma=0.1)
        jc, ja = jivf.kmeans_fit(data, 24, iters=6, seed=3)
        tc, ta = tivf.kmeans_fit(_t(data), 24, iters=6,
                                 init=_t(_jax_init(data, 24, seed=3)))
        np.testing.assert_allclose(tc.numpy(), jc, atol=ATOL, rtol=0)
        np.testing.assert_array_equal(ta.numpy(), ja)
        assert ta.dtype == torch.int32

    def test_kmeans_fit_is_deterministic_for_one_seed(self):
        data = _t(_clustered(1500))
        a = tivf.kmeans_fit(data, 16, seed=5)
        b = tivf.kmeans_fit(data, 16, seed=5)
        c = tivf.kmeans_fit(data, 16, seed=6)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert not torch.equal(a[0], c[0])
        g = torch.Generator().manual_seed(5)
        assert torch.equal(tivf.kmeans_fit(data, 16, generator=g)[0], a[0])

    def test_assign_candidates_and_balanced_assign_match_jax(self):
        data = _clustered(3000)
        cents, _ = jivf.kmeans_fit(data, 32)
        np.testing.assert_array_equal(
            tivf.assign_partitions(_t(data), _t(cents)).numpy(),
            np.asarray(jivf.assign_partitions(jnp.asarray(data),
                                              jnp.asarray(cents))))
        jo, jb = jivf.centroid_candidates(data, cents, chunk=1000)
        to, tb = tivf.centroid_candidates(_t(data), _t(cents), chunk=700)
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_allclose(tb, jb, atol=ATOL, rtol=0)
        np.testing.assert_array_equal(
            tivf.balanced_assign(_t(data), _t(cents)),
            jivf.balanced_assign(data, cents))
        assert tivf.assign_partitions(_t(data[:0]), _t(cents)).shape == (0,)

    def test_rank_round_assign_and_partition_lists_are_identical(self):
        rng = np.random.default_rng(0)
        n, nlist = 500, 12
        order = np.argsort(rng.random((n, nlist)), axis=1)[:, :4].astype(
            np.int32)
        best = rng.integers(0, 5, n).astype(np.float32)  # many ties
        for cap in (20, 42, 200):  # overflow to the emptiest, spill, none
            np.testing.assert_array_equal(
                tivf.rank_round_assign(order, best, nlist, cap),
                jivf.rank_round_assign(order, best, nlist, cap))
        assign = rng.integers(0, nlist + 2, n).astype(np.int32)
        (tl, tm), (jl, jm) = (tivf._partition_lists(assign, nlist + 3),
                              jivf._partition_lists(assign, nlist + 3))
        assert tm == jm and len(tl) == len(jl)
        for a, b in zip(tl, jl):
            np.testing.assert_array_equal(a, b)

    def test_quantize_rows_bit_identical(self):
        rng = np.random.default_rng(4)
        v = rng.standard_normal((64, DIM)).astype(np.float32) * \
            rng.uniform(1e-9, 10, (64, 1)).astype(np.float32)
        v[3] = 0.0
        v[5, :] = 1.27e-6
        jq, js = jivf.quantize_rows(jnp.asarray(v))
        tq, ts = tivf.quantize_rows(_t(v))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                      np.asarray(js).view(np.int32))
        # And over a 3-D partition table.
        jq, js = jivf.quantize_rows(jnp.asarray(v.reshape(4, 16, DIM)))
        tq, ts = tivf.quantize_rows(_t(v.reshape(4, 16, DIM)))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    def test_topk_orders_ties_by_the_lower_index_as_lax(self):
        x = np.array([[1, 3, 3, 0, 3, -np.inf, 2, 3]], np.float32)
        jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
        tv, ti = tivf._topk(_t(x), 6)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# -- IVFIndex on equal training state, against JAX ----------------------


def _index_pair(vecs, nlist=32, nprobe=8, quantize=False, **kw):
    c, a = jivf.kmeans_fit(vecs, nlist)
    a = jivf.balanced_assign(vecs, c)
    j = jivf.IVFIndex(vecs, nlist, nprobe=nprobe, quantize_int8=quantize,
                      centroids=c, assignments=a)
    t = tivf.IVFIndex(vecs, nlist, nprobe=nprobe, quantize_int8=quantize,
                      centroids=c, assignments=a, device="cpu", **kw)
    return j, t


def _same_search(j, t, qs, k):
    js, ji, jn = j.search(qs, k)
    ts, ti, tn = t.search(qs, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0)
    assert tn == jn


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
class TestIVFIndexParity:
    def test_search_matches_jax(self, quantize):
        vecs = _clustered(3000)
        j, t = _index_pair(vecs, quantize=quantize)
        assert t.max_list_len == j.max_list_len
        np.testing.assert_array_equal(t._g3.numpy(), np.asarray(j._g3))
        qs = _clustered(20, seed=SEED + 20)
        for k in (1, 4, 10):
            _same_search(j, t, qs, k)
        _same_search(j, t, qs, 4)
        # nprobe beyond nlist clamps, k beyond the probed rows pads -inf/-1
        _same_search(j, t, qs[:3], 7)
        js, ji, _ = j.search(qs[:2], 5000, nprobe=1)
        ts, ti, _ = t.search(qs[:2], 5000, nprobe=1)
        assert ti.shape == tuple(np.asarray(ji).shape)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert (ti.numpy() == -1).any() and np.isneginf(ts.numpy()).any()
        assert all(np.array_equal(a, b) for a, b in zip(
            j.state().values(), t.state().values()))

    def test_add_slots_widening_and_skew_guard_match_jax(self, quantize):
        vecs = _clustered(2000)
        j, t = _index_pair(vecs, quantize=quantize)
        qs = _clustered(12, seed=SEED + 21)
        for seed, n in ((1, 40), (2, 1), (3, 150)):
            new = _clustered(n, seed=seed)
            assert t.add(_t(new)) is j.add(new) is True
            assert (t.n_rows, t.max_list_len) == (j.n_rows, j.max_list_len)
            np.testing.assert_array_equal(t._g3.numpy(), np.asarray(j._g3))
            _same_search(j, t, qs, 4)
        # Widening: a burst into one region pads every partition's block.
        ml = t.max_list_len
        near = vecs[:1] + 0.02 * np.random.default_rng(9).standard_normal(
            (60, DIM)).astype(np.float32)
        near /= np.linalg.norm(near, axis=1, keepdims=True)
        assert t.add(_t(near)) is j.add(near) is True
        assert t.max_list_len == j.max_list_len > ml
        np.testing.assert_array_equal(t._g3.numpy(), np.asarray(j._g3))
        _same_search(j, t, near[:5], 4)
        # The skew guard refuses without mutating anything.
        before = t._g3.clone(), t.n_rows, t.max_list_len
        hot = np.tile(vecs[:1], (3000, 1))
        assert t.add(_t(hot)) is j.add(hot) is False
        assert torch.equal(t._g3, before[0])
        assert (t.n_rows, t.max_list_len) == before[1:]
        assert t.add(_t(hot[:0])) is True
        for a, b in zip(j.state().values(), t.state().values()):
            np.testing.assert_array_equal(a, b)

    def test_a_query_alone_equals_it_in_a_batch(self, quantize, monkeypatch):
        """Fixed shapes: a query's probes, ids and score bits do not
        depend on how many queries share its call, and the refine scores
        only the real queries (one [P*M, D] product each, no padding
        query gathering blocks)."""
        vecs = _clustered(3000)
        _, t = _index_pair(vecs, quantize=quantize)
        qs = _t(_clustered(37, seed=SEED + 22))
        bs, bi, bn = t.search(qs, 6)
        total = 0
        for r in range(len(qs)):
            s, i, n = t.search(qs[r:r + 1], 6)
            assert torch.equal(s[0], bs[r]) and torch.equal(i[0], bi[r])
            total += n
        assert total == bn
        shapes = []
        mv = torch.mv

        def counted(mat, vec):
            shapes.append(tuple(mat.shape))
            return mv(mat, vec)

        monkeypatch.setattr(torch, "mv", counted)
        t.search(qs[:1], 6)
        assert len(shapes) == 1
        t.search(qs, 6)
        assert len(shapes) == 1 + len(qs) and len(set(shapes)) == 1
        assert shapes[0] == (t.nprobe * t.max_list_len, DIM)


def test_ivf_entry_points_run_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vecs = _clustered(600)
    for make in (lambda: tivf.IVFIndex(vecs, 8),
                 lambda: tivf.kmeans_fit(vecs, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    idx = tivf.IVFIndex(vecs, 8, device="cpu")
    assert idx.centroids.device.type == "cpu"
    assert idx.table_bytes() == idx.nlist * idx.max_list_len * (DIM + 1) * 4


# -- the store's stats and ivf.npz, against JAX -------------------------


def _pair_stores(tmp_path, vecs, **kw):
    """A JAX store trains and saves at tmp/jax; then a JAX store and the
    port's store each load that directory (the same centroids and
    assignments, no search made yet)."""
    d = str(tmp_path / "jax")
    trained = jvs.TPUVectorStore(DIM, persist_dir=d, index_type="ivf", **kw)
    _fill(trained, vecs)
    trained.search(vecs[0], top_k=1)  # trains, writes ivf.npz
    j = jvs.TPUVectorStore(DIM, persist_dir=d, index_type="ivf", **kw)
    t = DeviceVectorStore(DIM, device="cpu", persist_dir=d,
                          index_type="ivf", **kw)
    return j, t


def test_stats_match_jax_in_flat_pending_and_ivf_states(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(jvs, "RECALL_SAMPLE_EVERY", 3)
    monkeypatch.setattr(vs_mod, "RECALL_SAMPLE_EVERY", 3)
    vecs = _clustered(1024)
    qs = _clustered(7, seed=SEED + 30)

    def same(t, j):
        ts, js = t.stats(), j.stats()
        assert ts.pop("backend") == "DeviceVectorStore"
        assert js.pop("backend") == "TPUVectorStore"
        assert ts == js

    for kw in ({}, {"index_type": "ivf"}):  # flat, and pending
        t, j = _store(**kw), jvs.TPUVectorStore(DIM, **kw)
        same(t, j)
        for s in (t, j):
            _fill(s, vecs[:100])
            s.search(qs[0], top_k=3)
            s.search_batch(qs, top_k=3)
        same(t, j)
    j, t = _pair_stores(tmp_path, vecs)
    same(t, j)  # pending: the loaded state trains at the first search
    same_ids = [[r.text for r in s.search(q, top_k=4)] for q in qs
                for s in (t, j)]
    assert same_ids[0::2] == same_ids[1::2]
    for s in (t, j):
        s.search_batch(qs, top_k=4)
    assert t.stats()["index"] == "ivf" and t.stats()["index_rebuilds"] == 0
    same(t, j)
    assert t.stats()["ann_recall_est"] is not None


def test_ivf_npz_loads_across_packages_without_training(tmp_path,
                                                        monkeypatch):
    vecs = _clustered(1024)
    qs = _clustered(5, seed=SEED + 31)

    def boom(*a, **k):
        raise AssertionError("a reload must not retrain k-means")

    # JAX saves; the port loads without k-means and returns JAX's ids.
    j, _ = _pair_stores(tmp_path, vecs)
    want = [[r.text for r in j.search(q, top_k=4)] for q in qs]
    monkeypatch.setattr(tivf, "kmeans_fit", boom)
    t = DeviceVectorStore(DIM, device="cpu", persist_dir=str(tmp_path / "jax"),
                          index_type="ivf")
    assert [[r.text for r in t.search(q, top_k=4)] for q in qs] == want
    assert t.stats()["index_rebuilds"] == 0
    monkeypatch.undo()
    # The port saves (its own training); JAX loads without k-means.
    d = str(tmp_path / "port")
    t = DeviceVectorStore(DIM, device="cpu", persist_dir=d, index_type="ivf")
    _fill(t, vecs)
    want = [[r.text for r in t.search(q, top_k=4)] for q in qs]
    assert os.path.isfile(os.path.join(d, "ivf.npz"))
    monkeypatch.setattr(jivf, "kmeans_fit", boom)
    j = jvs.TPUVectorStore(DIM, persist_dir=d, index_type="ivf")
    assert [[r.text for r in j.search(q, top_k=4)] for q in qs] == want
    assert j.stats()["index_rebuilds"] == 0
    with np.load(os.path.join(d, "ivf.npz")) as z:
        assert sorted(z.files) == ["assignments", "centroids"]
        assert z["assignments"].dtype == np.int32
        assert z["centroids"].dtype == np.float32


# -- tests/test_ann.py, case for case, on the port ----------------------


class TestKMeans:
    def test_shapes_and_clamping(self):
        data = _t(_clustered(300))
        c, a = tivf.kmeans_fit(data, 16, iters=4)
        assert c.shape == (16, DIM) and a.shape == (300,)
        assert a.min() >= 0 and a.max() < 16
        c2, _ = tivf.kmeans_fit(data[:5], 64)  # nlist clamps to N
        assert c2.shape[0] == 5

    def test_finds_cluster_structure(self):
        data = _t(_clustered(1024, n_clusters=8, sigma=0.05))
        _, a = tivf.kmeans_fit(data, 8, iters=10)
        sizes = np.bincount(a.numpy(), minlength=8)
        assert (sizes > 0).sum() >= 6


class TestIVFRecall:
    def test_recall_at_default_nprobe(self):
        vecs = _clustered(4096)
        flat = _store()
        _fill(flat, vecs)
        ivf = _ivf_store(vecs)  # config defaults: nlist=64, nprobe=16
        queries = _clustered(50, seed=SEED + 1)
        assert _recall(ivf, flat, queries) >= 0.9
        st = ivf.stats()
        assert st["index"] == "ivf"
        assert st["ann_probes"] > 0 and st["ann_scanned_rows"] > 0
        assert st["ann_scanned_rows"] < st["searches"] * len(vecs)

    def test_int8_quantized_recall(self):
        vecs = _clustered(4096, sigma=0.25)
        flat = _store()
        _fill(flat, vecs)
        ivf8 = _ivf_store(vecs, quantize_int8=True)
        queries = _clustered(50, seed=SEED + 2)
        assert _recall(ivf8, flat, queries) >= 0.8
        assert ivf8.stats()["quantize_int8"] is True
        assert ivf8._ivf._db3.dtype == torch.int8

    def test_small_corpus_stays_exact(self):
        vecs = _clustered(vs_mod.IVF_MIN_ROWS - 10)
        flat = _store()
        _fill(flat, vecs)
        ivf = _ivf_store(vecs)
        for qi in _clustered(5, seed=SEED + 3):
            a = [(r.text, round(r.score, 6)) for r in flat.search(qi, 4)]
            b = [(r.text, round(r.score, 6)) for r in ivf.search(qi, 4)]
            assert a == b  # the exact path, same ordering
        assert ivf.stats()["index"] == "flat(ivf pending)"

    def test_cosine_store_trains_on_normalized_rows(self):
        vecs = _clustered(1024) * np.random.default_rng(1).uniform(
            0.5, 3.0, (1024, 1)).astype(np.float32)
        flat = _store(metric="cosine")
        _fill(flat, vecs)
        ivf = _ivf_store(vecs, metric="cosine")
        queries = _clustered(20, seed=SEED + 4) * 2.0
        assert _recall(ivf, flat, queries) >= 0.9
        assert ivf.stats()["index"] == "ivf"


class TestIVFLifecycle:
    def test_background_trainer_failure_is_counted(self):
        store = _ivf_store(_clustered(512))
        assert store.stats()["background_errors"] == 0
        store._maybe_train_ivf = lambda: (_ for _ in ()).throw(
            RuntimeError("trainer boom"))
        store._kick_training_async()
        deadline = time.time() + 5
        while (store.stats()["background_errors"] == 0
               or store._train_busy) and time.time() < deadline:
            time.sleep(0.01)
        assert store.stats()["background_errors"] == 1
        assert store._train_busy is False

    def test_an_installed_index_leaves_no_device_copy_of_the_rows(self):
        """An ivf store keeps its rows on the host, as the JAX store keeps
        `_vecs`: the exact path's device mirror lives only while the
        store serves exact search and goes when the index installs (the
        index then holds its table and nothing of the corpus); a delete's
        exact fallback brings the mirror back. A flat store's rows are
        its device matrix."""
        vecs = _clustered(1024)
        flat = _store()
        _fill(flat, vecs)
        flat.search(vecs[0], top_k=1)
        assert flat._home == flat.device and flat._flat is flat.rows()
        store = _store(index_type="ivf")
        assert store._home.type == "cpu"
        store.add([f"a-{i}" for i in range(200)], _t(vecs[:200]),
                  [{"filename": "a.txt"} for _ in range(200)])
        store.search(vecs[0], top_k=1)  # below IVF_MIN_ROWS: exact
        assert store.stats()["index"] == "flat(ivf pending)"
        assert store._flat is not None
        store.add([f"b-{i}" for i in range(824)], _t(vecs[200:]),
                  [{"filename": "b.txt"} for _ in range(824)])
        store.search(vecs[0], top_k=1)  # trains and installs
        assert store.stats()["index"] == "ivf" and store._flat is None
        assert store.rows().device.type == "cpu"
        torch.testing.assert_close(store.rows(), _t(vecs))
        store.delete_documents(["a.txt"])
        store._refresh()  # the stale index drops to the exact path
        assert store._ivf is None and store._flat is not None
        torch.testing.assert_close(store._flat, _t(vecs[200:]))

    def test_add_after_train_assigns_without_rebuild(self):
        vecs = _clustered(2048)
        store = _ivf_store(vecs)
        store.search(vecs[0], top_k=1)  # trains
        assert store.stats()["index"] == "ivf"
        extra = _clustered(64, seed=SEED + 4)
        store.add([f"new-{i}" for i in range(len(extra))], extra,
                  [{"filename": "new.txt"} for _ in extra])
        res = store.search(extra[0], top_k=4)
        assert any(r.text.startswith("new-") for r in res)
        assert store.stats()["index_rebuilds"] == 0

    def test_growth_triggers_rebuild(self):
        vecs = _clustered(512)
        store = _ivf_store(vecs)
        store.search(vecs[0], top_k=1)  # trains at 512 rows
        extra = _clustered(400, seed=SEED + 5)  # > 50% growth
        store.add([f"g-{i}" for i in range(len(extra))], extra)
        store.search(vecs[0], top_k=1)
        assert store.stats()["index_rebuilds"] == 1

    def test_delete_triggers_rebuild_and_excludes_rows(self):
        vecs = _clustered(1024)
        store = _store(index_type="ivf")
        half = len(vecs) // 2
        store.add([f"keep-{i}" for i in range(half)], vecs[:half],
                  [{"filename": "keep.txt"} for _ in range(half)])
        store.add([f"drop-{i}" for i in range(half)], vecs[half:],
                  [{"filename": "drop.txt"} for _ in range(half)])
        store.search(vecs[0], top_k=1)  # trains
        assert store.delete_documents(["drop.txt"]) == half
        res = store.search(vecs[-1], top_k=8)
        assert res and all(r.text.startswith("keep-") for r in res)
        assert store.stats()["index_rebuilds"] == 1
        assert store.delete_documents(["keep.txt"]) == half
        assert store.stats()["index"] == "flat(ivf pending)"

    def test_hot_partition_add_falls_back_to_rebuild(self):
        vecs = _clustered(1024)
        store = _ivf_store(vecs)
        store.search(vecs[0], top_k=1)  # trains
        hot = vecs[0] + 0.01 * np.random.default_rng(0).standard_normal(
            (300, DIM)).astype(np.float32)  # all land in one partition
        hot /= np.linalg.norm(hot, axis=1, keepdims=True)
        store.add([f"hot-{i}" for i in range(len(hot))], hot)
        # the overflow-detecting search serves the exact fallback
        res = store.search(hot[0], top_k=4)
        assert any(r.text.startswith("hot-") for r in res)
        # ...and the next search rebuilds the clustered index
        res = store.search(hot[0], top_k=4)
        assert any(r.text.startswith("hot-") for r in res)
        st = store.stats()
        assert st["index"] == "ivf" and st["index_rebuilds"] == 1
        n = len(store)
        assert store._ivf.max_list_len <= 4 * max(1, n // store._ivf.nlist)

    def test_recall_estimate_gauge(self, monkeypatch):
        monkeypatch.setattr(vs_mod, "RECALL_SAMPLE_EVERY", 2)
        vecs = _clustered(1024)
        store = _ivf_store(vecs)
        for q in _clustered(6, seed=SEED + 6):
            store.search(q, top_k=4)
        est = store.stats()["ann_recall_est"]
        assert est is not None and 0.0 <= est <= 1.0

    def test_microbatched_searches_train_off_the_dispatcher(self):
        """From the micro-batcher, training runs on the background
        thread; the coalesced searches serve the exact path meanwhile and
        the index lands for later ones."""
        vecs = _clustered(1024)
        store = _ivf_store(vecs)
        store.enable_microbatch(max_batch=8, max_wait_us=2000)
        try:
            out = [None] * 8
            ths = [threading.Thread(target=lambda i=i: out.__setitem__(
                i, store.search(vecs[i], top_k=1))) for i in range(8)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=60)
            assert [o[0].text for o in out] == [f"chunk-{i}"
                                                for i in range(8)]
            deadline = time.time() + 30
            while store._train_busy and time.time() < deadline:
                time.sleep(0.01)
            assert store.search(vecs[9], top_k=1)[0].text == "chunk-9"
            assert store.stats()["index"] == "ivf"
        finally:
            store.disable_microbatch()


class TestSearchBatch:
    @pytest.mark.parametrize("make", [lambda: MemoryVectorStore(DIM), _store,
                                      lambda: _store(index_type="ivf")],
                             ids=["memory", "device", "device-ivf"])
    def test_batched_matches_sequential(self, make):
        vecs = _clustered(300)
        store = make()
        _fill(store, vecs)
        queries = _clustered(8, seed=SEED + 7)
        seq = [store.search(q, top_k=3) for q in queries]
        bat = store.search_batch(queries, top_k=3)
        assert len(bat) == len(queries)
        for a, b in zip(seq, bat):
            assert [r.text for r in a] == [r.text for r in b]
            np.testing.assert_allclose([r.score for r in a],
                                       [r.score for r in b], atol=1e-5)

    def test_ivf_batch_is_one_dispatch(self):
        vecs = _clustered(2048)
        store = _ivf_store(vecs)
        queries = _clustered(6, seed=SEED + 8)
        before = store.stats()["batched_searches"]
        out = store.search_batch(queries, top_k=4)
        assert len(out) == 6 and all(out)
        assert store.stats()["batched_searches"] == before + 1

    def test_rejects_1d_queries(self):
        with pytest.raises(ValueError):
            _store().search_batch(np.zeros((DIM,), np.float32))


class TestPersistence:
    def test_ivf_save_load_roundtrip_skips_training(self, tmp_path,
                                                    monkeypatch):
        vecs = _clustered(1024)
        d = str(tmp_path)
        store = _store(persist_dir=d, index_type="ivf")
        _fill(store, vecs)
        q = _clustered(4, seed=SEED + 11)
        first = [[r.text for r in store.search(qi, top_k=4)] for qi in q]
        assert os.path.isfile(os.path.join(d, "ivf.npz"))

        def boom(*a, **k):
            raise AssertionError("reload must not retrain k-means")

        monkeypatch.setattr(tivf, "kmeans_fit", boom)
        store2 = _store(persist_dir=d, index_type="ivf")
        assert len(store2) == len(store)
        again = [[r.text for r in store2.search(qi, top_k=4)] for qi in q]
        assert again == first

    def test_sidecar_rewritten_after_incremental_add(self, tmp_path):
        vecs = _clustered(512)
        d = str(tmp_path)
        store = _store(persist_dir=d, index_type="ivf")
        _fill(store, vecs)
        store.search(vecs[0], top_k=1)  # trains, writes sidecar
        store.add(["late"], _clustered(1, seed=SEED + 12))
        assert not os.path.isfile(os.path.join(d, "ivf.npz"))
        store.search(vecs[0], top_k=1)
        assert os.path.isfile(os.path.join(d, "ivf.npz"))

    def test_noop_delete_keeps_index(self):
        vecs = _clustered(512)
        store = _ivf_store(vecs)
        store.search(vecs[0], top_k=1)  # trains
        assert store.delete_documents(["not-there.txt"]) == 0
        store.search(vecs[0], top_k=1)
        assert store.stats()["index_rebuilds"] == 0

    def test_stale_ivf_sidecar_is_ignored(self, tmp_path):
        vecs = _clustered(512)
        d = str(tmp_path)
        store = _store(persist_dir=d, index_type="ivf")
        _fill(store, vecs)
        store.search(vecs[0], top_k=1)
        np.savez_compressed(os.path.join(d, "ivf.npz"),
                            centroids=np.zeros((4, DIM), np.float32),
                            assignments=np.zeros((3,), np.int32))
        store2 = _store(persist_dir=d, index_type="ivf")
        assert store2._loaded_ivf_state is None
        assert store2.search(vecs[0], top_k=2)  # retrained fine
        assert store2.stats()["index"] == "ivf"

    def test_save_is_atomic_under_midwrite_crash(self, tmp_path,
                                                 monkeypatch):
        vecs = _clustered(512)
        d = str(tmp_path)
        store = _ivf_store(vecs)
        store.search(vecs[0], top_k=1)
        store.save(d)
        n0 = len(store)
        assert os.path.isfile(os.path.join(d, "ivf.npz"))
        store.add(["extra"], np.zeros((1, DIM), np.float32))

        calls = {"n": 0}
        real_dumps = json.dumps

        def flaky(obj, *a, **k):
            calls["n"] += 1
            if calls["n"] > 3:
                raise OSError("disk gone mid-write")
            return real_dumps(obj, *a, **k)

        monkeypatch.setattr(vs_mod.json, "dumps", flaky)
        with pytest.raises(OSError):
            store.save(d)
        monkeypatch.undo()
        # previous snapshot intact (its sidecar too), no temp debris
        loaded = _store(persist_dir=d, index_type="ivf")
        assert len(loaded) == n0 and loaded._loaded_ivf_state is not None
        assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


class TestRetrieverBatching:
    def _retriever(self, **kw):
        from generativeaiexamples_tpu_torch.connectors.fakes import (
            HashEmbedder)
        from generativeaiexamples_tpu_torch.rag.retriever import Retriever

        emb = HashEmbedder(dim=64)
        store = DeviceVectorStore(64, device="cpu", index_type="ivf")
        texts = ["TPUs multiply matrices fast", "bananas are yellow",
                 "HBM is high bandwidth memory", "apples can be green"]
        store.add(texts, emb.embed_documents(texts),
                  [{"filename": "t.txt"} for _ in texts])
        return Retriever(store, emb, top_k=2, **kw)

    def test_retrieve_batch_aligns_and_falls_back(self):
        r = self._retriever(score_threshold=0.99)
        out = r.retrieve_batch(["TPU matrices", "zzz nonsense query"])
        assert len(out) == 2
        assert out[0] and out[1]  # both non-empty via threshold fallback

    def test_retrieve_multi_single_dispatch(self):
        r = self._retriever(score_threshold=None)
        before = r.store.stats()["batched_searches"]
        assert r.retrieve_multi(["TPU matrix hardware", "HBM bandwidth",
                                 "memory speed"])
        assert r.store.stats()["batched_searches"] == before + 1

    def test_hybrid_extra_queries_batched(self):
        from generativeaiexamples_tpu_torch.connectors.fakes import (
            OverlapReranker)

        r = self._retriever(reranker=OverlapReranker())
        before = r.store.stats()["batched_searches"]
        assert r.retrieve_hybrid("TPU matrices",
                                 extra_queries=["HBM memory bandwidth"])
        assert r.store.stats()["batched_searches"] == before + 1


class TestMetricsSurface:
    def test_chain_server_metrics_exposes_store_stats(self, tmp_path):
        """An IVF store behind the port's chain server: /metrics carries
        its gauges, and /search serves through the index."""
        import urllib.request

        from generativeaiexamples_tpu_torch.api import server as tapi
        from generativeaiexamples_tpu_torch.config.schema import load_config
        from generativeaiexamples_tpu_torch.connectors.factory import (
            EngineHub)

        cfg = load_config(env={"APP_LLM_MODELENGINE": "echo",
                               "APP_EMBEDDINGS_MODELENGINE": "hash",
                               "APP_EMBEDDINGS_DIMENSIONS": "64",
                               "APP_VECTORSTORE_NAME": "tpu",
                               "APP_VECTORSTORE_INDEXTYPE": "ivf",
                               "APP_VECTORSTORE_NLIST": "8"})
        app = tapi.ChainServer(cfg, hub=EngineHub(cfg, device="cpu"),
                               upload_dir=str(tmp_path / "up"))
        store = app.example.res.store
        assert isinstance(store, DeviceVectorStore)
        assert (store.index_type, store.nlist) == ("ivf", 8)
        texts = [f"passage {i} about topic {i % 7}" for i in range(300)]
        store.add(texts, app.example.res.embedder.embed_documents(texts))
        httpd = tapi.make_http_server(app, "127.0.0.1", 0)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            req = urllib.request.Request(
                base + "/search", data=json.dumps(
                    {"query": "topic 3", "top_k": 2}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert len(json.loads(r.read())["chunks"]) == 2
            with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
                st = json.loads(r.read())["vector_store"]
        finally:
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=10)
            app.close()
        for key in ("index", "ntotal", "searches", "ann_probes",
                    "ann_scanned_rows", "ann_recall_est", "index_rebuilds",
                    "background_errors", "nlist", "nprobe"):
            assert key in st
        assert st["index"] == "ivf" and st["ann_probes"] > 0
