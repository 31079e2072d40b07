"""Port parity: ops/tiered.py and the tiered store.

The JAX package's `TieredIVFIndex` (jitted jnp on the CPU) and the port's
(torch on the CPU) get the same corpus, centroids, assignments and
budgets, then one and the same sequence of queries, adds and maintenance
passes. Stated tolerances: the spill file byte for byte; hot slots,
`part2slot` and every `tier_stats` counter equal and the probe EMA within
1e-9 after each `run_maintenance`; search ids equal. Then every case of
tests/test_tiered_ann.py (HBM budgets tiny, so the pager pages in every
test) on the port (its lint cases stay with ROADMAP A.21).
"""

import glob as globlib
import os
import threading

import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.ops import ivf as jivf
from generativeaiexamples_tpu.ops import tiered as jtiered
from generativeaiexamples_tpu.rag import vectorstore as jvs
from generativeaiexamples_tpu_torch.ops import tiered as tiered_mod
from generativeaiexamples_tpu_torch.ops.ivf import IVFIndex
from generativeaiexamples_tpu_torch.ops.tiered import TieredIVFIndex
from generativeaiexamples_tpu_torch.rag.vectorstore import (
    DeviceVectorStore, MemoryVectorStore)

DIM = 32
SEED = 11


def _clustered(n, dim=DIM, n_clusters=48, sigma=0.12, seed=SEED,
               center_ids=None):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    cids = rng.integers(0, n_clusters, n) if center_ids is None \
        else rng.choice(center_ids, n)
    data = centers[cids] + \
        sigma * rng.standard_normal((n, dim)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    return data.astype(np.float32)


def _tiny_tiered(vecs, tmp_path, *, nlist=32, nprobe=8, budget=1 << 16,
                 **kw):
    return TieredIVFIndex(vecs, nlist, nprobe=nprobe,
                          hbm_budget_bytes=budget, spill_dir=str(tmp_path),
                          device="cpu", **kw)


def _ids(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                      np.int64)


# -- against JAX --------------------------------------------------------


def _pair(vecs, tmp_path, *, nlist=32, budget=1 << 16, **kw):
    cents, _ = jivf.kmeans_fit(vecs, nlist)
    assign = jivf.balanced_assign(vecs, cents)
    common = dict(nprobe=8, hbm_budget_bytes=budget, centroids=cents,
                  assignments=assign, **kw)
    j = jtiered.TieredIVFIndex(vecs, nlist, spill_dir=str(tmp_path / "j"),
                               **common)
    t = TieredIVFIndex(vecs, nlist, spill_dir=str(tmp_path / "t"),
                       device="cpu", **common)
    return j, t


def _spill(tmp_path, who):
    with open(os.path.join(str(tmp_path / who), tiered_mod.SPILL_FILE),
              "rb") as fh:
        return fh.read()


def _same_tiers(j, t):
    assert t.tier_stats() == j.tier_stats()
    np.testing.assert_array_equal(t._slot_part, j._slot_part)
    np.testing.assert_array_equal(t._p2s, j._p2s)
    np.testing.assert_array_equal(t._p2s_dev.numpy(), np.asarray(j._p2s_dev))
    np.testing.assert_allclose(t._ema, j._ema, atol=1e-9, rtol=0)
    np.testing.assert_array_equal(t._hot_gids.numpy(),
                                  np.asarray(j._hot_gids))
    assert (t._hot_width, t._hot_slots, t.max_list_len) == (
        j._hot_width, j._hot_slots, j.max_list_len)


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_tiers_move_as_jax_through_one_query_sequence(tmp_path, quantize):
    """Spill bytes, residency, the EMA, every counter and the ids after
    the same searches, pager rounds, adds and a compaction."""
    vecs = _clustered(4000)
    j, t = _pair(vecs, tmp_path, budget=1 << 17, quantize_int8=quantize)
    assert _spill(tmp_path, "t") == _spill(tmp_path, "j")
    _same_tiers(j, t)
    qs = _clustered(24, seed=2)
    for seed, cids in ((3, [0, 1, 2]), (4, [40, 41, 42]), (5, [7, 8])):
        for q in _clustered(60, seed=seed, center_ids=cids):
            (_, ji, _), (_, ti, _) = (j.search(q[None, :], 4),
                                      t.search(q[None, :], 4))
            np.testing.assert_array_equal(_ids(ti), _ids(ji))
        j.run_maintenance()
        t.run_maintenance()
        _same_tiers(j, t)
        (js, ji, jn), (ts, ti, tn) = j.search(qs, 4), t.search(qs, 4)
        np.testing.assert_array_equal(_ids(ti), _ids(ji))
        np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
        assert tn == jn
    assert t.tier_stats()["tier_promotions"] > 0
    assert t.tier_stats()["tier_demotions"] > 0
    # Adds land in tails as JAX's do; the skew guard refuses alike.
    new = _clustered(300, seed=6)
    assert t.add(torch.from_numpy(new)) is j.add(new) is True
    hot = np.tile(vecs[:1], (6000, 1))
    assert t.add(hot) is j.add(hot) is False
    _same_tiers(j, t)
    np.testing.assert_array_equal(_ids(t.search(new[:8], 3)[1]),
                                  _ids(j.search(new[:8], 3)[1]))
    # Compaction rewrites the spill byte for byte as JAX's.
    j._compact()
    t._compact()
    assert _spill(tmp_path, "t") == _spill(tmp_path, "j")
    _same_tiers(j, t)
    np.testing.assert_array_equal(_ids(t.search(qs, 4)[1]),
                                  _ids(j.search(qs, 4)[1]))
    for a, b in zip(j.state().values(), t.state().values()):
        np.testing.assert_array_equal(a, b)


def test_warm_cache_and_maintenance_gate_match_jax(tmp_path):
    vecs = _clustered(3000)
    j, t = _pair(vecs, tmp_path, ram_budget_bytes=40_000)
    for q in _clustered(40, seed=12):
        j.search(q[None, :], 4)
        t.search(q[None, :], 4)
    assert sorted(t._warm) == sorted(j._warm)
    assert t._warm_bytes == j._warm_bytes <= 40_000
    assert t.maintenance_due() == j.maintenance_due()
    _same_tiers(j, t)


def test_trains_on_the_same_sample_as_jax(tmp_path, monkeypatch):
    """Without centroids the index trains k-means on a numpy-rng sample:
    the same rows as JAX's (k-means then starts from the port's own draw),
    and the balanced assignment caps every list."""
    vecs = _clustered(3000)
    seen = {}
    for name, mod in (("jax", jtiered), ("port", tiered_mod)):
        real = mod.kmeans_fit

        def spy(sample, nlist, _real=real, _name=name, **kw):
            seen[_name] = np.array(sample.cpu() if isinstance(
                sample, torch.Tensor) else sample)
            return _real(sample, nlist, **kw)

        monkeypatch.setattr(mod, "kmeans_fit", spy)
    jtiered.TieredIVFIndex(vecs, 32, spill_dir=str(tmp_path / "j"),
                           train_sample_rows=1000, seed=4)
    idx = _tiny_tiered(vecs, tmp_path / "t", train_sample_rows=1000, seed=4)
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    assert seen["port"].shape == (1000, DIM)
    st = idx.state()
    assert st["centroids"].shape == (32, DIM)
    assert np.bincount(st["assignments"], minlength=32).max() <= \
        int(1.25 * 3000 / 32) + 1


def test_tiered_entry_points_run_on_cuda_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TieredIVFIndex(_clustered(500), 8, spill_dir=str(tmp_path))
    assert _tiny_tiered(_clustered(500), tmp_path).device.type == "cpu"


# -- tests/test_tiered_ann.py, case for case, on the port ---------------


class TestTieredIndex:
    def test_matches_plain_ivf_ids(self, tmp_path):
        vecs = _clustered(4000)
        qs = _clustered(16, seed=1)
        tiered = _tiny_tiered(vecs, tmp_path)
        st = tiered.state()
        plain = IVFIndex(vecs, 32, nprobe=8, centroids=st["centroids"],
                         assignments=st["assignments"], device="cpu")
        _, ids_t, _ = tiered.search(qs, 4)
        _, ids_p, _ = plain.search(qs, 4)
        assert np.array_equal(_ids(ids_p), _ids(ids_t))

    def test_promotion_demotion_roundtrip(self, tmp_path):
        vecs = _clustered(4000)
        qs = _clustered(24, seed=2)
        idx = _tiny_tiered(vecs, tmp_path, budget=1 << 17)
        _, before, _ = idx.search(qs, 4)
        for seed, cids in ((3, [0, 1, 2]), (4, [40, 41, 42])):
            for q in _clustered(160, seed=seed, center_ids=cids):
                idx.search(q[None, :], 4)
            idx.run_maintenance()
        ts = idx.tier_stats()
        assert ts["tier_promotions"] > 0
        assert ts["tier_demotions"] > 0
        assert 0 < ts["hbm_resident_fraction"] < 1.0
        _, after, _ = idx.search(qs, 4)
        assert np.array_equal(before, after)

    def test_add_lands_in_tails_and_is_searchable(self, tmp_path):
        vecs = _clustered(2000)
        idx = _tiny_tiered(vecs, tmp_path)
        new = _clustered(64, seed=5)
        assert idx.add(new)
        assert idx.tier_stats()["tier_tail_rows"] == 64
        _, ids, _ = idx.search(new[:1], 1)
        assert int(ids[0, 0]) == 2000

    def test_add_skew_guard_refuses(self, tmp_path):
        vecs = _clustered(2000)
        idx = _tiny_tiered(vecs, tmp_path)
        n0 = idx.n_rows
        hot = np.tile(vecs[:1], (3000, 1))
        assert not idx.add(hot)
        assert idx.n_rows == n0
        assert idx.tier_stats()["tier_tail_rows"] == 0

    def test_compaction_folds_tails(self, tmp_path):
        vecs = _clustered(3000)
        idx = _tiny_tiered(vecs, tmp_path)
        idx.add(_clustered(600, seed=6))
        qs = _clustered(8, seed=7)
        _, before, _ = idx.search(qs, 4)
        idx._compact()
        ts = idx.tier_stats()
        assert ts["tier_compactions"] == 1
        assert ts["tier_tail_rows"] == 0
        assert ts["tier_spill_bytes"] == 3600 * DIM * 4
        _, after, _ = idx.search(qs, 4)
        assert np.array_equal(before, after)

    def test_spill_rewrite_is_crash_safe(self, tmp_path, monkeypatch):
        vecs = _clustered(3000)
        idx = _tiny_tiered(vecs, tmp_path)
        spill = os.path.join(str(tmp_path), tiered_mod.SPILL_FILE)
        with open(spill, "rb") as fh:
            old = fh.read()
        idx.add(_clustered(500, seed=8))
        qs = _clustered(8, seed=9)
        _, before, _ = idx.search(qs, 4)

        def boom(src, dst):
            raise OSError("disk full")

        monkeypatch.setattr(tiered_mod.os, "replace", boom)
        with pytest.raises(OSError):
            idx._compact()
        monkeypatch.undo()
        with open(spill, "rb") as fh:
            assert fh.read() == old  # previous snapshot intact
        assert not globlib.glob(spill + "*.tmp")  # no tmp litter
        assert idx.tier_stats()["tier_compactions"] == 0
        _, after, _ = idx.search(qs, 4)  # still serving (base + tails)
        assert np.array_equal(before, after)
        idx._compact()  # and a later compaction succeeds
        assert idx.tier_stats()["tier_compactions"] == 1

    def test_kick_maintenance_counts_errors(self, tmp_path, monkeypatch):
        idx = _tiny_tiered(_clustered(1000), tmp_path)
        monkeypatch.setattr(idx, "run_maintenance",
                            lambda: (_ for _ in ()).throw(RuntimeError()))
        seen = []
        assert idx.kick_maintenance(on_error=lambda: seen.append(1))
        assert idx.wait_maintenance()
        assert idx.tier_stats()["tier_bg_errors"] == 1
        assert seen == [1]

    def test_compaction_window_never_hides_folded_rows(self, tmp_path,
                                                       monkeypatch):
        vecs = _clustered(3000)
        idx = _tiny_tiered(vecs, tmp_path, budget=1 << 20)  # all hot
        assert idx.tier_stats()["hbm_resident_fraction"] == 1.0
        new = _clustered(8, seed=30)
        idx.add(new)
        _, ids, _ = idx.search(new[:1], 1)
        assert int(ids[0, 0]) == 3000
        monkeypatch.setattr(idx, "_refill_hot", lambda want: None)
        idx._compact()  # install lands; the hot refill "hasn't yet"
        assert idx.tier_stats()["hbm_resident_rows"] == 0  # demoted
        _, ids, _ = idx.search(new[:1], 1)
        assert int(ids[0, 0]) == 3000  # host refine serves the window
        monkeypatch.undo()
        idx._refill_hot(list(range(idx.nlist)))
        _, ids, _ = idx.search(new[:1], 1)
        assert int(ids[0, 0]) == 3000

    def test_warm_insert_drops_stale_epoch_blocks(self, tmp_path):
        idx = _tiny_tiered(_clustered(1000), tmp_path)
        blk = np.ones((4, DIM), np.float32)
        with idx._lock:
            idx._warm_insert(3, blk, idx._epoch - 1)  # stale generation
        assert 3 not in idx._warm
        with idx._lock:
            idx._warm_insert(3, blk, idx._epoch)  # current generation
        assert 3 in idx._warm

    def test_search_snapshot_survives_concurrent_compaction(self,
                                                            tmp_path):
        vecs = _clustered(3000)
        idx = _tiny_tiered(vecs, tmp_path)
        idx.add(_clustered(400, seed=21))
        qs = _clustered(8, seed=22)
        _, before, _ = idx.search(qs, 4)
        orig = idx._host_refine
        fired = []

        def racing(qs_, pids, hit_mask, tails, mm, off, base_gids,
                   warm, epoch):
            if not fired:
                fired.append(1)
                idx._compact()  # lands between snapshot and host refine
            return orig(qs_, pids, hit_mask, tails, mm, off, base_gids,
                        warm, epoch)

        idx._host_refine = racing
        _, during, _ = idx.search(qs, 4)
        idx._host_refine = orig
        assert fired
        assert np.array_equal(before, during)
        _, after, _ = idx.search(qs, 4)  # and the new epoch serves too
        assert np.array_equal(before, after)

    def test_rebalance_leaves_a_held_table_unchanged(self, tmp_path):
        """A tier move installs new device tensors: a search that took
        its snapshot before the move reads the table it took."""
        vecs = _clustered(4000)
        idx = _tiny_tiered(vecs, tmp_path, budget=1 << 17)
        held = idx._hot_db
        copy = held.clone()
        for q in _clustered(100, seed=3, center_ids=[0, 1]):
            idx.search(q[None, :], 4)
        idx.run_maintenance()
        assert idx.tier_stats()["tier_promotions"] > 0
        assert idx._hot_db is not held and torch.equal(held, copy)

    def test_state_roundtrip_rebuilds_identically(self, tmp_path):
        vecs = _clustered(2000)
        a = _tiny_tiered(vecs, tmp_path / "a")
        st = a.state()
        b = TieredIVFIndex(vecs, 32, nprobe=8, hbm_budget_bytes=1 << 16,
                           spill_dir=str(tmp_path / "b"),
                           centroids=st["centroids"],
                           assignments=st["assignments"], device="cpu")
        qs = _clustered(8, seed=10)
        _, ia, _ = a.search(qs, 4)
        _, ib, _ = b.search(qs, 4)
        assert np.array_equal(ia, ib)


class TestTieredStore:
    def _store(self, vecs, **kw):
        kw.setdefault("index_type", "ivf")
        kw.setdefault("nlist", 32)
        kw.setdefault("nprobe", 8)
        kw.setdefault("tiered", True)
        kw.setdefault("hbm_budget_mb", 1)
        store = DeviceVectorStore(DIM, device="cpu", **kw)
        store.recall_sample_every = 1 << 30
        store.add([f"chunk-{i}" for i in range(len(vecs))], vecs)
        return store

    def test_config_validation(self):
        with pytest.raises(ValueError, match="index_type=ivf"):
            DeviceVectorStore(DIM, device="cpu", index_type="flat",
                              tiered=True)
        with pytest.raises(ValueError, match="flat | ivf"):
            DeviceVectorStore(DIM, device="cpu", index_type="hnsw")

    def test_store_serves_and_reports_tier_counters(self):
        # 6000 rows x 32 lists -> pow2 block width 256 -> ~34 KB per f32
        # slot: the 1 MB floor budget holds 31 of 32 partitions.
        vecs = _clustered(6000)
        store = self._store(vecs, nprobe=16)
        out = store.search(vecs[5], top_k=4)
        plain = self._store(vecs, nprobe=16, tiered=False)
        expect = plain.search(vecs[5], top_k=4)
        assert [r.text for r in out] == [r.text for r in expect]
        s = store.stats()
        assert s["index"] == "ivf_tiered"
        assert s["tiered"] is True
        assert 0 < s["hbm_resident_fraction"] < 1.0
        for key in ("pager_hbm_hit_rate", "tier_promotions",
                    "tier_demotions", "tier_compactions",
                    "hbm_resident_rows", "tier_hot_slots"):
            assert key in s

    def test_stats_match_jax_store(self, tmp_path):
        """The JAX store trains and saves; each package's store loads the
        directory (same centroids) and serves the same searches: equal
        stats in the ivf_tiered state, `backend` apart."""
        vecs = _clustered(6000)
        d = str(tmp_path / "s")
        kw = dict(index_type="ivf", nlist=32, nprobe=16, tiered=True,
                  hbm_budget_mb=1)
        trained = jvs.TPUVectorStore(DIM, persist_dir=d, **kw)
        trained.add([f"chunk-{i}" for i in range(len(vecs))], vecs)
        trained.search(vecs[0], top_k=1)
        j = jvs.TPUVectorStore(DIM, persist_dir=d, **kw)
        t = DeviceVectorStore(DIM, device="cpu", persist_dir=d, **kw)
        for q in _clustered(12, seed=40):
            assert [r.text for r in t.search(q, top_k=4)] == [
                r.text for r in j.search(q, top_k=4)]
        for s in (t, j):
            s.search_batch(_clustered(5, seed=41), top_k=4)
            s._ivf.wait_maintenance()
        ts, js = t.stats(), j.stats()
        assert (ts.pop("backend"), js.pop("backend")) == (
            "DeviceVectorStore", "TPUVectorStore")
        assert ts == js and ts["index"] == "ivf_tiered"
        assert t._tier_spill_dir() == os.path.join(d, "tiered")

    def test_tier_counters_always_present_when_off(self):
        for store in (MemoryVectorStore(DIM),
                      DeviceVectorStore(DIM, device="cpu"),
                      DeviceVectorStore(DIM, device="cpu",
                                        index_type="ivf")):
            s = store.stats()
            assert s["tiered"] is False
            assert s["hbm_resident_fraction"] is None
            assert s["pager_hbm_hit_rate"] is None
            assert s["tier_promotions"] == 0
            assert s["tier_demotions"] == 0

    def test_search_kicks_single_flight_maintenance(self, monkeypatch):
        vecs = _clustered(2000)
        store = self._store(vecs)
        store.search(vecs[0], top_k=4)  # index live
        kicked = []
        monkeypatch.setattr(store._ivf, "maintenance_due", lambda: True)
        monkeypatch.setattr(
            store._ivf, "kick_maintenance",
            lambda on_error=None: kicked.append(on_error) or True)
        store.search(vecs[1], top_k=4)
        assert len(kicked) == 1
        assert kicked[0] is not None  # store's bg-error counter wired

    def test_ephemeral_spill_dir_is_removed_with_the_store(self):
        import gc

        store = self._store(_clustered(1000))
        store.search(_clustered(1, seed=3)[0], top_k=2)
        d = store._tier_spill_dir()
        assert os.path.isfile(os.path.join(d, tiered_mod.SPILL_FILE))
        store._ivf.wait_maintenance()
        del store
        gc.collect()
        assert not os.path.exists(d)

    def test_concurrent_add_search_recall(self):
        vecs = _clustered(4000)
        store = self._store(vecs)
        store.search(vecs[0], top_k=4)
        errs = []

        def writer(wid):
            try:
                for i in range(5):
                    rows = _clustered(100, seed=100 + 10 * wid + i)
                    store.add([f"w{wid}-{i}-{j}" for j in range(100)],
                              rows)
            except Exception as e:  # pragma: no cover - failure path
                errs.append(e)

        threads = [threading.Thread(target=writer, args=(w,))
                   for w in range(2)]
        for t in threads:
            t.start()
        qs = _clustered(64, seed=200)
        for q in qs:
            assert store.search(q, top_k=4) is not None
        for t in threads:
            t.join()
        assert not errs
        if store._ivf is not None and \
                hasattr(store._ivf, "wait_maintenance"):
            store._ivf.wait_maintenance()
        store.search(qs[0], top_k=4)  # fold any lagging tail rows in
        rows, docs = store.rows().numpy(), store.snapshot_docs()
        exact = rows @ qs.T
        rec = []
        for j in range(len(qs)):
            truth = {docs[i]["text"]
                     for i in np.argpartition(exact[:, j], -4)[-4:]}
            got = {r.text for r in store.search(qs[j], top_k=4)}
            rec.append(len(truth & got) / 4)
        assert float(np.mean(rec)) > 0.8
        assert store.stats()["background_errors"] == 0

    def test_delete_retrains_like_plain_ivf(self):
        vecs = _clustered(2000)
        store = self._store(vecs)
        store.search(vecs[0], top_k=4)
        assert store.stats()["index"] == "ivf_tiered"
        store.delete_documents([""])  # no filename metadata -> no-op
        assert store.delete_documents(["nope"]) == 0
        store.add(["solo"], _clustered(1, seed=300),
                  [{"filename": "solo.txt"}])
        store.delete_documents(["solo.txt"])
        store.search(vecs[0], top_k=4)
        s = store.stats()
        assert s["index"] == "ivf_tiered"
        assert s["index_rebuilds"] >= 1
