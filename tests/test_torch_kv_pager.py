"""Port parity: the session KV pager (serving/kv_pager.py) and the page
moves it rides on (`engine_model.pool_to_pages` / `pages_to_pool`).

`pool_to_pages` and `pages_to_pool` are held bit for bit against the JAX
functions on the same numpy pool: f32 values, bf16 bit patterns, int8
codes with their scales. A demote -> promote round trip must give back
the exact bytes the pool held, through the host tier and the disk spill
alike, for f32, bf16 and int8 pools. The spill file must survive a crash
mid-rewrite; the engine's reclaim hook must demote instead of dropping,
and a warm resume must give the stream a resident hit gives. The pager
off must change no stream and still report every counter. Every wait on
the background worker is bounded.
"""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.serving import engine_model as jem
from generativeaiexamples_tpu.serving import kv_cache as jkv
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.serving import engine_model as tem
from generativeaiexamples_tpu_torch.serving.engine import (
    EngineMetrics, LLMEngine)
from generativeaiexamples_tpu_torch.serving.kv_cache import (
    PageAllocator, PagePool, QuantPagePool)
from generativeaiexamples_tpu_torch.serving.kv_pager import (
    KV_PAGER_KEYS, KVPager, PagedPrefixCache, gather_spans)
from generativeaiexamples_tpu_torch.serving.prefix_cache import (
    TIER_DEVICE, TIER_DISK, TIER_HOST)
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

VOCAB = 259
PS = 4
TCFG = tl.LlamaConfig.tiny(vocab_size=VOCAB)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}
WAIT_S = 30.0  # bound on every wait for the background worker


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of a pool tensor (bf16 as int16), for bit equality."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _pool_arrays(kind, n_pages, seed=0):
    """Random page data as numpy: (k, v) f32 values (bf16 pools take
    them rounded), or int8 codes and positive f32 scales."""
    rng = np.random.default_rng(seed)
    shape = (TCFG.n_layers, TCFG.n_kv_heads, n_pages, PS, TCFG.head_dim)
    if kind == "int8":
        return (rng.integers(-127, 128, (2,) + shape).astype(np.int8),
                rng.random((2,) + shape[:-1]).astype(np.float32))
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _port_pool(kind, n_pages=16, seed=0):
    a, b = _pool_arrays(kind, n_pages, seed)
    if kind == "int8":
        return QuantPagePool(torch.from_numpy(a), torch.from_numpy(b), PS)
    dt = DTYPES[kind]
    return PagePool(torch.from_numpy(a).to(dt), torch.from_numpy(b).to(dt),
                    PS)


def _jax_pool(kind, n_pages=16, seed=0):
    a, b = _pool_arrays(kind, n_pages, seed)
    if kind == "int8":
        return jkv.QuantPagePool(jnp.asarray(a), jnp.asarray(b), PS)
    return jkv.PagePool(jnp.asarray(a, kind), jnp.asarray(b, kind), PS)


def _as_port_bits(x) -> np.ndarray:
    """A JAX array's bits as the port keeps them (bf16 as int16)."""
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x


@pytest.mark.parametrize("kind", sorted(DTYPES))
def test_pool_to_pages_and_back_equal_jax(kind):
    jpool, tpool = _jax_pool(kind), _port_pool(kind)
    row = np.array([5, 2, 11, 0], np.int32)  # 3 pages + the sink pad
    jc, js = jem.pool_to_pages(jpool, jnp.asarray(row))
    tc, ts = tem.pool_to_pages(tpool, torch.from_numpy(row))
    np.testing.assert_array_equal(_bits(tc).numpy(), _as_port_bits(jc))
    assert (ts is None) == (js is None) == (kind != "int8")
    if ts is not None:
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # Scatter those pages elsewhere on both sides: pools equal, page 0
    # (the sink, written by the padding row) left out.
    dst = np.array([7, 1, 14, 0], np.int32)
    jpool = jem.pages_to_pool(jpool, jc, js, jnp.asarray(dst))
    assert tem.pages_to_pool(tpool, tc, ts, torch.from_numpy(dst)) is tpool
    pairs = ((tpool.kv, jpool.kv, 3), (tpool.s, jpool.s, 3)) \
        if kind == "int8" else ((tpool.k, jpool.k, 2), (tpool.v, jpool.v, 2))
    for t, j, axis in pairs:
        got = _bits(t).numpy().take(range(1, 16), axis=axis)
        want = _as_port_bits(j).take(range(1, 16), axis=axis)
        np.testing.assert_array_equal(got, want)
    # ...and the moved pages hold the source pages' bytes.
    for src, d in ((5, 7), (2, 1), (11, 14)):
        for t, _, axis in pairs:
            assert torch.equal(_bits(t.select(axis, d)),
                               _bits(t.select(axis, src)))


def test_gather_spans_cover_in_power_of_two_widths():
    assert list(gather_spans(0, 8)) == []
    assert list(gather_spans(5, 0)) == [(0, 5)]
    assert list(gather_spans(11, 3)) == [(0, 4), (4, 8), (8, 11)]


# -- the pager and PagedPrefixCache on a bare pool --------------------------


def _mk(kind="float32", host_mb=4, n_pages=16, tmp=None):
    pool = _port_pool(kind, n_pages)
    alloc = PageAllocator(n_pages)
    pager = KVPager(pool, host_budget_mb=host_mb,
                    spill_dir=str(tmp) if tmp else "")
    cache = PagedPrefixCache(alloc, PS, 100, pager, lambda: pool)
    return pool, alloc, pager, cache


def _page_bytes(pool, page):
    if pool.quantized:
        return pool.kv[:, :, :, page].clone(), pool.s[:, :, :, page].clone()
    return _bits(pool.k[:, :, page]).clone(), _bits(pool.v[:, :, page]).clone()


def _scribble(pool, pages):
    """Overwrite pages, so a promotion that read the stale device pool
    instead of the cold copy would fail."""
    if pool.quantized:
        pool.kv[:, :, :, pages] = 0
        pool.s[:, :, :, pages] = 0
    else:
        pool.k[:, :, pages] = -1
        pool.v[:, :, pages] = -1


def _assert_pages(pool, nodes, before):
    for want, node in zip(before, nodes):
        got = _page_bytes(pool, node.page)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kind", sorted(DTYPES))
@pytest.mark.parametrize("host_mb, tier", [(4, TIER_HOST), (0, TIER_DISK)])
def test_demote_promote_is_bit_identical(kind, host_mb, tier):
    pool, alloc, pager, cache = _mk(kind, host_mb)
    try:
        ids = list(range(12))
        pages = alloc.alloc(3)
        cache.insert(ids, pages)
        alloc.release(pages)
        before = [_page_bytes(pool, p) for p in pages]
        assert cache.evict(10) == 3
        assert alloc.n_free == 15  # every device page is back
        nodes = cache.match_nodes(ids)
        assert [n.tier for n in nodes] == [tier] * 3
        junk = alloc.alloc(3)
        _scribble(pool, junk)
        alloc.release(junk)
        assert cache.promote(pool, nodes) is pool
        assert [n.tier for n in nodes] == [TIER_DEVICE] * 3
        _assert_pages(pool, nodes, before)
        s = pager.stats()
        assert s["kv_demotions"] == 3 and s["kv_promotions"] == 3
        assert s["kv_promote_tokens"] == 3 * PS
        assert s["kv_host_pages"] == 0 and s["kv_spill_pages"] == 0
        assert s["kv_spill_writes"] == (3 if tier == TIER_DISK else 0)
    finally:
        pager.close()


def test_background_spill_host_to_disk_then_promote():
    pool, alloc, pager, cache = _mk()
    try:
        # A host tier of 3 slots: 3 of 6 demotions land on disk directly,
        # the worker spills more.
        pager.n_host_slots = 3
        pager._host_free = [2, 1, 0]
        pager._host_codes = pager._host_codes[:3]
        ids = list(range(24))
        pages = alloc.alloc(6)
        cache.insert(ids, pages)
        alloc.release(pages)
        before = [_page_bytes(pool, p) for p in pages]
        cache.evict(10)
        assert pager.wait_maintenance(WAIT_S)
        pager._run_maintenance()  # a deterministic second pass
        nodes = cache.match_nodes(ids)
        tiers = [n.tier for n in nodes]
        assert TIER_DISK in tiers and TIER_DEVICE not in tiers
        assert pager.stats()["kv_spill_writes"] >= 4
        cache.promote(pool, nodes)
        _assert_pages(pool, nodes, before)
    finally:
        pager.close()


def test_promote_memoryerror_leaves_cold_tiers_intact():
    pool, alloc, pager, cache = _mk(n_pages=8)
    try:
        ids = list(range(12))
        pages = alloc.alloc(3)
        cache.insert(ids, pages)
        alloc.release(pages)
        before = [_page_bytes(pool, p) for p in pages]
        cache.evict(10)
        nodes = cache.match_nodes(ids)
        hold = alloc.alloc(7)  # drain the free list
        with pytest.raises(MemoryError):
            cache.promote(pool, nodes)
        assert [n.tier for n in nodes] == [TIER_HOST] * 3
        assert pager.stats()["kv_host_pages"] == 3
        alloc.release(hold)
        cache.promote(pool, nodes)
        assert [n.tier for n in nodes] == [TIER_DEVICE] * 3
        _assert_pages(pool, nodes, before)
    finally:
        pager.close()


def test_reinsert_reattaches_demoted_chunk_without_promotion():
    pool, alloc, pager, cache = _mk()
    try:
        ids = list(range(8))
        pages = alloc.alloc(2)
        cache.insert(ids, pages)
        alloc.release(pages)
        cache.evict(10)
        assert cache.n_cached_pages == 0
        fresh = alloc.alloc(2)
        cache.insert(ids, fresh)
        nodes = cache.match_nodes(ids)
        assert [n.tier for n in nodes] == [TIER_DEVICE] * 2
        assert [n.page for n in nodes] == fresh
        s = pager.stats()
        assert s["kv_host_pages"] == 0 and s["kv_promotions"] == 0
        assert cache.n_cached_pages == 2
    finally:
        pager.close()


def _two_spilled_chains(pool, alloc, cache):
    """Chains A and B spilled (4 records), then A promoted (2 dead)."""
    ids_a, ids_b = list(range(8)), [50 + i for i in range(8)]
    pa, pb = alloc.alloc(2), alloc.alloc(2)
    cache.insert(ids_a, pa)
    cache.insert(ids_b, pb)
    alloc.release(pa)
    alloc.release(pb)
    before_b = [_page_bytes(pool, p) for p in pb]
    cache.evict(10)
    cache.promote(pool, cache.match_nodes(ids_a))
    return ids_b, before_b


def test_spill_file_is_crash_safe_mid_rewrite(monkeypatch):
    pool, alloc, pager, cache = _mk(host_mb=0)
    try:
        ids_b, before_b = _two_spilled_chains(pool, alloc, cache)
        old_size = os.path.getsize(pager._spill_path)
        real_replace = os.replace

        def boom(src, dst):
            if dst == pager._spill_path:
                raise OSError("simulated crash mid-rewrite")
            return real_replace(src, dst)

        monkeypatch.setattr(os, "replace", boom)
        with pytest.raises(OSError):
            pager._compact()
        monkeypatch.undo()
        assert os.path.getsize(pager._spill_path) == old_size
        assert not os.path.exists(pager._spill_path + ".tmp")
        assert not pager._compacting
        assert pager.stats()["kv_spill_compactions"] == 0
        nodes_b = cache.match_nodes(ids_b)
        cache.promote(pool, nodes_b)  # served from the intact old file
        _assert_pages(pool, nodes_b, before_b)
    finally:
        pager.close()


def test_compaction_drops_dead_records_and_remaps_live(tmp_path):
    pool, alloc, pager, cache = _mk(host_mb=0, tmp=tmp_path / "spill")
    try:
        ids_b, before_b = _two_spilled_chains(pool, alloc, cache)
        pager._compact()
        s = pager.stats()
        assert s["kv_spill_compactions"] == 1 and s["kv_spill_pages"] == 2
        nodes_b = cache.match_nodes(ids_b)
        cache.promote(pool, nodes_b)
        _assert_pages(pool, nodes_b, before_b)
    finally:
        pager.close()
    # A named spill dir outlives the pager (its file stays).
    assert os.path.isdir(tmp_path / "spill")


def test_close_removes_ephemeral_spill_dir():
    _, alloc, pager, cache = _mk(host_mb=0)
    pages = alloc.alloc(1)
    cache.insert(list(range(PS)), pages)
    alloc.release(pages)
    cache.evict(1)
    spill_dir = pager._spill_dir
    assert os.path.isdir(spill_dir)
    pager.close()
    assert not os.path.exists(spill_dir)


# -- the engine with the pager on -------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(vocab_size=VOCAB)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.llama_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jcfg, jparams, tparams


def _engine(models, **kw):
    """One slot, 5 usable pages of 8, every page cacheable: each request
    of 16 tokens + 4 new needs 3, so the next distinct prompt pushes the
    last one's cached pages out."""
    base = dict(max_batch_size=1, max_seq_len=32, page_size=8,
                prefill_buckets=(16,), kv_dtype="float32",
                decode_steps_per_dispatch=2, prefix_cache=True,
                prefix_cache_capacity=1.0)
    base.update(kw)
    return LLMEngine(models[2], TCFG, ByteTokenizer(), base, n_pages=6,
                     device="cpu").start()


def _run(eng, prompt, n=4):
    return [ev["token_id"] for ev in eng.generate_stream(
        prompt, max_new_tokens=n) if ev["token_id"] >= 0]


def _greedy(models, prompt, n=4):
    jcfg, jparams, _ = models
    out = jl.greedy_generate(jparams, jcfg, jnp.asarray([prompt], jnp.int32),
                             n, use_pallas=False)
    toks = np.asarray(out)[0, len(prompt):].tolist()
    eos = ByteTokenizer().eos_id
    return toks[:toks.index(eos) + 1] if eos in toks else toks


PROMPTS = [np.random.default_rng(s).integers(0, 256, 16).tolist()
           for s in range(4)]


def test_reclaim_hook_demotes_instead_of_destroying(models):
    eng = _engine(models, kv_pager=True, kv_host_budget_mb=4)
    try:
        for p in PROMPTS:
            assert _run(eng, p) == _greedy(models, p)
        snap = eng.metrics.snapshot()
        assert snap["kv_demotions"] > 0 and snap["kv_host_pages"] > 0
        assert snap["prefix_evictions"] == snap["kv_demotions"]
        # Nothing was destroyed: every prompt's 2 full pages still match.
        assert all(len(eng.prefix_cache.match_nodes(p)) == 2
                   for p in PROMPTS)
    finally:
        eng.stop()


@pytest.mark.parametrize("kv_dtype, host_mb", [
    ("float32", 4), ("float32", 0), ("bfloat16", 4), ("int8", 4),
    ("int8", 0)])
def test_warm_resume_is_byte_identical(models, kv_dtype, host_mb):
    """A session run twice while resident (the second run a hit), pushed
    out to host RAM (or, with no host budget, the disk spill) by three
    others, then resumed: the promoted pages equal their bytes before the
    demotion and the resumed stream equals the resident hit's, which
    equals the first run's (and offline greedy on the f32 pool)."""
    eng = _engine(models, kv_dtype=kv_dtype, kv_pager=True,
                  kv_host_budget_mb=host_mb)
    try:
        first = _run(eng, PROMPTS[0])
        h1 = _run(eng, PROMPTS[0])
        pages = eng.prefix_cache.match(PROMPTS[0])
        snap = tem.pool_to_pages(eng.pool, torch.tensor(pages))
        for p in PROMPTS[1:]:
            _run(eng, p)
        s1 = eng.metrics.snapshot()
        assert s1["kv_demotions"] > 0
        nodes = eng.prefix_cache.match_nodes(PROMPTS[0])
        assert nodes[0].tier == (TIER_HOST if host_mb else TIER_DISK)
        h2 = _run(eng, PROMPTS[0])
        s2 = eng.metrics.snapshot()
        assert s2["kv_promotions"] > s1["kv_promotions"]
        assert s2["prefix_hits"] == s1["prefix_hits"] + 1
        assert s2["kv_promote_ms"] > 0
        if not host_mb:
            assert s2["kv_spill_writes"] > 0
        back = tem.pool_to_pages(eng.pool, torch.tensor(
            [n.page for n in nodes]))
        for got, want in zip(back, snap):
            if want is not None:
                assert torch.equal(_bits(got), _bits(want))
        assert h2 == h1 == first
        if kv_dtype == "float32":
            assert first == _greedy(models, PROMPTS[0])
    finally:
        eng.stop()


def test_lookup_without_promote_never_promotes(models):
    eng = _engine(models, kv_pager=True, kv_host_budget_mb=4)
    try:
        for p in PROMPTS:
            _run(eng, p)
        s1 = eng.metrics.snapshot()
        assert s1["kv_demotions"] > 0
        hit = eng._lookup_prefix(PROMPTS[0], promote=False)
        assert eng.metrics.snapshot()["kv_promotions"] == s1["kv_promotions"]
        if hit is not None:  # the leading resident run only
            eng._release_hit_pin(hit)
        assert _run(eng, PROMPTS[0]) == _greedy(models, PROMPTS[0])
    finally:
        eng.stop()


def test_pager_off_is_byte_identical_with_zero_counters(models):
    eng_off = _engine(models)  # cache on, pager off
    eng_on = _engine(models, kv_pager=True, kv_host_budget_mb=4)
    try:
        for p in PROMPTS[:3] + [PROMPTS[0]]:
            assert _run(eng_off, p) == _run(eng_on, p)
        snap = eng_off.metrics.snapshot()
        assert eng_off.kv_pager is None
        for key in KV_PAGER_KEYS:
            assert snap[key] == 0, key
        assert eng_on.metrics.snapshot()["kv_promotions"] > 0
    finally:
        eng_off.stop()
        eng_on.stop()


def test_kv_pager_requires_prefix_cache(models):
    with pytest.raises(ValueError, match="requires engine.prefix_cache"):
        LLMEngine(models[2], TCFG, ByteTokenizer(),
                  dict(kv_pager=True, max_seq_len=32, page_size=8),
                  device="cpu")


def test_counters_always_present_in_snapshot():
    snap = EngineMetrics().snapshot()
    for key in KV_PAGER_KEYS + ("prefix_hits", "prefix_miss",
                                "prefix_evictions", "prefix_hit_tokens",
                                "kv_promote_ms"):
        assert snap[key] == 0, key


def test_stop_closes_the_pager(models):
    eng = _engine(models, kv_pager=True, kv_host_budget_mb=0)
    try:
        spill_dir = eng.kv_pager._spill_dir
        for p in PROMPTS[:3]:
            _run(eng, p)
        assert os.path.isdir(spill_dir)
    finally:
        eng.stop()
    assert not os.path.exists(spill_dir)


def test_concurrent_submit_vs_background_demotion(models):
    """Threads replay sessions while maintenance passes run back to back
    on the worker: every stream equals offline greedy."""
    want = [_greedy(models, p) for p in PROMPTS]
    eng = _engine(models, kv_pager=True, kv_host_budget_mb=4)
    errors = []
    stop = threading.Event()

    def churn():
        while not stop.is_set():
            eng.kv_pager.kick_maintenance()
            stop.wait(0.002)

    def worker(idx):
        try:
            for rep in range(3):
                got = _run(eng, PROMPTS[idx])
                if got != want[idx]:
                    errors.append((idx, rep, got, want[idx]))
        except Exception as e:  # surfaces in the main thread
            errors.append((idx, repr(e)))

    churner = threading.Thread(target=churn, daemon=True)
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(PROMPTS))]
    try:
        churner.start()
        for th in threads:
            th.start()
        deadline = time.monotonic() + 120
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))
            assert not th.is_alive()
    finally:
        stop.set()
        churner.join(timeout=10)
        eng.stop()
    assert not churner.is_alive()
    assert not errors, errors[:2]
    assert eng.metrics.snapshot()["kv_pager_errors"] == 0
