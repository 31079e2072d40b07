"""Port parity: the prefix cache (serving/prefix_cache.py, the allocator's
reclaim hook and `SequencePages.adopt` in serving/kv_cache.py,
`engine_model.pool_to_cache` and the engine's hit path).

The allocator, adopt and radix-tree cases run on the JAX package's
classes and the port's alike (both must pass each case), and seeded
workloads of insert/match/evict/trim must give both caches the same
pages, the same eviction order and the same counts. `pool_to_cache` is
held against the JAX function on the same numpy pool (exact), a hit's
suffix chunk against JAX `prefill_chunk_step` on a JAX-seeded cache (f32
atol 1e-4, tests/test_llama.py's tolerance), and the port's engine with
the cache on against offline JAX `greedy_generate` (greedy streams
identical). No JAX `LLMEngine` is built: the JAX suite's chunked-prefill
state is order dependent within a process (ROADMAP).
"""

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
from generativeaiexamples_tpu.serving import prefix_cache as jpc
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.serving import engine_model as tem
from generativeaiexamples_tpu_torch.serving import kv_cache as tkv
from generativeaiexamples_tpu_torch.serving import prefix_cache as tpc
from generativeaiexamples_tpu_torch.serving.engine import LLMEngine
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

ATOL = 1e-4  # f32 logits (tests/test_llama.py's tolerance)
VOCAB = 259  # the byte tokenizer's <eos> can be sampled
ECFG = dict(max_batch_size=4, max_seq_len=64, page_size=8,
            prefill_buckets=(16, 32), kv_dtype="float32",
            decode_steps_per_dispatch=2)
# (allocator / sequence module, radix-tree module) of each side.
IMPLS = {"jax": (jkv, jpc), "port": (tkv, tpc)}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


# -- the allocator and SequencePages (both sides) ---------------------------


def test_release_raises_on_double_unallocated_and_out_of_range(impl):
    kv, _ = impl
    a = kv.PageAllocator(8)
    (p,) = a.alloc(1)
    a.release([p])
    with pytest.raises(ValueError, match="double free"):
        a.release([p])
    with pytest.raises(ValueError, match="double free"):
        a.release([3])  # in range, never allocated
    for bad in (8, 0):  # past the pool; the sink is never allocatable
        with pytest.raises(ValueError, match="out of range"):
            a.release([bad])


def test_retain_release_lifecycle(impl):
    kv, _ = impl
    a = kv.PageAllocator(8)
    (p,) = a.alloc(1)
    a.retain([p])
    assert a.refcount(p) == 2
    a.release([p])
    assert a.refcount(p) == 1 and p not in a._free
    a.release([p])
    assert a.refcount(p) == 0 and p in a._free
    with pytest.raises(ValueError, match="retain of unallocated"):
        a.retain([3])


def test_alloc_shortfall_invokes_reclaim(impl):
    kv, _ = impl
    a = kv.PageAllocator(4)  # 3 usable pages
    held = a.alloc(3)
    calls = []

    def reclaim(n):
        calls.append(n)
        a.release(held[:n])  # free exactly what was asked

    a.reclaim = reclaim
    assert len(a.alloc(2)) == 2 and calls == [2]
    a.reclaim = lambda n: None
    with pytest.raises(MemoryError):
        a.alloc(2)


def test_release_is_idempotent(impl):
    kv, _ = impl
    a = kv.PageAllocator(8)
    seq = kv.SequencePages(a, page_size=4, max_pages=4)
    seq.ensure(10)
    assert len(seq.pages) == 3
    seq.release()
    assert seq.pages == [] and seq.length == 0 and seq.n_shared == 0
    n_free = a.n_free
    seq.release()
    assert a.n_free == n_free


def test_adopt_full_pages_shares_and_extends_privately(impl):
    kv, _ = impl
    a = kv.PageAllocator(16)
    shared = a.alloc(2)  # stands in for tree-owned pages
    seq = kv.SequencePages(a, page_size=4, max_pages=4)
    assert seq.adopt(shared, 8) is None
    assert seq.pages == shared and seq.n_shared == 2
    assert all(a.refcount(p) == 2 for p in shared)
    seq.ensure(13)  # 2 shared + 2 private pages
    assert len(seq.pages) == 4
    seq.release()
    assert all(a.refcount(p) == 1 for p in shared)
    assert seq.n_shared == 0


def test_adopt_partial_tail_is_copy_on_write(impl):
    kv, _ = impl
    a = kv.PageAllocator(16)
    shared = a.alloc(2)
    seq = kv.SequencePages(a, page_size=4, max_pages=4)
    src, dst = seq.adopt(shared, 6)  # 1 full page + 2 tokens of page 2
    assert src == shared[1] and dst not in shared
    assert seq.pages == [shared[0], dst]
    assert seq.n_shared == 1 and seq.length == 6
    assert a.refcount(shared[1]) == 1  # the source is not retained
    assert a.refcount(dst) == 1
    seq.release()
    assert a.refcount(shared[0]) == 1 and a.refcount(dst) == 0


# -- the radix tree ---------------------------------------------------------


def _cache(impl, n_pages=32, ps=4, cap=100):
    kv, pc = impl
    a = kv.PageAllocator(n_pages)
    return a, pc.RadixPrefixCache(a, ps, cap)


def test_insert_match_dedup_and_divergence(impl):
    a, t = _cache(impl)
    ids = list(range(11))  # 2 full pages + a partial tail
    pages = a.alloc(2)
    assert t.insert(ids, pages) == 2
    assert t.match(ids) == pages and t.match(ids[:9]) == pages
    assert t.match(ids[:7]) == pages[:1] and t.match([99] + ids[1:]) == []
    assert all(a.refcount(p) == 2 for p in pages)  # tree + owner
    dup = a.alloc(2)
    assert t.insert(ids[:8], dup) == 0  # the cached pages win
    assert t.match(ids) == pages
    assert all(a.refcount(p) == 1 for p in dup)
    more = a.alloc(1)
    t.insert(list(range(8)) + [40, 41, 42, 43], pages + more)
    assert t.match(list(range(8)) + [77, 78, 79, 80]) == pages


def test_evict_lru_only_unreferenced_and_exposes_parents(impl):
    a, t = _cache(impl)
    owner_a = a.alloc(2)
    t.insert(list(range(8)), owner_a)
    owner_b = a.alloc(1)
    t.insert([50, 51, 52, 53], owner_b)
    a.release(owner_a)
    a.release(owner_b)
    t.match([50, 51, 52, 53])  # chain A's leaf is now LRU
    assert t.evict(1) == 1
    assert t.match(list(range(8))) == owner_a[:1]
    t.match([50, 51, 52, 53])
    a.retain([owner_b[0]])  # a sequence adopts chain B
    assert t.evict(10) == 1  # A's last page; B is skipped
    assert t.n_cached_pages == 1 and t.evictions == 2
    a.release([owner_b[0]])
    assert t.reclaimable() == 1 and t.evict(10) == 1
    assert a.n_free == 31


def test_trim_and_reclaimable(impl):
    a, t = _cache(impl, cap=2)
    pages = a.alloc(3)
    t.insert(list(range(12)), pages)
    assert t.reclaimable() == 0  # the owner still holds every page
    a.release(pages[1:])
    assert t.reclaimable() == 2
    a.release(pages[:1])
    assert t.reclaimable() == 3
    assert t.trim() == 1 and t.n_cached_pages == 2


def test_evict_runs_off_the_heap_not_a_leaf_walk(impl):
    a, t = _cache(impl, n_pages=64)
    pages = a.alloc(4)
    t.insert(list(range(16)), pages)
    a.release(pages)

    def boom():
        raise AssertionError("evict() walked every leaf")

    t._leaves = boom
    assert t.evict(2) == 2
    t.match(list(range(16)))
    assert t.evict(10) == 2


def _workload(seed, ps=4, n_ops=120):
    """A seeded mix of inserts (chains branching off shared heads),
    matches, pins, evictions and trims."""
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, 50, ps * int(rng.integers(1, 4))).tolist()
             for _ in range(4)]
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["insert", "insert", "match", "evict", "trim",
                           "pin"])
        ids = (heads[int(rng.integers(0, 4))]
               + rng.integers(0, 50, ps * int(rng.integers(0, 4))
                              + int(rng.integers(0, ps))).tolist())
        ops.append((str(kind), ids, int(rng.integers(1, 6))))
    return ops


def _replay(pc, kv, ops, ps=4, cap=12):
    """Run `ops` on one side's cache; returns everything observable."""
    a = kv.PageAllocator(64)
    freed = []

    class Recorder(pc.RadixPrefixCache):
        def _release(self, node):
            freed.append(node.page)
            super()._release(node)

    t = Recorder(a, ps, cap)
    a.reclaim = t.evict  # as the engine wires it
    pinned = []
    out = []
    for kind, ids, n in ops:
        if kind == "insert":
            try:
                pages = a.alloc(len(ids) // ps)
            except MemoryError:
                out.append(("insert", "pool exhausted"))
                continue
            out.append(("insert", t.insert(ids, pages)))
            a.release(pages)
        elif kind == "match":
            out.append(("match", t.match(ids)))
        elif kind == "pin":
            # A live sequence adopts the matched prefix (or drops one).
            if pinned and n % 2:
                a.release(pinned.pop())
            else:
                got = t.match(ids)
                a.retain(got)
                pinned.append(got)
        elif kind == "evict":
            before = len(freed)
            out.append(("evict", t.evict(n), tuple(freed[before:])))
        else:
            before = len(freed)
            out.append(("trim", t.trim(), tuple(freed[before:])))
        out.append((t.n_cached_pages, t.evictions, t.reclaimable(),
                    a.n_free))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_radix_cache_matches_jax_on_seeded_workloads(seed):
    ops = _workload(seed)
    assert _replay(tpc, tkv, ops) == _replay(jpc, jkv, ops)


# -- pool_to_cache and a hit's suffix chunk against JAX ---------------------


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(vocab_size=VOCAB)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.llama_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jcfg, jparams, tl.LlamaConfig.tiny(vocab_size=VOCAB), tparams


def _numpy_pools(jcfg, tcfg, kind, n_pages=10, ps=8, seed=0):
    """The same random pool on both sides: f32 values, or int8 codes
    with positive f32 scales."""
    rng = np.random.default_rng(seed)
    tpool = tkv.PagePool.zeros(tcfg, n_pages, ps,
                               dtype=torch.int8 if kind == "int8"
                               else torch.float32, device="cpu")
    if kind == "int8":
        kv = rng.integers(-127, 128, tpool.kv.shape).astype(np.int8)
        s = rng.random(tpool.s.shape).astype(np.float32) / 64
        return (jkv.QuantPagePool(jnp.asarray(kv), jnp.asarray(s), ps),
                tkv.QuantPagePool(torch.from_numpy(kv), torch.from_numpy(s),
                                  ps))
    k = rng.standard_normal(tpool.k.shape).astype(np.float32)
    v = rng.standard_normal(tpool.v.shape).astype(np.float32)
    return (jkv.PagePool(jnp.asarray(k), jnp.asarray(v), ps),
            tkv.PagePool(torch.from_numpy(k), torch.from_numpy(v), ps))


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_pool_to_cache_equals_jax(models, kind):
    jcfg, _, tcfg, _ = models
    jpool, tpool = _numpy_pools(jcfg, tcfg, kind)
    row = np.array([4, 9, 2, 0], np.int32)  # 3 cached pages + the sink
    jc = jem.pool_to_cache(jpool, jcfg, jnp.asarray(row), jnp.int32(21))
    tc = tem.pool_to_cache(tpool, tcfg, torch.from_numpy(row), 21)
    assert tc.k.shape == tuple(jc.k.shape) and tc.k.dtype == torch.float32
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [21]


@pytest.mark.parametrize("plen, m", [(26, 16), (24, 23), (29, 8)])
def test_hit_suffix_chunk_logits_match_jax(models, plen, m):
    """A prompt's first pages prefilled by JAX into its pool; both sides
    gather them (pool_to_cache, m cached tokens: page aligned, or capped
    at plen - 1 mid-page) and run the suffix as one chunk at q_offset
    m."""
    jcfg, jparams, tcfg, tparams = models
    ps, s_total = 8, 32
    prompt = np.random.default_rng(plen).integers(0, 256, plen).tolist()
    jpool = jkv.PagePool.zeros(jcfg, 8, ps)
    n_pages = -(-m // ps)
    tok = np.zeros((1, 32), np.int32)
    tok[0, :m] = prompt[:m]
    table = np.arange(1, n_pages + 1, dtype=np.int32)
    _, jpool = jem.prefill_step(jparams, jcfg, jpool, jnp.asarray(tok),
                                jnp.int32(m),
                                jnp.asarray(np.pad(table, (0, 4 - n_pages))),
                                False)
    tpool = tkv.PagePool(torch.from_numpy(np.array(jpool.k)),
                         torch.from_numpy(np.array(jpool.v)), ps)
    row = np.zeros((s_total // ps,), np.int32)
    row[:n_pages] = table
    suffix = prompt[m:]
    width = min(1 << (len(suffix) - 1).bit_length(), s_total - m)
    chunk = np.zeros((1, width), np.int32)
    chunk[0, :len(suffix)] = suffix
    jcache = jem.pool_to_cache(jpool, jcfg, jnp.asarray(row), jnp.int32(m))
    jlogits, _ = jem.prefill_chunk_step(jparams, jcfg, jcache,
                                        jnp.asarray(chunk),
                                        jnp.int32(len(suffix)),
                                        use_pallas=False)
    tcache = tem.pool_to_cache(tpool, tcfg, torch.from_numpy(row), m)
    tlogits, tcache = tem.prefill_chunk_step(
        tparams, tcfg, tcache, torch.from_numpy(chunk), len(suffix))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)
    assert tcache.lengths.tolist() == [plen]


# -- the engine with the cache on, against offline greedy ------------------


_GREEDY = {}  # (prompt, n_new) -> tokens; the module's weights are fixed


def _greedy(models, prompt, n_new):
    """Offline JAX greedy continuation, cut after the first <eos> (the
    engine ends the stream there)."""
    key = (tuple(prompt), n_new)
    if key not in _GREEDY:
        jcfg, jparams, _, _ = models
        out = jl.greedy_generate(jparams, jcfg,
                                 jnp.asarray([prompt], jnp.int32), n_new,
                                 use_pallas=False)
        toks = np.asarray(out)[0, len(prompt):].tolist()
        eos = ByteTokenizer().eos_id
        _GREEDY[key] = toks[:toks.index(eos) + 1] if eos in toks else toks
    return _GREEDY[key]


def _engine(models, n_pages=None, **kw):
    _, _, tcfg, tparams = models
    return LLMEngine(tparams, tcfg, ByteTokenizer(), {**ECFG, **kw},
                     n_pages=n_pages, device="cpu").start()


def _run(eng, prompt, n=6):
    return [ev["token_id"] for ev in eng.generate_stream(
        prompt, max_new_tokens=n) if ev["token_id"] >= 0]


def _wait_drained(eng, timeout=20.0):
    """Until no slot, block or first token is in flight (the pages of a
    retired stream are released once its last block lands)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if (not eng._inflight and not eng._pending_first
                and all(s is None for s in eng.slots)):
            return
        time.sleep(0.01)
    raise AssertionError("engine did not drain")


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n).tolist()


def test_second_identical_prompt_prefills_only_suffix(models):
    eng = _engine(models, prefix_cache=True)
    try:
        prompt = _prompt(26, 1)
        want = _greedy(models, prompt, 6)
        assert _run(eng, prompt) == want
        s1 = eng.metrics.snapshot()
        assert _run(eng, prompt) == want
        s2 = eng.metrics.snapshot()
        assert s1["prefill_tokens"] == 26 and s1["prefix_miss"] == 1
        # 26 tokens = 3 full pages + 2: the hit covers 24, 2 prefill.
        assert s2["prefix_hits"] == 1 and s2["prefix_hit_tokens"] == 24
        assert s2["prefill_tokens"] - s1["prefill_tokens"] == 2
    finally:
        eng.stop()


def test_page_aligned_full_match_takes_cow_tail(models):
    """A fully cached page-aligned prompt still prefills ONE token: the
    match is capped at plen - 1, mid-page, so its last page is a CoW
    tail."""
    eng = _engine(models, prefix_cache=True)
    try:
        prompt = _prompt(24, 2)
        want = _greedy(models, prompt, 6)
        assert _run(eng, prompt) == want
        s1 = eng.metrics.snapshot()
        assert _run(eng, prompt) == want
        s2 = eng.metrics.snapshot()
        assert s2["prefix_hit_tokens"] - s1["prefix_hit_tokens"] == 23
        assert s2["prefill_tokens"] - s1["prefill_tokens"] == 1
    finally:
        eng.stop()


def test_divergent_prompt_reuses_common_prefix_only(models):
    eng = _engine(models, prefix_cache=True)
    try:
        head = _prompt(16, 3)
        p_a, p_b = head + [1, 2, 3, 4, 5], head + [9, 8, 7, 6, 5]
        assert _run(eng, p_a) == _greedy(models, p_a, 6)
        s1 = eng.metrics.snapshot()
        assert _run(eng, p_b) == _greedy(models, p_b, 6)
        s2 = eng.metrics.snapshot()
        assert s2["prefix_hit_tokens"] - s1["prefix_hit_tokens"] == 16
        assert s2["prefill_tokens"] - s1["prefill_tokens"] == 5
    finally:
        eng.stop()


def test_cache_off_reports_zero_and_prefills_fully(models):
    eng = _engine(models)
    try:
        prompt = _prompt(26, 1)
        want = _greedy(models, prompt, 6)
        assert _run(eng, prompt) == want and _run(eng, prompt) == want
        snap = eng.metrics.snapshot()
        assert eng.prefix_cache is None and eng.allocator.reclaim is None
        for key in ("prefix_hits", "prefix_miss", "prefix_evictions",
                    "prefix_hit_tokens", "kv_promote_ms"):
            assert snap[key] == 0, key
        assert snap["prefill_tokens"] == 52
    finally:
        eng.stop()


def test_eviction_under_allocator_pressure(models):
    """5 usable pages, 3 a request: a second distinct prompt must evict
    the first one's cached pages, never fail its admission."""
    eng = _engine(models, n_pages=6, max_batch_size=1, max_seq_len=32,
                  prefill_buckets=(16,), prefix_cache=True,
                  prefix_cache_capacity=1.0)
    try:
        for seed in range(3):
            prompt = _prompt(16, 10 + seed)
            assert _run(eng, prompt, 4) == _greedy(models, prompt, 4), seed
        assert eng.metrics.snapshot()["prefix_evictions"] > 0
    finally:
        eng.stop()


def test_cow_source_page_pinned_against_eviction(models):
    eng = _engine(models, prefix_cache=True)
    try:
        prompt = _prompt(24, 2)
        assert len(_run(eng, prompt, 2)) == 2
        _wait_drained(eng)
        assert eng.prefix_cache.n_cached_pages == 3
        hit = eng._lookup_prefix(prompt)
        pages, m = hit
        assert m == 23 and eng.allocator.refcount(pages[-1]) == 2
        # The pinned tail survives full pressure (and its ancestors,
        # which it keeps off the frontier).
        assert eng.prefix_cache.evict(10) == 0
        eng._release_hit_pin(hit)
        assert eng.allocator.refcount(pages[-1]) == 1
        assert eng.prefix_cache.evict(10) == 3
    finally:
        eng.stop()


def test_hits_keep_tree_stable_and_pages_balanced(models):
    eng = _engine(models, prefix_cache=True)
    try:
        free0 = eng.allocator.n_free
        prompt = _prompt(26, 1)
        for _ in range(4):
            assert len(_run(eng, prompt, 4)) == 4
        _wait_drained(eng)
        assert eng.prefix_cache.n_cached_pages == 3
        assert eng.allocator.n_free == free0 - 3
        assert eng.metrics.snapshot()["prefix_hits"] == 3
    finally:
        eng.stop()


def test_hit_never_rewrites_shared_pages(models):
    """The bytes of the pages a hit adopts are the same before and after
    the hit (its finish scatter sinks their rows); the CoW case rewrites
    only its private copy."""
    eng = _engine(models, prefix_cache=True)
    try:
        for plen in (26, 24):
            prompt = _prompt(plen, plen)
            _run(eng, prompt, 2)
            _wait_drained(eng)
            pages = eng.prefix_cache.match(prompt)
            before = (eng.pool.k[:, :, pages].clone(),
                      eng.pool.v[:, :, pages].clone())
            assert _run(eng, prompt, 4) == _greedy(models, prompt, 4)
            _wait_drained(eng)
            assert torch.equal(eng.pool.k[:, :, pages], before[0])
            assert torch.equal(eng.pool.v[:, :, pages], before[1])
    finally:
        eng.stop()


# Concurrent streams sharing prefixes: hits in the chunked lane while
# others decode, hits sent to the batched prefill while the lane is busy,
# and long prompts (past the 32 bucket) whose suffix starts mid-scratch.
_HEAD = _prompt(16, 40)
STREAM_SETS = {
    "shared_head": [_HEAD + _prompt(n, 41 + n) for n in (3, 9, 12, 1)],
    "repeats": [_prompt(26, 1)] * 3 + [_prompt(24, 2)] * 2,
    # The second prompt hits 8 tokens, so its last chunk has 17 tokens
    # and 24 scratch rows left: a width below the chunk's power of two.
    "long": [_HEAD + _prompt(4, 53), _HEAD[:8] + _prompt(49, 50),
             _HEAD + _prompt(29, 51), _HEAD[:8] + _prompt(49, 50)],
}


@pytest.mark.parametrize("name", sorted(STREAM_SETS))
def test_greedy_streams_identical_to_offline_greedy(models, name):
    prompts = STREAM_SETS[name]
    n_new = [min(8, 64 - len(p)) for p in prompts]
    eng = _engine(models, prefix_cache=True)
    try:
        for p, n in zip(prompts, n_new):  # warm the tree one by one
            assert _run(eng, p, n) == _greedy(models, p, n)
        got = [None] * len(prompts)

        def run(i):
            got[i] = _run(eng, prompts[i], n_new[i])

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for i, p in enumerate(prompts):
            assert got[i] == _greedy(models, p, n_new[i]), i
        snap = eng.metrics.snapshot()
        assert snap["prefix_hits"] > 0
        _wait_drained(eng)
        assert not eng._long_prefills and not eng._scratch_caches
    finally:
        eng.stop()


@pytest.mark.parametrize("spec", [
    pytest.param({"speculative_k": 2}, id="linear"),
    pytest.param({"speculative_k": 3, "speculative_tree_branches": 4},
                 id="tree")])
def test_speculative_engine_hits_equal_offline_greedy(models, spec):
    """A hit on a speculative engine seeds the slot's device token
    history from the whole prompt at its finish, so verify steps draft
    from it: the streams still equal offline greedy."""
    eng = _engine(models, prefix_cache=True, **spec)
    try:
        for p in STREAM_SETS["shared_head"] + STREAM_SETS["repeats"]:
            assert _run(eng, p, 8) == _greedy(models, p, 8)
        assert eng.metrics.snapshot()["prefix_hits"] >= 5
        assert eng.metrics.snapshot()["spec_slot_steps"] > 0
    finally:
        eng.stop()
