"""Port parity: the fused prefill rider's steps (beside a decode block,
and beside verify steps: the composed plan), the finish samplers and the
step-plan lowering (serving/engine_model.py) against the JAX package's
jitted functions with use_pallas=False, on shared weights.

Tiny f32 Llama carried across with the converter; the same page tables,
chunk and scratch cache on both sides. Logits, pool pages and scratch
caches within f32 atol 1e-4 (tests/test_llama.py's tolerance); greedy
tokens identical (verify targets, counts, lengths and history too); int8
pool codes identical, scales within rtol 1e-5
(test_torch_engine_model_int8's bounds). Sampled draws come from a torch
Generator and cannot match jax.random's, so they are held to the JAX
top-k / top-p mask instead. Sink page 0 is left out of pool comparisons.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.ops import quant as jq
from generativeaiexamples_tpu.serving import engine_model as jem
from generativeaiexamples_tpu.serving import sampling as jsampling
from generativeaiexamples_tpu.serving.kv_cache import PagePool as JPool
from generativeaiexamples_tpu.serving.kv_cache import QuantPagePool as JQPool
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.serving import engine_model as tem
from generativeaiexamples_tpu_torch.serving.kv_cache import PagePool as TPool

ATOL = 1e-4
SCALE_RTOL = 1e-5
PS, N_PAGES, MAXP, B = 8, 24, 6, 4
VOCAB = 259
S_TOTAL, W = 48, 16


@pytest.fixture(scope="module", params=["float32", "int8"])
def model(request):
    jcfg = jl.LlamaConfig.tiny(vocab_size=VOCAB)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    if request.param == "int8":
        jparams = jq.quantize_llama_params(jparams)
    tparams = convert.llama_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return (request.param, jcfg, jparams,
            tl.LlamaConfig.tiny(vocab_size=VOCAB), tparams)


def _pools(kind, jcfg, tcfg):
    if kind == "int8":
        return (JQPool.zeros(jcfg, N_PAGES, PS),
                TPool.zeros(tcfg, N_PAGES, PS, dtype=torch.int8,
                            device="cpu"))
    return (JPool.zeros(jcfg, N_PAGES, PS, dtype=jnp.float32),
            TPool.zeros(tcfg, N_PAGES, PS, dtype=torch.float32,
                        device="cpu"))


def _assert_pools_close(jpool, tpool):
    if tpool.quantized:
        np.testing.assert_array_equal(tpool.kv.numpy()[:, :, :, 1:],
                                      np.asarray(jpool.kv)[:, :, :, 1:])
        np.testing.assert_allclose(tpool.s.numpy()[:, :, :, 1:],
                                   np.asarray(jpool.s)[:, :, :, 1:],
                                   rtol=SCALE_RTOL, atol=0)
        return
    for j, t in ((jpool.k, tpool.k), (jpool.v, tpool.v)):
        np.testing.assert_allclose(t.numpy()[:, :, 1:],
                                   np.asarray(j)[:, :, 1:], atol=ATOL, rtol=0)


def _assert_caches_close(jcache, tcache):
    for j, t in ((jcache.k, tcache.k), (jcache.v, tcache.v)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=0)
    assert tcache.lengths.tolist() == np.asarray(jcache.lengths).tolist()


def _greedy(n):
    return (np.zeros((n,), np.float32), np.ones((n,), np.float32),
            np.zeros((n,), np.int32))


def _state(model):
    """Both sides after the same set-up: two prompts prefilled into the
    pool (slots 0 and 2, their first tokens in last_tokens) and a long
    prompt's first chunk through a scratch cache. Returns (jax state,
    torch state, decode inputs, the next chunk)."""
    kind, jcfg, jparams, tcfg, tparams = model
    jpool, tpool = _pools(kind, jcfg, tcfg)
    rng = np.random.default_rng(0)
    tokens = np.zeros((2, 16), np.int32)
    lengths = np.array([11, 5], np.int32)
    rows = np.array([[3, 7], [2, 0]], np.int32)
    for j, n in enumerate(lengths):
        tokens[j, :n] = rng.integers(0, 256, n)
    temps, top_ps, top_ks = _greedy(2)
    jfirst, jpool = jem.prefill_batch_step(
        jparams, jcfg, jpool, jnp.asarray(tokens), jnp.asarray(lengths),
        jnp.asarray(rows), jnp.asarray(temps), jnp.asarray(top_ps),
        jnp.asarray(top_ks), jax.random.PRNGKey(0), False,
        sampling_flags=(True, False, False))
    tfirst = tem.prefill_batch_step(
        tparams, tcfg, tpool, *(torch.from_numpy(a) for a in (
            tokens, lengths, rows, temps, top_ps, top_ks)),
        None, sampling_flags=(True, False, False))
    idxs = np.array([0, 2], np.int32)
    jlast = jem.set_last_tokens(jnp.zeros((B,), jnp.int32),
                                jnp.asarray(idxs), jfirst)
    tlast = tem.set_last_tokens(torch.zeros((B,), dtype=torch.int32), idxs,
                                tfirst)
    prompt = rng.integers(0, 256, 40).tolist()
    chunk0 = np.asarray([prompt[:W]], np.int32)
    jcache = jl.KVCache.zeros(jcfg, 1, max_len=S_TOTAL)
    _, jcache = jem.prefill_chunk_step(jparams, jcfg, jcache,
                                       jnp.asarray(chunk0), jnp.int32(W),
                                       use_pallas=False)
    tcache = tl.KVCache.zeros(tcfg, 1, max_len=S_TOTAL, device="cpu")
    _, tcache = tem.prefill_chunk_step(tparams, tcfg, tcache,
                                       torch.from_numpy(chunk0), W)
    tables = np.zeros((B, MAXP), np.int32)
    tables[0, :3] = [3, 7, 9]
    tables[2, :2] = [2, 5]
    dec = dict(tables=tables, lengths=np.array([12, 1, 6, 1], np.int32),
               active=np.array([True, False, True, False]),
               sampling=_greedy(B))
    chunk1 = np.zeros((1, W), np.int32)
    chunk1[0, :12] = prompt[W:W + 12]  # 12 valid, 4 padding
    return ((jpool, jlast, jcache), (tpool, tlast, tcache), dec,
            (chunk1, 12))


def test_fused_decode_prefill_step_matches_jax(model):
    """Block tokens equal, chunk logits, the pool's written pages and the
    scratch cache within f32 atol; two rider steps chained."""
    _, jcfg, jparams, tcfg, tparams = model
    (jpool, jlast, jcache), (tpool, tlast, tcache), dec, (chunk, valid) = \
        _state(model)
    temps, top_ps, top_ks = dec["sampling"]
    dec_len = dec["lengths"]
    for _ in range(2):
        jblock, jlast, jpool, jlogits, jcache = jem.fused_decode_prefill_step(
            jparams, jcfg, jpool, jlast, jnp.asarray(dec["tables"]),
            jnp.asarray(dec_len), jnp.asarray(dec["active"]),
            jnp.asarray(temps), jnp.asarray(top_ps), jnp.asarray(top_ks),
            jax.random.PRNGKey(1), jcache, jnp.asarray(chunk),
            jnp.int32(valid), 2, False, sampling_flags=(True, False, False))
        tblock, tlast, tlogits, tcache = tem.fused_decode_prefill_step(
            tparams, tcfg, tpool, tlast, *(torch.from_numpy(a) for a in (
                dec["tables"], dec_len, dec["active"], temps, top_ps,
                top_ks)), None, tcache, torch.from_numpy(chunk), valid, 2,
            sampling_flags=(True, False, False))
        np.testing.assert_array_equal(tblock.numpy(), np.asarray(jblock))
        np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   atol=ATOL, rtol=0)
        _assert_pools_close(jpool, tpool)
        _assert_caches_close(jcache, tcache)
        dec_len = np.where(dec["active"], dec_len + 2, dec_len).astype(
            np.int32)


def test_fused_step_equals_chunk_then_decode(model):
    """The rider is exactly prefill_chunk_step then decode_multi_step: the
    same tokens, logits, pool bytes and cache bytes."""
    _, _, _, tcfg, tparams = model
    _, (pool_a, last_a, cache_a), dec, (chunk, valid) = _state(model)
    _, (pool_b, last_b, cache_b), _, _ = _state(model)
    args = [torch.from_numpy(a) for a in (
        dec["tables"], dec["lengths"], dec["active"], *dec["sampling"])]
    block, last_a, logits, cache_a = tem.fused_decode_prefill_step(
        tparams, tcfg, pool_a, last_a, *args, None, cache_a,
        torch.from_numpy(chunk), valid, 2)
    want_logits, cache_b = tem.prefill_chunk_step(
        tparams, tcfg, cache_b, torch.from_numpy(chunk), valid)
    want_block, last_b = tem.decode_multi_step(
        tparams, tcfg, pool_b, last_b, *args, None, 2)
    assert torch.equal(block, want_block) and torch.equal(last_a, last_b)
    assert torch.equal(logits, want_logits)
    assert torch.equal(cache_a.k, cache_b.k)
    assert torch.equal(cache_a.lengths, cache_b.lengths)
    for name in (("kv", "s") if pool_a.quantized else ("k", "v")):
        assert torch.equal(getattr(pool_a, name), getattr(pool_b, name))


def _spec_state(n_rows=B):
    hist = torch.zeros((n_rows, 64), dtype=torch.int32)
    hist[0, :12] = torch.arange(12) % 7
    hist[2, :6] = torch.arange(6) % 5
    return hist, torch.tensor([12, 1, 6, 1], dtype=torch.int32)


@pytest.mark.parametrize("k, M, n_steps", [(2, 0, 2), (2, 3, 1)],
                         ids=["linear", "tree"])
def test_fused_spec_prefill_step_matches_jax(model, k, M, n_steps):
    """The composed plan, two chained calls: verify targets, counts,
    lengths, last tokens and history equal to JAX's; chunk logits, the
    pool's written pages and the scratch cache within f32 atol (int8:
    codes equal, scales within rtol)."""
    _, jcfg, jparams, tcfg, tparams = model
    (jpool, jlast, jcache), (tpool, tlast, tcache), dec, (chunk, valid) = \
        _state(model)
    th, td = _spec_state()
    jh, jd = jnp.asarray(th.numpy()), jnp.asarray(td.numpy())
    tables, active = dec["tables"], dec["active"]
    for _ in range(2):
        (jt, jc, jlast, jd, jh, jpool, jlogits,
         jcache) = jem.fused_spec_prefill_step(
            jparams, jcfg, jpool, jh, jlast, jd, jnp.asarray(tables),
            jnp.asarray(active), jcache, jnp.asarray(chunk),
            jnp.int32(valid), n_steps, k, n_branches=M, use_pallas=False)
        tt, tc, tlast, td, th, tlogits, tcache = tem.fused_spec_prefill_step(
            tparams, tcfg, tpool, th, tlast, td, torch.from_numpy(tables),
            torch.from_numpy(active), tcache, torch.from_numpy(chunk), valid,
            n_steps, k, M)
        for got, want in ((tt, jt), (tc, jc), (tlast, jlast), (td, jd),
                          (th, jh)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   atol=ATOL, rtol=0)
        _assert_pools_close(jpool, tpool)
        _assert_caches_close(jcache, tcache)


def test_fused_spec_step_equals_chunk_then_verify(model):
    """The composed plan is exactly prefill_chunk_step then
    decode_spec_multi_step: the same targets, logits and bytes."""
    _, _, _, tcfg, tparams = model
    _, (pool_a, last_a, cache_a), dec, (chunk, valid) = _state(model)
    _, (pool_b, last_b, cache_b), _, _ = _state(model)
    tables, active = (torch.from_numpy(dec[key]) for key in (
        "tables", "active"))
    hist_a, dl_a = _spec_state()
    hist_b, dl_b = _spec_state()
    got = tem.fused_spec_prefill_step(
        tparams, tcfg, pool_a, hist_a, last_a, dl_a, tables, active, cache_a,
        torch.from_numpy(chunk), valid, 1, 2, 3)
    want_logits, cache_b = tem.prefill_chunk_step(
        tparams, tcfg, cache_b, torch.from_numpy(chunk), valid)
    want = tem.decode_spec_multi_step(tparams, tcfg, pool_b, hist_b, last_b,
                                      dl_b, tables, active, 1, 2, 3)
    for a, b in zip(got[:5], want):
        assert torch.equal(a, b)
    assert torch.equal(got[5], want_logits)
    assert torch.equal(got[6].k, cache_b.k)
    assert torch.equal(got[6].lengths, cache_b.lengths)
    for name in (("kv", "s") if pool_a.quantized else ("k", "v")):
        assert torch.equal(getattr(pool_a, name), getattr(pool_b, name))


# -- the finish samplers ----------------------------------------------------


def _logits(seed=4):
    return np.random.default_rng(seed).normal(size=(VOCAB,)).astype(
        np.float32) * 3.0


def test_greedy_finish_samplers_match_jax():
    logits = _logits()
    jtok = jem.sample_token(jnp.asarray(logits), 0.0, 1.0, 0,
                            jax.random.PRNGKey(0), True, False, False)
    ttok = tem.sample_token(torch.from_numpy(logits), 0.0, 1.0, 0)
    assert ttok.shape == () and ttok.dtype == torch.int32
    assert int(ttok) == int(jtok) == int(np.argmax(logits))
    jlast = jem.set_last_token(jnp.zeros((B,), jnp.int32), jnp.int32(2),
                               jtok)
    tlast = torch.zeros((B,), dtype=torch.int32)
    assert tem.set_last_token(tlast, 2, ttok) is tlast
    assert tlast.tolist() == np.asarray(jlast).tolist()
    jtok2, jlast2 = jem.sample_token_into(
        jnp.zeros((B,), jnp.int32), jnp.int32(1), jnp.asarray(logits), 0.0,
        1.0, 0, jax.random.PRNGKey(0), True, False, False)
    ttok2, tlast2 = tem.sample_token_into(
        torch.zeros((B,), dtype=torch.int32), 1, torch.from_numpy(logits),
        0.0, 1.0, 0)
    assert int(ttok2) == int(jtok2)
    assert tlast2.tolist() == np.asarray(jlast2).tolist()


@pytest.mark.parametrize("temp, top_p, top_k", [
    (0.7, 1.0, 5), (1.3, 0.6, 0), (1.0, 0.9, 12)])
def test_sampled_finish_draws_inside_jax_mask(temp, top_p, top_k):
    """Every draw of sample_token and sample_token_into lies in the JAX
    sampler's top-k / top-p mask; the pair consumes the generator as
    sample_token does (same seed, same draws)."""
    logits = _logits(5)
    scaled = jnp.asarray(logits)[None, :] / max(temp, 1e-6)
    if top_k:
        scaled = jsampling._mask_top_k(scaled, jnp.asarray([top_k]))
    if top_p < 1.0:
        scaled = jsampling._mask_top_p(scaled, jnp.asarray([top_p],
                                                           jnp.float32))
    allowed = set(np.flatnonzero(np.isfinite(np.asarray(scaled)[0])))
    assert 1 < len(allowed) < VOCAB
    flags = (False, bool(top_k), top_p < 1.0)
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    last = torch.zeros((B,), dtype=torch.int32)
    seen = set()
    for _ in range(40):
        a = tem.sample_token(torch.from_numpy(logits), temp, top_p, top_k,
                             g1, *flags)
        b, last = tem.sample_token_into(last, 3, torch.from_numpy(logits),
                                        temp, top_p, top_k, g2, *flags)
        assert int(a) == int(b) == int(last[3])
        seen.add(int(a))
    assert seen <= allowed and len(seen) > 1


# -- step plans --------------------------------------------------------------


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _clone(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x


LATTICE = {
    "decode": (tem.StepPlan(decode_k=2), "decode_multi_step"),
    "rider": (tem.StepPlan(decode_k=2, rider_width=W, rider_s_total=S_TOTAL),
              "fused_decode_prefill_step"),
    "spec_linear": (tem.StepPlan(decode_k=2, spec_k=2),
                    "decode_spec_multi_step"),
    "spec_tree": (tem.StepPlan(decode_k=1, spec_k=2, tree_branches=3),
                  "decode_spec_multi_step"),
    "spec_rider_linear": (tem.StepPlan(decode_k=2, spec_k=2, rider_width=W,
                                       rider_s_total=S_TOTAL),
                          "fused_spec_prefill_step"),
    "spec_rider_tree": (tem.StepPlan(decode_k=1, spec_k=2, tree_branches=3,
                                     rider_width=W, rider_s_total=S_TOTAL),
                        "fused_spec_prefill_step"),
    "spec_state": (tem.StepPlan(decode_k=2, spec_state=True),
                   "decode_plain_spec_state_multi_step"),
    "chunk": (tem.StepPlan(rider_width=W, rider_s_total=S_TOTAL),
              "prefill_chunk_step"),
    "chunk_sample": (tem.StepPlan(rider_width=W, rider_s_total=S_TOTAL,
                                  rider_sample=True),
                     "prefill_chunk_sample_step"),
}


def _direct(name, tparams, tcfg, pool, last, cache, dec, chunk, valid):
    """The direct call of a lattice point, as a plan_step-shaped dict."""
    tables, lengths, active = (torch.from_numpy(dec[k]) for k in (
        "tables", "lengths", "active"))
    samp = [torch.from_numpy(a) for a in dec["sampling"]]
    chunk = torch.from_numpy(chunk)
    plan = LATTICE[name][0]
    if name == "decode":
        block, last = tem.decode_multi_step(tparams, tcfg, pool, last, tables,
                                            lengths, active, *samp, None, 2)
        return {"block": block, "last_tokens": last}
    if name == "rider":
        block, last, logits, cache = tem.fused_decode_prefill_step(
            tparams, tcfg, pool, last, tables, lengths, active, *samp, None,
            cache, chunk, valid, 2)
        return {"block": block, "last_tokens": last, "chunk_logits": logits,
                "cache": cache}
    if name in ("spec_rider_linear", "spec_rider_tree"):
        hist, dl = _spec_state()
        t, c, last, dl, hist, logits, cache = tem.fused_spec_prefill_step(
            tparams, tcfg, pool, hist, last, dl, tables, active, cache,
            chunk, valid, plan.decode_k, plan.spec_k, plan.tree_branches)
        return {"targets": t, "counts": c, "last_tokens": last,
                "dev_lengths": dl, "history": hist, "chunk_logits": logits,
                "cache": cache}
    if name in ("spec_linear", "spec_tree"):
        hist, dl = _spec_state()
        t, c, last, dl, hist = tem.decode_spec_multi_step(
            tparams, tcfg, pool, hist, last, dl, tables, active,
            plan.decode_k, plan.spec_k, plan.tree_branches)
        return {"targets": t, "counts": c, "last_tokens": last,
                "dev_lengths": dl, "history": hist}
    if name == "spec_state":
        hist, dl = _spec_state()
        block, last, dl, hist = tem.decode_plain_spec_state_multi_step(
            tparams, tcfg, pool, hist, last, dl, tables, active, *samp, None,
            2, sampling_flags=(True, False, False))
        return {"block": block, "last_tokens": last, "dev_lengths": dl,
                "history": hist}
    if name == "chunk":
        logits, cache = tem.prefill_chunk_step(tparams, tcfg, cache, chunk,
                                               valid)
        return {"chunk_logits": logits, "cache": cache}
    tok0, last, cache = tem.prefill_chunk_sample_step(
        tparams, tcfg, cache, chunk, valid, last, 1, 0.0, 1.0, 0)
    return {"tok0": tok0, "last_tokens": last, "cache": cache}


def _via_plan(name, tparams, tcfg, pool, last, cache, dec, chunk, valid):
    plan = LATTICE[name][0]
    kw = dict(pool=pool, last_tokens=last,
              page_tables=torch.from_numpy(dec["tables"]),
              active=torch.from_numpy(dec["active"]))
    if plan.spec_k or plan.spec_state:
        kw["history"], kw["dev_lengths"] = _spec_state()
    if plan.decode_k and not plan.spec_k:
        kw.update(zip(("temperature", "top_p", "top_k"),
                      (torch.from_numpy(a) for a in dec["sampling"])))
        kw.update(lengths=torch.from_numpy(dec["lengths"]),
                  sampling_flags=(True, False, False))
    if plan.rider_width:
        kw.update(cache=cache, chunk_tokens=torch.from_numpy(chunk),
                  chunk_valid=valid)
    if plan.rider_sample:
        kw.update(slot_idx=1, temperature=0.0, top_p=1.0, top_k=0,
                  sampling_flags=(True, False, False))
    return tem.plan_step(tparams, tcfg, plan, **kw)


@pytest.mark.parametrize("name", sorted(LATTICE))
def test_plan_step_lattice_point_equals_direct_call(model, name):
    """Each lattice point through plan_step gives what its step function
    gives on the same state, and touches the same pool bytes."""
    _, _, _, tcfg, tparams = model
    _, (pool, last, cache), dec, (chunk, valid) = _state(model)
    pool2, last2, cache2 = _clone(pool), last.clone(), _clone(cache)
    got = _via_plan(name, tparams, tcfg, pool, last, cache, dec, chunk,
                    valid)
    want = _direct(name, tparams, tcfg, pool2, last2, cache2, dec, chunk,
                   valid)
    assert isinstance(got.pop("t_dispatch"), float)
    if "pool" in got:
        assert got.pop("pool") is pool
    assert set(got) == set(want), name
    for key, value in want.items():
        if key == "cache":
            assert torch.equal(got[key].k, value.k)
            assert torch.equal(got[key].lengths, value.lengths)
        else:
            assert torch.equal(got[key], value), key
    for f in dataclasses.fields(pool):
        a, b = getattr(pool, f.name), getattr(pool2, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name


def test_plan_defaults_and_rider_beside_speculation_refused(model):
    """The plan's fields and defaults are JAX's. The rider beside
    speculation, once refused (ROADMAP A.14(d)), now lowers to
    fused_spec_prefill_step: every lattice point of the JAX docstring
    runs, none raises."""
    _, _, _, tcfg, tparams = model
    assert tem.StepPlan() == tem.StepPlan(0, 0, 0, 0, 0, False, False)
    assert tem.StepPlan._fields == jem.StepPlan._fields
    lowered = {fn for _, fn in LATTICE.values()}
    assert "fused_spec_prefill_step" in lowered
    assert all(hasattr(jem, fn) and hasattr(tem, fn) for fn in lowered)
    _, (pool, last, cache), dec, (chunk, valid) = _state(model)
    res = _via_plan("spec_rider_tree", tparams, tcfg, pool, last, cache, dec,
                    chunk, valid)
    assert res["cache"].lengths.tolist() == [W + valid]
