"""Port parity: the speculative programs of serving/engine_model.py.

The drafts (`ngram_draft`, `ngram_tree_draft`) and `set_history_rows`
must be int-equal to the JAX package's on the same numpy inputs. Then
`decode_spec_multi_step` runs on the tiny f32 Llama (JAX weights carried
across with the converter) from identical pool, history and length
state, linear (k=2) and tree (k=2, M=3), over a float pool and an int8
pool: targets, counts, lengths, last tokens and history must be
bit-identical to JAX's `decode_spec_multi_step(..., use_pallas=False)`.
Pools: f32 within 1e-5 (XLA and torch sum the projections in other
orders); int8 codes equal and scales within rtol 1e-5 (a k or v row that
differs in its last bit moves its amax / 127 scale by a few ulps).
Sink page 0 is left out: padding rows scatter into it in an unspecified
order. No JAX `LLMEngine` is built.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.serving import engine_model as jem
from generativeaiexamples_tpu.serving import sampling as js
from generativeaiexamples_tpu.serving.kv_cache import PagePool as JPool
from generativeaiexamples_tpu.serving.kv_cache import QuantPagePool as JQPool
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.serving import engine_model as tem
from generativeaiexamples_tpu_torch.serving.kv_cache import PagePool

PS, N_PAGES, MAXP, BUCKET, HCAP = 8, 24, 6, 16, 64
POOL_ATOL = 1e-5
SCALE_RTOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jcfg = jl.LlamaConfig.tiny()
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = convert.llama_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jcfg, jparams, tl.LlamaConfig.tiny(), tparams


def _histories(seed, B=6, Hcap=40, vocab=6):
    """Histories over a small vocabulary (many repeats), with a row whose
    current token never occurred before and a row with one occurrence."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, vocab, (B, Hcap)).astype(np.int32)
    lengths = rng.integers(3, Hcap - 4, (B,)).astype(np.int32)
    t0 = hist[np.arange(B), lengths - 1].copy()
    hist[0, :lengths[0] - 1] = (t0[0] + 1) % vocab   # no occurrence
    hist[1, :lengths[1] - 1] = (t0[1] + 1) % vocab
    hist[1, 2] = t0[1]                               # exactly one
    return hist, lengths, t0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 3])
def test_ngram_draft_matches_jax(seed, k):
    hist, ln, t0 = _histories(seed)
    want = np.asarray(jem.ngram_draft(jnp.asarray(hist), jnp.asarray(ln),
                                      jnp.asarray(t0), k))
    got = tem.ngram_draft(*(torch.from_numpy(a) for a in (hist, ln, t0)), k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k,M", [(2, 1), (2, 3), (3, 4), (1, 8)])
def test_ngram_tree_draft_matches_jax(seed, k, M):
    hist, ln, t0 = _histories(seed + 10)
    want = np.asarray(jem.ngram_tree_draft(
        jnp.asarray(hist), jnp.asarray(ln), jnp.asarray(t0), k, M))
    got = tem.ngram_tree_draft(
        *(torch.from_numpy(a) for a in (hist, ln, t0)), k, M)
    np.testing.assert_array_equal(got.numpy(), want)


def test_set_history_rows_matches_jax():
    rng = np.random.default_rng(4)
    B = 4
    hist = rng.integers(0, 50, (B, HCAP)).astype(np.int32)
    dl = rng.integers(1, 9, (B,)).astype(np.int32)
    tokens = rng.integers(0, 50, (4, BUCKET)).astype(np.int32)
    lengths = np.array([11, 5, 1, 16], np.int32)
    first = np.array([7, 8, 9, 10], np.int32)
    idxs = np.array([2, 0, B, 3], np.int32)   # row 2 is group padding
    jh, jd = jem.set_history_rows(*(jnp.asarray(a) for a in (
        hist, dl, idxs, tokens, lengths, first)))
    th, td = tem.set_history_rows(
        torch.from_numpy(hist.copy()), torch.from_numpy(dl.copy()), idxs,
        *(torch.from_numpy(a) for a in (tokens, lengths, first)))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def _pools(jcfg, tcfg, int8):
    if int8:
        return (JQPool.zeros(jcfg, N_PAGES, PS),
                PagePool.zeros(tcfg, N_PAGES, PS, dtype=torch.int8,
                               device="cpu"))
    return (JPool.zeros(jcfg, N_PAGES, PS, dtype=jnp.float32),
            PagePool.zeros(tcfg, N_PAGES, PS, dtype=torch.float32,
                           device="cpu"))


def _assert_pools_equal(jpool, tpool):
    if tpool.quantized:
        np.testing.assert_array_equal(tpool.kv.numpy()[:, :, :, 1:],
                                      np.asarray(jpool.kv)[:, :, :, 1:])
        np.testing.assert_allclose(tpool.s.numpy()[:, :, :, 1:],
                                   np.asarray(jpool.s)[:, :, :, 1:],
                                   rtol=SCALE_RTOL, atol=0)
        return
    for j, t in ((jpool.k, tpool.k), (jpool.v, tpool.v)):
        np.testing.assert_allclose(t.numpy()[:, :, 1:],
                                   np.asarray(j)[:, :, 1:],
                                   atol=POOL_ATOL, rtol=0)


def _admitted(model, int8):
    """Both sides after a batched prefill of two prompts (slots 0 and 1;
    slot 2 idle) and the history seed: (jax state, port state, tables).
    Prompt 0 repeats a trigram so drafts get accepted."""
    jcfg, jparams, tcfg, tparams = model
    jpool, tpool = _pools(jcfg, tcfg, int8)
    tokens = np.zeros((4, BUCKET), np.int32)
    tokens[0, :11] = [7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8]
    tokens[1, :5] = [40, 41, 42, 43, 44]
    lengths = np.array([11, 5, 1, 1], np.int32)
    rows = np.zeros((4, BUCKET // PS), np.int32)
    rows[0] = [3, 7]
    rows[1, 0] = 2
    greedy = (np.zeros((4,), np.float32), np.ones((4,), np.float32),
              np.zeros((4,), np.int32))
    idxs = np.array([0, 1, 3, 3], np.int32)   # 3 = out of bounds: padding
    jfirst, jpool = jem.prefill_batch_step(
        jparams, jcfg, jpool, *(jnp.asarray(a) for a in (
            tokens, lengths, rows) + greedy), jax.random.PRNGKey(0), False,
        sampling_flags=(True, False, False))
    tfirst = tem.prefill_batch_step(
        tparams, tcfg, tpool, *(torch.from_numpy(a) for a in (
            tokens, lengths, rows) + greedy),
        sampling_flags=(True, False, False))
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    jh, jd = jem.set_history_rows(
        jnp.zeros((3, HCAP), jnp.int32), jnp.ones((3,), jnp.int32),
        jnp.asarray(idxs), jnp.asarray(tokens), jnp.asarray(lengths),
        jfirst)
    th, td = tem.set_history_rows(
        torch.zeros((3, HCAP), dtype=torch.int32),
        torch.ones((3,), dtype=torch.int32), idxs,
        torch.from_numpy(tokens), torch.from_numpy(lengths), tfirst)
    jlast = jem.set_last_tokens(jnp.zeros((3,), jnp.int32),
                                jnp.asarray(idxs), jfirst)
    tlast = tem.set_last_tokens(torch.zeros((3,), dtype=torch.int32), idxs,
                                tfirst)
    tables = np.zeros((3, MAXP), np.int32)
    tables[0] = [3, 7, 9, 10, 11, 12]
    tables[1] = [2, 13, 14, 15, 16, 17]
    return (jpool, jh, jd, jlast), (tpool, th, td, tlast), tables


@pytest.mark.parametrize("int8", [False, True], ids=["f32_pool", "int8_pool"])
@pytest.mark.parametrize("k,M", [(2, 0), (2, 3)], ids=["linear", "tree"])
def test_decode_spec_multi_step_bit_identical_to_jax(model, int8, k, M):
    jcfg, jparams, tcfg, tparams = model
    (jpool, jh, jd, jlast), (tpool, th, td, tlast), tables = _admitted(
        model, int8)
    active = np.array([True, True, False])
    counts = []
    for _ in range(3):   # three chained blocks of 3 verify steps
        jt, jc, jlast, jd, jh, jpool = jem.decode_spec_multi_step(
            jparams, jcfg, jpool, jh, jlast, jd, jnp.asarray(tables),
            jnp.asarray(active), n_steps=3, k=k, n_branches=M,
            use_pallas=False)
        tt, tc, tlast, td, th = tem.decode_spec_multi_step(
            tparams, tcfg, tpool, th, tlast, td, torch.from_numpy(tables),
            torch.from_numpy(active), 3, k, M)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        _assert_pools_equal(jpool, tpool)
        counts.append(tc.numpy())
    counts = np.concatenate(counts, axis=1)
    assert counts[:2].max() > 1, "no draft was ever accepted"
    assert (counts[2] == 0).all()


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pool", "int8_pool"])
def test_tree_relocate_commit_moves_rows_verbatim(int8):
    """Branch m_star's rows (every layer, k and v; codes and scales) land
    at the consecutive slots bit for bit, whatever they hold; branch 0
    stays; rows of other slots are untouched."""
    cfg = tl.LlamaConfig.tiny()
    g = torch.Generator().manual_seed(0)
    pool = PagePool.zeros(cfg, N_PAGES, PS,
                          dtype=torch.int8 if int8 else torch.bfloat16,
                          device="cpu")
    if int8:
        pool.kv.copy_(torch.randint(-127, 128, pool.kv.shape, generator=g))
        pool.s.copy_(torch.rand(pool.s.shape, generator=g))
        planes = (pool.kv, pool.s)
    else:
        pool.k.copy_(torch.randn(pool.k.shape, generator=g))
        pool.v.copy_(torch.randn(pool.v.shape, generator=g))
        planes = (pool.k, pool.v)
    k, tables = 3, torch.tensor([[3, 7, 9, 10], [2, 5, 6, 8],
                                 [11, 12, 13, 14]], dtype=torch.int32)
    lengths = torch.tensor([6, 9, 2], dtype=torch.int32)
    m_star = torch.tensor([2, 1, 0])
    before = [p.clone() for p in planes]
    tem._tree_relocate_commit(pool, cfg, tables, lengths, m_star, k)

    def slot(p, b, t):   # one slot's rows over layers (and k|v, kv heads)
        page, off = int(tables[b, t // PS]), t % PS
        return p[:, :, :, page, off] if int8 else p[:, :, page, off]

    moved = set()
    for b in range(3):
        L0 = int(lengths[b]) - 1
        for d in range(k + 1):
            src = L0 + (0 if d == 0 else 1 + int(m_star[b]) * k + d - 1)
            for new, old in zip(planes, before):
                assert torch.equal(slot(new, b, L0 + d), slot(old, b, src))
            moved.add((b, L0 + d))
    for b in range(3):
        for t in range(4 * PS):
            if (b, t) not in moved:
                for new, old in zip(planes, before):
                    assert torch.equal(slot(new, b, t), slot(old, b, t))


def test_plain_spec_state_block_matches_jax(model):
    """The sampled fallback over the speculative state: greedy rows equal
    JAX's (block, last tokens, lengths, history); a sampled row's draw
    lies inside the top-k set JAX computes from the same step's logits."""
    jcfg, jparams, tcfg, tparams = model
    (jpool, jh, jd, jlast), (tpool, th, td, tlast), tables = _admitted(
        model, False)
    active = np.array([True, True, False])
    temps = np.array([0.0, 0.0, 0.0], np.float32)
    top_ps = np.ones((3,), np.float32)
    top_ks = np.zeros((3,), np.int32)
    jb, jlast2, jd2, jh2, _ = jem.decode_plain_spec_state_multi_step(
        jparams, jcfg, jpool, jh, jlast, jd, jnp.asarray(tables),
        jnp.asarray(active), *(jnp.asarray(a) for a in (temps, top_ps,
                                                         top_ks)),
        jax.random.PRNGKey(1), 4, False, sampling_flags=(True, False, False))
    tb, tlast2, td2, th2 = tem.decode_plain_spec_state_multi_step(
        tparams, tcfg, tpool, th.clone(), tlast.clone(), td.clone(),
        torch.from_numpy(tables), torch.from_numpy(active),
        *(torch.from_numpy(a) for a in (temps, top_ps, top_ks)), None, 4,
        sampling_flags=(True, False, False))
    for got, want in ((tb, jb), (tlast2, jlast2), (td2, jd2), (th2, jh2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # One sampled step from the admitted state: row 1 samples with top-k
    # 3; JAX's mask over the same step's logits bounds the draw.
    _, (tpool, th, td, tlast), _ = _admitted(model, False)
    logits = tem._decode_once(tparams, tcfg, PagePool(
        tpool.k.clone(), tpool.v.clone(), PS), tlast,
        torch.from_numpy(tables), td)
    allowed = np.isfinite(np.asarray(js._mask_top_k(
        jnp.asarray(logits.numpy()), jnp.asarray([0, 3, 0], jnp.int32))))
    temps[1], top_ks[1] = 1.0, 3
    g = torch.Generator().manual_seed(0)
    for _ in range(5):
        tb, *_ = tem.decode_plain_spec_state_multi_step(
            tparams, tcfg, PagePool(tpool.k.clone(), tpool.v.clone(), PS),
            th.clone(), tlast.clone(), td.clone(), torch.from_numpy(tables),
            torch.from_numpy(active), *(torch.from_numpy(a) for a in (
                temps, top_ps, top_ks)), g, 1)
        assert allowed[1, int(tb[1, 1])]
        assert int(tb[0, 1]) == int(logits[0].argmax())
