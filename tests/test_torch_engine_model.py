"""Port parity: serving/engine_model.py, the engine's prefill and decode
steps, against the JAX package's jitted steps on the same pool state.

Tiny f32 Llama, weights carried across with the converter, the same page
tables on both sides. Logits and pool contents within 1e-4 (the JAX
package's f32 logit tolerance, tests/test_serving.py: only summation
order differs); greedy tokens identical. Sink page 0 is left out of pool
comparisons: every padding position of a group is scattered into it, and
which duplicate write lands last is unspecified on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.serving import engine_model as jem
from generativeaiexamples_tpu.serving.kv_cache import PagePool as JPool
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.serving import engine_model as tem
from generativeaiexamples_tpu_torch.serving.kv_cache import PagePool as TPool

ATOL = 1e-4
PS, N_PAGES, MAXP, BUCKET = 8, 24, 6, 16


@pytest.fixture(scope="module")
def model():
    jcfg = jl.LlamaConfig.tiny()
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.llama_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jcfg, jparams, tl.LlamaConfig.tiny(), tparams


def _pools(jcfg, tcfg):
    return (JPool.zeros(jcfg, N_PAGES, PS, dtype=jnp.float32),
            TPool.zeros(tcfg, N_PAGES, PS, dtype=torch.float32,
                        device="cpu"))


def _assert_pools_equal(jpool, tpool):
    for j, t in ((jpool.k, tpool.k), (jpool.v, tpool.v)):
        np.testing.assert_allclose(t.numpy()[:, :, 1:],
                                   np.asarray(j)[:, :, 1:], atol=ATOL)


def _prefill_inputs(vocab):
    """Two prompts (lengths 11 and 5) plus one padding row, bucket 16."""
    rng = np.random.default_rng(0)
    tokens = np.zeros((4, BUCKET), np.int32)
    lengths = np.ones((4,), np.int32)
    rows = np.zeros((4, BUCKET // PS), np.int32)
    for j, (n, pages) in enumerate(((11, [3, 7]), (5, [2]))):
        tokens[j, :n] = rng.integers(0, vocab, n)
        lengths[j] = n
        rows[j, :len(pages)] = pages
    return tokens, lengths, rows


def _sampling(n, greedy=True):
    return (np.zeros((n,), np.float32), np.ones((n,), np.float32),
            np.zeros((n,), np.int32))


def test_prefill_step_logits_and_pool_match_jax(model):
    jcfg, jparams, tcfg, tparams = model
    jpool, tpool = _pools(jcfg, tcfg)
    tokens, lengths, rows = _prefill_inputs(jcfg.vocab_size)
    want, jpool = jem.prefill_step(
        jparams, jcfg, jpool, jnp.asarray(tokens[:1]),
        jnp.int32(lengths[0]), jnp.asarray(rows[0]), False)
    got = tem.prefill_step(tparams, tcfg, tpool, torch.from_numpy(tokens[:1]),
                           int(lengths[0]), torch.from_numpy(rows[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    _assert_pools_equal(jpool, tpool)


def test_prefill_batch_then_decode_multi_step_match_jax(model):
    """The engine's main path: one batched prefill that samples the first
    tokens on the device, then K-step greedy decode blocks with tokens
    chained on the device and one inactive slot."""
    jcfg, jparams, tcfg, tparams = model
    jpool, tpool = _pools(jcfg, tcfg)
    tokens, lengths, rows = _prefill_inputs(jcfg.vocab_size)
    temps, top_ps, top_ks = _sampling(4)
    jfirst, jpool = jem.prefill_batch_step(
        jparams, jcfg, jpool, jnp.asarray(tokens), jnp.asarray(lengths),
        jnp.asarray(rows), jnp.asarray(temps), jnp.asarray(top_ps),
        jnp.asarray(top_ks), jax.random.PRNGKey(0), False,
        sampling_flags=(True, False, False))
    tfirst = tem.prefill_batch_step(
        tparams, tcfg, tpool, *(torch.from_numpy(a) for a in (
            tokens, lengths, rows, temps, top_ps, top_ks)),
        None, sampling_flags=(True, False, False))
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    _assert_pools_equal(jpool, tpool)

    # Slots: 0 <- prompt 0, 2 <- prompt 1, 1 and 3 idle.
    B = 4
    idxs = np.array([0, 2, B, B], np.int32)
    jlast = jem.set_last_tokens(jnp.zeros((B,), jnp.int32),
                                jnp.asarray(idxs), jfirst)
    tlast = tem.set_last_tokens(torch.zeros((B,), dtype=torch.int32), idxs,
                                tfirst)
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))

    tables = np.zeros((B, MAXP), np.int32)
    tables[0, :3] = [3, 7, 9]
    tables[2, :2] = [2, 5]
    dec_len = np.array([12, 1, 6, 1], np.int32)
    active = np.array([True, False, True, False])
    temps, top_ps, top_ks = _sampling(B)
    for _ in range(2):  # two blocks of K=4, chained through last tokens
        jblock, jlast, jpool = jem.decode_multi_step(
            jparams, jcfg, jpool, jlast, jnp.asarray(tables),
            jnp.asarray(dec_len), jnp.asarray(active), jnp.asarray(temps),
            jnp.asarray(top_ps), jnp.asarray(top_ks), jax.random.PRNGKey(1),
            4, False, sampling_flags=(True, False, False))
        tblock, tlast = tem.decode_multi_step(
            tparams, tcfg, tpool, tlast, *(torch.from_numpy(a) for a in (
                tables, dec_len, active, temps, top_ps, top_ks)),
            None, 4, sampling_flags=(True, False, False))
        np.testing.assert_array_equal(tblock.numpy(), np.asarray(jblock))
        np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
        _assert_pools_equal(jpool, tpool)
        dec_len = np.where(active, dec_len + 4, dec_len).astype(np.int32)


def test_decode_step_logits_match_jax(model):
    jcfg, jparams, tcfg, tparams = model
    jpool, tpool = _pools(jcfg, tcfg)
    tokens, lengths, rows = _prefill_inputs(jcfg.vocab_size)
    _, jpool = jem.prefill_step(
        jparams, jcfg, jpool, jnp.asarray(tokens[:1]),
        jnp.int32(lengths[0]), jnp.asarray(rows[0]), False)
    tem.prefill_step(tparams, tcfg, tpool, torch.from_numpy(tokens[:1]),
                     int(lengths[0]), torch.from_numpy(rows[0]))
    table = np.array([[3, 7, 0, 0, 0, 0]], np.int32)
    for t, tok in enumerate((17, 42, 99)):
        n = np.array([12 + t], np.int32)
        want, jpool = jem.decode_step(jparams, jcfg, jpool,
                                      jnp.asarray([tok], jnp.int32),
                                      jnp.asarray(table), jnp.asarray(n),
                                      False)
        got = tem.decode_step(tparams, tcfg, tpool,
                              torch.tensor([tok], dtype=torch.int32),
                              torch.from_numpy(table), torch.from_numpy(n))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    _assert_pools_equal(jpool, tpool)


def test_paged_steps_equal_contiguous_forward(model):
    """Paged forward == contiguous forward, as the JAX package pins for
    its own steps (tests/test_serving.py)."""
    _, _, cfg, params = model
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 14))
    full, _ = tl.forward(params, cfg, torch.from_numpy(toks))
    _, tpool = _pools(jl.LlamaConfig.tiny(), cfg)
    padded = np.zeros((1, BUCKET), np.int64)
    padded[0, :9] = toks[0, :9]
    row = np.array([4, 6], np.int32)
    got = tem.prefill_step(params, cfg, tpool, torch.from_numpy(padded), 9,
                           torch.from_numpy(row))
    np.testing.assert_allclose(got.numpy(), full[0, 8].numpy(), atol=ATOL)
    table = torch.tensor([[4, 6, 0, 0, 0, 0]], dtype=torch.int32)
    for t in range(9, 14):
        got = tem.decode_step(params, cfg, tpool,
                              torch.from_numpy(toks[:, t]).int(), table,
                              torch.tensor([t + 1], dtype=torch.int32))
        np.testing.assert_allclose(got[0].numpy(), full[0, t].numpy(),
                                   atol=ATOL, err_msg=f"pos {t}")
