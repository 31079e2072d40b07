"""Port parity: ops/quant.py and ops/int8_matmul.py (K6's plain version).

The same numpy weights go through the JAX package's `quantize_tensor` /
`quantize_llama_params` and the port's: codes and scales must be
bit-identical (the same f32 arithmetic, round half to even). The port's
`mm` (CPU route) and `int8_matmul_reference` are held against the JAX
`mm` on its XLA route and against the Pallas `int8_matmul` in interpret
mode, within f32 atol 1e-4 (only summation order differs; outputs are
O(10) at K = 256, where f32 sums carry ~1e-5 of rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.ops import quant as jq
from generativeaiexamples_tpu.ops.int8_matmul import int8_matmul as jmatmul
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.ops import quant as tq
from generativeaiexamples_tpu_torch.ops.int8_matmul import (
    int8_matmul, int8_matmul_plan, int8_matmul_reference)

ATOL = 1e-4


def _w(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape,axis", [((256, 384), -2), ((3, 64, 48), -2),
                                        ((40, 24), -1)])
def test_quantize_tensor_bit_identical(shape, axis):
    w = _w(shape, 0)
    w[..., 0, :] = 0.0  # an all-zero input row: the 1e-8 clip
    want = jq.quantize_tensor(jnp.asarray(w), contract_axis=axis)
    got = tq.quantize_tensor(torch.from_numpy(w), contract_axis=axis)
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))


def test_quantize_llama_params_bit_identical_and_in_place():
    cfg = jl.LlamaConfig.tiny()
    jparams = jl.init_params(cfg, jax.random.PRNGKey(0))
    want = jq.quantize_llama_params(jparams)
    tparams = convert.llama_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    emb = tparams["tok_emb"]
    got = tq.quantize_llama_params(tparams, "cpu")
    assert got is tparams and got["tok_emb"] is emb  # in place; lookup kept
    assert tq.is_quantized(got)
    for key in tq.LLAMA_QUANT_KEYS + ("lm_head",):
        g = got["layers"][key] if key != "lm_head" else got["lm_head"]
        w = want["layers"][key] if key != "lm_head" else want["lm_head"]
        np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q), key)
        np.testing.assert_array_equal(g.s.numpy(), np.asarray(w.s), key)
    for key in ("ln1", "ln2"):
        assert not isinstance(got["layers"][key], tq.QuantizedTensor)


def test_converter_carries_quantized_leaves_both_ways():
    cfg = jl.LlamaConfig.tiny()
    jparams = jq.quantize_llama_params(
        jl.init_params(cfg, jax.random.PRNGKey(1)))
    tparams = convert.llama_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    wq = tparams["layers"]["wq"]
    assert isinstance(wq, tq.QuantizedTensor)
    assert wq.q.dtype == torch.int8 and wq.s.dtype == torch.float32
    assert tparams["layers"]["ln1"].dtype == torch.float32
    # A quantized leaf comes back as a (q, s) pair, wrapped here.
    back = jax.tree.map(
        lambda v: jq.QuantizedTensor(*map(jnp.asarray, v))
        if isinstance(v, tuple) else jnp.asarray(v),
        convert.llama_params_to_numpy(tparams),
        is_leaf=lambda v: isinstance(v, tuple))
    assert isinstance(back["lm_head"], jq.QuantizedTensor)
    for key in tq.LLAMA_QUANT_KEYS:
        for part in ("q", "s"):
            a = getattr(back["layers"][key], part)
            b = getattr(jparams["layers"][key], part)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("R", [16, 13])
def test_mm_and_plain_version_match_jax(R):
    """R = 13 is a ragged row count (the JAX kernel needs a multiple of 8
    and gets padded rows; the port takes any)."""
    x = _w((R, 256), 2)
    qt = jq.quantize_tensor(jnp.asarray(_w((256, 384), 3)))
    q, s = np.array(qt.q), np.array(qt.s)  # writable copies
    xla = np.asarray(jq.mm(jnp.asarray(x), qt))
    pad = (-R) % 8
    pallas = np.asarray(jmatmul(jnp.asarray(np.pad(x, ((0, pad), (0, 0)))),
                                qt.q, qt.s, interpret=True))[:R]
    tw = tq.QuantizedTensor(torch.from_numpy(q), torch.from_numpy(s))
    got_mm = tq.mm(torch.from_numpy(x), tw).numpy()
    got_ref = int8_matmul(torch.from_numpy(x), tw.q, tw.s).numpy()
    np.testing.assert_array_equal(
        got_ref, int8_matmul_reference(torch.from_numpy(x), tw.q,
                                       tw.s).numpy())
    for got in (got_mm, got_ref):
        np.testing.assert_allclose(got, xla, atol=ATOL, rtol=0)
        np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)


def test_mm_stacked_and_batched_shapes():
    """A [B, S, K] activation against a 2-D weight keeps its leading axes;
    a stacked [L, K, M] QuantizedTensor slices to one layer."""
    x = torch.from_numpy(_w((2, 5, 64), 4))
    qt = tq.quantize_tensor(torch.from_numpy(_w((3, 64, 32), 5)))
    layer = qt[1]
    assert layer.q.shape == (64, 32) and layer.s.shape == (32,)
    y = tq.mm(x, layer)
    assert y.shape == (2, 5, 32)
    want = int8_matmul_reference(x.reshape(10, 64), layer.q, layer.s)
    np.testing.assert_allclose(y.reshape(10, 32).numpy(), want.numpy(),
                               atol=ATOL, rtol=0)
    plain = torch.from_numpy(_w((64, 32), 6))
    assert torch.equal(tq.mm(x, plain), x @ plain)


def test_quantize_llama_params_raises_without_cuda(monkeypatch):
    from generativeaiexamples_tpu_torch.models import llama as tl

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = tl.init_params(tl.LlamaConfig.tiny(), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tq.quantize_llama_params(params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tq.quantize_llama_params(params, "cuda")
    assert tq.is_quantized(tq.quantize_llama_params(params, "cpu"))


def test_int8_matmul_kernel_matches_plain_version_on_cuda():
    """K6 on the card (skips without one): ragged R and M, against the
    plain version in f32, within 1e-2 of max |y| (the bf16 output's
    rounding grows with K)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 is a CUDA kernel")
    g = torch.Generator(device="cuda").manual_seed(0)
    # Split-K decode shapes (wk_wv and w_down at R = 8 and 128), the
    # linear (256) and tree (1,664) verify rows, a ragged R above 128, a
    # K that is not a multiple of the 64-deep tile, and M % 16 != 0 (the
    # simple kernel).
    for R, K, M in ((8, 4096, 1024), (128, 14336, 4096), (256, 4096, 1024),
                    (1664, 1024, 2048), (300, 1024, 384), (37, 528, 256),
                    (37, 512, 1000)):
        assert int8_matmul_plan(R, K, M).splits > 1 or R > 128 or M % 16
        x = torch.randn((R, K), generator=g, device="cuda").bfloat16()
        qt = tq.quantize_tensor(torch.randn((K, M), generator=g,
                                            device="cuda"))
        got = int8_matmul(x, qt.q, qt.s)
        assert torch.equal(got, int8_matmul(x, qt.q, qt.s))
        want = int8_matmul_reference(x, qt.q, qt.s, torch.float32)
        assert float((got.float() - want).abs().max()) <= 1e-2 * float(
            want.abs().max())


# Every quantized projection of Llama-3-8B as (K, M), as chip_smoke.K6_SHAPES.
K6_SHAPES = {"wq_wo": (4096, 4096), "wk_wv": (4096, 1024),
             "w_gate_up": (4096, 14336), "w_down": (14336, 4096),
             "lm_head": (4096, 128256)}


@pytest.mark.parametrize("name", sorted(K6_SHAPES))
def test_int8_matmul_plan_fills_the_card(name):
    """K6's launch plan at every 8B projection and the row counts the
    int8 paths meet: CTAs for at least 80% of the 132 SMs, in one wave
    when the output tiles alone do not fill the card (a CTA holds a whole
    SM, and a second wave measured slower than a partly idle first), K
    slices that are positive multiples of the 64-deep tile and cover K in
    order, and a workspace of splits x R x M f32 exactly when K is
    split."""
    K, M = K6_SHAPES[name]
    for R in (1, 8, 37, 128, 129, 256, 1664, 4096):
        plan = int8_matmul_plan(R, K, M)
        assert plan.regime == ("decode" if R <= 128 else "prefill")
        assert plan.row_tile >= min(R, 256)
        assert plan.tiles == -(-M // 128) * -(-R // plan.row_tile)
        ctas = plan.tiles * plan.splits
        assert ctas >= 0.8 * 132
        assert plan.tiles >= 132 or ctas <= 132
        step = 64 * plan.k_tiles_per_split  # split i covers [i step, (i+1) step)
        slices = [(i * step, min(K, (i + 1) * step))
                  for i in range(plan.splits)]
        assert len(slices) == plan.splits
        assert slices[0][0] == 0 and slices[-1][1] == K
        for (b0, e0), (b1, _) in zip(slices, slices[1:]):
            assert e0 == b1
        assert all(e > b and (e - b) % 64 == 0 for b, e in slices)
        assert plan.workspace_bytes == (4 * plan.splits * R * M
                                        if plan.splits > 1 else 0)


def test_int8_matmul_plan_unaligned_columns():
    """M % 16 != 0 cannot be read by TMA: the simple kernel, unsplit."""
    plan = int8_matmul_plan(128, 4096, 1000)
    assert plan.regime == "unaligned" and plan.splits == 1
    assert plan.workspace_bytes == 0


@pytest.mark.parametrize("shape", [(8, 2, 5, 128), (3, 7, 64)])
def test_quantize_kv_bit_identical_to_jax(shape):
    """The int8 pool's quantize-on-write (paged_attention_int8.quantize_kv,
    whose divisor is a 0-d tensor made by a device fill, not a host
    copy): codes and scales bit-identical to the JAX quantize_kv on
    the same numpy rows, an all-zero row (the 1e-8 clip) included."""
    from generativeaiexamples_tpu.serving.paged_attention_int8 import (
        quantize_kv as jquantize_kv)
    from generativeaiexamples_tpu_torch.serving.paged_attention_int8 import (
        quantize_kv)

    x = _w(shape, 3) * 4.0
    x[..., 0, :] = 0.0
    for scale_dtype, jdt in ((torch.float32, jnp.float32),
                             (torch.bfloat16, jnp.bfloat16)):
        jq_, js = jquantize_kv(jnp.asarray(x), scale_dtype=jdt)
        q, s = quantize_kv(torch.from_numpy(x), scale_dtype=scale_dtype)
        assert q.dtype == torch.int8 and s.dtype == scale_dtype
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
        np.testing.assert_array_equal(s.float().numpy(),
                                      np.asarray(js).astype(np.float32))


def test_div127_divides_by_a_device_tensor_not_a_scalar():
    """div127 is x / 127 correctly rounded, the same bits as numpy's f32
    division, with the divisor a device fill (no host copy)."""
    x = np.abs(_w((4096,), 5)) * 10.0
    got = tq.div127(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, x / np.float32(127.0))
