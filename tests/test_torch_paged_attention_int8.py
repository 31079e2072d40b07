"""Port parity: serving/paged_attention_int8.py (K4's plain version over
the full fused pool).

The same numpy inputs go through the JAX package's `quantize_kv`,
`paged_attention_int8` (Pallas, interpret mode) and
`paged_attention_int8_reference_fused`, and the port's functions on the
CPU. The pool is the FULL fused pool [2, L, KH, P, ps, Hd] with a nonzero
`layer`, page tables name pages in a shuffled order and leave their tail
slots at sink page 0. All f32; tolerance 1e-5: the two sides differ only
in summation order and in where the softmax scale is applied (the kernel
folds it into q, the reference scales the scores), each ~1e-7 here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.serving import paged_attention_int8 as jpa
from generativeaiexamples_tpu_torch.serving import paged_attention_int8 as tpa8

ATOL = 1e-5


def _pool(L, KH, P, ps, Hd, seed):
    """Quantized pages from f32 rows, through the JAX quantizer."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, L, KH, P, ps, Hd)).astype(np.float32)
    q, s = jpa.quantize_kv(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


def _inputs(B, H, KH, Hd, ps, maxp, lengths, L=2, seed=0):
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    q = rng.standard_normal((B, H, Hd)).astype(np.float32)
    kv, sc = _pool(L, KH, P, ps, Hd, seed + 1)
    perm = rng.permutation(np.arange(1, P))
    table = np.zeros((B, maxp), np.int32)
    used = 0
    for b, n in enumerate(lengths):
        need = -(-max(n, 1) // ps)
        table[b, :need] = perm[used:used + need]
        used += need
    return q, kv, sc, table, np.asarray(lengths, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_quantize_kv_bit_identical():
    x = np.random.default_rng(0).standard_normal((3, 2, 5, 16, 64)).astype(
        np.float32) * 3
    x[0, 0, 0, 0] = 0.0  # an all-zero row: the 1e-8 clip
    jq, js = jpa.quantize_kv(jnp.asarray(x))
    tq, ts = tpa8.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tpa8.dequantize_pages(tq, ts).numpy(),
        np.asarray(jpa.dequantize_pages(jq, js)))
    kq, vq = tq[0], tq[1]
    ks, vs = ts[0], ts[1]
    fkv, fs = tpa8.fuse_kv(kq, ks, vq, vs)
    jkv, jfs = jpa.fuse_kv(jq[0], js[0], jq[1], js[1])
    np.testing.assert_array_equal(fkv.numpy(), np.asarray(jkv))
    np.testing.assert_array_equal(fs.numpy(), np.asarray(jfs))


@pytest.mark.parametrize("B,H,KH,lengths,layer", [
    (3, 8, 2, [5, 37, 64], 1),     # G = 4, ragged, a full last page
    (3, 2, 2, [1, 16, 50], 0),     # G = 1
    (2, 8, 2, [0, 33], 1),         # a length-0 row: clamped to 1
])
def test_plain_version_matches_jax_kernel_and_reference(B, H, KH, lengths,
                                                        layer):
    Hd, ps, maxp = 128, 16, 4
    q, kv, sc, table, ln = _inputs(B, H, KH, Hd, ps, maxp, lengths)
    kernel = np.asarray(jpa.paged_attention_int8(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(sc),
        jnp.asarray(table), jnp.asarray(ln), layer, interpret=True))
    got = tpa8.paged_attention_int8(*_t(q, kv, sc, table, ln), layer).numpy()
    np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=0)
    # The JAX reference takes lengths as given; compare where none is 0.
    clamped = np.maximum(ln, 1)
    ref = np.asarray(jpa.paged_attention_int8_reference_fused(
        jnp.asarray(q), jnp.asarray(kv[:, layer]), jnp.asarray(sc[:, layer]),
        jnp.asarray(table), jnp.asarray(clamped)))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    tref = tpa8.paged_attention_int8_reference_fused(
        *_t(q, kv[:, layer], sc[:, layer], table, clamped)).numpy()
    np.testing.assert_allclose(tref, ref, atol=ATOL, rtol=0)


def test_layer_is_indexed_inside_the_wrapper():
    """The wrapper takes the FULL fused pool and reads `layer` from it:
    the same as handing it that layer's one-layer pool at layer 0."""
    q, kv, sc, table, ln = _inputs(2, 8, 2, 128, 16, 3, [20, 41], L=3,
                                   seed=3)
    got = tpa8.paged_attention_int8(*_t(q, kv, sc, table, ln), 2)
    want = tpa8.paged_attention_int8(
        *_t(q, kv[:, 2:3], sc[:, 2:3], table, ln), 0)
    assert torch.equal(got, want)


def test_unported_speculative_forms_raise():
    """Kept under its first name: the verify forms are ported
    (tests/test_torch_paged_attention_tree.py), and what they refuse is a
    q that is not [B, q_rep, H, Hd] or a tree whose node count is not
    q_rep."""
    q, kv, sc, table, ln = _t(*_inputs(2, 8, 2, 128, 16, 3, [20, 41]))
    with pytest.raises(ValueError, match="q_rep"):
        tpa8.paged_attention_int8(q, kv, sc, table, ln, 0, q_rep=2)
    with pytest.raises(ValueError, match="q_rep"):
        tpa8.paged_attention_int8(q, kv, sc, table, ln, 0, tree=(2, 2))
    q4 = q[:, None].expand(2, 3, 8, 128).contiguous()
    with pytest.raises(ValueError, match="q_rep"):
        tpa8.paged_attention_int8(q4, kv, sc, table, ln, 0, q_rep=5,
                                  tree=(2, 2))


def test_paged_int8_kernel_matches_plain_version_on_cuda():
    """K4 on the card (skips without one), bf16 q scaled up so that the
    scores are sharp and every row's output is O(1), within 1e-2 of each
    row's max |out| (the bf16 output rounds by up to 2^-8 of it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 is a CUDA kernel")
    q, kv, sc, table, ln = (t.cuda() for t in _t(*_inputs(
        4, 32, 8, 128, 128, 8, [1, 130, 700, 1024], seed=5)))
    q = (q * 8).bfloat16()
    got = tpa8.paged_attention_int8(q, kv, sc, table, ln, 1)
    want = tpa8.paged_attention_int8_reference_fused(
        q.float(), kv[:, 1], sc[:, 1], table, ln)
    diff = (got.float() - want).abs().reshape(4, -1).amax(1)
    assert bool((diff <= 1e-2 * want.abs().reshape(4, -1).amax(1)).all())
