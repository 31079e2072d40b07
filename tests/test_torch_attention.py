"""Port parity: ops/attention.py (K1's plain version and dispatcher).

The same numpy inputs (from a seed) go through the JAX package's
`flash_attention` (Pallas, interpret mode) and `mha_reference`, and the
port's `mha_reference` and `attention()` on the CPU. All f32.

Tolerance 2e-5: both sides compute the same f32 softmax attention and
differ only in summation order (the JAX package's own kernel-vs-reference
test uses the same bound, tests/test_attention.py).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from generativeaiexamples_tpu.ops import attention as jattn
from generativeaiexamples_tpu_torch.ops import attention as tattn

ATOL = 2e-5


def _inputs(B, H, KH, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, H, Sq, D), (B, KH, Sk, D), (B, KH, Sk, D)))


def _port(q, k, v, **kw):
    kw = {n: torch.from_numpy(np.asarray(x, np.int32)) if x is not None
          and n in ("lengths", "q_offset") else x for n, x in kw.items()}
    out = tattn.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **kw)
    return out.numpy()


def _jax_flash(q, k, v, **kw):
    kw = {n: jnp.asarray(x, jnp.int32) if x is not None
          and n in ("lengths", "q_offset") else x for n, x in kw.items()}
    return np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=16,
        block_k=16, interpret=True, **kw))


def _jax_ref(q, k, v, **kw):
    kw = {n: jnp.asarray(x, jnp.int32) if x is not None
          and n in ("lengths", "q_offset") else x for n, x in kw.items()}
    return np.asarray(jattn.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), **kw))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_heads", [4, 2, 1])
def test_attention_matches_jax_flash_and_reference(causal, kv_heads):
    """Causal or not, ragged lengths, GQA groups 1/2/4."""
    q, k, v = _inputs(2, 4, kv_heads, 32, 32, 16, seed=kv_heads)
    kw = dict(causal=causal, lengths=[32, 19])
    got = _port(q, k, v, **kw)
    np.testing.assert_allclose(got, _jax_ref(q, k, v, **kw), atol=ATOL)
    np.testing.assert_allclose(got, _jax_flash(q, k, v, **kw), atol=ATOL)


def test_attention_q_offset_matches_jax():
    """Cached continuation: queries start at q_offset[b] inside a longer
    key sequence, the causal diagonal shifts with them."""
    q, k, v = _inputs(3, 4, 2, 16, 48, 16, seed=7)
    kw = dict(causal=True, lengths=[48, 30, 16], q_offset=[32, 14, 0])
    got = _port(q, k, v, **kw)
    np.testing.assert_allclose(got, _jax_ref(q, k, v, **kw), atol=ATOL)
    np.testing.assert_allclose(got, _jax_flash(q, k, v, **kw), atol=ATOL)


def test_fully_masked_row_follows_the_reference():
    """A batch row with no valid key: the port's plain version averages V
    like the JAX reference; the kernels (TPU and CUDA) write zeros. Rows
    that see a key agree with the JAX kernel too."""
    q, k, v = _inputs(2, 4, 2, 16, 16, 16, seed=9)
    kw = dict(causal=True, lengths=[0, 11])
    got = _port(q, k, v, **kw)
    np.testing.assert_allclose(got, _jax_ref(q, k, v, **kw), atol=ATOL)
    flash = _jax_flash(q, k, v, **kw)
    np.testing.assert_array_equal(flash[0], 0.0)
    np.testing.assert_allclose(got[1], flash[1], atol=ATOL)


def test_gqa_expand_matches_jax():
    k = np.random.default_rng(3).standard_normal((2, 2, 5, 8)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tattn._gqa_expand(torch.from_numpy(k), 6).numpy(),
        np.asarray(jattn._gqa_expand(jnp.asarray(k), 6)))


def test_neg_inf_sentinel_matches_jax():
    assert tattn.NEG_INF == jattn.NEG_INF


def test_flash_wrapper_refuses_other_devices():
    """No silent fallback: only a CPU tensor takes the plain version; any
    other device goes to the kernel or raises."""
    q = torch.empty((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.flash_attention(q, q, q)


def test_flash_kernel_matches_reference_on_cuda():
    """K1 on the card against the plain version (bf16 inputs, reference
    in f32). Tolerance 2e-2: the kernel rounds P to bf16 before P.V and
    rounds its output to bf16; indexing or masking faults give O(1).
    Cases: ragged lengths; a chunk at q_offset (the chunked-prefill
    shape, cut down); head_dim 64; non-causal; a zero-length row, whose
    output the kernel writes as zeros. A second launch gives the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 is a CUDA kernel")
    g = torch.Generator(device="cuda").manual_seed(0)
    # (B, H, KH, Sq, Sk, D, lengths, q_offset, causal)
    cases = ((2, 8, 2, 200, 200, 128, [200, 77], None, True),
             (1, 8, 2, 256, 1024, 128, [700], [444], True),
             (2, 8, 2, 300, 300, 64, [300, 129], None, True),
             (2, 4, 4, 96, 160, 128, [160, 33], None, False),
             (2, 8, 2, 128, 128, 128, [0, 100], None, True))
    for B, H, KH, Sq, Sk, D, ln, off, causal in cases:
        q = torch.randn((B, H, Sq, D), generator=g, device="cuda").bfloat16()
        k = torch.randn((B, KH, Sk, D), generator=g, device="cuda").bfloat16()
        v = torch.randn((B, KH, Sk, D), generator=g, device="cuda").bfloat16()
        lengths = torch.tensor(ln, dtype=torch.int32, device="cuda")
        q_offset = (torch.tensor(off, dtype=torch.int32, device="cuda")
                    if off is not None else None)
        got = tattn.attention(q, k, v, causal=causal, lengths=lengths,
                              q_offset=q_offset)
        again = tattn.attention(q, k, v, causal=causal, lengths=lengths,
                                q_offset=q_offset)
        assert torch.equal(got, again)
        want = tattn.mha_reference(q.float(), k.float(), v.float(),
                                   causal=causal, lengths=lengths,
                                   q_offset=q_offset)
        empty = lengths == 0  # rows with no key: zeros, not the mean of V
        assert float(got[empty].float().abs().sum()) == 0.0
        torch.testing.assert_close(got[~empty].float(), want[~empty],
                                   atol=2e-2, rtol=0)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_decode_attention_reference_matches_jax(kv_heads):
    """One decode step against a contiguous cache, ragged lengths (one of
    them the whole cache)."""
    rng = np.random.default_rng(7)
    B, H, S, D = 3, 4, 24, 16
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, kv_heads, S, D)).astype(np.float32)
    v = rng.standard_normal((B, kv_heads, S, D)).astype(np.float32)
    lengths = np.asarray([5, 24, 1], np.int32)
    want = np.asarray(jattn.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths), scale=0.3))
    got = tattn.decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), scale=0.3)
    assert tuple(got.shape) == (B, H, D)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
