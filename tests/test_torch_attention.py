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
    rounds its output to bf16; indexing or masking faults give O(1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 is a CUDA kernel")
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((2, 8, 200, 128), generator=g, device="cuda").bfloat16()
    k = torch.randn((2, 2, 200, 128), generator=g, device="cuda").bfloat16()
    v = torch.randn((2, 2, 200, 128), generator=g, device="cuda").bfloat16()
    lengths = torch.tensor([200, 77], dtype=torch.int32, device="cuda")
    got = tattn.attention(q, k, v, causal=True, lengths=lengths)
    want = tattn.mha_reference(q.float(), k.float(), v.float(), causal=True,
                               lengths=lengths)
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=0)
