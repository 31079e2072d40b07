"""Port parity: ops/encoder_attention.py (K3's plain version and wrapper).

The same seeded numpy inputs go through the port's `encoder_attention`
on the CPU (its plain version) and through the JAX package's Pallas
`encoder_attention` in interpret mode, and JAX's `mha_reference(causal=
False, lengths=...)`. f32 tolerance 1e-5: the three compute the same f32
softmax and products and differ only in summation order. A `lengths=0`
row averages V in all three.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.ops.attention import mha_reference as jmha
from generativeaiexamples_tpu.ops.encoder_attention import (
    encoder_attention as jenc)
from generativeaiexamples_tpu_torch.ops import encoder_attention as tenc

ATOL = 1e-5


def _inputs(B, H, S, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, S, D)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("H", [2, 6, 12])
def test_plain_version_matches_jax_kernel_and_reference(H):
    B, S, D = 4, 32, 64
    q, k, v = _inputs(B, H, S, D, seed=H)
    lengths = np.array([32, 17, 0, 1], np.int32)
    got = tenc.encoder_attention(*map(torch.from_numpy, (q, k, v)),
                                 torch.from_numpy(lengths)).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_kernel = np.asarray(jenc(jq, jk, jv, jnp.asarray(lengths),
                                  interpret=True))
    want_ref = np.asarray(jmha(jq, jk, jv, causal=False,
                               lengths=jnp.asarray(lengths)))
    np.testing.assert_allclose(got, want_kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=0)
    # lengths 0: every key masked, the softmax is uniform over all S.
    np.testing.assert_allclose(got[2], np.broadcast_to(
        v[2].mean(axis=1, keepdims=True), v[2].shape), atol=ATOL, rtol=0)


def test_default_lengths_scale_and_bf16_cast_order():
    """No lengths = every key valid; an explicit scale is honoured; with
    bf16 inputs the probabilities are cast to bf16 before P.V, as the
    TPU kernel does (matched by the JAX kernel in interpret mode to bf16
    rounding: 1e-2 on unit-scale outputs)."""
    q, k, v = _inputs(2, 4, 24, 64, seed=9)
    got = tenc.encoder_attention(*map(torch.from_numpy, (q, k, v)),
                                 scale=0.3).numpy()
    want = np.asarray(jenc(*map(jnp.asarray, (q, k, v)), scale=0.3,
                           interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    tb = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    got16 = tenc.encoder_attention(*tb).float().numpy()
    jb = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in tb]
    want16 = np.asarray(jenc(*jb, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(got16, want16, atol=1e-2, rtol=0)


def test_fused_qkv_view_is_accepted():
    """bert.forward hands the op q/k/v views of one [B, S, 3, H, D]
    projection (non-contiguous); the result equals contiguous inputs."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(
        rng.standard_normal((2, 20, 3, 4, 64)).astype(np.float32))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    lengths = torch.tensor([20, 5], dtype=torch.int32)
    got = tenc.encoder_attention(q, k, v, lengths)
    want = tenc.encoder_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), lengths)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tenc.encoder_attention(q, q, q)


def test_encoder_kernel_matches_plain_version_on_cuda():
    """K3 on the card against its plain version on the same bf16 inputs.
    Tolerance 2e-2: the kernel rounds P and its output to bf16 (P before
    the division by the denominator, the plain version after it) and sums
    in another order. Cases: fused-QKV views at S = 256 with a lengths-0
    row (the mean of V), S = 512 (four 128-row query tiles re-reading
    K / V), an S that is no multiple of the 64-key tile, and sharp scores
    (q and each row's last 64 valid keys x 4, V x 1/4 so the output stays
    under 2 where a bf16 ulp is 2^-7) whose maxima all lie in the last
    one or two key tiles, so the online softmax must rescale what it
    summed before; a repeat launch gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3 is a CUDA kernel")
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, H, S, lengths, sharp in (
            (4, 12, 256, [256, 0, 1, 100], False),
            (2, 16, 512, [512, 301], False),
            (3, 2, 33, [0, 20, 33], False),
            (4, 4, 512, [512, 449, 65, 200], True)):
        qkv = torch.randn((B, S, 3, H, 64), generator=g,
                          device="cuda").bfloat16()
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        if sharp:
            q.mul_(4)
            v.mul_(0.25)
            for b, n in enumerate(lengths):
                k[b, :, max(n - 64, 0):n].mul_(4)
        ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        got = tenc.encoder_attention(q, k, v, ln)
        want = tenc.encoder_attention_reference(q, k, v, ln)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=0)
        assert torch.equal(got, tenc.encoder_attention(q, k, v, ln))
