"""Port parity: serving/paged_attention.py (K2's plain version and the
engine's dispatcher).

The same numpy inputs go through the JAX package's `paged_attention`
(Pallas, interpret mode) and `paged_attention_reference`, and the port's
`paged_attention_dispatch` on the CPU. Page tables name pages in a
shuffled order and leave their tail slots at sink page 0, as the engine
does. All f32; tolerance 2e-5, the bound the JAX package's own
kernel-vs-reference test uses (tests/test_serving.py): the two sides
differ only in summation order.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from generativeaiexamples_tpu.serving import paged_attention as jpa
from generativeaiexamples_tpu_torch.serving import paged_attention as tpa

ATOL = 2e-5


def _inputs(B, H, KH, Hd, ps, maxp, lengths, seed):
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    q = rng.standard_normal((B, H, Hd)).astype(np.float32)
    kp = rng.standard_normal((KH, P, ps, Hd)).astype(np.float32)
    vp = rng.standard_normal((KH, P, ps, Hd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, P))
    table = np.zeros((B, maxp), np.int32)  # tail slots: sink page 0
    used = 0
    for b, n in enumerate(lengths):
        need = -(-n // ps)
        table[b, :need] = perm[used:used + need]
        used += need
    return q, kp, vp, table, np.asarray(lengths, np.int32)


def _port(q, kp, vp, table, lengths):
    return tpa.paged_attention_dispatch(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(lengths)).numpy()


@pytest.mark.parametrize("B,H,KH,Hd,ps,maxp,lengths", [
    (2, 4, 2, 16, 8, 4, [32, 19]),
    (3, 8, 2, 32, 16, 4, [1, 17, 64]),
    (2, 4, 4, 16, 8, 6, [8, 9]),
])
def test_dispatch_matches_jax_kernel_and_reference(B, H, KH, Hd, ps, maxp,
                                                   lengths):
    args = _inputs(B, H, KH, Hd, ps, maxp, lengths, seed=B * ps)
    got = _port(*args)
    jargs = [jnp.asarray(a) for a in args]
    want_ref = np.asarray(jpa.paged_attention_reference(*jargs))
    want_kernel = np.asarray(jpa.paged_attention(*jargs, interpret=True))
    np.testing.assert_allclose(got, want_ref, atol=ATOL)
    np.testing.assert_allclose(got, want_kernel, atol=ATOL)


def test_sink_page_contents_do_not_change_the_result():
    """Tail slots point at page 0; whatever the sink holds (padding k/v
    of earlier prefills) is masked out by `lengths`."""
    q, kp, vp, table, lengths = _inputs(2, 4, 2, 16, 8, 4, [5, 20], seed=3)
    base = _port(q, kp, vp, table, lengths)
    kp[:, 0] = 1e3
    vp[:, 0] = -1e3
    np.testing.assert_allclose(_port(q, kp, vp, table, lengths), base,
                               atol=ATOL)


def test_quantized_form_is_not_ported_yet():
    """Kept under its first name, though every form is ported now: the
    fused int8 pool goes to K4's wrapper, whose plain version equals the
    dequantized pages through the dispatcher's bf16/f32 form, and whose
    verify forms take q as [B, R, H, Hd] (a [B, H, Hd] q with q_rep > 1
    is refused)."""
    from generativeaiexamples_tpu_torch.serving import (
        paged_attention_int8 as tpa8)

    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in _inputs(
        1, 2, 1, 16, 8, 2, [3], seed=0))
    (kq, ks), (vq, vs) = tpa8.quantize_kv(kp), tpa8.quantize_kv(vp)
    kv, scales = tpa8.fuse_kv(kq, ks, vq, vs)
    got = tpa8.paged_attention_int8(q, kv[:, None], scales[:, None], table,
                                    lengths, 0)
    want = tpa.paged_attention_dispatch(
        q, tpa8.dequantize_pages(kq, ks), tpa8.dequantize_pages(vq, vs),
        table, lengths)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    with pytest.raises(ValueError, match="q_rep"):
        tpa8.paged_attention_int8(q, kv[:, None], scales[:, None], table,
                                  lengths, 0, q_rep=2)


def test_paged_wrapper_refuses_other_devices():
    q = torch.empty((1, 2, 64), device="meta")
    pages = torch.empty((1, 3, 8, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpa.paged_attention(q, pages, pages,
                            torch.zeros((1, 2), dtype=torch.int32),
                            torch.ones((1,), dtype=torch.int32))


def test_paged_kernel_matches_reference_on_cuda():
    """K2 on the card against the plain version (bf16 inputs, reference
    in f32). Tolerance 2e-2: the output is rounded to bf16; an indexing
    or masking fault gives O(1) errors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 is a CUDA kernel")
    q, kp, vp, table, lengths = (torch.from_numpy(a).cuda() for a in _inputs(
        3, 32, 8, 128, 128, 4, [1, 130, 512], seed=5))
    q, kp, vp = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
    got = tpa.paged_attention_dispatch(q, kp, vp, table, lengths)
    want = tpa.paged_attention_reference(q.float(), kp.float(), vp.float(),
                                         table, lengths)
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=0)
