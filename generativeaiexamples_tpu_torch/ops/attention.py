"""Attention ops: the plain PyTorch reference and the K1 flash kernel.

Counterpart of generativeaiexamples_tpu/ops/attention.py.

- `mha_reference`: scaled-dot-product attention with GQA, causal and
  padding masks and an f32 softmax, in plain torch. The numerics oracle
  for the kernel, the path a CPU tensor takes, and the differentiable
  route the training modules ask for (`attention(..., route="plain")`).
- `decode_attention_reference`: one decode step against a contiguous
  cache, on `mha_reference`.
- `flash_attention`: wrapper of the hand-written CUDA kernel
  `csrc/flash_attention.cu` (it replaces the Pallas `_flash_kernel`).
  A CUDA tensor launches the kernel or raises (also when an operand
  requires grad: the kernel has no backward); a CPU tensor runs
  `mha_reference`.
- `attention`: the dispatcher the model code calls, with its `route`.

All shapes are [batch, heads, seq, head_dim]; `lengths` is [batch] valid
kv counts and `q_offset` [batch] the absolute position of q[0].

One documented difference between the kernel and the reference, the same
as between the JAX package's TPU kernel and its reference: a query row
with no valid key is written as zeros by the kernel, while the reference's
softmax over an all-masked row averages V. Serving never produces such a
row (every prefill row sees key 0).
"""

from __future__ import annotations

from typing import Optional

import torch

from generativeaiexamples_tpu_torch import kernels

NEG_INF = -1e30


def _gqa_expand(k: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    """[B, KH, S, D] -> [B, H, S, D] by repeating each kv head."""
    n_kv = k.shape[1]
    if n_kv == n_q_heads:
        return k
    if n_q_heads % n_kv:
        raise ValueError(f"{n_q_heads} query heads not a multiple of "
                         f"{n_kv} kv heads")
    return k.repeat_interleave(n_q_heads // n_kv, dim=1)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, lengths: Optional[torch.Tensor] = None,
                  q_offset: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Scaled-dot-product attention, GQA-aware, f32 softmax.

    q [B, H, Sq, D]; k/v [B, KH, Sk, D]; lengths [B] valid kv length;
    q_offset [B] absolute position of q[0]."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    k = _gqa_expand(k, H)
    v = _gqa_expand(v, H)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    kv_pos = torch.arange(Sk, device=q.device)[None, None, None, :]
    mask = torch.ones((B, 1, Sq, Sk), dtype=torch.bool, device=q.device)
    if lengths is not None:
        mask &= kv_pos < lengths.to(q.device)[:, None, None, None]
    if causal:
        off = (q_offset.to(q.device) if q_offset is not None
               else torch.zeros((B,), dtype=torch.int32, device=q.device))
        q_pos = (torch.arange(Sq, device=q.device)[None, None, :, None]
                 + off[:, None, None, None])
        mask &= kv_pos <= q_pos
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)


def decode_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, lengths: torch.Tensor,
                               *, scale: Optional[float] = None
                               ) -> torch.Tensor:
    """Single-step decode attention against a contiguous KV cache: q
    [B, H, D] (one new token a sequence), k/v caches [B, KH, S_max, D],
    lengths [B] tokens in the cache including the current one."""
    out = mha_reference(q[:, :, None, :], k_cache, v_cache, causal=False,
                        lengths=lengths, scale=scale)
    return out[:, :, 0, :]


def _check_cuda_operand(name: str, t: torch.Tensor, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16 for the CUDA kernel, "
                        f"got {t.dtype}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs a contiguous last dim and "
                         f"16-byte aligned rows (strides {t.stride()})")


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """A kernel bound with ctypes is invisible to autograd: an operand
    that requires grad would silently get no gradient, so it raises.
    Training asks for the differentiable route (`route="plain"`)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an operand requires grad, and the CUDA kernel has "
            f"no backward; differentiate through the plain route "
            f"(attention=\"plain\" in models/llama.py and models/bert.py)")


def _int32_vector(name: str, t: Optional[torch.Tensor], fill: int, n: int,
                  device) -> torch.Tensor:
    if t is None:
        return torch.full((n,), fill, dtype=torch.int32, device=device)
    if t.shape != (n,) or t.dtype != torch.int32 or t.device != device:
        raise ValueError(f"{name} must be int32 [{n}] on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    lengths: Optional[torch.Tensor] = None,
                    q_offset: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """K1: causal/padded prefill flash attention. q [B,H,Sq,D] bf16,
    k/v [B,KH,Sk,D] bf16 with D in {64, 128}, lengths/q_offset [B] int32.

    On CUDA the output is a [B, H, Sq, D] view of a [B, Sq, H, D] buffer,
    so the caller's transpose back to token-major layout is free. On the
    CPU this runs `mha_reference`."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, lengths=lengths,
                             q_offset=q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    _, KH, Sk, Dk = k.shape
    if k.shape[0] != B or Dk != D or H % KH or D not in (64, 128):
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} (head_dim 64 or 128, "
                         f"H a multiple of KH)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda_operand(name, t, q.device)
    refuse_grad("flash_attention", q, k, v)
    lengths = _int32_vector("lengths", lengths, Sk, B, q.device)
    q_offset = _int32_vector("q_offset", q_offset, 0, B, q.device)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = kernels.strides_arg(*q.stride()[:3], *k.stride()[:3],
                                  *v.stride()[:3], *out.stride()[:3])
    kernels.launch(
        "flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lengths.data_ptr(), q_offset.data_ptr(),
        B, H, KH, Sq, Sk, D, strides,
        float(scale if scale is not None else D ** -0.5), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    return out


ROUTES = ("kernel", "plain")


def attention(q, k, v, *, causal=True, lengths=None, q_offset=None,
              scale=None, route: str = "kernel"):
    """Dispatch. route "kernel": the K1 kernel for CUDA tensors,
    `mha_reference` for CPU tensors (the choice is made inside
    `flash_attention`). route "plain": `mha_reference` on any device,
    the differentiable route a caller asks for (the JAX package's
    `use_pallas=False`), never a fallback."""
    if route == "plain":
        return mha_reference(q, k, v, causal=causal, lengths=lengths,
                             q_offset=q_offset, scale=scale)
    if route != "kernel":
        raise ValueError(f"attention route {route!r}: one of {ROUTES}")
    return flash_attention(q, k, v, causal=causal, lengths=lengths,
                           q_offset=q_offset, scale=scale)
