"""Encoder (bidirectional, key-padding-masked) attention: K3.

Counterpart of generativeaiexamples_tpu/ops/encoder_attention.py.

- `encoder_attention_reference`: the plain torch version, written in the
  TPU kernel's order of operations: f32 scores, keys `>= lengths[b]` set
  to -1e30, max-subtracted exp, sum, `p / denom` cast to v's dtype, then
  P.V accumulated in f32. Query rows are not masked, and a row whose
  lengths is 0 averages V (every score is -1e30, so the softmax is
  uniform).
- `encoder_attention`: wrapper of the hand-written CUDA kernel
  `csrc/encoder_attention.cu` (it replaces the Pallas `_encoder_kernel`).
  A CUDA tensor launches the kernel or raises; a CPU tensor runs the
  plain version.

Shapes are [batch, heads, seq, head_dim] with seq <= 512 and head_dim 64
on the card; `lengths` is [batch] valid tokens.
"""

from __future__ import annotations

from typing import Optional

import torch

from generativeaiexamples_tpu_torch import kernels
from generativeaiexamples_tpu_torch.ops.attention import (
    NEG_INF, _check_cuda_operand, _int32_vector)

MAX_SEQ = 512
HEAD_DIM = 64


def encoder_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                lengths: Optional[torch.Tensor] = None, *,
                                scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v [B, H, S, D] -> [B, H, S, D] in q's dtype."""
    B, H, S, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if lengths is not None:
        key_ok = (torch.arange(S, device=q.device)[None, :]
                  < lengths.to(q.device)[:, None])            # [B, S]
        s = torch.where(key_ok[:, None, None, :], s,
                        torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", (p / denom).to(v.dtype).float(),
                     v.float())
    return o.to(q.dtype)


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: Optional[torch.Tensor] = None, *,
                      scale: Optional[float] = None) -> torch.Tensor:
    """K3. On CUDA: bf16 q/k/v [B, H, S, 64] with S <= 512 and a
    contiguous last dimension (views of a fused-QKV projection are taken
    as they are), lengths [B] int32; the output is a [B, H, S, D] view of
    a [B, S, H, D] buffer, so the caller's transpose back to token-major
    layout is free. On the CPU this runs `encoder_attention_reference`."""
    if q.device.type == "cpu":
        return encoder_attention_reference(q, k, v, lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"encoder_attention: unsupported device {q.device}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, H, S, D = q.shape
    if D != HEAD_DIM or not 0 < S <= MAX_SEQ:
        raise ValueError(f"encoder_attention kernel takes head_dim "
                         f"{HEAD_DIM} and 0 < S <= {MAX_SEQ}, got "
                         f"{tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda_operand(name, t, q.device)
    lengths = _int32_vector("lengths", lengths, S, B, q.device)
    out = torch.empty((B, S, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = kernels.strides_arg(*q.stride()[:3], *k.stride()[:3],
                                  *v.stride()[:3], *out.stride()[:3])
    kernels.launch(
        "encoder_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lengths.data_ptr(), B, H, S, D, strides,
        float(scale if scale is not None else D ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    return out
