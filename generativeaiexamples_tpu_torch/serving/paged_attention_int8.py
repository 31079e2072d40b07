"""Paged decode attention over the fused int8 KV pool, the K4 kernel.

Counterpart of generativeaiexamples_tpu/serving/paged_attention_int8.py.
int8 KV halves the pool's bytes against bf16, and decode attention is
bound by reading the pool. Scales are one f32 per (k|v, layer, kv head,
token): 4 bytes beside each 128-byte code row.

Layouts (kv_cache.QuantPagePool):

  q          [B, H, Hd]              one token per sequence
  kv_pages   [2, L, KH, P, ps, Hd]   int8, the FULL pool; [0] = k, [1] = v
  kv_scales  [2, L, KH, P, ps]       f32 (amax / 127 over Hd at write)
  page_table [B, maxp] int32         page ids (0 = sink page)
  lengths    [B] int32               valid tokens INCLUDING the current one
  layer      int                     the layer to attend over

`paged_attention_int8` wraps `csrc/paged_attention_int8.cu` (its q_rep = 1
form). A CUDA tensor launches the kernel or raises; a CPU tensor runs
`paged_attention_int8_reference_fused` over the layer's slice. The
speculative forms (`q_rep > 1`, `tree`) are not ported yet and raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from generativeaiexamples_tpu_torch import kernels
from generativeaiexamples_tpu_torch.serving.paged_attention import (
    paged_attention_reference)


def quantize_kv(x: torch.Tensor, scale_dtype=torch.float32):
    """Symmetric int8 over the last axis (head_dim): one scale per
    (..., token) row. Returns (codes int8, scales [...-1] scale_dtype).
    The JAX package's arithmetic, so codes and scales are bit-identical."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s = (amax / 127.0).clamp(min=1e-8)
    q = torch.round(xf / s).clamp(-127, 127).to(torch.int8)
    return q, s.squeeze(-1).to(scale_dtype)


def dequantize_pages(q_pages: torch.Tensor, scales: torch.Tensor,
                     dtype=torch.float32) -> torch.Tensor:
    """[..., ps, Hd] int8 + [..., ps] -> float pages."""
    return q_pages.to(dtype) * scales.to(dtype)[..., None]


def paged_attention_int8_reference(q, k_pages, k_scales, v_pages, v_scales,
                                   page_table, lengths, *, scale=None):
    """Dequantize-then-attend over UNFUSED one-layer pages ([KH, P, ps,
    Hd] codes, [KH, P, ps] scales)."""
    k = dequantize_pages(k_pages, k_scales)
    v = dequantize_pages(v_pages, v_scales)
    return paged_attention_reference(q, k, v, page_table, lengths,
                                     scale=scale).to(q.dtype)


def paged_attention_int8_reference_fused(q, kv_pages, kv_scales, page_table,
                                         lengths, *, scale=None):
    """The plain version over one layer of the fused layout ([2, KH, P,
    ps, Hd] codes, [2, KH, P, ps] scales)."""
    return paged_attention_int8_reference(
        q, kv_pages[0], kv_scales[0], kv_pages[1], kv_scales[1],
        page_table, lengths, scale=scale)


def fuse_kv(kq, ks, vq, vs):
    """Separate quantized k/v ([KH, P, ps, Hd] + [KH, P, ps]) -> the fused
    layout."""
    return torch.stack([kq, vq], dim=0), torch.stack([ks, vs], dim=0)


def paged_attention_int8(q: torch.Tensor, kv_pages: torch.Tensor,
                         kv_scales: torch.Tensor, page_table: torch.Tensor,
                         lengths: torch.Tensor, layer: int, *,
                         scale: Optional[float] = None, q_rep: int = 1,
                         tree=None) -> torch.Tensor:
    """K4. The softmax scale is folded into an f32 copy of q, and lengths
    are clamped to >= 1, as the JAX wrapper does (a length-0 row attends
    one masked-in token; the engine ignores inactive rows). On CUDA: bf16
    q [B, H, Hd] (Hd in {64, 128}, H / KH <= 8), the full int8 pool and
    f32 scales with ps a multiple of 16 up to 128, int32 page_table and
    lengths, all contiguous; the output is bf16."""
    if q_rep != 1 or tree is not None:
        raise NotImplementedError(
            "paged_attention_int8: the speculative forms (q_rep > 1, tree) "
            "are not ported yet (ROADMAP A.13)")
    B, H, Hd = q.shape
    s = scale if scale is not None else Hd ** -0.5
    if q.device.type == "cpu":
        return paged_attention_int8_reference_fused(
            q, kv_pages[:, layer], kv_scales[:, layer], page_table,
            lengths.clamp(min=1), scale=s)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_int8: unsupported device "
                         f"{q.device}")
    two, L, KH, P, ps, Hk = kv_pages.shape
    maxp = page_table.shape[1] if page_table.dim() == 2 else -1
    if (two != 2 or kv_scales.shape != kv_pages.shape[:-1] or Hk != Hd
            or Hd not in (64, 128) or H % KH or H // KH > 8 or ps % 16
            or not 0 < ps <= 128 or page_table.shape != (B, maxp)
            or lengths.shape != (B,) or not 0 <= int(layer) < L):
        raise ValueError(
            f"paged_attention_int8: unsupported shapes q {tuple(q.shape)} "
            f"pool {tuple(kv_pages.shape)} scales {tuple(kv_scales.shape)} "
            f"table {tuple(page_table.shape)} lengths {tuple(lengths.shape)} "
            f"layer {layer}")
    for name, t, dtype in (("q", q, torch.bfloat16),
                           ("kv_pages", kv_pages, torch.int8),
                           ("kv_scales", kv_scales, torch.float32),
                           ("page_table", page_table, torch.int32),
                           ("lengths", lengths, torch.int32)):
        if t.dtype != dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_attention_int8: {name} must be "
                             f"contiguous {dtype} on {q.device}, got "
                             f"{t.dtype} on {t.device}")
    qk = q.float() * s
    out = torch.empty_like(q)
    # The kernel clamps lengths to [1, maxp * ps] itself.
    kernels.launch(
        "paged_attention_int8", qk.data_ptr(), kv_pages.data_ptr(),
        kv_scales.data_ptr(), out.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), B, H, KH, L, P, ps, maxp, Hd, int(layer),
        torch.cuda.current_stream(q.device).cuda_stream)
    return out
