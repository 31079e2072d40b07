"""Weight-only int8 GEMM: y = (x @ q) * scale, the K6 kernel.

Counterpart of generativeaiexamples_tpu/ops/int8_matmul.py. Layout as
there: x [R, K] bf16, q [K, M] int8 (the [in, out] layout the parameter
tree keeps), scale [M] f32 -> y [R, M]. The f32 accumulator is scaled in
f32 and rounded once to the output dtype, the TPU kernel's order.

`int8_matmul` wraps `csrc/int8_matmul.cu`. A CUDA tensor launches the
kernel or raises; a CPU tensor runs `int8_matmul_reference`. Unlike the
JAX wrapper it takes any row count (no padding to a multiple of 8) and
any column count; K must be a multiple of 16.
"""

from __future__ import annotations

from typing import Optional

import torch

from generativeaiexamples_tpu_torch import kernels


def int8_matmul_reference(x: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """The plain version: f32 product of x and the widened codes, times
    the f32 scale, one rounding to out_dtype (default x.dtype)."""
    y = (x.float() @ q.float()) * scale.float()
    return y.to(out_dtype or x.dtype)


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K6. On CUDA: x [R, K] bf16, q [K, M] int8 and scale [M] f32, all
    contiguous with 16-byte aligned x and q; R >= 1, K a multiple of 16,
    any M; the output is bf16."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    out_dtype = out_dtype or x.dtype
    if x.dim() != 2 or q.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)} q "
                         f"{tuple(q.shape)} scale {tuple(scale.shape)}")
    R, K = x.shape
    M = q.shape[1]
    if (q.shape[0] != K or scale.shape[0] != M or R < 1 or M < 1 or K < 16
            or K % 16):
        raise ValueError(f"int8_matmul: unsupported shapes x {tuple(x.shape)}"
                         f" q {tuple(q.shape)} scale {tuple(scale.shape)} "
                         f"(K a positive multiple of 16)")
    for name, t, dtype in (("x", x, torch.bfloat16), ("q", q, torch.int8),
                           ("scale", scale, torch.float32)):
        if t.dtype != dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous {dtype} "
                             f"on {x.device}, got {t.dtype} on {t.device}")
    if x.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("int8_matmul: x and q must be 16-byte aligned")
    if out_dtype != torch.bfloat16:
        raise ValueError(f"int8_matmul: the kernel writes bfloat16, "
                         f"not {out_dtype}")
    out = torch.empty((R, M), dtype=torch.bfloat16, device=x.device)
    kernels.launch("int8_matmul", x.data_ptr(), q.data_ptr(),
                   scale.data_ptr(), out.data_ptr(), R, K, M,
                   torch.cuda.current_stream(x.device).cuda_stream)
    return out
