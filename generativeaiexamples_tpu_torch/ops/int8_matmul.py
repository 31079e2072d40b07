"""Weight-only int8 GEMM: y = (x @ q) * scale, the K6 kernel.

Counterpart of generativeaiexamples_tpu/ops/int8_matmul.py. Layout as
there: x [R, K] bf16, q [K, M] int8 (the [in, out] layout the parameter
tree keeps), scale [M] f32 -> y [R, M]. The f32 accumulator is scaled in
f32 and rounded once to the output dtype, the TPU kernel's order.

`int8_matmul` wraps `csrc/int8_matmul.cu`. A CUDA tensor launches the
kernel or raises; a CPU tensor runs `int8_matmul_reference`. Unlike the
JAX wrapper it takes any row count (no padding to a multiple of 8) and
any column count; K must be a multiple of 16.

`int8_matmul_plan` is the kernel's launch plan, pure Python so the CPU
tests can check it: the row tile, and how K is split so that output
tiles x splits fill the card's SMs (split-K; the slices' f32 partials go
to a workspace the wrapper allocates and are summed in slice order, so
the result is the same on every run).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from generativeaiexamples_tpu_torch import kernels

N_SMS = 132        # streaming multiprocessors of an H100 SXM
COL_TILE = 128     # output columns per CTA
K_TILE = 64        # reduction depth of one staged tile
ROW_TILES = (8, 16, 32, 64, 128)  # decode row tiles; 256 above 128 rows
CTA_COST = 2       # a CTA's fixed cost (ring fill, epilogue) in K tiles


class Int8MatmulPlan(NamedTuple):
    regime: str             # "decode" (R <= 128), "prefill", or "unaligned"
    row_tile: int           # rows of x per CTA (the wgmma's N)
    tiles: int              # output tiles (CTAs of one split)
    splits: int             # K slices; each CTA computes one
    k_tiles_per_split: int  # K_TILE-deep tiles in each slice (the last may
                            # hold fewer)
    workspace_bytes: int    # f32 partials, splits x R x M (0 unsplit)


@functools.lru_cache(maxsize=4096)
def int8_matmul_plan(R: int, K: int, M: int) -> Int8MatmulPlan:
    """The K6 launch plan for x [R, K] @ q [K, M].

    M % 16 != 0 cannot be read by TMA and takes the simple kernel, unsplit.
    Otherwise the row tile is the smallest of ROW_TILES that holds R
    (decode) or 256. With fewer than N_SMS output tiles, K is split:
    the split count is the one that minimises the critical path, waves
    x (K tiles + CTA_COST) per CTA, the smaller on a tie. A CTA holds a
    whole SM, so this fills one wave as fully as the tiles allow (w_down
    at decode: 32 tiles x 4 splits) rather than asking for two waves,
    which measured slower on an H100 (PERF.md, §6); with N_SMS tiles
    or more, splitting would only add partials to write and read.
    Cached: the engine asks for the same few shapes on every step."""
    if M % 16:
        return Int8MatmulPlan("unaligned", 0, 0, 1, math.ceil(K / K_TILE), 0)
    row_tile = next((t for t in ROW_TILES if t >= R), 256)
    tiles = math.ceil(M / COL_TILE) * math.ceil(R / row_tile)
    nk = math.ceil(K / K_TILE)
    best = None
    for want in range(1, nk + 1 if tiles < N_SMS else 2):
        per = math.ceil(nk / want)
        splits = math.ceil(nk / per)
        cost = (math.ceil(tiles * splits / N_SMS) * (per + CTA_COST), splits)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    _, splits, per = best
    return Int8MatmulPlan("decode" if R <= 128 else "prefill", row_tile,
                          tiles, splits, per,
                          4 * splits * R * M if splits > 1 else 0)


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
    if x.data_ptr() % 16 or q.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("int8_matmul: x, q and scale must be 16-byte "
                         "aligned")
    if out_dtype != torch.bfloat16:
        raise ValueError(f"int8_matmul: the kernel writes bfloat16, "
                         f"not {out_dtype}")
    plan = int8_matmul_plan(R, K, M)
    out = torch.empty((R, M), dtype=torch.bfloat16, device=x.device)
    ws = tickets = None
    if plan.splits > 1:
        ws = torch.empty((plan.splits, R, M), dtype=torch.float32,
                         device=x.device)
        tickets = kernels.tickets("int8_matmul", x.device, plan.tiles)
    kernels.launch("int8_matmul", x.data_ptr(), q.data_ptr(),
                   scale.data_ptr(), out.data_ptr(),
                   ws.data_ptr() if ws is not None else None,
                   tickets.data_ptr() if tickets is not None else None,
                   R, K, M, plan.row_tile, plan.splits,
                   plan.k_tiles_per_split,
                   torch.cuda.current_stream(x.device).cuda_stream)
    return out
