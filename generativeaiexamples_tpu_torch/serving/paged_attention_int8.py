"""Paged decode attention over the fused int8 KV pool, the K4 kernel.

Counterpart of generativeaiexamples_tpu/serving/paged_attention_int8.py.
int8 KV halves the pool's bytes against bf16, and decode attention is
bound by reading the pool. Scales are one f32 per (k|v, layer, kv head,
token): 4 bytes beside each 128-byte code row.

Layouts (kv_cache.QuantPagePool):

  q          [B, H, Hd], or [B, R, H, Hd] when q_rep = R > 1
  kv_pages   [2, L, KH, P, ps, Hd]   int8, the FULL pool; [0] = k, [1] = v
  kv_scales  [2, L, KH, P, ps]       f32 (amax / 127 over Hd at write)
  page_table [B, maxp] int32         page ids (0 = sink page)
  lengths    [B] int32               valid tokens INCLUDING the current one
                                     (q_rep > 1: the FIRST query's)
  layer      int                     the layer to attend over

`paged_attention_int8` wraps `csrc/paged_attention_int8.cu` in all three
of the TPU kernel's forms: one query per sequence (`q_rep = 1`); R
consecutive verify positions whose query j attends `pos < length + j`
(`q_rep = R`, linear speculation); and the packed tree of tree verify
(`tree = (k, M)`, `q_rep = 1 + k * M`), whose ancestor mask is the
arithmetic `_tree_keep`. The pages are read once for all R positions. A
CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
versions (`paged_attention_int8_reference_fused` for one query,
`paged_attention_int8_rep_reference` for the others).

`paged_int8_plan` is the kernel's launch plan, pure Python so the CPU
tests can check it: the consumer warps per 16-row tile of query rows,
and how the page axis is split across CTAs (flash-decoding) when B x KH
CTAs alone would leave the card idle. The wrapper passes it the card's
SM count.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from generativeaiexamples_tpu_torch import kernels
from generativeaiexamples_tpu_torch.ops.attention import NEG_INF
from generativeaiexamples_tpu_torch.serving.paged_attention import (
    _gather_pages, _sm_count, paged_attention_reference)


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


def _tree_keep(pos, length, jrow, r: int, tree):
    """Tree-verify keep mask over the packed lattice, computed
    arithmetically from indices (no table): node 0 is the root at slot
    length-1, node 1 + m*k + (d-1) is branch m's depth-d draft, so node
    t is an ancestor-or-self of node j iff t == 0, or both sit on the
    same branch with depth(t) <= depth(j). pos: absolute kv slots;
    length: the row's length incl. the root; jrow: the query's node
    index; r = 1 + M*k nodes; tree = (k, M). Broadcasting tensors."""
    k, _branches = tree
    rel = pos - (length - 1)
    in_tree = (rel >= 0) & (rel < r)
    # Clamped so the div/mod see non-negative values; the guards
    # (jrow > 0, rel >= 1) exclude every clamped case.
    jn = (jrow - 1).clamp(min=0)
    tn = (rel - 1).clamp(min=0)
    same_chain = ((jrow > 0) & (rel >= 1)
                  & (jn // k == tn // k) & (tn % k <= jn % k))
    return (rel < 0) | (in_tree & ((rel == 0) | same_chain))


def paged_attention_int8_rep_reference(q, kv_pages, kv_scales, page_table,
                                       lengths, *, scale=None, tree=None):
    """K4's plain version for R = q.shape[1] queries per sequence, over
    ONE layer of the fused pool ([2, KH, P, ps, Hd] codes, [2, KH, P, ps]
    scales): query j sits at position lengths-1+j and attends
    `pos < lengths + j`, or under `tree = (k, M)` (R == 1 + k*M) the
    prefix plus its ancestor chain (`_tree_keep`). Gather, then
    dequantize only the gathered pages. q [B, R, H, Hd] -> [B, R, H, Hd]
    in q's dtype."""
    B, R, H, Hd = q.shape
    dev = q.device
    s = scale if scale is not None else Hd ** -0.5

    def deq(i):
        codes = _gather_pages(kv_pages[i], page_table)     # [B, KH, S, Hd]
        sc = _gather_pages(kv_scales[i], page_table)       # [B, KH, S]
        return codes.float() * sc.float()[..., None]

    k, v = deq(0), deq(1)
    KH, S = k.shape[1], k.shape[2]
    # Query head h reads kv head h // (H / KH), without repeating k / v.
    qg = q.float().reshape(B, R, KH, H // KH, Hd)
    logits = torch.einsum("brkgd,bksd->brkgs", qg, k) * s
    pos = torch.arange(S, device=dev)[None, None, :]
    length = lengths.to(dev).long()[:, None, None]
    jrow = torch.arange(R, device=dev)[None, :, None]
    keep = (_tree_keep(pos, length, jrow, R, tree) if tree is not None
            else pos < length + jrow)                       # [B, R, S]
    logits = torch.where(keep[:, :, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("brkgs,bksd->brkgd", probs, v)
    return out.reshape(B, R, H, Hd).to(q.dtype)


MAX_WARPS = 8        # consumer warps of a CTA (row tiles x key slices)
CTAS_PER_SM = 2      # CTAs a split launch aims for per SM (two resident;
                     # twice as many measured slower, PERF.md)


class PagedInt8Plan(NamedTuple):
    row_tiles: int        # 16-row tiles of the (H / KH) * q_rep query rows
    key_slices: int       # consumer warps per row tile, each a slice of every page
    keys_per_step: int    # keys a warp takes per step (32, or 16)
    splits: int           # CTAs along the page axis (grid z)
    pages_per_split: int  # table slots each split covers (the last may hold fewer)
    workspace_bytes: int  # f32 partials, 0 unsplit


@functools.lru_cache(maxsize=1024)
def paged_int8_plan(B: int, KH: int, rows: int, Hd: int, ps: int,
                    maxp: int, n_sms: int) -> PagedInt8Plan:
    """The K4 launch plan for B sequences, KH kv heads and `rows` = (H /
    KH) * q_rep query rows a kv head, pages of ps tokens, maxp table
    slots, on a card of n_sms SMs. Splits: with fewer than CTAS_PER_SM *
    n_sms CTAs of (kv head, row), the page axis is cut into equal runs of
    table slots so that B * KH * splits comes close to that target; a
    row whose pages end before a split's run skips it. Key slices (warps
    per 16-row tile, a power of two, at most 8 warps): split launches
    take as many as leave 16 keys of a page to each; unsplit ones keep 32
    keys a step where the page allows; both choices measured fastest on
    an H100 (`chip_smoke.py --variants`, PERF.md). Cached: the engine
    asks for the same few shapes on every step."""
    row_tiles = math.ceil(rows / 16)
    if row_tiles > MAX_WARPS:
        raise ValueError(f"paged_int8_plan: {rows} query rows a kv head "
                         f"exceed {16 * MAX_WARPS}")
    want = max(1, min(maxp, CTAS_PER_SM * n_sms // (B * KH)))
    per = math.ceil(maxp / want)
    splits = math.ceil(maxp / per)
    slices = 1
    while row_tiles * slices * 2 <= MAX_WARPS and ps % (slices * 32) == 0:
        slices *= 2
    if splits == 1 and ps % 32 == 0:
        slices = min(slices, ps // 32)
    step = 32 if (ps // slices) % 32 == 0 else 16
    ws = (4 * B * KH * splits * row_tiles * (Hd // 2 + 4) * 32
          if splits > 1 else 0)
    return PagedInt8Plan(row_tiles, slices, step, splits, per, ws)


def paged_attention_int8(q: torch.Tensor, kv_pages: torch.Tensor,
                         kv_scales: torch.Tensor, page_table: torch.Tensor,
                         lengths: torch.Tensor, layer: int, *,
                         scale: Optional[float] = None, q_rep: int = 1,
                         tree=None) -> torch.Tensor:
    """K4. q is [B, H, Hd], or [B, R, H, Hd] with `q_rep = R > 1` (R
    verify positions; under `tree = (k, M)` the packed lattice, R == 1 +
    k*M). Lengths are clamped to >= 1, as the JAX wrapper does (a
    length-0 row attends one masked-in token; the engine ignores inactive
    rows). On CUDA the bf16 q goes to the kernel as it is, with the
    softmax scale applied to the score columns there: bf16 q (Hd in {64,
    128}), the full int8 pool and f32 scales with ps a multiple of 16 up
    to 128, int32 page_table and lengths, all contiguous, and at most 128
    query rows ((H / KH) * R) per kv head; the output is bf16. The launch
    follows `paged_int8_plan`."""
    if tree is not None and q_rep != 1 + tree[0] * tree[1]:
        raise ValueError(f"paged_attention_int8: tree {tree} needs q_rep "
                         f"== 1 + k * M, got {q_rep}")
    want_dim = 4 if q_rep > 1 else 3
    if q.dim() != want_dim or (q_rep > 1 and q.shape[1] != q_rep):
        raise ValueError(f"paged_attention_int8: q {tuple(q.shape)} for "
                         f"q_rep {q_rep} (want [B, H, Hd] or [B, R, H, Hd])")
    B, H, Hd = q.shape[0], q.shape[-2], q.shape[-1]
    s = scale if scale is not None else Hd ** -0.5
    if q.device.type == "cpu":
        layer_kv, layer_s = kv_pages[:, layer], kv_scales[:, layer]
        if q_rep == 1:
            return paged_attention_int8_reference_fused(
                q, layer_kv, layer_s, page_table, lengths.clamp(min=1),
                scale=s)
        return paged_attention_int8_rep_reference(
            q, layer_kv, layer_s, page_table, lengths.clamp(min=1),
            scale=s, tree=tree)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_int8: unsupported device "
                         f"{q.device}")
    two, L, KH, P, ps, Hk = kv_pages.shape
    maxp = page_table.shape[1] if page_table.dim() == 2 else -1
    if (two != 2 or kv_scales.shape != kv_pages.shape[:-1] or Hk != Hd
            or Hd not in (64, 128) or H % KH or ps % 16
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
    if any(t.data_ptr() % 16 for t in (q, kv_pages, kv_scales)):
        raise ValueError("paged_attention_int8: q, kv_pages and kv_scales "
                         "must be 16-byte aligned")
    index = (q.device.index if q.device.index is not None
             else torch.cuda.current_device())
    plan = paged_int8_plan(B, KH, (H // KH) * q_rep, Hd, ps, maxp,
                           _sm_count(index))
    out = torch.empty_like(q)
    ws = tickets = None
    if plan.splits > 1:
        ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                         device=q.device)
        tickets = kernels.tickets("paged_attention_int8", q.device,
                                  B * KH)
    tk, tm = tree if tree is not None else (0, 0)
    # The kernel clamps lengths to >= 1 and the span to maxp * ps itself.
    kernels.launch(
        "paged_attention_int8", q.data_ptr(), kv_pages.data_ptr(),
        kv_scales.data_ptr(), out.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), ws.data_ptr() if ws is not None else None,
        tickets.data_ptr() if tickets is not None else None,
        B, H, KH, L, P, ps, maxp, Hd, int(layer), q_rep, int(tk), int(tm),
        plan.key_slices, plan.pages_per_split, float(s),
        torch.cuda.current_stream(q.device).cuda_stream)
    return out
