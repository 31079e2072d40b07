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
"""

from __future__ import annotations

from typing import Optional

import torch

from generativeaiexamples_tpu_torch import kernels
from generativeaiexamples_tpu_torch.ops.attention import NEG_INF
from generativeaiexamples_tpu_torch.serving.paged_attention import (
    _gather_pages, paged_attention_reference)


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


def paged_attention_int8(q: torch.Tensor, kv_pages: torch.Tensor,
                         kv_scales: torch.Tensor, page_table: torch.Tensor,
                         lengths: torch.Tensor, layer: int, *,
                         scale: Optional[float] = None, q_rep: int = 1,
                         tree=None) -> torch.Tensor:
    """K4. q is [B, H, Hd], or [B, R, H, Hd] with `q_rep = R > 1` (R
    verify positions; under `tree = (k, M)` the packed lattice, R == 1 +
    k*M). The softmax scale is folded into an f32 copy of q, and lengths
    are clamped to >= 1, as the JAX wrapper does (a length-0 row attends
    one masked-in token; the engine ignores inactive rows). On CUDA: bf16
    q (Hd in {64, 128}), the full int8 pool and f32 scales with ps a
    multiple of 16 up to 128, int32 page_table and lengths, all
    contiguous, and (H / KH) * R query rows per kv head whose staging
    fits the block's shared memory; the output is bf16."""
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
    qk = q.float() * s
    out = torch.empty_like(q)
    tk, tm = tree if tree is not None else (0, 0)
    # The kernel clamps lengths to >= 1 and the span to maxp * ps itself,
    # and refuses (launch error) a row count whose staging overflows
    # shared memory.
    kernels.launch(
        "paged_attention_int8", qk.data_ptr(), kv_pages.data_ptr(),
        kv_scales.data_ptr(), out.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), B, H, KH, L, P, ps, maxp, Hd, int(layer),
        q_rep, int(tk), int(tm),
        torch.cuda.current_stream(q.device).cuda_stream)
    return out
