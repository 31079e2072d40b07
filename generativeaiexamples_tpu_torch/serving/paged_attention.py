"""Paged decode attention: the gather reference and the K2 CUDA kernel.

Counterpart of generativeaiexamples_tpu/serving/paged_attention.py.
Layouts (one layer):

  q          [B, H, Hd]          one token per sequence
  k_pages    [KH, P, ps, Hd]     the layer's slice of the page pool
  page_table [B, maxp] int32     page ids per sequence (0 = sink page)
  lengths    [B] int32           valid tokens, including the new one

`paged_attention` wraps `csrc/paged_attention.cu`, which replaces both
TPU routes (the in-repo `_paged_kernel` and JAX's bundled JetStream
kernel). A CUDA tensor launches the kernel or raises; a CPU tensor runs
`paged_attention_reference`. The fused int8 pool goes to K4
(serving/paged_attention_int8.py).

`paged_bf16_plan` is the launch plan of K2 and of the tree-verify kernel
K5 (serving/paged_attention_tree.py), which share one body
(`csrc/paged_bf16.cuh`): the consumer warps per 16-row tile of query
rows, the slots a ring stage holds, and how the page axis is split
across CTAs when B x KH CTAs alone would leave the card idle. It is pure
Python so the CPU tests can check it; the wrappers pass it the card's SM
count.

Tree verify (speculation) has its plain versions here, as in the JAX
package: `paged_tree_attention_reference` over a bf16/f32 pool and
`paged_tree_attention_int8_reference_fused` over one layer of the fused
int8 pool. They are the oracles of K5 (serving/paged_attention_tree.py)
and of K4's tree form, and the route a CPU tensor takes.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from generativeaiexamples_tpu_torch import kernels
from generativeaiexamples_tpu_torch.ops.attention import (
    NEG_INF, _check_cuda_operand, _gqa_expand, mha_reference)


def paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, page_table: torch.Tensor,
                              lengths: torch.Tensor, *,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Gather-based paged attention in plain torch (the numerics oracle)."""
    B, H, Hd = q.shape
    KH, _, ps, _ = k_pages.shape
    maxp = page_table.shape[1]
    table = page_table.long()
    # [KH, B, maxp, ps, Hd] -> [B, KH, maxp * ps, Hd]
    k = k_pages[:, table].permute(1, 0, 2, 3, 4).reshape(B, KH, maxp * ps, Hd)
    v = v_pages[:, table].permute(1, 0, 2, 3, 4).reshape(B, KH, maxp * ps, Hd)
    out = mha_reference(q[:, :, None, :], k, v, causal=False,
                        lengths=lengths, scale=scale)
    return out[:, :, 0, :]


def _gather_pages(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[KH, P, ps, ...] pages gathered through table [B, maxp] ->
    [B, KH, maxp * ps, ...]."""
    KH, _, ps = pages.shape[:3]
    B, maxp = table.shape
    g = pages[:, table.long()]                 # [KH, B, maxp, ps, ...]
    return g.transpose(0, 1).reshape(B, KH, maxp * ps, *pages.shape[3:])


def _tree_attention_core(q, k, v, lengths, anc_mask, scale):
    """Tree-verify attention over gathered pool rows. q [B, H, r, Hd]:
    r packed tree nodes whose k/v were just written at pool slots
    lengths-1 .. lengths-2+r; k/v [B, KH, S, Hd]. Node j attends the
    committed prefix (slots < lengths-1) plus its ancestor-or-self chain
    (anc_mask [r, r], row j marks j's ancestors). f32 softmax, output in
    q's dtype."""
    B, H, r, Hd = q.shape
    S = k.shape[2]
    dev = q.device
    k = _gqa_expand(k, H)
    v = _gqa_expand(v, H)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    rel = (torch.arange(S, device=dev)[None, :]
           - (lengths.to(dev).long() - 1)[:, None])          # [B, S]
    prefix_ok = rel < 0
    in_tree = (rel >= 0) & (rel < r)
    anc = torch.as_tensor(anc_mask, dtype=torch.bool, device=dev)  # [r, r]
    anc_cols = anc[:, rel.clamp(0, r - 1)]                   # [r, B, S]
    tree_ok = in_tree[:, None, :] & anc_cols.transpose(0, 1)  # [B, r, S]
    mask = (prefix_ok[:, None, :] | tree_ok)[:, None]         # [B, 1, r, S]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)


def paged_tree_attention_reference(q, k_pages, v_pages, page_table, lengths,
                                   anc_mask, *, scale=None):
    """Tree-verify attention over one layer's bf16/f32 pool ([KH, P, ps,
    Hd]), gather-based: the oracle of K5. q [B, H, r, Hd]; lengths [B]
    count the committed prefix plus the tree root (node 0)."""
    Hd = q.shape[-1]
    return _tree_attention_core(
        q, _gather_pages(k_pages, page_table),
        _gather_pages(v_pages, page_table), lengths, anc_mask,
        scale if scale is not None else Hd ** -0.5)


def paged_tree_attention_int8_reference_fused(q, kv_pages, kv_scales,
                                              page_table, lengths, anc_mask,
                                              *, scale=None):
    """The tree-verify twin over ONE layer of the fused int8 pool ([2, KH,
    P, ps, Hd] codes, [2, KH, P, ps] scales): gather, then dequantize
    only the gathered pages. The oracle of K4's tree form."""
    Hd = q.shape[-1]

    def deq(i):
        codes = _gather_pages(kv_pages[i], page_table)     # [B, KH, S, Hd]
        s = _gather_pages(kv_scales[i], page_table)        # [B, KH, S]
        return codes.float() * s.float()[..., None]

    return _tree_attention_core(q, deq(0), deq(1), lengths, anc_mask,
                                scale if scale is not None else Hd ** -0.5)


MAX_WARPS = 8            # consumer warps of a CTA (row tiles x key slices)
CTAS_PER_SM = 3          # CTAs a split launch aims for per SM
MIN_SPLIT_SLOTS = 512    # kv slots a split covers at least
STAGE_KEYS = 128         # kv slots a ring stage holds
RING_BYTES = 131072      # bytes of the ring


class PagedBf16Plan(NamedTuple):
    row_tiles: int        # 16-row tiles of the (H / KH) * R query rows
    key_slices: int       # consumer warps per row tile, each a slice of every stage
    keys_per_step: int    # keys a warp takes per step (32, or 16)
    stage_keys: int       # kv slots a ring stage holds
    ring_stages: int      # stages in the ring
    splits: int           # CTAs along the page axis (grid z)
    pages_per_split: int  # table slots each split covers (the last may hold fewer)
    workspace_bytes: int  # f32 partials, 0 unsplit


@functools.lru_cache(maxsize=1024)
def paged_bf16_plan(B: int, KH: int, rows: int, Hd: int, ps: int,
                    maxp: int, n_sms: int) -> PagedBf16Plan:
    """The K2 / K5 launch plan for B sequences, KH kv heads and `rows` =
    (H / KH) * R query rows a kv head (R = 1 for decode, the tree's node
    count for K5), pages of ps tokens, maxp table slots, on a card of
    n_sms SMs. A ring stage holds STAGE_KEYS slots of K and V (a page of
    128 slots, or sixteen of 8; 64 KB at head_dim 128), and the ring
    RING_BYTES. Splits: with fewer than CTAS_PER_SM * n_sms CTAs of
    (kv head, row), the page axis is cut into equal runs of table slots
    so that B * KH * splits comes close to that target, each run at
    least MIN_SPLIT_SLOTS slots (the last split to arrive merges the
    others, a round of loads per key slice); a row whose pages end
    before a split's run skips it. Key slices (warps per 16-row tile, a
    power of two, at most MAX_WARPS warps): split launches take as many
    as leave 16 keys of a stage to each, unsplit ones as many as leave
    32. These choices measured fastest on an H100 (`chip_smoke.py
    --variants`, PERF.md). Cached: the engine asks for the same few
    shapes on every step."""
    row_tiles = math.ceil(rows / 16)
    if row_tiles > MAX_WARPS:
        raise ValueError(f"paged_bf16_plan: {rows} query rows a kv head "
                         f"exceed {16 * MAX_WARPS}")
    want = max(1, min(maxp, CTAS_PER_SM * n_sms // (B * KH)))
    per = max(math.ceil(maxp / want), math.ceil(MIN_SPLIT_SLOTS / ps))
    splits = math.ceil(maxp / per)
    least = 16 if splits > 1 else 32  # keys of a stage each slice keeps
    slices = 1
    while (row_tiles * slices * 2 <= MAX_WARPS
           and STAGE_KEYS // (slices * 2) >= least):
        slices *= 2
    step = 32 if (STAGE_KEYS // slices) % 32 == 0 else 16
    ws = (4 * B * KH * splits * row_tiles * (Hd // 2 + 4) * 32
          if splits > 1 else 0)
    return PagedBf16Plan(row_tiles, slices, step, STAGE_KEYS,
                         RING_BYTES // (4 * STAGE_KEYS * Hd), splits,
                         min(per, maxp), ws)


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_paged_bf16(name: str, q, k_pages, v_pages, page_table, lengths,
                       rows: int, scale: float, *tree) -> torch.Tensor:
    """Checks the operands K2 and K5 share and launches kernel `name`
    under paged_bf16_plan: bf16 q and pages [KH, P, ps, Hd] (Hd in {64,
    128}, ps a multiple of 8 up to 128), int32 page_table [B, maxp] and
    lengths [B], all contiguous on q's device; `rows` query rows a kv
    head. The output is bf16 in q's layout."""
    B, H, Hd = q.shape[0], q.shape[1], q.shape[-1]
    KH, P, ps, Hk = k_pages.shape
    maxp = page_table.shape[1] if page_table.dim() == 2 else -1
    if (v_pages.shape != k_pages.shape or Hk != Hd or Hd not in (64, 128)
            or H % KH or rows > 16 * MAX_WARPS or ps % 8
            or not 0 < ps <= 128 or page_table.shape != (B, maxp)
            or lengths.shape != (B,)):
        raise ValueError(
            f"{name}: unsupported shapes q {tuple(q.shape)} pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} table "
            f"{tuple(page_table.shape)} lengths {tuple(lengths.shape)}")
    for label, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        _check_cuda_operand(label, t, q.device)
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    for label, t in (("page_table", page_table), ("lengths", lengths)):
        if t.dtype != torch.int32 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous int32 "
                             f"on {q.device}")
    plan = paged_bf16_plan(B, KH, rows, Hd, ps, maxp,
                           _sm_count(q.device.index))
    out = torch.empty_like(q)
    ws = tickets = None
    if plan.splits > 1:
        ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                         device=q.device)
        tickets = kernels.tickets(name, q.device, B * KH)
    kernels.launch(
        name, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        out.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        tickets.data_ptr() if tickets is not None else None,
        B, H, KH, P, ps, maxp, Hd, *tree, plan.key_slices, plan.stage_keys,
        plan.ring_stages, plan.pages_per_split, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    return out


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """K2: paged decode attention. bf16 q [B,H,Hd] and pages
    [KH,P,ps,Hd] (Hd in {64, 128}, ps a multiple of 8 up to 128, at most
    128 query heads a kv head), int32 page_table [B, maxp] and lengths
    [B]; all contiguous. The launch follows `paged_bf16_plan`; a row of
    length 0 gets zeros on the card."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} pages "
                         f"{tuple(k_pages.shape)} (want [B, H, Hd] and "
                         f"[KH, P, ps, Hd])")
    Hd = q.shape[-1]
    return _launch_paged_bf16(
        "paged_attention", q, k_pages, v_pages, page_table, lengths,
        q.shape[1] // k_pages.shape[0],
        scale if scale is not None else Hd ** -0.5)


def paged_attention_dispatch(q, k_pages, v_pages, page_table, lengths, *,
                             scale=None):
    """The engine's entry point over a bf16/f32 pool. `lengths` INCLUDES
    the current token, whose k/v must already be in the pool
    (write-then-attend). The fused int8 pool has its own entry point,
    `paged_attention_int8.paged_attention_int8` (K4), which the engine
    calls directly."""
    return paged_attention(q, k_pages, v_pages, page_table, lengths,
                           scale=scale)
