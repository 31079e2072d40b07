"""Paged tree-verify attention: the K5 kernel and the tree dispatchers.

Counterpart of generativeaiexamples_tpu/serving/paged_attention_tree.py.
Tree speculation (engine.speculative_tree_branches) verifies an
M-branch, depth-k n-gram lattice in one widened decode step: the r =
1 + M*k packed nodes sit at pool slots lengths-1 .. lengths-2+r
(write-then-attend), and node j attends the committed prefix plus its
ancestor-or-self chain (engine_model._tree_layout).

- bf16 pools: `paged_tree_attention` wraps `csrc/paged_attention_tree.cu`
  (K5), which replaces the Pallas `_tree_kernel`. It reads only the
  `length + r - 1` tokens the deepest node sees and builds the ancestor
  mask arithmetically (`paged_attention_int8._tree_keep`), so no mask
  table crosses from the host.
- int8 pools: the twin is K4's tree form,
  `paged_attention_int8(..., q_rep=r, tree=(k, M))`: the same page
  stream as linear verify with the tree mask.

The arithmetic mask is exact only for the canonical lattice
(`_canonical_tree`). The JAX dispatchers quietly take the gather
reference for any other mask; the port does so only on the CPU. On a
CUDA tensor a mask that is not the canonical lattice raises: no route
reaches a plain version on the card.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from generativeaiexamples_tpu_torch import kernels
from generativeaiexamples_tpu_torch.ops.attention import _check_cuda_operand
from generativeaiexamples_tpu_torch.serving.paged_attention import (
    paged_tree_attention_int8_reference_fused, paged_tree_attention_reference)
from generativeaiexamples_tpu_torch.serving.paged_attention_int8 import (
    paged_attention_int8)


@functools.lru_cache(maxsize=None)
def _canonical_tree(k: int, n_branches: int) -> np.ndarray:
    """The [r, r] ancestor-or-self mask `_tree_keep`'s arithmetic
    reproduces; it equals engine_model._tree_layout(k, n_branches)[1]."""
    n = np.arange(1 + n_branches * k)
    branch = np.maximum(n - 1, 0) // k
    depth = np.where(n == 0, 0, np.maximum(n - 1, 0) % k + 1)
    return (n[None, :] == 0) | (
        (n[:, None] > 0) & (n[None, :] > 0)
        & (branch[:, None] == branch[None, :])
        & (depth[None, :] <= depth[:, None]))


def tree_shape_of(anc_mask, k: int, n_branches: int) -> Optional[Tuple]:
    """(k, n_branches) when `anc_mask` is the canonical packed lattice
    for those parameters (the only mask the kernels' arithmetic
    reproduces), else None."""
    anc = np.asarray(anc_mask, bool)
    r = 1 + n_branches * k
    if anc.shape != (r, r) or not np.array_equal(
            anc, _canonical_tree(k, n_branches)):
        return None
    return (k, n_branches)


def paged_tree_attention(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_table: torch.Tensor,
                         lengths: torch.Tensor, tree: Tuple[int, int], *,
                         scale: Optional[float] = None) -> torch.Tensor:
    """K5: tree-verify attention over one layer's pool. q [B, H, r, Hd]
    packed tree queries (r == 1 + k*M for tree = (k, M)), pages [KH, P,
    ps, Hd], int32 page_table [B, maxp] and lengths [B] (incl. the root).
    On CUDA: bf16 q and pages (Hd in {64, 128}), all contiguous, and
    (H / KH) * r <= 128 query rows per kv head; the output is bf16.
    Lengths are clamped to >= 1 as the JAX wrapper does."""
    B, H, r, Hd = q.shape
    k, m = tree
    if r != 1 + k * m:
        raise ValueError(f"paged_tree_attention: {r} nodes for tree {tree}")
    if q.device.type == "cpu":
        return paged_tree_attention_reference(
            q, k_pages, v_pages, page_table, lengths.clamp(min=1),
            _canonical_tree(k, m), scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_tree_attention: unsupported device "
                         f"{q.device}")
    KH, P, ps, Hk = k_pages.shape
    maxp = page_table.shape[1] if page_table.dim() == 2 else -1
    if (v_pages.shape != k_pages.shape or Hk != Hd or Hd not in (64, 128)
            or H % KH or (H // KH) * r > 128 or page_table.shape != (B, maxp)
            or lengths.shape != (B,)):
        raise ValueError(
            f"paged_tree_attention: unsupported shapes q {tuple(q.shape)} "
            f"pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)} table "
            f"{tuple(page_table.shape)} lengths {tuple(lengths.shape)}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        _check_cuda_operand(name, t, q.device)
        if not t.is_contiguous():
            raise ValueError(f"paged_tree_attention: {name} must be "
                             f"contiguous")
    for name, t in (("page_table", page_table), ("lengths", lengths)):
        if t.dtype != torch.int32 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"paged_tree_attention: {name} must be "
                             f"contiguous int32 on {q.device}")
    out = torch.empty_like(q)
    kernels.launch(
        "paged_attention_tree", q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), out.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), B, H, KH, P, ps, maxp, Hd, k, m,
        float(scale if scale is not None else Hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    return out


def _kernel_tree(q, anc_mask, k, n_branches, who):
    tree = tree_shape_of(anc_mask, k, n_branches)
    if tree is None:
        raise ValueError(f"{who}: the ancestor mask is not the canonical "
                         f"(k={k}, M={n_branches}) lattice, the only one "
                         f"the CUDA kernels compute")
    return tree


def paged_tree_attention_dispatch(q, k_pages, v_pages, page_table, lengths,
                                  anc_mask, k: int, n_branches: int, *,
                                  scale=None):
    """bf16/f32 tree verify: the gather reference on the CPU (any mask),
    K5 on CUDA (the canonical (k, n_branches) lattice only)."""
    if q.device.type == "cpu":
        return paged_tree_attention_reference(
            q, k_pages, v_pages, page_table, lengths, anc_mask, scale=scale)
    tree = _kernel_tree(q, anc_mask, k, n_branches,
                        "paged_tree_attention_dispatch")
    return paged_tree_attention(q, k_pages, v_pages, page_table, lengths,
                                tree, scale=scale)


def paged_tree_attention_int8_dispatch(q, kv_pages, kv_scales, page_table,
                                       lengths, anc_mask, k: int,
                                       n_branches: int, layer, *,
                                       scale=None):
    """int8 tree verify over the FULL fused pool [2, L, KH, P, ps, Hd]:
    the gather-then-dequantize reference on the layer's slice on the CPU
    (any mask), K4's tree form on CUDA (the canonical lattice only).
    q [B, H, r, Hd] -> [B, H, r, Hd]."""
    if q.device.type == "cpu":
        return paged_tree_attention_int8_reference_fused(
            q, kv_pages[:, layer], kv_scales[:, layer], page_table, lengths,
            anc_mask, scale=scale)
    tree = _kernel_tree(q, anc_mask, k, n_branches,
                        "paged_tree_attention_int8_dispatch")
    out = paged_attention_int8(
        q.transpose(1, 2).contiguous(), kv_pages, kv_scales, page_table,
        lengths, layer, scale=scale, q_rep=q.shape[2], tree=tree)
    return out.transpose(1, 2)
