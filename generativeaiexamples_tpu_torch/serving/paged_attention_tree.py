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
  table crosses from the host. It shares K2's body and launch plan
  (`csrc/paged_bf16.cuh`, `paged_attention.paged_bf16_plan`).
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

from generativeaiexamples_tpu_torch.serving.paged_attention import (
    _launch_paged_bf16, paged_tree_attention_int8_reference_fused,
    paged_tree_attention_reference)
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
    On CUDA: bf16 q and pages (Hd in {64, 128}, ps a multiple of 8 up to
    128), all contiguous, and (H / KH) * r <= 128 query rows per kv head;
    the output is bf16 and the launch follows
    `paged_attention.paged_bf16_plan`. Lengths are clamped to >= 1 as the
    JAX wrapper does."""
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
    if k_pages.dim() != 4:
        raise ValueError(f"paged_tree_attention: pages "
                         f"{tuple(k_pages.shape)} (want [KH, P, ps, Hd])")
    # The kernel clamps lengths to >= 1 and the span to maxp * ps itself.
    return _launch_paged_bf16(
        "paged_attention_tree", q, k_pages, v_pages, page_table, lengths,
        (H // k_pages.shape[0]) * r,
        scale if scale is not None else Hd ** -0.5, k, m)


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
