"""Tensor-parallel serving: a rank's shard of the params and the KV pool.

Counterpart of generativeaiexamples_tpu/serving/sharding.py. There the
params are placed on a device mesh with the Megatron `param_specs`
layout and GSPMD inserts the collectives; here each rank process holds
its own slice of every leaf as a plain tensor (`shard_llama_params`), the
model's forward runs on the rank's local heads (`local_config`) and calls
the two collectives itself (models/llama.py: one all-reduce after `wo`
and one after `w_down`, a vocab-parallel embedding, vocab-sharded logits
gathered before sampling).

Quantized weights shard too: a `QuantizedTensor` leaf slices its int8
payload with the full weight spec and its per-output-channel scale with
the spec minus the contracted axis, so a column-parallel leaf's scales
shard with its outputs and a row-parallel leaf (`wo`, `w_down`, whose
contracted axis is sharded) keeps every scale, computed over the FULL
column before the slice (ops.quant, models/hf_loader.py's sharded load).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Optional, Sequence

import torch

from generativeaiexamples_tpu_torch.models.llama import (
    LlamaConfig, param_specs)
from generativeaiexamples_tpu_torch.ops.quant import QuantizedTensor
from generativeaiexamples_tpu_torch.config.schema import MeshConfig
from generativeaiexamples_tpu_torch.parallel.mesh import Mesh, build_mesh

_LOG = logging.getLogger(__name__)

# PagePool k/v layout is [L, KH, P, page_size, Hd]; kv-heads live on the
# tensor axis, matching wk/wv's output-dim sharding so decode's KV
# read/write never crosses ranks.
KV_POOL_SPEC = (None, "tensor", None, None, None)
# Fused int8 pools lead with the k|v axis: codes [2, L, KH, P, ps, Hd]
# and narrow scales [2, L, KH, P, ps]; kv-heads (the TP axis) sit at
# axis 2 (kv_cache.QuantPagePool).
KV_FUSED_SPEC = (None, None, "tensor")
KV_FUSED_SCALE_SPEC = (None, None, "tensor")


def tensor_axis_size(mesh: Optional[Mesh]) -> int:
    if mesh is None:
        return 1
    return int(mesh.shape.get("tensor", 1))


def is_sharded(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.size > 1


def validate_tp(cfg: LlamaConfig, mesh: Mesh) -> None:
    """Fail fast at engine build when the geometry can't split."""
    pp = int(mesh.shape.get("pipeline", 1))
    if pp > 1:
        raise ValueError(
            f"serving engine does not support pipeline-parallel meshes "
            f"(pipeline axis = {pp}); use tensor/data axes for serving — "
            f"dcn_pipeline>1 is a training-only layout "
            f"(parallel/pipeline.py)")
    tp = tensor_axis_size(mesh)
    if tp <= 1:
        return
    bad = {name: dim for name, dim in (
        ("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
        ("mlp_dim", cfg.mlp_dim), ("vocab_size", cfg.vocab_size),
    ) if dim % tp}
    if bad:
        g = math.gcd(math.gcd(cfg.n_heads, cfg.n_kv_heads),
                     math.gcd(cfg.mlp_dim, cfg.vocab_size))
        n_dev = mesh.size
        best = max(t for t in range(1, g + 1)
                   if g % t == 0 and n_dev % t == 0)
        raise ValueError(
            f"tensor axis {tp} does not divide model dims {bad}; "
            f"smallest working geometry on {n_dev} device(s): "
            f"ici_tensor={best}"
            + (f", ici_data={n_dev // best}" if n_dev // best > 1 else "")
            + f" (shardable-dim gcd {g}; compatible_mesh() applies this "
            f"clamp automatically)")


def compatible_mesh(lcfg: LlamaConfig, mesh: Mesh) -> Mesh:
    """Return `mesh` if the model's dims divide its tensor axis; else
    rebuild it over the same ranks with the largest compatible tensor
    size and the remainder on the data axis."""
    tp = tensor_axis_size(mesh)
    g = math.gcd(math.gcd(lcfg.n_heads, lcfg.n_kv_heads),
                 math.gcd(lcfg.mlp_dim, lcfg.vocab_size))
    if tp <= 1 or g % tp == 0:
        return mesh
    n_dev = mesh.size
    best = max(t for t in range(1, g + 1) if g % t == 0 and n_dev % t == 0)
    _LOG.warning(
        "mesh tensor=%d incompatible with model (gcd of shardable dims %d); "
        "clamping to tensor=%d, data=%d", tp, g, best, n_dev // best)
    return build_mesh(MeshConfig(ici_tensor=best, ici_data=-1),
                      devices=mesh.devices, rank=mesh.rank)


def local_config(cfg: LlamaConfig, mesh: Optional[Mesh]) -> LlamaConfig:
    """The rank's view of the model: H / tp query heads, KH / tp kv heads
    and mlp_dim / tp MLP columns (the vocabulary stays whole: the logits
    are gathered before sampling). `cfg` itself at tp = 1."""
    tp = tensor_axis_size(mesh)
    if tp <= 1:
        return cfg
    validate_tp(cfg, mesh)
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp,
                               mlp_dim=cfg.mlp_dim // tp)


def _quantized_leaf_spec(spec: tuple):
    """Spec pair for a QuantizedTensor: q keeps the full weight spec; the
    per-output-channel scale drops the contracted axis (-2)."""
    if len(spec) < 2:
        return spec, spec
    return spec, spec[:-2] + (spec[-1],)


def shard_slices(shape: Sequence[int], spec: Sequence, mesh: Mesh) -> tuple:
    """The slice of each dimension of a `shape` leaf that this rank holds
    under `spec` (per dimension None, an axis name or a tuple of them,
    the first the major one), as the JAX NamedSharding places it."""
    coords = mesh.coords
    out = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * len(shape)):
        if axes is None:
            out.append(slice(0, dim))
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n, idx = 1, 0
        for a in axes:
            idx = idx * mesh.shape[a] + coords[a]
            n *= mesh.shape[a]
        if dim % n:
            raise ValueError(f"dimension {dim} does not split over mesh "
                             f"axes {axes} ({n} shards)")
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def shard_leaf(leaf, spec: tuple, mesh: Mesh, device=None):
    """This rank's slice of one leaf (a tensor or a QuantizedTensor) as a
    contiguous tensor of its own on `device` (default: the rank's)."""
    device = device if device is not None else mesh.device

    def take(t: torch.Tensor, s: tuple) -> torch.Tensor:
        part = t[shard_slices(t.shape, s, mesh)]
        return torch.empty(part.shape, dtype=part.dtype,
                           device=device).copy_(part)

    if isinstance(leaf, QuantizedTensor):
        q_spec, s_spec = _quantized_leaf_spec(tuple(spec))
        return QuantizedTensor(take(leaf.q, q_spec), take(leaf.s, s_spec))
    return take(leaf, tuple(spec))


def shard_llama_params(params, cfg: LlamaConfig, mesh: Mesh,
                       device=None) -> Any:
    """This rank's shard of a (possibly int8-quantized) Llama tree: every
    leaf sliced by `llama.param_specs` at this rank's mesh coordinates,
    each a contiguous tensor of its own on `device` (default: the rank's
    device), so the whole tree can be freed."""
    validate_tp(cfg, mesh)
    specs = param_specs(cfg)
    out = {}
    for key, leaf in params.items():
        if key == "layers":
            out[key] = {k: shard_leaf(v, specs[key][k], mesh, device)
                        for k, v in leaf.items()}
        else:
            out[key] = shard_leaf(leaf, specs[key], mesh, device)
    return out


def pool_shard_heads(n_kv_heads: int, mesh: Optional[Mesh]) -> slice:
    """The kv heads of the global pool this rank's pool holds (the
    KV_POOL_SPEC / KV_FUSED_SPEC slice)."""
    tp = tensor_axis_size(mesh)
    if tp <= 1:
        return slice(0, n_kv_heads)
    step = n_kv_heads // tp
    r = mesh.tensor_rank
    return slice(r * step, (r + 1) * step)

