"""Memory-budget planner: size the paged-KV pool from the device's memory.

The port's own copy of generativeaiexamples_tpu/serving/memory_plan.py,
with the same formulas and the same text. Given a model config, the
engine config (weight and KV dtypes, page size, batch and bucket sizes),
a mesh geometry and the per-device memory, `plan_engine_memory` counts
the weights, the scratch caches, the activation transients and the
headroom, and gives the largest page count that fits beside them.

With `engine.auto_pool_pages` the engine sizes its `PagePool` from the
plan; a plan that cannot hold one max-length sequence fails at build with
the breakdown and the smallest tensor-parallel mesh that would fit. A
tensor-parallel rank plans its own shard (`plan_rank_memory`): the mesh's
axis sizes over its own device, the pager's host tier per rank process.

The accounting is analytic over `models.llama.param_shapes` and
`param_specs`: per-device shard bytes come from each leaf's mesh axes and
the axis sizes, so a 70B plan over 8 devices can be made (or refused)
on one card or none. The weight and pool lines are exact; the scratch
and activation lines are the reference's documented estimates (the
caching allocator owns those buffers), which `chip_smoke.py` holds
against the card's peak.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from generativeaiexamples_tpu_torch.config.schema import (
    AUTO_POOL_SHARED, EngineConfig)
from generativeaiexamples_tpu_torch.device import DeviceLike
from generativeaiexamples_tpu_torch.models.llama import LlamaConfig

GiB = float(1 << 30)

# The CPU has no device memory limit: a budget large enough that test
# engines plan, small enough that 70B geometries take the fail-fast path.
_CPU_DEFAULT_HBM = 4 << 30

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


class MemoryPlanError(RuntimeError):
    """Raised at engine build when the plan cannot fit. Carries the whole
    breakdown and the smallest mesh that would fit."""

    def __init__(self, msg: str, plan: Optional["MemoryPlan"] = None):
        super().__init__(msg)
        self.plan = plan


@dataclass(frozen=True)
class PlanLine:
    name: str
    bytes_per_device: int
    exact: bool  # analytic and exact, or a documented estimate
    note: str = ""


@dataclass(frozen=True)
class MemoryPlan:
    """Per-device memory accounting for one engine build."""

    lines: Tuple[PlanLine, ...]  # fixed costs (everything but the pool)
    hbm_bytes_per_device: int
    headroom_bytes: int  # per device, left to the allocator
    page_bytes_per_device: int  # ONE page's per-device footprint
    fit_pages: int  # pool pages that fit the budget
    pool_pages: int  # pages the engine allocates
    default_pages: int  # the worst-case sizing without the planner
    axis_sizes: Dict[str, int] = field(default_factory=dict)
    devices_per_host: int = 1
    n_processes: int = 1
    # The KV pager's host tier (host RAM; zeros with the pager off): its
    # budget per host, one page record's bytes and the slots that fit.
    pager_host_budget_mb: int = 0
    pager_rec_bytes_per_host: int = 0
    pager_host_slots: int = 0

    @property
    def fixed_bytes_per_device(self) -> int:
        return sum(line.bytes_per_device for line in self.lines)

    @property
    def pool_bytes_per_device(self) -> int:
        return self.pool_pages * self.page_bytes_per_device

    @property
    def total_bytes_per_device(self) -> int:
        return self.fixed_bytes_per_device + self.pool_bytes_per_device

    @property
    def free_bytes_per_device(self) -> int:
        return (self.hbm_bytes_per_device - self.headroom_bytes
                - self.total_bytes_per_device)

    def per_host(self, bytes_per_device: int) -> int:
        return bytes_per_device * self.devices_per_host

    def breakdown(self) -> str:
        tp = self.axis_sizes.get("tensor", 1)
        hdr = (f"memory plan (per device; {self.devices_per_host} dev/host"
               f" x {self.n_processes} host(s); tensor={tp})")
        rows = [("hbm", self.hbm_bytes_per_device, ""),
                ("headroom", self.headroom_bytes, "reserved")]
        for line in self.lines:
            tag = "exact" if line.exact else "estimate"
            note = f"{tag}{', ' + line.note if line.note else ''}"
            rows.append((line.name, line.bytes_per_device, note))
        rows.append(("kv_pool", self.pool_bytes_per_device,
                     f"{self.pool_pages} pages x "
                     f"{self.page_bytes_per_device / (1 << 20):.2f} MiB "
                     f"(fit={self.fit_pages}, legacy={self.default_pages})"))
        rows.append(("free", self.free_bytes_per_device, ""))
        w = max(len(n) for n, _, _ in rows)
        body = "\n".join(
            f"  {n:<{w}}  {b / GiB:9.3f} GiB"
            f"  ({b * self.devices_per_host / GiB:.3f} GiB/host)"
            + (f"  [{note}]" if note else "")
            for n, b, note in rows)
        out = hdr + "\n" + body
        if self.pager_host_budget_mb > 0:
            out += (
                f"\n  kv pager host tier (host RAM, per host): "
                f"{self.pager_host_budget_mb} MiB budget -> "
                f"{self.pager_host_slots} page slots x "
                f"{self.pager_rec_bytes_per_host / (1 << 20):.2f} MiB "
                f"local slice")
        return out


# -- analytic shard accounting ---------------------------------------------


def _dtype_name(dtype) -> str:
    return dtype if isinstance(dtype, str) else str(dtype).replace(
        "torch.", "")


def _itemsize(dtype) -> int:
    return _ITEMSIZE[_dtype_name(dtype)]


def _shard_numel(shape, spec, axis_sizes: Dict[str, int]) -> int:
    """Per-device element count of `shape` whose dimensions shard over the
    mesh axes `spec` (ceil division: a dimension the axis does not divide
    over-counts rather than under-counts)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    n = 1
    for dim, axis in zip(shape, entries):
        n *= math.ceil(dim / (int(axis_sizes.get(axis, 1)) if axis else 1))
    return n


def weight_bytes_per_device(lcfg: LlamaConfig, axis_sizes: Dict[str, int],
                            quantize: bool = False) -> int:
    """Exact per-device bytes of the (possibly int8) sharded parameter
    tree. Shapes come from `llama.param_shapes` (the initializer's, with
    nothing allocated), mesh axes from `llama.param_specs`; an int8 leaf
    counts its codes (int8, the leaf's axes) and its f32 scales (the leaf
    without its contracted dimension), as `ops.quant.quantize_llama_params`
    lays them out."""
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops.quant import LLAMA_QUANT_KEYS

    shapes = llama.param_shapes(lcfg)
    specs = llama.param_specs(lcfg)
    wsize = _itemsize(lcfg.dtype)

    def leaf(shape, spec, quantized: bool) -> int:
        if not quantized:
            return _shard_numel(shape, spec, axis_sizes) * wsize
        q = _shard_numel(shape, spec, axis_sizes)
        s_shape = shape[:-2] + shape[-1:]
        s_spec = spec[:-2] + (spec[-1],) if len(spec) >= 2 else spec
        return q + 4 * _shard_numel(s_shape, s_spec, axis_sizes)

    total = 0
    for name, shape in shapes.items():
        if name == "layers":
            for k, lshape in shape.items():
                total += leaf(lshape, specs["layers"][k],
                              quantize and k in LLAMA_QUANT_KEYS)
        else:
            total += leaf(shape, specs[name], quantize and name == "lm_head")
    return total


def pool_page_bytes_per_device(lcfg: LlamaConfig, ecfg: EngineConfig,
                               axis_sizes: Dict[str, int]) -> int:
    """Exact per-device bytes of ONE pool page. bf16 / f32 `PagePool`:
    k and v each [L, KH, P, ps, Hd]; fused int8 `QuantPagePool`: codes
    [2, L, KH, P, ps, Hd] int8 and scales [2, L, KH, P, ps] f32; kv heads
    shard over "tensor"."""
    tp = int(axis_sizes.get("tensor", 1))
    kh = math.ceil(lcfg.n_kv_heads / tp)
    base = lcfg.n_layers * kh * ecfg.page_size
    if ecfg.kv_dtype == "int8":
        return 2 * base * lcfg.head_dim + 2 * base * 4
    return 2 * base * lcfg.head_dim * _itemsize(ecfg.kv_dtype)


def _scratch_lines(lcfg: LlamaConfig, ecfg: EngineConfig,
                   axis_sizes: Dict[str, int]) -> Tuple[PlanLine, ...]:
    tp = int(axis_sizes.get("tensor", 1))
    wsize = _itemsize(lcfg.dtype)
    # One long prefill in flight holds a full-length scratch cache
    # [L, 1, KH, max_seq_len, Hd] for k and v (the engine's
    # _max_long_prefills is 1), counted unsharded.
    long_pf = (2 * lcfg.n_layers * lcfg.n_kv_heads
               * ecfg.max_seq_len * lcfg.head_dim * wsize)
    # Activation transients: the widest prefill dispatch runs N sequences
    # of the largest bucket through the stack; ~4 hidden-width and 2
    # MLP-width live copies (the reference's estimate), plus the f32
    # last-token logits [N, vocab / tp].
    group = ecfg.max_prefill_group or ecfg.max_batch_size
    n_seq = max(1, min(group, ecfg.max_batch_size))
    bucket = max(ecfg.prefill_buckets) if ecfg.prefill_buckets else 128
    tokens = n_seq * bucket
    mlp = math.ceil(lcfg.mlp_dim / tp)
    acts = tokens * (4 * lcfg.dim + 2 * mlp) * wsize
    logits = n_seq * math.ceil(lcfg.vocab_size / tp) * 4
    return (
        PlanLine("long_prefill_scratch", long_pf, False,
                 "1 full-length KVCache, counted unsharded"),
        PlanLine("activation_transients", acts + logits, False,
                 f"{n_seq} seq x {bucket}-token bucket"),
    )


# -- the budget and the plan ------------------------------------------------


def device_hbm_bytes(ecfg: EngineConfig, device: DeviceLike = None) -> int:
    """Per-device memory budget: the config's `hbm_gb_per_device` when
    set, else the CUDA device's total memory, else the CPU default."""
    if ecfg.hbm_gb_per_device > 0:
        return int(ecfg.hbm_gb_per_device * GiB)
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return _CPU_DEFAULT_HBM


def plan_engine_memory(
    lcfg: LlamaConfig,
    ecfg: EngineConfig,
    *,
    axis_sizes: Optional[Dict[str, int]] = None,
    n_processes: int = 1,
    devices_per_host: Optional[int] = None,
    hbm_bytes_per_device: Optional[int] = None,
    strict: bool = True,
    device: DeviceLike = None,
) -> MemoryPlan:
    """The per-device memory plan of one engine. `axis_sizes` gives the
    mesh geometry ({} = one device); `hbm_bytes_per_device` the budget
    (default: `device_hbm_bytes(ecfg, device)`). With `strict`, a plan
    that cannot hold one max-length sequence of KV raises MemoryPlanError
    with the breakdown and the smallest mesh that would fit."""
    sizes = dict(axis_sizes or {})
    if devices_per_host is None:
        n_dev = int(math.prod(sizes.values())) if sizes else 1
        devices_per_host = max(1, n_dev // max(1, n_processes))
    hbm = (hbm_bytes_per_device if hbm_bytes_per_device is not None
           else device_hbm_bytes(ecfg, device))
    headroom = int(hbm * max(0.0, ecfg.planner_headroom_fraction))

    quantize = ecfg.quantize_weights == "int8"
    lines = (PlanLine("weights", weight_bytes_per_device(
        lcfg, sizes, quantize=quantize), True,
        "int8 + f32 scales" if quantize else _dtype_name(lcfg.dtype)),
    ) + _scratch_lines(lcfg, ecfg, sizes)

    page = pool_page_bytes_per_device(lcfg, ecfg, sizes)
    fixed = sum(line.bytes_per_device for line in lines)
    budget = hbm - headroom - fixed
    fit_pages = max(0, budget // page)

    max_pages = ecfg.max_seq_len // ecfg.page_size
    slack = max_pages if ecfg.kv_dtype == "int8" else 0
    default_pages = ecfg.max_batch_size * max_pages + slack + 1
    # With a prefix cache every spare page serves reuse; otherwise the
    # worst case caps the pool: the same pool when it fits, a smaller one
    # when it does not.
    pool_pages = fit_pages if ecfg.prefix_cache else min(fit_pages,
                                                         default_pages)

    # The KV pager's host tier (host RAM): one record a page, the page's
    # per-device bytes times the host's devices.
    pager_budget = int(ecfg.kv_host_budget_mb) if ecfg.kv_pager else 0
    pager_rec = page * devices_per_host
    pager_slots = ((pager_budget << 20) // pager_rec
                   if pager_budget > 0 else 0)

    plan = MemoryPlan(
        lines=lines, hbm_bytes_per_device=hbm, headroom_bytes=headroom,
        page_bytes_per_device=page, fit_pages=int(fit_pages),
        pool_pages=int(pool_pages), default_pages=default_pages,
        axis_sizes=sizes, devices_per_host=devices_per_host,
        n_processes=max(1, n_processes),
        pager_host_budget_mb=pager_budget,
        pager_rec_bytes_per_host=int(pager_rec),
        pager_host_slots=int(pager_slots))
    if strict and fit_pages < max_pages + 1:
        smaller = smallest_fitting_mesh(lcfg, ecfg, hbm)
        hint = (f"smallest mesh that fits: ici_tensor="
                f"{smaller['tensor']} ({smaller['tensor']} device(s))"
                if smaller else
                "no tensor-parallel geometry fits this HBM budget; "
                "raise engine.hbm_gb_per_device or shrink the model")
        raise MemoryPlanError(
            f"memory plan does not fit: {fit_pages} pages available but "
            f"one max-length sequence needs {max_pages + 1} "
            f"(max_seq_len={ecfg.max_seq_len}, page_size={ecfg.page_size})."
            f"\n{plan.breakdown()}\n{hint}", plan)
    return plan


def plan_rank_memory(lcfg: LlamaConfig, ecfg: EngineConfig, mesh=None,
                     device: DeviceLike = None) -> MemoryPlan:
    """The plan of one engine: on one device, `plan_engine_memory`; as a
    rank of a tensor-parallel mesh, its shard of the weights and of every
    pool page against its own device's budget, with the pager's host
    tier per rank process (each parks only its kv-head slice). Ranks
    that share a device cannot each plan its whole memory
    (AUTO_POOL_SHARED)."""
    if mesh is None or mesh.size <= 1:
        return plan_engine_memory(lcfg, ecfg, device=device)
    if mesh.shared_device:
        raise ValueError(AUTO_POOL_SHARED.format(
            f"{mesh.size} tensor-parallel rank processes on "
            f"{sorted({str(d) for d in mesh.devices})}"))
    return plan_engine_memory(lcfg, ecfg, axis_sizes=dict(mesh.shape),
                              n_processes=mesh.size, devices_per_host=1,
                              device=device)


def smallest_fitting_mesh(lcfg: LlamaConfig, ecfg: EngineConfig,
                          hbm_bytes_per_device: int,
                          max_tensor: int = 1024) -> Optional[Dict[str, int]]:
    """The smallest tensor-parallel degree whose plan holds one
    max-length sequence, among the divisors of gcd(heads, kv heads, mlp,
    vocab) in increasing order; None when none does."""
    g = math.gcd(math.gcd(lcfg.n_heads, lcfg.n_kv_heads),
                 math.gcd(lcfg.mlp_dim, lcfg.vocab_size))
    max_pages = ecfg.max_seq_len // ecfg.page_size
    for t in range(1, min(g, max_tensor) + 1):
        if g % t:
            continue
        plan = plan_engine_memory(
            lcfg, ecfg, axis_sizes={"tensor": t},
            hbm_bytes_per_device=hbm_bytes_per_device, strict=False)
        if plan.fit_pages >= max_pages + 1:
            return {"tensor": t}
    return None
