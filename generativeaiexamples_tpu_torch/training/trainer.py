"""Next-token SFT / pretraining step for the Llama models, on one device
or sharded over rank processes.

Counterpart of generativeaiexamples_tpu/training/trainer.py. The loss runs the model on the
differentiable route (`llama.forward(..., attention="plain")`, JAX's
`use_pallas=False`): K1 has no backward and refuses operands that
require grad. Remat is `torch.utils.checkpoint` per layer where JAX
checkpoints the whole loss: the same gradients, other memory.

The optimizer is optax's `chain(clip_by_global_norm(grad_clip),
adamw(warmup_cosine_decay_schedule(0, lr, warmup, 100_000),
weight_decay))` written out (`AdamW`), so the numbers follow optax's,
not torch.optim's:

- the schedule is 0 at count 0, so the first step leaves the
  parameters unchanged; linear warmup to the peak, then a cosine tail
  over the remaining 100,000 - warmup steps;
- the clip scales by max_norm / g_norm only when g_norm >= max_norm,
  with no epsilon;
- Adam's eps 1e-8 sits outside the square root (eps_root 0), the moments
  keep the parameters' dtype, and the weight decay is decoupled:
  lr * (m_hat / (sqrt(v_hat) + eps) + wd * p);
- `grad_norm` is the global norm before the clip.

A step returns new parameter tensors; the ones it was given are left
as they were.

The sharded train state (JAX `shard_train_state`, `_opt_state_shardings`,
`batch_specs`). JAX places the tree on a mesh and GSPMD inserts the
collectives; here each rank process keeps only its shard of every leaf,
sliced by `llama.param_specs` (the hidden dimension on "fsdp",
Megatron's on "tensor"), its AdamW moments are shards of the same shape,
and the step calls the collectives itself (parallel/mesh.py):

- the global batch splits over ("data", "fsdp"), JAX's `batch` rule,
  and its sequence dimension over "sequence" (JAX's "seq" rule): a rank
  runs its contiguous shard at its global RoPE positions, and attention
  is ring attention over that axis (models/llama.py), so the sequence
  length must divide by the axis;
- every FSDP leaf is gathered whole in the forward, and its gradient is
  reduce-scattered (summed) back to the shard in the backward;
- the forward runs on the rank's Megatron shard (local heads and MLP
  columns, a vocabulary-parallel embedding and head) with autograd-aware
  collectives (models/llama.py's training route);
- the loss is the global masked mean: each rank's CE sum is summed over
  the batch and sequence axes, then divided once by the global mask
  count;
- a gradient is summed over every batch or sequence axis its leaf is
  not sharded on (no leaf is sharded on "sequence"); the clip's global
  norm sums each leaf's squared shard over the axes that leaf is
  sharded on, and only those.

The "expert" axis shards nothing, as in JAX, where no Llama leaf and no
batch dimension names it: the ranks along it hold the same state, take
the same step, and no collective runs over it.

One step serves both cases: with no mesh every collective is the
identity and it is the one-device step; sharded, it equals that step up
to summation order. A "pipeline" axis goes through parallel/pipeline.py.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.parallel import mesh as mesh_lib
from generativeaiexamples_tpu_torch.parallel.mesh import (
    LLM_RULES, MESH_AXIS_NAMES, Mesh, logical_to_spec)

Tree = Dict[str, Any]

# The differentiable route the training losses take (K1 has no
# backward); parallel/pipeline.py passes it on to the model's blocks.
ROUTE = "plain"
# The axes a gradient is summed over unless its leaf is sharded on them.
REDUCE_AXES = ("pipeline", "data", "fsdp", "sequence")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    warmup_steps: int = 100
    grad_clip: float = 1.0
    remat: bool = True  # recompute layer activations in the backward


# -- trees ------------------------------------------------------------------


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, depth first in insertion order."""
    out: List[torch.Tensor] = []
    for v in tree.values():
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_rebuild(tree: Tree, leaves: List[torch.Tensor]) -> Tree:
    """`tree` with its tensors replaced, in `tree_leaves` order."""
    it = iter(leaves)

    def go(node):
        return {k: go(v) if isinstance(v, dict) else next(it)
                for k, v in node.items()}

    return go(tree)


def global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm),
    accumulated in f32."""
    return torch.sqrt(sum(g.float().pow(2).sum() for g in leaves))


# -- optimizer ----------------------------------------------------------------


def warmup_cosine_decay(peak: float, warmup_steps: int,
                        decay_steps: int = 100_000) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0.0, peak, warmup_steps,
    decay_steps): linear from 0 over the warmup, then cosine decay to 0
    over decay_steps - warmup_steps."""
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            c = min(max(count, 0), warmup_steps)
            return -peak * (1.0 - c / warmup_steps) + peak
        t = min(count - warmup_steps, cos_steps)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / cos_steps))

    return schedule


class AdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(learning_rate,
    b1, b2, eps, weight_decay=weight_decay)) over a tree of tensors.
    `learning_rate` is a float or a schedule of the step count;
    grad_clip None leaves the gradients unclipped."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]],
                 *, weight_decay: float = 1e-4,
                 grad_clip: Optional[float] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr = (learning_rate if callable(learning_rate)
                   else (lambda count, v=float(learning_rate): v))
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Tree) -> Dict[str, Any]:
        """count 0 and zero moments in each parameter's dtype."""
        zeros = [torch.zeros_like(p) for p in tree_leaves(params)]
        return {"count": 0, "mu": zeros,
                "nu": [torch.zeros_like(z) for z in zeros]}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict[str, Any],
               params: Tree, g_norm: Optional[torch.Tensor] = None
               ) -> Tuple[Tree, Dict[str, Any]]:
        """(new params, new state) from gradients in `tree_leaves`
        order. `g_norm` is the gradients' global norm when they are a
        rank's shards (default: computed from `grads`)."""
        if self.grad_clip is not None:
            g_norm = global_norm(grads) if g_norm is None else g_norm
            if not bool(g_norm < self.grad_clip):
                grads = [g / g_norm.to(g.dtype) * self.grad_clip
                         for g in grads]
        count = state["count"] + 1
        lr = self.lr(state["count"])
        c1, c2 = 1.0 - self.b1 ** count, 1.0 - self.b2 ** count
        leaves = tree_leaves(params)
        mu, nu, new = [], [], []
        for p, g, m, v in zip(leaves, grads, state["mu"], state["nu"]):
            m = (1 - self.b1) * g + self.b1 * m
            v = (1 - self.b2) * (g * g) + self.b2 * v
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            u = (u + self.weight_decay * p) * -lr
            mu.append(m)
            nu.append(v)
            new.append((p + u).to(p.dtype))
        return tree_rebuild(params, new), {"count": count, "mu": mu,
                                           "nu": nu}


def make_optimizer(tcfg: TrainConfig) -> AdamW:
    return AdamW(warmup_cosine_decay(tcfg.learning_rate, tcfg.warmup_steps),
                 weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip)


def value_and_grad(fn: Callable[[Tree], Any], params: Tree, has_aux=False):
    """(value, grads in `tree_leaves` order) of `fn(params)`, through
    detached leaves that require grad (the caller's tensors keep their
    flags)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        out = fn(tree_rebuild(params, leaves))
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, leaves)
    if has_aux:
        return (loss.detach(), out[1]), list(grads)
    return loss.detach(), list(grads)


# -- loss and step ------------------------------------------------------------


def masked_ce_sum(logits: torch.Tensor, targets, mask) -> torch.Tensor:
    """The SUM of the masked next-token cross-entropy (f32)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets.long()[..., None])[..., 0]
    return -(ll * mask).sum()


def loss_fn(params: Tree, cfg: llama.LlamaConfig, tokens, targets, mask,
            remat: bool = False, mesh: Optional[Mesh] = None
            ) -> torch.Tensor:
    """Mean next-token cross-entropy over mask == 1 positions, through the
    differentiable route. With a `mesh`, `params` are this rank's shards
    (`shard_train_state`) and the batch is the GLOBAL one, which every
    rank passes whole: its rows, FSDP gathers, the Megatron forward, the
    CE sum over the batch axes, divided once by the global mask count.
    Call (and differentiate) under `mesh_lib.active(mesh)`. Without one,
    the whole tree on the batch's device (a one-device mesh)."""
    if mesh is None:
        mesh = mesh_lib.single_device_mesh(tokens.device)
    local = shard_batch({"tokens": tokens, "targets": targets,
                         "mask": mask}, mesh)
    full = gather_fsdp(params, llama.param_specs(cfg), mesh)
    logits, _ = llama.forward(full, local_train_config(cfg, mesh),
                              local["tokens"],
                              positions=sequence_positions(
                                  mesh, local["tokens"].shape[1],
                                  local["tokens"].device),
                              attention="plain", remat=remat)
    total = mesh_lib.all_reduce_sum(
        masked_ce_sum(logits, local["targets"], local["mask"]), mesh,
        REDUCE_AXES)
    return total / torch.clamp(mask.sum().to(total.device), min=1.0)


def make_train_step(cfg: llama.LlamaConfig, tcfg: TrainConfig,
                    optimizer: AdamW, mesh: Optional[Mesh] = None
                    ) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).
    Batch: {tokens, targets, mask} each [B, S]. With a `mesh`, `params`
    and `opt_state` are this rank's shards (`shard_train_state`) and the
    batch is the global one, which every rank passes whole; without one,
    the whole tree on one device."""
    if mesh is not None:
        check_train_mesh(mesh)
    specs = llama.param_specs(cfg)

    def step(params, opt_state, batch):
        params, opt_state, loss, gnorm = sharded_update(
            lambda p: loss_fn(p, cfg, batch["tokens"], batch["targets"],
                              batch["mask"], remat=tcfg.remat, mesh=mesh),
            params, aligned_specs(specs, params), opt_state, optimizer,
            mesh)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


# -- the sharded train state ---------------------------------------------------


def check_train_mesh(mesh: Mesh) -> None:
    """Refuse a "pipeline" axis, which parallel/pipeline.py's step
    takes, naming it."""
    n = mesh_lib.mesh_axis_size(mesh, "pipeline")
    if n > 1:
        raise ValueError(
            f"the sharded train step does not shard the 'pipeline' mesh "
            f"axis (size {n}); a pipeline axis goes through "
            f"parallel/pipeline.py make_pp_train_step")


def batch_specs(rules: dict = LLM_RULES) -> Dict[str, tuple]:
    """The batch's layout: rows over ("data", "fsdp"), the sequence over
    "sequence" (JAX's `batch_specs`)."""
    s = logical_to_spec(("batch", "seq"), rules)
    return {"tokens": s, "targets": s, "mask": s}


def spec_axes(spec) -> List[str]:
    """The mesh axes a leaf's spec shards it on, in mesh order."""
    named = set()
    for entry in spec:
        if entry is not None:
            named.update((entry,) if isinstance(entry, str) else entry)
    return [a for a in MESH_AXIS_NAMES if a in named]


def aligned_specs(specs: Tree, params: Tree) -> List[tuple]:
    """The spec of every leaf of `params`, in `tree_leaves` order (the
    two trees may hold their keys in different orders)."""
    def go(p, s):
        out = []
        for k, v in p.items():
            out.extend(go(v, s[k]) if isinstance(v, dict) else [s[k]])
        return out

    return go(params, specs)


def shard_tree(params: Tree, specs: Tree, mesh: Mesh) -> Tree:
    """This rank's shard of every leaf, each a contiguous tensor of its
    own on the rank's device."""
    from generativeaiexamples_tpu_torch.serving.sharding import shard_leaf

    return tree_rebuild(params, [
        shard_leaf(leaf, spec, mesh)
        for leaf, spec in zip(tree_leaves(params),
                              aligned_specs(specs, params))])


def shard_batch(batch: Tree, mesh: Mesh) -> Tree:
    """This rank's rows of a global batch, and its shard of their
    sequence."""
    from generativeaiexamples_tpu_torch.serving.sharding import shard_leaf

    n = mesh_lib.mesh_axis_size(mesh, "sequence")
    seq = batch["tokens"].shape[1]
    if seq % n:
        raise ValueError(f"sequence length {seq} does not split over the "
                         f"{n}-way 'sequence' mesh axis")
    specs = batch_specs()
    return {k: shard_leaf(v, specs[k], mesh) for k, v in batch.items()}


def sequence_positions(mesh: Mesh, s_local: int,
                       device) -> torch.Tensor:
    """[1, s_local] global positions of this rank's sequence shard:
    its coordinate on "sequence" times the shard's length, onward."""
    n = mesh_lib.mesh_axis_size(mesh, "sequence")
    base = mesh.coords["sequence"] * s_local if n > 1 else 0
    return base + torch.arange(s_local, device=device)[None, :]


def local_train_config(cfg: llama.LlamaConfig,
                       mesh: Optional[Mesh]) -> llama.LlamaConfig:
    """The rank's Megatron view: heads, kv heads and MLP columns divided
    by the tensor axis (the vocabulary is gathered before the loss)."""
    tp = mesh_lib.mesh_axis_size(mesh, "tensor")
    if tp == 1:
        return cfg
    bad = {name: dim for name, dim in (
        ("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
        ("mlp_dim", cfg.mlp_dim), ("vocab_size", cfg.vocab_size))
        if dim % tp}
    if bad:
        raise ValueError(f"tensor axis {tp} does not divide model dims "
                         f"{bad}")
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp,
                               mlp_dim=cfg.mlp_dim // tp)


def shard_train_state(params: Tree, cfg: llama.LlamaConfig,
                      optimizer: AdamW, mesh: Mesh):
    """(this rank's parameter shards, fresh optimizer state over them,
    the spec tree): the moments shard exactly like their parameters."""
    check_train_mesh(mesh)
    local_train_config(cfg, mesh)
    specs = llama.param_specs(cfg)
    local = shard_tree(params, specs, mesh)
    return local, optimizer.init(local), specs


def _opt_state_shardings(optimizer: AdamW, params: Tree,
                         specs: Tree) -> Dict[str, Any]:
    """The spec of every optimizer-state leaf: a moment takes its
    parameter's, the step count is replicated."""
    leaf_specs = aligned_specs(specs, params)
    return {"count": (), "mu": list(leaf_specs), "nu": list(leaf_specs)}


def gather_fsdp(params: Tree, specs: Tree, mesh: Mesh) -> Tree:
    """Every leaf gathered whole along its "fsdp" dimension; the
    gathers' backward reduce-scatters each gradient to its shard."""
    out = []
    for leaf, spec in zip(tree_leaves(params), aligned_specs(specs, params)):
        for dim, entry in enumerate(spec):
            if entry == "fsdp":
                leaf = mesh_lib.fsdp_gather(leaf, mesh, dim)
            elif entry is not None and not isinstance(entry, str) \
                    and "fsdp" in entry:
                raise ValueError(f"spec {spec}: fsdp inside a compound "
                                 f"axis is not gathered")
        out.append(leaf)
    return tree_rebuild(params, out)


def _coalesced_all_reduce(tensors: List[torch.Tensor], mesh: Mesh,
                          axis: str) -> List[torch.Tensor]:
    """Sum each tensor over `axis` with one collective per dtype."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[Any, List[int]] = OrderedDict()
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = mesh_lib.all_reduce_raw(
            torch.cat([tensors[i].reshape(-1) for i in idx]), mesh, axis)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out


def sync_grads(grads: List[torch.Tensor], leaf_specs: List[tuple],
               mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """Sum each rank's gradient shards over every `REDUCE_AXES` axis its
    leaf is not sharded on (the batch and sequence axes; "pipeline" for
    the leaves every stage holds). FSDP leaves took their fsdp sum in the
    reduce-scatter; tensor-replicated leaves already agree."""
    grads = list(grads)
    for axis in REDUCE_AXES:
        if mesh_lib.mesh_axis_size(mesh, axis) == 1:
            continue
        idx = [i for i, s in enumerate(leaf_specs)
               if axis not in spec_axes(s)]
        for i, g in zip(idx, _coalesced_all_reduce(
                [grads[i] for i in idx], mesh, axis)):
            grads[i] = g
    return grads


def sharded_global_norm(grads: List[torch.Tensor], leaf_specs: List[tuple],
                        mesh: Optional[Mesh]) -> torch.Tensor:
    """The global norm of gradients held as shards: each leaf's sum of
    squares is summed over the axes its leaf is sharded on, and only
    those, so a replicated leaf counts once."""
    by_axes: Dict[tuple, torch.Tensor] = OrderedDict()
    for g, spec in zip(grads, leaf_specs):
        axes = tuple(a for a in spec_axes(spec)
                     if mesh_lib.mesh_axis_size(mesh, a) > 1)
        sq = g.float().pow(2).sum()
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    total = None
    for axes, sq in by_axes.items():
        for a in axes:
            sq = mesh_lib.all_reduce_raw(sq, mesh, a)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def sharded_update(loss_of: Callable[[Tree], torch.Tensor], params: Tree,
                   leaf_specs: List[tuple], opt_state, optimizer: AdamW,
                   mesh: Optional[Mesh]):
    """One step over shards (the whole tree when `mesh` is None): value
    and gradients under the active mesh, the gradients summed, the global
    norm, the optimizer update."""
    with mesh_lib.active(mesh):
        loss, grads = value_and_grad(loss_of, params)
    grads = sync_grads(grads, leaf_specs, mesh)
    gnorm = sharded_global_norm(grads, leaf_specs, mesh)
    params, opt_state = optimizer.update(grads, opt_state, params,
                                         g_norm=gnorm)
    return params, opt_state, loss, gnorm


def synthetic_batch(cfg: llama.LlamaConfig, batch: int, seq: int,
                    seed: int = 0, device: DeviceLike = None) -> Tree:
    """Random LM batch (targets = tokens shifted), the JAX package's draw:
    numpy's default_rng(seed)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1), dtype=np.int32)
    return {
        "tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
        "targets": torch.from_numpy(toks[:, 1:].copy()).to(dev),
        "mask": torch.ones((batch, seq), dtype=torch.float32, device=dev),
    }
