"""Pipeline parallelism: GPipe-style microbatched training over the
"pipeline" mesh axis, on rank processes.

Counterpart of generativeaiexamples_tpu/parallel/pipeline.py:

- The stacked-layer leaves ([L, ...]) shard on "pipeline": stage s holds
  layers [s*L/S, (s+1)*L/S). The embedding, the final norm and the head
  are held by every stage (`pp_param_specs`); the other axes follow
  `llama.param_specs`, so the pipeline composes with "data", "fsdp" and
  "tensor" on one mesh (the batch splits over ("data", "fsdp"), each
  stage runs its Megatron shard), and with "sequence" (each stage runs
  its sequence shard at its global positions, attention as a ring over
  that axis, as trainer.loss_fn does).
- `pipeline_loss` runs the classic GPipe fill-drain: n_micro
  microbatches flow through S stages in n_micro + S - 1 ticks. Stage 0
  injects the embeddings; every stage runs its local layers through
  `llama.run_blocks`; the last stage computes the head and the SUM of the
  masked CE as each microbatch drains; the activations hop to the next
  stage by `ppermute`. The stages' sums are summed, and divided once by
  the global mask count.
- As in JAX every stage runs the same program each tick (stage 0's
  received activations and the other stages' heads are masked out by
  `torch.where`), so every rank builds the same autograd graph and the
  backward issues its collectives in the same order on every rank. The
  backward comes from autograd: `ppermute`'s backward sends each
  activation's gradient to the previous stage, and the leaves every
  stage holds get the sum of the stages' gradients (the transpose of
  JAX's replicated in_specs).

One stage falls through to `trainer.loss_fn`, as JAX's does.
"""

from __future__ import annotations

from typing import Dict

import torch

from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.parallel import mesh as mesh_lib
from generativeaiexamples_tpu_torch.parallel.mesh import Mesh
from generativeaiexamples_tpu_torch.training import trainer


def pp_param_specs(cfg: llama.LlamaConfig) -> Dict:
    """`llama.param_specs` with the stacked-layer leading axis on
    "pipeline" (stage-local layer shards); everything else unchanged."""
    specs = llama.param_specs(cfg)
    out = dict(specs)
    out["layers"] = {k: ("pipeline",) + tuple(s)[1:]
                     for k, s in specs["layers"].items()}
    return out


def _head_ce(params, cfg: llama.LlamaConfig, x, targets, mask):
    """Final norm, vocabulary head and the SUM of the masked token CE
    (normalized once, outside the microbatch loop)."""
    logits = llama.logits_from_hidden(cfg, params, x, trainer.ROUTE)
    return trainer.masked_ce_sum(logits, targets, mask)


def pipeline_loss(params, cfg: llama.LlamaConfig, tokens, targets, mask, *,
                  mesh: Mesh, n_micro: int, remat: bool = False):
    """Masked-mean next-token CE through the GPipe schedule, from this
    rank's shards (`shard_pp_train_state`) and the GLOBAL batch, which
    every rank passes whole. Equals `trainer.loss_fn` up to summation
    order. Differentiate under `mesh_lib.active(mesh)`."""
    n_stages = mesh_lib.mesh_axis_size(mesh, "pipeline")
    if n_stages == 1:
        return trainer.loss_fn(params, cfg, tokens, targets, mask)
    B = tokens.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro {n_micro}")
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by "
                         f"pipeline stages {n_stages}")
    rows = mesh_lib.mesh_axis_size(mesh, "data") * mesh_lib.mesh_axis_size(mesh, "fsdp")
    if (B // rows) % n_micro:
        raise ValueError(
            f"batch {B} over the {rows}-way data x fsdp axes leaves "
            f"{B // rows} rows a rank, not divisible by n_micro {n_micro}")
    specs = pp_param_specs(cfg)
    local = trainer.shard_batch({"tokens": tokens, "targets": targets,
                                 "mask": mask}, mesh)
    p = trainer.gather_fsdp(params, specs, mesh)
    lcfg = trainer.local_train_config(cfg, mesh)
    mb = B // rows // n_micro
    dev = local["tokens"].device
    S = local["tokens"].shape[1]  # this rank's sequence shard
    stage = mesh.coords["pipeline"]
    last = n_stages - 1
    is_first = torch.tensor(stage == 0, device=dev)
    is_last = torch.tensor(stage == last, device=dev)
    positions = trainer.sequence_positions(mesh, S, dev)
    cos, sin = llama.rope_cos_sin(positions, lcfg.head_dim, lcfg.rope_theta,
                                  lcfg.rope_scaling)
    lengths = torch.full((mb,), S, dtype=torch.int32, device=dev)
    mb_tok = local["tokens"].reshape(n_micro, mb, S)
    mb_tgt = local["targets"].reshape(n_micro, mb, S)
    mb_mask = local["mask"].reshape(n_micro, mb, S)

    state = torch.zeros((mb, S, lcfg.dim), dtype=lcfg.dtype, device=dev)
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ticks = n_micro + n_stages - 1
    for t in range(ticks):
        inject = llama.embed(p, mb_tok[min(t, n_micro - 1)], lcfg.dtype,
                             trainer.ROUTE)
        x_in = torch.where(is_first, inject, state)
        y = llama.run_blocks(p["layers"], lcfg, x_in, cos, sin, lengths,
                             trainer.ROUTE, remat)
        o = t - last
        if o >= 0:
            ce = _head_ce(p, lcfg, y, mb_tgt[o], mb_mask[o])
            loss_sum = loss_sum + torch.where(is_last, ce, zero)
        if t < ticks - 1:  # the last tick's activations go nowhere
            state = mesh_lib.ppermute(y, mesh, "pipeline", 1)
    total = mesh_lib.all_reduce_sum(loss_sum, mesh, trainer.REDUCE_AXES)
    return total / torch.clamp(mask.sum().to(dev), min=1.0)


def make_pp_train_step(cfg: llama.LlamaConfig, tcfg: trainer.TrainConfig,
                       optimizer: trainer.AdamW, *, mesh: Mesh,
                       n_micro: int):
    """The pipelined twin of `trainer.make_train_step`: (params,
    opt_state, batch) -> (params, opt_state, metrics), over this rank's
    shards and the global batch."""
    specs = pp_param_specs(cfg)

    def step(params, opt_state, batch):
        params, opt_state, loss, gnorm = trainer.sharded_update(
            lambda p: pipeline_loss(p, cfg, batch["tokens"],
                                    batch["targets"], batch["mask"],
                                    mesh=mesh, n_micro=n_micro,
                                    remat=tcfg.remat),
            params, trainer.aligned_specs(specs, params), opt_state,
            optimizer, mesh)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def shard_pp_train_state(params, cfg: llama.LlamaConfig,
                         optimizer: trainer.AdamW, mesh: Mesh):
    """(this rank's shards with the pipeline-stage layout, fresh
    optimizer state over them, the spec tree)."""
    n_stages = mesh_lib.mesh_axis_size(mesh, "pipeline")
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by "
                         f"pipeline stages {n_stages}")
    trainer.local_train_config(cfg, mesh)
    specs = pp_param_specs(cfg)
    local = trainer.shard_tree(params, specs, mesh)
    return local, optimizer.init(local), specs
