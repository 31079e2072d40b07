"""Rank processes for the port's sharded-training parity tests.

`RankPool(world, mesh_kw)` spawns `world` CPU rank processes (gloo over a
TCPStore on 127.0.0.1) that build the port's mesh of `MeshConfig(**mesh_kw)`
once, then run jobs: `pool.run(fn, *args)` sends a module-level function
of this module to every rank, which calls `fn(mesh, *args)` and returns
its result (numpy); `run` returns the results in rank order, within its
own deadline. The ranks import the port and torch only, never JAX.

The jobs below hold the rank-side bodies of tests/test_torch_ring_attention.py,
test_torch_pipeline.py and test_torch_sharded_training.py.
"""

from __future__ import annotations

import socket
import time
import traceback

import numpy as np

LIMIT_S = 120


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_main(rank, world, coordinator, mesh_kw, cmds, results) -> None:
    import torch

    torch.set_num_threads(1)
    from generativeaiexamples_tpu_torch.config.schema import MeshConfig
    from generativeaiexamples_tpu_torch.parallel import mesh as tm

    devices = ["cpu"] * world
    tm.init_ranks(coordinator, world, rank, devices)
    mesh = tm.build_mesh(MeshConfig(**mesh_kw), devices)
    while True:
        cmd = cmds.get()
        if cmd is None:
            break
        fn, args = cmd
        try:
            results.put((rank, "ok", fn(mesh, *args)))
        except BaseException:
            results.put((rank, "error", traceback.format_exc()))
    tm.shutdown()


class RankPool:
    def __init__(self, world: int, mesh_kw: dict):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        coordinator = f"127.0.0.1:{_free_port()}"
        self.cmds = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_main, args=(
            r, world, coordinator, mesh_kw, self.cmds[r], self.results))
            for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, limit_s: float = LIMIT_S):
        for q in self.cmds:
            q.put((fn, args))
        got = {}
        deadline = time.monotonic() + limit_s
        while len(got) < len(self.procs):
            assert all(p.is_alive() for p in self.procs), \
                "a rank process died"
            try:
                rank, status, out = self.results.get(timeout=max(
                    0.1, min(5.0, deadline - time.monotonic())))
            except Exception:
                assert time.monotonic() < deadline, "ranks timed out"
                continue
            assert status == "ok", out
            got[rank] = out
        return [got[r] for r in range(len(self.procs))]

    def close(self) -> None:
        for q in self.cmds:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()


def assemble(shards, shape):
    """A whole array from every rank's (slices, array) of it."""
    out = np.zeros(shape, np.float32)
    for slices, arr in shards:
        out[tuple(slice(a, b) for a, b in slices)] = arr
    return out


def _slices_of(shape, spec, mesh):
    from generativeaiexamples_tpu_torch.serving.sharding import shard_slices

    return [(s.start, s.stop) for s in shard_slices(shape, spec, mesh)]


def _shards(tree_leaves_, full_shapes, specs, mesh):
    return [(_slices_of(shape, spec, mesh), t.detach().float().numpy())
            for t, shape, spec in zip(tree_leaves_, full_shapes, specs)]


# -- ring attention ---------------------------------------------------------


def job_ring(mesh, q, k, v, causal, grads):
    """ring_attention_sharded on the global numpy q, k, v; with `grads`,
    also the gradients of out.sum() with respect to them."""
    import torch

    from generativeaiexamples_tpu_torch.ops.ring_attention import (
        ring_attention_sharded)

    ts = [torch.from_numpy(a).requires_grad_(grads) for a in (q, k, v)]
    with torch.enable_grad():
        out = ring_attention_sharded(*ts, mesh, causal=causal)
        res = {"out": out.detach().numpy()}
        if grads:
            gs = torch.autograd.grad(out.sum(), ts)
            res["grads"] = [g.numpy() for g in gs]
    return res


# -- sharded training -------------------------------------------------------


def _port_setup(np_params, cfg_kw):
    import torch

    from generativeaiexamples_tpu_torch.models import convert
    from generativeaiexamples_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig.tiny(**cfg_kw)
    return cfg, convert.llama_params_from_numpy(np_params, "cpu",
                                                torch.float32)


def _batch(np_batch):
    import torch

    return {k: torch.from_numpy(v) for k, v in np_batch.items()}


def _state_bytes(params, opt_state):
    from generativeaiexamples_tpu_torch.training import trainer

    p = sum(t.numel() * t.element_size() for t in trainer.tree_leaves(params))
    m = sum(t.numel() * t.element_size()
            for t in opt_state["mu"] + opt_state["nu"])
    return p, m


def job_train(mesh, np_params, cfg_kw, np_batch, lr, n_steps):
    """`n_steps` sharded train steps (remat): per step the loss and
    grad_norm, then every leaf's shard, and the rank's parameter and
    moment bytes."""
    from generativeaiexamples_tpu_torch.models import llama as tl
    from generativeaiexamples_tpu_torch.training import trainer

    cfg, params = _port_setup(np_params, cfg_kw)
    tcfg = trainer.TrainConfig(learning_rate=lr, warmup_steps=1, remat=True)
    opt = trainer.make_optimizer(tcfg)
    local, state, specs = trainer.shard_train_state(params, cfg, opt, mesh)
    bytes_ = _state_bytes(local, state)
    step = trainer.make_train_step(cfg, tcfg, opt, mesh=mesh)
    batch = _batch(np_batch)
    metrics = []
    for _ in range(n_steps):
        local, state, m = step(local, state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": metrics, "bytes": bytes_,
            "shards": _shards(trainer.tree_leaves(local),
                              [tuple(t.shape) for t in
                               trainer.tree_leaves(params)],
                              trainer.aligned_specs(specs, local), mesh),
            "spec_tree": tl.param_specs(cfg)}


def job_lora(mesh, np_params, np_lora, cfg_kw, lora_kw, np_batch, lr,
             n_steps):
    """`n_steps` sharded LoRA steps: per step the loss and grad norm,
    then every adapter leaf's shard."""
    from generativeaiexamples_tpu_torch.models import convert
    from generativeaiexamples_tpu_torch.training import lora as tlora
    from generativeaiexamples_tpu_torch.training import trainer

    cfg, params = _port_setup(np_params, cfg_kw)
    lcfg = tlora.LoraConfig(**lora_kw)
    adapters = convert.lora_params_from_numpy(np_lora, "cpu")
    opt = trainer.AdamW(lr, weight_decay=0.0)
    base, _, _ = trainer.shard_train_state(params, cfg, opt, mesh)
    local, state, specs = tlora.shard_lora_state(adapters, opt, mesh)
    step = tlora.make_lora_train_step(cfg, lcfg, opt, remat=True, mesh=mesh)
    batch = _batch(np_batch)
    metrics = []
    for _ in range(n_steps):
        local, state, m = step(local, state, base, batch)
        metrics.append((float(m["loss"]), float(m["lora_grad_norm"])))
    return {"metrics": metrics, "shards": _shards(
        trainer.tree_leaves(local),
        [tuple(t.shape) for t in trainer.tree_leaves(adapters)],
        trainer.aligned_specs(specs, local), mesh)}


_MESHES: dict = {}


def job_on_mesh(mesh, mesh_kw, fn, *args):
    """`fn(m, *args)` on the mesh of `MeshConfig(**mesh_kw)` over the
    same ranks, built the first time a geometry is asked for (every rank
    runs the same jobs in the same order, so the axis groups are made in
    the same order everywhere)."""
    from generativeaiexamples_tpu_torch.config.schema import MeshConfig
    from generativeaiexamples_tpu_torch.parallel import mesh as tm

    key = tuple(sorted(mesh_kw.items()))
    if key not in _MESHES:
        _MESHES[key] = tm.build_mesh(MeshConfig(**mesh_kw), mesh.devices)
    return fn(_MESHES[key], *args)


def job_positions(mesh, np_params, cfg_kw, np_batch):
    """This rank's coordinates, the RoPE positions and batch shard its
    loss runs on, and its parameter and moment bytes."""
    from generativeaiexamples_tpu_torch.training import trainer

    cfg, params = _port_setup(np_params, cfg_kw)
    opt = trainer.make_optimizer(trainer.TrainConfig())
    local, state, _ = trainer.shard_train_state(params, cfg, opt, mesh)
    shard = trainer.shard_batch(_batch(np_batch), mesh)
    s_local = shard["tokens"].shape[1]
    return {"coords": mesh.coords,
            "positions": trainer.sequence_positions(
                mesh, s_local, "cpu").numpy(),
            "tokens": shard["tokens"].numpy(),
            "bytes": _state_bytes(local, state)}


# -- pipeline ---------------------------------------------------------------


def job_pp_grads(mesh, np_params, cfg_kw, np_batch, n_micro):
    """pipeline_loss and its gradients (summed as the step sums them) as
    every leaf's shard."""
    from generativeaiexamples_tpu_torch.parallel import mesh as tm
    from generativeaiexamples_tpu_torch.parallel import pipeline as pp
    from generativeaiexamples_tpu_torch.training import trainer

    cfg, params = _port_setup(np_params, cfg_kw)
    opt = trainer.make_optimizer(trainer.TrainConfig())
    local, _, specs = pp.shard_pp_train_state(params, cfg, opt, mesh)
    batch = _batch(np_batch)
    leaf_specs = trainer.aligned_specs(specs, local)
    with tm.active(mesh):
        loss, grads = trainer.value_and_grad(
            lambda p: pp.pipeline_loss(p, cfg, batch["tokens"],
                                       batch["targets"], batch["mask"],
                                       mesh=mesh, n_micro=n_micro), local)
    grads = trainer.sync_grads(grads, leaf_specs, mesh)
    return {"loss": float(loss), "shards": _shards(
        grads, [tuple(t.shape) for t in trainer.tree_leaves(params)],
        leaf_specs, mesh)}


def job_pp_steps(mesh, np_params, cfg_kw, np_batch, n_micro, lr, n_steps):
    """`n_steps` of make_pp_train_step: the metrics and every parameter
    leaf's shard."""
    from generativeaiexamples_tpu_torch.parallel import pipeline as pp
    from generativeaiexamples_tpu_torch.training import trainer

    cfg, params = _port_setup(np_params, cfg_kw)
    tcfg = trainer.TrainConfig(learning_rate=lr, warmup_steps=1,
                               remat=False)
    opt = trainer.make_optimizer(tcfg)
    local, state, specs = pp.shard_pp_train_state(params, cfg, opt, mesh)
    step = pp.make_pp_train_step(cfg, tcfg, opt, mesh=mesh, n_micro=n_micro)
    batch = _batch(np_batch)
    metrics = []
    for _ in range(n_steps):
        local, state, m = step(local, state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": metrics, "shards": _shards(
        trainer.tree_leaves(local),
        [tuple(t.shape) for t in trainer.tree_leaves(params)],
        trainer.aligned_specs(specs, local), mesh)}
