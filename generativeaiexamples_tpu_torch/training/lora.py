"""LoRA fine-tuning for the Llama models, on one device or sharded over
rank processes.

Counterpart of generativeaiexamples_tpu/training/lora.py: low-rank
adapters on selected projections of the stacked layer weights; the
gradient flows only into the adapters (the frozen base takes no
gradient and no optimizer state), and `merge` folds trained adapters
into the base weights so the serving engine (K1 and K2 on the card)
needs no LoRA code path.

Sharded (`lora_param_specs`): a [L, in, r] shards like its weight's input
axis, b [L, r, out] like its output axis, the rank axis is replicated,
so a rank merges its adapter shards into its base shard with no
collective. Where one factor is sharded on "tensor" and the other is
not, the other enters Megatron's tensor region (its gradient is a
partial over the sharded axis, summed in the backward); the rest is the
sharded train state's machinery (training/trainer.py).

`init_lora` draws with a torch generator, so its adapters differ from
the JAX package's `jax.random` ones; `models/convert.py` carries
adapters across as numpy in both directions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.parallel import mesh as mesh_lib
from generativeaiexamples_tpu_torch.parallel.mesh import (
    LLM_RULES, Mesh, logical_to_spec)
from generativeaiexamples_tpu_torch.training import trainer


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    # Attention q/v is the classic target set; any of the seven
    # projection names of the llama layer stack are accepted.
    targets: Tuple[str, ...] = ("wq", "wv")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def init_lora(lcfg: llama.LlamaConfig, lora_cfg: LoraConfig,
              generator: Optional[torch.Generator] = None,
              device: DeviceLike = None) -> Dict:
    """f32 adapters for the stacked layer weights: a ~ N(0, 1/in), b = 0,
    so the adapted model equals the base model at step 0. Drawn from
    `generator` (default: seed 0 on the device)."""
    dev = resolve_device(device)
    g = generator if generator is not None \
        else torch.Generator(device=dev).manual_seed(0)
    dims = {
        "wq": (lcfg.dim, lcfg.n_heads * lcfg.head_dim),
        "wk": (lcfg.dim, lcfg.n_kv_heads * lcfg.head_dim),
        "wv": (lcfg.dim, lcfg.n_kv_heads * lcfg.head_dim),
        "wo": (lcfg.n_heads * lcfg.head_dim, lcfg.dim),
        "w_gate": (lcfg.dim, lcfg.mlp_dim),
        "w_up": (lcfg.dim, lcfg.mlp_dim),
        "w_down": (lcfg.mlp_dim, lcfg.dim),
    }
    unknown = set(lora_cfg.targets) - set(dims)
    if unknown:
        raise ValueError(f"unknown LoRA targets {sorted(unknown)}")
    out: Dict = {}
    L, r = lcfg.n_layers, lora_cfg.rank
    for name in lora_cfg.targets:
        d_in, d_out = dims[name]
        out[name] = {
            "a": torch.randn((L, d_in, r), generator=g, device=dev)
            * d_in ** -0.5,
            "b": torch.zeros((L, r, d_out), dtype=torch.float32, device=dev),
        }
    return out


def lora_param_specs(lora_params: Dict, rules=None) -> Dict:
    """Specs parallel to `init_lora`'s tree: the rank axis replicated,
    the in and out axes following the base weight's (JAX's table)."""
    rules = rules or LLM_RULES
    out_axis = {"wq": "heads", "wk": "kv_heads", "wv": "kv_heads",
                "wo": "embed_fsdp", "w_gate": "mlp", "w_up": "mlp",
                "w_down": "embed_fsdp"}
    in_axis = {"wq": "embed_fsdp", "wk": "embed_fsdp", "wv": "embed_fsdp",
               "wo": "heads", "w_gate": "embed_fsdp", "w_up": "embed_fsdp",
               "w_down": "mlp"}
    return {name: {
        "a": logical_to_spec(("layers", in_axis[name], None), rules),
        "b": logical_to_spec(("layers", None, out_axis[name]), rules),
    } for name in lora_params}


def shard_lora_state(lora_params: Dict, optimizer: trainer.AdamW,
                     mesh: Mesh):
    """(this rank's adapter shards, optimizer state over them, specs)."""
    trainer.check_train_mesh(mesh)
    specs = lora_param_specs(lora_params)
    local = trainer.shard_tree(lora_params, specs, mesh)
    return local, optimizer.init(local), specs


def _tensor_region(lora_params: Dict, mesh: Optional[Mesh]) -> Dict:
    """Each factor replicated over "tensor" whose partner is sharded on
    it enters the tensor region (identity; its gradient summed over the
    axis). With no tensor axis, the adapters as they are."""
    specs = lora_param_specs(lora_params)
    out = {}
    for name, ab in lora_params.items():
        a_t = "tensor" in trainer.spec_axes(specs[name]["a"])
        b_t = "tensor" in trainer.spec_axes(specs[name]["b"])
        a, b = ab["a"], ab["b"]
        if b_t and not a_t:
            a = mesh_lib.copy_to_tensor_region(a, mesh)
        if a_t and not b_t:
            b = mesh_lib.copy_to_tensor_region(b, mesh)
        out[name] = {"a": a, "b": b}
    return out


def merge(params: Dict, lora_params: Dict, lora_cfg: LoraConfig) -> Dict:
    """Fold adapters into base weights: w + scale * (a @ b) over the
    layer axis, rounded as JAX rounds it ((w + delta.astype(w.dtype))
    .astype(w.dtype)). Returns a new tree; the given one is unchanged."""
    out = dict(params)
    layers = dict(params["layers"])
    for name, ab in lora_params.items():
        w = layers[name]
        delta = torch.einsum("lir,lro->lio", ab["a"], ab["b"]) \
            * lora_cfg.scale
        layers[name] = (w + delta.to(w.dtype)).to(w.dtype)
    out["layers"] = layers
    return out


def loss_with_lora(lora_params: Dict, base_params: Dict,
                   lcfg: llama.LlamaConfig, lora_cfg: LoraConfig,
                   tokens, targets, mask, remat: bool = False,
                   mesh: Optional[Mesh] = None):
    """SFT loss of the merged model; the base enters detached, so only
    the adapters take gradients. With a `mesh`, the adapters and the base
    are this rank's shards and the batch is the global one
    (`trainer.loss_fn`)."""
    base = llama.map_params(base_params, torch.Tensor.detach)
    merged = merge(base, _tensor_region(lora_params, mesh), lora_cfg)
    return trainer.loss_fn(merged, lcfg, tokens, targets, mask, remat=remat,
                           mesh=mesh)


def make_lora_train_step(lcfg: llama.LlamaConfig, lora_cfg: LoraConfig,
                         optimizer: trainer.AdamW, remat: bool = False,
                         mesh: Optional[Mesh] = None):
    """(lora_params, opt_state, base_params, batch) -> (lora_params,
    opt_state, metrics). The optimizer's state covers the adapters only.
    With a `mesh`, the adapters, their state and the base are this
    rank's shards (`shard_lora_state`, `trainer.shard_train_state`) and
    the batch is the global one."""
    if mesh is not None:
        trainer.check_train_mesh(mesh)

    def step(lora_params, opt_state, base_params, batch):
        lora_params, opt_state, loss, gnorm = trainer.sharded_update(
            lambda lp: loss_with_lora(lp, base_params, lcfg, lora_cfg,
                                      batch["tokens"], batch["targets"],
                                      batch["mask"], remat=remat,
                                      mesh=mesh),
            lora_params,
            trainer.aligned_specs(lora_param_specs(lora_params),
                                  lora_params),
            opt_state, optimizer, mesh)
        return lora_params, opt_state, {"loss": loss,
                                        "lora_grad_norm": gnorm}

    return step
