"""LoRA fine-tuning for the Llama models, on one device.

Counterpart of generativeaiexamples_tpu/training/lora.py: low-rank
adapters on selected projections of the stacked layer weights; the
gradient flows only into the adapters (the frozen base takes no
gradient and no optimizer state), and `merge` folds trained adapters
into the base weights so the serving engine (K1 and K2 on the card)
needs no LoRA code path. `lora_param_specs` (the adapters' mesh layout)
is not ported yet: it comes with the sharded train state (ROADMAP A.19).

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
                   tokens, targets, mask, remat: bool = False):
    """SFT loss of the merged model; the base enters detached, so only
    the adapters take gradients."""
    base = llama.map_params(base_params, torch.Tensor.detach)
    merged = merge(base, lora_params, lora_cfg)
    return trainer.loss_fn(merged, lcfg, tokens, targets, mask, remat=remat)


def make_lora_train_step(lcfg: llama.LlamaConfig, lora_cfg: LoraConfig,
                         optimizer: trainer.AdamW, remat: bool = False):
    """(lora_params, opt_state, base_params, batch) -> (lora_params,
    opt_state, metrics). The optimizer's state covers the adapters only."""

    def step(lora_params, opt_state, base_params, batch):
        loss, grads = trainer.value_and_grad(
            lambda lp: loss_with_lora(lp, base_params, lcfg, lora_cfg,
                                      batch["tokens"], batch["targets"],
                                      batch["mask"], remat=remat),
            lora_params)
        gnorm = trainer.global_norm(grads)
        lora_params, opt_state = optimizer.update(grads, opt_state,
                                                  lora_params)
        return lora_params, opt_state, {"loss": loss,
                                        "lora_grad_norm": gnorm}

    return step
