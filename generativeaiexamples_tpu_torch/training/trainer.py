"""Next-token SFT / pretraining step for the Llama models, on one device.

Counterpart of generativeaiexamples_tpu/training/trainer.py (its
single-device part; the mesh-sharded train state, `shard_train_state`,
is not ported yet: ROADMAP A.19). The loss runs the model on the
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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device
from generativeaiexamples_tpu_torch.models import llama

Tree = Dict[str, Any]


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
               params: Tree) -> Tuple[Tree, Dict[str, Any]]:
        """(new params, new state) from gradients in `tree_leaves`
        order."""
        if self.grad_clip is not None:
            g_norm = global_norm(grads)
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


def loss_fn(params: Tree, cfg: llama.LlamaConfig, tokens, targets, mask,
            remat: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy over mask == 1 positions, through the
    differentiable route."""
    logits, _ = llama.forward(params, cfg, tokens, attention="plain",
                              remat=remat)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets.long()[..., None])[..., 0]
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_train_step(cfg: llama.LlamaConfig, tcfg: TrainConfig,
                    optimizer: AdamW) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).
    Batch: {tokens, targets, mask} each [B, S]."""

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(
            lambda p: loss_fn(p, cfg, batch["tokens"], batch["targets"],
                              batch["mask"], remat=tcfg.remat), params)
        gnorm = global_norm(grads)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


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
