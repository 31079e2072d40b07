"""Token sampling on the device: greedy / temperature / top-k / top-p.

Counterpart of generativeaiexamples_tpu/serving/sampling.py, with
per-slot parameter tensors so one step serves a heterogeneous batch.
Categorical draws come from the caller's `torch.Generator`, so they do
not reproduce `jax.random` draws; greedy rows and the masks match.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SamplingParams(NamedTuple):
    """Per-slot [B]-shaped tensors."""

    temperature: torch.Tensor  # 0 => greedy
    top_p: torch.Tensor        # 1.0 => disabled
    top_k: torch.Tensor        # 0 => disabled

    @staticmethod
    def make(batch: int, temperature=0.0, top_p=1.0, top_k=0,
             device=None) -> "SamplingParams":
        def full(v, dtype):
            return torch.full((batch,), v, dtype=dtype, device=device)

        return SamplingParams(full(float(temperature), torch.float32),
                              full(float(top_p), torch.float32),
                              full(int(top_k), torch.int32))


def _mask_top_k(logits: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Keep the top_k[b] largest logits per row (0 = keep all)."""
    V = logits.shape[-1]
    sorted_l = torch.sort(logits, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k.clamp(1, V), torch.full_like(top_k, V))
    thresh = torch.gather(sorted_l, -1, (k - 1).long()[:, None])
    return torch.where(logits >= thresh, logits,
                       torch.full_like(logits, -float("inf")))


def _mask_top_p(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus mask: smallest set of tokens with cumulative probability
    >= top_p[b] (rank 0 is always kept)."""
    sorted_l, sort_idx = torch.sort(logits, dim=-1, descending=True)
    probs = torch.softmax(sorted_l, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p[:, None]
    keep = torch.zeros_like(keep_sorted).scatter(-1, sort_idx, keep_sorted)
    return torch.where(keep, logits, torch.full_like(logits, -float("inf")))


def sample(logits: torch.Tensor, params: SamplingParams,
           generator: Optional[torch.Generator] = None, *,
           all_greedy: bool = False, any_top_k: bool = True,
           any_top_p: bool = True) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int32). temperature <= 0 rows are
    greedy. The keyword flags are host-known: an all-greedy batch skips
    the sorts and the draw, and each mask is skipped when no slot asks
    for it."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    if all_greedy:
        return greedy
    t = params.temperature.clamp(min=1e-6)[:, None]
    scaled = logits.float() / t
    if any_top_k:
        scaled = _mask_top_k(scaled, params.top_k)
    if any_top_p:
        scaled = _mask_top_p(scaled, params.top_p)
    probs = torch.softmax(scaled, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(params.temperature <= 0.0, greedy,
                       sampled.to(torch.int32))
