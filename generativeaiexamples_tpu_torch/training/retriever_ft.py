"""Retriever customization: contrastive fine-tune of the embedding model.

Counterpart of generativeaiexamples_tpu/training/retriever_ft.py, on one
device: InfoNCE with in-batch negatives over (query, positive passage)
pairs, which typically come from the synthetic QA generator
(eval/harness.py) run over the deployment corpus. The encoder runs on
the differentiable route (`bert.forward(..., attention="plain")`, JAX's
`use_pallas=False`); the fine-tuned weights serve through K3 as before.
The optimizer is optax's `chain(clip_by_global_norm(grad_clip),
adamw(learning_rate))` written out (training/trainer.py `AdamW`, with
optax's default weight decay 1e-4).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device
from generativeaiexamples_tpu_torch.models import bert
from generativeaiexamples_tpu_torch.training import trainer


@dataclasses.dataclass(frozen=True)
class RetrieverFTConfig:
    learning_rate: float = 2e-5
    temperature: float = 0.05  # InfoNCE logit scale (1/tau)
    grad_clip: float = 1.0


def encode(params, cfg: bert.BertConfig, tokens, lengths) -> torch.Tensor:
    """Pooled, L2-normalized embeddings [B, D], on the training route."""
    _, pooled = bert.forward(params, cfg, tokens, lengths=lengths,
                             attention="plain")
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)


def info_nce_loss(params, cfg: bert.BertConfig, batch: Dict,
                  temperature: float) -> Tuple[torch.Tensor, Dict]:
    """Symmetric in-batch-negatives contrastive loss: query i must score
    its own passage above every other passage in the batch (and vice
    versa)."""
    q = encode(params, cfg, batch["q_tokens"], batch["q_lengths"])
    p = encode(params, cfg, batch["p_tokens"], batch["p_lengths"])
    logits = (q @ p.T) / temperature  # [B, B]
    labels = torch.arange(q.shape[0], device=q.device)
    loss = 0.5 * (F.cross_entropy(logits.float(), labels)
                  + F.cross_entropy(logits.T.float(), labels))
    acc = (logits.argmax(dim=1) == labels).float().mean()
    return loss, {"loss": loss.detach(), "retrieval_acc": acc}


def make_train_step(cfg: bert.BertConfig, ft: RetrieverFTConfig,
                    optimizer: trainer.AdamW):
    def step(params, opt_state, batch):
        (_, metrics), grads = trainer.value_and_grad(
            lambda p: info_nce_loss(p, cfg, batch, ft.temperature), params,
            has_aux=True)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, metrics

    return step


def make_optimizer(ft: RetrieverFTConfig) -> trainer.AdamW:
    return trainer.AdamW(ft.learning_rate, grad_clip=ft.grad_clip)


def tokenize_pairs(tokenizer, pairs: Sequence[Tuple[str, str]],
                   max_len: int = 64, device: DeviceLike = None) -> Dict:
    """(query, passage) strings -> padded int32 token batch on `device`.
    Works with any tokenizer exposing encode() -> List[int]."""
    dev = resolve_device(device)

    def enc_side(texts):
        ids = [tokenizer.encode(t)[:max_len] for t in texts]
        lengths = np.asarray([max(1, len(i)) for i in ids], np.int32)
        out = np.zeros((len(ids), max_len), np.int32)
        for r, seq in enumerate(ids):
            out[r, :len(seq)] = seq
        return torch.from_numpy(out).to(dev), torch.from_numpy(lengths).to(dev)

    q_tokens, q_lengths = enc_side([q for q, _ in pairs])
    p_tokens, p_lengths = enc_side([p for _, p in pairs])
    return {"q_tokens": q_tokens, "q_lengths": q_lengths,
            "p_tokens": p_tokens, "p_lengths": p_lengths}


def finetune(params, cfg: bert.BertConfig, tokenizer,
             pairs: Sequence[Tuple[str, str]], *, epochs: int = 3,
             batch_size: int = 32,
             ft: RetrieverFTConfig = RetrieverFTConfig(),
             log: Callable[[Dict], None] = lambda m: None,
             device: DeviceLike = None):
    """Driver over a pair list; returns trained params. Small corpora
    clamp the batch to the corpus (never a silent zero training steps);
    a sub-batch tail is dropped with a warning."""
    if not pairs:
        raise ValueError("finetune needs at least one (query, passage) pair")
    batch_size = min(batch_size, len(pairs))
    tail = len(pairs) % batch_size
    if tail:
        logging.getLogger(__name__).warning(
            "dropping %d trailing pairs (< batch_size %d)", tail, batch_size)
    # Tokenize every batch once (host work does not repeat per epoch).
    batches = [tokenize_pairs(tokenizer, pairs[i:i + batch_size],
                              device=device)
               for i in range(0, len(pairs) - batch_size + 1, batch_size)]
    opt = make_optimizer(ft)
    step = make_train_step(cfg, ft, opt)
    opt_state = opt.init(params)
    for _ in range(epochs):
        for batch in batches:
            params, opt_state, metrics = step(params, opt_state, batch)
            log({k: float(v) for k, v in metrics.items()})
    return params
