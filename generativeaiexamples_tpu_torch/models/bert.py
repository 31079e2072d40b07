"""BERT-class encoder in PyTorch: embedder and cross-encoder reranker.

Counterpart of generativeaiexamples_tpu/models/bert.py, with the same
parameter tree (stacked `[L, ...]` layer weights, `[in, out]`
projections), so `models/convert.bert_params_from_numpy` carries JAX
weights across leaf by leaf. One encoder serves both roles:

- embedder: CLS (or mean) pooling + L2 normalisation;
- cross-encoder: [CLS] query [SEP] passage [SEP] through the encoder,
  CLS -> tanh pooler -> linear -> relevance score.

Attention at S <= 512 goes to `ops.encoder_attention` (the K3 CUDA
kernel on the card, its plain version on the CPU); longer inputs go to
`ops.attention.attention(causal=False, lengths=...)`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device
from generativeaiexamples_tpu_torch.ops import attention as attn_ops
from generativeaiexamples_tpu_torch.ops.encoder_attention import (
    MAX_SEQ, encoder_attention)

Params = Dict[str, Any]


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    mlp_dim: int = 4096
    max_position: int = 512
    type_vocab_size: int = 2
    ln_eps: float = 1e-12
    pooling: str = "cls"  # cls | mean
    normalize: bool = True
    n_labels: int = 0  # >0 adds a cross-encoder classification head
    dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def arctic_embed_l() -> "BertConfig":
        return BertConfig()  # BERT-large geometry, CLS pooling, normalized

    @staticmethod
    def reranker_base() -> "BertConfig":
        """Cross-encoder reranker at BERT-base geometry."""
        return BertConfig(dim=768, n_layers=12, n_heads=12, mlp_dim=3072,
                          pooling="cls", normalize=False, n_labels=1)

    @staticmethod
    def tiny(vocab_size: int = 128) -> "BertConfig":
        return BertConfig(vocab_size=vocab_size, dim=32, n_layers=2,
                          n_heads=2, mlp_dim=64, max_position=64)


def init_params(cfg: BertConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> Params:
    """Random init (normal * 0.02, unit / zero norms and biases) on
    `device` (CUDA unless the caller asks for the CPU), drawn from
    `generator` (default: seed 0 on that device)."""
    dev = resolve_device(device)
    g = generator if generator is not None \
        else torch.Generator(device=dev).manual_seed(0)
    if g.device.type != dev.type:
        raise ValueError(f"generator on {g.device}, params on {dev}")
    D, M, L = cfg.dim, cfg.mlp_dim, cfg.n_layers

    def norm(*shape):
        out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        for part in (out if len(shape) == 3 else [out]):
            part.copy_(torch.randn(part.shape, generator=g, device=dev)
                       * 0.02)
        return out

    def const(value, *shape):
        return torch.full(shape, value, dtype=cfg.dtype, device=dev)

    params: Params = {
        "tok_emb": norm(cfg.vocab_size, D),
        "pos_emb": norm(cfg.max_position, D),
        "type_emb": norm(cfg.type_vocab_size, D),
        "emb_ln": {"w": const(1.0, D), "b": const(0.0, D)},
        "layers": {
            "wq": norm(L, D, D), "bq": const(0.0, L, D),
            "wk": norm(L, D, D), "bk": const(0.0, L, D),
            "wv": norm(L, D, D), "bv": const(0.0, L, D),
            "wo": norm(L, D, D), "bo": const(0.0, L, D),
            "ln1_w": const(1.0, L, D), "ln1_b": const(0.0, L, D),
            "w_in": norm(L, D, M), "b_in": const(0.0, L, M),
            "w_out": norm(L, M, D), "b_out": const(0.0, L, D),
            "ln2_w": const(1.0, L, D), "ln2_b": const(0.0, L, D),
        },
    }
    if cfg.n_labels:
        params["classifier"] = {
            "pool_w": norm(D, D), "pool_b": const(0.0, D),
            "w": norm(D, cfg.n_labels), "b": const(0.0, cfg.n_labels),
        }
    return params


_SPLIT = ("wq", "wk", "wv", "bq", "bk", "bv")


def fuse_qkv_params(params: Params) -> Params:
    """One-time QKV fusion: wq/wk/wv (and biases) -> wqkv [L, D, 3D] and
    bqkv [L, 3D], which forward() projects with. Idempotent."""
    lw = params["layers"]
    if "wqkv" in lw:
        return params
    fused = {k: v for k, v in lw.items() if k not in _SPLIT}
    fused["wqkv"] = torch.cat([lw["wq"], lw["wk"], lw["wv"]], dim=-1)
    fused["bqkv"] = torch.cat([lw["bq"], lw["bk"], lw["bv"]], dim=-1)
    return {**params, "layers": fused}


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with f32 statistics, scaled in the input's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


@torch.no_grad()
def forward(params: Params, cfg: BertConfig, tokens: torch.Tensor, *,
            lengths: Optional[torch.Tensor] = None,
            token_types: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (hidden [B, S, D], pooled [B, D] or scores
    [B, n_labels]). `lengths` [B] int32 masks padding keys."""
    B, S = tokens.shape
    H, Hd = cfg.n_heads, cfg.head_dim
    dev = tokens.device
    tokens = tokens.long()
    if token_types is None:
        token_types = torch.zeros_like(tokens)
    x = (params["tok_emb"][tokens]
         + params["pos_emb"][torch.arange(S, device=dev)][None]
         + params["type_emb"][token_types.long()])
    x = layer_norm(x, params["emb_ln"]["w"], params["emb_ln"]["b"],
                   cfg.ln_eps)
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    lengths = lengths.to(device=dev, dtype=torch.int32)
    lw = fuse_qkv_params(params)["layers"]
    for layer in range(cfg.n_layers):
        w = {k: v[layer] for k, v in lw.items()}
        qkv = (x @ w["wqkv"] + w["bqkv"]).view(B, S, 3, H, Hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        if S <= MAX_SEQ:
            out = encoder_attention(q, k, v, lengths)
        else:
            out = attn_ops.attention(q, k, v, causal=False, lengths=lengths)
        out = out.transpose(1, 2).reshape(B, S, H * Hd)
        x = layer_norm(x + out @ w["wo"] + w["bo"], w["ln1_w"], w["ln1_b"],
                       cfg.ln_eps)
        h = F.gelu(x @ w["w_in"] + w["b_in"], approximate="none")
        x = layer_norm(x + h @ w["w_out"] + w["b_out"], w["ln2_w"],
                       w["ln2_b"], cfg.ln_eps)

    mask = (torch.arange(S, device=dev)[None, :]
            < lengths[:, None]).to(x.dtype)
    if cfg.pooling == "mean":
        pooled = (x * mask[..., None]).sum(1) / torch.clamp(
            mask.sum(1, keepdim=True), min=1.0)
    else:
        pooled = x[:, 0]
    if cfg.n_labels:
        c = params["classifier"]
        pooled = torch.tanh(pooled @ c["pool_w"] + c["pool_b"])
        return x, pooled @ c["w"] + c["b"]
    if cfg.normalize:
        pooled = pooled / torch.linalg.vector_norm(
            pooled, dim=-1, keepdim=True).clamp(min=1e-12)
    return x, pooled
