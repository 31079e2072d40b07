"""Llama-family decoder in PyTorch (plain functions over a dict of tensors).

Counterpart of generativeaiexamples_tpu/models/llama.py. The parameter
tree has the same keys and the same stacked layout: per-layer weights
carry a leading layer axis ([L, ...]) and projections are stored
[in, out] so that `x @ w` applies them. One converter
(models/convert.py) therefore serves both packages. Attention goes
through ops.attention: the K1 CUDA kernel for CUDA tensors, the plain
reference for CPU tensors.

RMSNorm, RoPE (optionally llama3-scaled), GQA, SwiGLU MLP, optional tied
embeddings. Projections go through `ops.quant.mm`, so the same code runs
a weight-only int8 tree (`ops.quant.quantize_llama_params`): K6 on CUDA,
the plain route on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device
from generativeaiexamples_tpu_torch.ops import attention as attn_ops
from generativeaiexamples_tpu_torch.ops.quant import mm

Params = Dict[str, Any]


@dataclass(frozen=True)
class RopeScaling:
    """Llama-3.1-style rope frequency scaling (HF `rope_type: "llama3"`)."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    mlp_dim: int = 14336
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    rope_scaling: Optional[RopeScaling] = None
    dtype: Any = torch.bfloat16

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama3_70b() -> "LlamaConfig":
        return LlamaConfig(dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
                           mlp_dim=28672)

    @staticmethod
    def llama3_1_8b() -> "LlamaConfig":
        return LlamaConfig(max_seq_len=131072,
                           rope_scaling=RopeScaling(factor=8.0))

    @staticmethod
    def llama3_2_1b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=128256, dim=2048, n_layers=16,
                           n_heads=32, n_kv_heads=8, head_dim=64,
                           mlp_dim=8192, tie_embeddings=True,
                           max_seq_len=131072,
                           rope_scaling=RopeScaling(factor=32.0))

    @staticmethod
    def tiny(vocab_size: int = 256) -> "LlamaConfig":
        """Hermetic-test geometry (f32)."""
        return LlamaConfig(vocab_size=vocab_size, dim=64, n_layers=2,
                           n_heads=4, n_kv_heads=2, head_dim=16, mlp_dim=128,
                           max_seq_len=128, dtype=torch.float32)


def init_params(cfg: LlamaConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> Params:
    """Random init on `device` (CUDA unless the caller asks for the CPU),
    drawn from `generator` (default: seed 0 on that device). Stacked
    weights are drawn one layer at a time, so the f32 draw never holds
    more than one layer's matrix at once."""
    dev = resolve_device(device)
    g = generator if generator is not None \
        else torch.Generator(device=dev).manual_seed(0)
    if g.device.type != dev.type:
        raise ValueError(f"generator on {g.device}, params on {dev}")
    D, H, KH, Hd, M, L = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                          cfg.mlp_dim, cfg.n_layers)

    def norm(*shape, scale=None):
        scale = scale if scale is not None else shape[-2] ** -0.5
        out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        for part in (out if len(shape) == 3 else [out]):
            part.copy_(torch.randn(part.shape, generator=g, device=dev)
                       * scale)
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    params: Params = {
        "tok_emb": norm(cfg.vocab_size, D, scale=0.02),
        "ln_f": ones(D),
        "layers": {
            "ln1": ones(L, D),
            "ln2": ones(L, D),
            "wq": norm(L, D, H * Hd),
            "wk": norm(L, D, KH * Hd),
            "wv": norm(L, D, KH * Hd),
            "wo": norm(L, H * Hd, D),
            "w_gate": norm(L, D, M),
            "w_up": norm(L, D, M),
            "w_down": norm(L, M, D),
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = norm(D, cfg.vocab_size, scale=D ** -0.5)
    return params


def map_params(params: Params, fn: Callable[[torch.Tensor], Any]) -> Params:
    """Apply `fn` to every tensor of a parameter tree."""
    return {k: map_params(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in params.items()}


def layer_weights(params: Params, layer: int) -> Dict[str, Any]:
    """One layer's weights: views into the stacked [L, ...] tensors (a
    stacked QuantizedTensor gives QuantizedTensor(q[l], s[l]))."""
    return {k: v[layer] for k, v in params["layers"].items()}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * w


def rope_freqs(head_dim: int, theta: float,
               scaling: Optional[RopeScaling] = None,
               device=None) -> torch.Tensor:
    """Inverse frequencies [Hd/2] (f32), with optional llama3 scaling."""
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=device) / head_dim
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=device), exps)
    if scaling is None:
        return freqs
    s = scaling
    wavelen = 2.0 * math.pi / freqs
    high_wl = s.original_max_position_embeddings / s.high_freq_factor
    low_wl = s.original_max_position_embeddings / s.low_freq_factor
    smooth = (s.original_max_position_embeddings / wavelen
              - s.low_freq_factor) / (s.high_freq_factor - s.low_freq_factor)
    mid = (1.0 - smooth) * freqs / s.factor + smooth * freqs
    return torch.where(wavelen < high_wl, freqs,
                       torch.where(wavelen > low_wl, freqs / s.factor, mid))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 scaling: Optional[RopeScaling] = None):
    """cos, sin [B, 1, S, Hd/2] (f32) for positions [B, S]; computed once
    per forward and shared by every layer's q and k."""
    freqs = rope_freqs(head_dim, theta, scaling, device=positions.device)
    angles = positions[:, None, :, None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         scaling: Optional[RopeScaling] = None) -> torch.Tensor:
    """Rotary position embedding. x [B, n, S, Hd], positions [B, S]."""
    return apply_rope(x, *rope_cos_sin(positions, x.shape[-1], theta,
                                       scaling))


@dataclass
class KVCache:
    """Contiguous KV cache: k/v [L, B, KH, S_max, Hd], lengths [B] (tokens
    already written). Backs greedy_generate and tests; serving uses the
    paged pool in serving.kv_cache."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @staticmethod
    def zeros(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None,
              dtype=None, device: DeviceLike = None) -> "KVCache":
        dev = resolve_device(device)
        S = max_len or cfg.max_seq_len
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, S, cfg.head_dim)
        dtype = dtype or cfg.dtype
        return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                       torch.zeros(shape, dtype=dtype, device=dev),
                       torch.zeros((batch,), dtype=torch.int32, device=dev))


def project_qkv(cfg: LlamaConfig, h: torch.Tensor, w: Dict[str, torch.Tensor],
                cos: torch.Tensor, sin: torch.Tensor):
    """h [B, S, D] -> rotated q [B, H, S, Hd], rotated k and v
    [B, KH, S, Hd] (views in head-major order)."""
    B, S, _ = h.shape
    H, KH, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = mm(h, w["wq"]).view(B, S, H, Hd).transpose(1, 2)
    k = mm(h, w["wk"]).view(B, S, KH, Hd).transpose(1, 2)
    v = mm(h, w["wv"]).view(B, S, KH, Hd).transpose(1, 2)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def finish_block(cfg: LlamaConfig, x: torch.Tensor, out: torch.Tensor,
                 w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Attention output projection + residual, then the SwiGLU MLP."""
    B, S, _ = x.shape
    x = x + mm(out.transpose(1, 2).reshape(B, S, -1), w["wo"])
    h = rms_norm(x, w["ln2"], cfg.rms_eps)
    return x + mm(F.silu(mm(h, w["w_gate"])) * mm(h, w["w_up"]), w["w_down"])


def logits_from_hidden(cfg: LlamaConfig, params: Params,
                       x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["ln_f"], cfg.rms_eps)
    if cfg.tie_embeddings:
        return (x @ params["tok_emb"].T.to(x.dtype)).float()
    return mm(x, params["lm_head"]).float()


def forward(params: Params, cfg: LlamaConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            kv_cache: Optional[KVCache] = None,
            lengths: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Token ids [B, S] -> (logits [B, S, V] f32, cache or None).

    1. No cache: full causal attention.
    2. Fresh cache (lengths 0): k/v written at absolute positions.
    3. Decode: new k/v appended after the cached prefix.
    Unlike the JAX version, the cache's k/v tensors are updated IN PLACE;
    the returned KVCache shares them and carries the new lengths."""
    x, new_cache = forward_hidden(params, cfg, tokens, positions=positions,
                                  kv_cache=kv_cache, lengths=lengths)
    return logits_from_hidden(cfg, params, x), new_cache


def forward_hidden(params: Params, cfg: LlamaConfig, tokens: torch.Tensor, *,
                   positions: Optional[torch.Tensor] = None,
                   kv_cache: Optional[KVCache] = None,
                   lengths: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """`forward` up to the last block: (hidden [B, S, D] before the final
    norm, cache or None). Callers that need the logits of a few positions
    (a prefill chunk's last valid token) take them from here instead of
    materialising [B, S, V]."""
    B, S = tokens.shape
    dev = tokens.device
    if positions is None:
        base = (kv_cache.lengths[:, None].long() if kv_cache is not None
                else 0)
        positions = base + torch.arange(S, device=dev)[None, :]
    x = params["tok_emb"][tokens].to(cfg.dtype)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    new_len = (lengths.to(torch.int32) if lengths is not None
               else torch.full((B,), S, dtype=torch.int32, device=dev))
    if kv_cache is not None:
        attn_lengths = kv_cache.lengths + new_len
        q_offset = kv_cache.lengths
        idx = kv_cache.lengths[:, None].long() + torch.arange(S, device=dev)
        bidx = torch.arange(B, device=dev)[:, None]
    else:
        attn_lengths, q_offset = new_len, None

    for layer in range(cfg.n_layers):
        w = layer_weights(params, layer)
        h = rms_norm(x, w["ln1"], cfg.rms_eps)
        q, k, v = project_qkv(cfg, h, w, cos, sin)
        if kv_cache is None:
            out = attn_ops.attention(q, k, v, causal=True,
                                     lengths=attn_lengths)
        else:
            kc, vc = kv_cache.k[layer], kv_cache.v[layer]
            # Scatter the S new tokens at [len, len + S) per row:
            # kc[bidx, :, idx] addresses [B, S, KH, Hd].
            kc[bidx, :, idx] = k.transpose(1, 2).to(kc.dtype)
            vc[bidx, :, idx] = v.transpose(1, 2).to(vc.dtype)
            out = attn_ops.attention(q, kc, vc, causal=True,
                                     lengths=attn_lengths, q_offset=q_offset)
        x = finish_block(cfg, x, out, w)

    new_cache = None
    if kv_cache is not None:
        new_cache = dataclasses.replace(kv_cache, lengths=attn_lengths)
    return x, new_cache


@torch.no_grad()
def greedy_generate(params: Params, cfg: LlamaConfig, prompt: torch.Tensor,
                    max_new_tokens: int, *,
                    eos_id: Optional[int] = None) -> torch.Tensor:
    """Batch greedy decode over a contiguous cache (tests / offline use).
    prompt [B, S] -> [B, S + max_new_tokens]."""
    B, S = prompt.shape
    cache = KVCache.zeros(cfg, B, max_len=S + max_new_tokens,
                          device=prompt.device)
    logits, cache = forward(params, cfg, prompt, kv_cache=cache)
    tok = logits[:, -1].argmax(dim=-1)[:, None]
    done = tok[:, 0] == eos_id if eos_id is not None else None
    out = [prompt, tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = forward(params, cfg, tok, kv_cache=cache)
        nxt = logits[:, -1].argmax(dim=-1)[:, None]
        if eos_id is not None:
            nxt = torch.where(done[:, None], torch.full_like(nxt, eos_id),
                              nxt)
            done = done | (nxt[:, 0] == eos_id)
        tok = nxt
        out.append(tok)
    return torch.cat(out, dim=1)
