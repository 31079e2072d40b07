"""Llama-family decoder in PyTorch (plain functions over a dict of tensors).

Counterpart of generativeaiexamples_tpu/models/llama.py. The parameter
tree has the same keys and the same stacked layout: per-layer weights
carry a leading layer axis ([L, ...]) and projections are stored
[in, out] so that `x @ w` applies them. One converter
(models/convert.py) therefore serves both packages. Attention goes
through ops.attention: the K1 CUDA kernel for CUDA tensors, the plain
reference for CPU tensors, or, on the route training asks for
(`attention="plain"`), the plain reference on any device.

RMSNorm, RoPE (optionally llama3-scaled), GQA, SwiGLU MLP, optional tied
embeddings. Projections go through `ops.quant.mm`, so the same code runs
a weight-only int8 tree (`ops.quant.quantize_llama_params`): K6 on CUDA,
the plain route on the CPU.

Tensor parallelism (serving/sharding.py): a rank process holds its slice
of every leaf and runs this code on a config of local head counts
(`sharding.local_config`). The collectives sit in three helpers, which
do nothing without an active tensor-parallel mesh
(parallel/mesh.py), so the single-device forward is unchanged bit for
bit: `embed` (the vocab-parallel embedding: each rank looks up the ids
of its vocabulary slice, the rest are zeros, one all-reduce),
`finish_block` (one all-reduce after `wo` and one after `w_down`) and
`logits_from_hidden` (vocab-sharded logits gathered before sampling).
On the inference route autograd does not see those collectives. The
training route (`attention="plain"`) takes Megatron's autograd-aware
ones instead (parallel/mesh.py): the embedding's and each row-parallel
output's sum has the identity backward, each column-parallel input
(q/k/v, the MLP, the head) sums its gradient over the tensor axis, and
the gathered logits' backward keeps this rank's vocabulary slice.
Under an active mesh whose "sequence" axis is above 1 the training
route's tokens are this rank's sequence shard (its `positions` carry
the global offset) and attention is ring attention over that axis
(ops/ring_attention.py): causal on global positions, its K/V rotations
autograd-aware, so the backward is exact.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device
from generativeaiexamples_tpu_torch.ops import attention as attn_ops
from generativeaiexamples_tpu_torch.ops.quant import mm
from generativeaiexamples_tpu_torch.ops.ring_attention import ring_attention
from generativeaiexamples_tpu_torch.parallel import mesh as mesh_lib
from generativeaiexamples_tpu_torch.parallel.mesh import (
    tensor_all_gather, tensor_all_reduce, tensor_shard)

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


def param_shapes(cfg: LlamaConfig) -> Params:
    """The shape of every leaf `init_params` makes, without allocating
    (what the memory planner reads)."""
    D, H, KH, Hd, M, L = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                          cfg.mlp_dim, cfg.n_layers)
    shapes: Params = {
        "tok_emb": (cfg.vocab_size, D),
        "ln_f": (D,),
        "layers": {
            "ln1": (L, D), "ln2": (L, D),
            "wq": (L, D, H * Hd), "wk": (L, D, KH * Hd),
            "wv": (L, D, KH * Hd), "wo": (L, H * Hd, D),
            "w_gate": (L, D, M), "w_up": (L, D, M), "w_down": (L, M, D),
        },
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, cfg.vocab_size)
    return shapes


def param_specs(cfg: LlamaConfig) -> Params:
    """The mesh axes each leaf's dimensions shard over, parallel to
    `init_params` (the JAX package's `param_specs` after its logical-axis
    rules; None = replicated). Megatron layout: q/k/v and the MLP's
    inputs shard their output dimension on "tensor", wo and w_down their
    input dimension, the embeddings their vocabulary; the hidden
    dimension of the weights is the "fsdp" axis. Each rank's shard
    (serving/sharding.py, the sharded load of models/hf_loader.py) and
    the memory planner's per-device bytes follow this table."""
    specs: Params = {
        "tok_emb": ("tensor", "fsdp"),
        "ln_f": (None,),
        "layers": {
            "ln1": (None, None), "ln2": (None, None),
            "wq": (None, "fsdp", "tensor"), "wk": (None, "fsdp", "tensor"),
            "wv": (None, "fsdp", "tensor"), "wo": (None, "tensor", "fsdp"),
            "w_gate": (None, "fsdp", "tensor"),
            "w_up": (None, "fsdp", "tensor"),
            "w_down": (None, "tensor", "fsdp"),
        },
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("fsdp", "tensor")
    return specs


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
    """Inverse frequencies [Hd/2] (f32), with optional llama3 scaling.
    The base is a device fill, not a host-to-device copy (a decode block
    captured as a CUDA graph calls this once a forward)."""
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=device) / head_dim
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
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
    paged pool in serving.kv_cache.

    `store` is set on a view of a static scratch store
    (`serving.engine_model.scratch_view`): the store's own k / v, whose
    last row is a sink past every view. `forward_hidden` writes a row at
    or past the view's end there, where nothing reads it, as the JAX
    package's scatter drops an index out of range; without a store such
    a row is an index error."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    store: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

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


def _reduce(x: torch.Tensor, route: str) -> torch.Tensor:
    """Sum a row-parallel partial over the active tensor axis (the
    identity backward on the training route)."""
    m = mesh_lib.active_mesh()
    if route == "plain" and m is not None:
        return mesh_lib.reduce_from_tensor_region(x, m)
    return tensor_all_reduce(x)


def _copy_in(x: torch.Tensor, route: str) -> torch.Tensor:
    """A column-parallel input: on the training route under an active
    tensor axis its gradient is summed over the ranks."""
    m = mesh_lib.active_mesh()
    if route == "plain" and m is not None:
        return mesh_lib.copy_to_tensor_region(x, m)
    return x


def _gather_vocab(x: torch.Tensor, route: str) -> torch.Tensor:
    m = mesh_lib.active_mesh()
    if route == "plain" and m is not None:
        return mesh_lib.gather_from_region(x, m, "tensor", x.dim() - 1)
    return tensor_all_gather(x)


def project_qkv(cfg: LlamaConfig, h: torch.Tensor, w: Dict[str, torch.Tensor],
                cos: torch.Tensor, sin: torch.Tensor, route: str = "kernel"):
    """h [B, S, D] -> rotated q [B, H, S, Hd], rotated k and v
    [B, KH, S, Hd] (views in head-major order)."""
    h = _copy_in(h, route)
    B, S, _ = h.shape
    H, KH, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = mm(h, w["wq"]).view(B, S, H, Hd).transpose(1, 2)
    k = mm(h, w["wk"]).view(B, S, KH, Hd).transpose(1, 2)
    v = mm(h, w["wv"]).view(B, S, KH, Hd).transpose(1, 2)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def embed(params: Params, tokens: torch.Tensor, dtype,
          route: str = "kernel") -> torch.Tensor:
    """Token ids [...] -> embeddings [..., D] in `dtype`. Under tensor
    parallelism the table holds this rank's vocabulary slice: ids outside
    it read zeros and one all-reduce sums the ranks' rows (exactly one
    rank contributes each row, so the sum is exact)."""
    emb = params["tok_emb"]
    rank, tp = tensor_shard()
    if tp == 1:
        return emb[tokens.long()].to(dtype)
    n = emb.shape[0]
    local = tokens.long() - rank * n
    inside = (local >= 0) & (local < n)
    x = emb[local.clamp(0, n - 1)].to(dtype)
    return _reduce(torch.where(inside[..., None], x, torch.zeros_like(x)),
                   route)


def finish_block(cfg: LlamaConfig, x: torch.Tensor, out: torch.Tensor,
                 w: Dict[str, torch.Tensor],
                 route: str = "kernel") -> torch.Tensor:
    """Attention output projection + residual, then the SwiGLU MLP. Under
    tensor parallelism `wo` and `w_down` contract this rank's heads and
    MLP columns: each partial is summed over the ranks (one all-reduce
    each) before the residual."""
    B, S, _ = x.shape
    x = x + _reduce(mm(out.transpose(1, 2).reshape(B, S, -1), w["wo"]),
                    route)
    h = _copy_in(rms_norm(x, w["ln2"], cfg.rms_eps), route)
    return x + _reduce(
        mm(F.silu(mm(h, w["w_gate"])) * mm(h, w["w_up"]), w["w_down"]),
        route)


def logits_from_hidden(cfg: LlamaConfig, params: Params,
                       x: torch.Tensor, route: str = "kernel") -> torch.Tensor:
    """Final norm and head -> f32 logits over the whole vocabulary (under
    tensor parallelism each rank's vocabulary slice, gathered in rank
    order)."""
    x = _copy_in(rms_norm(x, params["ln_f"], cfg.rms_eps), route)
    if cfg.tie_embeddings:
        return _gather_vocab((x @ params["tok_emb"].T.to(x.dtype)).float(),
                             route)
    return _gather_vocab(mm(x, params["lm_head"]).float(), route)


def forward(params: Params, cfg: LlamaConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            kv_cache: Optional[KVCache] = None,
            lengths: Optional[torch.Tensor] = None,
            attention: str = "kernel", remat: bool = False,
            ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Token ids [B, S] -> (logits [B, S, V] f32, cache or None).

    1. No cache: full causal attention.
    2. Fresh cache (lengths 0): k/v written at absolute positions.
    3. Decode: new k/v appended after the cached prefix.
    Unlike the JAX version, the cache's k/v tensors are updated IN PLACE;
    the returned KVCache shares them and carries the new lengths.

    `attention="plain"` is the differentiable route (the JAX package's
    `use_pallas=False`): attention runs `mha_reference` on any device, so
    autograd sees it; the default "kernel" launches K1 on CUDA, which
    raises on operands that require grad. `remat` recomputes each
    layer's activations in the backward (torch.utils.checkpoint), a
    training option; it takes no cache."""
    x, new_cache = forward_hidden(params, cfg, tokens, positions=positions,
                                  kv_cache=kv_cache, lengths=lengths,
                                  attention=attention, remat=remat)
    return logits_from_hidden(cfg, params, x, attention), new_cache


def _block(cfg: LlamaConfig, x: torch.Tensor, w: Dict[str, torch.Tensor],
           cos: torch.Tensor, sin: torch.Tensor, attn_lengths: torch.Tensor,
           route: str) -> torch.Tensor:
    """One decoder layer without a cache: norm, q/k/v, causal attention,
    output projection and MLP."""
    h = rms_norm(x, w["ln1"], cfg.rms_eps)
    q, k, v = project_qkv(cfg, h, w, cos, sin, route)
    m = mesh_lib.active_sequence_mesh()
    if route == "plain" and m is not None:
        # A sequence shard of full rows (training pads nothing): the ring
        # masks by global position, so `attn_lengths` has nothing to add.
        out = ring_attention(q, k, v, mesh=m, axis_name="sequence",
                             causal=True)
    else:
        out = attn_ops.attention(q, k, v, causal=True,
                                 lengths=attn_lengths, route=route)
    return finish_block(cfg, x, out, w, route)


def run_blocks(layers: Dict[str, Any], cfg: LlamaConfig, x: torch.Tensor,
               cos, sin, lengths, attention: str = "kernel",
               remat: bool = False) -> torch.Tensor:
    """`x` through the stacked `layers` ([n, ...] leaves: the whole stack,
    or a pipeline stage's slice) with no KV cache. Under `remat` each
    block is recomputed in the backward (`torch.utils.checkpoint`)."""
    for i in range(layers["ln1"].shape[0]):
        w = {k: v[i] for k, v in layers.items()}
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _block, cfg, x, w, cos, sin, lengths, attention,
                use_reentrant=False)
        else:
            x = _block(cfg, x, w, cos, sin, lengths, attention)
    return x


def forward_hidden(params: Params, cfg: LlamaConfig, tokens: torch.Tensor, *,
                   positions: Optional[torch.Tensor] = None,
                   kv_cache: Optional[KVCache] = None,
                   lengths: Optional[torch.Tensor] = None,
                   attention: str = "kernel", remat: bool = False,
                   ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """`forward` up to the last block: (hidden [B, S, D] before the final
    norm, cache or None). Callers that need the logits of a few positions
    (a prefill chunk's last valid token) take them from here instead of
    materialising [B, S, V]."""
    if remat and kv_cache is not None:
        raise ValueError("remat recomputes layers in the backward; it "
                         "takes no KV cache (written in place)")
    B, S = tokens.shape
    dev = tokens.device
    if positions is None:
        base = (kv_cache.lengths[:, None].long() if kv_cache is not None
                else 0)
        positions = base + torch.arange(S, device=dev)[None, :]
    x = embed(params, tokens, cfg.dtype, attention)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    new_len = (lengths.to(torch.int32) if lengths is not None
               else torch.full((B,), S, dtype=torch.int32, device=dev))
    if kv_cache is not None:
        attn_lengths = kv_cache.lengths + new_len
        q_offset = kv_cache.lengths
        idx = kv_cache.lengths[:, None].long() + torch.arange(S, device=dev)
        bidx = torch.arange(B, device=dev)[:, None]
        k_dst, v_dst = kv_cache.k, kv_cache.v
        if kv_cache.store is not None:
            # A padded chunk may pass the view's end: those rows go to the
            # store's sink row (static in shape, no host read), so no row
            # of the view is overwritten by one that JAX drops.
            k_dst, v_dst = kv_cache.store
            idx = torch.where(idx < kv_cache.k.shape[3], idx,
                              k_dst.shape[3] - 1)
    else:
        attn_lengths, q_offset = new_len, None

    if kv_cache is None:
        return run_blocks(params["layers"], cfg, x, cos, sin, attn_lengths,
                          attention, remat), None
    for layer in range(cfg.n_layers):
        w = layer_weights(params, layer)
        h = rms_norm(x, w["ln1"], cfg.rms_eps)
        q, k, v = project_qkv(cfg, h, w, cos, sin, attention)
        kc, vc = kv_cache.k[layer], kv_cache.v[layer]
        # Scatter the S new tokens at [len, len + S) per row:
        # kc[bidx, :, idx] addresses [B, S, KH, Hd].
        k_dst[layer][bidx, :, idx] = k.transpose(1, 2).to(kc.dtype)
        v_dst[layer][bidx, :, idx] = v.transpose(1, 2).to(vc.dtype)
        out = attn_ops.attention(q, kc, vc, causal=True,
                                 lengths=attn_lengths, q_offset=q_offset,
                                 route=attention)
        x = finish_block(cfg, x, out, w, attention)

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
