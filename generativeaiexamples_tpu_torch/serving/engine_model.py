"""Paged Llama forward: the prefill and decode steps of the serving engine.

Counterpart of the main-path subset of
generativeaiexamples_tpu/serving/engine_model.py. The block math is the
contiguous model's (models/llama.py: rms_norm, rope, project_qkv,
finish_block), so paged forward == contiguous forward; the difference is
that k/v live in the serving PagePool:

- `prefill_batch_step`: N sequences at one bucketed length S, causal
  flash attention over each prompt (K1 on CUDA), every layer's k/v
  scattered into the sequences' pages (padding positions land in sink
  page 0), and the first token sampled on the device.
- `decode_multi_step`: K fused iterations over the whole slot batch,
  write-then-attend paged decode attention (K2 on CUDA) and on-device
  sampling, tokens chained on the device.
- Chunked prefill of prompts longer than the largest bucket:
  `prefill_chunk_step` / `prefill_chunk_sample_step` run one chunk
  through a contiguous scratch `KVCache` with `q_offset = cache.lengths`
  (K1's shifted causal diagonal on CUDA), and `cache_to_pool` scatters
  the finished cache into the page pool once. The prompt-completing
  chunk samples its first token and writes it to `last_tokens` in the
  same call.

With an int8 pool (`QuantPagePool`) every k/v row is quantized as it is
written (`paged_attention_int8.quantize_kv`: one f32 scale per kv head
and token), prefill layer by layer as each layer finishes, and decode
attends through K4 over the fused pool.

The JAX steps donate the pool and return a new one; these update the
pool IN PLACE (`index_put_` per layer) and never copy it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from generativeaiexamples_tpu_torch.models.llama import (
    KVCache, LlamaConfig, Params, finish_block, forward_hidden,
    layer_weights, logits_from_hidden, project_qkv, rms_norm, rope_cos_sin)
from generativeaiexamples_tpu_torch.ops import attention as attn_ops
from generativeaiexamples_tpu_torch.serving.kv_cache import (
    PagePool, QuantPagePool)
from generativeaiexamples_tpu_torch.serving.paged_attention import (
    paged_attention_dispatch)
from generativeaiexamples_tpu_torch.serving.paged_attention_int8 import (
    paged_attention_int8, quantize_kv)
from generativeaiexamples_tpu_torch.serving.sampling import (
    SamplingParams, sample)

Pool = Union[PagePool, QuantPagePool]


# The block pieces live in models/llama.py, shared with the contiguous
# forward (the JAX package keeps a copy of each here); the JAX names stay
# so a reader finds their counterparts.
_project_qkv = project_qkv
_finish_block = finish_block
_logits = logits_from_hidden


def _write_prefill_pages(pool: Pool, layer: int, k: torch.Tensor,
                         v: torch.Tensor, table_flat: torch.Tensor) -> None:
    """Scatter one layer's prefill k/v [N, KH, S, Hd] into the pool pages
    named by table_flat [N * S // ps] (row-major over the group), in
    place. Page-0 entries (padding) all land in the sink. An int8 pool
    takes the rows quantized (_write_quant_pages)."""
    N, KH, S, Hd = k.shape
    ps = pool.page_size

    def paged(t):  # [N, KH, S, ...] -> [KH, N * S/ps, ps, ...]
        rest = t.shape[3:]
        t = t.reshape(N, KH, S // ps, ps, *rest).transpose(0, 1)
        return t.reshape(KH, N * (S // ps), ps, *rest)

    if pool.quantized:
        kq, ks = quantize_kv(k, scale_dtype=pool.s.dtype)
        vq, vs = quantize_kv(v, scale_dtype=pool.s.dtype)
        _write_quant_pages(pool, layer, paged(kq), paged(ks), paged(vq),
                           paged(vs), table_flat)
        return
    pool.k[layer][:, table_flat] = paged(k).to(pool.k.dtype)
    pool.v[layer][:, table_flat] = paged(v).to(pool.v.dtype)


def _write_quant_pages(pool: QuantPagePool, layer: int, kq, ks, vq, vs,
                       table_flat: torch.Tensor) -> None:
    """Scatter one layer's page-shaped codes ([KH, M, ps, Hd]) and scales
    ([KH, M, ps]) into the fused pool pages named by table_flat [M], in
    place: k then v, codes then scales."""
    pool.kv[0, layer][:, table_flat] = kq
    pool.kv[1, layer][:, table_flat] = vq
    pool.s[0, layer][:, table_flat] = ks
    pool.s[1, layer][:, table_flat] = vs


def _prefill_logits(params: Params, cfg: LlamaConfig, pool: Pool,
                    tokens: torch.Tensor, lengths: torch.Tensor,
                    table_rows: torch.Tensor) -> torch.Tensor:
    """Forward N bucketed prompts, writing their k/v into the pool;
    returns the logits at each row's last valid position [N, V]."""
    N, S = tokens.shape
    if S % pool.page_size:
        raise ValueError(f"bucket {S} not a multiple of page_size "
                         f"{pool.page_size}")
    dev = tokens.device
    positions = torch.arange(S, device=dev)[None, :].expand(N, S)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    table_flat = table_rows.reshape(-1).long()
    x = params["tok_emb"][tokens.long()].to(cfg.dtype)
    for layer in range(cfg.n_layers):
        w = layer_weights(params, layer)
        h = rms_norm(x, w["ln1"], cfg.rms_eps)
        q, k, v = _project_qkv(cfg, h, w, cos, sin)
        out = attn_ops.attention(q, k, v, causal=True, lengths=lengths)
        x = _finish_block(cfg, x, out, w)
        _write_prefill_pages(pool, layer, k, v, table_flat)
    last = x[torch.arange(N, device=dev), lengths.long() - 1]  # [N, D]
    return _logits(cfg, params, last[:, None, :])[:, 0]


@torch.no_grad()
def prefill_step(params: Params, cfg: LlamaConfig, pool: Pool,
                 tokens: torch.Tensor, length, table_row: torch.Tensor
                 ) -> torch.Tensor:
    """Prefill one sequence ([1, S_bucket] tokens, `length` valid, pages
    table_row [S_bucket // ps]); returns last-token logits [V]. The pool
    is written in place."""
    dev = tokens.device
    lengths = torch.as_tensor(length, dtype=torch.int32,
                              device=dev).reshape(1)
    return _prefill_logits(params, cfg, pool, tokens, lengths,
                           table_row.reshape(1, -1))[0]


@torch.no_grad()
def prefill_batch_step(params: Params, cfg: LlamaConfig, pool: Pool,
                       tokens: torch.Tensor,       # [N, S_bucket]
                       lengths: torch.Tensor,      # [N] int32 (padding: 1)
                       table_rows: torch.Tensor,   # [N, S_bucket // ps]
                       temperature: torch.Tensor,  # [N]
                       top_p: torch.Tensor,        # [N]
                       top_k: torch.Tensor,        # [N]
                       generator: Optional[torch.Generator] = None,
                       sampling_flags: Tuple[bool, bool, bool] = (
                           True, False, False)) -> torch.Tensor:
    """Prefill N sequences in one pass and sample each one's first token
    on the device; returns first tokens [N] (int32). Padding rows
    (lengths 1, table page 0) are computed, their k/v land in the sink
    and their tokens are ignored by the caller. The pool is written in
    place."""
    logits = _prefill_logits(params, cfg, pool, tokens, lengths, table_rows)
    all_greedy, any_top_k, any_top_p = sampling_flags
    return sample(logits, SamplingParams(temperature, top_p, top_k),
                  generator, all_greedy=all_greedy, any_top_k=any_top_k,
                  any_top_p=any_top_p)


@torch.no_grad()
def set_last_tokens(last_tokens: torch.Tensor, idxs: Sequence[int],
                    toks: torch.Tensor) -> torch.Tensor:
    """last_tokens[idxs] = toks in place (batched admission). `idxs` is a
    host array; rows whose index is out of bounds (group padding) are
    dropped, as the JAX scatter's mode="drop" does."""
    idxs = np.asarray(idxs)
    keep = np.flatnonzero((idxs >= 0) & (idxs < last_tokens.shape[0]))
    dev = last_tokens.device
    dst = torch.from_numpy(idxs[keep].astype(np.int64)).to(dev)
    src = torch.from_numpy(keep.astype(np.int64)).to(dev)
    last_tokens.index_copy_(0, dst,
                            toks.index_select(0, src).to(last_tokens.dtype))
    return last_tokens


def _decode_once(params: Params, cfg: LlamaConfig, pool: Pool,
                 tokens: torch.Tensor, page_tables: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """One decode iteration, write-then-attend: each layer writes the
    current token's k/v into its pool slice (quantized, for an int8
    pool), then paged attention runs with `lengths` INCLUDING the current
    token (K2 over a bf16 pool, K4 over the fused int8 one). Returns
    logits [B, V]."""
    B = tokens.shape[0]
    ps = pool.page_size
    dev = tokens.device
    pos = lengths.long() - 1
    page_idx = page_tables[torch.arange(B, device=dev), pos // ps].long()
    offset = pos % ps
    cos, sin = rope_cos_sin(pos[:, None], cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    x = params["tok_emb"][tokens.long()[:, None]].to(cfg.dtype)  # [B, 1, D]
    for layer in range(cfg.n_layers):
        w = layer_weights(params, layer)
        h = rms_norm(x, w["ln1"], cfg.rms_eps)
        q, k, v = _project_qkv(cfg, h, w, cos, sin)  # [B, *, 1, Hd]
        k_new = k[:, :, 0, :].transpose(0, 1)        # [KH, B, Hd]
        v_new = v[:, :, 0, :].transpose(0, 1)
        q_new = q[:, :, 0, :].contiguous()
        if pool.quantized:
            kq, ksc = quantize_kv(k_new, scale_dtype=pool.s.dtype)
            vq, vsc = quantize_kv(v_new, scale_dtype=pool.s.dtype)
            pool.kv[0, layer][:, page_idx, offset] = kq
            pool.kv[1, layer][:, page_idx, offset] = vq
            pool.s[0, layer][:, page_idx, offset] = ksc
            pool.s[1, layer][:, page_idx, offset] = vsc
            out = paged_attention_int8(q_new, pool.kv, pool.s, page_tables,
                                       lengths, layer)
        else:
            kp, vp = pool.k[layer], pool.v[layer]    # [KH, P, ps, Hd]
            kp[:, page_idx, offset] = k_new.to(kp.dtype)
            vp[:, page_idx, offset] = v_new.to(vp.dtype)
            out = paged_attention_dispatch(q_new, kp, vp, page_tables,
                                           lengths)
        x = _finish_block(cfg, x, out[:, :, None, :], w)
    return _logits(cfg, params, x)[:, 0]


@torch.no_grad()
def decode_step(params: Params, cfg: LlamaConfig, pool: Pool,
                tokens: torch.Tensor, page_tables: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """One decode step for the whole slot batch -> logits [B, V]."""
    return _decode_once(params, cfg, pool, tokens, page_tables, lengths)


@torch.no_grad()
def decode_multi_step(params: Params, cfg: LlamaConfig, pool: Pool,
                      last_tokens: torch.Tensor,  # [B] device tokens
                      page_tables: torch.Tensor,  # [B, maxp] int32
                      lengths: torch.Tensor,      # [B] int32 incl. current
                      active: torch.Tensor,       # [B] bool
                      temperature: torch.Tensor,  # [B]
                      top_p: torch.Tensor,        # [B]
                      top_k: torch.Tensor,        # [B]
                      generator: Optional[torch.Generator],
                      n_steps: int,
                      sampling_flags: Tuple[bool, bool, bool] = (
                          False, True, True),
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """n_steps decode iterations with on-device sampling and device-side
    token chaining: the host never reads a token before launching the
    next block. Returns (block [B, n_steps + 1], last tokens [B]) where
    block[:, 0] echoes the input tokens and block[:, 1:] are the sampled
    ones. Inactive slots do not advance. Sequences must have page
    capacity for n_steps more tokens."""
    sp = SamplingParams(temperature, top_p, top_k)
    all_greedy, any_top_k, any_top_p = sampling_flags
    tokens = last_tokens
    out = [tokens]
    for _ in range(n_steps):
        logits = _decode_once(params, cfg, pool, tokens, page_tables,
                              lengths)
        nxt = sample(logits, sp, generator, all_greedy=all_greedy,
                     any_top_k=any_top_k, any_top_p=any_top_p)
        tokens = torch.where(active, nxt, tokens)
        out.append(tokens)
        lengths = torch.where(active, lengths + 1, lengths)
    return torch.stack(out, dim=1), tokens


@torch.no_grad()
def prefill_chunk_step(params: Params, cfg: LlamaConfig, cache: KVCache,
                       tokens: torch.Tensor,   # [1, C] (padded chunk)
                       valid: int):
    """One chunk of a long prompt through the scratch cache: k/v written
    in place at absolute positions cache.lengths + i, queries at
    q_offset = cache.lengths. Returns (logits of the last valid token
    [V], cache); only that row goes through the final norm and head."""
    dev = tokens.device
    new_len = torch.full((1,), valid, dtype=torch.int32, device=dev)
    x, cache = forward_hidden(params, cfg, tokens.long(), kv_cache=cache,
                              lengths=new_len)
    last = x[:, valid - 1:valid]                       # [1, 1, D]
    return logits_from_hidden(cfg, params, last)[0, 0], cache


@torch.no_grad()
def prefill_chunk_sample_step(params: Params, cfg: LlamaConfig,
                              cache: KVCache,
                              tokens: torch.Tensor,       # [1, C] final chunk
                              valid: int,
                              last_tokens: torch.Tensor,  # [B] device tokens
                              slot_idx: int,
                              temperature: float, top_p: float, top_k: int,
                              generator: Optional[torch.Generator] = None,
                              sampling_flags: Tuple[bool, bool, bool] = (
                                  True, False, False)):
    """The chunk that COMPLETES a prompt, its first-token sample and the
    last_tokens write, with no host read between them (the
    fused_sampling tail). Returns (tok0 [1], last_tokens, cache)."""
    logits, cache = prefill_chunk_step(params, cfg, cache, tokens, valid)
    all_greedy, any_top_k, any_top_p = sampling_flags
    sp = SamplingParams.make(1, temperature, top_p, top_k,
                             device=logits.device)
    tok0 = sample(logits[None, :], sp, generator, all_greedy=all_greedy,
                  any_top_k=any_top_k, any_top_p=any_top_p)   # [1] int32
    last_tokens[slot_idx:slot_idx + 1] = tok0.to(last_tokens.dtype)
    return tok0, last_tokens, cache


@torch.no_grad()
def cache_to_pool(pool: Pool, cache: KVCache, cfg: LlamaConfig,
                  table_row: torch.Tensor) -> Pool:
    """Scatter a finished scratch cache (batch 1, S_total a multiple of
    the page size) into the pool pages named by table_row
    [S_total // page_size], in place; entries 0 land in the sink. An int8
    pool takes each layer's rows quantized, one layer at a time."""
    ps = pool.page_size
    L, _, KH, S, Hd = cache.k.shape
    if S % ps:
        raise ValueError(f"scratch cache length {S} not a multiple of "
                         f"page_size {ps}")
    rows = table_row.long()
    if pool.quantized:
        for layer in range(L):
            _write_prefill_pages(pool, layer, cache.k[layer],
                                 cache.v[layer], rows)
        return pool
    pool.k[:, :, rows] = cache.k[:, 0].reshape(L, KH, S // ps, ps, Hd).to(
        pool.k.dtype)
    pool.v[:, :, rows] = cache.v[:, 0].reshape(L, KH, S // ps, ps, Hd).to(
        pool.v.dtype)
    return pool
