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

Greedy self-speculation (`decode_spec_multi_step`): each verify step
drafts k tokens per row from an n-gram lookup over the device token
history (`ngram_draft`; M branches with `ngram_tree_draft`), runs the
current token and the drafts through one forward, and commits the
accepted prefix plus one bonus token, so every step emits exactly the
greedy continuation. Linear verify attends through K2 with the r
positions folded into its batch (bf16 pool) or through K4's `q_rep = r`
form (int8 pool); tree verify through K5 (bf16) or K4's tree form
(int8), after which `_tree_relocate_commit` moves the accepted branch's
k/v to consecutive slots. `decode_plain_spec_state_multi_step` is the
plain block a speculative engine runs while a sampled request is live.

The JAX steps donate the pool and return a new one; these update the
pool IN PLACE (`index_put_` per layer) and never copy it.
"""

from __future__ import annotations

import functools
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
from generativeaiexamples_tpu_torch.serving.paged_attention_tree import (
    paged_tree_attention_dispatch, paged_tree_attention_int8_dispatch)
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
        _write_rows(pool, layer, k[:, :, 0, :].transpose(0, 1),
                    v[:, :, 0, :].transpose(0, 1), page_idx, offset)
        q_new = q[:, :, 0, :].contiguous()
        if pool.quantized:
            out = paged_attention_int8(q_new, pool.kv, pool.s, page_tables,
                                       lengths, layer)
        else:
            out = paged_attention_dispatch(q_new, pool.k[layer],
                                           pool.v[layer], page_tables,
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


def _write_rows(pool: Pool, layer: int, k_new: torch.Tensor,
                v_new: torch.Tensor, page_idx: torch.Tensor,
                offset: torch.Tensor) -> None:
    """Write k/v rows [KH, B, r, Hd] into one layer's pool slice at
    (page_idx, offset) [B, r], in place; an int8 pool takes them
    quantized."""
    if pool.quantized:
        kq, ksc = quantize_kv(k_new, scale_dtype=pool.s.dtype)
        vq, vsc = quantize_kv(v_new, scale_dtype=pool.s.dtype)
        pool.kv[0, layer][:, page_idx, offset] = kq
        pool.kv[1, layer][:, page_idx, offset] = vq
        pool.s[0, layer][:, page_idx, offset] = ksc
        pool.s[1, layer][:, page_idx, offset] = vsc
        return
    pool.k[layer][:, page_idx, offset] = k_new.to(pool.k.dtype)
    pool.v[layer][:, page_idx, offset] = v_new.to(pool.v.dtype)


def _slot_pages(page_tables: torch.Tensor, slots: torch.Tensor, ps: int):
    """(page ids, offsets) [B, r] of pool slots [B, r]."""
    maxp = page_tables.shape[1]
    page_idx = torch.gather(page_tables.long(), 1,
                            (slots // ps).clamp(0, maxp - 1))
    return page_idx, slots % ps


# -- greedy self-speculation ----------------------------------------------
#
# One verify step runs the current token and k drafts through a single
# forward: one weight read for up to k + 1 committed tokens. Drafting is
# on the device (n-gram lookup over a device-resident token history), so
# a multi-step block still needs no host read. Greedy only: drafts are
# compared against argmax targets, so the emitted tokens are always the
# sequential greedy continuation and acceptance changes only the speed.


def ngram_draft(history: torch.Tensor, lengths: torch.Tensor,
                t0: torch.Tensor, k: int) -> torch.Tensor:
    """k draft tokens per row: the tokens FOLLOWING the most recent
    previous occurrence of the current token t0 in the row's history
    (t0 lives at history[b, lengths[b] - 1]); rows without one repeat
    t0. history [B, Hcap] int32, lengths [B], t0 [B] -> [B, k]."""
    _, Hcap = history.shape
    dev = history.device
    pos = torch.arange(Hcap, device=dev)[None, :]
    cur = (lengths.long() - 1)[:, None]
    m = (history == t0[:, None]) & (pos < cur)
    has = m.any(dim=1)
    last = torch.where(m, pos, -1).argmax(dim=1)
    gidx = (last[:, None] + torch.arange(1, k + 1, device=dev)[None, :]
            ).clamp(0, Hcap - 1)
    d = torch.gather(history, 1, gidx)
    return torch.where(has[:, None], d, t0[:, None].to(d.dtype))


def ngram_tree_draft(history: torch.Tensor, lengths: torch.Tensor,
                     t0: torch.Tensor, k: int,
                     n_branches: int) -> torch.Tensor:
    """Multi-branch n-gram lattice draft: branch m proposes the k tokens
    following the (m+1)-th most recent previous occurrence of t0 (branch
    0 is ngram_draft's chain). With n_branches >= 2 the LAST branch
    follows the most recent occurrence of the bigram (t_{-1}, t0)
    instead, or the next most recent one when that is branch 0's site.
    Branches without an occurrence repeat t0. Returns [B, n_branches,
    k]."""
    B, Hcap = history.shape
    dev = history.device
    pos = torch.arange(Hcap, device=dev)[None, :]
    cur = (lengths.long() - 1)[:, None]
    m = (history == t0[:, None]) & (pos < cur)
    occ = torch.topk(torch.where(m, pos, -1), n_branches, dim=1).values
    if n_branches >= 2:
        prev = torch.gather(history, 1, (cur - 1).clamp(min=0))  # t_{-1}
        hist_prev = torch.cat([torch.full((B, 1), -1, dtype=history.dtype,
                                          device=dev), history[:, :-1]], 1)
        m2 = m & (hist_prev == prev)
        occ2 = torch.topk(torch.where(m2, pos, -1), 2, dim=1).values
        best = torch.where(occ2[:, 0] == occ[:, 0], occ2[:, 1], occ2[:, 0])
        occ = torch.cat([occ[:, :n_branches - 1], best[:, None]], dim=1)
    has = occ >= 0
    gidx = (occ[:, :, None] + torch.arange(1, k + 1, device=dev)[None, None]
            ).clamp(0, Hcap - 1)
    d = torch.gather(history, 1, gidx.reshape(B, n_branches * k)).reshape(
        B, n_branches, k)
    return torch.where(has[:, :, None], d, t0[:, None, None].to(d.dtype))


def _decode_verify_once(params: Params, cfg: LlamaConfig, pool: Pool,
                        tokens: torch.Tensor,       # [B, r] t0 + drafts
                        page_tables: torch.Tensor,  # [B, maxp]
                        lengths: torch.Tensor       # [B] incl. t0
                        ) -> torch.Tensor:
    """One linear verify forward over r = k + 1 positions per sequence:
    their k/v are written at slots lengths-1 .. lengths-2+r
    (write-then-attend) and position i attends lengths + i tokens. A
    bf16/f32 pool folds the r positions into K2's batch; an int8 pool
    reads each sequence's pages once for all r through K4's q_rep = r
    form. Returns logits [B, r, V]. Rejected positions need no cleanup:
    the length never advances past the accepted prefix."""
    B, r = tokens.shape
    dev = tokens.device
    H, Hd = cfg.n_heads, cfg.head_dim
    offs = torch.arange(r, device=dev)[None, :]
    positions = (lengths.long() - 1)[:, None] + offs             # [B, r]
    page_idx, offset = _slot_pages(page_tables, positions, pool.page_size)
    cos, sin = rope_cos_sin(positions, Hd, cfg.rope_theta, cfg.rope_scaling)
    flat_tables = page_tables.repeat_interleave(r, dim=0)        # [B*r, maxp]
    flat_lengths = (lengths[:, None] + offs).reshape(-1).to(torch.int32)
    x = params["tok_emb"][tokens.long()].to(cfg.dtype)           # [B, r, D]
    for layer in range(cfg.n_layers):
        w = layer_weights(params, layer)
        h = rms_norm(x, w["ln1"], cfg.rms_eps)
        q, k, v = _project_qkv(cfg, h, w, cos, sin)              # [B, *, r, Hd]
        _write_rows(pool, layer, k.transpose(0, 1), v.transpose(0, 1),
                    page_idx, offset)
        qm = q.transpose(1, 2).contiguous()                      # [B, r, H, Hd]
        if pool.quantized:
            out = paged_attention_int8(qm, pool.kv, pool.s, page_tables,
                                       lengths, layer, q_rep=r)
        else:
            out = paged_attention_dispatch(
                qm.reshape(B * r, H, Hd), pool.k[layer], pool.v[layer],
                flat_tables, flat_lengths).reshape(B, r, H, Hd)
        x = _finish_block(cfg, x, out.transpose(1, 2), w)
    return _logits(cfg, params, x)


@functools.lru_cache(maxsize=None)
def _tree_layout(k: int, n_branches: int):
    """The packed (depth-k, M-branch) lattice: node 0 is the root (t0),
    node 1 + m*k + (d-1) is branch m's depth-d draft. Returns (depth
    [r], ancestor-or-self mask [r, r]) as numpy."""
    r = 1 + n_branches * k
    depth = np.zeros((r,), np.int32)
    anc = np.zeros((r, r), bool)
    anc[0, 0] = True
    for m in range(n_branches):
        for d in range(1, k + 1):
            j = 1 + m * k + (d - 1)
            depth[j] = d
            anc[j, 0] = True
            anc[j, j] = True
            for d2 in range(1, d):
                anc[j, 1 + m * k + (d2 - 1)] = True
    return depth, anc


def _tree_verify_once(params: Params, cfg: LlamaConfig, pool: Pool,
                      tokens: torch.Tensor,       # [B, r] packed tree
                      page_tables: torch.Tensor,  # [B, maxp]
                      lengths: torch.Tensor,      # [B] incl. the root
                      depth, anc_mask, spec_k: int,
                      n_branches: int) -> torch.Tensor:
    """One tree-verify forward over r packed nodes per sequence: node j's
    k/v are written at pool SLOT lengths-1+j, but its RoPE POSITION is
    lengths-1+depth[j] (its place in the sequence if its branch is
    accepted). Attention takes the packed ancestor mask: K5 over a bf16
    pool, K4's tree form over an int8 one (the gather references on the
    CPU). Returns logits [B, r, V]; `_tree_relocate_commit` then moves
    the accepted branch to consecutive slots."""
    B, r = tokens.shape
    dev = tokens.device
    lm1 = (lengths.long() - 1)[:, None]
    positions = lm1 + torch.as_tensor(depth, device=dev).long()[None, :]
    slots = lm1 + torch.arange(r, device=dev)[None, :]
    page_idx, offset = _slot_pages(page_tables, slots, pool.page_size)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    x = params["tok_emb"][tokens.long()].to(cfg.dtype)           # [B, r, D]
    for layer in range(cfg.n_layers):
        w = layer_weights(params, layer)
        h = rms_norm(x, w["ln1"], cfg.rms_eps)
        q, k, v = _project_qkv(cfg, h, w, cos, sin)              # [B, *, r, Hd]
        _write_rows(pool, layer, k.transpose(0, 1), v.transpose(0, 1),
                    page_idx, offset)
        q = q.contiguous()
        if pool.quantized:
            out = paged_tree_attention_int8_dispatch(
                q, pool.kv, pool.s, page_tables, lengths, anc_mask, spec_k,
                n_branches, layer)
        else:
            out = paged_tree_attention_dispatch(
                q, pool.k[layer], pool.v[layer], page_tables, lengths,
                anc_mask, spec_k, n_branches)
        x = _finish_block(cfg, x, out, w)                        # out [B, H, r, Hd]
    return _logits(cfg, params, x)


def _tree_relocate_commit(pool: Pool, cfg: LlamaConfig,
                          page_tables: torch.Tensor, lengths: torch.Tensor,
                          m_star: torch.Tensor, k: int) -> Pool:
    """Move the accepted branch m_star's k/v (every layer) from its packed
    tree slots to the consecutive slots lengths-1 .. lengths-1+k, in
    place; int8 pools move codes and scales verbatim. Source and
    destination overlap for m_star > 0, so every source row is gathered
    into a temporary before any is scattered. Branch 0 is the identity."""
    dev = lengths.device
    ps = pool.page_size
    d_ar = torch.arange(k + 1, device=dev)[None, :]
    src_node = torch.where(d_ar == 0, 0, 1 + m_star.long()[:, None] * k
                           + d_ar - 1)
    lm1 = (lengths.long() - 1)[:, None]
    src_pi, src_off = _slot_pages(page_tables, lm1 + src_node, ps)
    dst_pi, dst_off = _slot_pages(page_tables, lm1 + d_ar, ps)
    if pool.quantized:
        vals = pool.kv[:, :, :, src_pi, src_off]     # gathers: copies
        svals = pool.s[:, :, :, src_pi, src_off]
        pool.kv[:, :, :, dst_pi, dst_off] = vals
        pool.s[:, :, :, dst_pi, dst_off] = svals
        return pool
    kvals = pool.k[:, :, src_pi, src_off]
    vvals = pool.v[:, :, src_pi, src_off]
    pool.k[:, :, dst_pi, dst_off] = kvals
    pool.v[:, :, dst_pi, dst_off] = vvals
    return pool


@torch.no_grad()
def decode_spec_multi_step(params: Params, cfg: LlamaConfig, pool: Pool,
                           history: torch.Tensor,      # [B, Hcap] int32
                           last_tokens: torch.Tensor,  # [B] current token
                           dev_lengths: torch.Tensor,  # [B] incl. current
                           page_tables: torch.Tensor,  # [B, maxp]
                           active: torch.Tensor,       # [B] bool
                           n_steps: int, k: int, n_branches: int = 0):
    """n_steps verify steps: each drafts from the history (a k-chain, or
    an M-branch tree when n_branches > 1), verifies in one forward,
    commits the accepted prefix plus one bonus token (>= 1 token a
    step, exactly the greedy continuation), and chains tokens, lengths
    and history on the device. The pool and the history are updated in
    place. Returns (targets [B, n_steps, k+1], counts [B, n_steps],
    last_tokens, dev_lengths, history); the host emits
    targets[b, s, :counts[b, s]]. Inactive rows do not advance."""
    B = last_tokens.shape[0]
    dev = last_tokens.device
    Hcap = history.shape[1]
    bi = torch.arange(B, device=dev)[:, None]
    tree = n_branches > 1
    if tree:
        depth, anc = _tree_layout(k, n_branches)
    out_t, out_c = [], []
    for _ in range(n_steps):
        if tree:
            draft = ngram_tree_draft(history, dev_lengths, last_tokens, k,
                                     n_branches)                   # [B, M, k]
            logits = _tree_verify_once(
                params, cfg, pool,
                torch.cat([last_tokens[:, None],
                           draft.reshape(B, n_branches * k)], dim=1),
                page_tables, dev_lengths, depth, anc, k, n_branches)
            node_t = logits.argmax(dim=-1).to(torch.int32)
            t_root = node_t[:, 0]
            btarg = node_t[:, 1:].reshape(B, n_branches, k)
            ok = torch.cat([(draft[:, :, 0] == t_root[:, None])[..., None],
                            draft[:, :, 1:] == btarg[:, :, :-1]], dim=-1)
            accm = torch.cumprod(ok.int(), dim=-1).sum(dim=-1)     # [B, M]
            m_star = accm.argmax(dim=-1)                           # first max
            acc = torch.gather(accm, 1, m_star[:, None])[:, 0]
            sel_t = torch.gather(
                btarg, 1, m_star[:, None, None].expand(B, 1, k))[:, 0]
            # Every branch accepted at depth d agrees on the token there
            # (same context, same argmax), so the deepest-accepting
            # branch is still exactly greedy.
            targets = torch.cat([t_root[:, None], sel_t], dim=1)
            _tree_relocate_commit(pool, cfg, page_tables, dev_lengths,
                                  m_star, k)
        else:
            draft = ngram_draft(history, dev_lengths, last_tokens, k)
            logits = _decode_verify_once(
                params, cfg, pool,
                torch.cat([last_tokens[:, None], draft], dim=1),
                page_tables, dev_lengths)
            targets = logits.argmax(dim=-1).to(torch.int32)       # [B, r]
            acc = torch.cumprod((draft == targets[:, :-1]).int(),
                                dim=1).sum(dim=1)
        counts = torch.where(active, acc + 1, 0).to(torch.int32)
        bonus = torch.gather(targets, 1, acc[:, None].long())[:, 0]
        # The history gains the committed continuation at positions
        # len .. len+k; entries past the accepted prefix are provisional
        # and hidden by the length until overwritten.
        hpos = (dev_lengths.long()[:, None]
                + torch.arange(k + 1, device=dev)[None, :]).clamp(0, Hcap - 1)
        old = torch.gather(history, 1, hpos)
        history[bi, hpos] = torch.where(active[:, None], targets, old)
        dev_lengths = torch.where(active, dev_lengths + counts, dev_lengths)
        last_tokens = torch.where(active, bonus, last_tokens)
        out_t.append(targets)
        out_c.append(counts)
    return (torch.stack(out_t, dim=1), torch.stack(out_c, dim=1),
            last_tokens, dev_lengths, history)


@torch.no_grad()
def decode_plain_spec_state_multi_step(
        params: Params, cfg: LlamaConfig, pool: Pool,
        history: torch.Tensor,      # [B, Hcap] int32
        last_tokens: torch.Tensor,  # [B] current token
        dev_lengths: torch.Tensor,  # [B] device lengths incl. current
        page_tables: torch.Tensor,  # [B, maxp]
        active: torch.Tensor,       # [B] bool
        temperature: torch.Tensor, top_p: torch.Tensor, top_k: torch.Tensor,
        generator: Optional[torch.Generator], n_steps: int,
        sampling_flags: Tuple[bool, bool, bool] = (False, True, True)):
    """The plain decode block over a speculative engine's device state:
    the fallback while a sampled request is live (greedy verification
    cannot honour temperature > 0). decode_multi_step's loop, except that
    lengths come from the device and every sampled token is appended to
    the history (in place), so later verify steps draft from fresh
    state. Returns (block [B, n_steps+1], last_tokens, dev_lengths,
    history)."""
    B = last_tokens.shape[0]
    Hcap = history.shape[1]
    bi = torch.arange(B, device=last_tokens.device)
    sp = SamplingParams(temperature, top_p, top_k)
    all_greedy, any_top_k, any_top_p = sampling_flags
    tokens = last_tokens
    out = [tokens]
    for _ in range(n_steps):
        logits = _decode_once(params, cfg, pool, tokens, page_tables,
                              dev_lengths)
        nxt = sample(logits, sp, generator, all_greedy=all_greedy,
                     any_top_k=any_top_k, any_top_p=any_top_p)
        tokens = torch.where(active, nxt, tokens)
        out.append(tokens)
        hpos = dev_lengths.long().clamp(0, Hcap - 1)
        history[bi, hpos] = torch.where(active, tokens, history[bi, hpos])
        dev_lengths = torch.where(active, dev_lengths + 1, dev_lengths)
    return torch.stack(out, dim=1), tokens, dev_lengths, history


@torch.no_grad()
def set_history_rows(history: torch.Tensor, dev_lengths: torch.Tensor,
                     idxs: Sequence[int], tokens: torch.Tensor,
                     lengths: torch.Tensor, first_toks: torch.Tensor):
    """Write admitted prompts (tokens [N, S], padded) and the first token
    sampled at prefill (at column lengths[j] < Hcap) into the history
    rows idxs, and set dev_lengths there to lengths + 1 (the token at
    lengths-1 is the current one), in place. `idxs` is a host array;
    out-of-bounds rows (group padding) are dropped, as the JAX scatter's
    mode="drop" does. Returns (history, dev_lengths)."""
    idxs = np.asarray(idxs)
    B, Hcap = history.shape
    keep = np.flatnonzero((idxs >= 0) & (idxs < B))
    dev = history.device
    dst = torch.from_numpy(idxs[keep].astype(np.int64)).to(dev)
    src = torch.from_numpy(keep.astype(np.int64)).to(dev)
    width = min(tokens.shape[1], Hcap)
    history[dst, :width] = tokens.index_select(0, src)[:, :width].to(
        history.dtype)
    n = lengths.index_select(0, src).long()
    history[dst, n] = first_toks.index_select(0, src).to(history.dtype)
    dev_lengths[dst] = (n + 1).to(dev_lengths.dtype)
    return history, dev_lengths


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
