#!/usr/bin/env python3
"""On-card check of the PyTorch/H100 port (generativeaiexamples_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  1. env      the card's name and power limit (nvidia-smi), torch / CUDA
  2. build    nvcc builds every kernel (K1-K6) from csrc/, one process
              per source, all in parallel
  3. flash    K1 (csrc/flash_attention.cu) against `mha_reference` run in
              f32 on the same bf16 inputs, at Llama-3-8B prefill shapes
              (and the chunked lane's and a prefix-cache hit's q_offset
              shapes) plus ragged /
              q_offset / fully-masked / head_dim 64 cases; a second
              launch must give the same bits; SDPA (is_causal, or a
              boolean mask for lengths and q_offset) timed beside it
  4. paged    K2 (csrc/paged_attention.cu) against
              `paged_attention_reference` in f32, at 8B decode shapes
              (B=8 lengths 1…8191, B=1 at 6,000, B=8 at the serving
              phase's 17…129), head_dim 64, pages of 16 and 8 slots,
              and sharp scores whose maximum sits on each row's last page
              (every split and key slice must be rescaled); the sink
              page, poisoned with NaN, must stay unread and a second
              launch must give the same bits (the page axis split);
              loop and device time beside SDPA over pre-gathered K/V
  5. encoder  K3 (csrc/encoder_attention.cu) against
              `encoder_attention_reference` at arctic-embed-l (B=16,
              H=16, S=128/512) and reranker-base (B=8, H=12, S=256/512)
              shapes through the fused-QKV views bert.forward passes,
              ragged lengths with a lengths-0 row (must average V),
              contiguous q/k/v, and sharp scores whose maxima sit in
              each row's last 64 keys (the online softmax must
              rescale); a second launch must give the same bits;
              SDPA with a key-padding mask and K1's head_dim 64
              non-causal form timed beside it (loop and device time)
  6. paged_int8  K4 (csrc/paged_attention_int8.cu) against
              `paged_attention_int8_reference_fused` in f32 on the same
              codes and scales, row by row relative to each row's output,
              over a 2-layer fused pool read at layer 1: the 8B decode
              shape at B=8 and B=128, head_dim 64, a small page size, and
              rows whose largest score sits on their last page (the online
              softmax must rescale the earlier pages); NaN-poisoned scales
              in the sink page and in the table slots past each row's
              pages must not change it. Then its verify forms against
              `paged_attention_int8_rep_reference`, query by query: q_rep
              2 and 4 (linear k = 1, 3) and the (3, 4) tree at B = 8 and
              B = 128, the (3, 4) tree and q_rep 2 at the spec_int8
              burst's lengths, the (2, 8) tree, a late_max tree and a
              head_dim 64 / page 16 tree. A second launch must give the
              same bits (the B = 8 cases split the page axis and merge);
              loop and device time beside the byte bound and SDPA over
              K/V gathered and dequantized beforehand (a yardstick)
  6b. tree    K5 (csrc/paged_attention_tree.cu) against
              `paged_tree_attention_reference` in f32, node by node: the
              8B shape (B=8, lengths 1…8191, (3, 4)), (2, 8) at head_dim
              64 / page 16 (with a length-1 row) and at 8B, (3, 4) at
              page 8, and a late_max case, with a NaN-poisoned sink page
              and tail slots; a second launch must give the same bits;
              loop and device time beside SDPA with a boolean mask over
              pre-gathered K/V
  7. int8_matmul  K6 (csrc/int8_matmul.cu) against
              `int8_matmul_reference` in f32 at every 8B projection shape
              (K, M) and R = 8, 128 (decode), 256, 1664 (linear and tree
              verify at batch 128), 4096 (prefill), plus a ragged R and a
              ragged M; a second launch must give the same bits (split-K
              included); torch.matmul over a pre-dequantized bf16 weight
              timed beside it as a yardstick
  8. model    a 2-layer bf16 model with 8B head geometry, run through the
              engine's prefill and decode steps on the card, against the
              plain f32 forward on the CPU over the same weights; then
              its int8 variant (int8 weights, int8 pool: K6, K4) against
              the same steps in f32 on the CPU over the same codes. In
              both, a linear (k = 3) and a tree ((3, 4)) verify step
              against the same step in f32 on the CPU: logits within the
              tolerance, targets equal wherever the f32 top-2 margin
              exceeds twice it
  9. serving  LLMEngine at Llama-3-8B geometry (random weights from a
              seed, bf16, default engine config) behind the port's
              OpenAI server on a local port: one streaming chat
              completion, one non-streaming completion, 4 concurrent
              64-token completions (one of them sampled with temperature,
              top-k and top-p); K1's and K2's launch counts must rise.
              Then, outside the counted window, torch.profiler over one
              more 64-token completion: device idle share and device
              time by kernel name
  10. chunked a ~6,000-token completion through the same server (chunked
              prefill beyond the 4096 bucket; K1 must launch), and the
              chunk steps' first-token logits against a one-shot forward;
              then engine.prefill_decode_k_cap: three greedy streams
              decode while the prompt prefills (at the default
              prefill_chunks_per_block and at 1), every decode block
              dispatched while the lane is live must take K <= 2 and the
              streams must equal the same requests run alone
  11. rag     the chain server (developer_rag, device store, ranked
              hybrid retrieval) over the same 8B engine with
              arctic-embed-l and BERT-base reranker encoders: ingest of
              ~2,000 chunks of the repository's prose, /search and a
              1M-row device store against exact host MIPS, two
              knowledge-base /generate answers (tokens generated, no
              error frame); K3's launches must equal encoder layers x
              forwards, K1 and K2 must launch
  11a. chain  over the RAG phase's encoders and 2,001-chunk store and the
              same engine, tracing on: 64 distinct corpus queries to
              /search one at a time with micro-batching off, then all at
              once with serving.microbatch_enabled (results held to exact
              host MIPS, ids equal, fewer forwards, K3 launches = layers x
              forwards, the coalesced query embeddings compared bit for
              bit); 16 concurrent traced knowledge-base answers (one with
              a traceparent; every generate span shares its trace with one
              llm.local and one engine.generate span; the TTFT split from
              the spans; the reranker's batcher must coalesce); 2 answers
              with query augmentation (rewrite, hyde, multi_query: one
              embed_queries forward, one search_batch) and the fact check
              (a "[fact-check] " frame and a verdict); K1, K2, K3 launch
  12. serving_int8  after the bf16 engine and the stores are released:
              an LLMEngine at Llama-3-8B geometry, random weights from
              seed 0 quantized at load, in the documented int8 deployment
              (int8 weights and KV, batch 128, page 128, max_seq 8192),
              with one cut (4,097 pool pages); 128 concurrent greedy
              64-token completions and one ~6,000-token chunked prompt
              behind the OpenAI server. K6, K4 and K1 must launch, K2
              not. Then, with the engine stopped, four free pages of its
              int8 pool through pool_to_pages, host memory and
              pages_to_pool: codes and scales must come back bit-identical
  11b. spec_bf16  (before the bf16 engine goes) a tree engine (k = 3,
              M = 4, batch 8) over the same bf16 weights: 8 concurrent
              64-token completions, one sampled, so dispatches fall back
              to plain decode while it is live; K5 must launch, K2 only
              through the fallback
  11c. prefix  (before the bf16 engine goes) an engine with the prefix
              cache and the KV pager (batch 8, page 128, 257 pool pages,
              a quarter of them cacheable, 512 MB of host tier) over the
              same weights: a 1,536-token shared prefix with 8 questions
              (each hit prefills only its suffix through K1's q_offset
              form; TTFT cold against hits; then all 8 at once), and 12
              1,024-token sessions run twice each, the first three
              resumed from host RAM and the spill file: promoted pages
              must equal their copy taken before demotion bit for bit and
              the resumed streams the resident hits'; K1 and K2 must
              launch
  13. spec_int8  over serving_int8's quantized weights, two speculative
              engines in turn in the same deployment: k = 3, M = 4 (tree)
              and k = 1 (linear), each with serving_int8's 128-request
              burst; every request must finish with its tokens; K4 and
              K6 must launch, K2 and K5 not; spec_tokens_per_step,
              tokens/s, TTFT, peak memory and the share of streams equal
              to serving_int8's are printed; the tree engine's burst
              runs again under the profiler (outside the counted window)
              for the split of a verify step between K4, K6, the other
              device work and the host
  13b. checkpoint  serve from disk, after every phase above: the served
              bf16 8B engine's weights (kept when its engine went) written
              as an HF snapshot (4 shards + index, 16.06 GB under the
              ignored build/, free disk checked first) and the RAG
              phase's encoders as two BERT snapshots; load_tokenizer's
              gate on the weights-only snapshot; the encoders loaded
              (trees, embeddings and scores bit-identical to the
              in-memory ones; K3); load_llama in bf16 (time, GB/s, peak
              device memory; every leaf bit-identical), build_engine from
              the path behind the OpenAI server (a streaming chat and 4
              concurrent 64-token greedy completions equal to the served
              engine's tokens; K1, K2), the chain over it (PDF and HTML
              through /documents into a persisted store, reloaded; the
              RAG phase's 2,001-chunk store saved and reloaded, equal
              hits); load_llama(quantize=True) (codes and scales
              bit-identical to the loader's quantizer on the card and, at
              layer 0, to the JAX loader's numpy arithmetic; peak device
              memory at most the int8 tree plus one bf16 layer of the
              largest leaf) and the int8 deployment from the path (K6,
              K4, no K2). The snapshots are removed at the end
  14. kernels one line {"kernels": [...]} with each kernel's parity,
              launches on its path (K1, K2: serving; K3: rag; K4, K6:
              serving_int8; K5: spec_bf16), times and bound; K1-K3 also
              their launches on the chain phase; K4's entry
              also carries its verify cases and its spec_int8 launches,
              K1's and K2's their prefix launches, every kernel its
              launches on the checkpoint phase's loaded models
  15. the card's name and power limit, then the last line
              {"ok": true, "device": {...}}

It imports neither jax nor the JAX package. Without CUDA, or without the
port's package beside it, it exits non-zero and prints no result.

    python3 chip_smoke.py --compare-parent DIR

times K1-K6 (AB_FLASH, K2's, K3's, K4's and K5's timed cases, every K6
case) through the public wrappers of the tree at DIR and of this one, in
turns (DIR, this, this, DIR), each in its own process on the same card,
and prints the four times per case.

    python3 chip_smoke.py --variants

times K4, K2 and K5 under other launch plans (key slices, stage size,
pages per split) beside the shipped plan, each checked against its plain
version, in one process.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import struct
import subprocess
import sys
import threading
import time
import urllib.request

# H100 SXM peaks (NVIDIA data sheet) for the roofline bound.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# bf16 parity tolerance for unit-scale inputs: the kernels round their
# output to bf16 (half an ulp is 2^-9 ~ 2e-3 at |x| < 1) and K1 also
# rounds the softmax probabilities to bf16 before the P.V product; 2e-2
# leaves a 5-10x margin over that while still catching any indexing or
# masking fault (those give O(1) errors).
BF16_ATOL = 2e-2

# First-token logits of the chunked lane against the one-shot forward
# (phase_chunked): both sides bf16 on the card, same weights and kernels;
# see phase_chunked for why they can differ at all.
CHUNK_LOGIT_ATOL = 5e-2

K1_REPLACES = "generativeaiexamples_tpu/ops/attention.py:233 (_flash_kernel)"
K2_REPLACES = ("generativeaiexamples_tpu/serving/paged_attention.py:266 "
               "(_paged_kernel)")
K3_REPLACES = ("generativeaiexamples_tpu/ops/encoder_attention.py:96 "
               "(_encoder_kernel)")
K4_REPLACES = ("generativeaiexamples_tpu/serving/paged_attention_int8.py:386 "
               "(_int8_kernel)")
K5_REPLACES = ("generativeaiexamples_tpu/serving/paged_attention_tree.py:283 "
               "(_tree_kernel)")
K6_REPLACES = ("generativeaiexamples_tpu/ops/int8_matmul.py:91,109 "
               "(_kernel_fullk, _kernel)")

# K6 parity, relative to max |y| of the case: the kernel rounds its output
# to bf16 once (half an ulp is at most 2^-8 ~ 3.9e-3 of |y|) and sums in
# another order than the f32 reference; 1e-2 leaves a 2.5x margin while
# an indexing or scale fault gives O(1).
INT8_MM_RTOL = 1e-2

# K4 parity, per batch row and relative to that row's max |out|: the
# kernel rounds its output to bf16 once (half an ulp is at most 2^-8 ~
# 3.9e-3 of the value) and sums in another order than the f32 reference;
# 1e-2 leaves a 2.5x margin, while a wrong rescale of earlier pages by the
# online softmax is off by O(1) of the row. A fixed absolute tolerance
# would not do: under flat scores a long row's output is a mean over
# thousands of values, as small as 1e-2, and such a fault hides in it.
PAGED_INT8_RTOL = 1e-2
# q is scaled up so that the scores are sharp (std ~5 over the keys) and
# each row's output stays O(1) at every length, not a near-uniform mean.
PAGED_INT8_Q_SCALE = 8.0

# The int8 model's logits on the card (bf16 activations) against the same
# steps in f32 on the CPU over the same codes: the bf16 budget of phase
# model (5e-2), plus int8 KV codes that move by one where a bf16 k or v
# differs by a bf16 ulp from the f32 one and crosses a rounding boundary
# (one quantization step, amax / 127 of that row, in one element).
INT8_MODEL_ATOL = 1e-1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi rc {out.returncode}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def n_sms() -> int:
    """The card's SM count, as the K2, K4 and K5 wrappers pass it to
    their plans."""
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, calls: int = 50, batches: int = 5) -> float:
    """Host time of one call of `fn`: the least, over `batches` runs of
    `calls` calls (the card synchronised before each run), of the wall
    time per call. Where the card takes less time a call than the host,
    this is what the host spends in it; the least of the runs leaves out
    the other tenants of a shared host."""
    import torch

    best = float("inf")
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls)
    torch.cuda.synchronize()
    return best * 1e3


def host_profile(fn, calls: int = 100, top: int = 8) -> list:
    """Where the host's time in a call of `fn` goes: torch.profiler's CPU
    activities over `calls` calls, the `top` by self CPU time, as [µs a
    call, occurrences a call, name]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_cpu_time_total / calls, e.count / calls, e.key)
                   for e in prof.key_averages()), reverse=True)[:top]
    return [[us, n, key[:60]] for us, n, key in rows]


def device_ms(fn, kernel_function: str = "", iters: int = 10) -> float:
    """Device time of one call of `fn`, from torch.profiler: the self
    device time of the activities whose name holds `kernel_function`
    (all of them by default), over `iters` calls. Unlike time_ms it does
    not count host gaps between launches, so the two differ when the
    host, not the card, sets the pace of a launch loop."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if kernel_function in e.key:
            us += getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
    return us / 1e3 / iters


def bound(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 3: K1 ------------------------------------------------------------


def flash_case(name, B, H, KH, Sq, Sk, D, lengths, q_offset, causal=True,
               seed=0, timed=False):
    import torch

    from generativeaiexamples_tpu_torch.ops import attention as attn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, Sq, D), generator=g, device=dev).bfloat16()
    k = torch.randn((B, KH, Sk, D), generator=g, device=dev).bfloat16()
    v = torch.randn((B, KH, Sk, D), generator=g, device=dev).bfloat16()
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    off = torch.tensor(q_offset, dtype=torch.int32, device=dev)
    got = attn.flash_attention(q, k, v, causal=causal, lengths=ln,
                               q_offset=off)
    # A second launch on the same inputs must give the same bits.
    repeat_identical = bool(torch.equal(got, attn.flash_attention(
        q, k, v, causal=causal, lengths=ln, q_offset=off)))
    want = attn.mha_reference(q.float(), k.float(), v.float(), causal=causal,
                              lengths=ln, q_offset=off)
    torch.cuda.synchronize()
    # Rows with no valid key: the kernel writes zeros, the reference
    # averages V (documented in ops/attention.py); held separately.
    # Visible keys per query row: min(lengths, row position + 1).
    n_valid = ln.long().clamp(0, Sk)[:, None].expand(B, Sq)
    if causal:
        q_pos = torch.arange(Sq, device=dev)[None, :] + off.long()[:, None]
        n_valid = torch.minimum(n_valid, q_pos + 1)
    has_key = (n_valid > 0)[:, None, :, None]           # [B, 1, Sq, 1]
    diff = (got.float() - want).abs()
    err = float(torch.where(has_key, diff, torch.zeros_like(diff)).max())
    masked_nonzero = float(torch.where(has_key, torch.zeros_like(diff),
                                       got.float().abs()).max())
    finite = bool(torch.isfinite(got.float()).all())
    ok = (finite and err <= BF16_ATOL and masked_nonzero == 0.0
          and repeat_identical)
    rec = {"phase": "flash", "case": name, "B": B, "H": H, "KH": KH,
           "Sq": Sq, "Sk": Sk, "D": D, "max_abs_err": err, "tol": BF16_ATOL,
           "masked_rows_max_abs": masked_nonzero, "finite": finite,
           "repeat_identical": repeat_identical, "ok": ok}
    if timed:
        # Work this input needs: every (query row, visible key) pair costs
        # 4 * D flops per head (QK^T and PV); q read once, the output
        # written once, and the k/v rows below `lengths` read once.
        pairs = float(n_valid.clamp(min=0).sum())
        flops = 4.0 * D * H * pairs
        kv_rows = float(ln.long().clamp(0, Sk).sum())
        n_bytes = 2.0 * (2 * q.numel() + 2 * kv_rows * KH * D) + 8.0 * B
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, flops)
        rec["ms"] = time_ms(lambda: attn.flash_attention(
            q, k, v, causal=causal, lengths=ln, q_offset=off))
        rec["device_ms"] = device_ms(lambda: attn.flash_attention(
            q, k, v, causal=causal, lengths=ln, q_offset=off),
            "flash_fwd_kernel")
        rec["plain_ms"] = time_ms(lambda: attn.mha_reference(
            q, k, v, causal=causal, lengths=ln, q_offset=off), iters=5)
        rec["library_ms"], rec["library"] = flash_library_ms(
            q, k, v, causal, ln, off)
        rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
    del got, want, diff
    torch.cuda.empty_cache()
    return rec


def flash_library_ms(q, k, v, causal, lengths, q_offset):
    """(ms, call) of one SDPA call computing the same function on the
    same inputs: `is_causal` where lengths are full and there is no
    offset, else a boolean attn_mask [B, 1, Sq, Sk] holding lengths and
    the q_offset-shifted diagonal (built once, outside the timing). A row
    with no visible key differs (SDPA gives NaN there, K1 zeros), which
    does not change the work."""
    import torch
    import torch.nn.functional as F

    B, _, Sq, _ = q.shape
    Sk = k.shape[2]
    if causal and bool((lengths == Sk).all()) and not bool(q_offset.any()):
        return time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)), \
            "SDPA is_causal"
    kv_pos = torch.arange(Sk, device=q.device)[None, None, None, :]
    mask = kv_pos < lengths.long()[:, None, None, None]
    if causal:
        q_pos = (torch.arange(Sq, device=q.device)[None, None, :, None]
                 + q_offset.long()[:, None, None, None])
        mask = mask & (kv_pos <= q_pos)
    ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True))
    del mask
    return ms, "SDPA with a boolean attn_mask"


def phase_flash():
    cases = [
        # The serving phase's own prefill shape: a group of four short
        # prompts in the 128 bucket.
        flash_case("8b_s128_served", 4, 32, 8, 128, 128, 128,
                   [23, 41, 17, 30], [0] * 4, seed=8, timed=True),
        flash_case("8b_s512", 4, 32, 8, 512, 512, 128, [512] * 4, [0] * 4,
                   seed=1, timed=True),
        flash_case("8b_s2048", 4, 32, 8, 2048, 2048, 128, [2048] * 4,
                   [0] * 4, seed=2, timed=True),
        # The chunked lane's second chunk of a 6,000-token prompt: 1,904
        # valid queries in a 2,048-wide chunk at q_offset 4,096 over an
        # 8,192-row scratch cache.
        flash_case("8b_chunk_q_offset", 1, 32, 8, 2048, 8192, 128, [6000],
                   [4096], seed=9, timed=True),
        # A prefix-cache hit on a fully cached 1,536-token prompt: capped
        # at plen - 1, one suffix token at q_offset 1,535 (mid-tile) in a
        # 128-wide chunk over a 2,048-row scratch cache.
        flash_case("8b_hit_q_offset", 1, 32, 8, 128, 2048, 128, [1536],
                   [1535], seed=10, timed=True),
        flash_case("ragged", 4, 32, 8, 200, 200, 128, [200, 137, 1, 64],
                   [0] * 4, seed=3),
        flash_case("q_offset", 4, 32, 8, 128, 512, 128, [512, 128, 228, 328],
                   [384, 0, 100, 200], seed=4),
        flash_case("masked_row", 2, 32, 8, 128, 128, 128, [0, 100], [0, 0],
                   seed=5),
        flash_case("hd64", 2, 32, 8, 256, 256, 64, [256, 77], [0, 0], seed=6),
        flash_case("noncausal", 2, 8, 8, 96, 160, 128, [160, 33], [0, 0],
                   causal=False, seed=7),
    ]
    for c in cases:
        emit(c)
    return cases


# -- phase 4: K2 ------------------------------------------------------------


def _paged_inputs(B, H, KH, Hd, ps, maxp, lengths, seed, q_scale=1.0,
                  late_max=False):
    """K2's inputs: bf16 q [B, H, Hd], two layers of bf16 pages [2, KH,
    P, ps, Hd] (k and v), a table naming shuffled pages with its tail
    slots at sink page 0, int32 lengths. `late_max` gives each row's last
    slot (on its last page) a k that matches its query group, so that the
    row's largest score comes last and every earlier page, split and key
    slice must be rescaled."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = B * maxp + 1
    q = (torch.randn((B, H, Hd), generator=g, device=dev)
         * q_scale).bfloat16()
    kp = torch.randn((2, KH, n_pages, ps, Hd), generator=g,
                     device=dev).bfloat16()
    vp = torch.randn((2, KH, n_pages, ps, Hd), generator=g,
                     device=dev).bfloat16()
    perm = torch.randperm(n_pages - 1, generator=g, device=dev) + 1
    table = torch.zeros((B, maxp), dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(lengths):
        need = -(-n // ps)
        table[b, :need] = perm[used:used + need].int()
        used += need
    if late_max:
        group_q = q.float().reshape(B, KH, H // KH, Hd).sum(2)
        for b, n in enumerate(lengths):
            page = int(table[b, (n - 1) // ps])
            kp[:, :, page, (n - 1) % ps] = (
                torch.sign(group_q[b]) * 4).bfloat16()
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, table, ln


def paged_case(name, B, H, KH, Hd, ps, maxp, lengths, seed=0, timed=False,
               q_scale=1.0, late_max=False):
    """K2 against `paged_attention_reference` in f32 on the same bf16
    inputs (layer 1 of a two-layer pool), within BF16_ATOL. Tail table
    slots point at sink page 0; after the parity check the sink is
    poisoned with NaN and the kernel's result must not change (it never
    reads those slots). A second launch must give the same bits (the
    page axis split across CTAs and merged included)."""
    import torch

    from generativeaiexamples_tpu_torch.serving import paged_attention as pa

    q, kp2, vp2, table, ln = _paged_inputs(B, H, KH, Hd, ps, maxp, lengths,
                                           seed, q_scale, late_max)
    kp, vp = kp2[1], vp2[1]
    got = pa.paged_attention(q, kp, vp, table, ln)
    repeat = bool(torch.equal(got, pa.paged_attention(q, kp, vp, table, ln)))
    want = pa.paged_attention_reference(q.float(), kp.float(), vp.float(),
                                        table, ln)
    # Tail slots point at sink page 0: poison it and require a
    # bit-identical result, i.e. the kernel never reads those slots.
    kp_sink, vp_sink = kp[:, 0].clone(), vp[:, 0].clone()
    kp[:, 0] = float("nan")
    vp[:, 0] = float("nan")
    poisoned = pa.paged_attention(q, kp, vp, table, ln)
    kp[:, 0], vp[:, 0] = kp_sink, vp_sink
    torch.cuda.synchronize()
    err = float((got.float() - want).abs().max())
    sink_unread = bool(torch.equal(poisoned, got))
    finite = bool(torch.isfinite(got.float()).all())
    ok = finite and sink_unread and repeat and err <= BF16_ATOL
    plan = pa.paged_bf16_plan(B, KH, H // KH, Hd, ps, maxp, n_sms())
    rec = {"phase": "paged", "case": name, "B": B, "H": H, "KH": KH,
           "Hd": Hd, "ps": ps, "maxp": maxp, "lengths": lengths,
           "q_scale": q_scale, "late_max": late_max,
           "max_abs_err": err, "tol": BF16_ATOL,
           "max_abs_out": float(want.abs().max()),
           "sink_unread": sink_unread, "repeat_identical": repeat,
           "plan": plan._asdict(), "finite": finite, "ok": ok}
    if timed:
        tokens = float(sum(lengths))
        # K/V of the tokens this input attends (not whole pages), the
        # query and output once, plus the table and lengths.
        n_bytes = 2.0 * (2 * tokens * KH * Hd + 2 * q.numel()) \
            + 4.0 * (table.numel() + B)
        flops = 4.0 * Hd * H * tokens
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, flops)
        # Alternate the two layers so that one call's pages are not in L2
        # for the next (the decode path reads another layer every call).
        turn = [0]

        def alternating():
            turn[0] ^= 1
            pa.paged_attention(q, kp2[turn[0]], vp2[turn[0]], table, ln)

        rec["ms"] = time_ms(alternating)
        rec["device_ms"] = device_ms(alternating,
                                     KERNEL_FUNCTIONS["paged_attention"])
        rec["host_ms"] = host_ms(alternating)
        rec["host_profile"] = host_profile(alternating)
        rec["plain_ms"] = time_ms(lambda: pa.paged_attention_reference(
            q, kp, vp, table, ln), iters=5)
        # No single torch call takes a page table; SDPA over K/V gathered
        # beforehand (gather not timed) is kept as a dense yardstick only.
        rec["library_ms"] = None
        rec["sdpa_gathered_ms"], rec["sdpa_gathered_device_ms"] = \
            paged_sdpa_gathered_ms(q, kp, vp, table, ln)
        rec["gbytes_per_s"] = n_bytes / (rec["device_ms"] * 1e-3) / 1e9
    del kp2, vp2, got, poisoned, want
    torch.cuda.empty_cache()
    return rec


def paged_sdpa_gathered_ms(q, kp, vp, table, ln):
    """(loop ms, device ms) of SDPA with a lengths mask over K/V gathered
    through the table beforehand (the gather is not timed)."""
    import torch
    import torch.nn.functional as F

    B, H, Hd = q.shape
    KH, _, ps, _ = kp.shape
    maxp = table.shape[1]
    t = table.long()
    k = kp[:, t].permute(1, 0, 2, 3, 4).reshape(B, KH, maxp * ps, Hd)
    v = vp[:, t].permute(1, 0, 2, 3, 4).reshape(B, KH, maxp * ps, Hd)
    mask = (torch.arange(maxp * ps, device=q.device)[None, :]
            < ln[:, None])[:, None, None, :]

    def sdpa():
        F.scaled_dot_product_attention(q[:, :, None, :], k, v,
                                       attn_mask=mask, enable_gqa=True)

    return time_ms(sdpa), device_ms(sdpa)


# K2's timed cases at the 8B shape (H = 32, KH = 8, head_dim 128, page
# 128, 64 table slots): (name, B, lengths, seed).
K2_TIMED = (
    ("8b_decode", 8, [1, 17, 128, 129, 1000, 4096, 7000, 8191], 11),
    # The decode that follows the chunked phase's 6,000-token prompt.
    ("8b_b1_6000", 1, [6000], 14),
    # The serving phase's rows: short prompts and up to 64 new tokens;
    # the loop time is the host's.
    ("8b_short", 8, [17, 23, 30, 41, 64, 81, 100, 129], 15))


def phase_paged():
    cases = [paged_case(name, B, 32, 8, 128, 128, 64, lengths, seed=seed,
                        timed=True)
             for name, B, lengths, seed in K2_TIMED]
    cases += [
        paged_case("hd64", 4, 32, 8, 64, 128, 16, [1, 300, 1024, 2047],
                   seed=12),
        paged_case("ps16", 3, 8, 2, 128, 16, 32, [5, 16, 511], seed=13),
        # The smallest page the engine admits: a 16-key step holds two
        # pages, a ring stage eight; the page axis is split.
        paged_case("ps8", 4, 32, 8, 128, 8, 128, [1, 9, 300, 1023],
                   seed=16),
        # Sharp scores whose maximum sits on each row's last page: every
        # earlier page, key slice and split must be rescaled when merged.
        paged_case("sharp_late_max", 8, 32, 8, 128, 128, 64,
                   [129, 700, 1500, 2048, 3000, 4097, 6000, 8191], seed=17,
                   q_scale=PAGED_INT8_Q_SCALE, late_max=True),
    ]
    for c in cases:
        emit(c)
    return cases


# -- phase 5: K3 ------------------------------------------------------------


def _encoder_inputs(B, H, S, lengths, seed, fused, sharp=False):
    """K3's bf16 q, k, v [B, H, S, 64] (views of one [B, S, 3, H, 64]
    buffer when `fused`, as bert.forward passes them) and lengths.
    `sharp`: q and each row's last 64 keys below its length x 4 (exact
    in bf16), so scores there have std ~16 against ~4 before them: every
    query row's largest score lies in its last one or two key tiles,
    ~25 above the earlier tiles' running max, and the online softmax
    must rescale everything it has summed. V x 1/4 keeps the output, a
    mix of a few V rows, under 2 in magnitude, where a bf16 ulp (2^-7)
    stays well inside the absolute tolerance."""
    import torch

    D = 64
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    if fused:  # the q/k/v views bert.forward hands the kernel
        qkv = torch.randn((B, S, 3, H, D), generator=g, device=dev).bfloat16()
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    else:
        q, k, v = (torch.randn((B, H, S, D), generator=g,
                               device=dev).bfloat16() for _ in range(3))
    if sharp:
        q.mul_(4)
        v.mul_(0.25)
        for b, n in enumerate(lengths):
            n = min(max(n, 1), S)
            k[b, :, max(n - 64, 0):n].mul_(4)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)


def encoder_case(name, B, H, S, lengths, seed=0, fused=False, timed=False,
                 sharp=False):
    """K3 against `encoder_attention_reference` on the same bf16 inputs
    (the plain version rounds P and the output to bf16 where the kernel
    does). A lengths-0 row must average V like the plain version, and a
    second launch must give the same bits. `sharp`: see _encoder_inputs."""
    import torch
    import torch.nn.functional as F

    from generativeaiexamples_tpu_torch.ops import attention as attn
    from generativeaiexamples_tpu_torch.ops import encoder_attention as ea

    D = 64
    q, k, v, ln = _encoder_inputs(B, H, S, lengths, seed, fused, sharp)
    got = ea.encoder_attention(q, k, v, ln)
    want = ea.encoder_attention_reference(q, k, v, ln)
    repeat = bool(torch.equal(got, ea.encoder_attention(q, k, v, ln)))
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    zero_rows = [b for b, n in enumerate(lengths) if n <= 0]
    zero_err = max((float((got[b].float() - v[b].float().mean(
        dim=1, keepdim=True)).abs().max()) for b in zero_rows), default=None)
    finite = bool(torch.isfinite(got.float()).all())
    ok = finite and repeat and err <= BF16_ATOL and (
        zero_err is None or zero_err <= BF16_ATOL)
    rec = {"phase": "encoder", "case": name, "B": B, "H": H, "S": S,
           "D": D, "fused_qkv_view": fused, "sharp": sharp,
           "max_abs_out": float(want.float().abs().max()), "max_abs_err": err,
           "zero_length_rows": zero_rows, "zero_row_vs_v_mean": zero_err,
           "tol": BF16_ATOL, "repeat_identical": repeat, "finite": finite,
           "ok": ok}
    if timed:
        # Work this input needs: every query row against the keys below
        # its lengths (all S for a lengths-0 row); q and the output once,
        # k/v rows below lengths once.
        keys = [S if n <= 0 else min(n, S) for n in lengths]
        flops = 4.0 * D * H * S * sum(keys)
        n_bytes = 2.0 * (2 * q.numel() + 2 * H * D * sum(keys)) + 4.0 * B
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, flops)

        def kernel():
            ea.encoder_attention(q, k, v, ln)

        rec["ms"] = time_ms(kernel)
        rec["device_ms"] = device_ms(kernel, KERNEL_FUNCTIONS[
            "encoder_attention"])
        rec["plain_ms"] = time_ms(
            lambda: ea.encoder_attention_reference(q, k, v, ln), iters=5)
        mask = (torch.arange(S, device=q.device)[None, :]
                < ln[:, None])[:, None, None, :]

        def library():
            F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        rec["library_ms"] = None if zero_rows else time_ms(library)
        rec["library_device_ms"] = None if zero_rows else device_ms(library)
        # K1's head_dim 64 non-causal form with lengths, for information
        # (it writes zeros on a lengths-0 row, so it is no substitute).
        rec["k1_d64_ms"] = time_ms(lambda: attn.flash_attention(
            q, k, v, causal=False, lengths=ln))
        rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
    del got, want
    torch.cuda.empty_cache()
    return rec


# K3's timed cases: (name, B, H, S, lengths, seed), all through the
# fused-QKV views. arctic-embed-l (B=16, H=16): the ingest shape and a
# short one; reranker-base (B=8, H=12): its RAG shape (a query plus a
# ~508-token chunk mostly fill the 512 bucket, shorter tails do not) and
# a shorter bucket.
def _encoder_timed_cases():
    import numpy as np

    rng = np.random.default_rng(5)
    rng.integers(1, 513, 16)  # the ragged case's draw comes first
    rerank_lengths = [512] * 5 + rng.integers(1, 512, 3).tolist()
    return (("arctic_s512", 16, 16, 512, [512] * 16, 1),
            ("arctic_s128", 16, 16, 128, [128] * 16, 2),
            ("reranker_s512", 8, 12, 512, rerank_lengths, 7),
            ("reranker_s256", 8, 12, 256, [256] * 8, 3))


def phase_encoder():
    import numpy as np

    rng = np.random.default_rng(5)
    ragged = rng.integers(1, 513, 16).tolist()
    ragged[3] = 0
    cases = [encoder_case(name, B, H, S, ln, seed=seed, fused=True,
                          timed=True)
             for name, B, H, S, ln, seed in _encoder_timed_cases()]
    cases += [
        # Contiguous q/k/v (the wrapper takes any strides).
        encoder_case("ragged_zero_row", 16, 16, 512, ragged, seed=4),
        encoder_case("fused_qkv_view", 8, 12, 256,
                     [256, 0, 1, 100, 17, 255, 64, 200], seed=5, fused=True),
        encoder_case("odd_s", 2, 2, 33, [0, 20], seed=6),
        # Sharp scores whose maximum lies in each row's last key tile.
        encoder_case("sharp_late_max", 8, 4, 512,
                     [512, 449, 300, 65, 130, 511, 64, 200], seed=8,
                     fused=True, sharp=True),
    ]
    for c in cases:
        emit(c)
    return cases


# -- phase 6: K4 ------------------------------------------------------------


def _verify_pairs(lengths, R, tree, cap):
    """(query row, visible kv slot) pairs per query head, and kv slots
    read, of a verify form over these lengths: query j of row b sees
    len - 1 prefix slots plus its ancestor-or-self nodes (j + 1 of them
    for the linear form); the span read is min(len + R - 1, cap)."""
    import numpy as np

    from generativeaiexamples_tpu_torch.serving.paged_attention_tree import (
        _canonical_tree)

    seen = (_canonical_tree(*tree).sum(1) if tree is not None
            else np.arange(1, R + 1))
    pairs = sum(R * (max(n, 1) - 1) + int(seen.sum()) for n in lengths)
    slots = sum(min(max(n, 1) + R - 1, cap) for n in lengths)
    return float(pairs), float(slots)


def _paged_int8_inputs(B, H, KH, Hd, ps, maxp, lengths, L, layer, seed,
                       late_max, R):
    """K4's inputs: bf16 q [B, H, Hd] ([B, R, H, Hd] for R > 1), the full
    L-layer fused pool and f32 scales, a table naming shuffled pages
    (tail slots at page P - 1, never assigned), int32 lengths."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    P = B * maxp + 2              # page P - 1: never assigned, poisoned
    q = (torch.randn((B, R, H, Hd), generator=g, device=dev)
         * PAGED_INT8_Q_SCALE).bfloat16()
    if R == 1:
        q = q[:, 0]
    kv = torch.randint(-127, 128, (2, L, KH, P, ps, Hd), generator=g,
                       device=dev, dtype=torch.int8)
    sc = (torch.rand((2, L, KH, P, ps), generator=g, device=dev) + 0.5) / 127
    perm = torch.randperm(P - 2, generator=g, device=dev) + 1
    table = torch.full((B, maxp), P - 1, dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(lengths):
        need = min(-(-(max(n, 1) + R - 1) // ps), maxp)
        table[b, :need] = perm[used:used + need].int()
        used += need
    if late_max:
        group_q = q.float().reshape(B, R, KH, H // KH, Hd).sum((1, 3))
        for b, n in enumerate(lengths):
            t = max(n, 1) - 1
            page = int(table[b, t // ps])
            kv[0, layer, :, page, t % ps] = (
                torch.sign(group_q[b]) * 127).to(torch.int8)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kv, sc, table, ln, P


def paged_int8_case(name, B, H, KH, Hd, ps, maxp, lengths, L=2, layer=1,
                    seed=0, timed=False, late_max=False, q_rep=1, tree=None):
    """K4 against its plain version in f32 on the same codes and scales,
    over the full L-layer fused pool read at `layer`, query by query
    (PAGED_INT8_RTOL of each (row, verify position)'s max |out|). With
    q_rep = R > 1 the R verify positions of each row (the packed nodes
    of `tree`) go through the kernel at once. Tail table slots point at
    an unused page; after the parity check the scales of that page and
    of sink page 0 are poisoned with NaN and the kernel's result must not
    change (it never reads them). A second launch must give the same
    bits (the page axis split across CTAs and merged included). `late_max`
    gives the slot every position sees last (the root, len - 1) a k that
    matches its query group, so the running max rises on the row's last
    page and the earlier pages' sums must be rescaled."""
    import torch

    from generativeaiexamples_tpu_torch.serving import (
        paged_attention_int8 as pa8)

    R = q_rep
    q, kv, sc, table, ln, P = _paged_int8_inputs(
        B, H, KH, Hd, ps, maxp, lengths, L, layer, seed, late_max, R)

    def kernel(lay=layer):
        return pa8.paged_attention_int8(q, kv, sc, table, ln, lay, q_rep=R,
                                        tree=tree)

    def plain(qq):
        if R == 1:
            return pa8.paged_attention_int8_reference_fused(
                qq, kv[:, layer], sc[:, layer], table, ln.clamp(min=1))
        return pa8.paged_attention_int8_rep_reference(
            qq, kv[:, layer], sc[:, layer], table, ln.clamp(min=1),
            tree=tree)

    got = kernel()
    want = plain(q.float())
    repeat = bool(torch.equal(got, kernel()))
    torch.cuda.synchronize()
    diff = (got.float() - want).abs().reshape(B * R, -1).amax(1)
    row_max = want.abs().reshape(B * R, -1).amax(1)
    err = float(diff.max())
    row_rel = float((diff / row_max).max())
    out_min = float(row_max.min())
    del want
    saved = sc[:, :, :, [0, P - 1]].clone()
    sc[:, :, :, [0, P - 1]] = float("nan")
    poisoned = kernel()
    sc[:, :, :, [0, P - 1]] = saved
    torch.cuda.synchronize()
    unread = bool(torch.equal(poisoned, got))
    finite = bool(torch.isfinite(got.float()).all())
    ok = finite and unread and repeat and row_rel <= PAGED_INT8_RTOL
    plan = pa8.paged_int8_plan(B, KH, (H // KH) * R, Hd, ps, maxp,
                               n_sms())
    rec = {"phase": "paged_int8", "case": name, "B": B, "H": H, "KH": KH,
           "Hd": Hd, "ps": ps, "maxp": maxp, "L": L, "layer": layer,
           "q_rep": R, "tree": list(tree) if tree else None,
           "lengths": lengths if len(lengths) <= 16 else
           {"n": len(lengths), "min": min(lengths), "max": max(lengths),
            "sum": sum(lengths)},
           "late_max": late_max, "max_abs_err": err,
           "max_row_rel_err": row_rel, "rtol": PAGED_INT8_RTOL,
           "min_row_max_abs_out": out_min,
           "sink_and_tail_unread": unread, "repeat_identical": repeat,
           "plan": plan._asdict(), "finite": finite, "ok": ok}
    if timed:
        pairs, slots = _verify_pairs(lengths, R, tree, maxp * ps)
        # Codes and scales of the slots read (k and v: 2 Hd bytes + 2 f32
        # a token and kv head), q and the output once (bf16), the table
        # and lengths.
        n_bytes = slots * KH * (2 * Hd + 8) + 2.0 * 2 * q.numel() \
            + 4.0 * (table.numel() + B)
        flops = 4.0 * Hd * H * pairs
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, flops)
        # Alternate the two layers so that one call's pages are not in L2
        # for the next (the decode path reads another layer every call).
        turn = [0]

        def alternating():
            turn[0] ^= 1
            kernel(turn[0])

        rec["ms"] = time_ms(alternating)
        rec["device_ms"] = device_ms(alternating, KERNEL_FUNCTIONS[
            "paged_attention_int8"])
        rec["plain_ms"] = time_ms(lambda: plain(q), iters=3, warmup=1)
        # No single torch call takes a page table and int8 pages; SDPA
        # over K/V gathered and dequantized beforehand (neither timed) is
        # kept as a dense yardstick only, as for K2 and K5.
        rec["library_ms"] = None
        rec["sdpa_gathered_ms"], rec["sdpa_gathered_device_ms"] = \
            paged_int8_sdpa_gathered_ms(q, kv[:, layer], sc[:, layer], table,
                                        ln, R, tree)
        rec["gbytes_per_s"] = n_bytes / (rec["ms"] * 1e-3) / 1e9
    del kv, sc, got, poisoned
    torch.cuda.empty_cache()
    return rec


def paged_int8_sdpa_gathered_ms(q, kv, sc, table, ln, R, tree):
    """(loop ms, device ms) of SDPA over one layer's K/V gathered through
    the table and dequantized to bf16 beforehand (neither is timed), with
    K4's visibility as a boolean mask: lengths for q_rep 1, `pos < len +
    j` for query j of the linear verify form, the prefix and the
    ancestor chain for a tree (`_tree_keep`, K4's plain version's)."""
    import torch
    import torch.nn.functional as F

    from generativeaiexamples_tpu_torch.serving.paged_attention import (
        _gather_pages)
    from generativeaiexamples_tpu_torch.serving.paged_attention_int8 import (
        _tree_keep)

    def deq(i):
        return (_gather_pages(kv[i], table).float()
                * _gather_pages(sc[i], table)[..., None]).bfloat16()

    k, v = deq(0), deq(1)                                  # [B, KH, S, Hd]
    S, dev = k.shape[2], q.device
    qq = (q[:, None] if R == 1 else q).transpose(1, 2)     # [B, H, R, Hd]
    pos = torch.arange(S, device=dev)[None, None, :]
    length = ln.long().clamp(min=1)[:, None, None]
    jrow = torch.arange(R, device=dev)[None, :, None]
    keep = (_tree_keep(pos, length, jrow, R, tree) if tree is not None
            else pos < length + jrow)                       # [B, R, S]
    mask = keep[:, None]

    def sdpa():
        F.scaled_dot_product_attention(qq, k, v, attn_mask=mask,
                                       enable_gqa=True)

    out = time_ms(sdpa), device_ms(sdpa)
    del k, v, mask
    return out


def _paged_int8_timed_cases():
    """K4's timed cases: (name, B, maxp, lengths, seed, q_rep, tree) at the
    8B shape (H = 32, KH = 8, head_dim 128, page 128)."""
    import numpy as np

    b128 = np.linspace(1, 4096, 128).astype(int).tolist()
    b8 = [1, 17, 128, 129, 1000, 4096, 7000, 8191]
    # The spec_int8 burst's rows midway through their 64 tokens: each
    # prompt's tokens (its bytes and BOS) plus 32, in the engine's
    # 64-slot table.
    burst = [len(p) + 1 + 32 for p in _int8_prompts(128)]
    cases = [
        # K2's 8B decode case, on the int8 pool.
        ("8b_decode", 8, 64, b8, 21, 1, None),
        # The documented int8 deployment's batch.
        ("8b_b128", 128, 32, b128, 22, 1, None)]
    # The verify forms: linear k = 1 (R = 2, the r05 config) and k = 3
    # (R = 4), and the (3, 4) tree (R = 13), at B = 8 (one more page of
    # table so the deepest node fits) and B = 128.
    for tag, R, tree in (("qrep2", 2, None), ("qrep4", 4, None),
                         ("tree34", 13, (3, 4))):
        cases.append((f"{tag}_b8", 8, 65, b8, 26, R, tree))
        cases.append((f"{tag}_b128", 128, 33, b128, 27, R, tree))
    cases += [("tree34_burst", 128, 64, burst, 31, 13, (3, 4)),
              ("qrep2_burst", 128, 64, burst, 32, 2, None)]
    return cases


def phase_paged_int8():
    cases = [paged_int8_case(name, B, 32, 8, 128, 128, maxp, ln, seed=seed,
                             timed=True, q_rep=R, tree=tree)
             for name, B, maxp, ln, seed, R, tree in _paged_int8_timed_cases()]
    cases += [
        paged_int8_case("hd64", 4, 32, 8, 64, 128, 16, [1, 300, 1024, 2047],
                        seed=23),
        # A small page, G = 4, and a length-0 row (clamped to 1).
        paged_int8_case("ps16", 3, 8, 2, 128, 16, 32, [0, 16, 511], seed=24),
        # Each row's largest score on its last page: the earlier pages'
        # sums must be rescaled by the online softmax.
        paged_int8_case("late_max", 8, 32, 8, 128, 128, 64,
                        [129, 700, 1500, 2048, 3000, 4097, 6000, 8191],
                        seed=25, late_max=True),
        paged_int8_case("tree28", 8, 32, 8, 128, 128, 65,
                        [1, 17, 128, 129, 1000, 4096, 7000, 8191], seed=28,
                        q_rep=17, tree=(2, 8)),
        paged_int8_case("tree34_late_max", 8, 32, 8, 128, 128, 65,
                        [129, 700, 1500, 2048, 3000, 4097, 6000, 8180],
                        seed=29, late_max=True, q_rep=13, tree=(3, 4)),
        paged_int8_case("tree28_hd64_ps16", 4, 8, 2, 64, 16, 64,
                        [1, 50, 300, 1000], seed=30, q_rep=17, tree=(2, 8)),
    ]
    for c in cases:
        emit(c)
    return cases


# -- phase 6b: K5 -----------------------------------------------------------

# K5 parity, per (row, node) and relative to that node's max |out|: the
# kernel rounds the probabilities to bf16 before P.V (as K1 does) and its
# output once, each at most 2^-9 relative, and sums in another order than
# the f32 reference; 1e-2 leaves a 2.5x margin, while a wrong ancestor or
# a wrong rescale of earlier chunks is off by O(1) of the node's output.
TREE_RTOL = 1e-2


def _tree_inputs(B, H, KH, Hd, ps, maxp, lengths, tree, seed, late_max):
    """K5's inputs: bf16 q [B, H, r, Hd] scaled as in the K4 cases, two
    layers of bf16 pages [2, KH, P, ps, Hd] (k and v), a table naming
    shuffled pages with its tail slots at page P - 1 (never assigned),
    int32 lengths. `late_max` puts each row's largest score at its root
    slot."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    r = 1 + tree[0] * tree[1]
    P = B * maxp + 2
    q = (torch.randn((B, H, r, Hd), generator=g, device=dev)
         * PAGED_INT8_Q_SCALE).bfloat16()
    kp = torch.randn((2, KH, P, ps, Hd), generator=g, device=dev).bfloat16()
    vp = torch.randn((2, KH, P, ps, Hd), generator=g, device=dev).bfloat16()
    perm = torch.randperm(P - 2, generator=g, device=dev) + 1
    table = torch.full((B, maxp), P - 1, dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(lengths):
        need = min(-(-(max(n, 1) + r - 1) // ps), maxp)
        table[b, :need] = perm[used:used + need].int()
        used += need
    if late_max:
        group_q = q.float().reshape(B, KH, H // KH, r, Hd).sum((2, 3))
        for b, n in enumerate(lengths):
            t = max(n, 1) - 1
            page = int(table[b, t // ps])
            kp[:, :, page, t % ps] = (torch.sign(group_q[b]) * 4).bfloat16()
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, table, ln, P


def tree_case(name, B, H, KH, Hd, ps, maxp, lengths, tree, seed=0,
              timed=False, late_max=False):
    """K5 against `paged_tree_attention_reference` in f32 on the same bf16
    inputs (layer 1 of a two-layer pool), node by node (TREE_RTOL of each
    (row, node)'s max |out|). After the parity check the unused page the
    tail slots name and sink page 0 are poisoned with NaN and the
    kernel's result must not change. A second launch must give the same
    bits (the span split across CTAs and merged included)."""
    import torch
    import torch.nn.functional as F

    from generativeaiexamples_tpu_torch.serving import paged_attention as pa
    from generativeaiexamples_tpu_torch.serving import (
        paged_attention_tree as pt)

    dev = torch.device("cuda")
    r = 1 + tree[0] * tree[1]
    q, kp2, vp2, table, ln, P = _tree_inputs(B, H, KH, Hd, ps, maxp, lengths,
                                             tree, seed, late_max)
    kp, vp = kp2[1], vp2[1]
    anc = pt._canonical_tree(*tree)
    got = pt.paged_tree_attention(q, kp, vp, table, ln, tree)
    repeat = bool(torch.equal(got, pt.paged_tree_attention(
        q, kp, vp, table, ln, tree)))
    want = pa.paged_tree_attention_reference(
        q.float(), kp.float(), vp.float(), table, ln.clamp(min=1), anc)
    torch.cuda.synchronize()
    per_node = lambda t: t.transpose(1, 2).reshape(B * r, -1)  # noqa: E731
    diff = per_node(got.float() - want).abs().amax(1)
    node_max = per_node(want).abs().amax(1)
    err = float(diff.max())
    node_rel = float((diff / node_max).max())
    del want
    saved = (kp[:, [0, P - 1]].clone(), vp[:, [0, P - 1]].clone())
    kp[:, [0, P - 1]] = float("nan")
    vp[:, [0, P - 1]] = float("nan")
    poisoned = pt.paged_tree_attention(q, kp, vp, table, ln, tree)
    kp[:, [0, P - 1]], vp[:, [0, P - 1]] = saved
    torch.cuda.synchronize()
    unread = bool(torch.equal(poisoned, got))
    finite = bool(torch.isfinite(got.float()).all())
    ok = finite and unread and repeat and node_rel <= TREE_RTOL
    plan = pa.paged_bf16_plan(B, KH, (H // KH) * r, Hd, ps, maxp, n_sms())
    rec = {"phase": "tree", "case": name, "B": B, "H": H, "KH": KH,
           "Hd": Hd, "ps": ps, "maxp": maxp, "tree": list(tree), "r": r,
           "lengths": lengths, "late_max": late_max, "max_abs_err": err,
           "max_node_rel_err": node_rel, "rtol": TREE_RTOL,
           "min_node_max_abs_out": float(node_max.min()),
           "sink_and_tail_unread": unread, "repeat_identical": repeat,
           "plan": plan._asdict(), "finite": finite, "ok": ok}
    if timed:
        pairs, slots = _verify_pairs(lengths, r, tree, maxp * ps)
        # K/V of the slots read (bf16), q and the output once, the table
        # and lengths.
        n_bytes = 2.0 * 2 * slots * KH * Hd + 2.0 * 2 * q.numel() \
            + 4.0 * (table.numel() + B)
        flops = 4.0 * Hd * H * pairs
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, flops)
        turn = [0]

        def alternating():  # another layer's pages each call, as in K2's
            turn[0] ^= 1
            pt.paged_tree_attention(q, kp2[turn[0]], vp2[turn[0]], table,
                                    ln, tree)

        rec["ms"] = time_ms(alternating)
        rec["device_ms"] = device_ms(alternating,
                                     KERNEL_FUNCTIONS["paged_attention_tree"])
        rec["host_ms"] = host_ms(alternating)
        rec["plain_ms"] = time_ms(lambda: pa.paged_tree_attention_reference(
            q, kp, vp, table, ln.clamp(min=1), anc), iters=3, warmup=1)
        # SDPA with a boolean mask over K/V gathered beforehand (the
        # gather is not timed), as a dense yardstick.
        S = maxp * ps
        k = pa._gather_pages(kp, table)
        v = pa._gather_pages(vp, table)
        rel = (torch.arange(S, device=dev)[None, :]
               - (ln.long().clamp(min=1) - 1)[:, None])         # [B, S]
        anc_t = torch.as_tensor(anc, device=dev)
        mask = (rel < 0)[:, None, :] | (
            ((rel >= 0) & (rel < r))[:, None, :]
            & anc_t[:, rel.clamp(0, r - 1)].transpose(0, 1))   # [B, r, S]

        def sdpa():
            F.scaled_dot_product_attention(q, k, v, attn_mask=mask[:, None],
                                           enable_gqa=True)

        # No single torch call takes a page table (as for K2): the SDPA
        # time over K/V gathered beforehand is a dense yardstick only.
        rec["library_ms"] = None
        rec["sdpa_gathered_ms"] = time_ms(sdpa)
        rec["sdpa_gathered_device_ms"] = device_ms(sdpa)
        rec["gbytes_per_s"] = n_bytes / (rec["device_ms"] * 1e-3) / 1e9
        del k, v, mask
    del kp2, vp2, got, poisoned
    torch.cuda.empty_cache()
    return rec


# K5's timed cases at the 8B shape (H = 32, KH = 8, head_dim 128, page
# 128): (name, B, maxp, lengths, tree, seed). The bf16 tree engine's
# shape: batch 8, the (3, 4) lattice, lengths up to 8191 (one more table
# page for the tree).
K5_TIMED = (("8b_tree34", 8, 65, [1, 17, 128, 129, 1000, 4096, 7000, 8191],
             (3, 4), 51),)


def phase_tree():
    b8 = [1, 17, 128, 129, 1000, 4096, 7000, 8191]
    cases = [tree_case(name, B, 32, 8, 128, 128, maxp, lengths, tree,
                       seed=seed, timed=True)
             for name, B, maxp, lengths, tree, seed in K5_TIMED]
    cases += [
        tree_case("tree28_hd64_ps16", 4, 8, 2, 64, 16, 64,
                  [1, 50, 300, 1000], (2, 8), seed=52),
        # The smallest page the engine admits, with the span split.
        tree_case("tree34_ps8", 4, 32, 8, 128, 8, 130, [1, 9, 300, 1023],
                  (3, 4), seed=55),
        tree_case("tree28_8b", 8, 32, 8, 128, 128, 65, b8, (2, 8), seed=53),
        tree_case("late_max", 8, 32, 8, 128, 128, 65,
                  [129, 700, 1500, 2048, 3000, 4097, 6000, 8180], (3, 4),
                  seed=54, late_max=True),
    ]
    for c in cases:
        emit(c)
    return cases


# -- phase 7: K6 ------------------------------------------------------------

# Every quantized projection of Llama-3-8B as (K, M): wq and wo, wk/wv,
# w_gate/w_up, w_down, the lm head.
K6_SHAPES = {"wq_wo": (4096, 4096), "wk_wv": (4096, 1024),
             "w_gate_up": (4096, 14336), "w_down": (14336, 4096),
             "lm_head": (4096, 128256)}
# Rows K6 meets on the int8 paths: decode at batch 8 and 128, the linear
# (k = 1) and tree ((3, 4)) verify steps at batch 128, a 4096 prefill.
K6_ROWS = (8, 128, 256, 1664, 4096)


def int8_mm_case(name, R, K, M, seed=0):
    """K6 against `int8_matmul_reference` in f32 (INT8_MM_RTOL of max |y|),
    then timed with enough copies of the weight in rotation that none is
    in L2 when it is read (the path reads each weight once per forward):
    the kernel, the plain version, and torch.matmul over a pre-dequantized
    bf16 copy (a yardstick that moves twice the weight bytes; the port
    never calls it)."""
    import torch

    from generativeaiexamples_tpu_torch.ops.int8_matmul import (
        int8_matmul, int8_matmul_plan, int8_matmul_reference)
    from generativeaiexamples_tpu_torch.ops.quant import quantize_tensor

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((R, K), generator=g, device=dev).bfloat16()
    qt = quantize_tensor(torch.randn((K, M), generator=g, device=dev)
                         * K ** -0.5)
    got = int8_matmul(x, qt.q, qt.s)
    # A second launch on the same inputs must give the same bits (the
    # split-K slices are summed in a fixed order).
    repeat_identical = bool(torch.equal(got, int8_matmul(x, qt.q, qt.s)))
    want = int8_matmul_reference(x, qt.q, qt.s, torch.float32)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got.float() - want).abs().max())
    finite = bool(torch.isfinite(got.float()).all())
    del want
    ok = finite and err <= INT8_MM_RTOL * scale and repeat_identical
    plan = int8_matmul_plan(R, K, M)
    n_bytes = 2.0 * R * K + K * M + 4.0 * M + 2.0 * R * M
    flops = 2.0 * R * K * M
    rec = {"phase": "int8_matmul", "case": name, "R": R, "K": K, "M": M,
           "max_abs_err": err, "y_max_abs": scale,
           "rel_err": err / scale, "tol_rel": INT8_MM_RTOL,
           "finite": finite, "repeat_identical": repeat_identical,
           "regime": plan.regime, "row_tile": plan.row_tile,
           "splits": plan.splits, "ctas": plan.tiles * plan.splits,
           "ok": ok}
    rec["bound_ms"], rec["bound_by"] = bound(n_bytes, flops)
    copies = [qt.q] + [qt.q.clone() for _ in range(
        min(15, int(150e6 // (K * M))))]
    turn = [0]

    def kernel():
        turn[0] = (turn[0] + 1) % len(copies)
        int8_matmul(x, copies[turn[0]], qt.s)

    rec["ms"] = time_ms(kernel)
    rec["device_ms"] = device_ms(kernel)
    rec["weight_copies"] = len(copies)
    rec["plain_ms"] = time_ms(lambda: int8_matmul_reference(x, qt.q, qt.s),
                              iters=3, warmup=1)
    del copies
    dense = [(qt.q.bfloat16() * qt.s.bfloat16())]
    dense += [dense[0].clone() for _ in range(
        min(15, int(150e6 // (2 * K * M))))]

    def library():
        turn[0] = (turn[0] + 1) % len(dense)
        torch.matmul(x, dense[turn[0]])

    rec["library_ms"] = time_ms(library)
    rec["library_device_ms"] = device_ms(library)
    rec["library"] = "torch.matmul over a pre-dequantized bf16 weight"
    rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
    rec["gbytes_per_s"] = n_bytes / (rec["ms"] * 1e-3) / 1e9
    del dense, got, qt, x
    torch.cuda.empty_cache()
    return rec


def phase_int8_matmul():
    cases = []
    for wname, (K, M) in K6_SHAPES.items():
        for i, R in enumerate(K6_ROWS):
            cases.append(int8_mm_case(f"{wname}_r{R}", R, K, M, seed=31 + i))
            emit(cases[-1])
    for name, R, K, M in (("ragged_r37", 37, 4096, 4096),
                          ("ragged_m1000", 128, 4096, 1000)):
        cases.append(int8_mm_case(name, R, K, M, seed=40))
        emit(cases[-1])
    return cases


# -- phase 8: model steps on the card vs the plain forward ------------------


# The verify steps of phase model: linear k = 3 (r = 4 positions) and the
# (3, 4) tree (r = 13 nodes), both at the length the decode steps reach.
VERIFY_K, VERIFY_TREE = 3, (3, 4)


def _paged_steps(params, cfg, pool, toks, prompt_len, n_decode, dev,
                 bucket=256, ps=128):
    """The engine's prefill step over the first prompt_len tokens, then
    n_decode decode steps, then one linear and one tree verify step over
    the next tokens of `toks` (t0 and its drafts), on `dev`. Returns (the
    prefill and decode logits [V] each, the linear verify logits [r, V],
    the tree verify logits [r, V]), f32 on the CPU."""
    import torch

    from generativeaiexamples_tpu_torch.serving import engine_model
    from generativeaiexamples_tpu_torch.serving.kv_cache import (
        PageAllocator, SequencePages)

    seq = SequencePages(PageAllocator(pool.n_pages), ps, 4)
    seq.ensure(prompt_len)
    padded = torch.zeros((1, bucket), dtype=torch.int64)
    padded[0, :prompt_len] = toks[0, :prompt_len]
    row = torch.zeros((bucket // ps,), dtype=torch.int32)
    row[:len(seq.pages)] = torch.tensor(seq.pages)
    out = [engine_model.prefill_step(params, cfg, pool, padded.to(dev),
                                     prompt_len, row.to(dev)).float().cpu()]
    for t in range(prompt_len, prompt_len + n_decode):
        seq.ensure(t + 1)
        table = torch.tensor(seq.table_row()[None, :], device=dev)
        out.append(engine_model.decode_step(
            params, cfg, pool, toks[:, t].to(dev), table,
            torch.tensor([t + 1], dtype=torch.int32, device=dev))[0]
            .float().cpu())
    # Verify at length L: the committed prefix is the L - 1 tokens above.
    L = prompt_len + n_decode + 1
    k, m = VERIFY_TREE
    seq.ensure(L + k * m)
    table = torch.tensor(seq.table_row()[None, :], device=dev)
    length = torch.tensor([L], dtype=torch.int32, device=dev)
    lin = engine_model._decode_verify_once(
        params, cfg, pool, toks[:, L - 1:L + VERIFY_K].to(dev), table, length)
    depth, anc = engine_model._tree_layout(k, m)
    tree = engine_model._tree_verify_once(
        params, cfg, pool, toks[:, L - 1:L + k * m].to(dev), table, length,
        depth, anc, k, m)
    return out, lin[0].float().cpu(), tree[0].float().cpu()


def _verify_check(got, want, tol):
    """(max |logit diff|, targets equal on every position whose f32 top-2
    margin exceeds 2 tol, positions so checked) for verify logits [r, V]:
    a smaller margin may flip under the card's bf16 rounding."""
    top2 = want.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
    same = got.argmax(-1) == want.argmax(-1)
    return (float((got - want).abs().max()), bool(same[sure].all()),
            int(sure.sum()))


def phase_model():
    """Engine prefill + decode steps (K1, K2) in bf16 on the card against
    the contiguous forward in f32 on the CPU over the same (bf16-rounded)
    weights. Tolerance 5e-2 on logits of scale ~1: the card path rounds
    every activation to bf16 through two layers (each rounding ~2^-9
    relative), the CPU path does not.

    Then the int8 variant: the same weights quantized on the card
    (int8 weights through K6, an int8 pool through K4), against the same
    engine steps in f32 on the CPU over the same codes and scales, with
    an int8 pool there too (tolerance INT8_MODEL_ATOL)."""
    import dataclasses

    import torch

    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops.quant import (
        QuantizedTensor, quantize_llama_params)
    from generativeaiexamples_tpu_torch.serving.kv_cache import PagePool

    dev = torch.device("cuda")
    cfg = dataclasses.replace(
        llama.LlamaConfig.llama3_8b(), vocab_size=512, dim=512, n_layers=2,
        n_heads=8, n_kv_heads=2, head_dim=128, mlp_dim=1024, max_seq_len=512,
        dtype=torch.bfloat16)
    params = llama.init_params(cfg, dev, torch.Generator(dev).manual_seed(0))
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_params = llama.map_params(params, lambda t: t.float().cpu())
    prompt_len, n_decode = 150, 6
    g = torch.Generator().manual_seed(1)
    n_verify = 1 + VERIFY_TREE[0] * VERIFY_TREE[1]
    toks = torch.randint(0, cfg.vocab_size,
                         (1, prompt_len + n_decode + n_verify), generator=g)
    full, _ = llama.forward(cpu_params, cpu_cfg, toks[:, :prompt_len
                                                         + n_decode])
    want = [full[0, t] for t in range(prompt_len - 1, prompt_len + n_decode)]
    # The same verify steps in f32 on the CPU over the same weights.
    _, want_lin, want_tree = _paged_steps(
        cpu_params, cpu_cfg,
        PagePool.zeros(cpu_cfg, 8, 128, dtype=torch.float32, device="cpu"),
        toks, prompt_len, n_decode, "cpu")

    pool = PagePool.zeros(cfg, 8, 128, dtype=torch.bfloat16, device=dev)
    got, lin, tree = _paged_steps(params, cfg, pool, toks, prompt_len,
                                  n_decode, dev)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    verify = {name: dict(zip(("max_abs_err", "targets_equal",
                              "positions_checked"),
                             _verify_check(a, b, 5e-2)))
              for name, a, b in (("linear", lin, want_lin),
                                 ("tree", tree, want_tree))}
    rec = {"phase": "model", "variant": "bf16", "layers": cfg.n_layers,
           "dim": cfg.dim, "head_dim": cfg.head_dim, "prompt": prompt_len,
           "decode_steps": n_decode, "logit_scale": float(full.abs().max()),
           "max_abs_err": err, "tol": 5e-2, "verify": verify,
           "ok": err <= 5e-2 and all(
               v["max_abs_err"] <= 5e-2 and v["targets_equal"]
               for v in verify.values())}
    emit(rec)

    qparams = quantize_llama_params(params, dev)
    cpu_qparams = llama.map_params(qparams, lambda t: QuantizedTensor(
        t.q.cpu(), t.s.cpu()) if isinstance(t, QuantizedTensor)
        else t.float().cpu())
    qpool = PagePool.zeros(cfg, 8, 128, dtype=torch.int8, device=dev)
    cpu_qpool = PagePool.zeros(cpu_cfg, 8, 128, dtype=torch.int8,
                               device="cpu")
    got, lin, tree = _paged_steps(qparams, cfg, qpool, toks, prompt_len,
                                  n_decode, dev)
    want, want_lin, want_tree = _paged_steps(
        cpu_qparams, cpu_cfg, cpu_qpool, toks, prompt_len, n_decode, "cpu")
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    verify = {name: dict(zip(("max_abs_err", "targets_equal",
                              "positions_checked"),
                             _verify_check(a, b, INT8_MODEL_ATOL)))
              for name, a, b in (("linear", lin, want_lin),
                                 ("tree", tree, want_tree))}
    used = slice(1, None)  # page 0 is the sink
    code_diff = (qpool.kv[:, :, :, used].cpu().int()
                 - cpu_qpool.kv[:, :, :, used].int()).abs()
    irec = {"phase": "model", "variant": "int8 weights + int8 KV",
            "layers": cfg.n_layers, "prompt": prompt_len,
            "decode_steps": n_decode,
            "logit_scale": float(max(w.abs().max() for w in want)),
            "max_abs_err": err, "tol": INT8_MODEL_ATOL,
            "kv_codes_moved": int((code_diff > 0).sum()),
            # k and v codes of every layer, kv head and token written
            "kv_codes_written": 2 * cfg.n_layers * cfg.n_kv_heads
            * (prompt_len + n_decode + n_verify) * cfg.head_dim,
            "kv_code_max_move": int(code_diff.max()),
            "argmax_equal": all(int(a.argmax()) == int(b.argmax())
                                for a, b in zip(got, want)),
            "verify": verify,
            "ok": err <= INT8_MODEL_ATOL and all(
                v["max_abs_err"] <= INT8_MODEL_ATOL and v["targets_equal"]
                for v in verify.values())}
    emit(irec)
    rec["ok"] = rec["ok"] and irec["ok"]
    rec["int8"] = irec
    return rec


# -- phase 9: serving ------------------------------------------------------


def _post(url, body, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _stream_chat(base, max_tokens):
    """One streaming chat completion. Random weights over a 128256-token
    vocabulary rarely pick one of the byte tokenizer's 256 text ids, so
    most tokens carry no text: the check is the SSE framing and the
    finish reason, and the token count comes from the engine's metrics."""
    n_chunks, finish, text, done = 0, None, "", False
    with _post(base + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "Say something."}],
            "max_tokens": max_tokens, "stream": True}) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if line == "data: [DONE]":
                done = True
                continue
            if not line.startswith("data: "):
                continue
            ch = json.loads(line[6:])["choices"][0]
            n_chunks += 1
            text += ch["delta"].get("content", "")
            if ch.get("finish_reason"):
                finish = ch["finish_reason"]
    return {"sse_chunks": n_chunks, "finish_reason": finish,
            "chars": len(text), "done_marker": done}


def _complete(base, prompt, max_tokens, **sampling):
    t0 = time.perf_counter()
    with _post(base + "/v1/completions", {"prompt": prompt,
                                          "max_tokens": max_tokens,
                                          **sampling}) as resp:
        body = json.loads(resp.read())
    ch = body["choices"][0]
    return {"completion_tokens": body["usage"]["completion_tokens"],
            "finish_reason": ch["finish_reason"],
            "seconds": time.perf_counter() - t0}


# Device function names of the port's kernels, for the profile windows.
# K2 and K5 share one body (csrc/paged_bf16.cuh) under two kernel names.
KERNEL_FUNCTIONS = {"flash_attention": "flash_fwd_kernel",
                    "paged_attention": "paged_decode_kernel",
                    "encoder_attention": "encoder_attention_kernel",
                    "paged_attention_int8": "paged_int8_kernel",
                    "paged_attention_tree": "paged_tree_kernel",
                    "int8_matmul": "int8_matmul_kernel"}


def _profile_window(run):
    """Where served time goes: torch.profiler around `run()` (which
    returns the completion tokens it produced), after the main path's
    counts were read. Device busy time is the sum of every device
    activity's self time (one stream, so activities do not overlap); the
    idle share is the rest of the window's wall time. `port_kernels_ms`
    sums the device time of each port kernel's instantiations."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tokens = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:  # older torch
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(ms for ms, _, _ in rows)
    return {"wall_ms": wall_ms, "completion_tokens": tokens,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if rows else None,
            "device_activities": sum(n for _, n, _ in rows),
            "port_kernels_ms": {
                name: sum(ms for ms, _, k in rows if fn in k)
                for name, fn in KERNEL_FUNCTIONS.items()},
            "port_kernel_instances": {
                name: [{"name": k[:120], "ms": ms, "count": n}
                       for ms, n, k in rows if fn in k]
                for name, fn in KERNEL_FUNCTIONS.items()},
            "top": [{"name": k[:90], "ms": ms, "count": n}
                    for ms, n, k in rows[:10]]}


def _recording_server(engine):
    """The port's OpenAIServer over `engine`, which also keeps the last
    request's generated token ids under its prompt ids (`streams`): random
    weights rarely emit text, so streams are compared by token."""
    from generativeaiexamples_tpu_torch.serving.openai_server import (
        OpenAIServer)

    class RecordingServer(OpenAIServer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.streams = {}

        def _events(self, req):
            ids = self.streams[tuple(req.prompt_ids)] = []
            for ev in OpenAIServer._events(req):
                if ev["token_id"] >= 0:
                    ids.append(ev["token_id"])
                yield ev

    return RecordingServer(engine, model_name="llama3-8b-random")


class ServedEngine:
    """The 8B engine behind the port's OpenAI server on a local port,
    shared by the serving, chunked-prefill and RAG phases (bf16, default
    engine config) and, on its own, by serving_int8 (`engine_cfg`,
    `n_pages`, warmed at `warmup_buckets` only); the speculative phases
    hand in an `engine` built over weights already on the card. The
    server records each request's token ids (`app.streams`).
    `model_size` and `device` exist so the phases can be rehearsed on
    the CPU at tiny size; the check runs them at 8b on cuda."""

    def __init__(self, model_size: str = "8b", device: str = "cuda",
                 engine_cfg=None, n_pages=None, warmup_buckets=None,
                 engine=None):
        from generativeaiexamples_tpu_torch.serving.__main__ import (
            build_engine)
        from generativeaiexamples_tpu_torch.serving.openai_server import (
            make_http_server)

        t0 = time.perf_counter()
        self.engine = engine or build_engine(
            model_size, device=device, seed=0, warmup=False,
            engine_cfg=engine_cfg, n_pages=n_pages)
        self.build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.engine.warmup(buckets=warmup_buckets)
        self.warm_s = time.perf_counter() - t0
        self.engine.start()
        self.app = _recording_server(self.engine)
        self.httpd = make_http_server(self.app, "127.0.0.1", 0)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=30)
        self.engine.stop()


def phase_serving(card: str, served: ServedEngine):
    import torch

    from generativeaiexamples_tpu_torch import kernels

    base, engine = served.base, served.engine
    torch.cuda.synchronize()
    kernels.reset_launches()
    stream = _stream_chat(base, 32)
    single = _complete(base, "The quick brown fox", 32)
    results = [None] * 4

    def run(i):
        # The last one samples (temperature, top-k, top-p on the device),
        # so the batch takes the masked-sampling path.
        sampling = ({"temperature": 0.7, "top_p": 0.9, "top_k": 40}
                    if i == 3 else {})
        results[i] = _complete(base, f"Request number {i}:", 64, **sampling)

    t1 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t1
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    with urllib.request.urlopen(base + "/health", timeout=30) as r:
        health = json.loads(r.read())
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        metrics = json.loads(r.read())
    profile = _profile_window(lambda: _complete(
        base, "Profile window", 64)["completion_tokens"])
    conc_tokens = sum(r["completion_tokens"] for r in results if r)

    def finished_ok(r, want):
        return r is not None and (r["completion_tokens"] == want
                                  or r["finish_reason"] in ("length", "stop"))

    ok = (stream["finish_reason"] in ("length", "stop")
          and stream["done_marker"]
          and finished_ok(single, 32)
          and all(finished_ok(r, 64) for r in results)
          and health.get("status") == "healthy"
          and launches["flash_attention"] > 0
          and launches["paged_attention"] > 0)
    rec = {"phase": "serving", "model": "llama3_8b random bf16",
           "layers": engine.cfg.n_layers, "card": card,
           "engine_build_s": served.build_s, "warmup_s": served.warm_s,
           "stream": stream, "single": single,
           "concurrent": results, "concurrent_wall_s": wall,
           "concurrent_tokens_per_s": conc_tokens / wall if wall else None,
           "ttft_p50_ms": metrics.get("ttft_p50_ms"),
           "ttft_p95_ms": metrics.get("ttft_p95_ms"),
           "tokens_generated": metrics.get("tokens_generated"),
           "mean_batch_occupancy": metrics.get("mean_batch_occupancy"),
           "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "profile": profile, "ok": ok}
    emit(rec)
    return rec


# -- phase 10: chunked long prefill at 8B ---------------------------------


def phase_chunked(served: ServedEngine, prompt_len: int = 6000):
    """A ~6k-token prompt (beyond the 4096 bucket) through the server:
    the engine's chunked lane must launch K1 (with q_offset > 0 on the
    second chunk). Then the first-token logits of the engine's chunk
    steps over the same prompt against the port's one-shot forward.
    Tolerance CHUNK_LOGIT_ATOL: both sides are bf16 on the card through
    32 layers; they differ only where cuBLAS tiles the two matmul shapes
    differently, and each such bf16 rounding flip (2^-8 relative) feeds
    the residual stream of every later layer."""
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.serving import engine_model

    engine = served.engine
    g = torch.Generator().manual_seed(6)
    prompt = torch.randint(0, 256, (prompt_len,), generator=g).tolist()
    torch.cuda.synchronize()
    kernels.reset_launches()
    served_rec = _complete(served.base, prompt, 8)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)

    # The engine's chunk steps (what _advance_long_prefills dispatches)
    # against one forward over the whole prompt, same weights.
    dev = engine.device
    chunk = engine.buckets[-1]
    s_total = -(-prompt_len // chunk) * chunk
    cache = llama.KVCache.zeros(engine.cfg, 1, max_len=s_total, device=dev)
    t0 = time.perf_counter()
    for pos in range(0, prompt_len, chunk):
        part = prompt[pos:pos + chunk]
        width = engine._pick_chunk_width(len(part), chunk)
        tok = torch.zeros((1, width), dtype=torch.int32)
        tok[0, :len(part)] = torch.tensor(part)
        chunked, cache = engine_model.prefill_chunk_step(
            engine.params, engine.cfg, cache, tok.to(dev), len(part))
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    with torch.no_grad():
        x, _ = llama.forward_hidden(engine.params, engine.cfg,
                                    torch.tensor([prompt], device=dev))
        oneshot = llama.logits_from_hidden(engine.cfg, engine.params,
                                           x[:, -1:])[0, 0]
    torch.cuda.synchronize()
    err = float((chunked.float() - oneshot.float()).abs().max())
    del cache, x
    k_cap = _k_cap_check(served, prompt, list(served.app.streams[
        tuple(prompt)]))
    ok = (served_rec["completion_tokens"] >= 1
          and launches["flash_attention"] >= 2 * engine.cfg.n_layers
          and err <= CHUNK_LOGIT_ATOL and bool(torch.isfinite(chunked).all())
          and k_cap["ok"])
    rec = {"phase": "chunked", "prompt_tokens": prompt_len, "chunk": chunk,
           "served": served_rec, "launches": launches,
           "chunk_steps_s": chunked_s,
           "logit_scale": float(oneshot.float().abs().max()),
           "first_token_logit_max_abs_err": err, "tol": CHUNK_LOGIT_ATOL,
           "argmax_equal": int(chunked.argmax()) == int(oneshot.argmax()),
           "prefill_decode_k_cap": k_cap, "ok": ok}
    emit(rec)
    return rec


def _k_cap_run(served, prompt, shorts, chunks_per_block: int,
               max_tokens: int):
    """The short greedy prompts admitted one at a time (each its own
    prefill group, as when run alone), then `prompt` through the chunked
    lane while they decode, with engine.prefill_chunks_per_block set to
    `chunks_per_block` for the run. Returns each plain decode block's K
    with whether a chunked prefill was in progress at its dispatch (a spy
    on engine_model.decode_multi_step, removed after) and the streams'
    tokens (shorts, then prompt)."""
    import dataclasses

    from generativeaiexamples_tpu_torch.serving import engine_model

    engine, streams = served.engine, served.app.streams
    real = engine_model.decode_multi_step
    log = []

    def spy(*args, **kw):
        n_steps = args[11] if len(args) > 11 else kw["n_steps"]
        log.append((n_steps, bool(engine._long_prefills)))
        return real(*args, **kw)

    saved = engine.ecfg
    engine.ecfg = dataclasses.replace(
        saved, prefill_chunks_per_block=chunks_per_block)
    engine_model.decode_multi_step = spy
    threads = []
    try:
        for p in shorts:
            streams.pop(tuple(p), None)
            t = threading.Thread(target=_complete,
                                 args=(served.base, p, max_tokens))
            t.start()
            threads.append(t)
            deadline = time.time() + 60
            while len(streams.get(tuple(p), ())) < 2 \
                    and time.time() < deadline:
                time.sleep(0.001)
        long_rec = _complete(served.base, prompt, 8)
        for t in threads:
            t.join(timeout=600)
    finally:
        engine_model.decode_multi_step = real
        engine.ecfg = saved
    live = [k for k, lv in log if lv]
    return {"chunks_per_block": chunks_per_block,
            "blocks": len(log), "blocks_while_prefilling": len(live),
            "k_while_prefilling": sorted(set(live)),
            "k_otherwise": sorted({k for k, lv in log if not lv}),
            "long_completion_tokens": long_rec["completion_tokens"]
            }, [list(streams[tuple(p)]) for p in (*shorts, prompt)]


def _k_cap_check(served, prompt, long_alone, n_short: int = 3,
                 max_tokens: int = 128):
    """engine.prefill_decode_k_cap on the card: `n_short` greedy streams
    decode while the ~6k-token prompt prefills in chunks. Three streams,
    not two: at most a quarter of the batch decoding already caps K at 2
    (the low-occupancy rule), which would hide the rule under test. Run
    at the default prefill_chunks_per_block (2: the prompt's two chunks
    go out in one beat, so no decode block is dispatched in between),
    then at 1, where the blocks between the chunks must take K <= the
    cap. The streams must equal the same requests run alone."""
    import torch

    cap = served.engine.ecfg.prefill_decode_k_cap
    g = torch.Generator().manual_seed(7)
    shorts = [torch.randint(0, 256, (48 + 16 * i,), generator=g).tolist()
              for i in range(n_short)]
    alone = []
    for p in shorts:
        _complete(served.base, p, max_tokens)
        alone.append(list(served.app.streams[tuple(p)]))
    alone.append(long_alone)
    runs = []
    for cpb in (served.engine.ecfg.prefill_chunks_per_block, 1):
        run, got = _k_cap_run(served, prompt, shorts, cpb, max_tokens)
        run["streams_equal_alone"] = [g == w for g, w in zip(got, alone)]
        runs.append(run)
    ok = (cap == 2 and runs[-1]["blocks_while_prefilling"] >= 1
          and all(max(r["k_while_prefilling"], default=0) <= cap
                  and all(r["streams_equal_alone"]) for r in runs))
    return {"cap": cap, "short_streams": n_short,
            "short_max_tokens": max_tokens, "runs": runs, "ok": ok}


# -- phase 11: the developer_rag chain at full width ----------------------


def _rag_corpus(seed: int, n_chunks: int) -> str:
    """English prose from the repository's own documents (docs/*.md and
    README.md): its prose paragraphs (no code, tables or headings),
    sampled with a seed until the default splitter (508 approx-tokens a
    chunk, 200 overlap) gives about n_chunks chunks."""
    import glob

    import numpy as np

    from generativeaiexamples_tpu_torch.rag.splitter import ApproxTokenizer

    root = os.path.dirname(os.path.abspath(__file__))
    paths = sorted(glob.glob(os.path.join(root, "docs", "*.md"))) + [
        os.path.join(root, "README.md")]
    paras = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            for p in fh.read().split("\n\n"):
                p = p.strip()
                if (len(p.split()) >= 8
                        and not p.startswith(("```", "|", "    ", "<", "#"))
                        and sum(c.isalpha() or c.isspace() for c in p)
                        > 0.8 * len(p)):
                    paras.append(p)
    counts = [len(ApproxTokenizer().encode(p)) for p in paras]
    want = (n_chunks - 1) * (508 - 200) + 508
    rng = np.random.default_rng(seed)
    out, n = [], 0
    while n < want:
        i = int(rng.integers(len(paras)))
        out.append(paras[i])
        n += counts[i]
    return "\n\n".join(out)


def _multipart(filename: str, data):
    """A multipart upload of `data` (text, or bytes as they are)."""
    boundary = "gaieboundary7a3f"
    raw = data.encode() if isinstance(data, str) else data
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{filename}\"\r\nContent-Type: text/plain\r\n\r\n"
            ).encode() + raw + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def _chain_generate(base: str, query: str, max_tokens: int):
    """One knowledge-base /generate: frames, the [DONE] sentinel, the
    time to the first frame and to the end (host clock)."""
    t0 = time.perf_counter()
    frames, first_s = [], None
    with _post(base + "/generate", {
            "messages": [{"role": "user", "content": query}],
            "use_knowledge_base": True, "max_tokens": max_tokens}) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: "):
                first_s = first_s or time.perf_counter() - t0
                frames.append(json.loads(line[6:]))
    last = frames[-1]["choices"][0] if frames else {}
    texts = [f["choices"][0]["message"]["content"] for f in frames]
    return {"frames": len(frames), "done_frame": last.get(
                "finish_reason") == "[DONE]",
            "error_frames": sum("Error from chain server" in t
                                for t in texts),
            "chars": sum(len(t) for t in texts),
            "first_frame_s": first_s, "seconds": time.perf_counter() - t0}


def _exact_topk_check(rows, queries, got_ids, got_scores, k):
    """Hold device-store results against an exact float64 MIPS on the
    host. Ids must be equal; a swap is accepted only between rows whose
    exact scores tie within 1e-6 (f32 accumulation order)."""
    import numpy as np

    exact = queries.astype(np.float64) @ rows.astype(np.float64).T
    part = np.argpartition(-exact, k, axis=1)[:, :k]
    order = np.argsort(-np.take_along_axis(exact, part, axis=1), axis=1)
    want = np.take_along_axis(part, order, axis=1)
    want_scores = np.take_along_axis(exact, want, axis=1)
    swaps = 0
    for r in range(len(queries)):
        for j in range(k):
            if got_ids[r][j] != want[r, j]:
                swaps += 1
                if abs(exact[r, got_ids[r][j]] - want_scores[r, j]) > 1e-6:
                    return False, swaps, None
    err = float(np.abs(np.asarray(got_scores) - want_scores).max())
    return err <= 1e-4, swaps, err


def phase_rag(card: str, served: ServedEngine, device: str = "cuda",
              n_chunks: int = 2000, store_rows: int = 1_000_000,
              store_dim: int = 1024, max_tokens: int = 32, keep=None):
    """The port's ChainServer with developer_rag over the device store,
    the served 8B engine, and arctic-embed-l / BERT-base reranker
    encoders (bf16, random from seeds): ingest the repository's prose
    sampled with a seed (~2,000 chunks at the default splitter, all at
    S=512), /search against exact host MIPS, a 1M-row device store
    searched with 64 queries against exact host MIPS, and two
    knowledge-base /generate answers whose prompts exceed the 4096
    bucket. Each answer must generate its tokens with no error frame
    (an engine failure becomes one); K3's launches must equal the
    encoder layers times the forwards made, and K1 and K2 must launch.
    `keep` (a dict), when given, receives the encoders, the ingested
    store and the phase's queries, which the checkpoint phase writes to
    disk and loads back."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.api.server import (
        ChainServer, make_http_server)
    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
    from generativeaiexamples_tpu_torch.rag.vectorstore import (
        DeviceVectorStore)
    from generativeaiexamples_tpu_torch.serving.__main__ import (
        build_encoders)

    emb, rr = build_encoders(device, seed=1)
    config = load_config(env={}, overrides={
        "vector_store": {"name": "tpu"}, "reranker": {"enabled": True},
        "embeddings": {"dimensions": emb.dim}})
    hub = EngineHub(config, llm=served.engine, embed=emb, rerank=rr,
                    device=device)
    app = ChainServer(config, hub=hub)
    httpd = make_http_server(app, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    store = app.example.res.store
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        emb.forwards = rr.forwards = 0
        corpus = _rag_corpus(0, n_chunks)
        body, ctype = _multipart("corpus.txt", corpus)
        t0 = time.perf_counter()
        req = urllib.request.Request(base + "/documents", data=body,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=900) as r:
            upload = json.loads(r.read())
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        stored = len(store)

        query = "Which scheduler keeps the decode batch full of tokens?"
        with _post(base + "/search", {"query": query, "top_k": 5}) as r:
            chunks = json.loads(r.read())["chunks"]

        # Two knowledge-base answers (prompts beyond the 4096 bucket).
        gens = []
        m = served.engine.metrics
        questions = ("How does the prefill scheduler use the page cache?",
                     "What bounds the attention kernel on the device?")
        for q in questions:
            prefill0, tokens0 = m.prefill_tokens, m.tokens_out
            g = _chain_generate(base, q, max_tokens)
            g["prompt_tokens"] = m.prefill_tokens - prefill0
            g["tokens_generated"] = m.tokens_out - tokens0
            g["engine_ttft_ms"] = m.last_ttft_ms
            gens.append(g)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        forwards = {"embed": emb.forwards, "rerank": rr.forwards}
        want_k3 = (emb.forwards * emb.cfg.n_layers
                   + rr.forwards * rr.cfg.n_layers)

        # /search against exact host MIPS over the store's rows (the
        # query's embedding is recomputed after the counts were read).
        qv = emb.embed_query(query)
        texts = [d["text"] for d in store.snapshot_docs()]
        ids = [texts.index(c["content"]) for c in chunks]
        search_ok, search_swaps, search_err = _exact_topk_check(
            store.rows().cpu().numpy(), qv[None, :], [ids],
            [[c["score"] for c in chunks]], 5)
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            metrics = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
        app.close()

    # A second device store of seed-made unit rows, searched in batch.
    g = torch.Generator(device=device).manual_seed(2)
    big = DeviceVectorStore(store_dim, device=device)
    vecs = torch.randn((store_rows, store_dim), generator=g, device=device)
    vecs /= torch.linalg.vector_norm(vecs, dim=1, keepdim=True)
    big.add([str(i) for i in range(store_rows)], vecs)
    del vecs
    qs = torch.randn((64, store_dim), generator=g, device=device)
    qs = (qs / torch.linalg.vector_norm(qs, dim=1, keepdim=True)).cpu()
    big.search(qs[0].numpy(), top_k=10)  # folds the rows in (not timed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = big.search(qs[0].numpy(), top_k=10)
    one_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    batch = big.search_batch(qs.numpy(), top_k=10)
    batch_ms = (time.perf_counter() - t0) * 1e3
    store_gb = big.rows().numel() * 4 / 1e9
    big_ok, big_swaps, big_err = _exact_topk_check(
        big.rows().cpu().numpy(), qs.numpy(),
        [[int(h.text) for h in hits] for hits in batch],
        [[h.score for h in hits] for hits in batch], 10)
    big_ok = big_ok and [int(h.text) for h in one] == [
        int(h.text) for h in batch[0]]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    del big
    if keep is not None:
        keep.update(emb=emb, rr=rr, store=store,
                    queries=[query, *questions])

    # An answer generates max_tokens tokens, or fewer when it ends on an
    # end-of-sequence token; a request the engine fails streams the error
    # frame (the connector raises on an "error" finish).
    ok = (upload.get("message", "").endswith("uploaded successfully")
          and search_ok and big_ok
          and all(g["done_frame"] and g["error_frames"] == 0
                  and 1 <= g["tokens_generated"] <= max_tokens
                  and g["prompt_tokens"] > served.engine.buckets[-1]
                  for g in gens)
          and launches["encoder_attention"] == want_k3 > 0
          and launches["flash_attention"] > 0
          and launches["paged_attention"] > 0
          and health.get("message") == "Service is up.")
    rec = {"phase": "rag", "card": card, "example": "developer_rag",
           "store": "DeviceVectorStore", "embedder": "arctic_embed_l bf16",
           "reranker": "reranker_base bf16", "nr_pipeline": "ranked_hybrid",
           "corpus": "docs/*.md + README.md prose, seed 0",
           "corpus_bytes": len(corpus), "chunks": stored,
           "ingest_s": ingest_s, "ingest_chunks_per_s": stored / ingest_s,
           "search": {"ok": search_ok, "swaps": search_swaps,
                      "max_score_err": search_err, "top": chunks[:1]},
           "store_1m": {"rows": store_rows, "dim": store_dim,
                        "gb": store_gb, "ok": big_ok, "swaps": big_swaps,
                        "max_score_err": big_err,
                        "search_1_query_ms": one_ms,
                        "search_64_queries_ms": batch_ms},
           "generate": gens, "forwards": forwards,
           "launches": launches, "want_encoder_launches": want_k3,
           "store_metrics": metrics.get("vector_store"),
           "peak_mem_gb": peak_gb, "ok": ok}
    emit(rec)
    return rec


# -- phase 11a: the rest of the chain (micro-batching, tracing, augmentation)


def _pct(vals, p):
    """The p-quantile (0..1) of vals by rank, None when empty."""
    vals = sorted(v for v in vals if v is not None)
    return vals[min(len(vals) - 1, int(p * len(vals)))] if vals else None


def _together(n: int, fn):
    """fn(i) on n threads released at once: [(result, seconds)]."""
    out = [None] * n
    bar = threading.Barrier(n)

    def run(i):
        bar.wait()
        t0 = time.perf_counter()
        try:
            res = fn(i)
        except Exception as e:  # reported, and fails the phase
            res = e
        out[i] = (res, time.perf_counter() - t0)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return out


def _span_s(t):
    """A span or event time in seconds: the built-in tracer keeps
    time.time() floats, the OpenTelemetry SDK integer nanoseconds."""
    return t / 1e9 if isinstance(t, int) else t


def _search(base, query, top_k):
    with _post(base + "/search", {"query": query, "top_k": top_k}) as r:
        return json.loads(r.read())["chunks"]


def _chain_frames(base, query, max_tokens, headers=None):
    """One knowledge-base /generate: the frames' contents, in order."""
    req = urllib.request.Request(
        base + "/generate", data=json.dumps({
            "messages": [{"role": "user", "content": query}],
            "use_knowledge_base": True, "max_tokens": max_tokens}).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    frames = []
    with urllib.request.urlopen(req, timeout=900) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: "):
                frames.append(json.loads(line[6:])["choices"][0])
    return frames


def _chain_server(config, hub, store):
    """A ChainServer (developer_rag) over `hub`'s engines and the given
    store, on a local port: (app, httpd, base, thread)."""
    from generativeaiexamples_tpu_torch.api.server import (
        ChainServer, make_http_server)
    from generativeaiexamples_tpu_torch.pipelines.base import (
        get_example_class)
    from generativeaiexamples_tpu_torch.pipelines.resources import Resources

    example = get_example_class("developer_rag")(
        Resources(config, hub=hub, store=store))
    app = ChainServer(config, example=example)
    httpd = make_http_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return app, httpd, f"http://127.0.0.1:{httpd.server_address[1]}", th


def _stop_server(app, httpd, th):
    httpd.shutdown()
    httpd.server_close()
    th.join(timeout=30)
    app.close()


def phase_chain(card: str, served: ServedEngine, keep: dict,
                device: str = "cuda", n_search: int = 64,
                n_answers: int = 16, n_augmented: int = 2,
                max_tokens: int = 32, top_k: int = 5):
    """The rest of the chain over phase_rag's encoders and 2,001-chunk
    device store (`keep`) and the served 8B engine, tracing on (a
    MemoryExporter):

    1. coalesced search: `n_search` distinct corpus queries to /search
       one at a time on a server with micro-batching off, then all at
       once on one with `serving.microbatch_enabled`; every result held
       to exact host MIPS, the two runs' ids equal, the query embeddings
       made concurrently through the embedder's batcher compared bit for
       bit with the direct ones; K3's launches must equal encoder layers
       x forwards;
    2. traced answers: `n_answers` concurrent knowledge-base /generate
       (ranked_hybrid), one with a W3C traceparent: each `generate` span
       must share its trace with one `llm.local` and one
       `engine.generate` span, the header's trace id must come back, and
       the reranker's batcher must coalesce; the TTFT split is read from
       the spans;
    3. augmented answers: `n_augmented` answers with
       query_augmentation rewrite,hyde,multi_query and fact_check: the
       variants reach the encoder as one embed_queries call (one
       forward) and the store as one search_batch, and each answer ends
       with the "[fact-check] " frame and a verdict the engine
       generated. K1, K2 and K3 must launch.
    The batchers are disabled and tracing turned off at the end, so the
    later phases run as before."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.api.server import sanitize
    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
    from generativeaiexamples_tpu_torch.obs import tracing

    emb, rr, store = keep["emb"], keep["rr"], keep["store"]
    base_cfg = {"vector_store": {"name": "tpu"},
                "reranker": {"enabled": True},
                "embeddings": {"dimensions": emb.dim}}
    cfg_off = load_config(env={}, overrides=base_cfg)
    cfg_on = load_config(env={}, overrides={
        **base_cfg, "serving": {"microbatch_enabled": True}})
    cfg_aug = load_config(env={}, overrides={
        **base_cfg, "serving": {"microbatch_enabled": True},
        "retriever": {"query_augmentation": "rewrite,hyde,multi_query",
                      "fact_check": True}})
    hub = EngineHub(cfg_on, llm=served.engine, embed=emb, rerank=rr,
                    device=device)
    exporter = tracing.MemoryExporter()
    tracing.setup(exporter=exporter)
    backend = tracing._BACKEND  # "otel" where the SDK is installed
    docs = store.snapshot_docs()
    texts = [d["text"] for d in docs]
    # Queries the server's input hygiene leaves as they are, so the
    # embeddings made here are those of what /search embeds.
    rng = np.random.default_rng(11)
    queries = []
    for i in rng.permutation(len(docs)):
        q = " ".join(texts[int(i)].split()[:12])
        if sanitize(q) == q and q not in queries:
            queries.append(q)
        if len(queries) == n_search:
            break
    rows = store.rows().cpu().numpy()
    servers = []
    try:
        # 1. /search, direct then coalesced.
        app, httpd, base, th = _chain_server(cfg_off, hub, store)
        servers.append((app, httpd, th))
        torch.cuda.synchronize()
        f0 = emb.forwards
        direct, direct_s = [], []
        for q in queries:
            t0 = time.perf_counter()
            direct.append(_search(base, q, top_k))
            direct_s.append(time.perf_counter() - t0)
        direct_forwards = emb.forwards - f0
        direct_vecs = np.stack([emb.embed_query(q) for q in queries])
        app, httpd, base, th = _chain_server(cfg_on, hub, store)
        servers.append((app, httpd, th))
        torch.cuda.synchronize()
        kernels.reset_launches()
        f0, r0 = emb.forwards, rr.forwards
        coal = _together(n_search, lambda i: _search(base, queries[i],
                                                     top_k))
        torch.cuda.synchronize()
        search_launches = dict(kernels.LAUNCHES)
        coal_forwards = emb.forwards - f0
        want_k3 = (coal_forwards * emb.cfg.n_layers
                   + (rr.forwards - r0) * rr.cfg.n_layers)
        stats = app.example.res.retriever.microbatch_stats()
        coal_vecs = _together(n_search, lambda i: emb.embed_query(
            queries[i]))
        coal_vecs = np.stack([v for v, _ in coal_vecs])
        same_bits = int(sum(np.array_equal(a, b)
                            for a, b in zip(direct_vecs, coal_vecs)))
        vec_err = float(np.abs(direct_vecs - coal_vecs).max())
        search_errors = [c for c, _ in coal if isinstance(c, Exception)]
        coal_hits = [c if not isinstance(c, Exception) else [{
            "content": texts[0], "score": float("nan")}] * top_k
            for c, _ in coal]

        def ids_scores(hits):
            return ([[texts.index(c["content"]) for c in h] for h in hits],
                    [[c["score"] for c in h] for h in hits])

        d_ids, d_scores = ids_scores(direct)
        c_ids, c_scores = ids_scores(coal_hits)
        d_ok, d_swaps, d_err = _exact_topk_check(rows, direct_vecs, d_ids,
                                                 d_scores, top_k)
        c_ok, c_swaps, c_err = _exact_topk_check(rows, direct_vecs, c_ids,
                                                 c_scores, top_k)
        search = {
            "queries": n_search, "top_k": top_k,
            "direct": {"forwards": direct_forwards, "exact_ok": d_ok,
                       "swaps": d_swaps, "max_score_err": d_err,
                       "latency_p50_ms": _pct(direct_s, 0.5) * 1e3,
                       "latency_p99_ms": _pct(direct_s, 0.99) * 1e3},
            "coalesced": {"forwards": coal_forwards, "exact_ok": c_ok,
                          "swaps": c_swaps, "max_score_err": c_err,
                          "errors": [repr(e) for e in search_errors],
                          "latency_p50_ms": _pct([t for _, t in coal],
                                                 0.5) * 1e3,
                          "latency_p99_ms": _pct([t for _, t in coal],
                                                 0.99) * 1e3,
                          "embed_batcher": stats.get("embed"),
                          "search_batcher": stats.get("search")},
            "ids_equal": d_ids == c_ids,
            "embeddings_bit_identical": same_bits,
            "embeddings_max_abs_diff": vec_err,
            "launches": search_launches, "want_encoder_launches": want_k3}
        search_ok = (d_ok and c_ok and d_ids == c_ids and not search_errors
                     and (same_bits == n_search or vec_err <= 2e-2)
                     and coal_forwards < direct_forwards
                     and search_launches["encoder_attention"] == want_k3)

        # 2. traced answers, all at once (one with a traceparent).
        trace_id = "4bf92f3577b34da6a3ce929d0e0e4736"
        header = {"traceparent": f"00-{trace_id}-00f067aa0ba902b7-01"}
        exporter.clear()
        kernels.reset_launches()
        rr_stats0 = rr.microbatch_stats()
        questions = [f"How does the engine handle request {i} when the "
                     f"page cache is full?" for i in range(n_answers)]
        answers = _together(n_answers, lambda i: _chain_frames(
            base, questions[i], max_tokens, header if i == 0 else None))
        torch.cuda.synchronize()
        answer_launches = dict(kernels.LAUNCHES)
        rr_stats = rr.microbatch_stats()
        spans = exporter.get_finished_spans()
        by_trace = {}
        for sp in spans:
            by_trace.setdefault(sp.context.trace_id, []).append(sp)
        gens = [sp for sp in spans if sp.name == "generate"]
        splits, linked = [], 0
        for g in gens:
            tree = by_trace[g.context.trace_id]
            llm = [sp for sp in tree if sp.name == "llm.local"]
            eng = [sp for sp in tree if sp.name == "engine.generate"]
            if len(llm) == 1 and len(eng) == 1:
                linked += 1

            def first(sp):
                return next((e for e in sp.events
                             if e.name == "first_token"), None)

            g0 = _span_s(g.start_time)
            e_first = first(eng[0]) if eng else None
            l_first = first(llm[0]) if llm else None
            splits.append({
                # Start of generate to the engine's first token (random
                # weights rarely emit one of the byte tokenizer's text
                # ids, so the first frame, and the spans' text TTFTs,
                # often never come).
                "chain_first_token_ms": (
                    (_span_s(e_first.timestamp) - g0) * 1e3 if e_first
                    else None),
                "retrieval_and_prompt_ms": (
                    (_span_s(llm[0].start_time) - g0) * 1e3 if llm
                    else None),
                "engine_ttft_ms": (e_first.attributes["ttft_ms"]
                                   if e_first else None),
                "chain_first_frame_ms": g.attributes.get("ttft_ms"),
                "llm_first_text_ms": (l_first.attributes["ttft_ms"]
                                      if l_first else None)})
        answer_errors = [a for a, _ in answers if isinstance(a, Exception)]
        good = [a for a, _ in answers if not isinstance(a, Exception)]
        ttft_split = {key: {"p50": _pct([s[key] for s in splits], 0.5),
                            "p95": _pct([s[key] for s in splits], 0.95),
                            "n": sum(s[key] is not None for s in splits)}
                      for key in ("chain_first_token_ms",
                                  "retrieval_and_prompt_ms",
                                  "engine_ttft_ms", "chain_first_frame_ms",
                                  "llm_first_text_ms")}
        rerank_calls = rr_stats["submitted"] - rr_stats0["submitted"]
        rerank_dispatches = rr_stats["dispatches"] - rr_stats0["dispatches"]
        traced = {
            "answers": n_answers, "max_tokens": max_tokens,
            "errors": [repr(e) for e in answer_errors],
            "done_frames": sum(a[-1]["finish_reason"] == "[DONE]"
                               for a in good),
            "error_frames": sum("Error from chain server"
                                in f["message"]["content"]
                                for a in good for f in a),
            "generate_spans": len(gens), "linked_traces": linked,
            "header_trace_back": any(
                g.context.trace_id == int(trace_id, 16) for g in gens),
            "ttft_split": ttft_split,
            "rerank_calls": rerank_calls,
            "rerank_dispatches": rerank_dispatches,
            "rerank_batcher": rr_stats, "launches": answer_launches}
        traced_ok = (not answer_errors and traced["done_frames"] == n_answers
                     and traced["error_frames"] == 0
                     and len(gens) == linked == n_answers
                     and ttft_split["chain_first_token_ms"]["n"] == n_answers
                     and traced["header_trace_back"]
                     and rerank_dispatches < rerank_calls
                     and all(answer_launches[k] > 0 for k in (
                         "flash_attention", "paged_attention",
                         "encoder_attention")))

        # 3. augmented answers with the fact check, one at a time.
        app, httpd, base, th = _chain_server(cfg_aug, hub, store)
        servers.append((app, httpd, th))
        res = app.example.res
        calls = []
        real_eq = res.embedder.embed_queries

        def counted(texts_):
            calls.append(len(texts_))
            return real_eq(texts_)

        res.embedder.embed_queries = counted
        kernels.reset_launches()
        exporter.clear()
        augmented = []
        for i in range(n_augmented):
            calls.clear()
            f0 = emb.forwards
            b0 = store.stats()["batched_searches"]
            frames = _chain_frames(base, questions[i], max_tokens)
            contents = [f["message"]["content"] for f in frames]
            mark = (contents.index("\n\n[fact-check] ")
                    if "\n\n[fact-check] " in contents else None)
            augmented.append({
                "frames": len(frames),
                "done_frame": frames[-1]["finish_reason"] == "[DONE]",
                "fact_check_frame": mark is not None,
                "verdict_frames": (len(frames) - 2 - mark
                                   if mark is not None else 0),
                "embed_queries_calls": list(calls),
                "embed_forwards": emb.forwards - f0,
                "search_batch_calls": store.stats()["batched_searches"]
                - b0})
        torch.cuda.synchronize()
        aug_launches = dict(kernels.LAUNCHES)
        # Each augmented answer's trace: the hyde, multi_query, answer
        # and fact-check LLM calls (rewrite has no history to resolve).
        aug_traces = {}
        for sp in exporter.get_finished_spans():
            aug_traces.setdefault(sp.context.trace_id, []).append(sp)
        verdicts = []
        for tree in aug_traces.values():
            eng = sorted((sp for sp in tree if sp.name == "engine.generate"),
                         key=lambda sp: _span_s(sp.start_time))
            verdicts.append({"llm_calls": len(eng),
                             "verdict_tokens": (eng[-1].attributes.get(
                                 "tokens_generated") if eng else 0)})
        aug_ok = (all(a["done_frame"] and a["fact_check_frame"]
                      and len(a["embed_queries_calls"]) == 1
                      and a["embed_queries_calls"][0] >= 2
                      and a["embed_forwards"] == 1
                      and a["search_batch_calls"] == 1 for a in augmented)
                  and len(verdicts) == n_augmented
                  and all(v["llm_calls"] == 4 and v["verdict_tokens"] >= 1
                          for v in verdicts)
                  and all(aug_launches[k] > 0 for k in (
                      "flash_attention", "paged_attention",
                      "encoder_attention")))
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            metrics = json.loads(r.read())
    finally:
        for app, httpd, th in servers:
            _stop_server(app, httpd, th)
        for obj in (emb, rr, store):
            obj.disable_microbatch()
        tracing._ENABLED = False  # the later phases run untraced
    ok = search_ok and traced_ok and aug_ok
    rec = {"phase": "chain", "card": card, "store_chunks": len(docs),
           "tracing_backend": backend,
           "search": search, "search_ok": search_ok,
           "traced": traced, "traced_ok": traced_ok,
           "augmented": augmented, "augmented_traces": verdicts,
           "augmented_launches": aug_launches, "augmented_ok": aug_ok,
           "microbatch_metrics": metrics.get("microbatch"), "ok": ok}
    emit(rec)
    return rec


# -- phase 12: the int8 deployment at 8B ---------------------------------

# The JAX package's documented int8 deployment (docs/deployment.md):
# llama3-8b, int8 weights + int8 KV, max_batch_size 128, page_size 128.
INT8_DEPLOYMENT = {"quantize_weights": "int8", "kv_dtype": "int8",
                   "max_batch_size": 128, "page_size": 128,
                   "max_seq_len": 8192}
# The one cut: 4,097 pool pages (a 35 GB pool at 8.65 MB a page) in place
# of the engine's default 128 x 64 + 64 + 1 (~71 GB), so the pool, the
# weights and the activations fit one 80 GB card beside each other.
INT8_POOL_PAGES = 4097


def _int8_prompts(n_requests: int):
    """The int8 phases' prompts: 20-400 random letters each (seed 3)."""
    import numpy as np

    rng = np.random.default_rng(3)
    return ["".join(chr(c) for c in rng.integers(97, 123, n))
            for n in rng.integers(20, 401, n_requests)]


def _burst(base, prompts, max_tokens):
    """All prompts as concurrent greedy completions; their results."""
    results = [None] * len(prompts)

    def run(i):
        results[i] = _complete(base, prompts[i], max_tokens)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return results


def _page_round_trip(pool, pages):
    """The KV pager's page moves on an int8 pool: random codes and scales
    written into `pages`, read out with pool_to_pages and copied to host
    memory, the pages zeroed, the host copy scattered back with
    pages_to_pool: codes and scales must come back bit-identical."""
    import torch

    from generativeaiexamples_tpu_torch.serving import engine_model

    dev = pool.kv.device
    row = torch.tensor(pages, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    codes = torch.randint(-127, 128, (len(pages),) + pool.kv[:, :, :, 0].shape,
                          generator=g, device=dev).to(torch.int8)
    scales = torch.rand((len(pages),) + pool.s[:, :, :, 0].shape,
                        generator=g, device=dev)
    engine_model.pages_to_pool(pool, codes, scales, row)
    got, got_s = engine_model.pool_to_pages(pool, row)
    host, host_s = got.cpu().numpy(), got_s.cpu().numpy()
    pool.kv[:, :, :, row] = 0
    pool.s[:, :, :, row] = 0
    engine_model.pages_to_pool(pool, torch.from_numpy(host).to(dev),
                               torch.from_numpy(host_s).to(dev), row)
    back, back_s = engine_model.pool_to_pages(pool, row)
    torch.cuda.synchronize()
    ok = bool(torch.equal(back, codes) and torch.equal(back_s, scales))
    return {"pages": list(pages),
            "bytes": back.numel() + 4 * back_s.numel(), "ok": ok}


def phase_serving_int8(card: str, model_size: str = "8b",
                       device: str = "cuda", n_requests: int = 128,
                       max_tokens: int = 64, long_prompt: int = 6000,
                       n_pages: int = INT8_POOL_PAGES,
                       engine_cfg=None):
    """The int8 engine behind the OpenAI server: n_requests concurrent
    greedy completions of max_tokens with prompts of 20-400 bytes (seed
    3), then one long_prompt-token prompt through the chunked lane into
    the int8 pool. Every request must finish ("length" or "stop", never
    "error") with tokens; K6, K4 and K1 must launch in the window, K2
    not. Tokens/s, TTFT and memory are printed for information, and the
    same burst runs again under the profiler (outside the counted
    window) for the device's busy time and idle share. Returns (the
    record, the closed ServedEngine), whose weights and token streams
    the speculative phase reuses."""
    import torch

    from generativeaiexamples_tpu_torch import kernels

    ecfg = dict(engine_cfg or INT8_DEPLOYMENT)
    served = ServedEngine(model_size, device, engine_cfg=ecfg,
                          n_pages=n_pages, warmup_buckets=[128, 512])
    engine = served.engine
    try:
        prompts = _int8_prompts(n_requests)

        def burst():
            return _burst(served.base, prompts, max_tokens)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        results = burst()
        wall = time.perf_counter() - t0
        metrics = engine.metrics.snapshot()
        g = torch.Generator().manual_seed(7)
        ids = torch.randint(0, 256, (long_prompt,), generator=g).tolist()
        long_rec = _complete(served.base, ids, 8)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        pool = engine.pool
        # Outside the counted window: the same burst again under the
        # profiler, for where its time goes.
        profile = _profile_window(lambda: sum(
            r["completion_tokens"] for r in burst() if r))
    finally:
        served.close()
    # With the engine stopped, a few free pages of its int8 pool make
    # the pager's round trip.
    round_trip = _page_round_trip(pool, engine.allocator._free[-4:])
    tokens = sum(r["completion_tokens"] for r in results if r)
    finished = all(r is not None and r["finish_reason"] in ("length", "stop")
                   and r["completion_tokens"] >= 1 for r in results)
    ok = (finished and long_rec["finish_reason"] in ("length", "stop")
          and long_rec["completion_tokens"] >= 1
          and launches["int8_matmul"] > 0
          and launches["paged_attention_int8"] > 0
          and launches["flash_attention"] > 0
          and launches["paged_attention"] == 0 and round_trip["ok"])
    max_pages = ecfg["max_seq_len"] // ecfg["page_size"]
    default_pages = ecfg["max_batch_size"] * max_pages + max_pages + 1
    rec = {"phase": "serving_int8", "card": card,
           "model": f"llama3_{model_size} random (seed 0), int8 weights "
                    f"quantized at load, int8 KV",
           "engine": ecfg, "layers": engine.cfg.n_layers,
           "reduced": {"n_pages": n_pages, "default_n_pages": default_pages,
                       "pool_gb": pool.nbytes / 1e9,
                       "default_pool_gb": pool.nbytes / n_pages
                       * default_pages / 1e9},
           "engine_build_s": served.build_s, "warmup_s": served.warm_s,
           "requests": n_requests, "max_tokens": max_tokens,
           "prompt_bytes": [int(min(len(p) for p in prompts)),
                            int(max(len(p) for p in prompts))],
           "completion_tokens": tokens,
           "finish_reasons": sorted({r["finish_reason"] for r in results
                                     if r}),
           "wall_s": wall, "tokens_per_s": tokens / wall if wall else None,
           "ttft_p50_ms": metrics["ttft_p50_ms"],
           "ttft_p95_ms": metrics["ttft_p95_ms"],
           "decode_steps": metrics["decode_steps"],
           "mean_batch_occupancy": metrics["mean_batch_occupancy"],
           "long_prompt": {"tokens": long_prompt, **long_rec},
           "launches": launches, "peak_mem_gb": peak_gb,
           "page_round_trip": round_trip, "profile": profile, "ok": ok}
    emit(rec)
    return rec, served


# -- phase 13: greedy self-speculation at 8B ------------------------------

# bench.py's default lattice (k = 3, M = 4, its step plans left off) and
# the r05 official config (k = 1, bench.py:59), on the int8 deployment.
SPEC_INT8_CONFIGS = (("tree_k3_m4", {"speculative_k": 3,
                                     "speculative_tree_branches": 4}),
                     ("linear_k1", {"speculative_k": 1}))


def _first_divergence(got, want):
    """Index of the first token where two streams differ (None if equal)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i
    return None if len(got) == len(want) else min(len(got), len(want))


def phase_spec_int8(card: str, int8_served, device: str = "cuda",
                    n_requests: int = 128, max_tokens: int = 64,
                    n_pages: int = INT8_POOL_PAGES, engine_cfg=None,
                    configs=SPEC_INT8_CONFIGS):
    """Speculative engines on the int8 deployment, over serving_int8's
    quantized weights (its engine and pool are released first), each
    behind the OpenAI server in turn: serving_int8's burst of n_requests
    concurrent greedy max_tokens completions. Every request must finish
    with its tokens; K6 and K4 must launch, K2 and K5 not. The share of
    streams equal token for token to serving_int8's non-speculative
    streams is printed for information: verify projections at B * r
    rows round differently from one-row decode in bf16."""
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.serving.engine import LLMEngine

    old = int8_served.engine
    params, cfg, tokenizer = old.params, old.cfg, old.tokenizer
    base_streams = int8_served.app.streams
    old.pool = None
    del old, int8_served
    gc.collect()
    torch.cuda.empty_cache()
    prompts = _int8_prompts(n_requests)
    recs = []
    for name, spec in configs:
        ecfg = {**(engine_cfg or INT8_DEPLOYMENT), **spec}
        engine = LLMEngine(params, cfg, tokenizer, ecfg, n_pages=n_pages,
                           device=device)
        served = ServedEngine(engine=engine, warmup_buckets=[128, 512])
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t0 = time.perf_counter()
            results = _burst(served.base, prompts, max_tokens)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            metrics = engine.metrics.snapshot()
            peak_gb = torch.cuda.max_memory_allocated() / 2**30
            streams = dict(served.app.streams)  # the counted burst's
            profile = None
            if spec.get("speculative_tree_branches"):
                # Outside the counted window: the same burst again under
                # the profiler, for the split of a verify step between
                # K4, K6, the other device work and the host.
                steps0 = engine.metrics.snapshot()["decode_steps"]
                profile = _profile_window(lambda: sum(
                    r["completion_tokens"] for r in _burst(
                        served.base, prompts, max_tokens) if r))
                steps = engine.metrics.snapshot()["decode_steps"] - steps0
                window = profile["wall_ms"]
                profile["decode_steps"] = steps
                profile["per_step_ms"] = {
                    "wall": window / steps if steps else None,
                    **{k: ms / steps if steps else None
                       for k, ms in profile["port_kernels_ms"].items()},
                    "device_busy": (profile["device_busy_ms"] / steps
                                    if steps else None)}
                profile["shares"] = {
                    "paged_attention_int8": profile["port_kernels_ms"][
                        "paged_attention_int8"] / window,
                    "int8_matmul": profile["port_kernels_ms"][
                        "int8_matmul"] / window,
                    "other_device": (profile["device_busy_ms"] - sum(
                        profile["port_kernels_ms"].values())) / window,
                    "device_idle": profile["device_idle_share"]}
        finally:
            served.close()
        tokenize = tokenizer.encode
        equal, first = 0, None
        for p in prompts:
            ids = tuple(tokenize(p, add_bos=True))
            got = streams.get(ids, [])
            div = _first_divergence(got, base_streams.get(ids, []))
            if div is None:
                equal += 1
            elif first is None or div < first["token"]:
                first = {"prompt_chars": len(p), "token": div}
        tokens = sum(r["completion_tokens"] for r in results if r)
        finished = all(r is not None and (
            r["completion_tokens"] == max_tokens
            or r["finish_reason"] == "stop") for r in results)
        ok = (finished and launches["int8_matmul"] > 0
              and launches["paged_attention_int8"] > 0
              and launches["paged_attention"] == 0
              and launches["paged_attention_tree"] == 0)
        rec = {"phase": "spec_int8", "config": name, "card": card,
               "engine": ecfg, "layers": cfg.n_layers,
               "reduced": {"n_pages": n_pages},
               "engine_build_s": served.build_s, "warmup_s": served.warm_s,
               "requests": n_requests, "max_tokens": max_tokens,
               "completion_tokens": tokens,
               "finish_reasons": sorted({r["finish_reason"] for r in results
                                         if r}),
               "wall_s": wall, "tokens_per_s": tokens / wall if wall else None,
               "spec_tokens_per_step": metrics["spec_tokens_per_step"],
               "spec_committed": metrics["spec_committed"],
               "spec_slot_steps": metrics["spec_slot_steps"],
               "spec_fallback_steps": metrics["spec_fallback_steps"],
               "decode_steps": metrics["decode_steps"],
               "mean_batch_occupancy": metrics["mean_batch_occupancy"],
               "ttft_p50_ms": metrics["ttft_p50_ms"],
               "ttft_p95_ms": metrics["ttft_p95_ms"],
               "peak_mem_gb": peak_gb,
               "streams_equal_to_serving_int8": equal / len(prompts),
               "first_divergence": first,
               "launches": launches, "profile": profile, "ok": ok}
        emit(rec)
        recs.append(rec)
        engine.pool = None
        del engine, served
        gc.collect()
        torch.cuda.empty_cache()
    return recs


def phase_spec_bf16(card: str, bf16_served, device: str = "cuda",
                    n_requests: int = 8, max_tokens: int = 64,
                    spec=(3, 4)):
    """A tree engine (k = 3, M = 4, default batch 8) over the bf16 8B
    weights the serving phases used, behind the OpenAI server:
    n_requests concurrent max_tokens completions, the last of them
    sampled and sent once the greedy ones have run a verify step, so
    dispatches fall back to plain decode while it is live. Every request
    must finish with its tokens; K5 must launch, and K2 only through the
    fallback (at most fallback dispatches x decode_steps_per_dispatch x
    layers launches)."""
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.serving.engine import LLMEngine

    src = bf16_served.engine
    engine = LLMEngine(src.params, src.cfg, src.tokenizer,
                       {"speculative_k": spec[0],
                        "speculative_tree_branches": spec[1]},
                       device=device)
    served = ServedEngine(engine=engine)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        results = [None] * n_requests

        def run(i, sampling):
            results[i] = _complete(served.base, f"Speculative request {i}:",
                                   max_tokens, **sampling)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i, {}))
                   for i in range(n_requests - 1)]
        for t in threads:
            t.start()
        while engine.metrics.spec_slot_steps == 0 and any(
                t.is_alive() for t in threads):
            time.sleep(0.005)
        threads.append(threading.Thread(target=run, args=(
            n_requests - 1, {"temperature": 0.7, "top_p": 0.9, "top_k": 40})))
        threads[-1].start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        metrics = engine.metrics.snapshot()
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
    finally:
        served.close()
    engine.pool = None
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    tokens = sum(r["completion_tokens"] for r in results if r)
    finished = all(r is not None and (r["completion_tokens"] == max_tokens
                                      or r["finish_reason"] == "stop")
                   for r in results)
    k2_cap = (metrics["spec_fallback_steps"]
              * src.ecfg.decode_steps_per_dispatch * src.cfg.n_layers)
    ok = (finished and launches["paged_attention_tree"] > 0
          and launches["flash_attention"] > 0
          and metrics["spec_fallback_steps"] > 0
          and 0 < launches["paged_attention"] <= k2_cap
          and launches["paged_attention_int8"] == 0)
    rec = {"phase": "spec_bf16", "card": card,
           "engine": {"speculative_k": spec[0],
                      "speculative_tree_branches": spec[1],
                      "max_batch_size": src.ecfg.max_batch_size},
           "requests": n_requests, "sampled_requests": 1,
           "max_tokens": max_tokens, "completion_tokens": tokens,
           "finish_reasons": sorted({r["finish_reason"] for r in results
                                     if r}),
           "wall_s": wall, "tokens_per_s": tokens / wall if wall else None,
           "spec_tokens_per_step": metrics["spec_tokens_per_step"],
           "spec_committed": metrics["spec_committed"],
           "spec_slot_steps": metrics["spec_slot_steps"],
           "spec_fallback_steps": metrics["spec_fallback_steps"],
           "ttft_p50_ms": metrics["ttft_p50_ms"],
           "ttft_p95_ms": metrics["ttft_p95_ms"],
           "peak_mem_gb": peak_gb, "launches": launches,
           "k2_launch_cap": k2_cap, "ok": ok}
    emit(rec)
    return rec


# -- phase 11c: the prefix cache and the KV pager at 8B --------------------

PREFIX_ENGINE = {"prefix_cache": True, "kv_pager": True,
                 "prefix_cache_capacity": 0.25, "kv_host_budget_mb": 512}
PREFIX_POOL_PAGES = 257


# Scheduler methods whose host time splits a request's TTFT.
TIMELINE_METHODS = ("_admit_waiting", "_lookup_prefix",
                    "_begin_prefix_prefill", "_dispatch_chunk",
                    "_finish_long_prefill", "_prefill_group",
                    "_dispatch_decode", "_land_next_block")


def _ttft_timeline(engine, run):
    """Host time of the scheduler's methods between the submit of
    `run()`'s one request and its first token: each of TIMELINE_METHODS
    (and `submit`) is wrapped on `engine` for the call (the engine must
    be idle), and per method the calls and milliseconds that started in
    that span are summed. Returns (ttft_ms, {method: [calls, ms]})."""
    log, submits = [], []
    engine.submit = lambda req, _fn=engine.submit: (
        submits.append(req.submit_time), _fn(req))[1]
    for name in TIMELINE_METHODS:
        fn = getattr(engine, name)

        def timed(*a, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                log.append((_name, t0, time.perf_counter()))

        setattr(engine, name, timed)
    try:
        run()
    finally:
        for name in TIMELINE_METHODS + ("submit",):
            delattr(engine, name)
    ttft = engine.metrics.last_ttft_ms
    out = {}
    for name, a, b in log:
        if 0 <= (a - submits[0]) * 1e3 < ttft:
            calls, ms = out.get(name, (0, 0.0))
            out[name] = [calls + 1, ms + (b - a) * 1e3]
    return ttft, out


def _timeline_rec(engine, base, prompt, max_tokens):
    ttft, host = _ttft_timeline(
        engine, lambda: _complete(base, prompt, max_tokens))
    return {"ttft_ms": ttft, "host_ms": host}


def _metric_delta(engine, before, keys):
    after = engine.metrics.snapshot()
    return after, {k: after[k] - before[k] for k in keys}


def phase_prefix(card: str, bf16_served, device: str = "cuda",
                 prefix_len: int = 1536, question_len: int = 40,
                 n_questions: int = 8, session_len: int = 1024,
                 n_sessions: int = 12, n_resume: int = 3,
                 max_tokens: int = 16, n_pages: int = PREFIX_POOL_PAGES,
                 engine_cfg=None, warmup_buckets=(128, 1024, 2048)):
    """An engine with the prefix cache and the KV pager (PREFIX_ENGINE,
    batch 8, page 128, n_pages pool pages) over the bf16 8B weights the
    serving phases used, behind the OpenAI server; raw token-id prompts
    through /v1/completions (no chat template shifts the pages), greedy.

    Shared prefix (the RAG shape): one prefix_len-token prefix (system
    prompt and retrieved context) and n_questions distinct
    question_len-token questions, one after another: the first misses,
    each later one must raise prefix_hit_tokens by page_size x the
    prefix's full pages and prefill_tokens by its suffix only (K1's
    q_offset form). TTFT cold against the hits' p50. Then the same
    prompts at once: hits against lane demotions (the scratch lane is one
    wide, as in the JAX engine).

    Sessions (the pager): n_sessions distinct session_len-token prompts,
    each run twice while resident (the second run, h1, is a hit capped at
    plen - 1: a CoW tail and an unaligned q_offset); the later sessions
    push the first past the cache's capacity into host RAM and the spill
    file. The first n_resume sessions' pages are copied (pool_to_pages)
    right after their h1; resuming them (h2) must promote pages equal to
    that copy bit for bit and give h1's tokens. kv_demotions,
    kv_promotions and kv_spill_writes must be > 0. K1 and K2 must launch
    in both parts."""
    import tempfile

    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.serving import engine_model
    from generativeaiexamples_tpu_torch.serving.engine import LLMEngine

    t_phase = time.perf_counter()
    src = bf16_served.engine
    spill = tempfile.TemporaryDirectory(prefix="kv_spill_")
    ecfg = {**PREFIX_ENGINE, "kv_spill_dir": spill.name,
            **(engine_cfg or {})}
    engine = LLMEngine(src.params, src.cfg, src.tokenizer, ecfg,
                       n_pages=n_pages, device=device)
    served = ServedEngine(engine=engine, warmup_buckets=list(warmup_buckets))
    ps = engine.pool.page_size
    keys = ("prefix_hits", "prefix_miss", "prefix_hit_tokens",
            "prefill_tokens", "kv_demotions", "kv_promotions",
            "kv_spill_writes", "kv_promote_ms")
    g = torch.Generator().manual_seed(11)

    def ids(n):
        return torch.randint(0, 256, (n,), generator=g).tolist()

    def run(prompt):
        before = engine.metrics.snapshot()
        res = _complete(served.base, prompt, max_tokens)
        torch.cuda.synchronize()
        _, d = _metric_delta(engine, before, keys)
        return {**res, "ttft_ms": engine.metrics.last_ttft_ms,
                "tokens": list(served.app.streams[tuple(prompt)]), **d}

    try:
        # -- shared prefix ---------------------------------------------
        prefix = ids(prefix_len)
        prompts = [prefix + ids(question_len) for _ in range(n_questions)]
        full_pages = prefix_len // ps
        torch.cuda.synchronize()
        kernels.reset_launches()
        seq_runs = [run(p) for p in prompts]
        before = engine.metrics.snapshot()
        t0 = time.perf_counter()
        burst = _burst(served.base, prompts, max_tokens)
        burst_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        _, burst_d = _metric_delta(engine, before, keys)
        shared_launches = dict(kernels.LAUNCHES)
        # Outside the counted window: where a resident shared-prefix
        # hit's TTFT goes on the host.
        timeline = {"shared_prefix_hit": _timeline_rec(
            engine, served.base, prompts[-1], max_tokens)}
        cold, hits = seq_runs[0], seq_runs[1:]
        hit_ttft = sorted(r["ttft_ms"] for r in hits)
        shared_ok = (
            cold["prefix_miss"] == 1
            and cold["prefill_tokens"] == len(prompts[0])
            and all(r["prefix_hits"] == 1
                    and r["prefix_hit_tokens"] == full_pages * ps
                    and r["prefill_tokens"] == len(p) - full_pages * ps
                    for r, p in zip(hits, prompts[1:]))
            and all(r is not None and r["completion_tokens"] >= 1
                    for r in burst)
            and burst_d["prefix_miss"] == 0 and burst_d["prefix_hits"] >= 1
            and shared_launches["flash_attention"] > 0
            and shared_launches["paged_attention"] > 0)
        shared = {
            "prefix_tokens": prefix_len, "prefix_full_pages": full_pages,
            "question_tokens": question_len, "requests": n_questions,
            "hit_tokens_each": [r["prefix_hit_tokens"] for r in hits],
            "prefill_tokens_each": [r["prefill_tokens"] for r in seq_runs],
            "ttft_cold_ms": cold["ttft_ms"],
            "ttft_hit_p50_ms": hit_ttft[len(hit_ttft) // 2],
            "ttft_hits_ms": [r["ttft_ms"] for r in hits],
            "burst": {"hits": burst_d["prefix_hits"],
                      "misses": burst_d["prefix_miss"],
                      "lane_demotions": n_questions - burst_d["prefix_hits"]
                      - burst_d["prefix_miss"],
                      "prefill_tokens": burst_d["prefill_tokens"],
                      "wall_s": burst_s},
            "launches": shared_launches, "ok": shared_ok}

        # -- sessions through the pager ---------------------------------
        kernels.reset_launches()
        sessions = [ids(session_len) for _ in range(n_sessions)]
        h1, snaps, sess_runs = [], [], []
        for i, p in enumerate(sessions):
            sess_runs.append(run(p))
            h1.append(run(p))
            if i < n_resume:
                pages = engine.prefix_cache.match(p)
                codes, _ = engine_model.pool_to_pages(
                    engine.pool, torch.tensor(pages, device=engine.device))
                snaps.append((len(pages), codes.cpu()))
        # The spill worker has moved the host tier's oldest pages to disk
        # before the resumes read them.
        spilled = engine.kv_pager.wait_maintenance(60.0)
        mid = engine.metrics.snapshot()
        tiers = [[n.tier for n in engine.prefix_cache.match_nodes(p)]
                 for p in sessions[:n_resume]]
        h2, equal = [], []
        for i, p in enumerate(sessions[:n_resume]):
            h2.append(run(p))
            nodes = engine.prefix_cache.match_nodes(p)[:snaps[i][0]]
            codes, _ = engine_model.pool_to_pages(
                engine.pool, torch.tensor([n.page for n in nodes],
                                          device=engine.device))
            equal.append(bool(torch.equal(codes.cpu().view(torch.int16),
                                          snaps[i][1].view(torch.int16))))
        torch.cuda.synchronize()
        session_launches = dict(kernels.LAUNCHES)
        end = engine.metrics.snapshot()
        # Outside the counted window: where a resident session hit's TTFT
        # goes on the host.
        timeline["session_hit"] = _timeline_rec(engine, served.base,
                                                sessions[-1], max_tokens)
        promoted = end["kv_promotions"] - mid["kv_promotions"]
        capped = session_len - 1
        sess_ok = (
            all(r["prefix_hits"] == 1 and r["prefix_hit_tokens"] == capped
                and r["prefill_tokens"] == 1 for r in h1 + h2)
            and all(equal) and len(equal) == n_resume
            and all(a["tokens"] == b["tokens"] for a, b in zip(h1, h2))
            and spilled and all(t[0] != 0 for t in tiers)  # all demoted
            and end["kv_demotions"] > 0 and promoted > 0
            and end["kv_spill_writes"] > 0
            and session_launches["flash_attention"] > 0
            and session_launches["paged_attention"] > 0)
        sessions_rec = {
            "sessions": n_sessions, "session_tokens": session_len,
            "resumed": n_resume, "max_tokens": max_tokens,
            "capacity_pages": engine.prefix_cache.capacity_pages,
            "host_slots": engine.kv_pager.n_host_slots,
            "h1_hit_tokens": [r["prefix_hit_tokens"] for r in h1],
            "h2_hit_tokens": [r["prefix_hit_tokens"] for r in h2],
            "resume_tiers": tiers,
            "promoted_equal_snapshot": equal,
            "h2_tokens_equal_h1": [a["tokens"] == b["tokens"]
                                   for a, b in zip(h1, h2)],
            "ttft_cold_p50_ms": sorted(r["ttft_ms"] for r in sess_runs)[
                len(sess_runs) // 2],
            "ttft_h1_p50_ms": sorted(r["ttft_ms"] for r in h1)[len(h1) // 2],
            "ttft_h2_ms": [r["ttft_ms"] for r in h2],
            "promoted_pages": promoted,
            "promote_ms_per_page": ((end["kv_promote_ms"]
                                     - mid["kv_promote_ms"]) / promoted
                                    if promoted else None),
            "pager": {k: end[k] for k in end if k.startswith("kv_")},
            "launches": session_launches, "ok": sess_ok}
    finally:
        served.close()
        engine.pool = None
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        spill.cleanup()
    launches = {k: shared_launches[k] + session_launches[k]
                for k in shared_launches}
    rec = {"phase": "prefix", "card": card,
           "engine": {**{k: ecfg[k] for k in PREFIX_ENGINE},
                      "n_pages": n_pages, "page_size": ps,
                      "max_batch_size": src.ecfg.max_batch_size},
           "shared_prefix": shared, "sessions": sessions_rec,
           "ttft_timeline": timeline, "launches": launches,
           "engine_warmup_s": served.warm_s,
           "seconds": time.perf_counter() - t_phase,
           "ok": shared["ok"] and sessions_rec["ok"]}
    emit(rec)
    return rec


# -- phase 15: serve from disk (checkpoints, tokenizer gate, store) ---------

# Where the phase writes its snapshots (inside the ignored build/), and
# removes them when it ends.
CHECKPOINT_DIR = os.path.join("build", "checkpoint_smoke")
# HF names of a Llama layer's tensors, and whether ours is the transpose
# (HF linears are [out, in], the port's [in, out]). Written out here, not
# taken from the loader, so the snapshot is independent of what reads it.
HF_LLAMA_LAYER = (("ln1", "input_layernorm.weight", False),
                  ("ln2", "post_attention_layernorm.weight", False),
                  ("wq", "self_attn.q_proj.weight", True),
                  ("wk", "self_attn.k_proj.weight", True),
                  ("wv", "self_attn.v_proj.weight", True),
                  ("wo", "self_attn.o_proj.weight", True),
                  ("w_gate", "mlp.gate_proj.weight", True),
                  ("w_up", "mlp.up_proj.weight", True),
                  ("w_down", "mlp.down_proj.weight", True))
HF_BERT_LAYER = (("wq", "attention.self.query.weight", True),
                 ("bq", "attention.self.query.bias", False),
                 ("wk", "attention.self.key.weight", True),
                 ("bk", "attention.self.key.bias", False),
                 ("wv", "attention.self.value.weight", True),
                 ("bv", "attention.self.value.bias", False),
                 ("wo", "attention.output.dense.weight", True),
                 ("bo", "attention.output.dense.bias", False),
                 ("ln1_w", "attention.output.LayerNorm.weight", False),
                 ("ln1_b", "attention.output.LayerNorm.bias", False),
                 ("w_in", "intermediate.dense.weight", True),
                 ("b_in", "intermediate.dense.bias", False),
                 ("w_out", "output.dense.weight", True),
                 ("b_out", "output.dense.bias", False),
                 ("ln2_w", "output.LayerNorm.weight", False),
                 ("ln2_b", "output.LayerNorm.bias", False))


def _write_safetensors(path, entries) -> int:
    """A .safetensors file of (name, tensor) entries, each tensor copied
    to the host in turn (bf16 as its 16-bit patterns); the header padded
    to 8 bytes, as the HF writer does. Returns the data bytes."""
    import torch

    names = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, off = {}, 0
    for name, t in entries:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(blob)) + blob)
        for _, t in entries:
            host = t.contiguous().cpu()
            if host.dtype == torch.bfloat16:
                host = host.view(torch.int16)
            fh.write(host.numpy().data)
    return off


def _write_snapshot(path, entries, config, n_shards=1) -> int:
    """An HF snapshot directory: config.json, the entries over `n_shards`
    files of about equal bytes and, when sharded, the
    model.safetensors.index.json naming each tensor's file."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(config, fh, indent=1)
    sizes = [t.numel() * t.element_size() for _, t in entries]
    total, shards, acc = sum(sizes), [[] for _ in range(n_shards)], 0
    for entry, n in zip(entries, sizes):
        shards[min(n_shards - 1, acc * n_shards // total)].append(entry)
        acc += n
    weight_map = {}
    for i, shard in enumerate(shards):
        fname = (f"model-{i + 1:05d}-of-{n_shards:05d}.safetensors"
                 if n_shards > 1 else "model.safetensors")
        _write_safetensors(os.path.join(path, fname), shard)
        weight_map.update({name: fname for name, _ in shard})
    if n_shards > 1:
        with open(os.path.join(path, "model.safetensors.index.json"),
                  "w") as fh:
            json.dump({"metadata": {"total_size": total},
                       "weight_map": weight_map}, fh, indent=1)
    return total


def _llama_snapshot_entries(params, cfg):
    """The served Llama tree under HF LlamaForCausalLM names and layouts
    (views on the device; written one at a time)."""
    entries = [("model.embed_tokens.weight", params["tok_emb"]),
               ("model.norm.weight", params["ln_f"])]
    for i in range(cfg.n_layers):
        for leaf, name, transpose in HF_LLAMA_LAYER:
            w = params["layers"][leaf][i]
            entries.append((f"model.layers.{i}.{name}",
                            w.t() if transpose else w))
    if not cfg.tie_embeddings:
        entries.append(("lm_head.weight", params["lm_head"].t()))
    return entries


def _llama_hf_config(cfg) -> dict:
    import torch

    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.dim,
            "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
            "intermediate_size": cfg.mlp_dim, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.rms_eps,
            "max_position_embeddings": cfg.max_seq_len,
            "tie_word_embeddings": cfg.tie_embeddings,
            "torch_dtype": str(cfg.dtype).replace("torch.", "")
            if cfg.dtype != torch.float32 else "float32"}


def _bert_snapshot(params, cfg, prefixed: bool):
    """(entries, config.json) of an encoder engine's tree (fused QKV split
    back into HF's query, key and value) under HF BERT names: bare, as
    BertModel saves them, or under `bert.` with the pooler and the
    classifier, as BertForSequenceClassification does."""
    lw, D = params["layers"], cfg.dim
    split = {"wq": lw["wqkv"][..., :D], "wk": lw["wqkv"][..., D:2 * D],
             "wv": lw["wqkv"][..., 2 * D:], "bq": lw["bqkv"][..., :D],
             "bk": lw["bqkv"][..., D:2 * D], "bv": lw["bqkv"][..., 2 * D:]}
    pre = "bert." if prefixed else ""
    entries = [(pre + "embeddings.word_embeddings.weight", params["tok_emb"]),
               (pre + "embeddings.position_embeddings.weight",
                params["pos_emb"]),
               (pre + "embeddings.token_type_embeddings.weight",
                params["type_emb"]),
               (pre + "embeddings.LayerNorm.weight", params["emb_ln"]["w"]),
               (pre + "embeddings.LayerNorm.bias", params["emb_ln"]["b"])]
    for i in range(cfg.n_layers):
        for leaf, name, transpose in HF_BERT_LAYER:
            w = (split[leaf] if leaf in split else lw[leaf])[i]
            entries.append((f"{pre}encoder.layer.{i}.{name}",
                            w.t() if transpose else w))
    if cfg.n_labels:
        c = params["classifier"]
        entries += [(pre + "pooler.dense.weight", c["pool_w"].t()),
                    (pre + "pooler.dense.bias", c["pool_b"]),
                    ("classifier.weight", c["w"].t()),
                    ("classifier.bias", c["b"])]
    config = {"model_type": "bert", "vocab_size": cfg.vocab_size,
              "hidden_size": D, "num_hidden_layers": cfg.n_layers,
              "num_attention_heads": cfg.n_heads,
              "intermediate_size": cfg.mlp_dim,
              "max_position_embeddings": cfg.max_position,
              "type_vocab_size": cfg.type_vocab_size,
              "layer_norm_eps": cfg.ln_eps}
    return entries, config


def _bits_equal(a, b) -> bool:
    """Equal shape, dtype and bits (a float compare would take -0 for 0)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    raw = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
           torch.float32: torch.int32}.get(a.dtype)
    return bool(torch.equal(a.view(raw), b.view(raw)) if raw
                else torch.equal(a, b))


def _tree_mismatches(got, want, path="") -> list:
    """Paths of the leaves (codes and scales of a QuantizedTensor) that
    differ in keys, shape, dtype or bits."""
    from generativeaiexamples_tpu_torch.ops.quant import QuantizedTensor

    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [path or "/"]
        return [m for k in sorted(want)
                for m in _tree_mismatches(got[k], want[k], f"{path}/{k}")]
    if isinstance(want, QuantizedTensor):
        if not isinstance(got, QuantizedTensor):
            return [path]
        return [p for p, a, b in ((path + ".q", got.q, want.q),
                                  (path + ".s", got.s, want.s))
                if not _bits_equal(a, b)]
    return [] if _bits_equal(got, want) else [path]


def _tree_bytes(tree) -> int:
    from generativeaiexamples_tpu_torch.ops.quant import QuantizedTensor

    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, QuantizedTensor):
        return tree.q.nbytes + tree.s.nbytes
    return tree.nbytes


def _checkpoint_prompts(vocab: int):
    """Four token-id prompts of 20-100 ids (seed 9)."""
    import numpy as np

    rng = np.random.default_rng(9)
    return [rng.integers(0, min(vocab, 128000), n).tolist()
            for n in rng.integers(20, 101, 4)]


def checkpoint_streams(served: ServedEngine, max_tokens: int = 64):
    """Token streams of the checkpoint prompts through `served`'s OpenAI
    server: one streaming chat completion, then four concurrent greedy
    completions admitted as ONE prefill group (the scheduler is stopped
    until all four wait, so two engines see the same batch shapes and
    their bf16 results can be compared bit for bit)."""
    engine, app = served.engine, served.app
    app.streams.clear()
    chat = _stream_chat(served.base, 32)
    (chat_tokens,) = app.streams.values()
    prompts = _checkpoint_prompts(engine.cfg.vocab_size)
    engine.stop()
    results = [None] * len(prompts)

    def run(i):
        results[i] = _complete(served.base, prompts[i], max_tokens)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    deadline = time.perf_counter() + 60
    while len(engine.waiting) < len(prompts) \
            and time.perf_counter() < deadline:
        time.sleep(0.01)
    grouped = len(engine.waiting) == len(prompts)
    engine.start()
    for t in threads:
        t.join(timeout=600)
    return {"chat": chat, "chat_tokens": chat_tokens, "grouped": grouped,
            "completions": results,
            "tokens": [app.streams.get(tuple(p)) for p in prompts]}


def _pdf_bytes(pages) -> bytes:
    """A minimal PDF, one FlateDecode content stream of text a page."""
    import zlib

    out = (b"%PDF-1.4\n1 0 obj\n<< /Type /Catalog /Pages 2 0 R >>\n"
           b"endobj\n2 0 obj\n<< /Type /Pages /Kids ["
           + b" ".join(b"%d 0 R" % (3 + 2 * i) for i in range(len(pages)))
           + b"] /Count %d >>\nendobj\n" % len(pages))
    for i, text in enumerate(pages):
        num = 3 + 2 * i
        content = zlib.compress(b"BT /F1 12 Tf 72 720 Td (" + text.encode()
                                + b") Tj ET")
        out += (b"%d 0 obj\n<< /Type /Page /Parent 2 0 R /Contents %d 0 R "
                b">>\nendobj\n%d 0 obj\n<< /Length %d /Filter /FlateDecode "
                b">>\nstream\n" % (num, num + 1, num + 1, len(content))
                + content + b"\nendstream\nendobj\n")
    return out + b"trailer\n<< /Root 1 0 R >>\n%%EOF"


CHECKPOINT_PDF = ("Pager spill files hold demoted KV pages on disk.",
                  "Promotion scatters the pages back in one copy.")
CHECKPOINT_HTML = ("<html><head><style>p {margin: 0}</style><script>var "
                   "hidden = 1;</script></head><body><h1>Tokenizer gate</h1>"
                   "<p>A weights-only snapshot falls back to bytes only "
                   "when asked.</p></body></html>")


def _loaded(load):
    """Run `load()` with the device's peak memory counter reset: (result,
    seconds, peak bytes allocated above what was allocated before)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = load()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated() - base


def _largest_layer_bytes(params) -> int:
    """One layer of the largest stacked leaf (in the model dtype): what a
    streaming load may hold beside the tree."""
    return max(v.shape[1:].numel() * v.element_size()
               for v in params["layers"].values())


def _quantizers_match_numpy(device) -> dict:
    """quantize_tensor (per output column) and quantize_kv (per row) on
    the card against the JAX package's arithmetic in numpy (f32 divide,
    round half to even) on seeded values of mixed magnitude (`match`);
    and how many of those values' quotients by 127 differ between a
    division by a host scalar and `div127`'s by a device tensor."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch.ops.quant import (
        div127, quantize_tensor)
    from generativeaiexamples_tpu_torch.serving.paged_attention_int8 import (
        quantize_kv)

    g = torch.Generator(device=device).manual_seed(13)
    w = torch.randn((1024, 4096), generator=g, device=device) \
        * torch.rand((1, 4096), generator=g, device=device)
    wf = w.cpu().numpy()

    def ref(axis):
        amax = np.abs(wf).max(axis=axis, keepdims=True)
        s = np.maximum(amax / np.float32(127), np.float32(1e-8))
        return np.clip(np.round(wf / s), -127, 127).astype(np.int8), \
            np.squeeze(s, axis)

    qt = quantize_tensor(w)
    kq, ks = quantize_kv(w)
    (q0, s0), (q1, s1) = ref(0), ref(-1)
    match = bool(np.array_equal(qt.q.cpu().numpy(), q0)
                 and np.array_equal(qt.s.cpu().numpy(), s0)
                 and np.array_equal(kq.cpu().numpy(), q1)
                 and np.array_equal(ks.cpu().numpy(), s1))
    return {"match": match, "values": w.numel(),
            "host_scalar_div_differs": int((w / 127.0 != div127(w)).sum())}


def _checkpoint_chain(engine, emb, rr, keep, root, device):
    """The chain over the loaded engines with a persisted store: PDF and
    HTML uploads through /documents, a search returning every stored
    chunk with its file, the store's directory reloaded; then the RAG
    phase's 2,001-chunk store saved, reloaded into a fresh store and
    searched with the RAG phase's queries (equal ids and scores)."""
    import numpy as np

    from generativeaiexamples_tpu_torch.api.server import (
        ChainServer, make_http_server)
    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
    from generativeaiexamples_tpu_torch.rag.documents import load_document
    from generativeaiexamples_tpu_torch.rag.vectorstore import (
        DeviceVectorStore)

    chain_dir = os.path.join(root, "chain_store")
    config = load_config(env={}, overrides={
        "vector_store": {"name": "tpu", "persist_dir": chain_dir},
        "reranker": {"enabled": True},
        "embeddings": {"dimensions": emb.dim}})
    hub = EngineHub(config, llm=engine, embed=emb, rerank=rr, device=device)
    app = ChainServer(config, hub=hub, upload_dir=os.path.join(root, "up"))
    httpd = make_http_server(app, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    files = {"ckpt.pdf": _pdf_bytes(CHECKPOINT_PDF),
             "ckpt.html": CHECKPOINT_HTML.encode()}
    try:
        uploads = {}
        for name, data in files.items():
            body, ctype = _multipart(name, data)
            req = urllib.request.Request(base + "/documents", data=body,
                                         headers={"Content-Type": ctype})
            with urllib.request.urlopen(req, timeout=300) as r:
                uploads[name] = json.loads(r.read()).get("message", "")
        store, splitter = app.example.res.store, app.example.res.splitter
        n = len(store)
        with _post(base + "/search", {"query": CHECKPOINT_PDF[0],
                                      "top_k": max(n, 1)}) as r:
            chunks = json.loads(r.read())["chunks"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
        app.close()
    # The chunks each file's extraction gives (on the card's machine HTML
    # goes through the standard-library parser; the log says which).
    want = {}
    for name, data in files.items():
        path = os.path.join(root, "extract_" + name)
        with open(path, "wb") as fh:
            fh.write(data)
        want[name] = sorted(c for d in load_document(path, name)
                            for c in splitter.split(d.text))
    found = {name: sorted(c["content"] for c in chunks
                          if c["filename"] == name) for name in files}
    reopened = DeviceVectorStore(emb.dim, device=device,
                                 persist_dir=chain_dir)
    chain_ok = (all(m.endswith("uploaded successfully")
                    for m in uploads.values())
                and n == 3 and found == want
                and all(found[f] for f in files)
                and reopened.list_documents() == sorted(files)
                and len(reopened) == n)

    # The RAG phase's ingested store: save, reload, same hits.
    src = keep["store"]
    store_dir = os.path.join(root, "rag_store")
    t0 = time.perf_counter()
    src.save(store_dir)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fresh = DeviceVectorStore.load(store_dir, src.dim, device=device)
    load_s = time.perf_counter() - t0
    qv = np.stack([keep["emb"].embed_query(q) for q in keep["queries"]])
    a = src.search_batch(qv, top_k=10)
    b = fresh.search_batch(qv, top_k=10)
    same_ids = [[h.text for h in x] for x in a] == \
        [[h.text for h in x] for x in b]
    same_scores = [[h.score for h in x] for x in a] == \
        [[h.score for h in x] for x in b]
    store_rec = {"chunks": len(src), "reloaded": len(fresh),
                 "bytes_on_disk": sum(
                     os.path.getsize(os.path.join(store_dir, f))
                     for f in os.listdir(store_dir)),
                 "save_s": save_s, "load_s": load_s,
                 "queries": len(keep["queries"]), "same_ids": same_ids,
                 "same_scores": same_scores}
    del fresh, reopened
    return {"uploads": uploads, "chunks_stored": n,
            "search_found": {f: len(v) for f, v in found.items()},
            "documents_reopened": sorted(files), "chain_ok": chain_ok,
            "rag_store": store_rec,
            "ok": chain_ok and same_ids and same_scores
            and len(src) == store_rec["reloaded"]}


def phase_checkpoint(card: str, src_params, src_cfg, ref: dict, keep: dict,
                     device: str = "cuda", engine_cfg=None,
                     int8_cfg=None, int8_pages: int = 1025,
                     n_requests: int = 32, max_tokens: int = 32) -> dict:
    """Serve from disk. The served bf16 8B engine's own weights
    (`src_params`, kept when its engine went) are written as an HF
    snapshot (four shards, an index, config.json at the published
    widths) and the RAG phase's encoders as two BERT snapshots, under the
    ignored build/ (free disk checked first), all removed at the end.
    Then, each loaded model freed before the next:

    - the tokenizer gate: `load_tokenizer` on the weights-only 8B
      snapshot must raise unless GAIE_BYTE_TOKENIZER_FALLBACK=1 (set for
      the rest of the phase, as these snapshots have no tokenizer);
    - encoders: `load_bert` trees bit-identical to the in-memory
      encoders', then `build_encoders` from the two paths: embeddings
      and scores of a few texts bit-identical to the in-memory ones;
      K3 must launch;
    - bf16: `load_llama(device="cuda")` (time, GB/s, peak device memory
      against the tree's bytes) bit-identical leaf by leaf; then
      `build_engine(weights_path=...)` behind the OpenAI server: its
      streaming chat and four concurrent 64-token greedy completions
      must equal the served engine's tokens (`ref`); K1 and K2 must
      launch; the chain over it: PDF and HTML through /documents into a
      persisted store, and the RAG store saved and reloaded;
    - int8: `load_llama(quantize=True)` (peak device memory at most the
      int8 tree plus one bf16 layer of the largest leaf), codes and
      scales bit-identical to the loader's quantizer applied on the card
      to the source bf16 weights, layer 0 of each int8 leaf also to the
      JAX loader's numpy arithmetic (and `quantize_tensor` /
      `quantize_kv` to the JAX package's, on seeded values); then the
      int8 deployment built from the path serves `n_requests`
      concurrent completions: K6 and K4 must launch, K2 not."""
    import numpy as np
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.models import bert as bert_lib
    from generativeaiexamples_tpu_torch.models.hf_loader import (
        load_bert, load_llama)
    from generativeaiexamples_tpu_torch.ops.quant import (
        LLAMA_QUANT_KEYS, quantize_for_load)
    from generativeaiexamples_tpu_torch.serving.__main__ import (
        build_encoders, build_engine)
    from generativeaiexamples_tpu_torch.utils.tokenizer import (
        ByteTokenizer, load_tokenizer)

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        CHECKPOINT_DIR)
    llm_dir = os.path.join(root, "llama")
    emb_dir, rr_dir = os.path.join(root, "embed"), os.path.join(root, "rerank")
    emb_src, rr_src = keep["emb"], keep["rr"]
    llm_entries = _llama_snapshot_entries(src_params, src_cfg)
    tree_bytes = sum(t.numel() * t.element_size() for _, t in llm_entries)
    need = tree_bytes + 2 * _tree_bytes(emb_src.params) \
        + 2 * _tree_bytes(rr_src.params) + (1 << 30)
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    if free < need:
        raise RuntimeError(f"checkpoint phase: {free / 1e9:.2f} GB free "
                           f"under {root}, {need / 1e9:.2f} GB needed")
    launches = {}
    old_env = os.environ.pop("GAIE_BYTE_TOKENIZER_FALLBACK", None)
    rec = {"phase": "checkpoint", "card": card, "disk_free_gb": free / 1e9}
    try:
        t0 = time.perf_counter()
        _write_snapshot(llm_dir, llm_entries, _llama_hf_config(src_cfg),
                        n_shards=4)
        write_s = time.perf_counter() - t0
        del llm_entries
        for path, src, prefixed in ((emb_dir, emb_src, False),
                                    (rr_dir, rr_src, True)):
            entries, config = _bert_snapshot(src.params, src.cfg, prefixed)
            _write_snapshot(path, entries, config)
        rec["write"] = {"llm_bytes": tree_bytes, "llm_s": write_s,
                        "llm_gb_per_s": tree_bytes / write_s / 1e9,
                        "files": sorted(os.listdir(llm_dir))}

        # The tokenizer gate on the weights-only 8B snapshot.
        try:
            load_tokenizer(llm_dir)
            gate_raised = False
        except FileNotFoundError:
            gate_raised = True
        os.environ["GAIE_BYTE_TOKENIZER_FALLBACK"] = "1"
        rec["tokenizer_gate"] = {
            "raised_without_fallback": gate_raised,
            "byte_with_fallback": isinstance(load_tokenizer(llm_dir),
                                             ByteTokenizer)}

        # Encoders.
        loaded_e, _ = load_bert(emb_dir, dtype=emb_src.cfg.dtype,
                                device=device)
        loaded_r, _ = load_bert(rr_dir, n_labels=1, dtype=rr_src.cfg.dtype,
                                device=device)
        enc_mismatch = (
            _tree_mismatches(bert_lib.fuse_qkv_params(loaded_e),
                             emb_src.params, "embed")
            + _tree_mismatches(bert_lib.fuse_qkv_params(loaded_r),
                               rr_src.params, "rerank"))
        del loaded_e, loaded_r
        emb, rr = build_encoders(device, embed_path=emb_dir,
                                 rerank_path=rr_dir)
        texts = list(keep["queries"]) + list(CHECKPOINT_PDF)
        torch.cuda.synchronize()
        kernels.reset_launches()
        got_e = emb.embed(texts)
        got_s = rr.score(keep["queries"][0], texts)
        torch.cuda.synchronize()
        launches["encoders"] = dict(kernels.LAUNCHES)
        same_e = np.array_equal(got_e, emb_src.embed(texts))
        same_s = np.array_equal(got_s, rr_src.score(keep["queries"][0],
                                                    texts))
        enc_ok = (not enc_mismatch and same_e and same_s
                  and launches["encoders"]["encoder_attention"] > 0)
        rec["encoders"] = {"mismatched_leaves": enc_mismatch,
                           "embed_shape": list(got_e.shape),
                           "embeddings_bit_identical": same_e,
                           "scores_bit_identical": same_s}

        # bf16: the load measured, then the engine built from the path.
        params, load_s, peak = _loaded(
            lambda: load_llama(llm_dir, device=device,
                               dtype=src_cfg.dtype)[0])
        mismatch = _tree_mismatches(params, src_params)
        loaded_bytes = _tree_bytes(params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        rec["bf16"] = {"load_s": load_s,
                       "read_gb_per_s": loaded_bytes / load_s / 1e9,
                       "tree_bytes": loaded_bytes, "peak_bytes": peak,
                       "peak_over_tree_bytes": peak - loaded_bytes,
                       "mismatched_leaves": mismatch}
        t0 = time.perf_counter()
        served = ServedEngine(engine=build_engine(
            device=device, warmup=False, engine_cfg=engine_cfg,
            weights_path=llm_dir), warmup_buckets=[128])
        rec["bf16"]["engine_build_s"] = time.perf_counter() - t0
        try:
            torch.cuda.synchronize()
            kernels.reset_launches()
            got = checkpoint_streams(served)
            torch.cuda.synchronize()
            launches["bf16"] = dict(kernels.LAUNCHES)
            chain = _checkpoint_chain(served.engine, emb, rr, keep, root,
                                      device)
        finally:
            served.close()
        streams_equal = (got["chat_tokens"] == ref["chat_tokens"]
                         and got["tokens"] == ref["tokens"]
                         and all(t for t in ref["tokens"]))
        rec["bf16"].update({
            "grouped": [ref["grouped"], got["grouped"]],
            "chat_tokens": len(got["chat_tokens"]),
            "completion_tokens": [len(t or []) for t in got["tokens"]],
            "streams_equal_served": streams_equal})
        rec["chain"] = chain
        del served, emb, rr
        gc.collect()
        torch.cuda.empty_cache()

        # int8: the load measured, then the deployment from the path.
        qparams, qload_s, qpeak = _loaded(
            lambda: load_llama(llm_dir, device=device, dtype=src_cfg.dtype,
                               quantize=True)[0])
        int8_bytes = _tree_bytes(qparams)
        allowance = _largest_layer_bytes(src_params)
        qmismatch, host_checked = [], []
        for key in LLAMA_QUANT_KEYS:
            w = src_params["layers"][key]
            for layer in range(w.shape[0]):
                want = quantize_for_load(w[layer])
                got_q = qparams["layers"][key][layer]
                if not (_bits_equal(got_q.q, want.q)
                        and _bits_equal(got_q.s, want.s)):
                    qmismatch.append(f"{key}[{layer}]")
            # The JAX loader's numpy arithmetic on layer 0, on the host.
            af = w[0].float().cpu().numpy()
            amax = np.abs(af).max(axis=-2, keepdims=True).clip(1e-8)
            s = (amax / 127.0).astype(np.float32)
            q = np.clip(np.round(af / s), -127, 127).astype(np.int8)
            got_q = qparams["layers"][key][0]
            host_checked.append(key)
            if not (np.array_equal(got_q.q.cpu().numpy(), q)
                    and np.array_equal(got_q.s.cpu().numpy(), s[0])):
                qmismatch.append(f"{key}[0] vs numpy")
        if "lm_head" in src_params:
            want = quantize_for_load(src_params["lm_head"])
            if not (_bits_equal(qparams["lm_head"].q, want.q)
                    and _bits_equal(qparams["lm_head"].s, want.s)):
                qmismatch.append("lm_head")
            del want
        qmismatch += [p for p in _tree_mismatches(
            {k: qparams[k] for k in ("tok_emb", "ln_f")},
            {k: src_params[k] for k in ("tok_emb", "ln_f")})]
        qmismatch += _tree_mismatches(
            {k: qparams["layers"][k] for k in ("ln1", "ln2")},
            {k: src_params["layers"][k] for k in ("ln1", "ln2")})
        del qparams
        gc.collect()
        torch.cuda.empty_cache()
        rec["int8"] = {"load_s": qload_s,
                       "read_gb_per_s": tree_bytes / qload_s / 1e9,
                       "int8_tree_bytes": int8_bytes, "peak_bytes": qpeak,
                       "allowance_bytes": allowance,
                       "peak_within": qpeak <= int8_bytes + allowance,
                       "host_checked_layer0": host_checked,
                       "mismatched": qmismatch,
                       "quantizers_vs_numpy":
                       _quantizers_match_numpy(device)}
        ecfg = {**(int8_cfg or INT8_DEPLOYMENT)}
        served = ServedEngine(engine=build_engine(
            device=device, warmup=False, engine_cfg=ecfg,
            n_pages=int8_pages, weights_path=llm_dir),
            warmup_buckets=[128])
        try:
            prompts = _int8_prompts(n_requests)
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            results = _burst(served.base, prompts, max_tokens)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches["int8"] = dict(kernels.LAUNCHES)
        finally:
            served.close()
        tokens = sum(r["completion_tokens"] for r in results if r)
        int8_served_ok = all(
            r is not None and r["finish_reason"] in ("length", "stop")
            and r["completion_tokens"] >= 1 for r in results)
        rec["int8"].update({"requests": n_requests, "completion_tokens":
                            tokens, "wall_s": wall,
                            "tokens_per_s": tokens / wall if wall else None,
                            "served_ok": int8_served_ok})
        del served
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if old_env is None:
            os.environ.pop("GAIE_BYTE_TOKENIZER_FALLBACK", None)
        else:
            os.environ["GAIE_BYTE_TOKENIZER_FALLBACK"] = old_env
    total = {name: sum(v.get(name, 0) for v in launches.values())
             for name in kernels.SIGNATURES}
    ok = (rec["tokenizer_gate"]["raised_without_fallback"]
          and rec["tokenizer_gate"]["byte_with_fallback"]
          and enc_ok and not mismatch and streams_equal
          and ref["grouped"] and got["grouped"]
          and launches["bf16"]["flash_attention"] > 0
          and launches["bf16"]["paged_attention"] > 0
          and chain["ok"] and not qmismatch
          and rec["int8"]["quantizers_vs_numpy"]["match"]
          and rec["int8"]["peak_within"] and int8_served_ok
          and launches["int8"]["int8_matmul"] > 0
          and launches["int8"]["paged_attention_int8"] > 0
          and launches["int8"]["paged_attention"] == 0)
    rec.update({"launches": total, "launches_by_model": launches,
                "snapshot_removed": not os.path.exists(root),
                "seconds": time.perf_counter() - t_phase, "ok": ok})
    emit(rec)
    return rec


# -- K1, K3, K4 and K6 against another tree (--compare-parent) -------------

# (name, B, H, KH, Sq, Sk, lengths, q_offset) at head_dim 128, causal.
AB_FLASH = (("8b_s2048", 4, 32, 8, 2048, 2048, [2048] * 4, [0] * 4),
            ("8b_chunk_q_offset", 1, 32, 8, 2048, 8192, [6000], [4096]))


def time_kernels() -> dict:
    """K1-K6 times through the public wrappers of whichever port package
    is first on sys.path: AB_FLASH, K2's, K3's, K4's and K5's timed cases
    (K2, K4 and K5 alternating two layers as in their phases; these also
    with their device time, `<case>_device`, since a small case's loop
    time is the host's; K2 and K5 with their host time, `<case>_host`,
    and K2's 8b_short with a CPU profile of a call), and every
    K6_SHAPES x K6_ROWS case (the weights rotated through copies as in
    int8_mm_case)."""
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.ops import attention as attn
    from generativeaiexamples_tpu_torch.ops.int8_matmul import int8_matmul
    from generativeaiexamples_tpu_torch.ops.quant import quantize_tensor

    from generativeaiexamples_tpu_torch.ops import encoder_attention as ea
    from generativeaiexamples_tpu_torch.serving import paged_attention as pa
    from generativeaiexamples_tpu_torch.serving import (
        paged_attention_int8 as pa8)
    from generativeaiexamples_tpu_torch.serving import (
        paged_attention_tree as pt)

    kernels.build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    ms = {}
    for name, B, H, KH, Sq, Sk, lengths, q_offset in AB_FLASH:
        q = torch.randn((B, H, Sq, 128), generator=g, device=dev).bfloat16()
        k = torch.randn((B, KH, Sk, 128), generator=g, device=dev).bfloat16()
        v = torch.randn((B, KH, Sk, 128), generator=g, device=dev).bfloat16()
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        off = torch.tensor(q_offset, dtype=torch.int32, device=dev)
        ms[name] = time_ms(lambda: attn.flash_attention(
            q, k, v, causal=True, lengths=ln, q_offset=off))
    for name, B, lengths, seed in K2_TIMED:
        q, kp, vp, table, ln = _paged_inputs(B, 32, 8, 128, 128, 64,
                                             lengths, seed)
        turn = [0]

        def k2():
            turn[0] ^= 1
            pa.paged_attention(q, kp[turn[0]], vp[turn[0]], table, ln)

        ms[f"k2_{name}"] = time_ms(k2)
        ms[f"k2_{name}_device"] = device_ms(k2, KERNEL_FUNCTIONS[
            "paged_attention"])
        ms[f"k2_{name}_host"] = host_ms(k2)
        if name == "8b_short":  # host-bound: where a call's time goes
            ms[f"k2_{name}_host_profile"] = host_profile(k2)
        del kp, vp
        torch.cuda.empty_cache()
    for name, B, maxp, lengths, tree, seed in K5_TIMED:
        q, kp, vp, table, ln, _ = _tree_inputs(B, 32, 8, 128, 128, maxp,
                                               lengths, tree, seed, False)
        turn = [0]

        def k5():
            turn[0] ^= 1
            pt.paged_tree_attention(q, kp[turn[0]], vp[turn[0]], table, ln,
                                    tree)

        ms[f"k5_{name}"] = time_ms(k5)
        ms[f"k5_{name}_device"] = device_ms(k5, KERNEL_FUNCTIONS[
            "paged_attention_tree"])
        ms[f"k5_{name}_host"] = host_ms(k5)
        del kp, vp
        torch.cuda.empty_cache()
    for name, B, H, S, lengths, seed in _encoder_timed_cases():
        q, k, v, ln = _encoder_inputs(B, H, S, lengths, seed, True)

        def k3():
            ea.encoder_attention(q, k, v, ln)

        ms[f"k3_{name}"] = time_ms(k3)
        ms[f"k3_{name}_device"] = device_ms(k3, KERNEL_FUNCTIONS[
            "encoder_attention"])
    for name, B, maxp, lengths, seed, R, tree in _paged_int8_timed_cases():
        q, kv, sc, table, ln, _ = _paged_int8_inputs(
            B, 32, 8, 128, 128, maxp, lengths, 2, 1, seed, False, R)
        turn = [0]

        def alternating():
            turn[0] ^= 1
            pa8.paged_attention_int8(q, kv, sc, table, ln, turn[0], q_rep=R,
                                     tree=tree)

        ms[f"k4_{name}"] = time_ms(alternating)
        ms[f"k4_{name}_device"] = device_ms(alternating, KERNEL_FUNCTIONS[
            "paged_attention_int8"])
        del kv, sc
        torch.cuda.empty_cache()
    for wname, (K, M) in K6_SHAPES.items():
        qt = quantize_tensor(torch.randn((K, M), generator=g, device=dev)
                             * K ** -0.5)
        copies = [qt.q] + [qt.q.clone() for _ in range(
            min(15, int(150e6 // (K * M))))]
        for R in K6_ROWS:
            x = torch.randn((R, K), generator=g, device=dev).bfloat16()
            turn = [0]

            def kernel():
                turn[0] = (turn[0] + 1) % len(copies)
                int8_matmul(x, copies[turn[0]], qt.s)

            ms[f"{wname}_r{R}"] = time_ms(kernel)
        del copies, qt
        torch.cuda.empty_cache()
    return ms


# -- plan variants of K4 (--variants) ---------------------------------------

# K4's plan variants at its timed cases: fields of paged_int8_plan's
# result replaced ({} is the shipped plan).
K4_PLAN_VARIANTS = (
    ("8b_decode", {}), ("8b_decode", {"key_slices": 4}),
    ("8b_decode", {"pages_per_split": 8}),
    ("8b_decode", {"pages_per_split": 32}),
    ("qrep2_b8", {}), ("qrep2_b8", {"key_slices": 4}),
    ("8b_b128", {}), ("8b_b128", {"key_slices": 8}),
    ("8b_b128", {"key_slices": 2}),
    ("tree34_b128", {}), ("tree34_b128", {"key_slices": 1}),
    ("tree34_burst", {}), ("tree34_burst", {"key_slices": 1}))


def kernel_variants() -> list:
    """K4's plan variants at its timed cases, in one process on one card:
    each checked against its plain version (max error relative to each
    row's max |out|) and timed (loop and device)."""
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.serving import (
        paged_attention_int8 as pa8)

    kernels.build(["paged_attention_int8"])
    rows = []
    cases = {c[0]: c for c in _paged_int8_timed_cases()}
    shipped = pa8.paged_int8_plan
    for name, override in K4_PLAN_VARIANTS:
        _, B, maxp, lengths, seed, R, tree = cases[name]
        q, kv, sc, table, ln, _ = _paged_int8_inputs(
            B, 32, 8, 128, 128, maxp, lengths, 2, 1, seed, False, R)

        def plan(B_, KH, rows_, Hd, ps, maxp_, n_sms):
            p = shipped(B_, KH, rows_, Hd, ps, maxp_, n_sms)._replace(
                **override)
            splits = -(-maxp_ // p.pages_per_split)
            step = 32 if (ps // p.key_slices) % 32 == 0 else 16
            ws = (4 * B_ * KH * splits * p.row_tiles * (Hd // 2 + 4) * 32
                  if splits > 1 else 0)
            return p._replace(keys_per_step=step, splits=splits,
                              workspace_bytes=ws)

        turn = [0]

        def kernel():
            turn[0] ^= 1
            return pa8.paged_attention_int8(q, kv, sc, table, ln, turn[0],
                                            q_rep=R, tree=tree)

        pa8.paged_int8_plan = plan
        try:
            got = kernel().float().reshape(B * R, -1)
            want = pa8.paged_attention_int8_rep_reference(
                (q if R > 1 else q[:, None]).float(), kv[:, 1], sc[:, 1],
                table, ln.clamp(min=1), tree=tree).reshape(B * R, -1)
            rel = float(((got - want).abs().amax(1)
                         / want.abs().amax(1)).max())
            rows.append({"kernel": "paged_attention_int8", "case": name,
                         "plan": plan(B, 8, 4 * R, 128, 128, maxp,
                                      n_sms())._asdict(),
                         "shipped_plan": not override,
                         "max_row_rel_err": rel, "ms": time_ms(kernel),
                         "device_ms": device_ms(kernel, KERNEL_FUNCTIONS[
                             "paged_attention_int8"])})
        finally:
            pa8.paged_int8_plan = shipped
        del kv, sc
        torch.cuda.empty_cache()
    return rows


# K2's and K5's plan variants at their timed cases: (kernel, case, fields
# of paged_bf16_plan's result replaced; {} is the shipped plan).
# The first plan of this design (64-slot stages, 3 deep, 2 CTAs an SM
# targeted, no shortest run) is kept as a variant of each.
BF16_PLAN_VARIANTS = (
    ("paged_attention", "8b_decode", {}),
    ("paged_attention", "8b_decode", {"stage_keys": 64, "key_slices": 4,
                                      "ring_stages": 3,
                                      "pages_per_split": 16}),
    ("paged_attention", "8b_decode", {"pages_per_split": 16}),
    ("paged_attention", "8b_decode", {"pages_per_split": 8}),
    ("paged_attention", "8b_decode", {"ring_stages": 3}),
    ("paged_attention", "8b_decode", {"key_slices": 4}),
    ("paged_attention", "8b_b1_6000", {}),
    ("paged_attention", "8b_b1_6000", {"stage_keys": 64, "key_slices": 4,
                                       "ring_stages": 3,
                                       "pages_per_split": 2}),
    ("paged_attention", "8b_b1_6000", {"pages_per_split": 2}),
    ("paged_attention", "8b_b1_6000", {"pages_per_split": 8}),
    ("paged_attention", "8b_b1_6000", {"ring_stages": 3}),
    ("paged_attention", "8b_short", {}),
    ("paged_attention", "8b_short", {"pages_per_split": 64}),
    ("paged_attention_tree", "8b_tree34", {}),
    ("paged_attention_tree", "8b_tree34", {"stage_keys": 64,
                                           "ring_stages": 3,
                                           "pages_per_split": 17}),
    ("paged_attention_tree", "8b_tree34", {"pages_per_split": 17}),
    ("paged_attention_tree", "8b_tree34", {"pages_per_split": 8}),
    ("paged_attention_tree", "8b_tree34", {"ring_stages": 3}),
    ("paged_attention_tree", "8b_tree34", {"key_slices": 1}))


def bf16_variants() -> list:
    """K2's and K5's plan variants at their timed cases, in one process
    on one card: each checked against its plain version (K2: max abs
    error; K5: max error relative to each node's max |out|) and timed
    (loop and device, alternating two layers)."""
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.serving import paged_attention as pa
    from generativeaiexamples_tpu_torch.serving import (
        paged_attention_tree as pt)

    kernels.build(["paged_attention", "paged_attention_tree"])
    k2_cases = {c[0]: c for c in K2_TIMED}
    k5_cases = {c[0]: c for c in K5_TIMED}
    shipped = pa.paged_bf16_plan
    rows = []
    for kernel_name, name, override in BF16_PLAN_VARIANTS:
        tree = None
        if kernel_name == "paged_attention":
            _, B, lengths, seed = k2_cases[name]
            maxp = 64
            q, kp, vp, table, ln = _paged_inputs(B, 32, 8, 128, 128, maxp,
                                                 lengths, seed)
        else:
            _, B, maxp, lengths, tree, seed = k5_cases[name]
            q, kp, vp, table, ln, _ = _tree_inputs(
                B, 32, 8, 128, 128, maxp, lengths, tree, seed, False)

        def plan(B_, KH, rows_, Hd, ps, maxp_, n_sms_):
            p = shipped(B_, KH, rows_, Hd, ps, maxp_, n_sms_)._replace(
                **override)
            splits = -(-maxp_ // p.pages_per_split)
            width = p.stage_keys // p.key_slices
            ws = (4 * B_ * KH * splits * p.row_tiles * (Hd // 2 + 4) * 32
                  if splits > 1 else 0)
            return p._replace(keys_per_step=32 if width % 32 == 0 else 16,
                              splits=splits, workspace_bytes=ws)

        turn = [0]

        def kernel():
            turn[0] ^= 1
            if tree is None:
                return pa.paged_attention(q, kp[turn[0]], vp[turn[0]],
                                          table, ln)
            return pt.paged_tree_attention(q, kp[turn[0]], vp[turn[0]],
                                           table, ln, tree)

        pa.paged_bf16_plan = plan
        try:
            turn[0] = 0  # the next call reads layer 1
            got = kernel().float()
            if tree is None:
                want = pa.paged_attention_reference(
                    q.float(), kp[1].float(), vp[1].float(), table, ln)
                err = {"max_abs_err": float((got - want).abs().max())}
            else:
                want = pa.paged_tree_attention_reference(
                    q.float(), kp[1].float(), vp[1].float(), table,
                    ln.clamp(min=1), pt._canonical_tree(*tree))
                diff = (got - want).abs().amax((1, 3))        # [B, r]
                err = {"max_node_rel_err": float((
                    diff / want.abs().amax((1, 3))).max())}
            group_rows = 4 * (q.shape[2] if tree is not None else 1)
            rows.append({"kernel": kernel_name, "case": name,
                         "plan": plan(B, 8, group_rows, 128, 128, maxp,
                                      n_sms())._asdict(),
                         "shipped_plan": not override, **err,
                         "ms": time_ms(kernel),
                         "device_ms": device_ms(kernel, KERNEL_FUNCTIONS[
                             kernel_name]),
                         "host_ms": host_ms(kernel)})
        finally:
            pa.paged_bf16_plan = shipped
        del kp, vp, got, want
        torch.cuda.empty_cache()
    return rows


def compare_parent(parent: str) -> dict:
    """time_kernels of the tree at `parent` and of this one in turns
    (parent, change, change, parent), each in its own process on the
    same card; {case: [four ms]}."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for root in (parent, here, here, parent):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time-kernels",
             os.path.abspath(root)], capture_output=True, text=True,
            timeout=900)
        if out.returncode != 0:
            raise RuntimeError(f"--time-kernels {root} failed "
                               f"(rc {out.returncode}):\n{out.stderr[-4000:]}")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    return {case: [r[case] for r in runs] for case in runs[0]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU only",
              file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--time-kernels":
        # The port package of another tree (e.g. an unpacked parent).
        sys.path.insert(0, args[1])
        emit(time_kernels())
        return 0
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if len(args) == 2 and args[0] == "--compare-parent":
        emit({"card": nvidia_smi(), "order": "parent, change, change, parent",
              "compare_parent_ms": compare_parent(args[1])})
        return 0
    if args == ["--variants"]:
        emit({"card": nvidia_smi(),
              "variants": kernel_variants() + bf16_variants()})
        return 0
    if args:
        print("usage: chip_smoke.py [--compare-parent DIR | "
              "--time-kernels DIR | --variants]", file=sys.stderr)
        return 2
    try:
        from generativeaiexamples_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}",
              file=sys.stderr)
        return 2
    # Plain f32 matmuls in full precision on the card (the references).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = nvidia_smi()
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    t0 = time.perf_counter()
    secs = kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": secs,
          "ptxas": {n: _ptxas_summary(n) for n in kernels.SIGNATURES}})

    flash = phase_flash()
    paged = phase_paged()
    encoder = phase_encoder()
    paged_int8 = phase_paged_int8()
    tree = phase_tree()
    int8_mm = phase_int8_matmul()
    model = phase_model()
    served = ServedEngine("8b", "cuda")
    rag_keep = {}
    try:
        serving = phase_serving(card, served)
        chunked = phase_chunked(served)
        rag = phase_rag(card, served, keep=rag_keep)
        chain = phase_chain(card, served, rag_keep)
        spec_bf16 = phase_spec_bf16(card, served)
        prefix = phase_prefix(card, served)
        # What the engine loaded from the snapshot of these weights must
        # give, taken before this engine goes.
        ckpt_ref = checkpoint_streams(served)
    finally:
        served.close()
    # The bf16 engine's pool and the RAG phase's 1M-row store go before
    # the int8 engine comes; its weights, encoders and ingested store stay
    # for the checkpoint phase (~16 GB beside the int8 phases' ~45).
    bf16_params, bf16_cfg = served.engine.params, served.engine.cfg
    del served
    gc.collect()
    torch.cuda.empty_cache()
    serving_int8, int8_served = phase_serving_int8(card)
    spec_int8 = phase_spec_int8(card, int8_served)
    del int8_served
    gc.collect()
    torch.cuda.empty_cache()
    checkpoint = phase_checkpoint(card, bf16_params, bf16_cfg, ckpt_ref,
                                  rag_keep)
    del bf16_params, rag_keep

    line = []
    for name, rep, cases, main_case, launches, tol in (
            ("flash_attention", K1_REPLACES, flash, "8b_s2048",
             serving["launches"], BF16_ATOL),
            ("paged_attention", K2_REPLACES, paged, "8b_decode",
             serving["launches"], BF16_ATOL),
            ("encoder_attention", K3_REPLACES, encoder, "arctic_s512",
             rag["launches"], BF16_ATOL),
            ("paged_attention_int8", K4_REPLACES, paged_int8, "8b_decode",
             serving_int8["launches"],
             f"{PAGED_INT8_RTOL} x max|out| of each row"),
            ("paged_attention_tree", K5_REPLACES, tree, "8b_tree34",
             spec_bf16["launches"],
             f"{TREE_RTOL} x max|out| of each (row, node)"),
            ("int8_matmul", K6_REPLACES, int8_mm, "w_gate_up_r8",
             serving_int8["launches"], f"{INT8_MM_RTOL} x max|y|")):
        c = next(c for c in cases if c["case"] == main_case)
        line.append({
            "name": name, "route": "cuda",
            "source": f"generativeaiexamples_tpu_torch/csrc/{name}.cu",
            "replaces": rep, "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tol": tol, "parity_ok": all(c["ok"] for c in cases),
            "case": main_case, "ms": c["ms"], "device_ms": c.get("device_ms"),
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"]})
    # K4's verify forms (launched on spec_int8's path).
    k4 = next(e for e in line if e["name"] == "paged_attention_int8")
    k4["spec_launches"] = {r["config"]: r["launches"]["paged_attention_int8"]
                           for r in spec_int8}
    k4["verify_cases"] = {
        c["case"]: {k: c[k] for k in ("q_rep", "tree", "ms", "device_ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "library_ms", "sdpa_gathered_ms",
                                      "sdpa_gathered_device_ms")}
        for c in paged_int8 if c["q_rep"] > 1 and "ms" in c}
    main_k4 = next(c for c in paged_int8 if c["case"] == "8b_decode")
    k4["sdpa_gathered_ms"] = main_k4["sdpa_gathered_ms"]
    k4["sdpa_gathered_device_ms"] = main_k4["sdpa_gathered_device_ms"]
    k4["cases"] = {c["case"]: {k: c[k] for k in (
        "ms", "device_ms", "bound_ms", "sdpa_gathered_ms",
        "sdpa_gathered_device_ms", "plan")} for c in paged_int8
        if c["q_rep"] == 1 and "ms" in c}
    k3 = next(e for e in line if e["name"] == "encoder_attention")
    k3["cases"] = {c["case"]: {k: c[k] for k in (
        "ms", "device_ms", "bound_ms", "library_ms", "library_device_ms",
        "k1_d64_ms")} for c in encoder if "ms" in c}
    # K2's and K5's timed cases (K2 also launches on spec_bf16's plain
    # fallback), each beside SDPA over K/V gathered beforehand.
    for name, cases in (("paged_attention", paged),
                        ("paged_attention_tree", tree)):
        entry = next(e for e in line if e["name"] == name)
        entry["cases"] = {c["case"]: {k: c[k] for k in (
            "ms", "device_ms", "bound_ms", "sdpa_gathered_ms",
            "sdpa_gathered_device_ms", "plan")} for c in cases if "ms" in c}
    k2 = next(e for e in line if e["name"] == "paged_attention")
    k2["spec_bf16_launches"] = spec_bf16["launches"]["paged_attention"]
    # K1 (a hit's suffix at q_offset) and K2 (decode over adopted and
    # promoted pages) on the prefix-cache path.
    for e in line:
        if e["name"] in ("flash_attention", "paged_attention"):
            e["prefix_launches"] = prefix["launches"][e["name"]]
        # Launches on the models loaded from their snapshots (K5 is not
        # on that path).
        e["checkpoint_launches"] = checkpoint["launches"][e["name"]]
        if e["name"] in ("flash_attention", "paged_attention",
                         "encoder_attention"):
            # The chain phase: coalesced search, traced and augmented
            # answers.
            e["chain_launches"] = sum(
                launches[e["name"]] for launches in (
                    chain["search"]["launches"], chain["traced"]["launches"],
                    chain["augmented_launches"]))
    emit({"kernels": line})
    ok = (all(c["ok"] for c in flash + paged + encoder + paged_int8 + tree
              + int8_mm) and model["ok"] and serving["ok"] and chunked["ok"]
          and rag["ok"] and chain["ok"] and serving_int8["ok"] and spec_bf16["ok"]
          and prefix["ok"] and all(r["ok"] for r in spec_int8)
          and checkpoint["ok"])
    print(card, flush=True)
    if not ok:
        print("chip_smoke: FAILED (see the phase lines above)",
              file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _ptxas_summary(name: str) -> list:
    from generativeaiexamples_tpu_torch import kernels

    log = kernels.library_path(name).with_suffix(".log")
    if not log.exists():
        return []
    return [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln or "spill" in ln]


if __name__ == "__main__":
    sys.exit(main())
