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
              (and the chunked lane's q_offset shape) plus ragged /
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
              loop and device time beside the byte bound
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
              chunk steps' first-token logits against a one-shot forward
  11. rag     the chain server (developer_rag, device store, ranked
              hybrid retrieval) over the same 8B engine with
              arctic-embed-l and BERT-base reranker encoders: ingest of
              ~2,000 chunks of the repository's prose, /search and a
              1M-row device store against exact host MIPS, two
              knowledge-base /generate answers (tokens generated, no
              error frame); K3's launches must equal encoder layers x
              forwards, K1 and K2 must launch
  12. serving_int8  after the bf16 engine and the stores are released:
              an LLMEngine at Llama-3-8B geometry, random weights from
              seed 0 quantized at load, in the documented int8 deployment
              (int8 weights and KV, batch 128, page 128, max_seq 8192),
              with one cut (4,097 pool pages); 128 concurrent greedy
              64-token completions and one ~6,000-token chunked prompt
              behind the OpenAI server. K6, K4 and K1 must launch, K2 not
  11b. spec_bf16  (before the bf16 engine goes) a tree engine (k = 3,
              M = 4, batch 8) over the same bf16 weights: 8 concurrent
              64-token completions, one sampled, so dispatches fall back
              to plain decode while it is live; K5 must launch, K2 only
              through the fallback
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
  14. kernels one line {"kernels": [...]} with each kernel's parity,
              launches on its path (K1, K2: serving; K3: rag; K4, K6:
              serving_int8; K5: spec_bf16), times and bound; K4's entry
              also carries its verify cases and its spec_int8 launches
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
        # No single torch call takes a page table and int8 pages.
        rec["library_ms"] = None
        rec["gbytes_per_s"] = n_bytes / (rec["ms"] * 1e-3) / 1e9
    del kv, sc, got, poisoned
    torch.cuda.empty_cache()
    return rec


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
    ok = (served_rec["completion_tokens"] >= 1
          and launches["flash_attention"] >= 2 * engine.cfg.n_layers
          and err <= CHUNK_LOGIT_ATOL and bool(torch.isfinite(chunked).all()))
    rec = {"phase": "chunked", "prompt_tokens": prompt_len, "chunk": chunk,
           "served": served_rec, "launches": launches,
           "chunk_steps_s": chunked_s,
           "logit_scale": float(oneshot.float().abs().max()),
           "first_token_logit_max_abs_err": err, "tol": CHUNK_LOGIT_ATOL,
           "argmax_equal": int(chunked.argmax()) == int(oneshot.argmax()),
           "ok": ok}
    emit(rec)
    return rec


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


def _multipart(filename: str, text: str):
    boundary = "gaieboundary7a3f"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{filename}\"\r\nContent-Type: text/plain\r\n\r\n"
            ).encode() + text.encode() + f"\r\n--{boundary}--\r\n".encode()
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
              store_dim: int = 1024, max_tokens: int = 32):
    """The port's ChainServer with developer_rag over the device store,
    the served 8B engine, and arctic-embed-l / BERT-base reranker
    encoders (bf16, random from seeds): ingest the repository's prose
    sampled with a seed (~2,000 chunks at the default splitter, all at
    S=512), /search against exact host MIPS, a 1M-row device store
    searched with 64 queries against exact host MIPS, and two
    knowledge-base /generate answers whose prompts exceed the 4096
    bucket. Each answer must generate its tokens with no error frame
    (an engine failure becomes one); K3's launches must equal the
    encoder layers times the forwards made, and K1 and K2 must launch."""
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
        for q in ("How does the prefill scheduler use the page cache?",
                  "What bounds the attention kernel on the device?"):
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
    tokens = sum(r["completion_tokens"] for r in results if r)
    finished = all(r is not None and r["finish_reason"] in ("length", "stop")
                   and r["completion_tokens"] >= 1 for r in results)
    ok = (finished and long_rec["finish_reason"] in ("length", "stop")
          and long_rec["completion_tokens"] >= 1
          and launches["int8_matmul"] > 0
          and launches["paged_attention_int8"] > 0
          and launches["flash_attention"] > 0
          and launches["paged_attention"] == 0)
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
           "profile": profile, "ok": ok}
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
    try:
        serving = phase_serving(card, served)
        chunked = phase_chunked(served)
        rag = phase_rag(card, served)
        spec_bf16 = phase_spec_bf16(card, served)
    finally:
        served.close()
    # The bf16 engine and the RAG stores go before the int8 engine comes.
    del served
    gc.collect()
    torch.cuda.empty_cache()
    serving_int8, int8_served = phase_serving_int8(card)
    spec_int8 = phase_spec_int8(card, int8_served)
    del int8_served

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
                                      "library_ms")}
        for c in paged_int8 if c["q_rep"] > 1 and "ms" in c}
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
    emit({"kernels": line})
    ok = (all(c["ok"] for c in flash + paged + encoder + paged_int8 + tree
              + int8_mm) and model["ok"] and serving["ok"] and chunked["ok"]
          and rag["ok"] and serving_int8["ok"] and spec_bf16["ok"]
          and all(r["ok"] for r in spec_int8))
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
