#!/usr/bin/env python3
"""On-card check of the PyTorch/H100 port (generativeaiexamples_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  1. env      the card's name and power limit (nvidia-smi), torch / CUDA
  2. build    nvcc builds every kernel of the serving path from csrc/
  3. flash    K1 (csrc/flash_attention.cu) against `mha_reference` run in
              f32 on the same bf16 inputs, at Llama-3-8B prefill shapes
              plus ragged / q_offset / fully-masked / head_dim 64 cases
  4. paged    K2 (csrc/paged_attention.cu) against
              `paged_attention_reference`, at 8B decode shapes plus
              head_dim 64 and a small page size
  5. model    a 2-layer bf16 model with 8B head geometry, run through the
              engine's prefill and decode steps on the card, against the
              plain f32 forward on the CPU over the same weights
  6. serving  LLMEngine at Llama-3-8B geometry (random weights from a
              seed, bf16, default engine config) behind the port's
              OpenAI server on a local port: one streaming chat
              completion, one non-streaming completion, 4 concurrent
              64-token completions (one of them sampled with temperature,
              top-k and top-p); both kernels' launch counts must rise.
              Then, outside the counted window, torch.profiler over one
              more 64-token completion: device idle share and device
              time by kernel name
  7. kernels  one line {"kernels": [...]} with each kernel's parity,
              launches in the serving phase, times and bound
  8. the card's name and power limit, then the last line
              {"ok": true, "device": {...}}

It imports neither jax nor the JAX package. Without CUDA, or without the
port's package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

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

K1_REPLACES = "generativeaiexamples_tpu/ops/attention.py:233 (_flash_kernel)"
K2_REPLACES = ("generativeaiexamples_tpu/serving/paged_attention.py:266 "
               "(_paged_kernel)")


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
    ok = finite and err <= BF16_ATOL and masked_nonzero == 0.0
    rec = {"phase": "flash", "case": name, "B": B, "H": H, "KH": KH,
           "Sq": Sq, "Sk": Sk, "D": D, "max_abs_err": err, "tol": BF16_ATOL,
           "masked_rows_max_abs": masked_nonzero, "finite": finite, "ok": ok}
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
        rec["plain_ms"] = time_ms(lambda: attn.mha_reference(
            q, k, v, causal=causal, lengths=ln, q_offset=off), iters=5)
        rec["library_ms"] = flash_library_ms(q, k, v, causal, lengths,
                                             q_offset, Sk)
        rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
    del got, want, diff
    torch.cuda.empty_cache()
    return rec


def flash_library_ms(q, k, v, causal, lengths, q_offset, Sk):
    """SDPA on the same inputs, where one call computes the same
    function: full lengths and no offset (plain causal attention)."""
    import torch.nn.functional as F

    if not causal or any(n != Sk for n in lengths) or any(q_offset):
        return None
    return time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))


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


def paged_case(name, B, H, KH, Hd, ps, maxp, lengths, seed=0, timed=False):
    import torch

    from generativeaiexamples_tpu_torch.serving import paged_attention as pa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = B * maxp + 1
    q = torch.randn((B, H, Hd), generator=g, device=dev).bfloat16()
    kp = torch.randn((KH, n_pages, ps, Hd), generator=g, device=dev).bfloat16()
    vp = torch.randn((KH, n_pages, ps, Hd), generator=g, device=dev).bfloat16()
    perm = torch.randperm(n_pages - 1, generator=g, device=dev) + 1
    table = torch.zeros((B, maxp), dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(lengths):
        need = -(-n // ps)
        table[b, :need] = perm[used:used + need].int()
        used += need
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = pa.paged_attention(q, kp, vp, table, ln)
    want = pa.paged_attention_reference(q.float(), kp.float(), vp.float(),
                                        table, ln)
    # Tail table slots point at sink page 0: poison it and require a
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
    ok = finite and sink_unread and err <= BF16_ATOL
    rec = {"phase": "paged", "case": name, "B": B, "H": H, "KH": KH,
           "Hd": Hd, "ps": ps, "maxp": maxp, "lengths": lengths,
           "max_abs_err": err, "tol": BF16_ATOL, "sink_unread": sink_unread,
           "finite": finite, "ok": ok}
    if timed:
        tokens = float(sum(lengths))
        # K/V of the tokens this input attends (not whole pages), the
        # query and output once, plus the table and lengths.
        n_bytes = 2.0 * (2 * tokens * KH * Hd + 2 * q.numel()) \
            + 4.0 * (table.numel() + B)
        flops = 4.0 * Hd * H * tokens
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, flops)
        rec["ms"] = time_ms(lambda: pa.paged_attention(q, kp, vp, table, ln))
        rec["plain_ms"] = time_ms(lambda: pa.paged_attention_reference(
            q, kp, vp, table, ln), iters=5)
        # No single torch call takes a page table; SDPA over K/V gathered
        # beforehand (gather not timed) is kept as a dense yardstick only.
        rec["library_ms"] = None
        rec["sdpa_gathered_ms"] = paged_sdpa_gathered_ms(q, kp, vp, table,
                                                         ln)
        rec["gbytes_per_s"] = n_bytes / (rec["ms"] * 1e-3) / 1e9
    return rec


def paged_sdpa_gathered_ms(q, kp, vp, table, ln):
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
    return time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], k, v, attn_mask=mask, enable_gqa=True))


def phase_paged():
    cases = [
        paged_case("8b_decode", 8, 32, 8, 128, 128, 64,
                   [1, 17, 128, 129, 1000, 4096, 7000, 8191], seed=11,
                   timed=True),
        paged_case("hd64", 4, 32, 8, 64, 128, 16, [1, 300, 1024, 2047],
                   seed=12),
        paged_case("ps16", 3, 8, 2, 128, 16, 32, [5, 16, 511], seed=13),
    ]
    for c in cases:
        emit(c)
    return cases


# -- phase 5: model steps on the card vs the plain forward ------------------


def phase_model():
    """Engine prefill + decode steps (K1, K2) in bf16 on the card against
    the contiguous forward in f32 on the CPU over the same (bf16-rounded)
    weights. Tolerance 5e-2 on logits of scale ~1: the card path rounds
    every activation to bf16 through two layers (each rounding ~2^-9
    relative), the CPU path does not."""
    import dataclasses

    import torch

    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.serving import engine_model
    from generativeaiexamples_tpu_torch.serving.kv_cache import (
        PageAllocator, PagePool, SequencePages)

    dev = torch.device("cuda")
    cfg = dataclasses.replace(
        llama.LlamaConfig.llama3_8b(), vocab_size=512, dim=512, n_layers=2,
        n_heads=8, n_kv_heads=2, head_dim=128, mlp_dim=1024, max_seq_len=512,
        dtype=torch.bfloat16)
    params = llama.init_params(cfg, dev, torch.Generator(dev).manual_seed(0))
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_params = llama.map_params(params, lambda t: t.float().cpu())
    prompt_len, n_decode, ps, bucket = 150, 6, 128, 256
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt_len + n_decode),
                         generator=g)
    full, _ = llama.forward(cpu_params, cpu_cfg, toks)          # [1, S, V]

    pool = PagePool.zeros(cfg, 8, ps, dtype=torch.bfloat16, device=dev)
    seq = SequencePages(PageAllocator(8), ps, 4)
    seq.ensure(prompt_len)
    padded = torch.zeros((1, bucket), dtype=torch.int64)
    padded[0, :prompt_len] = toks[0, :prompt_len]
    row = torch.zeros((bucket // ps,), dtype=torch.int32)
    row[:len(seq.pages)] = torch.tensor(seq.pages)
    logits = engine_model.prefill_step(params, cfg, pool, padded.to(dev),
                                       prompt_len, row.to(dev))
    errs = [float((logits.float().cpu() - full[0, prompt_len - 1]).abs().max())]
    for t in range(prompt_len, prompt_len + n_decode):
        seq.ensure(t + 1)
        table = torch.tensor(seq.table_row()[None, :], device=dev)
        lg = engine_model.decode_step(
            params, cfg, pool, toks[:, t].to(dev), table,
            torch.tensor([t + 1], dtype=torch.int32, device=dev))
        errs.append(float((lg[0].float().cpu() - full[0, t]).abs().max()))
    torch.cuda.synchronize()
    err = max(errs)
    rec = {"phase": "model", "layers": cfg.n_layers, "dim": cfg.dim,
           "head_dim": cfg.head_dim, "prompt": prompt_len,
           "decode_steps": n_decode, "logit_scale": float(full.abs().max()),
           "max_abs_err": err, "tol": 5e-2, "ok": err <= 5e-2}
    emit(rec)
    return rec


# -- phase 6: serving ------------------------------------------------------


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


def _profile_window(base):
    """Where one served completion's time goes: torch.profiler over one
    64-token completion after the main path's counts were read. Device
    busy time is the sum of every device activity's self time (one
    stream, so activities do not overlap); the idle share is the rest of
    the window's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        done = _complete(base, "Profile window", 64)
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
    return {"wall_ms": wall_ms, "completion_tokens": done[
                "completion_tokens"],
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if rows else None,
            "device_activities": sum(n for _, n, _ in rows),
            "top": [{"name": k[:90], "ms": ms, "count": n}
                    for ms, n, k in rows[:10]]}


def phase_serving(card: str):
    import torch

    from generativeaiexamples_tpu_torch import kernels
    from generativeaiexamples_tpu_torch.serving.__main__ import build_engine
    from generativeaiexamples_tpu_torch.serving.openai_server import (
        OpenAIServer, make_http_server)

    t0 = time.perf_counter()
    engine = build_engine("8b", device="cuda", seed=0, warmup=False)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t0
    engine.start()
    server = OpenAIServer(engine, model_name="llama3-8b-random")
    httpd = make_http_server(server, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        stream = _stream_chat(base, 32)
        single = _complete(base, "The quick brown fox", 32)
        results = [None] * 4

        def run(i):
            # The last one samples (temperature, top-k, top-p on the
            # device), so the batch takes the masked-sampling path.
            sampling = ({"temperature": 0.7, "top_p": 0.9, "top_k": 40}
                        if i == 3 else {})
            results[i] = _complete(base, f"Request number {i}:", 64,
                                   **sampling)

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
        profile = _profile_window(base)
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
    conc_tokens = sum(r["completion_tokens"] for r in results if r)

    def finished_ok(r, want):
        return r is not None and (r["completion_tokens"] == want
                                  or r["finish_reason"] in ("length", "stop"))

    ok = (stream["finish_reason"] in ("length", "stop")
          and stream["done_marker"]
          and finished_ok(single, 32)
          and all(finished_ok(r, 64) for r in results)
          and health.get("status") == "healthy"
          and all(n > 0 for n in launches.values()))
    rec = {"phase": "serving", "model": "llama3_8b random bf16",
           "layers": engine.cfg.n_layers, "card": card,
           "engine_build_s": build_s, "warmup_s": warm_s,
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
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
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
    model = phase_model()
    serving = phase_serving(card)

    k1 = next(c for c in flash if c["case"] == "8b_s2048")
    k2 = next(c for c in paged if c["case"] == "8b_decode")
    line = []
    for name, src, rep, main_case, cases in (
            ("flash_attention", "generativeaiexamples_tpu_torch/csrc/"
             "flash_attention.cu", K1_REPLACES, k1, flash),
            ("paged_attention", "generativeaiexamples_tpu_torch/csrc/"
             "paged_attention.cu", K2_REPLACES, k2, paged)):
        line.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": serving["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tol": BF16_ATOL, "parity_ok": all(c["ok"] for c in cases),
            "case": main_case["case"], "ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"]})
    emit({"kernels": line})
    ok = (all(c["ok"] for c in flash + paged) and model["ok"]
          and serving["ok"])
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
