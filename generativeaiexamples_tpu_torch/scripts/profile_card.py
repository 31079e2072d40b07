"""Microbenchmarks of the serving hot path on the card.

The port's counterpart of the JAX package's scripts/profile_tpu.py.
Prints, in order:

1. the card's name, memory and power limit (`nvidia-smi
   --query-gpu=name,power.limit --format=csv,noheader`);
2. the per-dispatch host overhead: one tiny launch, alone and with its
   host read;
3. the weight-read bandwidth at decode shapes, [B, D] x [D, M] at
   Llama-3-8B widths: bf16 `torch.matmul` against K6 (the int8 weight
   kernel, `ops/quant.mm`), one layer and a sweep over 8 layers;
4. with `--engine`: `prefill_step` and `decode_multi_step` wall times
   for the int8 deployment (8B, int8 weights, batch 16).

Every time ends with a host read (`.cpu()`) of the last result.

    python -m generativeaiexamples_tpu_torch.scripts.profile_card \\
        [--engine] [--device cpu]

On the CPU the widths and the model are the tiny ones.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Dict

import torch

from generativeaiexamples_tpu_torch.scripts import HBM_BYTES_PER_S

# Decode-shape GEMM at 8B widths: the MLP's gate projection.
MM_SHAPE = (16, 4096, 14336)
SWEEP_LAYERS = 8


def card_name() -> str:
    """nvidia-smi's name and power limit line, or why there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return (out.stdout.strip().splitlines()[0] if out.stdout.strip()
                else f"nvidia-smi rc {out.returncode}")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def timeit(fn, n: int = 20, warmup: int = 3, repeats: int = 3) -> float:
    """Seconds a call: the least, over `repeats` runs of n calls each
    ended by a host read of the last, of the run's time over n."""
    for _ in range(warmup):
        fn().cpu()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        out.cpu()
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def dispatch_overhead(device) -> Dict[str, float]:
    """ms of one tiny launch (x + 1 on 16 floats): a run of launches
    ended by one host read, and each with its own host read."""
    x = torch.zeros((16,), dtype=torch.float32, device=device)
    launch = timeit(lambda: x + 1, n=50)
    t0 = time.perf_counter()
    for _ in range(50):
        (x + 1).cpu()
    return {"launch_ms": launch * 1e3,
            "launch_and_read_ms": (time.perf_counter() - t0) / 50 * 1e3}


def bandwidth_rows(device, shape=MM_SHAPE, layers: int = SWEEP_LAYERS,
                   seed: int = 0) -> Dict[str, Dict[str, float]]:
    """The weight-read rate of [B, D] x [D, M]: bf16 torch.matmul, K6
    over int8 codes with per-column scales (`ops/quant.mm`), and K6
    over `layers` layers in turn (sustained). GB/s counts the weight
    bytes read a call (bf16: 2 a weight; int8: 1 plus the scales)."""
    from generativeaiexamples_tpu_torch.ops.quant import (
        QuantizedTensor, mm)

    B, D, M = shape
    dev = torch.device(device)
    dt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, D), generator=g, device=dev).to(dt)
    wb = torch.randn((D, M), generator=g, device=dev).to(dt)
    q = torch.randint(-127, 128, (layers, D, M), generator=g,
                      device=dev).to(torch.int8)
    s = torch.rand((layers, M), generator=g, device=dev) * 1e-2
    w8 = [QuantizedTensor(q[i], s[i]) for i in range(layers)]

    def sweep():
        y = x
        for w in w8:
            y = x + mm(y, w)[:, :D]
        return y

    rows = {}
    for name, fn, n_bytes, n in (
            ("bf16_matmul", lambda: x @ wb, D * M * wb.element_size(), 100),
            ("int8_k6", lambda: mm(x, w8[0]), D * M + 4 * M, 100),
            (f"int8_k6_{layers}_layers", sweep, layers * (D * M + 4 * M),
             20)):
        sec = timeit(fn, n=n)
        rows[name] = {"ms": sec * 1e3, "gb_per_s": n_bytes / sec / 1e9,
                      "share_of_hbm_rate": n_bytes / sec / HBM_BYTES_PER_S,
                      "weight_bytes": n_bytes}
    return rows


def engine_steps(device) -> Dict[str, float]:
    """prefill_step (S = 128) and decode_multi_step (K = 8, 16, 32) wall
    ms at batch 16 over a bf16 pool of 64-token pages, int8 weights."""
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops.quant import quantize_llama_params
    from generativeaiexamples_tpu_torch.serving import engine_model
    from generativeaiexamples_tpu_torch.serving.kv_cache import (
        PageAllocator, PagePool, SequencePages)

    dev = torch.device(device)
    cfg = (llama.LlamaConfig.llama3_8b() if dev.type == "cuda"
           else llama.LlamaConfig.tiny())
    t0 = time.perf_counter()
    params = quantize_llama_params(llama.init_params(
        cfg, dev, torch.Generator(device=dev).manual_seed(0)), dev)
    params["layers"]["wq"].q.cpu()
    out = {"params_s": time.perf_counter() - t0}
    batch, prompt_len, gen, page = 16, 128, 128, 64
    max_pages = (prompt_len + gen + page) // page
    n_pages = batch * max_pages + 1
    pool = PagePool.zeros(cfg, n_pages, page, device=dev)
    seq = SequencePages(PageAllocator(n_pages), page, max_pages)
    seq.ensure(prompt_len)
    row = torch.tensor(seq.pages[:prompt_len // page], dtype=torch.int32,
                       device=dev)
    toks = torch.zeros((1, prompt_len), dtype=torch.int32, device=dev)
    out["prefill_step_ms"] = timeit(lambda: engine_model.prefill_step(
        params, cfg, pool, toks, prompt_len, row), n=5, warmup=1,
        repeats=1) * 1e3
    tables = torch.arange(max_pages, dtype=torch.int32,
                          device=dev)[None].repeat(batch, 1)
    lengths = torch.full((batch,), prompt_len + 1, dtype=torch.int32,
                         device=dev)
    active = torch.ones((batch,), dtype=torch.bool, device=dev)
    temps = torch.zeros((batch,), dtype=torch.float32, device=dev)
    top_ps = torch.ones((batch,), dtype=torch.float32, device=dev)
    top_ks = torch.zeros((batch,), dtype=torch.int32, device=dev)
    tokens = torch.zeros((batch,), dtype=torch.int32, device=dev)
    for K in (8, 16, 32):
        ms = timeit(lambda K=K: engine_model.decode_multi_step(
            params, cfg, pool, tokens, tables, lengths, active, temps,
            top_ps, top_ks, None, K, sampling_flags=(True, False, False))[0],
            n=5, warmup=1, repeats=1) * 1e3
        out[f"decode_K{K}_ms"] = ms
        out[f"decode_K{K}_tokens_per_s"] = batch * K / ms * 1e3
    return out


def main(argv=None) -> None:
    from generativeaiexamples_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--engine", action="store_true",
                    help="also time the engine's prefill and decode steps")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        print(f"device: {props.name} ({card_name()}), "
              f"{props.total_memory / 2**30:.1f} GiB, "
              f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB in use",
              flush=True)
    else:
        print("device: cpu", flush=True)
    for k, v in dispatch_overhead(dev).items():
        print(f"dispatch {k}: {v:.4f}", flush=True)
    shape = MM_SHAPE if dev.type == "cuda" else (4, 64, 256)
    for name, r in bandwidth_rows(dev, shape).items():
        print(f"{name} {list(shape)}: {r['ms']:.4f} ms "
              f"({r['gb_per_s']:.0f} GB/s weight read, "
              f"{100 * r['share_of_hbm_rate']:.0f}% of the HBM rate)",
              flush=True)
    if args.engine:
        for k, v in engine_steps(dev).items():
            print(f"engine {k}: {v:.2f}", flush=True)


if __name__ == "__main__":
    main()
