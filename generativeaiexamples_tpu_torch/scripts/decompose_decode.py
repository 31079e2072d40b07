"""Decompose the cost of a decode block on the card.

The port's counterpart of the JAX package's scripts/decompose_decode.py.
Times `engine_model.decode_multi_step` (K = 8) at batch B over its own
pool, int8 or bf16 KV, in four variants that attribute a decode
iteration: full; attention stubbed out (`stub_attn`: the layer's output
is its query, no K2 / K4 launch); quantize-on-write stubbed (`stub_quant`:
the k/v rows cast to int8 with unit scales); both stubbed. The
variants run interleaved, one block each a round, and the paired
differences give attention, quantize-on-write and the rest (GEMMs, K6
under int8 weights, glue), each with its range over the rounds. On the
card one more block a variant runs under torch.profiler, for the same
attribution in device time and the kernels' own.

    python -m generativeaiexamples_tpu_torch.scripts.decompose_decode \\
        [B] [int8|bf16] [--rounds N] [--device cpu]

The model is Llama-3-8B geometry with random int8 weights on the card,
the tiny geometry on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import threading
import time
from typing import Dict, NamedTuple

import numpy as np
import torch

from generativeaiexamples_tpu_torch.scripts import (
    KERNEL_FUNCTIONS, profile_device)
from generativeaiexamples_tpu_torch.serving import engine_model
from generativeaiexamples_tpu_torch.serving.kv_cache import PagePool

K = 8
VARIANTS = {"full": (False, False), "stub_attn": (True, False),
            "stub_quant": (False, True), "stub_both": (True, True)}
# engine_model's module bindings the stubs replace.
STUB_NAMES = ("paged_attention_dispatch", "paged_attention_int8",
              "quantize_kv")


def _stub_attention(q, *args, **kwargs):
    return q  # skips the kernel, keeps the shape


def _stub_quantize_kv(x, scale_dtype=torch.float32):
    return (x.to(torch.int8),
            torch.ones(x.shape[:-1], dtype=scale_dtype, device=x.device))


@contextlib.contextmanager
def stubs(attn: bool, quant: bool):
    """engine_model's attention and quantize-on-write bindings replaced
    for the block, restored in `finally` whatever happens. Refused while
    an engine's scheduler thread is live in this process: its steps
    would read the stubs."""
    live = [t.name for t in threading.enumerate()
            if t.name.startswith("llm-engine") and t.is_alive()]
    if live:
        raise RuntimeError(f"decompose_decode stubs: engine threads {live} "
                           f"are live in this process; stop them first")
    saved = {name: getattr(engine_model, name) for name in STUB_NAMES}
    try:
        if attn:
            engine_model.paged_attention_dispatch = _stub_attention
            engine_model.paged_attention_int8 = _stub_attention
        if quant:
            engine_model.quantize_kv = _stub_quantize_kv
        yield
    finally:
        for name, fn in saved.items():
            setattr(engine_model, name, fn)


class DecodeSetup(NamedTuple):
    pool: object
    tables: torch.Tensor   # [B, maxp] int32
    lengths: torch.Tensor  # [B] int32, the first block's
    B: int
    kv: str


def decode_setup(cfg, B: int, kv: str, device) -> DecodeSetup:
    """The JAX script's pool and tables: pages of 128 tokens (int8) or 64
    (bf16), 384 // ps pages a row, B * that + 1 pages (page 0 is the
    sink), rows' pages drawn by `default_rng(0).permutation`, lengths
    129."""
    ps = 128 if kv == "int8" else 64
    maxp = 384 // ps
    n_pages = B * maxp + 1
    dtype = torch.int8 if kv == "int8" else torch.bfloat16
    pool = PagePool.zeros(cfg, n_pages, ps, dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    tables = np.zeros((B, maxp), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    for b in range(B):
        tables[b] = perm[b * maxp:(b + 1) * maxp]
    dev = torch.device(device)
    return DecodeSetup(pool, torch.from_numpy(tables).to(dev),
                       torch.full((B,), 129, dtype=torch.int32, device=dev),
                       B, kv)


def _block_inputs(setup: DecodeSetup) -> Dict[str, torch.Tensor]:
    B, dev = setup.B, setup.tables.device
    return {"active": torch.ones((B,), dtype=torch.bool, device=dev),
            "temps": torch.zeros((B,), dtype=torch.float32, device=dev),
            "top_ps": torch.ones((B,), dtype=torch.float32, device=dev),
            "top_ks": torch.zeros((B,), dtype=torch.int32, device=dev)}


def run_block(params, cfg, setup: DecodeSetup, inputs, last, i: int):
    """One block of K decode steps at the setup's lengths + K * i, ended
    by a host read of its tokens. Returns (tokens [B, K + 1] on the host,
    the next `last`, wall seconds, device ms between CUDA events around
    the block's launches, or None off the card)."""
    events = None
    if setup.tables.is_cuda:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
    t0 = time.perf_counter()
    block, last = engine_model.decode_multi_step(
        params, cfg, setup.pool, last, setup.tables,
        setup.lengths + K * i, inputs["active"], inputs["temps"],
        inputs["top_ps"], inputs["top_ks"], None, K,
        sampling_flags=(True, False, False))
    if events:
        events[1].record()
    tokens = block.cpu()
    wall = time.perf_counter() - t0
    return (tokens, last, wall,
            events[0].elapsed_time(events[1]) if events else None)


def run_blocks(params, cfg, setup: DecodeSetup, n_blocks: int):
    """A first block at the setup's lengths (warm), then n_blocks more,
    each K positions further, every one ended by a host read of its
    tokens. Returns (seconds of each timed block, the blocks' tokens
    [n_blocks + 1, B, K + 1] on the host)."""
    inputs = _block_inputs(setup)
    last = torch.zeros((setup.B,), dtype=torch.int32,
                       device=setup.tables.device)
    blocks, secs = [], []
    for i in range(n_blocks + 1):
        tokens, last, wall, _ = run_block(params, cfg, setup, inputs,
                                          last, i)
        blocks.append(tokens)
        if i:
            secs.append(wall)
    return secs, torch.stack(blocks).numpy()


def _spread(values) -> Dict[str, float]:
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values)}


def decompose(params, cfg, setup: DecodeSetup, n_rounds: int) -> Dict:
    """The four variants' decode iteration, timed interleaved: after one
    warm block each, `n_rounds` rounds run one block of every variant
    (the order rotating a round), so a drift of the host's speed reaches
    all four alike. A block's time is its wall time to the host read
    and its device span between CUDA events; an attribution is the
    median over rounds of the paired difference, with its spread. One
    more block of each variant runs under torch.profiler for its device
    busy time and K4's, K2's and K6's own (none off the card).

    The full variant's first two blocks run before any stub and again
    after the last one left (positions are rewritten before they are
    read, so the pool's state does not matter): their tokens must be
    equal, and the bindings the same objects."""
    cap = setup.tables.shape[1] * setup.pool.page_size
    if int(setup.lengths.max()) + K * (n_rounds + 2) > cap + 1:
        raise ValueError(f"{n_rounds} rounds of {K}-step blocks pass the "
                         f"rows' {cap}-token page capacity")
    originals = {n: getattr(engine_model, n) for n in STUB_NAMES}
    _, base_tokens = run_blocks(params, cfg, setup, 1)
    inputs = _block_inputs(setup)
    last = {name: torch.zeros((setup.B,), dtype=torch.int32,
                              device=setup.tables.device)
            for name in VARIANTS}
    names = list(VARIANTS)
    wall = {name: [] for name in names}
    span = {name: [] for name in names}

    def block(name, i):
        with stubs(*VARIANTS[name]):
            _, last[name], w, d = run_block(params, cfg, setup, inputs,
                                            last[name], i)
        return w, d

    for name in names:
        block(name, 0)
    for r in range(n_rounds):
        for name in names[r % 4:] + names[:r % 4]:
            w, d = block(name, r + 1)
            wall[name].append(w * 1e3 / K)
            if d is not None:
                span[name].append(d / K)
    device = {}
    for name in names:
        rows = profile_device(lambda n=name: block(n, n_rounds + 1),
                              setup.tables.device)
        device[name] = {
            "busy_ms": sum(ms for ms, _, _ in rows) / K,
            **{f"{k}_ms": sum(ms for ms, _, n in rows
                              if KERNEL_FUNCTIONS[k] in n) / K
               for k in ("paged_attention_int8", "paged_attention",
                         "int8_matmul")}}
    _, again = run_blocks(params, cfg, setup, 1)
    rows = {}
    for name in names:
        ms = statistics.median(wall[name])
        rows[name] = {"ms_per_iteration": ms,
                      "tokens_per_s": setup.B / ms * 1e3,
                      "wall_ms": _spread(wall[name]),
                      "device_span_ms": (_spread(span[name])
                                         if span[name] else None),
                      "device": device[name] if device[name]["busy_ms"]
                      else None}

    def paired(minus):
        return _spread([f - m for f, m in zip(wall["full"], wall[minus])])

    attn, quant = paired("stub_attn"), paired("stub_quant")
    dev_full, dev_attn, dev_quant = (
        rows[n]["device"] for n in ("full", "stub_attn", "stub_quant"))
    return {
        "B": setup.B, "kv": setup.kv, "K": K, "rounds": n_rounds,
        "variants": rows,
        "attention_ms": attn["median"], "attention_spread_ms": attn,
        "quantize_on_write_ms": quant["median"],
        "quantize_on_write_spread_ms": quant,
        "rest_ms": rows["stub_both"]["ms_per_iteration"],
        "device_attention_ms": (dev_full["busy_ms"] - dev_attn["busy_ms"]
                                if dev_full and dev_attn else None),
        "device_quantize_on_write_ms": (
            dev_full["busy_ms"] - dev_quant["busy_ms"]
            if dev_full and dev_quant else None),
        "full_tokens_equal_after_stubs": bool(
            np.array_equal(base_tokens, again)),
        "bindings_restored": all(getattr(engine_model, n) is fn
                                 for n, fn in originals.items())}


def format_rows(rec: Dict) -> list:
    tag = f"B={rec['B']} kv={rec['kv']} K={rec['K']}"
    lines = []
    for name, r in rec["variants"].items():
        w = r["wall_ms"]
        line = (f"[decompose] {name}: {tag}: {r['ms_per_iteration']:.2f} ms "
                f"per decode iteration ({r['tokens_per_s']:.0f} tok/s; "
                f"rounds {w['min']:.2f}-{w['max']:.2f} ms)")
        if r["device"]:
            line += f"; device busy {r['device']['busy_ms']:.2f} ms"
        lines.append(line)
    a, q = rec["attention_spread_ms"], rec["quantize_on_write_spread_ms"]
    lines.append(
        f"[decompose] attribution (median of {rec['rounds']} paired rounds, "
        f"range): attention {a['median']:.2f} ms ({a['min']:.2f} to "
        f"{a['max']:.2f}), quantize-on-write {q['median']:.2f} ms "
        f"({q['min']:.2f} to {q['max']:.2f}), rest (GEMMs, glue) "
        f"{rec['rest_ms']:.2f} ms per iteration; full tokens equal after "
        f"the stubs: {rec['full_tokens_equal_after_stubs']}")
    if rec["device_attention_ms"] is not None:
        k = rec["variants"]["full"]["device"]
        lines.append(
            f"[decompose] device time per iteration: attention "
            f"{rec['device_attention_ms']:.2f} ms (K4 "
            f"{k['paged_attention_int8_ms']:.2f}, K2 "
            f"{k['paged_attention_ms']:.2f}), quantize-on-write "
            f"{rec['device_quantize_on_write_ms']:.2f} ms, K6 "
            f"{k['int8_matmul_ms']:.2f} ms")
    return lines


def main(argv=None) -> None:
    from generativeaiexamples_tpu_torch.device import resolve_device
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops.quant import quantize_llama_params

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("B", nargs="?", type=int, default=128)
    ap.add_argument("kv", nargs="?", default="int8", choices=("int8", "bf16"))
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = (llama.LlamaConfig.llama3_8b() if dev.type == "cuda"
           else llama.LlamaConfig.tiny())
    params = quantize_llama_params(llama.init_params(
        cfg, dev, torch.Generator(device=dev).manual_seed(0)), dev)
    rec = decompose(params, cfg, decode_setup(cfg, args.B, args.kv, dev),
                    args.rounds)
    for line in format_rows(rec):
        print(line)


if __name__ == "__main__":
    main()
