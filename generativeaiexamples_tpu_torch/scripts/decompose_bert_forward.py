"""Attribution of the BERT encoder forward on the card.

The port's counterpart of the JAX package's
scripts/decompose_bert_forward.py. Times, at arctic-embed-l (B in {32,
64}) and reranker_base (B in {16, 32, 64}), S = 512, bf16:

  full       `bert.forward` as shipped (the engines' pre-fused QKV tree,
             K3 for the attention)
  no_attn    attention replaced by the identity (its output is v; q and
             k are projected and laid out all the same, as the JAX
             script's variant does): full less this is K3 and the
             attention's own layout work, and the gap between one fused
             [D, 3D] projection and three [D, D] ones
  fused_qkv  q/k/v projected by ONE [D, 3D] matmul, concatenated in the
             call (outside the layer loop), K3 for the attention

`no_attn` and `fused_qkv` exist only here. Every time is the least of 5
runs, each ended by a host read of the CLS rows. `device_split` reads
one full forward's device time from torch.profiler, by kernel class
(K3, GEMMs, GELU, reductions, other elementwise work and casts), so K3's
own share need not be inferred from the differences.

    python -m generativeaiexamples_tpu_torch.scripts.decompose_bert_forward \\
        [--device cpu]

On the CPU the geometry is `BertConfig.tiny` in f32 at S = 64.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from generativeaiexamples_tpu_torch.models import bert
from generativeaiexamples_tpu_torch.ops.encoder_attention import (
    encoder_attention)
from generativeaiexamples_tpu_torch.scripts import (
    BF16_FLOPS_PER_S, KERNEL_FUNCTIONS, profile_device)

MODES = ("full", "no_attn", "fused_qkv")
SHAPES = (("arctic-embed-l", bert.BertConfig.arctic_embed_l, (32, 64)),
          ("reranker_base", bert.BertConfig.reranker_base, (16, 32, 64)))


@torch.no_grad()
def forward_variant(params, cfg: bert.BertConfig, tokens: torch.Tensor,
                    lengths: torch.Tensor, mode: str) -> torch.Tensor:
    """The CLS row of the last hidden state [B, D] under `mode`. `params`
    is the raw (unfused) tree; "full" fuses it as the engines do once at
    load (pass it fused to leave that out of a timing)."""
    if mode == "full":
        return bert.forward(params, cfg, tokens, lengths=lengths)[0][:, 0]
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    B, S = tokens.shape
    H, Hd = cfg.n_heads, cfg.head_dim
    dev = tokens.device
    tokens = tokens.long()
    x = (params["tok_emb"][tokens]
         + params["pos_emb"][torch.arange(S, device=dev)][None]
         + params["type_emb"][torch.zeros_like(tokens)])
    x = bert.layer_norm(x, params["emb_ln"]["w"], params["emb_ln"]["b"],
                        cfg.ln_eps)
    lw = params["layers"]
    fused = mode == "fused_qkv"
    if fused:
        # Hoisted out of the layer loop, as the shipped forward fuses.
        wqkv = torch.cat([lw["wq"], lw["wk"], lw["wv"]], dim=-1)
        bqkv = torch.cat([lw["bq"], lw["bk"], lw["bv"]], dim=-1)
    lengths = lengths.to(device=dev, dtype=torch.int32)
    for layer in range(cfg.n_layers):
        w = {k: v[layer] for k, v in lw.items()}
        if fused:
            qkv = (x @ wqkv[layer] + bqkv[layer]).view(B, S, 3, H, Hd)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        else:
            q, k, v = ((x @ w[f"w{n}"] + w[f"b{n}"]).view(B, S, H, Hd)
                       .transpose(1, 2) for n in "qkv")
        if mode == "no_attn":
            out = v
        else:
            out = encoder_attention(q, k, v, lengths)
        out = out.transpose(1, 2).reshape(B, S, H * Hd)
        x = bert.layer_norm(x + out @ w["wo"] + w["bo"], w["ln1_w"],
                            w["ln1_b"], cfg.ln_eps)
        h = F.gelu(x @ w["w_in"] + w["b_in"], approximate="none")
        x = bert.layer_norm(x + h @ w["w_out"] + w["b_out"], w["ln2_w"],
                            w["ln2_b"], cfg.ln_eps)
    return x[:, 0]


def timed(fn, reps: int = 5) -> float:
    """Least seconds of `reps` calls, each ended by a host read, after
    one untimed call."""
    fn().cpu()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn().cpu()
        best = min(best, time.perf_counter() - t0)
    return best


def flops(cfg: bert.BertConfig, B: int, S: int) -> float:
    per_tok_layer = 2 * (4 * cfg.dim ** 2 + 2 * cfg.dim * cfg.mlp_dim)
    attn = 2 * 2 * cfg.n_heads * S * S * cfg.head_dim  # qk + pv a row
    return B * (S * per_tok_layer + attn) * cfg.n_layers


def _inputs(cfg: bert.BertConfig, B: int, S: int, device, seed: int):
    """Tokens [B, S] and lengths drawn in [S * 0.4, S], from `seed`."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                              .astype(np.int32)).to(dev)
    lengths = torch.from_numpy(rng.integers(int(S * 0.4), S + 1, (B,))
                               .astype(np.int32)).to(dev)
    return tokens, lengths


def decompose(params, cfg: bert.BertConfig, B: int, S: int, device,
              seed: int = 0, modes=MODES) -> Dict:
    """Seconds per mode at [B, S] (lengths drawn in [S * 0.4, S]) and the
    share of the bf16 peak each reaches on the forward's flops."""
    tokens, lengths = _inputs(cfg, B, S, device, seed)
    fused = bert.fuse_qkv_params(params)
    tf = flops(cfg, B, S)
    rows = {}
    for mode in modes:
        p = fused if mode == "full" else params
        s = timed(lambda: forward_variant(p, cfg, tokens, lengths, mode))
        rows[mode] = {"ms": s * 1e3, "per_s": B / s,
                      "peak_share": tf / s / BF16_FLOPS_PER_S}
    return {"B": B, "S": S, "flops": tf, "modes": rows}


# Kernel classes of a forward's device time, by name (first match).
KERNEL_CLASSES = (("K3", (KERNEL_FUNCTIONS["encoder_attention"],)),
                  ("gemm", ("gemm", "nvjet", "xmma", "cutlass")),
                  ("gelu", ("gelu",)),
                  ("reductions", ("reduce_kernel",)),
                  ("casts_and_copies", ("copy",)))


def device_split(params, cfg: bert.BertConfig, B: int, S: int, device,
                 seed: int = 0) -> Dict:
    """Device ms of one shipped forward at [B, S] (after one untimed
    one), by KERNEL_CLASSES, the rest as "other_elementwise" (bias adds,
    residuals, the layer norms' arithmetic, the embedding gather), with
    the eight costliest kernel names. All zero off the card."""
    tokens, lengths = _inputs(cfg, B, S, device, seed)
    fused = bert.fuse_qkv_params(params)

    def run():
        return forward_variant(fused, cfg, tokens, lengths, "full").cpu()

    run()
    rows = profile_device(run, device)
    split = {name: 0.0 for name, _ in KERNEL_CLASSES}
    split["other_elementwise"] = 0.0
    for ms, _, name in rows:
        low = name.lower()
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k.lower() in low for k in keys)),
                   "other_elementwise")
        split[cls] += ms
    return {"B": B, "S": S, "device_ms": sum(ms for ms, _, _ in rows),
            "by_class_ms": split,
            "top": [{"name": k[:90], "ms": ms, "count": n}
                    for ms, n, k in rows[:8]]}


def format_row(name: str, rec: Dict) -> str:
    return f"{name} B={rec['B']} S={rec['S']}: " + "  ".join(
        f"{mode} {r['ms']:.2f}ms ({r['per_s']:.0f}/s, "
        f"{100 * r['peak_share']:.0f}% of bf16 peak)"
        for mode, r in rec["modes"].items())


def main(argv=None) -> int:
    from generativeaiexamples_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    shapes = SHAPES if dev.type == "cuda" else (
        ("tiny", bert.BertConfig.tiny, (2, 4)),)
    S = 512 if dev.type == "cuda" else 64
    for name, cfg_fn, batches in shapes:
        cfg = cfg_fn()
        if dev.type == "cuda":
            cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
        params = bert.init_params(
            cfg, dev, torch.Generator(device=dev).manual_seed(0))
        for B in batches:
            print(format_row(name, decompose(params, cfg, B, S, dev)))
            split = device_split(params, cfg, B, S, dev)
            print(f"{name} B={B} S={S} device "
                  f"{split['device_ms']:.2f}ms: " + "  ".join(
                      f"{c} {ms:.2f}ms"
                      for c, ms in split["by_class_ms"].items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
