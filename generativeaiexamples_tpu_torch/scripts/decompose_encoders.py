"""The embedding engine's time, split by stage, on the card.

The port's counterpart of the JAX package's
scripts/decompose_encoders.py. For arctic-embed-l (bf16) at the
reference's document chunk size (500 characters, the 512 bucket) it
measures host tokenization, pad and pack, device compute (one bucketed
forward, `reps` of them before one host read, and one with its own
blocking read), the readback, and end-to-end `embed()` throughput for
documents and queries, across batch sizes. The roofline comparison
uses the bound chip_smoke.py uses (`scripts.bound_ms`): the forward's
bytes (weights, tokens, the pooled rows) over the memory rate against
its operations over the bf16 peak.

    python -m generativeaiexamples_tpu_torch.scripts.decompose_encoders \\
        [--batch-sizes 16,32,64] [--device cpu]

On the CPU the geometry is the launcher's tiny embedder (f32).
"""

from __future__ import annotations

import argparse
import random as pyrandom
import string
import time
from typing import Dict, List

import numpy as np

from generativeaiexamples_tpu_torch.scripts import bound_ms
from generativeaiexamples_tpu_torch.scripts.decompose_bert_forward import (
    flops)
from generativeaiexamples_tpu_torch.training.trainer import tree_leaves

N_DOCS = 256
BUCKETS = (64, 128, 512)


def mktexts(n: int, n_chars: int, seed: int = 0) -> List[str]:
    rng = pyrandom.Random(seed)
    return ["".join(rng.choice(string.ascii_lowercase + "    ")
                    for _ in range(n_chars)) for _ in range(n)]


def forward_cost(params, cfg, B: int, S: int):
    """(bytes, flops) of one [B, S] forward: every weight read once, the
    tokens and lengths read, the pooled f32 rows written; the matmuls'
    and attention's operations (decompose_bert_forward.flops)."""
    n_bytes = sum(t.numel() * t.element_size()
                  for t in tree_leaves(params)) + B * S * 4 + B * 4 \
        + B * cfg.dim * 4
    return n_bytes, flops(cfg, B, S)


def measure(emb, docs: List[str], queries: List[str], reps: int = 4
            ) -> Dict:
    """One batch size: `emb` an EmbeddingEngine (its max_batch). Seconds
    by stage for the documents; end-to-end docs/s and queries/s."""
    B = emb.max_batch
    emb.embed(docs[:B])                  # warm the 512 bucket
    emb.embed(queries[:B], is_query=True)  # and the 128 one
    t0 = time.perf_counter()
    ids = emb._encode_ids(docs)
    t_tok = time.perf_counter() - t0
    t0 = time.perf_counter()
    S = emb.buckets[-1]
    toks = np.zeros((B, S), np.int32)
    lens = np.ones((B,), np.int32)
    for r in range(B):
        row = ids[r][:S]
        toks[r, :len(row)] = row
        lens[r] = len(row)
    t_pack = time.perf_counter() - t0
    emb._dispatch(toks, lens).numpy()  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        copy = emb._dispatch(toks, lens)
    copy.numpy()  # one readback at the end
    t_chain = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    emb._dispatch(toks, lens).numpy()
    t_sync = time.perf_counter() - t0  # compute + readback serialized
    t0 = time.perf_counter()
    emb.embed(docs)
    docs_s = len(docs) / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    emb.embed(queries, is_query=True)
    q_s = len(queries) / (time.perf_counter() - t0)
    n_bytes, fl = forward_cost(emb.params, emb.cfg, B, S)
    b_ms, b_by = bound_ms(n_bytes, fl)
    return {"B": B, "S": S, "tokenize_ms": t_tok * 1e3, "n_docs": len(docs),
            "pack_ms": t_pack * 1e3, "batch_chain_ms": t_chain * 1e3,
            "batch_sync_ms": t_sync * 1e3,
            "readback_ms": (t_sync - t_chain) * 1e3,
            "docs_per_s": docs_s, "queries_per_s": q_s,
            "bound_ms": b_ms, "bound_by": b_by,
            "chain_over_bound": t_chain * 1e3 / b_ms}


def format_row(rec: Dict) -> str:
    return (f"[enc] B={rec['B']:3d} tokenize={rec['tokenize_ms']:7.1f}ms/"
            f"{rec['n_docs']} pack={rec['pack_ms']:5.1f}ms "
            f"batch_chain={rec['batch_chain_ms']:6.1f}ms "
            f"batch_sync={rec['batch_sync_ms']:6.1f}ms "
            f"(readback~{rec['readback_ms']:5.1f}ms) "
            f"docs/s={rec['docs_per_s']:6.1f} q/s={rec['queries_per_s']:6.1f} "
            f"bound={rec['bound_ms']:.2f}ms ({rec['bound_by']}, "
            f"{rec['chain_over_bound']:.1f}x)")


def main(argv=None) -> None:
    import torch

    from generativeaiexamples_tpu_torch.device import resolve_device
    from generativeaiexamples_tpu_torch.serving.__main__ import (
        ENCODER_GEOMETRIES)
    from generativeaiexamples_tpu_torch.models import bert
    from generativeaiexamples_tpu_torch.serving.encoders import (
        EmbeddingEngine)
    from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--batch-sizes", default="16,32,64")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    size = "full" if dev.type == "cuda" else "tiny"
    cfg = ENCODER_GEOMETRIES[size][0]()
    params = bert.init_params(cfg, dev,
                              torch.Generator(device=dev).manual_seed(0))
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"[enc] device={dev} model={size} embedder {cfg.dtype} "
          f"(~{n / 1e6:.0f}M params)")
    docs, queries = mktexts(N_DOCS, 500), mktexts(N_DOCS, 48, seed=1)
    for B in (int(b) for b in args.batch_sizes.split(",")):
        emb = EmbeddingEngine(params, cfg, ByteTokenizer(), max_batch=B,
                              buckets=BUCKETS, device=dev)
        print(format_row(measure(emb, docs, queries)))
        del emb


if __name__ == "__main__":
    main()
