"""Probe the tensor-parallel backend rule on this host's card(s).

    python3 scripts/tp_backend_probe.py

Two rank processes on cuda:0:

1. NCCL: `init_process_group("nccl")` with both ranks bound to cuda:0,
   then one all_reduce. NCCL is expected to refuse it ("Duplicate GPU
   detected"): the reason the port picks gloo for ranks that share a
   device (parallel/mesh.py `backend_for`). Each rank runs in its own
   process with a time limit, killed if it hangs.
2. gloo: bf16 all_reduce, f32 all_gather and bf16 broadcast on CUDA
   tensors (gloo stages them through host memory), checked for exact
   values, then timed (median of 20 calls after 3 warm-ups, CUDA
   synchronized around each) at the 8B TP=2 serving shapes: the decode
   all-reduce [4, 1, 4096] bf16, a 128-token prefill all-reduce
   [4, 128, 4096] bf16, and the vocab-sharded logits gather 2 x [4, 64128]
   f32.

Prints one JSON line: the card (nvidia-smi name and power limit), the
NCCL outcome and error text, the gloo checks and the times in ms.
"""

from __future__ import annotations

import datetime
import json
import multiprocessing as mp
import socket
import statistics
import subprocess
import sys
import time


def _port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _nccl_rank(rank: int, port: int, out) -> None:
    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        store = dist.TCPStore("127.0.0.1", port, 2, rank == 0,
                              timeout=datetime.timedelta(seconds=30))
        dist.init_process_group("nccl", store=store, rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=30),
                                device_id=torch.device("cuda", 0))
        x = torch.ones(4, device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        out.put((rank, "ok", float(x[0])))
    except Exception as e:  # the outcome under test
        out.put((rank, "error", f"{type(e).__name__}: {e}"[:600]))


def _gloo_rank(rank: int, port: int, out) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    store = dist.TCPStore("127.0.0.1", port, 2, rank == 0,
                          timeout=datetime.timedelta(seconds=60))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    dev = torch.device("cuda", 0)
    x = torch.full((3, 5), 1.5 + rank, dtype=torch.bfloat16, device=dev)
    dist.all_reduce(x)
    parts = [torch.empty(4, device=dev) for _ in range(2)]
    dist.all_gather(parts, torch.full((4,), float(rank), device=dev))
    b = torch.full((6,), float(rank + 7), dtype=torch.bfloat16, device=dev)
    dist.broadcast(b, 0)
    checks = {
        "all_reduce_bf16": bool((x == 4.0).all()) and x.is_cuda,
        "all_gather_f32": [p.tolist() for p in parts] == [[0.0] * 4,
                                                          [1.0] * 4],
        "broadcast_bf16": bool((b == 7.0).all()),
    }

    def timed(fn, n=20, warm=3):
        for _ in range(warm):
            fn()
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    dec = torch.randn(4, 1, 4096, device=dev).to(torch.bfloat16)
    pre = torch.randn(4, 128, 4096, device=dev).to(torch.bfloat16)
    logits = torch.randn(4, 64128, device=dev)
    gathered = [torch.empty_like(logits) for _ in range(2)]
    ms = {"all_reduce_decode_4x1x4096_bf16": timed(lambda: dist.all_reduce(dec)),
          "all_reduce_prefill_4x128x4096_bf16":
              timed(lambda: dist.all_reduce(pre)),
          "all_gather_logits_2x4x64128_f32":
              timed(lambda: dist.all_gather(gathered, logits))}
    out.put((rank, "ok", {"checks": checks, "ms": ms}))
    dist.destroy_process_group()


def _pair(target, timeout_s: float) -> list:
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _port()
    procs = [ctx.Process(target=target, args=(r, port, out))
             for r in range(2)]
    for p in procs:
        p.start()
    got = []
    deadline = time.monotonic() + timeout_s
    while len(got) < 2 and time.monotonic() < deadline:
        try:
            got.append(out.get(timeout=1))
        except Exception:
            if not any(p.is_alive() for p in procs):
                break
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join()
    return sorted(got) + [("exitcodes", [p.exitcode for p in procs])]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tp_backend_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    nccl = _pair(_nccl_rank, 90)
    gloo = _pair(_gloo_rank, 120)
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "nccl_two_ranks_one_device": nccl,
                      "gloo_cuda_tensors": gloo}), flush=True)
    ok = all(r[1] == "ok" and all(r[2]["checks"].values())
             for r in gloo[:2]) and len(gloo) == 3
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
