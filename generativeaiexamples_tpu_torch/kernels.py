"""Build, bind and launch the port's hand-written CUDA kernels.

Each source under `csrc/` is one kernel with a plain C entry point. It is
compiled with `nvcc` for `sm_90a` into its own shared library under
`build/torch_kernels/` at first use, and loaded with `ctypes`; pointers
and the CUDA stream cross as `c_void_p`. A library is rebuilt when the
hash of its source, of the shared `csrc/*.cuh` headers or of the
compiler flags changes, and several
sources compile in parallel (one `nvcc` each, all started together).

Every entry point returns the launch's `cudaError_t`; `launch` raises on
anything but 0, so a kernel that was refused (too much shared memory, a
bad shape) never passes silently. A failed build raises too: nothing in
the port falls back to a plain version on a CUDA tensor.

`LAUNCHES` counts, per kernel, the launches made through `launch` in
this process, and those a replayed CUDA graph makes (`add_launches`).
It exists so a run can show that the main path went through the
kernels (`chip_smoke.py` zeroes it with `reset_launches` before driving
the path and reads it after). A launch recorded into a CUDA graph runs
nothing: `capture_launches` counts those of its thread apart.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)

# kernel name -> (C symbol, argtypes). The source is csrc/<name>.cu.
SIGNATURES = {
    # q, k, v, o, lengths, q_offset, B, H, KH, Sq, Sk, D, strides[12],
    # scale, causal, stream
    "flash_attention": ("gaie_flash_attention_bf16",
                        [_P] * 6 + [_I] * 6 + [_STRIDES, _F, _I, _P]),
    # q, k_pages, v_pages, o, page_table, lengths, workspace, tickets, B,
    # H, KH, P, ps, maxp, Hd, key_slices, stage_keys, ring_stages,
    # pages_per_split, scale, stream
    "paged_attention": ("gaie_paged_attention_bf16",
                        [_P] * 8 + [_I] * 11 + [_F, _P]),
    # q, k, v, o, lengths, B, H, S, D, strides[12], scale, stream
    "encoder_attention": ("gaie_encoder_attention_bf16",
                          [_P] * 5 + [_I] * 4 + [_STRIDES, _F, _P]),
    # q, kv, scales, o, page_table, lengths, workspace, tickets, B, H, KH,
    # L, P, ps, maxp, Hd, layer, q_rep, tree_k, tree_m, key_slices,
    # pages_per_split, scale, stream
    "paged_attention_int8": ("gaie_paged_attention_int8",
                             [_P] * 8 + [_I] * 14 + [_F, _P]),
    # q, k_pages, v_pages, o, page_table, lengths, workspace, tickets, B,
    # H, KH, P, ps, maxp, Hd, tree_k, tree_m, key_slices, stage_keys,
    # ring_stages, pages_per_split, scale, stream
    "paged_attention_tree": ("gaie_paged_tree_attention_bf16",
                             [_P] * 8 + [_I] * 13 + [_F, _P]),
    # x, q, scale, y, workspace, tickets, R, K, M, row_tile, splits,
    # k_tiles_per_split, stream
    "int8_matmul": ("gaie_int8_matmul_bf16", [_P] * 6 + [_I] * 6 + [_P]),
}

LAUNCHES: Dict[str, int] = dict.fromkeys(SIGNATURES, 0)

_LOCK = threading.Lock()
_FUNCS: Dict[str, object] = {}


# Arrival tickets of the split kernels (K2, K4, K5, K6): int32 zeros per
# (kernel, device, stream), grown on demand and left zeroed by every
# launch (the last CTA of a group resets its ticket). Launches on one
# stream run in order, so a kernel's launches on it share one buffer;
# engines whose threads launch on different streams (fleet replicas in
# one process may) get a buffer each, so two launches in flight at once
# never share a ticket.
_TICKETS: Dict[tuple, object] = {}
# Guards LAUNCHES and _TICKETS: fleet replicas in one process launch from
# their own scheduler threads.
_COUNT_LOCK = threading.Lock()


def tickets(name: str, device, n: int):
    """At least `n` zeroed int32 tickets for kernel `name` on `device`, a
    tensor's device (which names its index), for the current stream of
    that device. A dictionary hit on the hot path: the wrappers call it
    on every split launch."""
    import torch

    key = (name, device, torch.cuda.current_stream(device).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        with _COUNT_LOCK:
            t = _TICKETS.get(key)
            if t is None or t.numel() < n:
                t = _TICKETS[key] = torch.zeros(
                    max(n, 4096), dtype=torch.int32, device=device)
    return t


def add_launches(counts: Dict[str, int]) -> None:
    """Add `counts` (kernel -> launches, either sign) to LAUNCHES: a CUDA
    graph's replay launches the kernels it captured without a call
    through `launch` (serving/step_graphs.py)."""
    with _COUNT_LOCK:
        for name, n in counts.items():
            LAUNCHES[name] += n


# Per thread: the counts of a CUDA graph capture running on it
# (capture_launches), which its launches go to instead of LAUNCHES.
_CAPTURE = threading.local()


@contextlib.contextmanager
def capture_launches():
    """Count the launches this thread makes inside the block in a dict of
    their own (kernel -> launches), which it yields, and not in
    LAUNCHES: a stream capture records them and runs none. Launches of
    other threads (fleet replicas serving meanwhile) still count in
    LAUNCHES."""
    counts: Dict[str, int] = {}
    _CAPTURE.counts = counts
    try:
        yield counts
    finally:
        _CAPTURE.counts = None


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the port's CUDA kernels are built from csrc/ "
                           "at first use and need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where kernel `name`'s library lives: keyed by the hash of its
    source, of every shared header under csrc/ (any source may include
    any of them) and of the compiler flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) whose library is missing
    or stale, one `nvcc` process per source, all in parallel. Returns
    {name: seconds} for the ones compiled; `ptxas -v` output (registers,
    shared memory, spills) is kept beside each library as `<lib>.log`."""
    names = list(names if names is not None else SIGNATURES)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    secs: Dict[str, float] = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for csrc/{name}.cu "
                          f"(rc {proc.returncode}):\n{log[-6000:]}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def _func(name: str):
    fn = _FUNCS.get(name)
    if fn is not None:
        return fn
    with _LOCK:
        if name not in _FUNCS:
            build([name])
            symbol, argtypes = SIGNATURES[name]
            lib = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FUNCS[name] = fn
        return _FUNCS[name]


def strides_arg(*strides: int):
    """A C array of int64 strides for an entry point's `strides` arg."""
    return (ctypes.c_longlong * len(strides))(*strides)


def launch(name: str, *args) -> None:
    """Launch kernel `name` with its C arguments (the stream last), raise
    if the launch was refused, and count it in LAUNCHES."""
    rc = _func(name)(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {rc}")
    captured = getattr(_CAPTURE, "counts", None)
    if captured is not None:
        captured[name] = captured.get(name, 0) + 1
        return
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
