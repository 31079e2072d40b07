"""Disaggregated prefill/decode: KV page transfer between replicas.

The port's own copy of generativeaiexamples_tpu/serving/disagg.py over
torch tensors: the same GKVT1 wire byte for byte (bf16 pages travel by
name and as their raw bits, written and read through torch, so no
ml_dtypes is needed), the same windowing and the same fallbacks.

The DistServe/Mooncake serving shape (OSDI'24): prefill-heavy work and
decode beats have opposite resource profiles: a long prefill is one
huge compute burst that serializes ahead of every decode block on the
same device queue, while decode wants steady short beats. The fleet
therefore specializes replicas by ROLE (`fleet.replica_roles`):
"prefill" replicas run prefill stages only and never receive decode
placements, "decode"/"mixed" replicas serve normal traffic.
`PrefixLocalityRouter.place_disagg` emits the two-stage plan (prefill
replica -> decode replica), and this module moves the finished
prefill's KV pages between them.

Transfer paths, selected per window by `KVPageTransfer`:

* **device path**: when both replicas' pools live on devices this
  process addresses (parallel/mesh.py `devices_colocated`, JAX's rule:
  two LocalReplicas on one card or on two cards of this host, or on the
  CPU in the tests), pages move as tensors straight from the source's
  `engine_model.pool_to_pages` gather into the target's `pages_to_pool`
  scatter: no host bounce, int8 codes + f32 scales verbatim so the route
  is bit-identical to the host bounce. Between two cards the target
  replica moves them with a peer copy on its pool's stream first
  (fleet.py `LocalReplica.import_kv_pages_device`). Any
  device-path failure marks the replica pair broken and falls back to
  the host bounce on the SAME window (counted, never fatal).
* **host bounce** (GKVT: the universal fallback, and the
  `/v1/kv/export` / `/v1/kv/import` wire for process-separated fleets):

  1. the prefill stage runs on the prefill-role replica; its completed
     prefill inserts the prompt's full pages into that replica's radix
     prefix cache (the existing admission path);
  2. `export`: batched `pool_to_pages` gathers on the source, chunked
     at the pager granularity, copied to host memory (a pager-demoted
     tail is read straight from its cold tier, serving/kv_pager.py
     `read_pages`); int8 codes + scales travel VERBATIM, so the
     transfer is bit-identical to never having left the pool;
  3. the bytes cross the replica boundary: in-process as CPU tensors
     (LocalReplica), or serialized through `serialize_kv_transfer` over
     the replica's `/v1/kv/import` endpoint (HttpReplica);
  4. `import`: ONE `pages_to_pool` scatter seats the pages on the
     target and the prefix enters the target's radix tree, so the
     decode submit that follows takes the NORMAL prefix-cache hit path:
     zero re-prefill of the transferred prefix.

With `fleet.disagg_pipeline` the fleet does not wait for the whole
prefill: the source publishes completed chunks' pages mid-prefill
(`LLMEngine.publish_prefill_pages`), each covered window ships while
later chunks compute, and the FINAL window ships from a background
thread (`ship_async`) so decode admission takes its prefix-cache hit
before the last chunk lands. Import dedup + the `first_page` window
contract make a late or repeated chunk harmless.

Both engine halves run as scheduler-thread control ops
(`LLMEngine.run_control_op`), so the tree/allocator/pool single-owner
discipline holds across the transfer. Failures at any stage fall back
to colocated serving on the same stream (`EngineFleet._submit_disagg`):
disagg is an optimization, never a correctness dependency.

Wire format (`serialize_kv_transfer`): a fixed magic + JSON header
(shapes/dtypes/token count) followed by raw little-endian array bytes.
"""

from __future__ import annotations

import json
import logging
import struct
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

_LOG = logging.getLogger(__name__)

_MAGIC = b"GKVT1"


def page_geometry(pool) -> Tuple[tuple, torch.dtype, Optional[tuple]]:
    """(codes_shape, codes_dtype, scales_shape|None) of ONE page of
    `pool` in pool_to_pages' page-major layout: the shared contract
    between export, import, the KV pager and the wire format."""
    if pool.quantized:
        _, L, KH, _, ps, Hd = pool.kv.shape
        return (2, L, KH, ps, Hd), torch.int8, (2, L, KH, ps)
    L, KH, _, ps, Hd = pool.k.shape
    return (2, L, KH, ps, Hd), pool.k.dtype, None


# The dtypes a pool page may travel in, by the name the JAX wire writes
# (numpy's name; "bfloat16" is ml_dtypes' there and torch's here).
_WIRE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                "float32": torch.float32, "int8": torch.int8,
                "uint8": torch.uint8, "int16": torch.int16,
                "int32": torch.int32}
# The same-width integer type that reads a 16-bit float's raw bits.
_RAW = {torch.bfloat16: torch.int16, torch.float16: torch.int16}


def _dtype_name(arr) -> str:
    if isinstance(arr, torch.Tensor):
        return str(arr.dtype).rsplit(".", 1)[-1]
    return np.asarray(arr).dtype.name


def _resolve_dtype(name: str) -> torch.dtype:
    """Dtype NAME -> torch dtype. Unknown names raise TypeError, as
    numpy's np.dtype(name) does for them on the JAX side."""
    dt = _WIRE_DTYPES.get(name)
    if dt is None:
        raise TypeError(f"data type {name!r} not understood")
    return dt


def _raw_bytes(arr) -> bytes:
    """A CPU tensor's or numpy array's contiguous little-endian bytes
    (a 16-bit float through its same-width integer view)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu").contiguous()
        return t.view(_RAW.get(t.dtype, t.dtype)).numpy().tobytes()
    return np.ascontiguousarray(arr).tobytes()


def serialize_kv_transfer(ids: Sequence[int], codes,
                          scales) -> bytes:
    """Pack one transfer (prompt ids + page-major KV bytes) into a
    self-describing buffer: magic | u32 header len | JSON header |
    int32 ids | codes bytes | scales bytes. Codes/scales (torch tensors
    or numpy arrays) are exactly pool_to_pages' layout, moved verbatim
    (never re-quantized). Dtypes travel by NAME ("bfloat16", "float32",
    "int8"); multi-byte types are little-endian on the wire (every
    supported platform is). The bytes equal the JAX package's for the
    same ids and values."""
    header = {
        "n_ids": len(ids),
        "codes_dtype": _dtype_name(codes),
        "codes_shape": list(codes.shape),
        "scales_shape": (list(scales.shape) if scales is not None
                         else None),
    }
    hb = json.dumps(header).encode()
    parts = [_MAGIC, struct.pack("<I", len(hb)), hb,
             np.asarray(list(ids), np.int32).tobytes(), _raw_bytes(codes)]
    if scales is not None:
        s = (scales.detach().to("cpu", torch.float32)
             if isinstance(scales, torch.Tensor)
             else np.asarray(scales, np.float32))
        parts.append(_raw_bytes(s))
    return b"".join(parts)


def deserialize_kv_transfer(buf: bytes) -> Tuple[
        List[int], torch.Tensor, Optional[torch.Tensor]]:
    """Inverse of serialize_kv_transfer -> (ids, codes, scales) as CPU
    tensors, reconstructed bit-identical (bf16 included).

    The buffer arrives off a network endpoint, so every length is
    validated BEFORE any numpy reshape touches it: truncated,
    oversized and garbage payloads all raise ValueError with the
    offending offset — the import endpoint answers 422 bad_kv_payload
    instead of a reshape crash polluting the availability signal.
    Trailing bytes are an error too (a framing bug upstream, not
    padding)."""
    total = len(buf)
    pre = len(_MAGIC) + 4
    if total < pre:
        raise ValueError(
            f"truncated KV transfer payload: {total} bytes is shorter "
            f"than the {pre}-byte magic + header-length preamble")
    if buf[: len(_MAGIC)] != _MAGIC:
        raise ValueError("not a KV transfer payload (bad magic)")
    off = len(_MAGIC)
    (hlen,) = struct.unpack_from("<I", buf, off)
    off += 4
    if hlen > total - off:
        raise ValueError(
            f"malformed KV transfer payload: header claims {hlen} "
            f"bytes at offset {off} but only {total - off} remain")
    try:
        header = json.loads(buf[off: off + hlen].decode())
        if not isinstance(header, dict):
            raise TypeError(f"header is {type(header).__name__}, "
                            "expected object")
        n_ids = int(header["n_ids"])
        codes_dtype = _resolve_dtype(str(header["codes_dtype"]))
        codes_shape = tuple(int(d) for d in header["codes_shape"])
        raw_ss = header["scales_shape"]
        scales_shape = (None if raw_ss is None
                        else tuple(int(d) for d in raw_ss))
        if n_ids < 0 or any(d < 0 for d in codes_shape) or (
                scales_shape is not None
                and any(d < 0 for d in scales_shape)):
            raise TypeError("negative dimension")
    except Exception as e:
        # Garbage headers surface as JSONDecodeError / KeyError /
        # TypeError (unknown dtype name) depending on which field is
        # rotten: normalize with the offset so the sender can find the
        # framing bug.
        raise ValueError(
            f"malformed KV transfer header at offset {off}: "
            f"{type(e).__name__}: {e}") from e
    off += hlen

    def take(count: int, dtype: torch.dtype, what: str) -> torch.Tensor:
        nonlocal off
        raw = _RAW.get(dtype, dtype)
        need = count * torch.empty((), dtype=raw).element_size()
        have = total - off
        if have < need:
            raise ValueError(
                f"short KV transfer body: {what} needs {need} bytes "
                f"at offset {off}, only {have} remain")
        np_raw = torch.empty((), dtype=raw).numpy().dtype
        arr = np.frombuffer(buf, np_raw, count=count, offset=off).copy()
        off += need
        return torch.from_numpy(arr).view(dtype)

    ids = take(n_ids, torch.int32, "ids").tolist()
    n_codes = int(np.prod(codes_shape, dtype=np.int64))
    codes = take(n_codes, codes_dtype, "codes").reshape(codes_shape)
    scales = None
    if scales_shape is not None:
        n_scales = int(np.prod(scales_shape, dtype=np.int64))
        scales = take(n_scales, torch.float32,
                      "scales").reshape(scales_shape)
    if off != total:
        raise ValueError(
            f"oversized KV transfer payload: {total - off} trailing "
            f"bytes after offset {off}")
    return ids, codes, scales


class KVPageTransfer:
    """Page mover between two fleet replicas: per-window transport
    selection (device path when both pools live on devices this
    process addresses, GKVT host bounce otherwise; see the module
    docstring), optional chunking, and the background
    tail-ship that lets decode admission overtake the last chunk.
    The fleet owns fallback-to-colocated policy; `ops` (FleetOps,
    optional) receives the device-fallback count.

    `transfer` returns (pages_imported, wall_ms) — 0 pages with no
    exception means the source had nothing cached (the caller falls
    back) or the target already held the prefix (success: the decode
    submit hits the cache either way).

    Thread model: `transfer`/`transfer_window` run on fleet submit
    threads; `_ship_tail` runs on its own background thread. The
    transfer state they share (the per-pair device-health memo and
    the in-flight tail count `drain()` waits on) lives behind
    ``self._lock`` (a Condition: drain waits on it too) on every
    access."""

    def __init__(self, timeout_s: float = 60.0, chunk_pages: int = 0,
                 device_path: bool = False, ops=None):
        self.timeout_s = float(timeout_s)
        # Pages per window when the fleet chunks a transfer (0 = one
        # window).
        self.chunk_pages = max(0, int(chunk_pages))
        self.device_path = bool(device_path)
        self.ops = ops
        # THE transfer-state lock (see the class docstring's thread
        # model): a Condition so drain() can wait on the in-flight
        # count under the same lock that guards it.
        self._lock = threading.Condition()
        # (src_rid, dst_rid) pairs whose device path failed once:
        # every later window goes straight to the host bounce — a
        # flapping fast path must not pay the exception per chunk.
        self._device_broken: set = set()
        self._inflight = 0  # background tail ships not yet landed

    # graftlint: hot-path
    def transfer(self, src, dst, ids: Sequence[int],
                 page_size: int = 0) -> Tuple[int, float]:
        """Export `ids`' cached prefix from `src` and import it into
        `dst` (replica objects with export_kv_pages/import_kv_pages).
        With `chunk_pages` set (and `page_size` known) the prefix
        moves window by window (each window one bounded export +
        import control-op pair), otherwise in one window. Raises on
        stage failure: the fleet maps that to the colocated
        fallback."""
        t0 = time.perf_counter()
        total = 0
        if self.chunk_pages and page_size:
            start = 0
            while True:
                imported, end_tokens = self.transfer_window(
                    src, dst, ids, start, self.chunk_pages)
                total += imported
                end_page = end_tokens // page_size
                if end_page <= start:
                    break  # window empty: prefix exhausted
                start = end_page
        else:
            total, _ = self.transfer_window(src, dst, ids, 0, 0)
        return total, (time.perf_counter() - t0) * 1e3

    # graftlint: hot-path
    def transfer_window(self, src, dst, ids: Sequence[int],
                        start_page: int = 0, max_pages: int = 0
                        ) -> Tuple[int, int]:
        """Move ONE page window [start_page, start_page+max_pages) of
        `ids`' cached prefix (max_pages<=0: through the end). Tries
        the device path first when enabled and the pair qualifies; a
        device failure marks the pair broken, counts the fallback,
        and re-ships the SAME window over the host bounce — transport
        trouble is never a stream failure. Returns (pages_imported,
        end_tokens) where end_tokens is the prefix covered through
        the window's end — (0, 0) when the window is empty."""
        if self.device_path and self.device_ok(src, dst):
            try:
                got = self._window_device(src, dst, ids, start_page,
                                          max_pages)
                if got is not None:
                    return got
            except Exception as e:
                with self._lock:
                    self._device_broken.add(
                        (getattr(src, "rid", ""), getattr(dst, "rid", "")))
                if self.ops is not None:
                    self.ops.note_disagg_device_fallback()
                _LOG.warning(
                    "device-path KV transfer %s->%s failed at page %d "
                    "(%s: %s); falling back to host bounce",
                    getattr(src, "rid", "?"), getattr(dst, "rid", "?"),
                    start_page, type(e).__name__, e)
        exported = src.export_kv_pages(ids, timeout_s=self.timeout_s,
                                       start_page=start_page,
                                       max_pages=max_pages)
        if exported is None:
            return 0, 0
        codes, scales, n_tokens = exported
        pages = dst.import_kv_pages(list(ids)[:n_tokens], codes, scales,
                                    timeout_s=self.timeout_s,
                                    first_page=start_page)
        return pages, n_tokens

    def _window_device(self, src, dst, ids: Sequence[int],
                       start_page: int, max_pages: int
                       ) -> Optional[Tuple[int, int]]:
        """Device leg of one window: the source's pool gather stays a
        device tensor end to end (zero serialization); the target
        scatters it straight into its pool. None when the window holds
        no device-resident pages (a pager-demoted tail: the caller's
        host bounce covers it; NOT a device failure). The device
        export caps each call at the engine's max_pages gather width,
        so an uncapped window ships in several sub-windows here."""
        ps = src.transfer_page_size()
        start = end = max(0, int(start_page))
        stop = None if max_pages <= 0 else start + int(max_pages)
        total = 0
        while stop is None or end < stop:
            cap = 0 if stop is None else stop - end
            exported = src.export_kv_pages_device(
                ids, timeout_s=self.timeout_s, start_page=end,
                max_pages=cap)
            if exported is None:
                break
            codes, scales, n_tokens = exported
            total += dst.import_kv_pages_device(
                list(ids)[:n_tokens], codes, scales,
                timeout_s=self.timeout_s, first_page=end)
            new_end = n_tokens // ps
            if new_end <= end:
                break
            end = new_end
        if end == start:
            return None  # no device-resident pages in this window
        return total, end * ps

    def device_ok(self, src, dst) -> bool:
        """May this pair take the device path right now? Both replicas
        must expose the device surface (LocalReplicas; an HttpReplica
        never does: its engine lives in another process, so the wire
        is the only route), their pools' devices must be addressable
        from this process (parallel/mesh.py devices_colocated, JAX's
        rule: one card, or a peer copy between two cards of this host),
        and the pair must not have failed the fast path before."""
        if not (hasattr(src, "export_kv_pages_device")
                and hasattr(dst, "import_kv_pages_device")
                and hasattr(src, "transfer_page_size")):
            return False
        with self._lock:
            if (getattr(src, "rid", ""),
                    getattr(dst, "rid", "")) in self._device_broken:
                return False
        from generativeaiexamples_tpu_torch.parallel.mesh import (
            devices_colocated)

        try:
            return devices_colocated(src.transfer_device_set(),
                                     dst.transfer_device_set())
        except Exception as e:
            # A failed probe just means "host bounce", but say why.
            _LOG.warning(
                "device-path colocation probe %s->%s failed: %s: %s",
                getattr(src, "rid", "?"), getattr(dst, "rid", "?"),
                type(e).__name__, e)
            return False

    def ship_async(self, src, dst, ids: Sequence[int],
                   start_page: int = 0) -> threading.Thread:
        """Ship the tail [start_page, end-of-prefix) from a background
        thread and return immediately: the pipelined fleet calls this
        for the FINAL window so decode admission takes its prefix-
        cache hit before the last chunk lands. Import dedup + the
        first_page contract make the late chunk harmless; a tail
        failure only costs the decode side a re-prefill of that tail
        (logged, never a stream failure). fleet.stop() drains these
        via drain()."""
        with self._lock:
            self._inflight += 1
        t = threading.Thread(target=self._ship_tail,
                             args=(src, dst, list(ids), start_page),
                             daemon=True, name="kv-tail-ship")
        t.start()
        return t

    # graftlint: hot-path
    def _ship_tail(self, src, dst, ids: List[int],
                   start_page: int) -> None:
        try:
            self.transfer_window(src, dst, ids, start_page, 0)
        except Exception as e:
            _LOG.warning("background KV tail ship at page %d failed: "
                         "%s: %s — the decode side re-prefills that "
                         "tail", start_page, type(e).__name__, e)
        finally:
            with self._lock:
                self._inflight -= 1
                self._lock.notify_all()

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Block until every background tail ship has landed (True) or
        the timeout passed (False, tails still in flight)."""
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        with self._lock:
            while self._inflight:
                wait = (1.0 if deadline is None
                        else deadline - time.monotonic())
                if wait <= 0:
                    return False
                self._lock.wait(wait)
            return True
