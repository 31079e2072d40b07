"""ctypes binding for the C SPSC ring (sdr_ring.c) and its Python twin.

Counterpart of generativeaiexamples_tpu/native/ring.py, over the port's
own copy of the C source. The library is built on first use with
`cc -O2 -shared -fPIC` into build/native/ at the repo root (as kernels.py
builds the CUDA kernels into build/torch_kernels/), named by a hash of
the source so an edited source rebuilds; never next to the source. A
host with no C compiler on PATH gets `PyRing`, the JAX package's
fallback; a compiler that fails on the source raises. ctypes releases
the GIL for every foreign call, so `recv_udp` drains the socket at full
speed while torch dispatch owns the Python side.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_LOG = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "sdr_ring.c"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False
_BUILD_LOCK = threading.Lock()


def library_path() -> Path:
    """Where the built library lies: build/native/sdr_ring-<hash>.so."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"sdr_ring-{digest}.so"


def _build() -> Optional[Path]:
    """The built library (built now if missing), or None when the host
    has no C compiler."""
    so = library_path()
    if so.exists():
        return so
    cc = shutil.which("cc")
    if cc is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cc, "-O2", "-shared", "-fPIC", "-o", tmp, str(SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    with _BUILD_LOCK:
        if _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        so = _build()
        if so is None:
            _LOG.warning("no C compiler on PATH; the SDR ring is the "
                         "pure-Python one (packet loss possible under load)")
            return None
        lib = ctypes.CDLL(str(so))
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_create.argtypes = [ctypes.c_size_t]
        lib.ring_destroy.argtypes = [ctypes.c_void_p]
        lib.ring_capacity.restype = ctypes.c_size_t
        lib.ring_capacity.argtypes = [ctypes.c_void_p]
        lib.ring_size.restype = ctypes.c_size_t
        lib.ring_size.argtypes = [ctypes.c_void_p]
        lib.ring_dropped.restype = ctypes.c_uint64
        lib.ring_dropped.argtypes = [ctypes.c_void_p]
        lib.ring_received.restype = ctypes.c_uint64
        lib.ring_received.argtypes = [ctypes.c_void_p]
        lib.ring_push.restype = ctypes.c_size_t
        lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_size_t]
        lib.ring_pop.restype = ctypes.c_size_t
        lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_size_t]
        lib.ring_recv_udp.restype = ctypes.c_long
        lib.ring_recv_udp.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_long, ctypes.c_int]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _load() is not None


class PyRing:
    """Pure-Python ring with the same surface and the same
    whole-datagram drop semantics."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._buf = bytearray()
        self._lock = threading.Lock()
        self.dropped = 0
        self.received = 0

    def push(self, data: bytes) -> int:
        with self._lock:
            if len(self._buf) + len(data) > self.capacity:
                self.dropped += len(data)
                return 0
            self._buf.extend(data)
            self.received += len(data)
            return len(data)

    def pop(self, n: int) -> bytes:
        with self._lock:
            out = bytes(self._buf[:n])
            del self._buf[:n]
            return out

    def __len__(self) -> int:
        return len(self._buf)

    def recv_udp(self, sock, max_bytes: int, idle_timeout_ms: int = 1000
                 ) -> int:
        import select

        got = 0
        while got < max_bytes:
            r, _, _ = select.select([sock], [], [], idle_timeout_ms / 1e3)
            if not r:
                break
            pkt = sock.recv(65536)
            if not pkt:
                break
            got += self.push(pkt)
        return got

    def close(self) -> None:
        pass


class IQRing:
    """The C-backed SPSC ring; raises ImportError when the host has no C
    compiler (`make_ring` then picks PyRing)."""

    def __init__(self, capacity: int):
        lib = _load()
        if lib is None:
            raise ImportError("native ring unavailable")
        self._lib = lib
        self._ptr = lib.ring_create(capacity)
        if not self._ptr:
            raise MemoryError("ring_create failed")
        self.capacity = capacity

    def push(self, data: bytes) -> int:
        return self._lib.ring_push(self._ptr, data, len(data))

    def pop(self, n: int) -> bytes:
        out = ctypes.create_string_buffer(n)
        got = self._lib.ring_pop(self._ptr, out, n)
        return out.raw[:got]

    def __len__(self) -> int:
        return self._lib.ring_size(self._ptr)

    @property
    def dropped(self) -> int:
        return self._lib.ring_dropped(self._ptr)

    @property
    def received(self) -> int:
        return self._lib.ring_received(self._ptr)

    def recv_udp(self, sock, max_bytes: int, idle_timeout_ms: int = 1000
                 ) -> int:
        """Drain `sock` into the ring outside the GIL. Call from a
        dedicated thread; pop from the consumer thread."""
        return self._lib.ring_recv_udp(self._ptr, sock.fileno(),
                                       max_bytes, idle_timeout_ms)

    def close(self) -> None:
        if getattr(self, "_ptr", None):
            self._lib.ring_destroy(self._ptr)
            self._ptr = None

    def __del__(self):  # pragma: no cover
        self.close()


def make_ring(capacity: int = 8 << 20):
    """The C ring where the host can build it, else PyRing."""
    return IQRing(capacity) if native_available() else PyRing(capacity)
