"""Native runtime pieces (C, bound with ctypes) around the torch compute
path: the SDR ingest ring buffer and its GIL-free UDP drain loop
(sdr_ring.c, the port's own copy). Built on first use with the host's
C compiler into build/native/; a host with no compiler gets the
pure-Python ring, as the JAX package's does."""

from generativeaiexamples_tpu_torch.native.ring import (
    IQRing, PyRing, make_ring, native_available)

__all__ = ["IQRing", "PyRing", "make_ring", "native_available"]
