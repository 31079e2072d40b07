"""Crash-safe file writes: the tmp + ``os.replace`` idiom.

The port's copy of generativeaiexamples_tpu/utils/fsio.py.

A persisted artifact is never rewritten in place — a crash mid-write
would leave a truncated file that poisons the next load. This is the
one shared implementation for plain-text/JSON artifacts (the vector
store keeps its own ``_atomic_replace`` for the callback-shaped npz
writers it predates). The tmp name carries the pid so two PROCESSES
persisting the same artifact cannot clobber each other's staging file;
same-process writers are expected to serialize at a higher level (they
already must, or the final os.replace order would be arbitrary).
"""

from __future__ import annotations

import os


def atomic_write_text(path: str, text: str) -> None:
    """Write ``text`` to ``path`` via a pid-suffixed tmp file and
    ``os.replace`` — the artifact is either the old bytes or the new
    bytes, never a truncated mix."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(text)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
