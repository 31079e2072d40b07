"""Paged KV cache: host-side page allocator + device page pool.

Counterpart of generativeaiexamples_tpu/serving/kv_cache.py.

- Device, bf16 / f32: `PagePool`, k/v tensors [L, KH, P, page_size, Hd];
  `pool.k[l]` is the contiguous [KH, P, ps, Hd] slice the K2 kernel reads.
- Device, int8: `QuantPagePool`, the FUSED pool: codes
  [2, L, KH, P, page_size, Hd] ([0] = k, [1] = v) and one f32 scale per
  (k|v, layer, kv head, token) [2, L, KH, P, page_size]. The K4 kernel
  reads the whole pool and indexes the layer itself.
- Page 0 is a reserved sink in both: padding positions and unused
  page-table slots point at it, so scatters never need dynamic shapes.
- Host: PageAllocator hands out page ids from a plain free list in the
  same order as the JAX allocator (page ids feed identical streams).

The engine updates the pool IN PLACE (the JAX steps donate and return
it instead).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class PagePool:
    k: torch.Tensor  # [L, KH, P, page_size, Hd]
    v: torch.Tensor
    page_size: int

    @property
    def n_pages(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return False

    @staticmethod
    def zeros(cfg, n_pages: int, page_size: int = 64, dtype=None,
              device: DeviceLike = None):
        """A zeroed pool on `device` (CUDA unless the caller asks for the
        CPU); dtype torch.int8 gives a QuantPagePool."""
        dtype = dtype or cfg.dtype
        if dtype == torch.int8:
            return QuantPagePool.zeros(cfg, n_pages, page_size, device)
        dev = resolve_device(device)
        shape = (cfg.n_layers, cfg.n_kv_heads, n_pages, page_size,
                 cfg.head_dim)
        return PagePool(torch.zeros(shape, dtype=dtype, device=dev),
                        torch.zeros(shape, dtype=dtype, device=dev),
                        page_size)


@dataclasses.dataclass
class QuantPagePool:
    """int8 page pool with fused k/v codes and narrow scales. The k|v axis
    leads, so a decode write indexes [0 | 1, layer, :, page, offset] and
    stays an in-place scatter."""

    kv: torch.Tensor  # int8 [2, L, KH, P, page_size, Hd]; [0] = k, [1] = v
    s: torch.Tensor   # f32  [2, L, KH, P, page_size] (amax / 127)
    page_size: int

    @property
    def n_pages(self) -> int:
        return self.kv.shape[3]

    @property
    def quantized(self) -> bool:
        return True

    @property
    def nbytes(self) -> int:
        return (self.kv.numel() * self.kv.element_size()
                + self.s.numel() * self.s.element_size())

    @staticmethod
    def zeros(cfg, n_pages: int, page_size: int = 64,
              device: DeviceLike = None) -> "QuantPagePool":
        dev = resolve_device(device)
        shape = (2, cfg.n_layers, cfg.n_kv_heads, n_pages, page_size,
                 cfg.head_dim)
        return QuantPagePool(torch.zeros(shape, dtype=torch.int8, device=dev),
                             torch.zeros(shape[:-1], dtype=torch.float32,
                                         device=dev),
                             page_size)


class PageAllocator:
    """Host-side ref-counted free list. Page 0 is never handed out (the
    sink). release() raises on a double free or a page never allocated."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._rc: dict = {}  # page id -> refcount (allocated pages only)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return self._rc.get(page, 0)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(f"KV page pool exhausted: want {n}, have "
                              f"{len(self._free)} of {self.n_pages}")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._rc[p] = 1
        return out

    def retain(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p not in self._rc:
                raise ValueError(f"retain of unallocated page {p}")
            self._rc[p] += 1

    def release(self, pages: Sequence[int]) -> None:
        for p in pages:
            if not 0 < p < self.n_pages:
                raise ValueError(f"page id {p} out of range "
                                 f"(pool has {self.n_pages})")
            rc = self._rc.get(p, 0)
            if rc <= 0:
                raise ValueError(f"double free of page {p}")
            if rc == 1:
                del self._rc[p]
                self._free.append(p)
            else:
                self._rc[p] = rc - 1


class SequencePages:
    """Page bookkeeping for one active sequence."""

    def __init__(self, allocator: PageAllocator, page_size: int,
                 max_pages: int):
        self.allocator = allocator
        self.page_size = page_size
        self.max_pages = max_pages
        self.pages: List[int] = []
        self.length = 0  # tokens written

    def ensure(self, new_length: int) -> None:
        """Grow the page list to cover new_length tokens."""
        need = -(-new_length // self.page_size)
        if need > self.max_pages:
            raise MemoryError(
                f"sequence needs {need} pages > max_pages {self.max_pages}")
        if need > len(self.pages):
            self.pages.extend(self.allocator.alloc(need - len(self.pages)))
        self.length = new_length

    def table_row(self) -> np.ndarray:
        row = np.zeros((self.max_pages,), np.int32)  # padding -> page 0
        row[: len(self.pages)] = self.pages
        return row

    def release(self) -> None:
        """Idempotent: the page list is emptied before the allocator call,
        so error paths that release twice are no-ops."""
        pages, self.pages = self.pages, []
        self.length = 0
        if pages:
            self.allocator.release(pages)
