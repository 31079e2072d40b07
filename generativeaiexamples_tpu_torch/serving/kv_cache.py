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
- Host: PageAllocator hands out ref-counted page ids from a plain free
  list in the same order as the JAX allocator (page ids feed identical
  streams). The prefix cache (serving/prefix_cache.py) holds one
  reference per cached page and every adopting sequence another
  (`SequencePages.adopt`); the allocator's `reclaim` hook lets the cache
  give pages back when live traffic runs short.

The engine updates the pool IN PLACE (the JAX steps donate and return
it instead).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

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

    @staticmethod
    def for_budget(cfg, hbm_bytes: int, page_size: int = 64, dtype=None,
                   device: DeviceLike = None):
        """A zeroed pool of as many pages as `hbm_bytes` holds (at least
        2), k and v together; torch.int8 gives a QuantPagePool, whose
        pages also hold one f32 scale a (k|v, layer, kv head, token)."""
        dtype = dtype or cfg.dtype
        itemsize = torch.empty((), dtype=dtype).element_size()
        per_tok = cfg.n_kv_heads * cfg.head_dim * itemsize
        if dtype == torch.int8:
            per_tok += cfg.n_kv_heads * 4
        per_page = cfg.n_layers * page_size * per_tok * 2
        n_pages = max(2, hbm_bytes // per_page)
        return PagePool.zeros(cfg, int(n_pages), page_size, dtype, device)


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
    sink). Pages are born with refcount 1; retain() adds a reference and
    release() drops one, returning the page to the free list at zero. It
    raises on a double free or a page never allocated.

    `reclaim` (optional callable, n_short -> None) runs when alloc()
    comes up short, before it raises: the prefix cache registers its LRU
    eviction there, so cold cached pages always yield to live traffic."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._rc: dict = {}  # page id -> refcount (allocated pages only)
        self.reclaim: Optional[Callable[[int], None]] = None

    @property
    def n_free(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return self._rc.get(page, 0)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free) and self.reclaim is not None:
            self.reclaim(n - len(self._free))
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
        # Leading pages adopted read-only from the prefix cache: the
        # sequence holds a reference but never writes them (the engine
        # points their scatter rows at the page-0 sink).
        self.n_shared = 0

    def adopt(self, pages: Sequence[int],
              n_tokens: int) -> Optional[Tuple[int, int]]:
        """Adopt a cached prefix: `pages` (ref-counted, read-only) cover
        `n_tokens` (<= len(pages) * page_size). Fully covered pages are
        shared in place; a partially covered tail page is copy-on-write:
        a fresh private page takes its table slot and the caller fills it
        (the engine's scratch-cache scatter rewrites the whole page,
        gathered head and computed tail). Returns the (src, dst) CoW
        pair, or None when the prefix ends on a page boundary."""
        if self.pages or self.length:
            raise ValueError("adopt() must come before ensure()")
        ps = self.page_size
        if not 0 < n_tokens <= len(pages) * ps:
            raise ValueError(f"adopt: {n_tokens} tokens not covered by "
                             f"{len(pages)} pages of {ps}")
        n_full = n_tokens // ps
        self.allocator.retain(pages[:n_full])
        self.pages = list(pages[:n_full])
        self.n_shared = n_full
        cow = None
        if n_tokens % ps:
            dst = self.allocator.alloc(1)[0]
            self.pages.append(dst)
            cow = (pages[n_full], dst)
        self.length = n_tokens
        return cow

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
        self.n_shared = 0
        if pages:
            self.allocator.release(pages)
