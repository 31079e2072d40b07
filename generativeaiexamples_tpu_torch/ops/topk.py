"""Maximum-inner-product search: a float32 matmul plus top-k.

Counterpart of generativeaiexamples_tpu/ops/topk.py, which is plain
`jnp` there (einsums, `lax.top_k` and, sharded, `shard_map` with an
all-gather; no Pallas kernel), so the port leaves it to `torch.matmul`
and `torch.topk`. Exact (recall 1.0). Two layouts:

- `mips_topk`: single-device exact search.
- `ShardedMIPSIndex` / `sharded_mips_topk`: the database rows in
  contiguous blocks over a mesh axis (parallel/mesh.py `axis_devices`),
  one block a device, in one process as in JAX; each shard scores its
  block and keeps a local top-k, the [Q, n_shards * k] candidates are
  copied to the first shard's device and concatenated (the all-gather),
  and a final top-k reduces them. Global row ids come from each shard's
  base; padding rows (N not divisible by the shards) score -inf.

Queries are scored in tiles of QUERY_TILE rows, every tile one matmul of
the same shape, so a query's scores do not depend on how many queries
share its call: the library picks its GEMM by shape, and two shapes round
differently, which reorders near-tied results. A search alone and the
same search inside a coalesced batch (serving/batcher.py) then return
the same ids in the same order. The sharded search also selects in
fixed tiles, with ties ordered by the lower index (`ordered_topk`, the
`lax.top_k` order).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

QUERY_TILE = 16


def tiled_scores(q: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """q [Q, D] x table [L, D] -> [Q, L], scored in QUERY_TILE-row tiles
    of one shape (the last padded), so a query's scores do not depend on
    how many queries share its call."""
    n = q.shape[0]
    pad = -n % QUERY_TILE
    if pad:
        q = torch.cat([q, q.new_zeros((pad, q.shape[1]))])
    t = table.T
    return torch.cat([torch.matmul(tile, t)
                      for tile in q.split(QUERY_TILE)])[:n]


def ordered_topk(x: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties ordered by the lower index (the
    `lax.top_k` order; `torch.topk` leaves them unordered on CUDA)."""
    vals, idx = torch.topk(x, k, dim=-1)
    idx, perm = idx.sort(dim=-1)
    vals, perm2 = vals.gather(-1, perm).sort(dim=-1, descending=True,
                                             stable=True)
    return vals, idx.gather(-1, perm2)


def tiled_topk(x: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`ordered_topk` of each row of x [Q, L], in QUERY_TILE-row tiles of
    one shape (the last padded with -inf), so the selection does not
    depend on how many queries share the call."""
    n = x.shape[0]
    pad = -n % QUERY_TILE
    if pad:
        x = torch.cat([x, x.new_full((pad, x.shape[1]), -torch.inf)])
    vals, idx = zip(*(ordered_topk(t, k) for t in x.split(QUERY_TILE)))
    return torch.cat(vals)[:n], torch.cat(idx)[:n]


def mips_topk(queries: torch.Tensor, database: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner products in float32. queries [Q, D], database
    [N, D] -> (scores [Q, k], indices [Q, k]), best first."""
    return torch.topk(tiled_scores(queries.float(), database.float()), k,
                      dim=-1)


def stored_rows(x) -> torch.Tensor:
    """`x` ([N, D] numpy or tensor) as an f32 tensor where it lies: numpy
    stays on the host (no copy when already f32 and writable)."""
    if isinstance(x, torch.Tensor):
        return x.float()
    arr = np.ascontiguousarray(x, np.float32)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


class ShardedMIPSIndex:
    """Distributed exact top-k index: database rows in contiguous blocks
    over the mesh axis `axis`, one block on each of the axis's devices
    (`parallel.mesh.axis_devices`), placed ONCE at construction so a
    search moves only the queries and the candidates.

    Search: each shard's f32 product and local top-k (min(k, rows a
    shard)), the [Q, n_shards * k] candidates copied to the first
    shard's device and concatenated, and a final top-k (min(k, N)).
    Index arithmetic restores global row ids."""

    def __init__(self, database, mesh, axis: str = "tensor"):
        from generativeaiexamples_tpu_torch.parallel.mesh import (
            axis_devices)

        self.mesh, self.axis = mesh, axis
        self.devices = axis_devices(mesh, axis)
        self.device = self.devices[0]
        self.n_shards = len(self.devices)
        rows = stored_rows(database)
        n = int(rows.shape[0])
        self.n_rows = n
        self.pad = (-n) % self.n_shards
        self.shard_rows = (n + self.pad) // self.n_shards
        self.shards = []
        for s, dev in enumerate(self.devices):
            block = rows[s * self.shard_rows:(s + 1) * self.shard_rows]
            shard = torch.zeros((self.shard_rows, rows.shape[1]),
                                dtype=torch.float32, device=dev)
            shard[:len(block)] = block.to(dev)
            self.shards.append(shard)

    def nbytes(self) -> int:
        """Device bytes of the shards."""
        return sum(t.numel() * t.element_size() for t in self.shards)

    def search(self, queries, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """queries [Q, D] -> (scores [Q, kk], global row ids [Q, kk]
        int64), both on the first shard's device, best first."""
        q = stored_rows(queries)
        kk = min(k, self.shard_rows)
        best, ids = [], []
        for s, (dev, shard) in enumerate(zip(self.devices, self.shards)):
            base = s * self.shard_rows
            sc = tiled_scores(q.to(dev), shard)
            row = base + torch.arange(self.shard_rows, device=dev)
            sc = torch.where(row < self.n_rows, sc,
                             torch.full_like(sc, -torch.inf))
            v, i = tiled_topk(sc, kk)
            best.append(v.to(self.device))
            ids.append((i + base).to(self.device))
        top, pos = tiled_topk(torch.cat(best, dim=1), min(k, self.n_rows))
        return top, torch.cat(ids, dim=1).gather(1, pos)


def sharded_mips_topk(queries, database, k: int, mesh,
                      axis: str = "tensor"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot convenience wrapper; build a ShardedMIPSIndex for repeated
    searches over the same database."""
    return ShardedMIPSIndex(database, mesh, axis).search(queries, k)
