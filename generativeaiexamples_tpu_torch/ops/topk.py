"""Maximum-inner-product search: a float32 matmul plus top-k.

Counterpart of `mips_topk` in generativeaiexamples_tpu/ops/topk.py, which
is plain `jnp` there (an einsum and `lax.top_k`, outside any Pallas
kernel), so the port leaves it to `torch.matmul` and `torch.topk`. Exact
(recall 1.0). The sharded index (`ShardedMIPSIndex`) waits for the
parallel layer (ROADMAP A.17).

Queries are scored in tiles of QUERY_TILE rows, every tile one matmul of
the same shape, so a query's scores do not depend on how many queries
share its call: the library picks its GEMM by shape, and two shapes round
differently, which reorders near-tied results. A search alone and the
same search inside a coalesced batch (serving/batcher.py) then return
the same ids in the same order.
"""

from __future__ import annotations

from typing import Tuple

import torch

QUERY_TILE = 16


def mips_topk(queries: torch.Tensor, database: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner products in float32. queries [Q, D], database
    [N, D] -> (scores [Q, k], indices [Q, k]), best first."""
    q = queries.float()
    n = q.shape[0]
    pad = -n % QUERY_TILE
    if pad:
        q = torch.cat([q, q.new_zeros((pad, q.shape[1]))])
    db_t = database.float().T
    scores = torch.cat([torch.matmul(tile, db_t)
                        for tile in q.split(QUERY_TILE)])[:n]
    return torch.topk(scores, k, dim=-1)
