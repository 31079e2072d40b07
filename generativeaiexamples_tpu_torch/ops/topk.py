"""Maximum-inner-product search: a float32 matmul plus top-k.

Counterpart of `mips_topk` in generativeaiexamples_tpu/ops/topk.py, which
is plain `jnp` there (an einsum and `lax.top_k`, outside any Pallas
kernel), so the port leaves it to `torch.matmul` and `torch.topk`. Exact
(recall 1.0). The sharded index (`ShardedMIPSIndex`) waits for the
parallel layer (ROADMAP A.17).
"""

from __future__ import annotations

from typing import Tuple

import torch


def mips_topk(queries: torch.Tensor, database: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner products in float32. queries [Q, D], database
    [N, D] -> (scores [Q, k], indices [Q, k]), best first."""
    scores = torch.matmul(queries.float(), database.float().T)
    return torch.topk(scores, k, dim=-1)
