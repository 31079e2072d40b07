"""Ring attention: sequence-parallel exact attention over rank processes.

Counterpart of generativeaiexamples_tpu/ops/ring_attention.py. Each rank
holds one contiguous sequence shard of Q for the whole computation while
the K/V shards rotate around the mesh's "sequence" axis (`ppermute`,
parallel/mesh.py); the partial results merge by the online-softmax rule,
so no rank ever holds the full S x S scores and a rank's memory scales
with S / ring. Causal masking works on absolute positions (position i of
the shard on ring rank r is r * S_local + i), so a rotation needs no
re-indexing.

The body is plain torch in f32, as the JAX one is plain jnp: no
`pl.pallas_call` sits on this path. Gradients come from autograd through
`ppermute`, whose backward sends each gradient back the way its tensor
came; no ring backward is written by hand. The K and V shards travel
as one stacked tensor, one exchange a step.
"""

from __future__ import annotations

from typing import Optional

import torch

from generativeaiexamples_tpu_torch.parallel import mesh as mesh_lib
from generativeaiexamples_tpu_torch.parallel.mesh import Mesh

NEG_INF = -1e30


def _block_attn(q, k, v, q_pos, kv_pos, scale, causal):
    """A local Q block against one K/V block, with the running-softmax
    statistics for merging across blocks. q [B,H,Sq,D], k/v [B,KH,Sk,D];
    positions are absolute."""
    H, KH = q.shape[1], k.shape[1]
    if KH != H:  # GQA
        k = k.repeat_interleave(H // KH, dim=1)
        v = v.repeat_interleave(H // KH, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = kv_pos[None, None, None, :] <= q_pos[None, None, :, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    # A fully masked block contributes nothing; clamp so exp() is finite.
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    p = torch.exp(s - m_safe)
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o, m_safe, l


def _merge(o1, m1, l1, o2, m2, l2):
    """Online-softmax merge of two partial attention results."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return o1 * a1 + o2 * a2, m, l1 * a1 + l2 * a2


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: Optional[Mesh], axis_name: str = "sequence",
                   causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """This rank's body: q [B, H, S_local, D] and k/v [B, KH, S_local, D]
    are its contiguous shards in ring order. ring - 1 attend-and-rotate
    steps, then a last attend with no rotation."""
    B, H, S_local, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    ring = mesh_lib.mesh_axis_size(mesh, axis_name)
    rank = mesh.coords[axis_name] if ring > 1 else 0
    dev = q.device
    q_pos = rank * S_local + torch.arange(S_local, device=dev)
    o = torch.zeros((B, H, S_local, D), dtype=torch.float32, device=dev)
    m = torch.full((B, H, S_local, 1), NEG_INF / 2, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, H, S_local, 1), dtype=torch.float32, device=dev)

    def attend(r, o, m, l, kv):
        # Rotation r holds the shard that started on ring rank rank - r.
        src = (rank - r) % ring
        kv_pos = src * S_local + torch.arange(S_local, device=dev)
        return _merge(o, m, l, *_block_attn(q, kv[0], kv[1], q_pos, kv_pos,
                                            scale, causal))

    kv = torch.stack([k, v])
    for r in range(ring - 1):
        o, m, l = attend(r, o, m, l, kv)
        kv = mesh_lib.ppermute(kv, mesh, axis_name, 1)
    o, m, l = attend(ring - 1, o, m, l, kv)
    l = torch.where(l == 0.0, torch.ones_like(l), l)  # fully masked rows
    return (o / l).to(q.dtype)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mesh: Mesh, *, causal: bool = True,
                           scale: Optional[float] = None,
                           axis_name: str = "sequence") -> torch.Tensor:
    """The whole attention from the global q [B, H, S, D] and k/v
    [B, KH, S, D] that every rank of the axis holds: each keeps its
    sequence shard, runs the ring, and the outputs are gathered back
    whole. Its gradients with respect to the global tensors are whole on
    every rank (the shard's backward gathers the shards' gradients), as
    JAX's shard_map gives them."""
    n = mesh_lib.mesh_axis_size(mesh, axis_name)
    if q.shape[2] % n:
        raise ValueError(
            f"sequence length {q.shape[2]} must be divisible by the "
            f"{n}-way {axis_name} axis")
    ql, kl, vl = (mesh_lib.scatter_to_region(t, mesh, axis_name, 2)
                  for t in (q, k, v))
    out = ring_attention(ql, kl, vl, mesh=mesh, axis_name=axis_name,
                         causal=causal, scale=scale)
    return mesh_lib.gather_from_region(out, mesh, axis_name, 2)
