"""Port parity: ops/ring_attention.py over four rank processes.

Four gloo rank processes on the CPU (tests/_torch_ranks.py, started once
for the module) form the port's mesh with a 4-way "sequence" axis and run
`ring_attention_sharded` on the same numpy q, k, v as the JAX package's
`ring_attention_sharded` over `MeshConfig(ici_sequence=4, ici_tensor=1,
ici_data=-1)` on the eight forced devices, and as `mha_reference`.
Tolerances, JAX's own (tests/test_ring_attention.py): outputs atol 2e-5,
the gradients of out.sum() with respect to q, k and v atol 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as ranks_lib
from generativeaiexamples_tpu.config.schema import MeshConfig
from generativeaiexamples_tpu.ops.attention import mha_reference
from generativeaiexamples_tpu.ops.ring_attention import (
    ring_attention_sharded)
from generativeaiexamples_tpu.parallel.mesh import build_mesh
from generativeaiexamples_tpu_torch.config.schema import MeshConfig as TMesh
from generativeaiexamples_tpu_torch.ops import ring_attention as tra
from generativeaiexamples_tpu_torch.parallel import mesh as tm

MESH_KW = dict(ici_sequence=4, ici_tensor=1, ici_data=-1)


@pytest.fixture(scope="module")
def seq_mesh(eight_devices):
    return build_mesh(MeshConfig(**MESH_KW), devices=jax.devices()[:8])


@pytest.fixture(scope="module")
def pool():
    p = ranks_lib.RankPool(4, MESH_KW)
    yield p
    p.close()


def _rand(shape, seed):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                      jnp.float32))


def _check_ranks(outs, want, key="out", atol=2e-5):
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out[key], want, atol=atol,
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("causal", [True, False])
def test_matches_jax_and_dense(seq_mesh, pool, causal):
    B, H, S, D = 2, 4, 64, 16
    q, k, v = (_rand((B, H, S, D), i) for i in range(3))
    want = np.asarray(mha_reference(*map(jnp.asarray, (q, k, v)),
                                    causal=causal))
    jax_ring = np.asarray(ring_attention_sharded(
        *map(jnp.asarray, (q, k, v)), seq_mesh, causal=causal))
    outs = pool.run(ranks_lib.job_ring, q, k, v, causal, False)
    _check_ranks(outs, want)
    _check_ranks(outs, jax_ring)


def test_gqa(seq_mesh, pool):
    B, H, KH, S, D = 2, 8, 2, 64, 16
    q = _rand((B, H, S, D), 0)
    k = _rand((B, KH, S, D), 1)
    v = _rand((B, KH, S, D), 2)
    want = np.asarray(mha_reference(*map(jnp.asarray, (q, k, v)),
                                    causal=True))
    jax_ring = np.asarray(ring_attention_sharded(
        *map(jnp.asarray, (q, k, v)), seq_mesh, causal=True))
    outs = pool.run(ranks_lib.job_ring, q, k, v, True, False)
    _check_ranks(outs, want)
    _check_ranks(outs, jax_ring)


def test_gradients_match_jax(seq_mesh, pool):
    """The gradients of out.sum() come from autograd through ppermute's
    backward; each rank holds them whole, as JAX's shard_map gives them."""
    B, H, S, D = 1, 2, 32, 8
    q, k, v = (_rand((B, H, S, D), i + 10) for i in range(3))
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    g_ring = jax.jit(jax.grad(
        lambda q, k, v: ring_attention_sharded(q, k, v, seq_mesh).sum(),
        argnums=(0, 1, 2)))(qj, kj, vj)
    g_dense = jax.grad(lambda q, k, v: mha_reference(
        q, k, v, causal=True).sum(), argnums=(0, 1, 2))(qj, kj, vj)
    outs = pool.run(ranks_lib.job_ring, q, k, v, True, True)
    for rank, out in enumerate(outs):
        for name, got, wj, wd in zip("qkv", out["grads"], g_ring, g_dense):
            np.testing.assert_allclose(got, np.asarray(wj), atol=5e-4,
                                       err_msg=f"rank {rank} d{name}")
            np.testing.assert_allclose(got, np.asarray(wd), atol=5e-4,
                                       err_msg=f"rank {rank} d{name}")


def test_indivisible_length_refused_with_jax_text(seq_mesh):
    """S = 30 on a 4-way axis: both packages refuse with one text, before
    any collective (the port's check runs on a mesh plan)."""
    q = _rand((1, 2, 30, 8), 0)
    with pytest.raises(ValueError, match="must be divisible") as want:
        ring_attention_sharded(*(jnp.asarray(q),) * 3, seq_mesh)
    import torch

    plan = tm.build_mesh(TMesh(**MESH_KW), ["cpu"] * 8)
    t = torch.from_numpy(q)
    with pytest.raises(ValueError) as got:
        tra.ring_attention_sharded(t, t, t, plan)
    assert str(got.value) == str(want.value)


def test_one_rank_ring_is_dense_attention():
    """Without a sequence axis the ring is one block: the dense answer,
    on a mesh plan with no process group."""
    import torch

    from generativeaiexamples_tpu_torch.ops.attention import (
        mha_reference as tmha)

    q, k, v = (torch.from_numpy(_rand((1, 4, 16, 8), i)) for i in range(3))
    got = tra.ring_attention(q, k, v, mesh=None)
    torch.testing.assert_close(got, tmha(q, k, v, causal=True), atol=2e-5,
                               rtol=0)
