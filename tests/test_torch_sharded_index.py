"""Port parity: the sharded exact and IVF indexes and the store over a
mesh.

`ops/topk.py` ShardedMIPSIndex and `ops/ivf.py` ShardedIVFIndex against
the JAX package's on the forced eight-device CPU mesh (`eight_devices`),
the port's over a mesh of CPU devices (`["cpu"] * n`, one process, as
JAX's), at tensor 2 and 4. Stated tolerances: ids equal, scores within
atol 1e-5, scanned-row counts and table widths equal; the indexes also
equal the port's unsharded search (flat `mips_topk`, `IVFIndex`) on the
same rows and training state. The store takes `mesh=` as JAX's does
(the sharded index under flat and ivf, `tiered` refused with JAX's
text), and a search alone equals the same search inside a batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.config.schema import MeshConfig as JMeshConfig
from generativeaiexamples_tpu.ops import ivf as jivf
from generativeaiexamples_tpu.ops import topk as jtopk
from generativeaiexamples_tpu.parallel import mesh as jm
from generativeaiexamples_tpu.rag import vectorstore as jvs
from generativeaiexamples_tpu_torch.config.schema import MeshConfig
from generativeaiexamples_tpu_torch.ops import ivf as tivf
from generativeaiexamples_tpu_torch.ops import topk as ttopk
from generativeaiexamples_tpu_torch.parallel import mesh as tm
from generativeaiexamples_tpu_torch.rag.vectorstore import (
    DeviceVectorStore, create_vector_store)

DIM = 32
ATOL = 1e-5
SHARDS = pytest.mark.parametrize("n", [2, 4])


def _clustered(n, dim=DIM, n_clusters=48, sigma=0.15, seed=7):
    """tests/test_ann.py's clustered corpus (unit-norm rows)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    data = centers[rng.integers(0, n_clusters, n)] + \
        sigma * rng.standard_normal((n, dim)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    return data.astype(np.float32)


def _meshes(n, devices):
    return (tm.build_mesh(MeshConfig(ici_tensor=n), ["cpu"] * n),
            jm.build_mesh(JMeshConfig(ici_tensor=n), devices[:n]))


def _same(got, want):
    """(scores, ids) pairs: ids equal, scores within ATOL."""
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               atol=ATOL)


# -- ShardedMIPSIndex ------------------------------------------------------


@SHARDS
@pytest.mark.parametrize("n_rows,k", [(1001, 10), (7, 5)])
def test_sharded_mips_equals_jax_and_flat(eight_devices, n, n_rows, k):
    """Contiguous row blocks (N not divisible by the shards: padding rows
    score -inf), local top-k, gathered candidates, final top-k: the JAX
    index's ids and scores, and the flat search's."""
    rng = np.random.default_rng(n_rows + n)
    db = rng.standard_normal((n_rows, DIM)).astype(np.float32)
    q = rng.standard_normal((5, DIM)).astype(np.float32)
    mesh, jmesh = _meshes(n, eight_devices)
    index = ttopk.ShardedMIPSIndex(db, mesh)
    jindex = jtopk.ShardedMIPSIndex(jnp.asarray(db), jmesh)
    assert (index.n_shards, index.pad, index.shard_rows) == (
        jindex.n_shards, jindex.pad, jindex.shard_rows)
    assert [t.shape[0] for t in index.shards] == [index.shard_rows] * n
    got = index.search(torch.from_numpy(q), k)
    _same(got, jindex.search(jnp.asarray(q), k))
    _same(got, ttopk.mips_topk(torch.from_numpy(q), torch.from_numpy(db),
                               min(k, n_rows)))
    _same(ttopk.sharded_mips_topk(q, db, k, mesh),
          jtopk.sharded_mips_topk(jnp.asarray(q), jnp.asarray(db), k,
                                  jmesh))


@SHARDS
def test_sharded_mips_alone_equals_in_batch(n):
    """A search alone returns the same bits as the same query inside a
    coalesced batch (C.4's fixed 16-query tiles)."""
    rng = np.random.default_rng(3)
    db = torch.from_numpy(rng.standard_normal((517, DIM)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((21, DIM)).astype(np.float32))
    index = ttopk.ShardedMIPSIndex(db, tm.build_mesh(
        MeshConfig(ici_tensor=n), ["cpu"] * n))
    scores, ids = index.search(q, 8)
    for i in (0, 5, 20):
        s1, i1 = index.search(q[i:i + 1], 8)
        assert torch.equal(s1[0], scores[i]) and torch.equal(i1[0], ids[i])


# -- ShardedIVFIndex -------------------------------------------------------


@pytest.fixture(scope="module")
def trained():
    """A corpus, queries and JAX's training state on it."""
    vecs = _clustered(2048)
    c, _ = jivf.kmeans_fit(vecs, 32)
    a = np.asarray(jivf.balanced_assign(vecs, c))
    return vecs, _clustered(9, seed=16), np.asarray(c), a


def _ivf_pair(trained, devices, n, quant):
    vecs, _, c, a = trained
    mesh, jmesh = _meshes(n, devices)
    kw = dict(nprobe=8, quantize_int8=quant, centroids=c, assignments=a)
    return (tivf.ShardedIVFIndex(vecs, 32, mesh, **kw),
            jivf.ShardedIVFIndex(vecs, 32, jmesh, **kw))


def _search_equal(ours, theirs, q, k=4):
    s1, i1, n1 = ours.search(torch.from_numpy(q), k)
    s2, i2, n2 = theirs.search(jnp.asarray(q), k)
    _same((s1, i1), (s2, i2))
    assert n1 == n2


@SHARDS
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_sharded_ivf_equals_jax(eight_devices, trained, n, quant):
    """Round-robin rows, shared centroids and assignments, one table a
    shard (int8 codes and scales bit for bit): JAX's ids, scores and
    scanned rows; the same candidates as the unsharded index."""
    ours, theirs = _ivf_pair(trained, eight_devices, n, quant)
    vecs, q, c, a = trained
    assert ours.max_list_len == theirs.max_list_len
    assert ours.n_shards == n and ours.nlist == 32
    for s, (_, db3, scales3, g3) in enumerate(ours._shards):
        np.testing.assert_array_equal(g3.numpy(), np.asarray(theirs._g3)[s])
        if quant:
            np.testing.assert_array_equal(db3.numpy(),
                                          np.asarray(theirs._db3)[s])
            np.testing.assert_array_equal(scales3.numpy(),
                                          np.asarray(theirs._scales3)[s])
    _search_equal(ours, theirs, q)
    single = tivf.IVFIndex(vecs, 32, nprobe=8, quantize_int8=quant,
                           centroids=c, assignments=a, device="cpu")
    s1, i1, n1 = single.search(q, 4)
    s2, i2, n2 = ours.search(q, 4)
    assert n1 == n2
    for row in range(len(q)):
        assert set(i1[row].tolist()) == set(i2[row].tolist())
    np.testing.assert_allclose(np.sort(s1.numpy(), 1),
                               np.sort(s2.numpy(), 1), atol=ATOL)


@SHARDS
def test_sharded_ivf_add_state_and_skew_equal_jax(eight_devices, trained, n):
    """`add` assigns without retraining and re-lays out the whole corpus,
    refuses a skewed add without mutating, and `state()` is JAX's format
    both ways."""
    ours, theirs = _ivf_pair(trained, eight_devices, n, False)
    vecs, q, _, _ = trained
    extra = _clustered(96, seed=11)
    both = np.concatenate([vecs, extra])
    assert ours.add(extra, both) is True
    assert theirs.add(extra, both) is True
    assert ours.n_rows == theirs.n_rows == len(both)
    _search_equal(ours, theirs, np.concatenate([q, extra[:3]]))
    # Every new row near one centroid: past 4x the mean list size.
    hot = np.repeat(vecs[:1], 1500, axis=0)
    before = ours.state()
    assert ours.add(hot, np.concatenate([both, hot])) is False
    assert theirs.add(hot, np.concatenate([both, hot])) is False
    assert ours.n_rows == len(both)
    np.testing.assert_array_equal(ours.state()["assignments"],
                                  before["assignments"])
    st, jst = ours.state(), theirs.state()
    assert set(st) == set(jst) == {"centroids", "assignments"}
    np.testing.assert_allclose(st["centroids"], jst["centroids"], atol=ATOL)
    np.testing.assert_array_equal(st["assignments"], jst["assignments"])
    # Each package's state builds the other's index.
    mesh, jmesh = _meshes(n, eight_devices)
    _search_equal(tivf.ShardedIVFIndex(both, 32, mesh, nprobe=8,
                                       centroids=jst["centroids"],
                                       assignments=jst["assignments"]),
                  jivf.ShardedIVFIndex(both, 32, jmesh, nprobe=8,
                                       centroids=st["centroids"],
                                       assignments=st["assignments"]), q)


@SHARDS
def test_sharded_ivf_alone_equals_in_batch(trained, n):
    vecs, _, c, a = trained
    q = torch.from_numpy(_clustered(19, seed=21))
    index = tivf.ShardedIVFIndex(
        vecs, 32, tm.build_mesh(MeshConfig(ici_tensor=n), ["cpu"] * n),
        nprobe=8, centroids=c, assignments=a)
    scores, ids, _ = index.search(q, 6)
    for i in (0, 9, 18):
        s1, i1, _ = index.search(q[i:i + 1], 6)
        assert torch.equal(s1[0], scores[i]) and torch.equal(i1[0], ids[i])


# -- the store over a mesh ---------------------------------------------------


def _fill(store, vecs, prefix="c"):
    store.add([f"{prefix}-{i}" for i in range(len(vecs))], vecs)


def _texts(results):
    return [[r.text for r in rs] for rs in results]


def test_store_with_mesh_flat_is_sharded_and_equals_unsharded():
    """Flat search over a mesh: the ShardedMIPSIndex, with the rows on the
    host; the results of the unsharded store, alone and coalesced."""
    vecs = _clustered(301)
    q = _clustered(6, seed=9)
    mesh = tm.build_mesh(MeshConfig(ici_tensor=2), ["cpu", "cpu"])
    sharded = DeviceVectorStore(DIM, mesh=mesh)
    plain = DeviceVectorStore(DIM, device="cpu")
    for store in (sharded, plain):
        _fill(store, vecs)
    assert sharded.device.type == sharded.rows().device.type == "cpu"
    want = _texts(plain.search_batch(q, top_k=5))
    assert _texts(sharded.search_batch(q, top_k=5)) == want
    assert isinstance(sharded._flat, ttopk.ShardedMIPSIndex)
    assert _texts([sharded.search(qi, top_k=5) for qi in q]) == want


def test_store_with_mesh_uses_sharded_ivf():
    """tests/test_ann.py's case on the port's store: the sharded IVF index
    serves, and an incremental add flows through the sharded layout (an
    off-lock re-layout from the live training state)."""
    vecs = _clustered(1024)
    mesh = tm.build_mesh(MeshConfig(ici_tensor=4), ["cpu"] * 4)
    store = DeviceVectorStore(DIM, mesh=mesh, index_type="ivf")
    _fill(store, vecs)
    res = store.search(vecs[0], top_k=4)
    assert res and isinstance(store._ivf, tivf.ShardedIVFIndex)
    state = store._ivf.state()
    extra = _clustered(32, seed=17)
    store.add([f"s-{i}" for i in range(len(extra))], extra)
    res = store.search(extra[0], top_k=4)
    assert any(r.text.startswith("s-") for r in res)
    assert store._ivf.n_rows == len(vecs) + len(extra)
    np.testing.assert_array_equal(store._ivf.state()["centroids"],
                                  state["centroids"])  # no retrain
    assert store.stats()["index"] == "ivf"


def test_store_refuses_tiered_beside_a_mesh_with_jax_text(eight_devices):
    mesh = tm.build_mesh(MeshConfig(ici_tensor=2), ["cpu", "cpu"])
    texts = []
    for make in (lambda: DeviceVectorStore(DIM, mesh=mesh, index_type="ivf",
                                           tiered=True),
                 lambda: jvs.TPUVectorStore(
                     DIM, mesh=jm.build_mesh(JMeshConfig(ici_tensor=2),
                                             eight_devices[:2]),
                     index_type="ivf", tiered=True)):
        with pytest.raises(ValueError) as e:
            make()
        texts.append(str(e.value))
    assert texts[0] == texts[1]
    assert "unset the mesh or tiered" in texts[0]


def test_create_vector_store_takes_a_mesh():
    from generativeaiexamples_tpu_torch.config.schema import load_config

    mesh = tm.build_mesh(MeshConfig(ici_tensor=2), ["cpu", "cpu"])
    config = load_config(env={"APP_VECTORSTORE_NAME": "tpu",
                              "APP_VECTORSTORE_INDEXTYPE": "ivf"})
    store = create_vector_store(config, dim=DIM, mesh=mesh)
    assert store.mesh is mesh and store.index_type == "ivf"
    assert store.device.type == "cpu"
    conv = create_vector_store(config, dim=DIM, mesh=mesh, ephemeral=True)
    assert conv.mesh is mesh and conv.index_type == "flat"
    assert create_vector_store(config, dim=DIM, device="cpu").mesh is None
