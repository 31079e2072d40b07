"""Port parity: serving/sharding.py against generativeaiexamples_tpu's.

One numpy parameter tree (JAX init, carried across with the converter),
plain and int8-quantized, sharded by the JAX package onto the 8 forced
CPU devices (tensor 2 or 4, the rest on data) and by the port for each
rank: every rank's slice of every leaf must be bit-identical to the JAX
shard of the device at that rank's place, the int8 payload and its
scales too (a row-parallel leaf keeps every scale). `validate_tp` and
`compatible_mesh` give JAX's texts and geometry. The sharded snapshot
load equals the slice of the whole load, and int8-at-load's codes and
scales the slice of the single-device int8 tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.config.schema import MeshConfig as JMesh
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.ops import quant as jq
from generativeaiexamples_tpu.parallel import mesh as jm
from generativeaiexamples_tpu.serving import sharding as jshd
from generativeaiexamples_tpu_torch.config.schema import MeshConfig
from generativeaiexamples_tpu_torch.models import convert, hf_loader
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.ops.quant import QuantizedTensor
from generativeaiexamples_tpu_torch.parallel import mesh as tm
from generativeaiexamples_tpu_torch.serving import sharding as tshd

# Every shardable dim divides 4: kv heads 4, heads 8, mlp 128, vocab 256.
SHAPE = dict(vocab_size=256, dim=64, n_layers=2, n_heads=8, n_kv_heads=4,
             head_dim=8, mlp_dim=128, max_seq_len=128)


@pytest.fixture(scope="module")
def trees():
    jcfg = jl.LlamaConfig(**SHAPE, dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(3))
    tcfg = tl.LlamaConfig(**SHAPE, dtype=torch.float32)
    out = {}
    for name, tree in (("plain", jparams),
                       ("int8", jq.quantize_llama_params(jparams))):
        out[name] = (tree, convert.llama_params_from_numpy(
            jax.tree.map(np.asarray, tree), "cpu", torch.float32))
    return jcfg, tcfg, out


def _leaves(tree, prefix=""):
    """(path, array) over a port tree (QuantizedTensor: .q and .s)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        elif isinstance(v, QuantizedTensor):
            yield prefix + k + ".q", v.q
            yield prefix + k + ".s", v.s
        else:
            yield prefix + k, v


def _jax_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _jax_leaves(v, prefix + k + ".")
        elif isinstance(v, jq.QuantizedTensor):
            yield prefix + k + ".q", v.q
            yield prefix + k + ".s", v.s
        else:
            yield prefix + k, v


def _shard_on(arr, device) -> np.ndarray:
    (sh,) = [s for s in arr.addressable_shards if s.device == device]
    return np.asarray(sh.data)


@pytest.mark.parametrize("kind", ["plain", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_rank_shards_equal_jax_addressable_shards(trees, kind, tp):
    jcfg, tcfg, out = trees
    jtree, ttree = out[kind]
    kw = {"ici_tensor": tp, "ici_data": -1}
    jmesh = jm.build_mesh(JMesh(**kw))
    jsharded = dict(_jax_leaves(jshd.shard_llama_params(jtree, jcfg, jmesh)))
    devices = jax.devices()
    for rank in range(8):
        mesh = tm.build_mesh(MeshConfig(**kw), ["cpu"] * 8, rank=rank)
        got = dict(_leaves(tshd.shard_llama_params(ttree, tcfg, mesh)))
        assert set(got) == set(jsharded)
        for path, t in got.items():
            want = _shard_on(jsharded[path], devices[rank])
            assert tuple(t.shape) == want.shape, (rank, path)
            assert np.array_equal(t.numpy(), want), (rank, path)
            assert t.is_contiguous()
        if kind == "int8":
            # Row-parallel leaves keep every scale; column-parallel ones
            # shard theirs with the outputs.
            layers = tshd.shard_llama_params(ttree, tcfg, mesh)["layers"]
            assert layers["wo"].s.shape == (2, SHAPE["dim"])
            assert layers["wq"].s.shape == (
                2, SHAPE["n_heads"] * SHAPE["head_dim"] // tp)


def test_local_config_and_pool_heads():
    tcfg = tl.LlamaConfig(**SHAPE, dtype=torch.float32)
    mesh = tm.build_mesh(MeshConfig(ici_tensor=4, ici_data=-1),
                         ["cpu"] * 8, rank=6)
    local = tshd.local_config(tcfg, mesh)
    assert (local.n_heads, local.n_kv_heads, local.mlp_dim,
            local.vocab_size) == (2, 1, 32, 256)
    assert tshd.local_config(tcfg, None) is tcfg
    assert tshd.pool_shard_heads(4, mesh) == slice(2, 3)
    assert tshd.tensor_axis_size(mesh) == 4 and tshd.is_sharded(mesh)
    assert not tshd.is_sharded(tm.single_device_mesh("cpu"))
    assert tshd.KV_POOL_SPEC == tuple(jshd.KV_POOL_SPEC)
    assert tshd.KV_FUSED_SPEC == tuple(jshd.KV_FUSED_SPEC)
    assert tshd.KV_FUSED_SCALE_SPEC == tuple(jshd.KV_FUSED_SCALE_SPEC)


def _err(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("kw", [{"ici_tensor": 4, "ici_data": 2},
                                {"ici_tensor": 8},
                                {"ici_tensor": -1, "dcn_pipeline": 2}])
def test_validate_tp_and_compatible_mesh_equal_jax(kw):
    """The tiny geometry (kv heads 2) cannot split 4 or 8 ways, and a
    pipeline axis is refused: the same texts; compatible_mesh clamps the
    tensor axis to the same geometry."""
    jcfg = jl.LlamaConfig.tiny()
    tcfg = tl.LlamaConfig.tiny()
    jmesh = jm.build_mesh(JMesh(**kw))
    mesh = tm.build_mesh(MeshConfig(**kw), ["cpu"] * 8)
    assert _err(lambda: tshd.validate_tp(tcfg, mesh)) == _err(
        lambda: jshd.validate_tp(jcfg, jmesh))
    if "dcn_pipeline" not in kw:
        got = tshd.compatible_mesh(tcfg, mesh)
        assert got.shape == dict(jshd.compatible_mesh(jcfg, jmesh).shape)
        tshd.validate_tp(tcfg, got)
    ok = tm.build_mesh(MeshConfig(ici_tensor=2, ici_data=-1), ["cpu"] * 8)
    assert tshd.compatible_mesh(tcfg, ok) is ok


@pytest.mark.parametrize("quantize", [False, True])
def test_sharded_load_equals_slices_of_the_whole_load(tmp_path, quantize):
    """Each rank reads only its rows (its columns of wo / w_down); int8
    at load quantizes those over their full input axis first, so each
    rank's codes and scales are the slice of the single-device int8
    tree."""
    from test_checkpoint_e2e import write_tiny_hf_checkpoint

    path = str(tmp_path / "llama")
    write_tiny_hf_checkpoint(path)
    whole, cfg = hf_loader.load_llama(path, device="cpu",
                                      dtype=torch.float32, quantize=quantize)
    for rank in range(2):
        mesh = tm.build_mesh(MeshConfig(ici_tensor=2), ["cpu"] * 2,
                             rank=rank)
        part, pcfg = hf_loader.load_llama(path, device="cpu",
                                          dtype=torch.float32,
                                          quantize=quantize, mesh=mesh)
        assert pcfg == cfg
        want = dict(_leaves(tshd.shard_llama_params(whole, cfg, mesh)))
        got = dict(_leaves(part))
        assert set(got) == set(want)
        for name, t in got.items():
            assert torch.equal(t, want[name]), (rank, name)
        if quantize:
            wo = part["layers"]["wo"]
            assert tuple(wo.q.shape) == (
                cfg.n_layers, cfg.n_heads * cfg.head_dim // 2, cfg.dim)
            assert tuple(wo.s.shape) == (cfg.n_layers, cfg.dim)


def test_rank_memory_plan_is_the_shard_plan():
    """A rank of a tensor-parallel mesh plans its own shard on its own
    device: the tensor > 1 plan (weights and pool pages per device, the
    pager's host tier per rank process); ranks sharing a device refuse
    the planner (AUTO_POOL_SHARED, A.17)."""
    from generativeaiexamples_tpu_torch.config.schema import EngineConfig
    from generativeaiexamples_tpu_torch.serving import memory_plan as tmp

    lcfg = tl.LlamaConfig.llama3_8b()
    ecfg = EngineConfig(auto_pool_pages=True, kv_pager=True,
                        prefix_cache=True, hbm_gb_per_device=80)
    mesh = tm.Mesh({**{a: 1 for a in tm.MESH_AXIS_NAMES}, "tensor": 2},
                   [torch.device("cuda", 0), torch.device("cuda", 1)],
                   rank=1)
    got = tmp.plan_rank_memory(lcfg, ecfg, mesh)
    want = tmp.plan_engine_memory(lcfg, ecfg, axis_sizes=dict(mesh.shape),
                                  n_processes=2, devices_per_host=1)
    assert got == want
    one = tmp.plan_engine_memory(lcfg, ecfg)
    assert got.page_bytes_per_device * 2 == one.page_bytes_per_device
    assert got.lines[0].bytes_per_device < one.lines[0].bytes_per_device
    assert tmp.plan_rank_memory(lcfg, ecfg, None) == one
    shared = tm.Mesh(dict(mesh.shape), [torch.device("cuda", 0)] * 2)
    with pytest.raises(ValueError, match=r"auto_pool_pages.*A\.17"):
        tmp.plan_rank_memory(lcfg, ecfg, shared)
