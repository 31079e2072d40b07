"""Port parity: parallel/mesh.py against generativeaiexamples_tpu's.

The axis-size resolution (`_resolve_axis_sizes`, its error texts and
`_nearest_geometry` hint) over a grid of configs and device counts, the
logical-axis rules, and `build_mesh`'s shape and rank placement against
the JAX mesh on the 8 forced CPU devices (tests/conftest.py). The port's
mesh places one rank a device in the JAX mesh's device order, tensor
fastest. The backend rule and the process-group-free mesh plan are the
port's own.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.config.schema import MeshConfig as JMesh
from generativeaiexamples_tpu.parallel import mesh as jm
from generativeaiexamples_tpu_torch.config.schema import MeshConfig
from generativeaiexamples_tpu_torch.parallel import mesh as tm

FIELDS = ("ici_data", "ici_fsdp", "ici_tensor", "ici_sequence", "ici_expert",
          "dcn_data", "dcn_pipeline")

GRID = [dict(zip(("ici_data", "ici_tensor", "ici_fsdp", "dcn_data",
                  "dcn_pipeline"), c))
        for c in itertools.product((1, -1, 2), (1, -1, 2, 4, 3), (1, 2),
                                   (1, -1, 2), (1, 2))]


def _resolve(mod, cfg_cls, kw, n):
    try:
        return ("ok", mod._resolve_axis_sizes(cfg_cls(**kw), n))
    except ValueError as e:
        return ("err", str(e))


@pytest.mark.parametrize("n_devices", [1, 2, 4, 6, 8])
def test_resolve_axis_sizes_equal_jax_over_a_grid(n_devices):
    for kw in GRID:
        assert _resolve(tm, MeshConfig, kw, n_devices) == _resolve(
            jm, JMesh, kw, n_devices), (kw, n_devices)


@pytest.mark.parametrize("n_devices", [1, 3, 6, 8, 12])
def test_nearest_geometry_and_divisors_equal_jax(n_devices):
    for t, d, f in itertools.product((1, 2, 3, 4, -1), (1, 2, 5), (1, 3)):
        sizes = {"data": d, "fsdp": f, "tensor": t, "pipeline": 1}
        assert tm._nearest_geometry(sizes, n_devices) == \
            jm._nearest_geometry(sizes, n_devices)
    assert tm._divisors(n_devices) == jm._divisors(n_devices)
    assert tm._divisors(5040) == jm._divisors(5040)


def test_config_defaults_and_rules_equal_jax():
    assert {f: getattr(MeshConfig(), f) for f in FIELDS} == {
        f: getattr(JMesh(), f) for f in FIELDS}
    assert (MeshConfig().coordinator_address, MeshConfig().num_processes,
            MeshConfig().process_id) == ("", 0, -1)
    assert tm.MESH_AXIS_NAMES == jm.MESH_AXIS_NAMES
    assert tm.LLM_RULES == jm.LLM_RULES
    for axes in (("batch", "seq", "embed"), ("vocab", "embed_fsdp"),
                 ("layers", "heads", None, "kv_pages")):
        assert tm.logical_to_spec(axes) == tuple(jm.logical_to_spec(axes))
    with pytest.raises(KeyError, match="unknown logical axis"):
        tm.logical_to_spec(("nope",))


@pytest.mark.parametrize("kw", [
    {}, {"ici_tensor": 2, "ici_data": -1}, {"ici_tensor": 4, "ici_data": 2},
    {"ici_tensor": 2, "ici_fsdp": 2, "ici_data": -1},
    {"ici_tensor": -1, "dcn_pipeline": 2},
    {"ici_tensor": 2, "ici_sequence": 2, "dcn_data": -1}])
def test_build_mesh_shape_and_rank_placement_equal_jax(kw):
    """On the 8 forced CPU devices: the port's axis sizes are the JAX
    mesh's, and rank r sits at device r's place in the JAX device array
    (the port's ranks go in the JAX device order, tensor fastest)."""
    devices = jax.devices()
    assert len(devices) == 8
    jmesh = jm.build_mesh(JMesh(**kw))
    for rank in range(8):
        mesh = tm.build_mesh(MeshConfig(**kw), ["cpu"] * 8, rank=rank)
        assert mesh.shape == dict(jmesh.shape)
        assert mesh.size == jmesh.devices.size
        where = np.argwhere(jmesh.devices == devices[rank])
        assert where.shape == (1, 6)
        assert mesh.coords == dict(zip(jm.MESH_AXIS_NAMES,
                                       (int(i) for i in where[0])))
        assert mesh.tensor_rank == mesh.coords["tensor"]
        assert tm.mesh_axis_size(mesh, "tensor") == jm.mesh_axis_size(
            jmesh, "tensor")


def test_single_device_mesh_and_local_devices():
    mesh = tm.single_device_mesh("cpu")
    assert mesh.size == 1 and mesh.tensor == 1
    assert set(mesh.shape.values()) == {1}
    assert mesh.shape == dict(jm.single_device_mesh(jax.devices()[0]).shape)
    assert tm.local_devices() == [torch.device("cpu")]
    assert tm.mesh_axis_size(None, "tensor") == 1


def test_backend_rule_from_the_device_list():
    """gloo on the CPU and where ranks share a card (NCCL refuses two
    ranks on one device); NCCL when every rank has a card of its own."""
    assert tm.backend_for(["cpu", "cpu"]) == "gloo"
    assert tm.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert tm.backend_for(["cuda:0", "cpu"]) == "gloo"
    assert tm.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert tm.backend_for(["cuda:0"]) == "nccl"
    two = tm.build_mesh(MeshConfig(ici_tensor=2), ["cpu", "cpu"], rank=1)
    assert two.shared_device and two.group is None and two.backend == "gloo"
    assert (two.tensor, two.tensor_rank, two.device) == (
        2, 1, torch.device("cpu"))


def test_devices_colocated_matches_jax_semantics():
    assert tm.devices_colocated(["cpu"], ["cpu"])
    assert not tm.devices_colocated([], ["cpu"])
    assert not tm.devices_colocated(["cpu"], [])
    assert not tm.devices_colocated(["cuda:0"], ["cpu"])  # no card here
    local = set(jax.local_devices())
    assert jm.devices_colocated(local, local)
    assert not jm.devices_colocated(set(), local)


def test_collectives_are_identity_without_an_active_mesh():
    """With no tensor-parallel mesh active, the model's collectives
    return their input object: the single-device forward is unchanged."""
    assert tm.active_mesh() is None
    x = torch.arange(6.0).reshape(2, 3)
    assert tm.tensor_all_reduce(x) is x
    assert tm.tensor_all_gather(x) is x
    assert tm.tensor_shard() == (0, 1)
    tm.activate(tm.single_device_mesh("cpu"))  # tensor 1: stays inactive
    assert tm.active_mesh() is None


def test_distributed_init_is_a_noop_without_a_coordinator(monkeypatch):
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                 "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert tm.maybe_initialize_distributed(MeshConfig()) is False
    assert not tm.is_multihost() and tm.coordination_store() is None
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    with pytest.raises(ValueError, match="process count"):
        tm.maybe_initialize_distributed(MeshConfig())
    with pytest.raises(ValueError, match="2 devices listed for 3"):
        tm.maybe_initialize_distributed(
            MeshConfig(num_processes=3, process_id=0), ["cpu", "cpu"])


def test_mesh_section_read_from_env_and_file_as_jax(tmp_path):
    """APP_MESH_* and a file's [mesh] section give the JAX wizard's
    MeshConfig (the port once logged and dropped [mesh])."""
    import dataclasses

    from generativeaiexamples_tpu.config.wizard import load_config as jload
    from generativeaiexamples_tpu_torch.config.schema import load_config

    env = {"APP_MESH_ICITENSOR": "2", "APP_MESH_ICIDATA": "-1",
           "APP_MESH_COORDINATORADDRESS": "10.0.0.1:8476",
           "APP_MESH_NUMPROCESSES": "2", "APP_MESH_PROCESSID": "1"}
    path = tmp_path / "c.json"
    path.write_text('{"mesh": {"ici_tensor": 4, "dcn_pipeline": 1}}')
    for e in (env, {"APP_CONFIG_FILE": str(path)}):
        ours, theirs = load_config(env=e), jload(env=e)
        assert dataclasses.asdict(ours.mesh) == dataclasses.asdict(
            theirs.mesh)
    assert load_config(env=env).mesh.process_id == 1
