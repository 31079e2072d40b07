"""Port parity: the sharded train state (training/trainer.py) and LoRA's
adapter layout (training/lora.py) over eight rank processes.

Eight gloo rank processes on the CPU (tests/_torch_ranks.py, started once
for the module) form the port's data 2 x fsdp 2 x tensor 2 mesh, JAX's
`test_sharded_train_step_matches_single` geometry. Each keeps only its
shard of every leaf and of the AdamW moments, and takes two steps (lr
1e-3 with one warmup step, so the first step's lr is 0 and the second
moves the parameters; remat on; batch 8, seq 16) on the JAX package's
tiny f32 weights. The losses equal the JAX single-device step's within
atol 1e-4, every updated leaf gathered back within atol 2e-4 (JAX's
test checks one leaf; this checks them all), and so do the port's own
single-device step's; the grad norms equal the single-device norms
within 1e-4 relative. Under tensor 2 this holds the training route's
autograd-aware collectives (models/llama.py) to the single-device
gradient of the head and of every leaf upstream of it.

The same ranks also form sequence 2 x tensor 2 x data 2 and expert 2 x
tensor 2 x data 2 meshes (`job_on_mesh`), held at the same tolerances
against JAX's `shard_train_state` and train step on the same
`MeshConfig` over the 8 forced devices: under "sequence" each rank runs
its half of the sequence at its global positions with ring attention,
under "expert" the ranks along the axis take identical steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks_lib
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.training import lora as jlora
from generativeaiexamples_tpu.training import trainer as jtr
from generativeaiexamples_tpu_torch.config.schema import MeshConfig as TMesh
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.parallel import mesh as tm
from generativeaiexamples_tpu_torch.training import lora as tlora
from generativeaiexamples_tpu_torch.training import trainer as ttr

MESH_KW = dict(ici_tensor=2, ici_fsdp=2, ici_data=2)
SEQ_KW = dict(ici_sequence=2, ici_tensor=2, ici_data=2)
# Sequence without a tensor axis: the ring runs with no Megatron
# collectives active.
SEQ_DATA_KW = dict(ici_sequence=2, ici_tensor=1, ici_data=4)
EXPERT_KW = dict(ici_expert=2, ici_tensor=2, ici_data=2)
LR = 1e-3
STEPS = 2
LORA_KW = dict(rank=4, alpha=8.0, targets=("wq", "wv", "wo", "w_down"))


def _numpy(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def setup():
    cfg = jl.LlamaConfig.tiny()
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    batch = jtr.synthetic_batch(cfg, 8, 16)
    return cfg, params, _numpy(params), {k: np.array(v)
                                         for k, v in batch.items()}


@pytest.fixture(scope="module")
def pool():
    p = ranks_lib.RankPool(8, MESH_KW)
    yield p
    p.close()


def _jax_steps(cfg, params, batch):
    tcfg = jtr.TrainConfig(learning_rate=LR, warmup_steps=1, remat=True)
    opt = jtr.make_optimizer(tcfg)
    step = jax.jit(jtr.make_train_step(cfg, tcfg, opt))
    state = opt.init(params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    for _ in range(STEPS):
        params, state, m = step(params, state, jb)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return _numpy(params), metrics


def _jax_mesh_steps(cfg, params, batch, mesh_kw):
    """JAX's sharded step: `shard_train_state` and the jitted step on
    the mesh of `MeshConfig(**mesh_kw)` over the 8 forced devices."""
    from generativeaiexamples_tpu.config.schema import MeshConfig as JMesh
    from generativeaiexamples_tpu.parallel.mesh import build_mesh

    mesh = build_mesh(JMesh(**mesh_kw), devices=jax.devices()[:8])
    tcfg = jtr.TrainConfig(learning_rate=LR, warmup_steps=1, remat=True)
    opt = jtr.make_optimizer(tcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    with jax.set_mesh(mesh):
        params, state, _ = jtr.shard_train_state(params, cfg, opt, mesh)
        step = jax.jit(jtr.make_train_step(cfg, tcfg, opt))
        for _ in range(STEPS):
            params, state, m = step(params, state, jb)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return _numpy(params), metrics


def _port_single(np_params, batch):
    cfg = tl.LlamaConfig.tiny()
    params = convert.llama_params_from_numpy(np_params, "cpu",
                                             torch.float32)
    tcfg = ttr.TrainConfig(learning_rate=LR, warmup_steps=1, remat=True)
    opt = ttr.make_optimizer(tcfg)
    step = ttr.make_train_step(cfg, tcfg, opt)
    state = opt.init(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = []
    for _ in range(STEPS):
        params, state, m = step(params, state, tb)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return convert.llama_params_to_numpy(params), metrics


def _gathered(outs, key_tree):
    """{path: whole array} from every rank's shards, in the port's
    tree_leaves order of `key_tree` (a numpy tree of the whole leaves)."""
    paths = []

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                paths.append((prefix + (k,), v.shape))

    walk(key_tree, ())
    out = {}
    for i, (path, shape) in enumerate(paths):
        out[path] = ranks_lib.assemble([o["shards"][i] for o in outs], shape)
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def sharded_run(setup, pool):
    cfg, params, np_params, batch = setup
    outs = pool.run(ranks_lib.job_train, np_params, {}, batch, LR, STEPS)
    return outs, _gathered(outs, np_params)


def _assert_steps_equal(outs, got, want, want_m, np_params=None):
    """Every rank's losses (atol 1e-4) and grad norms (rtol 1e-4), and
    every gathered leaf (atol 2e-4), against `want`; with `np_params`,
    every leaf moved."""
    for rank, o in enumerate(outs):
        for (gl, gn), (wl, wn) in zip(o["metrics"], want_m):
            np.testing.assert_allclose(gl, wl, atol=1e-4,
                                       err_msg=f"rank {rank} loss")
            np.testing.assert_allclose(gn, wn, rtol=1e-4,
                                       err_msg=f"rank {rank} grad_norm")
    for path, arr in got.items():
        np.testing.assert_allclose(arr, _at(want, path), atol=2e-4,
                                   err_msg="/".join(path))
        if np_params is not None:
            assert not np.allclose(arr, _at(np_params, path)), path


def test_loss_and_params_equal_the_jax_single_device_step(setup,
                                                          sharded_run):
    cfg, params, np_params, batch = setup
    outs, got = sharded_run
    want, want_m = _jax_steps(cfg, params, batch)
    for rank, o in enumerate(outs):
        for (gl, gn), (wl, wn) in zip(o["metrics"], want_m):
            np.testing.assert_allclose(gl, wl, atol=1e-4,
                                       err_msg=f"rank {rank} loss")
            np.testing.assert_allclose(gn, wn, rtol=1e-4,
                                       err_msg=f"rank {rank} grad_norm")
    moved = 0
    for path, arr in got.items():
        np.testing.assert_allclose(arr, _at(want, path), atol=2e-4,
                                   err_msg="/".join(path))
        moved += not np.allclose(arr, _at(np_params, path))
    assert moved == len(got), "every leaf moves on the second step"


def test_sharded_step_equals_the_port_single_device_step(setup,
                                                         sharded_run):
    cfg, params, np_params, batch = setup
    outs, got = sharded_run
    want, want_m = _port_single(np_params, batch)
    for (gl, gn), (wl, wn) in zip(outs[0]["metrics"], want_m):
        np.testing.assert_allclose(gl, wl, atol=1e-4)
        np.testing.assert_allclose(gn, wn, rtol=1e-4)
    for path, arr in got.items():
        np.testing.assert_allclose(arr, _at(want, path), atol=2e-4,
                                   err_msg="/".join(path))


def test_each_rank_holds_only_its_shards(setup, sharded_run):
    """A rank's parameter bytes and its moments' bytes are its shard's:
    each leaf's bytes over the product of the axes its spec names."""
    cfg, params, np_params, batch = setup
    outs, _ = sharded_run
    specs = tl.param_specs(tl.LlamaConfig.tiny())
    sizes = {"data": 2, "fsdp": 2, "tensor": 2}
    want = 0
    for leaf, spec in zip(ttr.tree_leaves(
            convert.llama_params_from_numpy(np_params, "cpu",
                                            torch.float32)),
            ttr.aligned_specs(specs, convert.llama_params_from_numpy(
                np_params, "cpu", torch.float32))):
        n = int(np.prod([sizes[a] for a in ttr.spec_axes(spec)]))
        want += leaf.numel() * 4 // n
    for rank, o in enumerate(outs):
        assert o["bytes"] == (want, 2 * want), rank


def test_batch_and_moment_specs_match_jax():
    """batch_specs and the moments' specs are JAX's, translated (a
    PartitionSpec entry per dimension)."""
    from generativeaiexamples_tpu.parallel.mesh import LLM_RULES

    jspec = jtr.batch_specs(LLM_RULES)
    for key, spec in ttr.batch_specs().items():
        assert spec == tuple(jspec[key]), key
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, "cpu")
    opt = ttr.make_optimizer(ttr.TrainConfig())
    sh = ttr._opt_state_shardings(opt, params, tl.param_specs(cfg))
    assert sh["mu"] == sh["nu"] == ttr.aligned_specs(tl.param_specs(cfg),
                                                     params)
    assert sh["count"] == ()


def test_lora_param_specs_equal_jax():
    cfg = jl.LlamaConfig.tiny()
    lcfg = jlora.LoraConfig(targets=("wq", "wk", "wv", "wo", "w_gate",
                                     "w_up", "w_down"))
    jspecs = jlora.lora_param_specs(jlora.init_lora(
        cfg, lcfg, jax.random.PRNGKey(1)))
    tspecs = tlora.lora_param_specs(tlora.init_lora(
        tl.LlamaConfig.tiny(), tlora.LoraConfig(targets=lcfg.targets),
        device="cpu"))
    assert set(tspecs) == set(jspecs)
    for name in jspecs:
        for ab in ("a", "b"):
            assert tspecs[name][ab] == tuple(jspecs[name][ab]), (name, ab)


@pytest.fixture(scope="module")
def jax_lora(setup):
    """(initial adapters, JAX single-device adapters and metrics after
    STEPS LoRA steps)."""
    cfg, params, np_params, batch = setup
    lcfg = jlora.LoraConfig(**LORA_KW)
    lora = jlora.init_lora(cfg, lcfg, jax.random.PRNGKey(1))
    # b = 0 at init: start from a trained-looking b so every factor's
    # gradient is nonzero on the first step.
    lora = {n: {"a": ab["a"], "b": 0.05 * jax.random.normal(
        jax.random.PRNGKey(7 + i), ab["b"].shape)}
        for i, (n, ab) in enumerate(lora.items())}
    import optax

    opt = optax.adamw(LR, weight_decay=0.0)
    step = jax.jit(jlora.make_lora_train_step(cfg, lcfg, opt))
    state = opt.init(lora)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, want_m = lora, []
    for _ in range(STEPS):
        want, state, m = step(want, state, params, jb)
        want_m.append((float(m["loss"]), float(m["lora_grad_norm"])))
    return _numpy(lora), _numpy(want), want_m


def test_sharded_lora_step_equals_single_device(setup, pool, jax_lora):
    """The adapters on wq / wv (column-parallel), wo / w_down
    (row-parallel), trained sharded over the frozen sharded base: loss,
    grad norm and every adapter leaf after two steps equal the JAX
    single-device LoRA step's (losses 1e-4, leaves 2e-4, as above)."""
    cfg, params, np_params, batch = setup
    lora, want, want_m = jax_lora
    outs = pool.run(ranks_lib.job_lora, np_params, lora, {},
                    LORA_KW, batch, LR, STEPS)
    for rank, o in enumerate(outs):
        for (gl, gn), (wl, wn) in zip(o["metrics"], want_m):
            np.testing.assert_allclose(gl, wl, atol=1e-4)
            np.testing.assert_allclose(gn, wn, rtol=1e-4)
    got = _gathered(outs, lora)
    for path, arr in got.items():
        np.testing.assert_allclose(arr, _at(want, path), atol=2e-4,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("axis,kw", [
    ("pipeline", dict(dcn_pipeline=2, ici_tensor=2, ici_data=2)),
])
def test_unsharded_axes_are_refused_naming_the_axis(setup, axis, kw):
    """A pipeline axis is refused with a ValueError naming it and
    pointing to parallel/pipeline.py. The check runs on a mesh plan,
    before any collective."""
    cfg, params, np_params, batch = setup
    plan = tm.build_mesh(TMesh(**kw), ["cpu"] * 8)
    port = convert.llama_params_from_numpy(np_params, "cpu", torch.float32)
    opt = ttr.make_optimizer(ttr.TrainConfig())
    with pytest.raises(ValueError, match=f"'{axis}' mesh axis"):
        ttr.shard_train_state(port, tl.LlamaConfig.tiny(), opt, plan)
    with pytest.raises(ValueError, match=f"'{axis}' mesh axis"):
        ttr.make_train_step(tl.LlamaConfig.tiny(), ttr.TrainConfig(), opt,
                            mesh=plan)


# -- the sequence and expert axes ----------------------------------------


@pytest.fixture(scope="module")
def seq_run(setup, pool):
    cfg, params, np_params, batch = setup
    outs = pool.run(ranks_lib.job_on_mesh, SEQ_KW, ranks_lib.job_train,
                    np_params, {}, batch, LR, STEPS)
    return outs, _gathered(outs, np_params)


def test_sequence_step_equals_jax_on_the_same_mesh(setup, seq_run,
                                                   eight_devices):
    """Sequence 2: each rank runs 8 of the 16 positions through ring
    attention; the steps equal JAX's on MeshConfig(ici_sequence=2,
    ici_tensor=2, ici_data=2), every leaf moved."""
    cfg, params, np_params, batch = setup
    outs, got = seq_run
    want, want_m = _jax_mesh_steps(cfg, params, batch, SEQ_KW)
    _assert_steps_equal(outs, got, want, want_m, np_params)


@pytest.mark.parametrize("mesh_kw", [SEQ_KW, SEQ_DATA_KW],
                         ids=["tensor2", "tensor1"])
def test_sequence_step_equals_the_port_single_device_step(setup, pool,
                                                          seq_run, mesh_kw):
    """Sequence 2 with and without a tensor axis against the port's own
    one-device step."""
    cfg, params, np_params, batch = setup
    if mesh_kw is SEQ_KW:
        outs, got = seq_run
    else:
        outs = pool.run(ranks_lib.job_on_mesh, mesh_kw, ranks_lib.job_train,
                        np_params, {}, batch, LR, STEPS)
        got = _gathered(outs, np_params)
    want, want_m = _port_single(np_params, batch)
    _assert_steps_equal(outs, got, want, want_m)


def test_expert_step_equals_jax_on_the_same_mesh(setup, pool,
                                                 eight_devices):
    """Expert 2 shards nothing: the two ranks along it hold the same
    shards and take the same step, JAX's on the same MeshConfig."""
    cfg, params, np_params, batch = setup
    outs = pool.run(ranks_lib.job_on_mesh, EXPERT_KW, ranks_lib.job_train,
                    np_params, {}, batch, LR, STEPS)
    want, want_m = _jax_mesh_steps(cfg, params, batch, EXPERT_KW)
    _assert_steps_equal(outs, _gathered(outs, np_params), want, want_m,
                        np_params)
    # Ranks r and r + 2 differ only in their expert coordinate (the axis
    # of stride 2 here, inside data 2 and outside tensor 2): their
    # shards are the same bits.
    for r in (0, 1, 4, 5):
        for (sa, a), (sb, b) in zip(outs[r]["shards"],
                                    outs[r + 2]["shards"]):
            assert sa == sb
            np.testing.assert_array_equal(a, b)


def test_sharded_lora_step_on_the_sequence_axis(setup, pool, jax_lora):
    """LoRA over the same sequence 2 x tensor 2 x data 2 ranks: the
    adapters' losses, grad norms and leaves equal JAX's LoRA step."""
    cfg, params, np_params, batch = setup
    lora, want, want_m = jax_lora
    outs = pool.run(ranks_lib.job_on_mesh, SEQ_KW, ranks_lib.job_lora,
                    np_params, lora, {}, LORA_KW, batch, LR, STEPS)
    _assert_steps_equal(outs, _gathered(outs, lora), want, want_m)


def test_rank_positions_and_shard_bytes_on_sequence_2(setup, pool):
    """A rank's RoPE positions start at its sequence coordinate times
    the shard's length; its tokens are that slice of its rows; no leaf
    shards on "sequence", so its bytes are the tensor x data mesh's."""
    cfg, params, np_params, batch = setup
    outs = pool.run(ranks_lib.job_on_mesh, SEQ_KW, ranks_lib.job_positions,
                    np_params, {}, batch)
    specs = tl.param_specs(tl.LlamaConfig.tiny())
    port = convert.llama_params_from_numpy(np_params, "cpu", torch.float32)
    want = sum(leaf.numel() * 4 // (2 if "tensor" in ttr.spec_axes(spec)
                                    else 1)
               for leaf, spec in zip(ttr.tree_leaves(port),
                                     ttr.aligned_specs(specs, port)))
    for rank, o in enumerate(outs):
        c = o["coords"]
        np.testing.assert_array_equal(
            o["positions"], c["sequence"] * 8 + np.arange(8)[None, :])
        rows = slice(c["data"] * 4, (c["data"] + 1) * 4)
        cols = slice(c["sequence"] * 8, (c["sequence"] + 1) * 8)
        np.testing.assert_array_equal(o["tokens"],
                                      batch["tokens"][rows, cols])
        assert o["bytes"] == (want, 2 * want), rank


def test_indivisible_sequence_length_is_refused_by_name(setup):
    """A length the sequence axis does not divide is refused before any
    collective, naming the length and the axis (on a mesh plan)."""
    cfg, params, np_params, batch = setup
    plan = tm.build_mesh(TMesh(**SEQ_KW), ["cpu"] * 8)
    odd = {k: torch.from_numpy(v[:, :15].copy()) for k, v in batch.items()}
    with pytest.raises(ValueError,
                       match="sequence length 15 .* 2-way 'sequence' mesh"):
        ttr.shard_batch(odd, plan)
