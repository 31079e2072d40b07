"""Port parity: parallel/pipeline.py (GPipe) over eight rank processes.

Eight gloo rank processes on the CPU (tests/_torch_ranks.py, started once
for the module) form the port's pipeline 2 x data 2 x tensor 2 mesh, the
geometry of JAX's `pp_mesh` (`MeshConfig(dcn_pipeline=2, ici_data=2,
ici_tensor=-1)`), and run `pipeline_loss` on the JAX package's tiny f32
weights (batch 8, seq 16, n_micro 4) against JAX's `pipeline_loss` on
its mesh: the loss within rtol 2e-5 and every gradient leaf, gathered
back from the ranks' shards after the step's sums, within atol 5e-4,
rtol 5e-3 (JAX's own tolerances, tests/test_pipeline.py). Two
`make_pp_train_step` steps move the parameters as JAX's do. A
single-stage mesh falls through to `loss_fn`, the bad microbatch and
stage splits are refused with JAX's texts, and the serving engine still
refuses a pipeline mesh. The same ranks also form pipeline 2 x sequence
2 x tensor 2, held against JAX's `pipeline_loss` on that mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks_lib
from generativeaiexamples_tpu.config.schema import MeshConfig
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.parallel import pipeline as jpp
from generativeaiexamples_tpu.parallel.mesh import build_mesh
from generativeaiexamples_tpu.training import trainer as jtr
from generativeaiexamples_tpu_torch.config.schema import MeshConfig as TMesh
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.parallel import mesh as tm
from generativeaiexamples_tpu_torch.parallel import pipeline as tpp
from generativeaiexamples_tpu_torch.training import trainer as ttr

MESH_KW = dict(dcn_pipeline=2, ici_data=2, ici_tensor=-1)
TINY = jl.LlamaConfig.tiny()


def _numpy(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _np_batch(batch):
    return {k: np.array(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def pp_mesh(eight_devices):
    return build_mesh(MeshConfig(**MESH_KW), devices=jax.devices()[:8])


@pytest.fixture(scope="module")
def pool():
    p = ranks_lib.RankPool(8, MESH_KW)
    yield p
    p.close()


@pytest.fixture(scope="module")
def params():
    return jl.init_params(TINY, jax.random.PRNGKey(0))


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _gathered(outs, np_tree):
    return {path: ranks_lib.assemble([o["shards"][i] for o in outs],
                                     leaf.shape)
            for i, (path, leaf) in enumerate(_paths(np_tree))}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def test_loss_and_grads_equal_jax_pipeline_loss(pp_mesh, pool, params):
    batch = jtr.synthetic_batch(TINY, batch=8, seq=16)
    sparams, _, _ = jpp.shard_pp_train_state(
        params, TINY, jtr.make_optimizer(jtr.TrainConfig()), pp_mesh)
    with jax.set_mesh(pp_mesh):
        want_loss, want_grads = jax.jit(jax.value_and_grad(
            lambda p, t, y, m: jpp.pipeline_loss(
                p, TINY, t, y, m, mesh=pp_mesh, n_micro=4)))(
            sparams, batch["tokens"], batch["targets"], batch["mask"])
    np_params = _numpy(params)
    outs = pool.run(ranks_lib.job_pp_grads, np_params, {},
                    _np_batch(batch), 4)
    for rank, o in enumerate(outs):
        np.testing.assert_allclose(o["loss"], float(want_loss), rtol=2e-5,
                                   err_msg=f"rank {rank}")
    got = _gathered(outs, np_params)
    want = _numpy(want_grads)
    for path, arr in got.items():
        np.testing.assert_allclose(arr, _at(want, path), atol=5e-4,
                                   rtol=5e-3, err_msg="/".join(path))
        # Every leaf takes a gradient: the stages' shares reached it.
        assert np.abs(arr).max() > 0, path


def test_pp_train_step_moves_params_as_jax(pp_mesh, pool, params):
    """Two steps (the warmup schedule's lr is 0 at step 0), remat off,
    n_micro 2, batch 4, seq 8, as JAX's TestPipelineTrainStep: the
    losses and grad norms within 1e-4, every parameter within 2e-4."""
    tcfg = jtr.TrainConfig(learning_rate=1e-3, warmup_steps=1, remat=False)
    opt = jtr.make_optimizer(tcfg)
    sparams, sopt, _ = jpp.shard_pp_train_state(params, TINY, opt, pp_mesh)
    step = jax.jit(jpp.make_pp_train_step(TINY, tcfg, opt, mesh=pp_mesh,
                                          n_micro=2))
    batch = jtr.synthetic_batch(TINY, batch=4, seq=8)
    want_m = []
    with jax.set_mesh(pp_mesh):
        for _ in range(2):
            sparams, sopt, m = step(sparams, sopt, batch)
            want_m.append((float(m["loss"]), float(m["grad_norm"])))
    np_params = _numpy(params)
    outs = pool.run(ranks_lib.job_pp_steps, np_params, {},
                    _np_batch(batch), 2, 1e-3, 2)
    for rank, o in enumerate(outs):
        for (gl, gn), (wl, wn) in zip(o["metrics"], want_m):
            np.testing.assert_allclose(gl, wl, atol=1e-4)
            np.testing.assert_allclose(gn, wn, rtol=1e-4)
    got = _gathered(outs, np_params)
    want = _numpy(sparams)
    for path, arr in got.items():
        np.testing.assert_allclose(arr, _at(want, path), atol=2e-4,
                                   err_msg="/".join(path))
        assert not np.allclose(arr, _at(np_params, path)), path


def test_single_stage_mesh_falls_through(eight_devices, params):
    """One stage: `trainer.loss_fn` on the whole tree, as JAX's does (a
    mesh plan, no process group)."""
    batch = jtr.synthetic_batch(TINY, batch=4, seq=8)
    want = jpp.pipeline_loss(params, TINY, batch["tokens"],
                             batch["targets"], batch["mask"],
                             mesh=build_mesh(MeshConfig(ici_tensor=-1),
                                             devices=jax.devices()[:4]),
                             n_micro=2)
    plan = tm.build_mesh(TMesh(ici_tensor=-1), ["cpu"] * 4)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    got = tpp.pipeline_loss(
        convert.llama_params_from_numpy(_numpy(params), "cpu",
                                        torch.float32),
        tl.LlamaConfig.tiny(), tb["tokens"], tb["targets"], tb["mask"],
        mesh=plan, n_micro=2)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_bad_microbatch_split_refused_with_jax_text(pp_mesh, params):
    batch = jtr.synthetic_batch(TINY, batch=6, seq=8)
    with pytest.raises(ValueError, match="not divisible by n_micro") as want:
        jpp.pipeline_loss(params, TINY, batch["tokens"], batch["targets"],
                          batch["mask"], mesh=pp_mesh, n_micro=4)
    plan = tm.build_mesh(TMesh(**MESH_KW), ["cpu"] * 8)
    t = torch.zeros((6, 8), dtype=torch.int64)
    with pytest.raises(ValueError) as got:
        tpp.pipeline_loss({}, tl.LlamaConfig.tiny(), t, t, t.float(),
                          mesh=plan, n_micro=4)
    assert str(got.value) == str(want.value)


def test_bad_stage_split_refused_with_jax_text(eight_devices):
    mesh = build_mesh(MeshConfig(dcn_pipeline=4, ici_data=2, ici_tensor=1),
                      devices=jax.devices()[:8])
    cfg3 = jl.LlamaConfig(vocab_size=64, dim=32, n_layers=3, n_heads=2,
                          n_kv_heads=2, head_dim=16, mlp_dim=64,
                          max_seq_len=64, dtype=jnp.float32)
    params = jl.init_params(cfg3, jax.random.PRNGKey(0))
    batch = jtr.synthetic_batch(cfg3, batch=4, seq=8)
    with pytest.raises(ValueError, match="not divisible by\n?.*stages") \
            as want:
        jpp.pipeline_loss(params, cfg3, batch["tokens"], batch["targets"],
                          batch["mask"], mesh=mesh, n_micro=2)
    tcfg3 = tl.LlamaConfig(vocab_size=64, dim=32, n_layers=3, n_heads=2,
                           n_kv_heads=2, head_dim=16, mlp_dim=64,
                           max_seq_len=64, dtype=torch.float32)
    plan = tm.build_mesh(TMesh(dcn_pipeline=4, ici_data=2, ici_tensor=1),
                         ["cpu"] * 8)
    t = torch.zeros((4, 8), dtype=torch.int64)
    with pytest.raises(ValueError) as got:
        tpp.pipeline_loss({}, tcfg3, t, t, t.float(), mesh=plan, n_micro=2)
    assert str(got.value) == str(want.value)
    port = tl.init_params(tcfg3, "cpu")
    with pytest.raises(ValueError) as got:
        tpp.shard_pp_train_state(port, tcfg3,
                                 ttr.make_optimizer(ttr.TrainConfig()), plan)
    assert str(got.value) == str(want.value)


def test_pp_param_specs_equal_jax():
    from generativeaiexamples_tpu.parallel.mesh import LLM_RULES

    want = jpp.pp_param_specs(TINY, LLM_RULES)
    got = tpp.pp_param_specs(tl.LlamaConfig.tiny())
    for path, spec in _paths(got):
        assert spec == tuple(_at_spec(want, path)), path


def _at_spec(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_serving_engine_refuses_a_pipeline_mesh_as_jax():
    """The serving mesh's refusal of a pipeline axis (serving/sharding.py)
    stays pinned: JAX's text on a pipeline 2 x data 2 x tensor 2 plan."""
    from generativeaiexamples_tpu_torch.serving import sharding as tsh

    plan = tm.build_mesh(TMesh(**MESH_KW), ["cpu"] * 8)
    with pytest.raises(ValueError, match="pipeline") as got:
        tsh.validate_tp(tl.LlamaConfig.tiny(), plan)
    from generativeaiexamples_tpu.serving import sharding as jsh

    jmesh = build_mesh(MeshConfig(**MESH_KW), devices=jax.devices()[:8])
    with pytest.raises(ValueError) as want:
        jsh.validate_tp(TINY, jmesh)
    assert str(got.value) == str(want.value)


PP_SEQ_KW = dict(dcn_pipeline=2, ici_sequence=2, ici_tensor=2)


def test_pipeline_with_a_sequence_axis_equals_jax(eight_devices, pool,
                                                  params):
    """Pipeline 2 x sequence 2 x tensor 2 on the same ranks: each stage
    runs its half of the sequence through ring attention. The loss and
    every gradient leaf equal JAX's `pipeline_loss` on the same mesh at
    the tolerances above."""
    mesh = build_mesh(MeshConfig(**PP_SEQ_KW), devices=jax.devices()[:8])
    batch = jtr.synthetic_batch(TINY, batch=8, seq=16)
    sparams, _, _ = jpp.shard_pp_train_state(
        params, TINY, jtr.make_optimizer(jtr.TrainConfig()), mesh)
    with jax.set_mesh(mesh):
        want_loss, want_grads = jax.jit(jax.value_and_grad(
            lambda p, t, y, m: jpp.pipeline_loss(
                p, TINY, t, y, m, mesh=mesh, n_micro=4)))(
            sparams, batch["tokens"], batch["targets"], batch["mask"])
    np_params = _numpy(params)
    outs = pool.run(ranks_lib.job_on_mesh, PP_SEQ_KW, ranks_lib.job_pp_grads,
                    np_params, {}, _np_batch(batch), 4)
    for rank, o in enumerate(outs):
        np.testing.assert_allclose(o["loss"], float(want_loss), rtol=2e-5,
                                   err_msg=f"rank {rank}")
    got = _gathered(outs, np_params)
    want = _numpy(want_grads)
    for path, arr in got.items():
        np.testing.assert_allclose(arr, _at(want, path), atol=5e-4,
                                   rtol=5e-3, err_msg="/".join(path))
        assert np.abs(arr).max() > 0, path
