"""Port parity: the memory planner (serving/memory_plan.py).

Every plan the port makes equals the JAX package's on the same model and
engine config: each PlanLine, the page bytes, `fit_pages`, `pool_pages`,
`default_pages`, the headroom, the pager's host tier, the breakdown text
and the MemoryPlanError text, for the 8B, 70B and tiny configs with bf16
or int8 weights and bf16 or int8 KV at tensor 1, 2, 4 and 8 and a given
per-device budget; `smallest_fitting_mesh` likewise. One note differs on
purpose: a model-dtype weights line names its dtype ("bfloat16") where
the JAX planner prints the JAX type's repr ("<class
'jax.numpy.bfloat16'>"); the comparison maps the one onto the other.
The exact lines equal real allocations: the weights line the port's tiny
parameter tree's bytes (f32, bf16 and int8), the page line a pool's
bytes over its pages; an engine with `auto_pool_pages` allocates
`plan.pool_pages` pages and shows the headroom in /metrics, and without
the knob the sizing is unchanged. `PagePool.for_budget` gives JAX's page
count. Nothing here builds a JAX engine.
"""

import dataclasses
import re

import pytest
import torch

from generativeaiexamples_tpu.config.schema import EngineConfig as JConfig
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.serving import memory_plan as jmp
from generativeaiexamples_tpu.serving.kv_cache import PagePool as JPool
from generativeaiexamples_tpu_torch.config.schema import EngineConfig
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.ops.quant import (
    QuantizedTensor, quantize_llama_params)
from generativeaiexamples_tpu_torch.serving import memory_plan as tmp
from generativeaiexamples_tpu_torch.serving.engine import LLMEngine
from generativeaiexamples_tpu_torch.serving.kv_cache import PagePool
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

MODELS = {"8b": (jl.LlamaConfig.llama3_8b, tl.LlamaConfig.llama3_8b),
          "70b": (jl.LlamaConfig.llama3_70b, tl.LlamaConfig.llama3_70b),
          "tiny": (jl.LlamaConfig.tiny, tl.LlamaConfig.tiny)}
# Engine configs: the default, the int8 deployment (docs/deployment.md)
# with the prefix cache and pager, and a small one.
ENGINES = {
    "default": {},
    "int8_deploy": {"max_batch_size": 128, "page_size": 128,
                    "max_seq_len": 8192, "prefix_cache": True,
                    "kv_pager": True, "kv_host_budget_mb": 1024},
    "small": {"max_batch_size": 4, "max_seq_len": 512, "page_size": 16,
              "prefill_buckets": (64, 256), "max_prefill_group": 0,
              "planner_headroom_fraction": 0.25},
}
BUDGETS = {"8b": 80 << 30, "70b": 96 << 30, "tiny": 1 << 20}


def _jax_note(note: str) -> str:
    return re.sub(r"<class 'jax\.numpy\.(\w+)'>", r"\1", note)


def _plans(model, engine, weights, kv, tensor, hbm, **kw):
    jcfg, tcfg = (f() for f in MODELS[model])
    fields = {**ENGINES[engine], "quantize_weights": weights,
              "kv_dtype": kv, "auto_pool_pages": True, **kw}
    jecfg, tecfg = JConfig(**fields), EngineConfig(**fields)
    sizes = {"tensor": tensor}
    outs = []
    for mod, lcfg, ecfg in ((jmp, jcfg, jecfg), (tmp, tcfg, tecfg)):
        try:
            outs.append(mod.plan_engine_memory(
                lcfg, ecfg, axis_sizes=sizes, hbm_bytes_per_device=hbm,
                n_processes=2 if tensor >= 4 else 1))
        except mod.MemoryPlanError as err:
            outs.append(err)
    return outs


def _assert_plans_equal(jplan, tplan):
    assert [(line.name, line.bytes_per_device, line.exact,
             _jax_note(line.note)) for line in jplan.lines] == [
        (line.name, line.bytes_per_device, line.exact, line.note)
        for line in tplan.lines]
    for name in ("hbm_bytes_per_device", "headroom_bytes",
                 "page_bytes_per_device", "fit_pages", "pool_pages",
                 "default_pages", "axis_sizes", "devices_per_host",
                 "n_processes", "pager_host_budget_mb",
                 "pager_rec_bytes_per_host", "pager_host_slots",
                 "total_bytes_per_device", "free_bytes_per_device"):
        assert getattr(jplan, name) == getattr(tplan, name), name
    assert _jax_note(jplan.breakdown()) == tplan.breakdown()


@pytest.mark.parametrize("tensor", [1, 2, 4, 8])
@pytest.mark.parametrize("weights,kv", [("none", "bfloat16"),
                                        ("int8", "int8"),
                                        ("int8", "bfloat16"),
                                        ("none", "int8")])
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_plan_equals_jax(engine, model, weights, kv, tensor):
    jout, tout = _plans(model, engine, weights, kv, tensor, BUDGETS[model])
    assert type(jout).__name__ == type(tout).__name__
    if isinstance(jout, Exception):
        # Fail fast: the same text (the breakdown and the hint), and the
        # plan it carries.
        assert _jax_note(str(jout)) == str(tout)
        jout, tout = jout.plan, tout.plan
    _assert_plans_equal(jout, tout)
    # The non-strict plan is the same plan.
    jcfg, tcfg = (f() for f in MODELS[model])
    fields = {**ENGINES[engine], "quantize_weights": weights,
              "kv_dtype": kv}
    assert tmp.plan_engine_memory(
        tcfg, EngineConfig(**fields), axis_sizes={"tensor": tensor},
        hbm_bytes_per_device=BUDGETS[model], strict=False,
        n_processes=2 if tensor >= 4 else 1).lines == tout.lines


@pytest.mark.parametrize("hbm_gib", [8, 16, 24, 40, 80])
@pytest.mark.parametrize("model", ["8b", "70b"])
@pytest.mark.parametrize("weights", ["none", "int8"])
def test_smallest_fitting_mesh_equals_jax(model, weights, hbm_gib):
    jcfg, tcfg = (f() for f in MODELS[model])
    fields = {"quantize_weights": weights, "kv_dtype": "int8"
              if weights == "int8" else "bfloat16"}
    want = jmp.smallest_fitting_mesh(jcfg, JConfig(**fields), hbm_gib << 30)
    got = tmp.smallest_fitting_mesh(tcfg, EngineConfig(**fields),
                                    hbm_gib << 30)
    assert got == want


def test_fail_fast_carries_breakdown_and_hint():
    """A 70B int8 plan on one 16 GiB device raises with the breakdown and
    the smallest mesh that fits, and that mesh plans cleanly (JAX's case,
    on the port)."""
    lcfg = tl.LlamaConfig.llama3_70b()
    ecfg = EngineConfig(quantize_weights="int8", kv_dtype="int8",
                        auto_pool_pages=True)
    with pytest.raises(tmp.MemoryPlanError) as ei:
        tmp.plan_engine_memory(lcfg, ecfg, axis_sizes={"tensor": 1},
                               hbm_bytes_per_device=16 << 30)
    msg = str(ei.value)
    for needle in ("memory plan does not fit", "weights", "kv_pool",
                   "headroom", "smallest mesh that fits: ici_tensor="):
        assert needle in msg
    hinted = tmp.smallest_fitting_mesh(lcfg, ecfg, 16 << 30)
    assert hinted is not None
    tmp.plan_engine_memory(lcfg, ecfg, axis_sizes=hinted,
                           hbm_bytes_per_device=16 << 30)


def _tree_bytes(tree) -> int:
    total = 0
    for v in tree.values():
        if isinstance(v, dict):
            total += _tree_bytes(v)
        elif isinstance(v, QuantizedTensor):
            total += v.q.nbytes + v.s.nbytes
        else:
            total += v.nbytes
    return total


@pytest.mark.parametrize("dtype,quantize", [(torch.float32, False),
                                            (torch.bfloat16, False),
                                            (torch.float32, True),
                                            (torch.bfloat16, True)])
@pytest.mark.parametrize("tie", [False, True])
def test_weight_line_equals_the_tree_bytes(dtype, quantize, tie):
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=259),
                              dtype=dtype, tie_embeddings=tie)
    params = tl.init_params(cfg, "cpu")
    shapes = tl.param_shapes(cfg)
    assert {k: tuple(v.shape) for k, v in params["layers"].items()} == \
        shapes["layers"]
    assert {k: tuple(v.shape) for k, v in params.items()
            if k != "layers"} == {k: v for k, v in shapes.items()
                                  if k != "layers"}
    if quantize:
        params = quantize_llama_params(params, "cpu")
    assert tmp.weight_bytes_per_device(cfg, {}, quantize=quantize) == \
        _tree_bytes(params)


def test_param_specs_equal_jax_after_its_rules():
    from generativeaiexamples_tpu.parallel.mesh import LLM_RULES

    for tie in (False, True):
        jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), tie_embeddings=tie)
        tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), tie_embeddings=tie)
        jspecs, tspecs = jl.param_specs(jcfg, LLM_RULES), tl.param_specs(tcfg)
        flat = lambda d: {k: v for k, v in d.items() if k != "layers"}
        assert {k: tuple(v) for k, v in flat(jspecs).items()} == \
            flat(tspecs)
        assert {k: tuple(v) for k, v in jspecs["layers"].items()} == \
            tspecs["layers"]


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_page_line_equals_pool_bytes_over_pages(kv):
    cfg = tl.LlamaConfig.tiny()
    ecfg = EngineConfig(page_size=8, kv_dtype=kv)
    n_pages = 7
    pool = PagePool.zeros(cfg, n_pages, 8, dtype=getattr(torch, kv),
                          device="cpu")
    nbytes = (pool.kv.nbytes + pool.s.nbytes if kv == "int8"
              else pool.k.nbytes + pool.v.nbytes)
    assert tmp.pool_page_bytes_per_device(cfg, ecfg, {}) * n_pages == nbytes


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("budget", [1 << 16, 1 << 20, 12345678])
def test_for_budget_page_count_equals_jax(kv, budget):
    import jax.numpy as jnp

    jpool = JPool.for_budget(jl.LlamaConfig.tiny(), budget, page_size=8,
                             dtype=getattr(jnp, kv))
    tpool = PagePool.for_budget(tl.LlamaConfig.tiny(), budget, page_size=8,
                                dtype=getattr(torch, kv), device="cpu")
    assert tpool.n_pages == jpool.n_pages
    assert tpool.quantized == (kv == "int8")


ECFG = dict(max_batch_size=2, max_seq_len=64, page_size=8,
            prefill_buckets=(16, 32), kv_dtype="float32")


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_engine_pool_sized_from_plan(prefix_cache):
    cfg = tl.LlamaConfig.tiny(vocab_size=259)
    params = tl.init_params(cfg, "cpu")
    eng = LLMEngine(params, cfg, ByteTokenizer(),
                    {**ECFG, "auto_pool_pages": True,
                     "prefix_cache": prefix_cache,
                     "hbm_gb_per_device": 0.001}, device="cpu")
    plan = eng.memory_plan
    assert plan is not None and eng.pool.n_pages == plan.pool_pages > 0
    assert plan.hbm_bytes_per_device == int(0.001 * tmp.GiB)
    # The exact lines are the real bytes: the tree and the pool.
    alloc = _tree_bytes(params) + eng.pool.k.nbytes + eng.pool.v.nbytes
    exact = sum(line.bytes_per_device for line in plan.lines if line.exact)
    assert exact + plan.pool_bytes_per_device == alloc
    if prefix_cache:
        assert plan.pool_pages == plan.fit_pages > plan.default_pages
    else:
        assert plan.pool_pages == plan.default_pages
    snap = eng.metrics.snapshot()
    assert snap["planner_headroom_bytes"] == plan.headroom_bytes > 0
    # The engine serves from the planned pool.
    out = [ev["token_id"] for ev in eng.start().generate_stream(
        [5, 6, 7], max_new_tokens=4)]
    eng.stop()
    assert len(out) == 4


def test_engine_plan_refuses_a_budget_that_cannot_fit():
    cfg = tl.LlamaConfig.tiny(vocab_size=259)
    with pytest.raises(tmp.MemoryPlanError, match="does not fit"):
        LLMEngine(tl.init_params(cfg, "cpu"), cfg, ByteTokenizer(),
                  {**ECFG, "auto_pool_pages": True,
                   "hbm_gb_per_device": 1e-6}, device="cpu")


def test_default_sizing_unchanged_without_knob():
    cfg = tl.LlamaConfig.tiny(vocab_size=259)
    params = tl.init_params(cfg, "cpu")
    eng = LLMEngine(params, cfg, ByteTokenizer(), ECFG, device="cpu")
    assert eng.memory_plan is None
    assert eng.pool.n_pages == ECFG["max_batch_size"] * (
        ECFG["max_seq_len"] // ECFG["page_size"]) + 1
    assert eng.metrics.snapshot()["planner_headroom_bytes"] == 0
    # An explicit n_pages wins over the knob, as in the JAX engine.
    eng = LLMEngine(params, cfg, ByteTokenizer(),
                    {**ECFG, "auto_pool_pages": True}, n_pages=9,
                    device="cpu")
    assert eng.memory_plan is None and eng.pool.n_pages == 9


@pytest.mark.parametrize("replicas", [1, 2])
def test_engines_sharing_a_device_refuse_the_plan(replicas):
    """Each engine would plan the device's whole memory, so a second
    local replica's planned pool would not fit beside the first: more
    than one engine refuses the knob before building any, naming A.17;
    one engine (or an explicit n_pages) builds."""
    from generativeaiexamples_tpu_torch.serving.__main__ import build_engines

    ecfg = {**ECFG, "auto_pool_pages": True, "hbm_gb_per_device": 0.001}
    if replicas > 1:
        with pytest.raises(ValueError, match=r"A\.17"):
            build_engines("tiny", "cpu", warmup=False, engine_cfg=ecfg,
                          replicas=replicas)
        engines = build_engines("tiny", "cpu", warmup=False,
                                engine_cfg=ecfg, replicas=replicas,
                                n_pages=9)
        assert [e.pool.n_pages for e in engines] == [9] * replicas
        assert all(e.memory_plan is None for e in engines)
    else:
        (eng,) = build_engines("tiny", "cpu", warmup=False, engine_cfg=ecfg)
        assert eng.pool.n_pages == eng.memory_plan.pool_pages > 0


def test_device_budget_defaults():
    assert tmp.device_hbm_bytes(EngineConfig()) == 4 << 30
    assert tmp.device_hbm_bytes(EngineConfig(), "cpu") == 4 << 30
    assert tmp.device_hbm_bytes(EngineConfig(hbm_gb_per_device=2.5)) == \
        int(2.5 * tmp.GiB)
    assert jmp._CPU_DEFAULT_HBM == tmp._CPU_DEFAULT_HBM
