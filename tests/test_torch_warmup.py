"""Port parity: the warmed engine (LLMEngine.warmup's lattice and the
dispatch limits it sets), against the JAX package's engine.

- The two picks: `_pick_k` and `_pick_chunk_width` of both packages on a
  stub that holds only the `_warm_*` sets, over hypothesis-drawn bounds
  and warm sets.
- The lattice and the dispatch: on LlamaConfig.tiny() (f32, the same
  weights on both sides), a plain engine with fused_prefill warmed at
  the defaults, and a speculative tree engine with step_plans,
  fused_prefill and long_prompts, each warmed and then stepped inline
  over one request trace. Their `_warm_ks`, `_warm_plans` (as tuples of
  StepPlan fields), rider and chunk sets, `plan_variants_compiled`, the
  sequence of dispatched plans (block lengths and riders) and the greedy
  streams must equal the JAX engine's. Each JAX engine runs in a
  subprocess of its own (tests/_warm_trace.py), with a fresh chunk
  staging array per chunk: ROADMAP's third reference-side fault (the
  JAX engine refills a staging array that the CPU backend may share
  with a chunk not yet computed) cannot reach it.
- An engine never warmed keeps the block lengths and chunk widths it
  picked before warmup limited them (the literal plans below are the
  parent tree's on the same trace).
- The CUDA graphs' launch bookkeeping (serving/step_graphs.py): a
  capture's launches are counted apart from LAUNCHES, those of another
  thread meanwhile are not, and each replay adds the capture's.
"""

import json
import os
import subprocess
import sys
import threading
import types

import jax
import numpy as np
import pytest
import torch
from _warm_trace import lattice, run_trace
from hypothesis import given, settings
from hypothesis import strategies as st

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.serving.engine import LLMEngine as JLLMEngine
from generativeaiexamples_tpu_torch import kernels
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.serving import step_graphs
from generativeaiexamples_tpu_torch.serving.engine import (
    GenRequest, LLMEngine)
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE = {"max_batch_size": 2, "max_seq_len": 128, "page_size": 8,
        "prefill_buckets": [16], "decode_steps_per_dispatch": 8,
        "pace_emission_max_streams": 0, "fused_prefill": True}
LONG = [(i * 7 + 1) % 256 for i in range(40)]  # 3 chunks of 16: 16, 16, 8
CONFIGS = {
    # Warmed at the defaults (greedy, ks {1, 2, 8}, no long prompts): no
    # prompt rides, and the last chunk goes out at the full width.
    "plain": {"ecfg": BASE, "warmup": {},
              "trace": [{"at": 0, "prompt": [5, 6, 7], "max_new_tokens": 12},
                        {"at": 1, "prompt": LONG, "max_new_tokens": 5},
                        {"at": 3, "prompt": [9, 10, 11, 12],
                         "max_new_tokens": 7}]},
    # Verify blocks with the composed rider at the warmed (48, K).
    "spec_tree": {"ecfg": {**BASE, "speculative_k": 2,
                           "speculative_tree_branches": 2,
                           "step_plans": True},
                  "warmup": {"long_prompts": True,
                             "long_prompt_lengths": [40]},
                  "trace": [{"at": 0, "prompt": [5, 6, 7],
                             "max_new_tokens": 30},
                            {"at": 2, "prompt": LONG,
                             "max_new_tokens": 6}]},
}
# The parent tree's plans on the plain trace with no warmup: K 4 for a
# 3-token remainder, the 8-token last chunk at width 8 sampling its
# first token in the chunk's dispatch. (decode_k, spec_k, tree, rider
# width, rider S_total, spec_state, rider_sample).
UNWARMED_PLAIN_PLANS = [[8, 0, 0, 0, 0, 0, 0], [4, 0, 0, 0, 0, 0, 0],
                        [0, 0, 0, 16, 48, 0, 0], [0, 0, 0, 16, 48, 0, 0],
                        [0, 0, 0, 8, 48, 0, 1], [4, 0, 0, 0, 0, 0, 0],
                        [8, 0, 0, 0, 0, 0, 0]]

JCFG = jl.LlamaConfig.tiny()
TCFG = tl.LlamaConfig.tiny()


@pytest.fixture(scope="module")
def jax_runs():
    """Each config's JAX engine, warmed and run over its trace, in a
    subprocess of its own (both started together)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_warm_trace.py"),
         json.dumps({**spec, "ecfg": {**spec["ecfg"],
                                      "compile_cache_dir": ""}})],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, spec in CONFIGS.items()}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-3000:]
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.fixture(scope="module")
def tparams():
    jparams = jl.init_params(JCFG, jax.random.PRNGKey(3))
    return convert.llama_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)


def _port_engine(tparams, name):
    ecfg = {**CONFIGS[name]["ecfg"], "dtype": "float32",
            "kv_dtype": "float32"}
    return LLMEngine(tparams, TCFG, ByteTokenizer(), ecfg, device="cpu")


@pytest.fixture(scope="module")
def port_runs(tparams):
    out = {}
    for name, spec in CONFIGS.items():
        eng = _port_engine(tparams, name).warmup(**spec["warmup"])
        out[name] = {"lattice": lattice(eng),
                     **run_trace(eng, GenRequest, spec["trace"])}
    return out


# -- the two picks ------------------------------------------------------------

WARM_KS = st.one_of(st.just(set()), st.sets(
    st.sampled_from([1, 2, 4, 8, 16, 32]), max_size=5).map(
        lambda s: s | {1}))


@settings(max_examples=300, deadline=None)
@given(bound=st.integers(-2, 100), warm_ks=WARM_KS)
def test_pick_k_matches_jax(bound, warm_ks):
    stub = types.SimpleNamespace(_warm_ks=warm_ks)
    assert LLMEngine._pick_k(stub, bound) == JLLMEngine._pick_k(stub, bound)


@st.composite
def _chunk_case(draw):
    chunk = draw(st.sampled_from([16, 32, 64, 512]))
    s_totals = [chunk * m for m in (1, 2, 3)]
    widths = st.sampled_from([w for w in (8, 16, 32, 64, 128, 256, 512)
                              if w <= chunk])
    warm = draw(st.sets(st.tuples(st.sampled_from(s_totals), widths),
                        max_size=6))
    return (draw(st.integers(1, chunk)), chunk, draw(st.sampled_from(
        s_totals)), warm, draw(st.sampled_from([set(), {1, 2, 8}])))


@settings(max_examples=300, deadline=None)
@given(case=_chunk_case())
def test_pick_chunk_width_matches_jax(case):
    n, chunk, s_total, warm, warm_ks = case
    stub = types.SimpleNamespace(_warm_ks=warm_ks, _warm_chunk_widths=warm)
    assert (LLMEngine._pick_chunk_width(stub, n, chunk, s_total)
            == JLLMEngine._pick_chunk_width(stub, n, chunk, s_total))


# -- the lattice and the dispatch ----------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_warmed_lattice_equals_jax(jax_runs, port_runs, name):
    want, got = jax_runs[name]["lattice"], port_runs[name]["lattice"]
    assert got == want
    assert got["plan_variants_compiled"] == len(got["plans"]) > 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_warmed_dispatch_and_streams_equal_jax(jax_runs, port_runs, name):
    want, got = jax_runs[name], port_runs[name]
    assert got["plans"] == want["plans"]
    assert got["streams"] == want["streams"]
    assert all(len(s) == t["max_new_tokens"]
               for s, t in zip(got["streams"], CONFIGS[name]["trace"]))


def test_warmed_picks_differ_from_unwarmed(port_runs):
    """The trace reaches the limits: the warmed plain engine rounds a
    3-token remainder up to the warmed K 8, sends the 8-token last chunk
    at the full width (no warmed tail) and samples it at the commit."""
    plans = port_runs["plain"]["plans"]
    assert [p[0] for p in plans if p[0]] == [8, 8, 8, 8]
    assert [p[3] for p in plans if not p[0]] == [16, 16, 16]
    assert not any(p[6] for p in plans)
    riders = [p for p in port_runs["spec_tree"]["plans"] if p[0] and p[3]]
    assert riders and all(p[4] == 48 and p[0] in (1, 2) for p in riders)


def test_unwarmed_engine_keeps_todays_picks(tparams, port_runs):
    eng = _port_engine(tparams, "plain")
    got = run_trace(eng, GenRequest, CONFIGS["plain"]["trace"])
    assert eng.metrics.plan_variants_compiled == 0 and not eng._warm_ks
    assert got["plans"] == UNWARMED_PLAIN_PLANS
    # Block lengths and chunk widths change no greedy token.
    assert got["streams"] == port_runs["plain"]["streams"]


# -- CUDA graphs: the launch bookkeeping ---------------------------------------


def test_capture_launches_are_counted_apart_and_replays_add_them(
        monkeypatch):
    """A capture's launches go to its own counts, not LAUNCHES, while a
    launch from another thread during the capture (a fleet replica
    serving meanwhile) counts in LAUNCHES as always; each replay adds
    the capture's counts."""
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES,
                                                           0))
    for name in ("int8_matmul", "paged_attention_int8"):
        monkeypatch.setitem(kernels._FUNCS, name, lambda *a: 0)
    kernels.LAUNCHES["int8_matmul"] = 5
    other = threading.Thread(target=lambda: [
        kernels.launch("int8_matmul") for _ in range(7)])
    with kernels.capture_launches() as delta:
        # What a capture of a block counts through kernels.launch.
        for _ in range(14):
            kernels.launch("int8_matmul")
        other.start()
        other.join()
        kernels.launch("paged_attention_int8")
        kernels.launch("paged_attention_int8")
    assert delta == {"int8_matmul": 14, "paged_attention_int8": 2}
    assert kernels.LAUNCHES["int8_matmul"] == 5 + 7
    assert kernels.LAUNCHES["paged_attention_int8"] == 0
    kernels.launch("int8_matmul")  # after the capture: counted again
    assert kernels.LAUNCHES["int8_matmul"] == 5 + 7 + 1
    for _ in range(3):  # three replays
        kernels.add_launches(delta)
    assert kernels.LAUNCHES["int8_matmul"] == 13 + 3 * 14
    assert kernels.LAUNCHES["paged_attention_int8"] == 3 * 2
    assert sum(kernels.LAUNCHES.values()) == 13 + 3 * 16


def test_graph_keys_ignore_flags_only_for_verify_blocks():
    Plan = step_graphs.engine_model.StepPlan
    verify = Plan(decode_k=2, spec_k=3, tree_branches=4)
    assert step_graphs.graph_key(verify, step_graphs.GREEDY) \
        == step_graphs.graph_key(verify, step_graphs.SAMPLED)
    plain = Plan(decode_k=8)
    assert step_graphs.graph_key(plain, step_graphs.GREEDY) \
        != step_graphs.graph_key(plain, step_graphs.SAMPLED)


def test_cpu_engine_captures_nothing(tparams):
    eng = _port_engine(tparams, "plain").warmup()
    assert eng._graphs is None
    with pytest.raises(ValueError, match="CUDA"):
        step_graphs.StepGraphs(eng.params, eng.cfg, eng.pool,
                               eng._generator, 2, eng.max_pages,
                               eng._last_tokens)


@pytest.mark.parametrize("long_env", [None, "0", "1"])
def test_server_warms_as_the_jax_launcher(monkeypatch, long_env):
    """serving/__main__.py warms with sampled=True, and long_prompts only
    with ENGINE_WARMUP_LONG=1, as the JAX launcher's __main__ does."""
    from generativeaiexamples_tpu_torch.serving.__main__ import (
        serving_warmup_kw)

    if long_env is None:
        monkeypatch.delenv("ENGINE_WARMUP_LONG", raising=False)
    else:
        monkeypatch.setenv("ENGINE_WARMUP_LONG", long_env)
    assert serving_warmup_kw() == {"sampled": True,
                                   "long_prompts": long_env == "1"}
