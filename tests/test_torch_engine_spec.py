"""Port parity: the speculative engine (serving/engine.py's spec lanes).

The port's LLMEngine on the tiny f32 Llama of the JAX suite's step-plan
tests (`LlamaConfig.tiny()`, `init_params(PRNGKey(3))`, carried across
with the converter), on the CPU, at that suite's engine shape. Greedy
streams must equal the JAX package's offline `llama.greedy_generate`
token for token, whatever the acceptance: verification commits exactly
the greedy continuation. No JAX `LLMEngine` is built (the JAX suite's
engine state is order dependent within a process, ROADMAP).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.serving import openai_server as tos
from generativeaiexamples_tpu_torch.serving.engine import LLMEngine
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

JCFG = jl.LlamaConfig.tiny()
BASE = dict(max_batch_size=2, max_seq_len=256, page_size=8,
            prefill_buckets=(16,), decode_steps_per_dispatch=2)
SPEC_KEYS = ("spec_tokens_per_step", "spec_fallback_steps",
             "spec_committed", "spec_slot_steps")


@pytest.fixture(scope="module")
def model():
    jparams = jl.init_params(JCFG, jax.random.PRNGKey(3))
    tparams = convert.llama_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jparams, tparams


def _engine(tparams, **kw):
    return LLMEngine(tparams, tl.LlamaConfig.tiny(), ByteTokenizer(),
                     {**BASE, **kw}, device="cpu")


def _oracle(jparams, prompt, n):
    return np.asarray(jl.greedy_generate(
        jparams, JCFG, jnp.asarray([prompt]), n))[0, len(prompt):].tolist()


def _stream(eng, prompt, n, **kw):
    return [e["token_id"] for e in eng.generate_stream(
        prompt, max_new_tokens=n, **kw) if e["token_id"] >= 0]


@pytest.mark.parametrize("spec", [dict(speculative_k=2),
                                  dict(speculative_k=2,
                                       speculative_tree_branches=3)],
                         ids=["linear", "tree"])
def test_concurrent_greedy_streams_equal_the_offline_oracle(model, spec):
    """Four concurrent streams of 7, 3, 12 and 40 tokens over four slots:
    each equals JAX's offline greedy continuation."""
    jparams, tparams = model
    eng = _engine(tparams, max_batch_size=4, decode_steps_per_dispatch=4,
                  **spec).start()
    try:
        results = {}

        def run(i, n):
            results[i] = _stream(eng, [i, i + 1, i + 2], n)

        lens = [7, 3, 12, 40]
        threads = [threading.Thread(target=run, args=(i, n))
                   for i, n in enumerate(lens)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        eng.stop()
    for i, n in enumerate(lens):
        assert results[i] == _oracle(jparams, [i, i + 1, i + 2], n), i
    snap = eng.metrics.snapshot()
    assert snap["spec_slot_steps"] > 0 and snap["spec_fallback_steps"] == 0
    assert snap["kernel_launches_paged_attention_tree"] == 0  # CPU


def test_int8_pool_tree_stream_equals_int8_linear_stream(model):
    """The int8 tree path (codes and scales moved verbatim by the
    relocation, gather-then-dequantize attention) commits exactly what
    the int8 linear path commits from the same pool state."""
    _, tparams = model
    out = {}
    for tree in (0, 3):
        eng = _engine(tparams, speculative_k=2, speculative_tree_branches=tree,
                      kv_dtype="int8", decode_steps_per_dispatch=4).start()
        try:
            out[tree] = _stream(eng, [7, 8, 9], 24)
        finally:
            eng.stop()
    assert len(out[0]) == 24
    assert out[3] == out[0]


def test_tree_acceptance_at_least_linear(model):
    """On a repetitive prompt the tree lattice accepts at least as much
    per step as the single chain, and the chain more than nothing."""
    _, tparams = model

    def run(tree):
        eng = _engine(tparams, speculative_k=2, speculative_tree_branches=tree,
                      decode_steps_per_dispatch=4).start()
        try:
            _stream(eng, [7, 8, 9], 48)
            return eng.metrics.snapshot()["spec_tokens_per_step"]
        finally:
            eng.stop()

    linear, tree = run(0), run(3)
    assert tree >= linear > 1.0, (tree, linear)


def test_sampled_request_falls_back_and_greedy_stream_holds(model):
    """A sampled request on a speculative engine serves all its tokens
    through the plain fallback block while a concurrent greedy stream
    still equals the oracle."""
    jparams, tparams = model
    eng = _engine(tparams, speculative_k=2, speculative_tree_branches=2,
                  decode_steps_per_dispatch=4).start()
    try:
        results = {}

        def greedy():
            results["greedy"] = _stream(eng, [5, 6, 7], 30)

        def sampled():
            results["sampled"] = _stream(eng, [9, 9, 9], 20,
                                         temperature=0.8, top_k=5)

        threads = [threading.Thread(target=greedy),
                   threading.Thread(target=sampled)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        eng.stop()
    assert len(results["sampled"]) == 20
    assert results["greedy"] == _oracle(jparams, [5, 6, 7], 30)
    assert eng.metrics.snapshot()["spec_fallback_steps"] > 0


def test_chunked_prompt_seeds_the_history(model):
    """A prompt beyond the largest bucket goes through the chunked lane:
    its history row is seeded with the prompt and its stream equals the
    oracle."""
    jparams, tparams = model
    prompt = [int(t) for t in np.random.default_rng(0).integers(0, 256, 40)]
    eng = _engine(tparams, speculative_k=2, speculative_tree_branches=3,
                  max_batch_size=1).start()
    try:
        got = _stream(eng, prompt, 16)
    finally:
        eng.stop()
    assert got == _oracle(jparams, prompt, 16)
    assert eng._history[0, :40].tolist() == prompt
    assert eng._history[0, 40] == got[0]


def test_metrics_show_the_spec_keys(model):
    """/metrics carries the speculation keys always: 0 on a plain engine,
    counted on a speculative one."""
    _, tparams = model
    plain = tos.OpenAIServer(_engine(tparams)).metrics()[1]
    assert {k: plain[k] for k in SPEC_KEYS} == dict.fromkeys(SPEC_KEYS, 0)
    eng = _engine(tparams, speculative_k=2).start()
    try:
        _stream(eng, [7, 8, 9], 12)
    finally:
        eng.stop()
    snap = tos.OpenAIServer(eng).metrics()[1]
    assert snap["spec_slot_steps"] > 0
    assert snap["spec_committed"] == 11  # the first token comes from prefill
    assert snap["spec_tokens_per_step"] == (snap["spec_committed"]
                                            / snap["spec_slot_steps"])


def test_chain_hub_builds_the_configured_speculative_engine(monkeypatch):
    """APP_ENGINE_SPECULATIVEK / APP_ENGINE_SPECULATIVETREEBRANCHES reach
    the engine the chain server's EngineHub (and the launcher) build, and
    it serves."""
    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
    from generativeaiexamples_tpu_torch.serving import __main__ as launcher

    build = launcher.build_engine
    monkeypatch.setattr(launcher, "build_engine", lambda *a, **kw: build(
        *a, **{**kw, "warmup": False}))
    config = load_config(env={"APP_ENGINE_SPECULATIVEK": "3",
                              "APP_ENGINE_SPECULATIVETREEBRANCHES": "4",
                              "APP_ENGINE_MAXSEQLEN": "256"})
    eng = EngineHub(config, device="cpu", model_size="tiny").llm_engine()
    try:
        assert (eng._spec_k, eng._tree_branches, eng._spec_tree_nodes) == (
            3, 4, 13)
        assert len(_stream(eng, [257, 65, 66], 6)) == 6
        assert eng.metrics.snapshot()["spec_slot_steps"] > 0
    finally:
        eng.stop()
