"""Port parity: composed step plans on the port's engine
(engine.step_plans), case for case with tests/test_step_plans.py's
TestPlanComposition and its sampled-fallback test.

With `step_plans` and `fused_prefill`, a speculative engine's long-prompt
chunks ride inside its verify dispatches (the (K, k, -, W) lattice point,
engine_model.fused_spec_prefill_step); without `step_plans` it never
fuses. The scheduler is stepped INLINE (test_torch_fused_prefill._step),
so plans-on and plans-off runs see the same verify programs and their
streams compare exactly. Oracles are offline JAX greedy decoding (f32)
and the JAX package's jitted int8 steps (int8 pool) on the same weights;
no JAX `LLMEngine` is built. The counters are the JAX test's literals.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_engine_model_int8 import ECFG as INT8_ECFG
from test_torch_engine_model_int8 import _oracle as int8_oracle
from test_torch_fused_prefill import (
    LONG_PROMPT, _engine, _ids, _jax_greedy, _run_to_idle, _step)

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.ops import quant as jq
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.serving import engine_model
from generativeaiexamples_tpu_torch.serving.engine import (
    GenRequest, LLMEngine)
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

VERIFY = pytest.mark.parametrize("tree_branches", [0, 3],
                                 ids=["linear", "tree"])


def _run_inline_spec(step_plans, tree_branches=0):
    """One short stream decodes continuously on a speculative engine
    (k = 2, K = 2); the 200-token prompt is admitted after two beats.
    Returns (short ids, long ids, metrics snapshot, plans dispatched)."""
    eng = _engine(speculative_k=2, speculative_tree_branches=tree_branches,
                  fused_prefill=True, step_plans=step_plans,
                  decode_steps_per_dispatch=2)
    plans = []
    real = engine_model.plan_step

    def spy(params, cfg, plan, **kw):
        plans.append(plan)
        return real(params, cfg, plan, **kw)

    engine_model.plan_step = spy
    try:
        short = eng.submit(GenRequest(prompt_ids=[5, 6, 7],
                                      max_new_tokens=120))
        for _ in range(2):
            _step(eng)
        long_req = eng.submit(GenRequest(prompt_ids=list(LONG_PROMPT),
                                         max_new_tokens=4))
        _run_to_idle(eng)
    finally:
        engine_model.plan_step = real
    return _ids(short), _ids(long_req), eng.metrics.snapshot(), plans


class TestPlanComposition:
    @VERIFY
    def test_spec_plus_rider_byte_identical_to_separate_lanes(
            self, tree_branches):
        """Verify + rider in one step gives exactly the streams of the
        lane-separate scheduler (plans off), and the long prompt's are
        the offline greedy continuation."""
        s_off, l_off, m_off, p_off = _run_inline_spec(False, tree_branches)
        s_on, l_on, m_on, p_on = _run_inline_spec(True, tree_branches)
        assert s_on == s_off and len(s_on) == 120
        assert l_on == l_off and len(l_on) == 4
        assert l_on == _jax_greedy(LONG_PROMPT, 4)
        # Plans off: the lane carries every chunk; counters present, 0.
        assert m_off["fused_steps"] == 0
        assert m_off["fused_prefill_tokens"] == 0
        assert not any(p.spec_k and p.rider_width for p in p_off)
        # Plans on: every prompt token rode a composed verify step (12
        # full chunks and an 8-token tail), at the verify width.
        assert m_on["fused_steps"] == 13
        assert m_on["fused_prefill_tokens"] == 200
        composed = [p for p in p_on if p.rider_width and p.decode_k]
        assert len(composed) == 13
        assert all(p.spec_k == 2 and p.tree_branches == tree_branches
                   for p in composed)

    @VERIFY
    def test_counters_account_exactly(self, tree_branches):
        s_on, l_on, m_on, _ = _run_inline_spec(True, tree_branches)
        total = len(s_on) + len(l_on)
        assert m_on["tokens_generated"] == total == 124
        assert m_on["spec_tokens_per_step"] > 0
        # 3 short + 200 long prompt tokens, none counted twice.
        assert m_on["prefill_tokens"] == 203
        assert m_on["spec_fallback_steps"] == 0
        # Every token but the two prefill-sampled firsts was committed by
        # a verify step.
        assert m_on["spec_committed"] == total - 2

    def test_spec_commit_identity(self):
        """spec_committed == tokens_generated - first tokens: the verify
        loop emits exactly what the block landing reports."""
        eng = _engine(speculative_k=2, fused_prefill=True, step_plans=True,
                      decode_steps_per_dispatch=2)
        req = eng.submit(GenRequest(prompt_ids=[5, 6, 7], max_new_tokens=40))
        _run_to_idle(eng, max_steps=200)
        assert len(_ids(req)) == 40
        assert eng.metrics.spec_committed == 40 - 1
        assert eng.metrics.tokens_out == 40

    @VERIFY
    def test_int8_pool_composed_equals_lane_and_oracle(self, tree_branches):
        """The int8 deployment (K6's and K4's plain forms): plans on and
        off give the same streams, plans on rides every prompt token,
        and the streams equal the int8 oracle."""
        vocab = 259
        jcfg = jl.LlamaConfig.tiny(vocab_size=vocab)
        jparams = jq.quantize_llama_params(
            jl.init_params(jcfg, jax.random.PRNGKey(0)))
        tcfg = tl.LlamaConfig.tiny(vocab_size=vocab)
        tparams = convert.llama_params_from_numpy(
            jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
        rng = np.random.default_rng(11)
        short_p = rng.integers(0, 256, 6).tolist()
        long_p = rng.integers(0, 256, 45).tolist()
        runs = {}
        for plans in (False, True):
            eng = LLMEngine(tparams, tcfg, ByteTokenizer(),
                            {**INT8_ECFG, "fused_prefill": True,
                             "step_plans": plans, "speculative_k": 2,
                             "speculative_tree_branches": tree_branches,
                             "decode_steps_per_dispatch": 2}, device="cpu")
            assert eng.pool.quantized
            short = eng.submit(GenRequest(prompt_ids=short_p,
                                          max_new_tokens=30))
            for _ in range(2):
                _step(eng)
            long_req = eng.submit(GenRequest(prompt_ids=long_p,
                                             max_new_tokens=8))
            _run_to_idle(eng)
            runs[plans] = (_ids(short), _ids(long_req),
                           eng.metrics.snapshot())
        assert runs[True][:2] == runs[False][:2]
        assert runs[True][2]["fused_prefill_tokens"] == 45
        assert runs[False][2]["fused_prefill_tokens"] == 0
        assert runs[True][2]["spec_slot_steps"] > 0
        model = (jcfg, jparams, tcfg, tparams)
        assert runs[True][1] == int8_oracle(model, long_p, 8)
        assert runs[True][0] == int8_oracle(model, short_p, 30)


def test_sampled_never_rides_verify_plan():
    """While a sampled slot is dispatchable the engine selects the
    spec-state plain plan, never a verify plan (which would greedy-ify
    the sampled stream), and that fallback never carries a rider: the
    chunked lane feeds a long prompt meanwhile. Once the sampled stream
    is done, verify plans resume."""
    eng = _engine(speculative_k=2, fused_prefill=True, step_plans=True,
                  decode_steps_per_dispatch=2)
    seen = []
    real = engine_model.plan_step

    def spy(params, cfg, plan, **kw):
        seen.append((plan, eng._sampled_live()))
        return real(params, cfg, plan, **kw)

    engine_model.plan_step = spy
    try:
        req = eng.submit(GenRequest(prompt_ids=[1, 2], max_new_tokens=24,
                                    temperature=0.7))
        _step(eng)
        long_req = eng.submit(GenRequest(prompt_ids=LONG_PROMPT[:60],
                                         max_new_tokens=30))
        _run_to_idle(eng)
    finally:
        engine_model.plan_step = real
    assert len(_ids(req)) == 24
    assert _ids(long_req) == _jax_greedy(LONG_PROMPT[:60], 30)
    while_sampled = [p for p, live in seen if live and p.decode_k > 0]
    assert while_sampled
    assert all(p.spec_state and p.spec_k == 0 and p.rider_width == 0
               for p in while_sampled)
    assert eng.metrics.spec_fallback_steps == len(while_sampled)
    assert any(p.spec_k == 2 for p, live in seen if not live)
    # The lane feeds the prompt while the sampled stream is live: chunk
    # plans go out then, and no beat passes without a prompt token.
    assert any(p.decode_k == 0 and p.rider_width > 0
               for p, live in seen if live)
    assert eng.metrics.prefill_stall_beats == 0
