"""Port parity: the fused prefill rider (engine.fused_prefill) and the
unfused finish (engine.fused_sampling off), case for case with
tests/test_fused_prefill.py, on the port's engine.

While streams decode, a long prompt's next chunk rides inside the decode
dispatch (engine_model.fused_decode_prefill_step) instead of going out as
a standalone chunk forward. Byte-identity tests step the scheduler INLINE
(no threads), as the JAX tests do: the dispatch schedule is then a pure
function of the engine state, so rider-on and rider-off runs see the same
decode programs and their token streams compare exactly. Oracles are
offline JAX (`greedy_generate`, and for the int8 pool the jitted int8
steps of test_torch_engine_model_int8._oracle) on the same weights,
carried across with the converter; no JAX `LLMEngine` is built (the JAX
suite's chunked-prefill state is order dependent within a process).
"""

import functools
import queue
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine_model_int8 import ECFG as INT8_ECFG
from test_torch_engine_model_int8 import _oracle as int8_oracle

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.ops import quant as jq
from generativeaiexamples_tpu.serving.kv_pager import (
    KV_PAGER_KEYS as J_KV_PAGER_KEYS)
from generativeaiexamples_tpu_torch.config.schema import EngineConfig
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.serving import engine_model
from generativeaiexamples_tpu_torch.serving.engine import (
    GenRequest, LLMEngine)
from generativeaiexamples_tpu_torch.serving.openai_server import OpenAIServer
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

JCFG = jl.LlamaConfig.tiny()
JPARAMS = jl.init_params(JCFG, jax.random.PRNGKey(3))
TCFG = tl.LlamaConfig.tiny()
TPARAMS = convert.llama_params_from_numpy(
    jax.tree.map(np.asarray, JPARAMS), "cpu", torch.float32)


def _engine(params=TPARAMS, cfg=TCFG, **kw):
    base = dict(max_batch_size=2, max_seq_len=256, page_size=8,
                prefill_buckets=(16,), decode_steps_per_dispatch=8,
                dtype="float32", kv_dtype="float32")
    base.update(kw)
    return LLMEngine(params, cfg, ByteTokenizer(), base, device="cpu")


def _step(eng):
    """One deterministic scheduler iteration (the body of _loop, single
    threaded; _land_next_block's steps spelled out to return the landed
    block). Returns the landed _InFlight block or None."""
    eng._admit_waiting()
    eng._advance_long_prefills()
    eng._emit_ready_first_tokens()
    while (len(eng._inflight) < eng.pipeline_depth
           and any(s is not None for s in eng.slots)):
        if not eng._dispatch_decode():
            break
    if not eng._inflight:
        return None
    fl = eng._inflight.popleft()
    eng._process_block_host(fl, eng._fetch_block_host(fl))
    for seq in fl.releases:
        seq.release()
    fl.releases = []
    eng._reap_starved()
    eng._beat += 1
    eng._note_prefill_stalls()
    return fl


def _idle(eng):
    return (all(s is None for s in eng.slots) and not eng.waiting
            and not eng._long_prefills and not eng._inflight
            and not eng._pending_first)


def _drain(req):
    """Every event already delivered to a request's stream."""
    out = []
    while True:
        try:
            out.append(req.stream.get_nowait())
        except queue.Empty:
            return out


def _ids(req):
    return [e["token_id"] for e in _drain(req) if e["token_id"] >= 0]


def _run_to_idle(eng, observe=None, max_steps=400):
    for _ in range(max_steps):
        fl = _step(eng)
        if observe is not None:
            observe(eng, fl)
        if _idle(eng):
            return
    raise AssertionError("engine did not go idle")


LONG_PROMPT = [(i * 7) % JCFG.vocab_size for i in range(200)]


def _run_inline(fused, observe=None, **kw):
    """One short stream decodes continuously; a long prompt (13 chunks of
    16) is admitted after two beats. K is pinned to 2 so both modes run
    the same decode steps. Returns (short ids, long ids, snapshot)."""
    eng = _engine(fused_prefill=fused, decode_steps_per_dispatch=2, **kw)
    short = eng.submit(GenRequest(prompt_ids=[5, 6, 7], max_new_tokens=64))
    for _ in range(2):
        _step(eng)
    long_req = eng.submit(GenRequest(prompt_ids=LONG_PROMPT,
                                     max_new_tokens=4))
    _run_to_idle(eng, observe)
    return _ids(short), _ids(long_req), eng.metrics.snapshot()


@functools.lru_cache(maxsize=None)
def _inline(fused, **kw):
    """_run_inline without an observer, run once per configuration (the
    run is deterministic, and several tests compare the same ones)."""
    return _run_inline(fused, **kw)


def _jax_greedy(prompt, n_new, params=JPARAMS, cfg=JCFG):
    out = jl.greedy_generate(params, cfg, jnp.asarray([prompt], jnp.int32),
                             n_new, use_pallas=False)
    return np.asarray(out)[0, len(prompt):].tolist()


class TestFusedDispatch:
    def test_fused_on_off_byte_identical_and_counters(self):
        s_off, l_off, m_off = _inline(False)
        s_on, l_on, m_on = _inline(True)
        assert s_on == s_off and len(s_on) == 64
        assert l_on == l_off and len(l_on) == 4
        # ... and the long stream is the offline greedy continuation.
        assert l_on == _jax_greedy(LONG_PROMPT, 4)
        # Off: the counters are present and 0.
        assert m_off["fused_steps"] == 0
        assert m_off["fused_prefill_tokens"] == 0
        # On: riders carried the whole prompt (12 full chunks and an
        # 8-token tail), no standalone chunk while decode was live.
        assert m_on["fused_steps"] == 13
        assert m_on["fused_prefill_tokens"] == 200
        # prefill_tokens counts real tokens, not the rider's padding.
        assert m_on["prefill_tokens"] == m_off["prefill_tokens"] == 203
        # The rider's last chunk did not sample: the commit's
        # sample_token_into did, once; the lane's tail did, once.
        assert m_on["fused_sample_dispatches"] == 1
        assert m_off["fused_sample_dispatches"] == 1

    def test_gap_bound_no_stream_skips_beats(self):
        """While the long prefill is live, no live decode stream goes more
        than prefill_chunks_per_block + 1 beats without a block."""
        missed = {"cur": 0, "max": 0}

        def observe(eng, fl):
            if not eng._long_prefills or fl is None:
                return
            live = [s for s in eng.slots if s is not None and not s.prefilling]
            if not live:
                return
            in_block = {id(s) for _, s, *_ in fl.metas}
            if all(id(s) in in_block for s in live):
                missed["cur"] = 0
            else:
                missed["cur"] += 1
                missed["max"] = max(missed["max"], missed["cur"])

        _, _, snap = _run_inline(True, observe=observe)
        bound = EngineConfig().prefill_chunks_per_block + 1
        assert missed["max"] <= bound, missed
        assert snap["fused_steps"] > 0
        # The rider fed the prompt every beat it was live.
        assert snap["prefill_stall_beats"] == 0

    def test_idle_engine_uses_fallback_lane(self):
        """With no decode traffic the chunked lane runs the chunks: a
        rider needs a decode batch to ride on."""
        eng = _engine(fused_prefill=True)
        prompt = LONG_PROMPT[:100]
        req = eng.submit(GenRequest(prompt_ids=prompt, max_new_tokens=3))
        _run_to_idle(eng, max_steps=200)
        assert _ids(req) == _jax_greedy(prompt, 3)
        assert eng.metrics.fused_steps == 0  # nothing to fuse into

    def test_speculative_engine_never_fuses(self):
        """Without step_plans a speculative engine accepts the knob and
        keeps the chunked lane, as the JAX engine does; with them its
        chunks ride the verify blocks (test_torch_spec_rider.py)."""
        eng = _engine(decode_steps_per_dispatch=4, speculative_k=2,
                      fused_prefill=True)
        assert eng._fused_width == 0
        short = eng.submit(GenRequest(prompt_ids=[5, 6, 7],
                                      max_new_tokens=24))
        _step(eng)
        long_req = eng.submit(GenRequest(prompt_ids=LONG_PROMPT[:60],
                                         max_new_tokens=4))
        _run_to_idle(eng)
        assert _ids(short) == _jax_greedy([5, 6, 7], 24)
        assert _ids(long_req) == _jax_greedy(LONG_PROMPT[:60], 4)
        assert eng.metrics.fused_steps == 0
        assert eng.metrics.spec_slot_steps > 0

    def test_fused_threaded_matches_offline_greedy(self):
        """Through the scheduler thread: a long prompt fused into live
        decode traffic still gives the offline greedy continuation."""
        eng = _engine(fused_prefill=True).start()
        try:
            a_done = threading.Event()

            def stream_a():
                for _ in eng.generate_stream([5, 6, 7], max_new_tokens=150):
                    pass
                a_done.set()

            t = threading.Thread(target=stream_a, daemon=True)
            t.start()
            while eng.metrics.tokens_out < 4 and not a_done.is_set():
                time.sleep(0.005)
            prompt = LONG_PROMPT[:150]
            got = [e["token_id"] for e in
                   eng.generate_stream(prompt, max_new_tokens=4)
                   if e["token_id"] >= 0]
            t.join(timeout=60)
            assert a_done.is_set()
            assert got == _jax_greedy(prompt, 4)
            assert eng.metrics.fused_steps > 0
        finally:
            eng.stop()

    @pytest.mark.parametrize("fused", [False, True])
    def test_counters_present_in_snapshot_and_health(self, fused):
        eng = _engine(fused_prefill=fused)
        snap = eng.metrics.snapshot()
        for key in ("fused_steps", "fused_prefill_tokens",
                    "prefill_stall_beats", "fused_sample_dispatches"):
            assert snap[key] == 0, key
        status, health = OpenAIServer(llm_engine=eng).health()
        assert status == 200
        assert health["fused_prefill"] == {
            "enabled": fused, "fused_steps": 0, "fused_prefill_tokens": 0,
            "prefill_stall_beats": 0}
        assert "prefix_cache" not in health  # the cache is off
        assert health["kv_pager"] == {
            "enabled": False, **dict.fromkeys(J_KV_PAGER_KEYS, 0)}

    def test_health_sections_with_prefix_cache_and_pager(self):
        eng = _engine(prefix_cache=True, kv_pager=True)
        try:
            _, health = OpenAIServer(llm_engine=eng).health()
            assert health["prefix_cache"] == {
                "enabled": True, "cached_pages": 0, "hits": 0, "misses": 0,
                "evictions": 0, "hit_tokens": 0}
            assert health["kv_pager"]["enabled"] is True
            assert set(health["kv_pager"]) == {"enabled",
                                               *J_KV_PAGER_KEYS}
            assert health["fused_prefill"]["enabled"] is False
        finally:
            eng.stop()
        # No LLM engine: the pager section is still there, zeroed.
        _, health = OpenAIServer().health()
        assert "fused_prefill" not in health
        assert health["kv_pager"]["enabled"] is False

    @pytest.mark.parametrize("budget, buckets, width", [
        (512, (16,), 16), (8, (16,), 8), (12, (16,), 8), (100, (32, 64), 64),
        (0, (16,), 0), (-4, (16,), 0)])
    def test_rider_width_follows_budget(self, budget, buckets, width):
        eng = _engine(fused_prefill=True, fused_token_budget=budget,
                      prefill_buckets=buckets)
        assert eng._fused_width == width
        assert _engine(fused_token_budget=budget,
                       prefill_buckets=buckets)._fused_width == 0

    def test_budget_zero_means_no_fusing(self):
        s, l_, snap = _inline(True, fused_token_budget=0)
        assert snap["fused_steps"] == 0 and snap["fused_prefill_tokens"] == 0
        s_off, l_off, _ = _inline(False)
        assert (s, l_) == (s_off, l_off)

    def test_narrow_budget_rides_narrower_chunks(self):
        """Budget 8: the 200-token prompt rides in 25 chunks of 8."""
        s, l_, snap = _inline(True, fused_token_budget=8)
        assert snap["fused_steps"] == 25
        assert snap["fused_prefill_tokens"] == 200
        assert l_ == _jax_greedy(LONG_PROMPT, 4)


class TestRiderEdges:
    def test_int8_pool_fused_equals_unfused_and_oracle(self):
        """The int8 deployment (int8 weights through K6's plain form, the
        fused int8 pool through K4's): the rider's scratch cache stays in
        the model dtype and is quantized once at the commit. Fused on and
        off give the same streams, and both equal the int8 oracle."""
        vocab = 259
        jcfg = jl.LlamaConfig.tiny(vocab_size=vocab)
        jparams = jq.quantize_llama_params(
            jl.init_params(jcfg, jax.random.PRNGKey(0)))
        tcfg = tl.LlamaConfig.tiny(vocab_size=vocab)
        tparams = convert.llama_params_from_numpy(
            jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
        model = (jcfg, jparams, tcfg, tparams)
        rng = np.random.default_rng(11)
        short_p = rng.integers(0, 256, 6).tolist()
        long_p = rng.integers(0, 256, 45).tolist()
        runs = {}
        for fused in (False, True):
            eng = LLMEngine(tparams, tcfg, ByteTokenizer(),
                            {**INT8_ECFG, "fused_prefill": fused,
                             "decode_steps_per_dispatch": 2}, device="cpu")
            assert eng.pool.quantized
            short = eng.submit(GenRequest(prompt_ids=short_p,
                                          max_new_tokens=30))
            for _ in range(2):
                _step(eng)
            long_req = eng.submit(GenRequest(prompt_ids=long_p,
                                             max_new_tokens=8))
            _run_to_idle(eng)
            runs[fused] = (_ids(short), _ids(long_req),
                           eng.metrics.snapshot())
        assert runs[True][:2] == runs[False][:2]
        assert runs[True][2]["fused_prefill_tokens"] == 45
        assert runs[False][2]["fused_prefill_tokens"] == 0
        assert runs[True][1] == int8_oracle(model, long_p, 8)
        assert runs[True][0] == int8_oracle(model, short_p, 30)

    def test_prefix_hit_suffix_rides_past_the_rider_width(self, monkeypatch):
        """A prefix hit's suffix starts at the cached length, so a full
        rider (32) from there passes the scratch cache's end (pos 24,
        s_total 32): the rider keeps the JAX engine's width, its rows
        past the end land in the scratch's sink row (where JAX's scatter
        drops them), and it feeds every suffix token. The stream equals
        the cold run's."""
        widths = []
        real = engine_model.fused_decode_prefill_step

        def spy(*a, **kw):
            cache, chunk_tokens = a[11], a[12]
            widths.append((chunk_tokens.shape[1], cache.k.shape[3]))
            return real(*a, **kw)

        monkeypatch.setattr(engine_model, "fused_decode_prefill_step", spy)
        ecfg = dict(prefill_buckets=(16, 32), max_batch_size=4,
                    max_seq_len=64, decode_steps_per_dispatch=2)
        base = LONG_PROMPT[:30]
        hit_p = base[:28] + [11, 12]
        cold = _engine(**ecfg)
        cold_req = cold.submit(GenRequest(prompt_ids=hit_p,
                                          max_new_tokens=6))
        _run_to_idle(cold)
        want = _ids(cold_req)
        assert want == _jax_greedy(hit_p, 6)

        eng = _engine(fused_prefill=True, prefix_cache=True, **ecfg)
        assert eng._fused_width == 32
        seed_req = eng.submit(GenRequest(prompt_ids=base, max_new_tokens=2))
        _run_to_idle(eng)
        _ids(seed_req)
        short = eng.submit(GenRequest(prompt_ids=[5, 6, 7],
                                      max_new_tokens=20))
        _step(eng)
        hit_req = eng.submit(GenRequest(prompt_ids=hit_p, max_new_tokens=6))
        _run_to_idle(eng)
        assert _ids(hit_req) == want
        assert _ids(short) == _jax_greedy([5, 6, 7], 20)
        snap = eng.metrics.snapshot()
        assert snap["prefix_hits"] == 1 and snap["prefix_hit_tokens"] == 24
        assert snap["fused_prefill_tokens"] == 6
        assert widths == [(32, 32)]


class TestTailChunkBucketing:
    def test_tail_chunk_buckets_to_pow2_width(self, monkeypatch):
        """The chunked lane's final partial chunk dispatches at the
        smallest power of two >= the tail, not the full chunk."""
        widths = []
        real = engine_model.prefill_chunk_step

        def spy(params, cfg, cache, tokens, *a, **k):
            widths.append(tokens.shape[1])
            return real(params, cfg, cache, tokens, *a, **k)

        # The prompt-completing chunk's prefill_chunk_sample_step runs its
        # forward through prefill_chunk_step too, so one spy sees every
        # chunk.
        monkeypatch.setattr(engine_model, "prefill_chunk_step", spy)
        eng = _engine()
        prompt = LONG_PROMPT[:150]  # tail 6
        req = eng.submit(GenRequest(prompt_ids=prompt, max_new_tokens=2))
        _run_to_idle(eng, max_steps=200)
        assert _ids(req) == _jax_greedy(prompt, 2)
        assert widths == [16] * 9 + [8], widths

    def test_staging_buffers_reused_per_width(self):
        eng = _engine()
        first = eng._chunk_buf(16)
        first[0, :3] = [1, 2, 3]
        again = eng._chunk_buf(16)
        assert again is first  # reused ...
        assert not again.any()  # ... and zeroed
        assert eng._chunk_buf(8) is not first
        assert set(eng._chunk_staging) == {8, 16}


class TestUnfusedFinish:
    """engine.fused_sampling off: every finish whose last chunk did not
    sample goes through sample_token + set_last_token. Greedy streams are
    byte-identical to fused_sampling on; fused_sample_dispatches stays 0
    and counts, with it on, only the chunk-tail and commit finishes."""

    def _streams(self, fused_sampling, prompts, **kw):
        eng = _engine(fused_sampling=fused_sampling, **kw)
        reqs = [eng.submit(GenRequest(prompt_ids=p, max_new_tokens=n))
                for p, n in prompts]
        _run_to_idle(eng)
        return [_ids(r) for r in reqs], eng.metrics.snapshot()

    def test_bucketed_only_traffic_counts_nothing(self):
        prompts = [([5, 6, 7], 6), (LONG_PROMPT[:12], 5)]
        on, m_on = self._streams(True, prompts)
        off, m_off = self._streams(False, prompts)
        assert on == off
        assert on[0] == _jax_greedy([5, 6, 7], 6)
        assert m_on["fused_sample_dispatches"] == 0
        assert m_off["fused_sample_dispatches"] == 0

    def test_chunked_finish(self):
        prompts = [(LONG_PROMPT[:40], 5)]
        on, m_on = self._streams(True, prompts)
        off, m_off = self._streams(False, prompts)
        assert on == off == [_jax_greedy(LONG_PROMPT[:40], 5)]
        assert m_on["fused_sample_dispatches"] == 1
        assert m_off["fused_sample_dispatches"] == 0

    def test_rider_finish(self):
        _, l_on, m_on = _inline(True)
        _, l_off, m_off = _inline(True, fused_sampling=False)
        assert l_on == l_off
        assert m_on["fused_sample_dispatches"] == 1
        assert m_off["fused_sample_dispatches"] == 0

    def test_prefix_hit_finish(self):
        base = LONG_PROMPT[:30]
        hit_p = base[:28] + [11, 12]
        runs = {}
        for fs in (True, False):
            eng = _engine(fused_sampling=fs, prefix_cache=True,
                          prefill_buckets=(16, 32))
            first = eng.submit(GenRequest(prompt_ids=base, max_new_tokens=3))
            _run_to_idle(eng)
            hit = eng.submit(GenRequest(prompt_ids=hit_p, max_new_tokens=5))
            _run_to_idle(eng)
            runs[fs] = (_ids(first), _ids(hit), eng.metrics.snapshot())
        assert runs[True][:2] == runs[False][:2]
        assert runs[True][1] == _jax_greedy(hit_p, 5)
        assert runs[True][2]["prefix_hits"] == runs[False][2]["prefix_hits"] \
            == 1
        assert runs[True][2]["fused_sample_dispatches"] == 1
        assert runs[False][2]["fused_sample_dispatches"] == 0

    def test_sampled_finish_draws_inside_the_mask(self):
        """A sampled request through the unfused finish: its first token
        lies in the top-k set of the prompt's last logits."""
        prompt = LONG_PROMPT[:40]
        logits = np.asarray(jl.forward(
            JPARAMS, JCFG, jnp.asarray([prompt], jnp.int32),
            use_pallas=False)[0])[0, -1]
        top3 = set(np.argsort(logits)[-3:].tolist())
        for fs in (True, False):
            eng = _engine(fused_sampling=fs)
            req = eng.submit(GenRequest(prompt_ids=prompt, max_new_tokens=1,
                                        temperature=1.5, top_k=3))
            _run_to_idle(eng)
            assert _ids(req)[0] in top3
