"""Port parity: the engine's emission pacer (serving/engine.py).

The JAX package's tests/test_serving.py TestEmissionPacing cases on the
port's engine: a committed burst reaches the consumer spaced and in
order, a terminal event flushes the held tokens first, streams above
`pace_emission_max_streams` are never paced, and stop() flushes what the
pacer holds. The fast path (blocks landing less than 4 ms a token apart)
delivers a burst directly; the port flushes the slot's pending entry
first, so a burst never overtakes the one before it. The JAX pacer's
fast path does not (`_pace_commit`, run here unbound on a stand-in
object, so no JAX engine is built): the reference fault is pinned beside
the port's fix. End to end on the tiny f32 model, with block intervals
stretched and shrunk while streams run (the chaos beat delay), four
paced streams equal the unpaced engine's and the offline JAX greedy
oracle token for token, and the limit is read at every block.
"""

import dataclasses
import queue
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.serving import engine as jeng_mod
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.serving import engine as teng_mod
from generativeaiexamples_tpu_torch.serving.engine import (
    GenRequest, LLMEngine)
from generativeaiexamples_tpu_torch.serving.kv_cache import SequencePages
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

VOCAB = 259
ECFG = dict(max_batch_size=4, max_seq_len=64, page_size=8,
            prefill_buckets=(16,), decode_steps_per_dispatch=8,
            kv_dtype="float32")


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(vocab_size=VOCAB)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    tparams = convert.llama_params_from_numpy(np_tree, "cpu", torch.float32)
    return jcfg, jparams, tl.LlamaConfig.tiny(vocab_size=VOCAB), tparams


def _engine(models, **kw):
    _, _, tcfg, tparams = models
    return LLMEngine(tparams, tcfg, ByteTokenizer(), {**ECFG, **kw},
                     device="cpu")


def _slot(eng, req):
    seq = SequencePages(eng.allocator, eng.pool.page_size, eng.max_pages)
    return teng_mod._Slot(req, seq, None)


def _evs(ids):
    return [{"text": str(j), "token_id": j, "finished": False,
             "finish_reason": None} for j in ids]


def test_default_limit_is_jax_default():
    from generativeaiexamples_tpu.config.schema import EngineConfig as JC

    from generativeaiexamples_tpu_torch.config.schema import EngineConfig
    assert EngineConfig().pace_emission_max_streams == \
        JC().pace_emission_max_streams == 16


def test_paced_burst_is_spaced_and_ordered(models):
    eng = _engine(models).start()
    try:
        req = GenRequest(prompt_ids=[1, 2], max_new_tokens=99)
        slot = _slot(eng, req)
        slot.pace_buf = _evs(range(4))
        slot.pace_last_land = time.perf_counter() - 0.2  # 50 ms a token
        eng._pace_commit(slot, time.perf_counter())
        got, times = [], []
        for _ in range(4):
            got.append(req.stream.get(timeout=5))
            times.append(time.perf_counter())
        assert [e["token_id"] for e in got] == [0, 1, 2, 3]
        gaps = [b - a for a, b in zip(times, times[1:])]
        assert sum(1 for g in gaps if g >= 0.02) >= 2, gaps
    finally:
        eng.stop()


def test_terminal_event_flushes_pending_tokens_in_order(models):
    eng = _engine(models).start()
    try:
        req = GenRequest(prompt_ids=[1, 2], max_new_tokens=99)
        slot = _slot(eng, req)
        slot.pace_buf = _evs([7])
        slot.pace_last_land = time.perf_counter() - 4.0  # slow pace
        eng._pace_commit(slot, time.perf_counter())
        eng.slots[0] = slot
        eng._finish(0, "cancelled")
        t0 = time.perf_counter()
        first = req.stream.get(timeout=2)
        term = req.stream.get(timeout=2)
        assert first["token_id"] == 7
        assert term["finished"] and term["finish_reason"] == "cancelled"
        assert time.perf_counter() - t0 < 1.0
    finally:
        eng.stop()


def test_streams_above_threshold_not_paced(models):
    eng = _engine(models, pace_emission_max_streams=1).start()
    try:
        entries_seen, results = [], {}

        def run(i):
            results[i] = [e["token_id"] for e in eng.generate_stream(
                [i + 1, 2, 3], max_new_tokens=12) if e["token_id"] >= 0]
            with eng._pace_lock:
                entries_seen.append(dict(eng._pace_entries))

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(len(v) == 12 for v in results.values())
        assert all(not e for e in entries_seen)
    finally:
        eng.stop()


def test_stop_flushes_paced_tokens(models):
    eng = _engine(models).start()
    req = GenRequest(prompt_ids=[1, 2], max_new_tokens=99)
    slot = _slot(eng, req)
    slot.pace_buf = _evs([9])
    slot.pace_last_land = time.perf_counter() - 8.0
    eng._pace_commit(slot, time.perf_counter())
    eng.stop()
    assert req.stream.get(timeout=2)["token_id"] == 9


def test_pacer_thread_only_with_a_limit(models):
    eng = _engine(models, pace_emission_max_streams=0).start()
    try:
        assert eng._pace_thread is None
    finally:
        eng.stop()
    eng = _engine(models).start()
    try:
        assert eng._pace_thread.is_alive()
    finally:
        eng.stop()
    assert eng._pace_thread is None


def _drain(q):
    out = []
    while True:
        try:
            out.append(q.get_nowait()["token_id"])
        except queue.Empty:
            return out


def test_fast_path_flushes_the_pending_entry_first(models):
    """A slow block's burst is still held by the pacer when the next
    block lands fast (the fast path): the older tokens go out first."""
    eng = _engine(models)  # not started: the held entry stays held
    req = GenRequest(prompt_ids=[1, 2], max_new_tokens=99)
    slot = _slot(eng, req)
    slot.pace_buf = _evs([0, 1, 2, 3])
    slot.pace_last_land = time.perf_counter() - 4.0  # 100 ms a token
    now = time.perf_counter()
    eng._pace_commit(slot, now)
    assert id(slot) in eng._pace_entries and req.stream.empty()
    slot.pace_buf = _evs([4, 5, 6, 7])
    eng._pace_commit(slot, now + 0.001)  # 0.25 ms a token: fast path
    assert _drain(req.stream) == list(range(8))
    assert not eng._pace_entries and not slot.pace_buf


class _JaxPacerStandIn:
    """What JAX's `_pace_commit` touches on its engine, without one."""

    def __init__(self):
        self._pace_lock = threading.Lock()
        self._pace_entries = {}
        self._pace_wake = threading.Event()


class _JaxSlot:
    def __init__(self):
        self.req = GenRequest(prompt_ids=[1, 2])
        self.pace_buf = []
        self.pace_last_land = 0.0


def test_jax_fast_path_reorders_a_stream():
    """The reference fault the port does not copy: JAX's fast path puts
    the new burst on the stream while the pending entry still holds the
    older tokens."""
    eng, slot = _JaxPacerStandIn(), _JaxSlot()
    commit = jeng_mod.LLMEngine._pace_commit
    slot.pace_buf = _evs([0, 1, 2, 3])
    slot.pace_last_land = time.perf_counter() - 4.0
    now = time.perf_counter()
    commit(eng, slot, now)
    slot.pace_buf = _evs([4, 5, 6, 7])
    commit(eng, slot, now + 0.001)
    # The newer burst is delivered; the older one is still held.
    assert _drain(slot.req.stream) == [4, 5, 6, 7]
    assert list(e["token_id"] for e in eng._pace_entries[id(slot)]["buf"]) \
        == [0, 1, 2, 3]


def test_first_token_is_never_paced(models):
    eng = _engine(models)
    req = GenRequest(prompt_ids=[1, 2], max_new_tokens=99)
    slot = _slot(eng, req)
    eng._pace_engaged = True
    slot.generated = 1
    eng._stream_put(slot, _evs([3])[0])
    assert _drain(req.stream) == [3]
    slot.generated = 2
    eng._stream_put(slot, _evs([4])[0])
    assert _drain(req.stream) == [] and len(slot.pace_buf) == 1
    # A terminal event flushes the held one first.
    eng._stream_put(slot, {"text": "", "token_id": 5, "finished": True,
                           "finish_reason": "stop"})
    assert _drain(req.stream) == [4, 5]


def _greedy(models, prompt, n_new):
    jcfg, jparams = models[:2]
    out = jl.greedy_generate(jparams, jcfg, jnp.asarray([prompt], jnp.int32),
                             n_new, use_pallas=False)
    toks = np.asarray(out)[0, len(prompt):].tolist()
    eos = ByteTokenizer().eos_id
    return toks[:toks.index(eos) + 1] if eos in toks else toks


def _run_streams(eng, prompts, n_new):
    """Each prompt's token ids and arrival times, all streams at once."""
    out = [None] * len(prompts)

    def run(i):
        toks, times = [], []
        for ev in eng.generate_stream(prompts[i], max_new_tokens=n_new):
            times.append(time.perf_counter())
            if ev["token_id"] >= 0:
                toks.append(ev["token_id"])
        out[i] = (toks, times)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return out


def test_paced_streams_equal_unpaced_and_greedy(models):
    """Blocks are stretched (a 40 ms beat delay) and then shrunk (none)
    while four streams run, so bursts go through both the paced path and
    the fast path with entries pending. Every stream equals the unpaced
    run and the greedy oracle."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 256, 5 + 2 * i).tolist() for i in range(4)]
    n_new = 40
    eng = _engine(models).start()
    commits = []
    real_commit = eng._pace_commit

    def spy(slot, now):
        commits.append(len(slot.pace_buf))
        real_commit(slot, now)

    eng._pace_commit = spy
    stop = threading.Event()

    def wobble():
        while not stop.is_set():
            eng.chaos_beat_delay_s = 0.04
            time.sleep(0.15)
            eng.chaos_beat_delay_s = 0.0
            time.sleep(0.05)

    th = threading.Thread(target=wobble, daemon=True)
    th.start()
    try:
        paced = _run_streams(eng, prompts, n_new)
        n_paced_commits = sum(1 for n in commits if n)
        # The same engine with the limit at 0: read at the next block.
        eng.ecfg = dataclasses.replace(eng.ecfg, pace_emission_max_streams=0)
        commits.clear()
        unpaced = _run_streams(eng, prompts, n_new)
    finally:
        stop.set()
        th.join(timeout=5)
        eng.stop()
    want = [_greedy(models, p, n_new) for p in prompts]
    assert [t for t, _ in paced] == want
    assert [t for t, _ in unpaced] == want
    assert n_paced_commits > 0 and not commits


def test_paced_tokens_arrive_spread(models):
    """At a steady 80 ms beat four streams' 8-token blocks arrive spread
    over the interval with pacing on, and together with it off."""
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, 256, 6 + i).tolist() for i in range(4)]
    together = {}
    for limit in (16, 0):
        eng = _engine(models, pace_emission_max_streams=limit).start()
        eng.chaos_beat_delay_s = 0.08
        try:
            runs = _run_streams(eng, prompts, 40)
        finally:
            eng.stop()
        # Gaps between decode tokens (the first token is never paced).
        gaps = [b - a for _, times in runs
                for a, b in zip(times[1:], times[2:])]
        together[limit] = sum(1 for g in gaps if g < 0.001) / len(gaps)
    assert together[16] < 0.7 * together[0], together


def test_pacing_keeps_order_beside_speculation(models):
    """A speculative engine paces its verify bursts the same way; the
    stream stays equal to the greedy oracle."""
    prompt = [9, 8, 7, 6, 5, 9, 8, 7, 6, 5]
    eng = _engine(models, speculative_k=2).start()
    eng.chaos_beat_delay_s = 0.03
    try:
        toks = [ev["token_id"] for ev in eng.generate_stream(
            prompt, max_new_tokens=30) if ev["token_id"] >= 0]
    finally:
        eng.stop()
    assert toks == _greedy(models, prompt, 30)
