"""Port parity: serving/engine.py and serving/openai_server.py.

Both engines serve the same tiny f32 Llama (JAX weights carried across
with the converter; vocabulary 259 so the byte tokenizer's <eos> can be
sampled) at the same engine config. Greedy event streams, submitted
from several threads at once, must be identical event for event: token
ids, text, finish flags and reasons. The JAX engine runs with emission
pacing off (`pace_emission_max_streams=0`): the port has no pacer, and
the JAX pacer can deliver a block's tokens ahead of the previous block's
still-paced ones when blocks start landing fast (`_pace_commit`'s
fast path does not flush the pending entry), which reorders a stream.
The port's OpenAI server then answers on the CPU over the standard
library's HTTP server.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.config.schema import EngineConfig as JConfig
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.serving.engine import LLMEngine as JEngine
from generativeaiexamples_tpu.serving.openai_server import StopStream as JStop
from generativeaiexamples_tpu.utils.tokenizer import ByteTokenizer as JTok
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.serving import openai_server as tos
from generativeaiexamples_tpu_torch.serving.engine import (
    GenRequest, LLMEngine, PromptTooLongError)
from generativeaiexamples_tpu_torch.utils.tokenizer import (
    ByteTokenizer, StreamDetokenizer)

ECFG = dict(max_batch_size=4, max_seq_len=64, page_size=8,
            prefill_buckets=(16, 32))
PROMPTS = [[257, 10, 11, 12, 13, 14], list(range(40, 60)), [257] + list(
    b"hello"), list(range(100, 125)), [257] + list("héllo ✓".encode()),
    [7] * 31]


@pytest.fixture(scope="module")
def engines():
    jcfg = jl.LlamaConfig.tiny(vocab_size=259)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.llama_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    jeng = JEngine(jparams, jcfg, JTok(),
                   JConfig(**ECFG, pace_emission_max_streams=0),
                   use_pallas=False).start()
    teng = LLMEngine(tparams, tl.LlamaConfig.tiny(vocab_size=259),
                     ByteTokenizer(), ECFG, device="cpu").start()
    yield jeng, teng
    jeng.stop()
    teng.stop()


def _threaded_streams(engine, prompts, max_new_tokens):
    out = [None] * len(prompts)

    def run(i):
        out[i] = list(engine.generate_stream(prompts[i],
                                             max_new_tokens=max_new_tokens))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    return out


def test_threaded_greedy_streams_identical_to_jax(engines):
    """Six concurrent requests over four slots: admission waits, batched
    prefill groups and multi-step decode blocks all take part."""
    jeng, teng = engines
    want = _threaded_streams(jeng, PROMPTS, 20)
    got = _threaded_streams(teng, PROMPTS, 20)
    assert got == want
    assert all(ev[-1]["finished"] for ev in got)


def test_sequential_streams_and_generate_identical_to_jax(engines):
    jeng, teng = engines
    for p in PROMPTS[:3]:
        assert list(teng.generate_stream(p, max_new_tokens=9)) == list(
            jeng.generate_stream(p, max_new_tokens=9))
    assert teng.generate(PROMPTS[4], max_new_tokens=12) == jeng.generate(
        PROMPTS[4], max_new_tokens=12)


def test_metrics_snapshot_keys_always_present(engines):
    _, teng = engines
    snap = teng.metrics.snapshot()
    for key in ("ttft_p50_ms", "ttft_p95_ms", "tokens_generated",
                "decode_steps", "mean_batch_occupancy", "tokens_per_sec",
                "prefill_tokens", "fused_sample_dispatches",
                "admission_failures", "kernel_launches_flash_attention",
                "kernel_launches_paged_attention"):
        assert key in snap, key
    # The plain versions serve the CPU: no kernel was launched.
    assert snap["kernel_launches_paged_attention"] == 0


def test_prompt_longer_than_largest_bucket_is_refused(engines):
    """Beyond the largest bucket a prompt takes chunked prefill
    (tests/test_torch_chunked_prefill.py); it is refused once it also
    passes the page capacity minus one generated token, here on an
    engine whose capacity (31) sits below its largest bucket (32)."""
    cfg = tl.LlamaConfig.tiny()
    small = LLMEngine(tl.init_params(cfg, "cpu"), cfg, ByteTokenizer(),
                      {**ECFG, "max_seq_len": 32}, device="cpu")
    with pytest.raises(PromptTooLongError, match="page capacity"):
        small.submit(GenRequest(prompt_ids=[5] * 33))


@pytest.mark.parametrize("flag,value,beside", [
    # Multi-host tensor-parallel serving is ported (A.17): without rank
    # processes (a process group spanning more than one) the engine
    # refuses the flag at build, before any allocation, whatever it is
    # beside; speculation, step plans and the fused rider beside it are
    # refused by validate_multihost_profile (tests/test_torch_multihost.py).
    pytest.param("multihost", True, {
        "fused_prefill": True, "step_plans": True, "speculative_k": 2,
        "qos": True, "auto_pool_pages": True}, id="fused_prefill-True"),
    pytest.param("multihost", True, {"prefix_cache": True,
                                     "kv_pager": True}, id="kv_pager-True"),
    pytest.param("multihost", True, {"prefix_cache": True, "qos": True},
                 id="prefix_cache-True"),
    pytest.param("multihost", True, {}, id="multihost-True"),
    pytest.param("multihost", True, {"step_plans": True,
                                     "pace_emission_max_streams": 4},
                 id="step_plans-True")])
def test_unported_engine_flags_are_refused(flag, value, beside):
    from generativeaiexamples_tpu_torch.serving.multihost import (
        MultihostError)

    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, "cpu")
    match = "engine.multihost=true but the process group spans 1 process"
    with pytest.raises(MultihostError, match=match):
        LLMEngine(params, cfg, ByteTokenizer(),
                  {**ECFG, **beside, flag: value}, device="cpu")
    with pytest.raises(MultihostError, match=match):
        LLMEngine(params, cfg, ByteTokenizer(),
                  JConfig(**{**ECFG, **beside, flag: value}), device="cpu")


def test_tokenizer_copy_matches_jax():
    from generativeaiexamples_tpu.utils.tokenizer import (
        StreamDetokenizer as JDetok)

    t, j = ByteTokenizer(), JTok()
    msgs = [{"role": "user", "content": "hé ✓"}]
    assert t.apply_chat_template(msgs) == j.apply_chat_template(msgs)
    ids = t.encode("hé ✓ x", add_bos=True)
    assert ids == j.encode("hé ✓ x", add_bos=True)
    td, jd = StreamDetokenizer(t), JDetok(j)
    assert [td.push(i) for i in ids * 3] == [jd.push(i) for i in ids * 3]
    assert (t.eos_ids, t.vocab_size) == (j.eos_ids, j.vocab_size)


@pytest.mark.parametrize("stops,pieces", [
    (["END"], ["ab", "cE", "N", "Dxyz"]),
    (["zz", "q"], ["az", "bz", "zq"]),
    (["xyz"], ["x", "y", "w"]),
])
def test_stop_stream_matches_jax(stops, pieces):
    t, j = tos.StopStream(stops), JStop(stops)
    assert [t.push(p) for p in pieces] == [j.push(p) for p in pieces]
    assert t.flush() == j.flush()


@pytest.fixture(scope="module")
def server(engines):
    jeng, teng = engines
    httpd = tos.make_http_server(tos.OpenAIServer(teng, model_name="tiny"),
                                 "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", jeng
    httpd.shutdown()
    httpd.server_close()
    th.join(timeout=10)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=60)


def _chat_ids(messages):
    return ByteTokenizer().encode(
        ByteTokenizer().apply_chat_template(messages), add_bos=False)


def test_server_chat_completion_non_streaming(server):
    base, jeng = server
    msgs = [{"role": "user", "content": "Hi there"}]
    with _post(base + "/v1/chat/completions",
               {"messages": msgs, "max_tokens": 10}) as r:
        body = json.loads(r.read())
    assert body["object"] == "chat.completion"
    choice = body["choices"][0]
    want = list(jeng.generate_stream(_chat_ids(msgs), max_new_tokens=10))
    assert choice["message"] == {"role": "assistant", "content": "".join(
        e["text"] for e in want)}
    assert choice["finish_reason"] == want[-1]["finish_reason"]
    n = sum(e["token_id"] >= 0 for e in want)
    assert body["usage"] == {"prompt_tokens": len(_chat_ids(msgs)),
                             "completion_tokens": n,
                             "total_tokens": len(_chat_ids(msgs)) + n}


def test_server_chat_completion_streaming(server):
    base, jeng = server
    msgs = [{"role": "user", "content": "Stream"}]
    chunks, done = [], False
    with _post(base + "/v1/chat/completions",
               {"messages": msgs, "max_tokens": 12, "stream": True}) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        for raw in r:
            line = raw.decode().strip()
            if line == "data: [DONE]":
                done = True
            elif line.startswith("data: "):
                chunks.append(json.loads(line[6:]))
    assert done and chunks
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks)
    want = list(jeng.generate_stream(_chat_ids(msgs), max_new_tokens=12))
    assert text == "".join(e["text"] for e in want)
    assert chunks[-1]["choices"][0]["finish_reason"] == want[-1][
        "finish_reason"]


def test_server_completion_and_side_routes(server):
    base, _ = server
    with _post(base + "/v1/completions",
               {"prompt": [257, 65, 66], "max_tokens": 4}) as r:
        body = json.loads(r.read())
    assert body["object"] == "text_completion"
    assert body["usage"]["prompt_tokens"] == 3
    with urllib.request.urlopen(base + "/health", timeout=30) as r:
        health = json.loads(r.read())
    assert health["status"] == "healthy" and health["device"] == "cpu"
    assert health["engines"]["llm"] is True
    with urllib.request.urlopen(base + "/v1/models", timeout=30) as r:
        assert json.loads(r.read())["data"][0]["id"] == "tiny"
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        assert "tokens_generated" in json.loads(r.read())
    for path, body, status in (
            ("/v1/embeddings", {"input": ["x"]}, 503),
            ("/v1/completions", {"prompt": [5] * 64}, 422)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + path, body)
        assert e.value.code == status


_ORACLE = {}


def _oracle(jcfg, jparams, prompt, n_new):
    """Offline JAX greedy continuation (no JAX LLMEngine), cut after the
    first <eos> as the engine ends the stream there."""
    import jax.numpy as jnp

    key = (tuple(prompt), n_new)
    if key not in _ORACLE:
        out = jl.greedy_generate(jparams, jcfg, jnp.asarray([prompt],
                                                            jnp.int32),
                                 n_new, use_pallas=False)
        toks = np.asarray(out)[0, len(prompt):].tolist()
        eos = ByteTokenizer().eos_id
        _ORACLE[key] = toks[:toks.index(eos) + 1] if eos in toks else toks
    return _ORACLE[key]


@pytest.mark.parametrize("cap", [2, 0])
def test_decode_k_capped_while_a_chunked_prefill_is_live(monkeypatch, cap):
    """engine.prefill_decode_k_cap (the JAX rule that
    tests/test_serving.py::TestPrefillPriorityLane pins): while a chunked
    prefill is in progress beside decoding streams, every decode block
    takes at most `cap` steps; at 0 there is no cap, and K=8 blocks run
    between the chunks. Two of four slots decoding stay above the
    low-occupancy cap, so only this rule caps K. Either way the greedy
    streams equal the same requests run alone (the cap changes when
    tokens come, never which), and the long prompt's the offline
    oracle's."""
    from generativeaiexamples_tpu_torch.serving import engine_model as tem

    jcfg = jl.LlamaConfig.tiny(vocab_size=259)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = convert.llama_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    eng = LLMEngine(tparams, tl.LlamaConfig.tiny(vocab_size=259),
                    ByteTokenizer(), dict(
                        max_batch_size=4, max_seq_len=256, page_size=8,
                        prefill_buckets=(16,), decode_steps_per_dispatch=8,
                        prefill_chunks_per_block=1,
                        prefill_decode_k_cap=cap), device="cpu")
    assert eng.ecfg.prefill_decode_k_cap == cap
    log = []
    real = tem.decode_multi_step

    def spy(*args, **kw):
        log.append((args[11], bool(eng._long_prefills)))
        return real(*args, **kw)

    monkeypatch.setattr(tem, "decode_multi_step", spy)
    shorts = [[5, 6, 7], [9, 10, 11, 12]]
    long_prompt = [(i * 7) % 256 for i in range(160)]  # 10 chunks of 16
    got = {}
    eng.start()
    try:
        def run(p, n):
            got[tuple(p)] = [e["token_id"] for e in eng.generate_stream(
                p, max_new_tokens=n) if e["token_id"] >= 0]

        for p in shorts:
            run(p, 60)
        alone = dict(got)
        log.clear()
        threads = [threading.Thread(target=run, args=(p, 60))
                   for p in shorts]
        for t in threads:
            t.start()
        while eng.metrics.tokens_out < 8:
            time.sleep(0.001)
        run(long_prompt, 4)
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        eng.stop()
    live = [k for k, lv in log if lv]
    assert live, log
    if cap:
        assert max(live) <= cap, log
    else:
        assert max(live) > 2, log
    for p in shorts:
        assert got[tuple(p)] == alone[tuple(p)]
        assert len(alone[tuple(p)]) == 60
    assert got[tuple(long_prompt)] == _oracle(jcfg, jparams, long_prompt, 4)
