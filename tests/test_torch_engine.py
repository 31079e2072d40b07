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


@pytest.mark.parametrize("flag,value", [
    ("fused_prefill", True), ("kv_pager", True),
    ("prefix_cache", True), ("multihost", True), ("step_plans", True)])
def test_unported_engine_flags_are_refused(flag, value):
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, "cpu")
    with pytest.raises(ValueError, match="ROADMAP A"):
        LLMEngine(params, cfg, ByteTokenizer(), {**ECFG, flag: value},
                  device="cpu")
    with pytest.raises(ValueError, match="ROADMAP A"):
        LLMEngine(params, cfg, ByteTokenizer(),
                  JConfig(**{**ECFG, flag: value}), device="cpu")


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
