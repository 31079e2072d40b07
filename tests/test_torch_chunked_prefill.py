"""Port parity: chunked long-prompt prefill (serving/engine_model.py's
chunk steps and serving/engine.py's long-prefill lane).

A prompt longer than the largest prefill bucket runs through a scratch
KVCache in bucket-wide chunks with offset queries, then one scatter moves
the cache into the page pool. The oracle is offline JAX: its
`greedy_generate` for the token streams (equality), and its
`prefill_chunk_step` / `cache_to_pool` for the per-chunk logits and the
pool pages (f32 atol 1e-4, the contract tolerance for f32 logits). No JAX
`LLMEngine` is built here: the JAX suite's chunked-prefill state is order
dependent within a process (ROADMAP), and an offline oracle does not stir
it.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.serving import engine_model as jem
from generativeaiexamples_tpu.serving.kv_cache import PagePool as JPool
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.serving import engine_model as tem
from generativeaiexamples_tpu_torch.serving.engine import (
    GenRequest, LLMEngine, PromptTooLongError)
from generativeaiexamples_tpu_torch.serving.kv_cache import PagePool
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

ATOL = 1e-4  # f32 logits (tests/test_llama.py's tolerance)
ECFG = dict(max_batch_size=4, max_seq_len=64, page_size=8,
            prefill_buckets=(16, 32))
VOCAB = 259


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(vocab_size=VOCAB)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = convert.llama_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jcfg, jparams, tl.LlamaConfig.tiny(vocab_size=VOCAB), tparams


@pytest.fixture(scope="module")
def engine(models):
    _, _, tcfg, tparams = models
    eng = LLMEngine(tparams, tcfg, ByteTokenizer(), ECFG,
                    device="cpu").start()
    yield eng
    eng.stop()


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n).tolist()


def _jax_greedy(models, prompt, n_new):
    """Offline greedy continuation, cut after the first <eos> (the
    engine ends the stream there; greedy_generate runs on)."""
    jcfg, jparams, _, _ = models
    out = jl.greedy_generate(jparams, jcfg, jnp.asarray([prompt], jnp.int32),
                             n_new, use_pallas=False)
    toks = np.asarray(out)[0, len(prompt):].tolist()
    eos = ByteTokenizer().eos_id
    return toks[:toks.index(eos) + 1] if eos in toks else toks


def _stream_ids(engine, prompt, n_new):
    return [ev["token_id"] for ev in engine.generate_stream(
        prompt, max_new_tokens=n_new) if ev["token_id"] >= 0]


@pytest.mark.parametrize("n", [33, 45, 63])
def test_long_prompt_stream_equals_offline_greedy(models, engine, n):
    """33 (one token past the 32 bucket), 45 (two chunks, a partial one
    of width 16) and 63 (page capacity minus one generated token)."""
    prompt = _prompt(n, seed=n)
    n_new = min(10, 64 - n)
    assert _stream_ids(engine, prompt, n_new) == _jax_greedy(
        models, prompt, n_new)


def test_long_prompt_while_other_streams_decode(models, engine):
    """Two short streams decode while a long prompt prefills chunk by
    chunk between their blocks; every stream equals offline greedy."""
    prompts = [_prompt(12, 1), _prompt(50, 2), _prompt(20, 3)]
    n_new = [14, 8, 14]
    got = [None] * 3

    def run(i):
        got[i] = _stream_ids(engine, prompts[i], n_new[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for i in range(3):
        assert got[i] == _jax_greedy(models, prompts[i], n_new[i]), i


def test_chunk_steps_and_cache_to_pool_match_jax(models):
    """Per-chunk last-token logits of prefill_chunk_step /
    prefill_chunk_sample_step, and the pool pages written by
    cache_to_pool, against the JAX steps on the same weights."""
    jcfg, jparams, tcfg, tparams = models
    prompt = _prompt(45, seed=7)
    chunk, ps, s_total = 32, 8, 64
    jcache = jl.KVCache.zeros(jcfg, 1, max_len=s_total)
    tcache = tl.KVCache.zeros(tcfg, 1, max_len=s_total, device="cpu")
    last = torch.zeros((4,), dtype=torch.int32)
    for pos in range(0, len(prompt), chunk):
        part = prompt[pos:pos + chunk]
        width = 32 if len(part) > 16 else 16
        tok = np.zeros((1, width), np.int32)
        tok[0, :len(part)] = part
        jlogits, jcache = jem.prefill_chunk_step(
            jparams, jcfg, jcache, jnp.asarray(tok), jnp.int32(len(part)),
            use_pallas=False)
        if pos + chunk < len(prompt):
            tlogits, tcache = tem.prefill_chunk_step(
                tparams, tcfg, tcache, torch.from_numpy(tok), len(part))
            np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                       atol=ATOL, rtol=0)
        else:
            tok0, last, tcache = tem.prefill_chunk_sample_step(
                tparams, tcfg, tcache, torch.from_numpy(tok), len(part),
                last, 2, 0.0, 1.0, 0)
            assert int(tok0[0]) == int(np.argmax(np.asarray(jlogits)))
            assert last.tolist() == [0, 0, int(tok0[0]), 0]
    assert tcache.lengths.tolist() == [len(prompt)] == np.asarray(
        jcache.lengths).tolist()
    row = np.array([3, 1, 4, 6, 2, 5, 0, 0], np.int32)  # 6 pages + sink
    jpool = jem.cache_to_pool(JPool.zeros(jcfg, 8, ps), jcache, jcfg,
                              jnp.asarray(row))
    tpool = tem.cache_to_pool(PagePool.zeros(tcfg, 8, ps, device="cpu"),
                              tcache, tcfg, torch.from_numpy(row))
    for name in ("k", "v"):
        want = np.asarray(getattr(jpool, name))[:, :, 1:]  # page 0: sink
        got = getattr(tpool, name).numpy()[:, :, 1:]
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_prompt_over_page_capacity_is_refused(engine):
    with pytest.raises(PromptTooLongError, match="page capacity"):
        engine.submit(GenRequest(prompt_ids=[5] * 64))
    req = GenRequest(prompt_ids=list(range(70)), truncate_prompt=True,
                     max_new_tokens=1)
    engine.submit(req)
    assert req.prompt_ids == list(range(7, 70))
    assert req.stream.get(timeout=60)["finished"]


def test_chunk_width_and_metrics(engine):
    # The engine was never warmed: any power-of-two width up to the chunk.
    assert [engine._pick_chunk_width(n, 32, 64)
            for n in (1, 13, 16, 17, 32)] == [1, 16, 16, 32, 32]
    before = engine.metrics.snapshot()
    _stream_ids(engine, _prompt(40, 9), 2)
    after = engine.metrics.snapshot()
    assert after["prefill_tokens"] - before["prefill_tokens"] == 40
    assert after["fused_sample_dispatches"] \
        - before["fused_sample_dispatches"] == 1
    assert not engine._long_prefills and not engine._scratch_caches
