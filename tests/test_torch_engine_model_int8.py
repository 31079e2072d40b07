"""Port parity: the int8 serving path (weight-only int8 Llama, the fused
int8 KV pool) -- serving/engine_model.py's int8 branches against the JAX
package's jitted steps on its QuantPagePool, and the port's int8
LLMEngine against an offline JAX oracle built from those steps.

Tiny f32 Llama quantized by the JAX package and carried across with the
converter, the same page tables on both sides. Pool codes must be
bit-identical and greedy tokens identical; logits within f32 atol 1e-4
(tests/test_llama.py's tolerance). Scales within rtol 1e-5: quantize_kv
is bit-identical on identical inputs (test_torch_paged_attention_int8),
but XLA's and torch's f32 matmuls sum in different orders, so a k or v
row can differ in its last bit, and its amax / 127 scale with it (a few
ulps, ~1e-7 relative). Sink page 0 is left out of pool comparisons:
every padding position is scattered into it, in an unspecified order.
No JAX `LLMEngine` is built (the JAX suite's engine state is order
dependent within a process, ROADMAP).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.ops import quant as jq
from generativeaiexamples_tpu.serving import engine_model as jem
from generativeaiexamples_tpu.serving.kv_cache import QuantPagePool as JQPool
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.ops import quant as tq
from generativeaiexamples_tpu_torch.serving import engine_model as tem
from generativeaiexamples_tpu_torch.serving.engine import LLMEngine, _pow2_ceil
from generativeaiexamples_tpu_torch.serving.kv_cache import (
    PagePool, QuantPagePool)
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

ATOL = 1e-4
SCALE_RTOL = 1e-5
PS, N_PAGES, MAXP, BUCKET = 8, 24, 6, 16
VOCAB = 259  # the byte tokenizer's <eos> can be sampled
ECFG = dict(max_batch_size=4, max_seq_len=64, page_size=8,
            prefill_buckets=(16, 32), kv_dtype="int8",
            quantize_weights="int8")


@pytest.fixture(scope="module")
def model():
    jcfg = jl.LlamaConfig.tiny(vocab_size=VOCAB)
    jparams = jq.quantize_llama_params(
        jl.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = convert.llama_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jcfg, jparams, tl.LlamaConfig.tiny(vocab_size=VOCAB), tparams


def _pools(jcfg, tcfg, n_pages=N_PAGES):
    return (JQPool.zeros(jcfg, n_pages, PS),
            PagePool.zeros(tcfg, n_pages, PS, dtype=torch.int8,
                           device="cpu"))


def _assert_pools_equal(jpool, tpool):
    np.testing.assert_array_equal(tpool.kv.numpy()[:, :, :, 1:],
                                  np.asarray(jpool.kv)[:, :, :, 1:])
    np.testing.assert_allclose(tpool.s.numpy()[:, :, :, 1:],
                               np.asarray(jpool.s)[:, :, :, 1:],
                               rtol=SCALE_RTOL, atol=0)


def _prefill_inputs(vocab):
    """Two prompts (lengths 11 and 5) plus one padding row, bucket 16."""
    rng = np.random.default_rng(0)
    tokens = np.zeros((4, BUCKET), np.int32)
    lengths = np.ones((4,), np.int32)
    rows = np.zeros((4, BUCKET // PS), np.int32)
    for j, (n, pages) in enumerate(((11, [3, 7]), (5, [2]))):
        tokens[j, :n] = rng.integers(0, vocab, n)
        lengths[j] = n
        rows[j, :len(pages)] = pages
    return tokens, lengths, rows


def _greedy(n):
    return (np.zeros((n,), np.float32), np.ones((n,), np.float32),
            np.zeros((n,), np.int32))


def test_quant_pool_layout_and_device():
    cfg = tl.LlamaConfig.tiny()
    pool = PagePool.zeros(cfg, 5, PS, dtype=torch.int8, device="cpu")
    assert isinstance(pool, QuantPagePool) and pool.quantized
    assert not PagePool.zeros(cfg, 5, PS, device="cpu").quantized
    assert pool.kv.shape == (2, cfg.n_layers, cfg.n_kv_heads, 5, PS,
                             cfg.head_dim)
    assert pool.s.shape == pool.kv.shape[:-1] and pool.n_pages == 5
    assert (pool.kv.dtype, pool.s.dtype) == (torch.int8, torch.float32)
    assert pool.nbytes == pool.kv.numel() + 4 * pool.s.numel()
    jpool = JQPool.zeros(jl.LlamaConfig.tiny(), 5, PS)
    assert pool.kv.shape == jpool.kv.shape and pool.s.shape == jpool.s.shape


def test_prefill_batch_then_decode_multi_step_match_jax(model):
    """Batched prefill sampling the first tokens, then two K=4 greedy
    decode blocks chained on the device with one inactive slot; codes
    and scales of every written page after each step."""
    jcfg, jparams, tcfg, tparams = model
    jpool, tpool = _pools(jcfg, tcfg)
    tokens, lengths, rows = _prefill_inputs(VOCAB)
    temps, top_ps, top_ks = _greedy(4)
    jfirst, jpool = jem.prefill_batch_step(
        jparams, jcfg, jpool, jnp.asarray(tokens), jnp.asarray(lengths),
        jnp.asarray(rows), jnp.asarray(temps), jnp.asarray(top_ps),
        jnp.asarray(top_ks), jax.random.PRNGKey(0), False,
        sampling_flags=(True, False, False))
    tfirst = tem.prefill_batch_step(
        tparams, tcfg, tpool, *(torch.from_numpy(a) for a in (
            tokens, lengths, rows, temps, top_ps, top_ks)),
        None, sampling_flags=(True, False, False))
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    _assert_pools_equal(jpool, tpool)

    B = 4
    idxs = np.array([0, 2, B, B], np.int32)
    jlast = jem.set_last_tokens(jnp.zeros((B,), jnp.int32),
                                jnp.asarray(idxs), jfirst)
    tlast = tem.set_last_tokens(torch.zeros((B,), dtype=torch.int32), idxs,
                                tfirst)
    tables = np.zeros((B, MAXP), np.int32)
    tables[0, :3] = [3, 7, 9]
    tables[2, :2] = [2, 5]
    dec_len = np.array([12, 1, 6, 1], np.int32)
    active = np.array([True, False, True, False])
    temps, top_ps, top_ks = _greedy(B)
    for _ in range(2):
        jblock, jlast, jpool = jem.decode_multi_step(
            jparams, jcfg, jpool, jlast, jnp.asarray(tables),
            jnp.asarray(dec_len), jnp.asarray(active), jnp.asarray(temps),
            jnp.asarray(top_ps), jnp.asarray(top_ks), jax.random.PRNGKey(1),
            4, False, sampling_flags=(True, False, False))
        tblock, tlast = tem.decode_multi_step(
            tparams, tcfg, tpool, tlast, *(torch.from_numpy(a) for a in (
                tables, dec_len, active, temps, top_ps, top_ks)),
            None, 4, sampling_flags=(True, False, False))
        np.testing.assert_array_equal(tblock.numpy(), np.asarray(jblock))
        np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
        _assert_pools_equal(jpool, tpool)
        dec_len = np.where(active, dec_len + 4, dec_len).astype(np.int32)


def test_prefill_and_decode_step_logits_match_jax(model):
    jcfg, jparams, tcfg, tparams = model
    jpool, tpool = _pools(jcfg, tcfg)
    tokens, lengths, rows = _prefill_inputs(VOCAB)
    want, jpool = jem.prefill_step(
        jparams, jcfg, jpool, jnp.asarray(tokens[:1]),
        jnp.int32(lengths[0]), jnp.asarray(rows[0]), False)
    got = tem.prefill_step(tparams, tcfg, tpool, torch.from_numpy(tokens[:1]),
                           int(lengths[0]), torch.from_numpy(rows[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    table = np.array([[3, 7, 0, 0, 0, 0]], np.int32)
    for t, tok in enumerate((17, 42, 99, 250, 3)):
        n = np.array([12 + t], np.int32)
        want, jpool = jem.decode_step(jparams, jcfg, jpool,
                                      jnp.asarray([tok], jnp.int32),
                                      jnp.asarray(table), jnp.asarray(n),
                                      False)
        got = tem.decode_step(tparams, tcfg, tpool,
                              torch.tensor([tok], dtype=torch.int32),
                              torch.from_numpy(table), torch.from_numpy(n))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
    _assert_pools_equal(jpool, tpool)


def test_cache_to_pool_quantizes_like_jax(model):
    """The chunked lane's scratch cache (model dtype) scattered into the
    int8 pool: each row quantized on the way in."""
    jcfg, jparams, tcfg, tparams = model
    prompt = np.random.default_rng(7).integers(0, 256, 45).tolist()
    s_total, chunk = 64, 32
    jcache = jl.KVCache.zeros(jcfg, 1, max_len=s_total)
    tcache = tl.KVCache.zeros(tcfg, 1, max_len=s_total, device="cpu")
    for pos in range(0, len(prompt), chunk):
        part = prompt[pos:pos + chunk]
        tok = np.zeros((1, chunk), np.int32)
        tok[0, :len(part)] = part
        jlogits, jcache = jem.prefill_chunk_step(
            jparams, jcfg, jcache, jnp.asarray(tok), jnp.int32(len(part)),
            use_pallas=False)
        tlogits, tcache = tem.prefill_chunk_step(
            tparams, tcfg, tcache, torch.from_numpy(tok), len(part))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   atol=ATOL, rtol=0)
    row = np.array([3, 1, 4, 6, 2, 5, 0, 0], np.int32)  # 6 pages + sink
    jpool, tpool = _pools(jcfg, tcfg, n_pages=8)
    jpool = jem.cache_to_pool(jpool, jcache, jcfg, jnp.asarray(row))
    assert tem.cache_to_pool(tpool, tcache, tcfg,
                             torch.from_numpy(row)) is tpool
    _assert_pools_equal(jpool, tpool)


# -- the int8 engine against an offline JAX oracle --------------------------


def _oracle(model, prompt, n_new):
    """Offline greedy decode of one prompt through the JAX package's
    jitted int8 steps: prefill_step into a QuantPagePool (or, beyond the
    32 bucket, chunked prefill through a contiguous cache and
    cache_to_pool, the engine's chunk widths), then decode_step over the
    fused pool. Cut after the first <eos>, where the engine ends the
    stream."""
    jcfg, jparams, _, _ = model
    n = len(prompt)
    max_pages = ECFG["max_seq_len"] // PS
    pool = JQPool.zeros(jcfg, max_pages + 1, PS)
    table = np.arange(1, max_pages + 1, dtype=np.int32)
    if n <= 32:
        bucket = 16 if n <= 16 else 32
        tok = np.zeros((1, bucket), np.int32)
        tok[0, :n] = prompt
        logits, pool = jem.prefill_step(
            jparams, jcfg, pool, jnp.asarray(tok), jnp.int32(n),
            jnp.asarray(table[:bucket // PS]), False)
    else:
        s_total = -(-n // 32) * 32
        cache = jl.KVCache.zeros(jcfg, 1, max_len=s_total)
        for pos in range(0, n, 32):
            part = prompt[pos:pos + 32]
            # The width an unwarmed engine dispatches (_pick_chunk_width).
            tok = np.zeros((1, min(_pow2_ceil(len(part)), 32)), np.int32)
            tok[0, :len(part)] = part
            logits, cache = jem.prefill_chunk_step(
                jparams, jcfg, cache, jnp.asarray(tok), jnp.int32(len(part)),
                use_pallas=False)
        pool = jem.cache_to_pool(pool, cache, jcfg,
                                 jnp.asarray(table[:s_total // PS]))
    out = [int(np.argmax(np.asarray(logits)))]
    for t in range(n_new - 1):
        logits, pool = jem.decode_step(
            jparams, jcfg, pool, jnp.asarray([out[-1]], jnp.int32),
            jnp.asarray(table[None, :]), jnp.asarray([n + t + 1], jnp.int32),
            False)
        out.append(int(np.argmax(np.asarray(logits)[0])))
    eos = ByteTokenizer().eos_id
    return out[:out.index(eos) + 1] if eos in out else out


@pytest.fixture(scope="module")
def engine(model):
    _, _, tcfg, tparams = model
    eng = LLMEngine(tparams, tcfg, ByteTokenizer(), ECFG,
                    device="cpu").start()
    yield eng
    eng.stop()


def test_int8_engine_streams_equal_offline_jax_oracle(model, engine):
    """Five concurrent greedy requests over four slots (admission waits,
    batched prefill groups, K-step decode blocks over the int8 pool), one
    of them 45 tokens long: chunked prefill beyond the 32 bucket."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, n).tolist() for n in (6, 20, 45, 13, 30)]
    n_new = [12, 10, 9, 14, 8]
    got = [None] * len(prompts)

    def run(i):
        got[i] = [ev["token_id"] for ev in engine.generate_stream(
            prompts[i], max_new_tokens=n_new[i]) if ev["token_id"] >= 0]

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for i, p in enumerate(prompts):
        assert got[i] == _oracle(model, p, n_new[i]), i
    assert not engine._long_prefills and not engine._scratch_caches


def test_int8_flags_build_an_int8_engine(model):
    _, _, tcfg, tparams = model
    eng = LLMEngine(tparams, tcfg, ByteTokenizer(), ECFG, device="cpu")
    assert isinstance(eng.pool, QuantPagePool)
    # One sequence of slack over B x max_pages, plus the sink (JAX sizing).
    assert eng.pool.n_pages == 4 * 8 + 8 + 1
    assert eng._scratch_dtype == torch.float32
    plain = tl.init_params(tcfg, "cpu")
    with pytest.raises(ValueError, match="not quantized"):
        LLMEngine(plain, tcfg, ByteTokenizer(), ECFG, device="cpu")
    with pytest.raises(ValueError, match="are quantized"):
        LLMEngine(tparams, tcfg, ByteTokenizer(),
                  {**ECFG, "quantize_weights": "none"}, device="cpu")
    bf16_pool = LLMEngine(tq.quantize_llama_params(plain, "cpu"), tcfg,
                          ByteTokenizer(), {**ECFG, "kv_dtype": "float32"},
                          device="cpu")
    assert not bf16_pool.pool.quantized and bf16_pool.pool.n_pages == 33


def test_chain_hub_builds_the_configured_int8_engine(monkeypatch):
    """The chain server's EngineHub builds its LLM at `config.engine`, so
    APP_ENGINE_QUANTIZEWEIGHTS / APP_ENGINE_KVDTYPE reach it (it used the
    default engine config before the int8 path)."""
    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
    from generativeaiexamples_tpu_torch.serving import __main__ as launcher

    build = launcher.build_engine
    monkeypatch.setattr(launcher, "build_engine", lambda *a, **kw: build(
        *a, **{**kw, "warmup": False}))
    config = load_config(env={"APP_ENGINE_QUANTIZEWEIGHTS": "int8",
                              "APP_ENGINE_KVDTYPE": "int8",
                              "APP_ENGINE_MAXSEQLEN": "256"})
    eng = EngineHub(config, device="cpu", model_size="tiny").llm_engine()
    try:
        assert eng.pool.quantized and tq.is_quantized(eng.params)
        assert eng.ecfg.max_seq_len == 256
        assert eng.generate([257, 65, 66], max_new_tokens=3) is not None
    finally:
        eng.stop()
