"""Port parity: the prefill lattice's graph-ready forms
(serving/step_graphs.py), against the JAX package on the tiny f32 config.

- The admission scatters take the group's slot indices as a device
  vector and drop out-of-range rows on the device: `set_last_tokens` and
  `set_history_rows` equal JAX's mode="drop" scatters, padding index B
  included.
- The static scratch: chunks run in the first S_total rows of one
  full-length store (`engine_model.scratch_view`) full of an earlier
  prompt's values, with the valid count as a device tensor; their
  logits equal JAX's `prefill_chunk_step` within atol 1e-4, and logits
  and scratch rows equal a fresh S_total scratch's bit for bit. A hit's
  gather into the store (`pool_to_cache(out=)`) equals JAX's gather; the
  prompt-completing chunk's sample with device scalars equals the host
  form's.
- The packed inputs of a prefill group round-trip through
  `step_graphs.prefill_inputs`.
- A warmed engine over bucketed, chunked, prefix-hit and rider traffic:
  its lattice, its dispatched plans and its greedy streams equal the
  warmed JAX engine's (the JAX engine in a subprocess of its own,
  tests/_warm_trace.py, as in test_torch_warmup.py). On the CPU the
  port runs every step eagerly, through the same static scratch and
  device-index scatters its CUDA graphs hold.
- Chunks at the JAX engine's widths: a chunk whose padded rows pass the
  scratch view's end writes them to the store's sink row, and equals
  JAX's `prefill_chunk_step` (whose scatter drops them); the engine's
  plans over hits inside a bucket, an exact repeat and a long hit's last
  rider equal JAX's op for op.
- First sight: `step_graphs.first_sight_keys` gives the chunk, seed and
  commit points the JAX engine dispatches (and compiles cold) for a long
  prompt and a hit at a scratch length its warmup left out.
- On a CUDA device (skipped here): a warmed tiny bf16 engine replays its
  prefill, chunk and hit graphs, with streams equal to the same engine
  with its graphs dropped, and a prefill graph's first tokens read back
  after a second replay of the same graph are the first replay's; an
  engine warmed without long prompts captures a cold scratch length's
  points at the first prompt's admission, and nothing more after.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _warm_trace import lattice, run_trace

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.serving import engine_model as jem
from generativeaiexamples_tpu.serving import kv_cache as jkv
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.serving import engine_model as tem
from generativeaiexamples_tpu_torch.serving import kv_cache as tkv
from generativeaiexamples_tpu_torch.serving import step_graphs
from generativeaiexamples_tpu_torch.serving.engine import (
    GenRequest, LLMEngine)
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4  # f32 logits (tests/test_llama.py's tolerance)
VOCAB = 259

JCFG = jl.LlamaConfig.tiny()
TCFG = tl.LlamaConfig.tiny()


@pytest.fixture(scope="module")
def models():
    jparams = jl.init_params(JCFG, jax.random.PRNGKey(3))
    tparams = convert.llama_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return jparams, tparams


# -- the admission scatters with device indices -------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_device_index_set_last_tokens_equals_jax(seed):
    """Slot indices as a device int32 vector, group padding at index B."""
    rng = np.random.default_rng(seed)
    B = int(rng.integers(3, 9))
    n = int(rng.integers(1, B + 1))
    N = 1 << (n - 1).bit_length()
    idxs = np.full((N,), B, np.int32)
    idxs[:n] = rng.permutation(B)[:n]
    last = rng.integers(0, 200, B).astype(np.int32)
    toks = rng.integers(0, 200, N).astype(np.int32)
    want = jem.set_last_tokens(jnp.asarray(last), jnp.asarray(idxs),
                               jnp.asarray(toks))
    got = torch.from_numpy(last.copy())
    out = tem.set_last_tokens(got, torch.from_numpy(idxs),
                              torch.from_numpy(toks))
    assert out is got
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(4))
def test_device_index_set_history_rows_equals_jax(seed):
    """A group of prompts written into history rows by device indices:
    padding rows (index B) dropped, and a first token whose column lies
    past the history dropped too, as JAX's mode="drop" drops it."""
    rng = np.random.default_rng(10 + seed)
    B, hcap, S = 5, 24, 16 if seed % 2 else 32   # S > hcap: columns drop
    N = 4
    idxs = np.array([3, B, 0, B], np.int32)
    if seed >= 2:
        idxs = np.array([1, 4, 2, B], np.int32)
    hist = rng.integers(0, 50, (B, hcap)).astype(np.int32)
    dl = rng.integers(1, 9, (B,)).astype(np.int32)
    tokens = rng.integers(0, 50, (N, S)).astype(np.int32)
    lengths = rng.integers(1, S + 1, N).astype(np.int32)
    lengths[0] = hcap + 3 if S > hcap else lengths[0]  # column dropped
    first = rng.integers(60, 90, N).astype(np.int32)
    jh, jd = jem.set_history_rows(*(jnp.asarray(a) for a in (
        hist, dl, idxs, tokens, lengths, first)))
    th, td = torch.from_numpy(hist.copy()), torch.from_numpy(dl.copy())
    out_h, out_d = tem.set_history_rows(
        th, td, torch.from_numpy(idxs),
        *(torch.from_numpy(a) for a in (tokens, lengths, first)))
    assert out_h is th and out_d is td
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_device_index_scatters_drop_every_padding_row():
    """An all-padding group (the warm run of a prefill graph) writes
    nothing."""
    last = torch.arange(4, dtype=torch.int32)
    hist = torch.arange(32, dtype=torch.int32).reshape(4, 8)
    dl = torch.ones(4, dtype=torch.int32)
    pad = torch.full((2,), 4, dtype=torch.int32)
    tem.set_last_tokens(last, pad, torch.tensor([9, 9], dtype=torch.int32))
    tem.set_history_rows(hist, dl, pad, torch.zeros((2, 8), dtype=torch.int32),
                         torch.ones(2, dtype=torch.int32),
                         torch.tensor([9, 9], dtype=torch.int32))
    assert last.tolist() == [0, 1, 2, 3]
    assert torch.equal(hist,
                       torch.arange(32, dtype=torch.int32).reshape(4, 8))
    assert dl.tolist() == [1, 1, 1, 1]


# -- the static scratch -------------------------------------------------------


def _stale_store(rows: int, seed: int) -> tl.KVCache:
    """A full-length scratch store holding an earlier prompt's finite
    values in every row and a stale length."""
    g = torch.Generator().manual_seed(seed)
    shape = (TCFG.n_layers, 1, TCFG.n_kv_heads, rows, TCFG.head_dim)
    return tl.KVCache(torch.randn(shape, generator=g),
                      torch.randn(shape, generator=g),
                      torch.tensor([rows - 5], dtype=torch.int32))


@pytest.mark.parametrize("plen, s_total", [(45, 64), (40, 48), (17, 32)])
def test_static_scratch_chunks_equal_jax_and_a_fresh_scratch(
        models, plen, s_total):
    """Chunks of a prompt through the first s_total rows of a 128-row
    store, the valid count a device tensor: logits within atol of JAX's
    prefill_chunk_step; logits and the written rows equal to a fresh
    s_total scratch's; the rows past s_total untouched; the last chunk's
    sample with device slot and scalars equal to the host form's."""
    jparams, tparams = models
    prompt = np.random.default_rng(plen).integers(0, 256, plen).tolist()
    store = _stale_store(128, plen)
    tail = store.k[:, :, :, s_total:].clone()
    view = tem.scratch_view(store, s_total)
    view.lengths.zero_()
    fresh = tl.KVCache.zeros(TCFG, 1, max_len=s_total, device="cpu")
    jcache = jl.KVCache.zeros(JCFG, 1, max_len=s_total)
    chunk = 16
    for pos in range(0, plen, chunk):
        part = prompt[pos:pos + chunk]
        width = 16 if len(part) > 8 else 8
        tok = np.zeros((1, width), np.int32)
        tok[0, :len(part)] = part
        jlogits, jcache = jem.prefill_chunk_step(
            jparams, JCFG, jcache, jnp.asarray(tok), jnp.int32(len(part)),
            use_pallas=False)
        if pos + chunk < plen:
            got, view = tem.prefill_chunk_step(
                tparams, TCFG, view, torch.from_numpy(tok),
                torch.tensor([len(part)], dtype=torch.int32))
            want, fresh = tem.prefill_chunk_step(
                tparams, TCFG, fresh, torch.from_numpy(tok), len(part))
            assert torch.equal(got, want)
            np.testing.assert_allclose(got.numpy(), np.asarray(jlogits),
                                       atol=ATOL, rtol=0)
            continue
        last_dev = torch.zeros(4, dtype=torch.int32)
        last_host = torch.zeros(4, dtype=torch.int32)
        scalars = [torch.tensor([v], dtype=dt) for v, dt in (
            (0.0, torch.float32), (1.0, torch.float32), (0, torch.int32))]
        tok0, _, view = tem.prefill_chunk_sample_step(
            tparams, TCFG, view, torch.from_numpy(tok),
            torch.tensor([len(part)], dtype=torch.int32), last_dev,
            torch.tensor([2], dtype=torch.int32), *scalars)
        tok0_h, _, fresh = tem.prefill_chunk_sample_step(
            tparams, TCFG, fresh, torch.from_numpy(tok), len(part),
            last_host, 2, 0.0, 1.0, 0)
        assert int(tok0[0]) == int(tok0_h[0]) == int(
            np.argmax(np.asarray(jlogits)))
        assert torch.equal(last_dev, last_host)
        assert last_dev.tolist() == [0, 0, int(tok0[0]), 0]
    assert view.lengths.tolist() == fresh.lengths.tolist() == [plen] \
        == np.asarray(jcache.lengths).tolist()
    for name in ("k", "v"):
        got = getattr(view, name)[:, :, :, :plen]
        assert torch.equal(got, getattr(fresh, name)[:, :, :, :plen])
        np.testing.assert_allclose(
            got.numpy(), np.asarray(getattr(jcache, name))[:, :, :, :plen],
            atol=ATOL, rtol=0)
    assert torch.equal(store.k[:, :, :, s_total:], tail)


@pytest.mark.parametrize("s_total, pos, width, valid", [
    (32, 24, 16, 8),    # a bucketed hit's suffix: half the width past
    (32, 31, 16, 1),    # an exact repeat capped at len - 1
    (48, 40, 16, 6),    # a long hit's last rider
    (64, 60, 32, 3)])
def test_chunk_past_the_scratch_end_equals_jax(models, s_total, pos, width,
                                                valid):
    """A chunk whose padded rows pass the scratch view's end (pos + width
    > s_total), the valid count a device tensor: the last valid token's
    logits and the k/v rows [pos, s_total) within atol of JAX's
    prefill_chunk_step, whose scatter drops the rows past the end. The
    rows below pos and the store's rows past s_total stay as they were;
    only the sink (the store's last row) takes the dropped rows."""
    jparams, tparams = models
    rng = np.random.default_rng(pos + width)
    store = _stale_store(97, pos)
    view = tem.scratch_view(store, s_total)
    view.lengths.fill_(pos)
    before = {n: getattr(store, n).clone() for n in ("k", "v")}
    jcache = jl.KVCache(jnp.asarray(store.k[:, :, :, :s_total].numpy()),
                        jnp.asarray(store.v[:, :, :, :s_total].numpy()),
                        jnp.asarray([pos], jnp.int32))
    tok = np.zeros((1, width), np.int32)
    tok[0, :valid] = rng.integers(0, 256, valid)
    # The padding ids are not zeros here: every dropped row is a live
    # token's k / v, which must not land in the view.
    tok[0, valid:] = rng.integers(0, 256, width - valid)
    jlogits, jcache = jem.prefill_chunk_step(
        jparams, JCFG, jcache, jnp.asarray(tok), jnp.int32(valid),
        use_pallas=False)
    got, view = tem.prefill_chunk_step(
        tparams, TCFG, view, torch.from_numpy(tok),
        torch.tensor([valid], dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), atol=ATOL,
                               rtol=0)
    assert view.lengths.tolist() == [pos + valid] \
        == np.asarray(jcache.lengths).tolist()
    for name in ("k", "v"):
        now, old = getattr(store, name), before[name]
        np.testing.assert_allclose(
            now[:, :, :, pos:s_total].numpy(),
            np.asarray(getattr(jcache, name))[:, :, :, pos:s_total],
            atol=ATOL, rtol=0)
        assert torch.equal(now[:, :, :, :pos], old[:, :, :, :pos])
        assert torch.equal(now[:, :, :, s_total:-1], old[:, :, :, s_total:-1])
        assert not torch.equal(now[:, :, :, -1], old[:, :, :, -1])


def test_scratch_view_keeps_the_sink_row_out():
    """A view reaches at most the row before the store's sink."""
    store = _stale_store(33, 0)
    assert tem.scratch_view(store, 32).k.shape[3] == 32
    for rows in (0, 33):
        with pytest.raises(ValueError, match="sink"):
            tem.scratch_view(store, rows)


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_hit_gather_into_the_static_scratch_equals_jax(kind):
    """pool_to_cache(out=) writes JAX's gather into the store's first
    rows and sets its lengths from a device count; the rows past them
    keep what they held."""
    rng = np.random.default_rng(5)
    ps, n_pages = 8, 10
    tpool = tkv.PagePool.zeros(TCFG, n_pages, ps, dtype=torch.int8
                               if kind == "int8" else torch.float32,
                               device="cpu")
    if kind == "int8":
        kv = rng.integers(-127, 128, tpool.kv.shape).astype(np.int8)
        s = rng.random(tpool.s.shape).astype(np.float32) / 64
        jpool = jkv.QuantPagePool(jnp.asarray(kv), jnp.asarray(s), ps)
        tpool = tkv.QuantPagePool(torch.from_numpy(kv), torch.from_numpy(s),
                                  ps)
    else:
        k = rng.standard_normal(tpool.k.shape).astype(np.float32)
        v = rng.standard_normal(tpool.v.shape).astype(np.float32)
        jpool = jkv.PagePool(jnp.asarray(k), jnp.asarray(v), ps)
        tpool = tkv.PagePool(torch.from_numpy(k), torch.from_numpy(v), ps)
    row = np.array([4, 9, 2, 0], np.int32)  # 3 cached pages + the sink
    jc = jem.pool_to_cache(jpool, JCFG, jnp.asarray(row), jnp.int32(21))
    store = _stale_store(64, 1)
    tail = store.v[:, :, :, 32:].clone()
    out = tem.pool_to_cache(tpool, TCFG, torch.from_numpy(row),
                            torch.tensor([21], dtype=torch.int32),
                            out=tem.scratch_view(store, 32))
    assert out.lengths is store.lengths and store.lengths.tolist() == [21]
    np.testing.assert_array_equal(out.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(out.v.numpy(), np.asarray(jc.v))
    assert torch.equal(store.v[:, :, :, 32:], tail)


# -- the packed inputs --------------------------------------------------------


@pytest.mark.parametrize("n, bucket", [(1, 16), (4, 32), (8, 64)])
def test_packed_prefill_inputs_round_trip(n, bucket):
    """A prefill record's arrays packed into one buffer read back through
    the field views; a second, narrower load leaves no stale value (every
    field takes its fill past the record's values)."""
    rng = np.random.default_rng(n)
    ps, B = 8, 16
    inputs = step_graphs.prefill_inputs(n, bucket, ps, B, "cpu")
    rec = {"tokens": rng.integers(0, 256, (n, bucket)).astype(np.int32),
           "lengths": rng.integers(1, bucket + 1, n).astype(np.int32),
           "rows": rng.integers(0, 99, (n, bucket // ps)).astype(np.int32),
           "temps": rng.random(n).astype(np.float32),
           "top_ps": rng.random(n).astype(np.float32),
           "top_ks": rng.integers(0, 50, n).astype(np.int32),
           "idxs": rng.integers(0, B + 1, n).astype(np.int32),
           "flags": np.asarray([True, False, False])}
    inputs.load(rec)
    for name, want in rec.items():
        if name == "flags":
            continue
        got = inputs.views[name]
        assert got.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(got.numpy(), want)
    inputs.load({})
    assert not inputs.views["tokens"].any()
    assert inputs.views["lengths"].tolist() == [1] * n
    assert inputs.views["idxs"].tolist() == [B] * n
    assert inputs.views["top_ps"].tolist() == [1.0] * n


# -- a warmed engine over bucketed, chunked, hit and rider traffic ------------

BASE = {"max_batch_size": 3, "max_seq_len": 128, "page_size": 8,
        "prefill_buckets": [16], "decode_steps_per_dispatch": 8,
        "pace_emission_max_streams": 0, "fused_prefill": True,
        "prefix_cache": True}
LONG = [(i * 7 + 1) % 256 for i in range(40)]   # 3 chunks of 16: 16, 16, 8
HIT = LONG + [11, 22, 33, 44]                    # 40 cached tokens + 4
SHORT = [5, 6, 7, 8, 9, 10, 11, 12, 13]          # 1 full page
SHORT_HIT = SHORT[:8] + [99, 98, 97, 96]         # that page + 4
REPEAT = [(i * 5 + 3) % 256 for i in range(16)]  # the whole bucket
LONG_HIT = LONG[:24] + [(i * 3 + 2) % 256 for i in range(22)]  # 24 + 22
CONFIGS = {
    # Riders at the warmed (48, K); the hit's 4-token suffix at (48, 8).
    # Past the scratch's end (JAX's widths, the rows past it dropped): a
    # bucketed prompt's cached first page hit inside the bucket (16 rows
    # from 8, scratch 16); an exact repeat of a 16-token prompt, capped
    # at 15 cached tokens (16 rows from 15); a long hit on LONG's first 3
    # pages whose riders of 16 run from 24, the last from 40 (scratch
    # 48) while REPEAT's first run decodes.
    "plain": {"ecfg": BASE,
              "warmup": {"long_prompts": True,
                         "long_prompt_lengths": [40, 44]},
              "trace": [{"at": 0, "prompt": SHORT, "max_new_tokens": 40},
                        {"at": 1, "prompt": LONG, "max_new_tokens": 5},
                        {"at": 2, "prompt": [3, 1, 4], "max_new_tokens": 6},
                        {"at": 9, "prompt": HIT, "max_new_tokens": 6},
                        {"at": 10, "prompt": SHORT_HIT,
                         "max_new_tokens": 5},
                        {"at": 11, "prompt": REPEAT, "max_new_tokens": 60},
                        {"at": 13, "prompt": REPEAT, "max_new_tokens": 4},
                        {"at": 14, "prompt": LONG_HIT,
                         "max_new_tokens": 5}]},
    # The same traffic on a speculative tree engine with composed plans:
    # its history rows come from the device-index scatters.
    "spec_tree": {"ecfg": {**BASE, "speculative_k": 2,
                           "speculative_tree_branches": 2,
                           "step_plans": True},
                  "warmup": {"long_prompts": True,
                             "long_prompt_lengths": [40, 44]},
                  "trace": [{"at": 0, "prompt": SHORT, "max_new_tokens": 40},
                            {"at": 1, "prompt": LONG, "max_new_tokens": 5},
                            {"at": 7, "prompt": HIT, "max_new_tokens": 6},
                            {"at": 8, "prompt": SHORT_HIT,
                             "max_new_tokens": 5},
                            {"at": 9, "prompt": REPEAT,
                             "max_new_tokens": 60},
                            {"at": 11, "prompt": REPEAT,
                             "max_new_tokens": 4},
                            {"at": 12, "prompt": LONG_HIT,
                             "max_new_tokens": 5}]},
    # Warmed as the default server warms (sampled, no long prompts): a
    # long prompt at the unwarmed scratch length 48, then a hit on it,
    # whose 4-token suffix runs 16 rows from 40.
    "cold": {"ecfg": BASE, "warmup": {"sampled": True},
             "trace": [{"at": 0, "prompt": LONG, "max_new_tokens": 5},
                       {"at": 1, "prompt": [3, 1, 4], "max_new_tokens": 6},
                       {"at": 6, "prompt": HIT, "max_new_tokens": 6}]},
}


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
def port_runs(models):
    _, tparams = models
    out = {}
    for name, spec in CONFIGS.items():
        ecfg = {**spec["ecfg"], "dtype": "float32", "kv_dtype": "float32"}
        eng = LLMEngine(tparams, TCFG, ByteTokenizer(), ecfg,
                        device="cpu").warmup(**spec["warmup"])
        stores, make = [], eng._scratch
        eng._scratch = lambda: stores.append(make()) or stores[-1]
        out[name] = {"lattice": lattice(eng),
                     **run_trace(eng, GenRequest, spec["trace"]),
                     "hits": eng.metrics.prefix_hits,
                     "fused_steps": eng.metrics.fused_steps,
                     "scratch_rows": {st.k.shape[3] for st in stores},
                     "scratch_left": eng._scratch_store}
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_warmed_lattice_with_hits_equals_jax(jax_runs, port_runs, name):
    assert port_runs[name]["lattice"] == jax_runs[name]["lattice"]


@pytest.mark.parametrize("name", list(CONFIGS))
def _chunk_keys(run) -> list:
    """A trace's chunk-family dispatches as step_graphs keys, in order:
    each chunk plan ("chunk", S_total, width, sampled tail or None), then
    each seed and commit record."""
    return ([("chunk", p[4], p[3], "tail" if p[6] else None)
             for p in run["plans"] if p[3]]
            + [tuple(pt) for pt in run["points"]])


@pytest.mark.parametrize("name", ["plain", "spec_tree"])
def test_warmed_streams_over_hits_and_riders_equal_jax(jax_runs, port_runs,
                                                       name):
    """The dispatched plans, seeds and commits and every greedy stream
    equal the JAX engine's op for op; the trace rode a prompt and hit the
    cache four times (a long prompt's 40 and 24 tokens, a bucketed
    prompt's first page, an exact repeat's 15), all through the one
    static scratch. Three of those dispatch chunks whose padded rows pass
    the scratch's end, at the JAX engine's widths."""
    want, got = jax_runs[name], port_runs[name]
    assert got["streams"] == want["streams"]
    assert got["plans"] == want["plans"]
    assert got["points"] == want["points"]
    trace = CONFIGS[name]["trace"]
    assert all(len(s) == t["max_new_tokens"]
               for s, t in zip(got["streams"], trace))
    assert got["hits"] == 4 and got["fused_steps"] > 0
    assert any(p[0] and p[3] for p in got["plans"])      # a rider
    # The hits inside the bucket: 16-row chunks of a 16-row scratch.
    assert [p[3] for p in got["plans"] if p[4] == 16] == [16, 16]
    # Riders at (48, 16): LONG's three, then the long hit's from 24 and
    # from 40 (6 valid rows; JAX drops the 8 past 48).
    assert [(p[3], p[4]) for p in got["plans"] if p[0] and p[3]] == [
        (16, 48)] * 5
    assert got["points"][-2:] == [["seed", 48], ["commit", 48]]
    # Page capacity's rows and the sink row; an engine without graphs
    # frees the store once no prefill holds it.
    assert got["scratch_rows"] == {BASE["max_seq_len"] + 1}
    assert got["scratch_left"] is None


def test_first_sight_keys_equal_the_cold_dispatch_of_jax(jax_runs,
                                                         port_runs):
    """On engines warmed as the default server warms (no long prompts),
    a long prompt at the unwarmed scratch length 48 and a hit on it
    dispatch exactly the chunk, seed and commit points
    `step_graphs.first_sight_keys` gives for 48 (the JAX engine compiles
    them cold there), and the port's plans, points and streams equal
    JAX's."""
    want, got = jax_runs["cold"], port_runs["cold"]
    assert got["lattice"] == want["lattice"]
    assert not any(s == 48 for s, _ in want["lattice"]["chunk_widths"])
    assert (got["plans"], got["points"], got["streams"]) == (
        want["plans"], want["points"], want["streams"])
    keys = step_graphs.first_sight_keys(48, BASE["prefill_buckets"][-1],
                                        True)
    assert {k for k in _chunk_keys(want) if k[1] == 48} == set(keys)
    assert [k for k in _chunk_keys(want) if k[0] == "chunk"] == [
        ("chunk", 48, 16, None)] * 4
    assert step_graphs.first_sight_keys(48, 16, False) == (
        ("chunk", 48, 16, None), ("commit", 48))


# -- on the card (skipped without one) ----------------------------------------


def test_replayed_prefill_lattice_equals_eager_on_cuda():
    """A tiny bf16 engine warmed with long prompts and the prefix cache
    on a CUDA device: its prefill groups, chunks, riders and hits replay
    graphs (no eager prefill or chunk dispatch), with streams equal to
    the same engine's with its graphs dropped; two back-to-back replays
    of one prefill graph, each followed by its host copy, read back each
    replay's own first tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs replay there")
    from generativeaiexamples_tpu_torch.serving.engine import HostCopy

    # K1 takes head_dim 64 or 128: the tiny geometry at head_dim 64.
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), dim=256, head_dim=64,
                              dtype=torch.bfloat16)
    params = tl.init_params(cfg, "cuda",
                            torch.Generator(device="cuda").manual_seed(0))
    spec = CONFIGS["plain"]
    trace = spec["trace"]
    ecfg = {**spec["ecfg"], "dtype": "bfloat16", "kv_dtype": "bfloat16"}
    runs = {}
    for mode in ("graphs", "eager"):
        eng = LLMEngine(params, cfg, ByteTokenizer(), ecfg,
                        device="cuda").warmup(**spec["warmup"])
        if mode == "eager":
            eng._graphs = None
        else:
            stats = eng._graphs.stats()["by_family"]
            assert all(stats[f]["graphs"] > 0 for f in stats)
        runs[mode] = run_trace(eng, GenRequest, trace)
        runs[mode]["eager"] = (eng.metrics.eager_prefill_dispatches,
                               eng.metrics.eager_chunk_dispatches)
        if mode == "graphs":
            g = eng._graphs
            recs = []
            for seed in (1, 2):
                r = np.random.default_rng(seed)
                recs.append({
                    "tokens": r.integers(1, 250, (1, 16)).astype(np.int32),
                    "lengths": np.array([16], np.int32),
                    "rows": np.zeros((1, 2), np.int32),
                    "temps": np.zeros(1, np.float32),
                    "top_ps": np.ones(1, np.float32),
                    "top_ks": np.zeros(1, np.int32),
                    "idxs": np.array([3], np.int32)})
            copies = [HostCopy(g.replay_prefill(rec, step_graphs.GREEDY))
                      for rec in recs]
            got = [c.numpy().copy() for c in copies]
            eng._graphs = None
            want = [eng._exec_prefill({**rec, "flags": np.asarray(
                step_graphs.GREEDY)}).cpu().numpy() for rec in recs]
            assert [a.tolist() for a in got] == [b.tolist() for b in want]
    assert runs["graphs"]["streams"] == runs["eager"]["streams"]
    assert runs["graphs"]["plans"] == runs["eager"]["plans"]
    assert runs["graphs"]["eager"] == (0, 0)
    assert runs["eager"]["eager"][0] > 0 and runs["eager"]["eager"][1] > 0


def _tiny_cuda_model():
    # K1 takes head_dim 64 or 128: the tiny geometry at head_dim 64.
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), dim=256, head_dim=64,
                              dtype=torch.bfloat16)
    return cfg, tl.init_params(cfg, "cuda",
                               torch.Generator(device="cuda").manual_seed(0))


def test_first_sight_captures_at_admission_on_cuda():
    """A tiny bf16 engine with the prefix cache, warmed as the default
    server warms (sampled, no long prompts), serves a long prompt at the
    unwarmed scratch length 48, a second one there with no shared
    prefix, then a hit on the first: the first admission captures
    `first_sight_keys(48, 16, True)` before its first chunk runs, the
    second and the hit capture nothing new, none of the three makes an
    eager chunk dispatch and no point is refused, and the streams equal
    the same engine's with its graphs dropped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs replay there")
    cfg, params = _tiny_cuda_model()
    other = [(i * 11 + 5) % 256 for i in range(40)]
    trace = [{"at": 0, "prompt": [3, 1, 4], "max_new_tokens": 60},
             {"at": 1, "prompt": LONG, "max_new_tokens": 5},
             {"at": 8, "prompt": other, "max_new_tokens": 5},
             {"at": 16, "prompt": HIT, "max_new_tokens": 6}]
    ecfg = {**BASE, "dtype": "bfloat16", "kv_dtype": "bfloat16"}
    keys = step_graphs.first_sight_keys(48, 16, True)
    runs = {}
    for mode in ("graphs", "eager"):
        eng = LLMEngine(params, cfg, ByteTokenizer(), ecfg,
                        device="cuda").warmup(sampled=True)
        if mode == "eager":
            eng._graphs = None
        else:
            assert not any(k in eng._graphs.graphs for k in keys)
        seen = []
        for name in ("_begin_long_prefill", "_begin_prefix_prefill"):
            def begin(*a, _fn=getattr(eng, name), _name=name):
                chunks = len(plans)
                out = _fn(*a)
                g = eng._graphs
                seen.append((_name, [r["key"] for r in g.live] if g else [],
                             len(plans) == chunks))
                return out
            setattr(eng, name, begin)
        plans = []
        real = eng._exec_plan
        eng._exec_plan = lambda rec, _real=real: (plans.append(rec),
                                                  _real(rec))[1]
        runs[mode] = run_trace(eng, GenRequest, trace)
        runs[mode]["eager"] = eng.metrics.eager_chunk_dispatches
        runs[mode]["seen"] = seen
        if mode == "graphs":
            stats = eng._graphs.stats()
            assert stats["by_family"]["chunk"]["live_graphs"] == len(keys)
            assert stats["by_family"]["chunk"]["live_refused"] == 0
            assert [r["key"] for r in stats["live"]] == list(keys)
    assert runs["graphs"]["streams"] == runs["eager"]["streams"]
    assert runs["graphs"]["plans"] == runs["eager"]["plans"]
    assert runs["graphs"]["eager"] == 0 and runs["eager"]["eager"] > 0
    assert runs["graphs"]["seen"] == [
        ("_begin_long_prefill", list(keys), True),
        ("_begin_long_prefill", list(keys), True),
        ("_begin_prefix_prefill", list(keys), True)]
