"""Port parity: the attribution tools (generativeaiexamples_tpu_torch/
scripts/) and `EngineMetrics.reset_window`.

- `ttft_breakdown.stage_rows` of both packages read one event sequence,
  recorded into a JAX and a port `FlightRecorder`: the tables are EQUAL
  (the same float64 arithmetic on the same timestamps).
- `decompose_decode` on the tiny f32 model: its full block equals
  `engine_model.decode_multi_step` called directly over the same page
  tables, which are the JAX script's (`default_rng(0).permutation`,
  scripts/decompose_decode.py:59-63, rebuilt here); the stubs' context
  manager puts the same binding objects back, also when the block
  raises, and refuses while an engine thread is live.
- `decompose_bert_forward` on `BertConfig.tiny` in f32: `full` equals
  JAX `bert.forward` on its plain route within the contract's f32 1e-4;
  `no_attn` equals the JAX script's same variant within 1e-4;
  `fused_qkv` equals `full` within 1e-5 (the same math, summed in
  another order).
- Each tool's main() raises without CUDA unless given `--device cpu`, and
  runs on the CPU at tiny size with it.
"""

import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import bert as jb
from generativeaiexamples_tpu.serving import flight as jf
from generativeaiexamples_tpu.serving.engine import (
    EngineMetrics as JEngineMetrics)
from generativeaiexamples_tpu_torch.models import bert as tb
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.ops.quant import quantize_llama_params
from generativeaiexamples_tpu_torch.scripts import (
    decompose_bert_forward, decompose_decode, decompose_encoders,
    profile_card, ttft_breakdown)
from generativeaiexamples_tpu_torch.serving import engine_model
from generativeaiexamples_tpu_torch.serving import flight as tf
from generativeaiexamples_tpu_torch.serving.engine import EngineMetrics
from generativeaiexamples_tpu_torch.training.trainer import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from scripts import decompose_bert_forward as jdecompose_bert  # noqa: E402
from scripts.ttft_breakdown import stage_rows as jstage_rows  # noqa: E402

ATOL = 1e-4


# -- EngineMetrics.reset_window -----------------------------------------------


@pytest.mark.parametrize("cls", [JEngineMetrics, EngineMetrics],
                         ids=["jax", "port"])
def test_reset_window_scopes_the_rate_gauge(cls):
    """tests/test_serving.py's case on both packages' EngineMetrics: the
    same tokens recorded; the gauge is positive, 0.0 after the reset,
    positive again after new tokens."""
    m = cls()
    m.record_tokens(1000)
    assert m.tokens_per_sec() > 0
    m.reset_window()
    assert m.tokens_per_sec() == 0.0
    m.record_tokens(50)
    assert m.tokens_per_sec() > 0


# -- ttft_breakdown -----------------------------------------------------------


def _record(mod, rec):
    """One event sequence: a bucketed request, a chunked one (two
    chunks), one with no first token yet, one admitted without a
    submit event, and another request's events interleaved."""
    ev = mod
    seq = [
        (ev.EV_SUBMIT, 10.0, "a"), (ev.EV_SUBMIT, 10.001, "b"),
        (ev.EV_ADMIT, 10.0004, "a"), (ev.EV_PREFILL_DISPATCH, 10.0021, "a"),
        (ev.EV_ADMIT, 10.003, "b"), (ev.EV_PREFILL_CHUNK, 10.0101, "b"),
        (ev.EV_FIRST_TOKEN, 10.0123, "a"), (ev.EV_PREFILL_CHUNK, 10.02, "b"),
        (ev.EV_RETIRE, 10.03, "a"), (ev.EV_FIRST_TOKEN, 10.0411, "b"),
        (ev.EV_SUBMIT, 10.05, "c"), (ev.EV_ADMIT, 10.0502, "c"),
        (ev.EV_ADMIT, 10.06, "d"), (ev.EV_FIRST_TOKEN, 10.07, "d"),
    ]
    for kind, ts, rid in seq:
        rec.record_event(kind, ts, rid=rid, a=1.5)


def test_stage_rows_equal_jax():
    jrec, trec = jf.FlightRecorder(), tf.FlightRecorder()
    _record(jf, jrec)
    _record(tf, trec)
    rids = ["a", "b", "c", "d", "missing"]
    want = jstage_rows(jrec, rids)
    got = ttft_breakdown.stage_rows(trec, rids)
    assert got == want
    assert set(got[0]) == {"admit", "prefill_dispatched", "first_token",
                           "total"}
    assert got[3] == {} and got[4] == {}
    # The chunked request's prefill stage is its FIRST chunk.
    assert got[1]["prefill_dispatched"] == pytest.approx(7.1)
    assert ttft_breakdown.STAGES == ["admit", "prefill_dispatched",
                                     "first_token"]


def test_ttft_breakdown_main_on_the_cpu(capsys):
    ttft_breakdown.main(["1", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    rows = [ln for ln in out if ln.startswith("[ttft] req ")]
    assert len(rows) == 1 and "nan" not in " ".join(rows)
    assert any(ln.startswith("[ttft] MEDIAN:") for ln in out)


def test_first_token_stage_equals_the_ttft_observed():
    """The engine reads one clock per slot, at its first token's
    emission, for both the TTFT and the first-token event, so every
    request's stage total equals the TTFT its histogram observed:
    chip_smoke's gate on the stage table, over concurrent requests whose
    first tokens land in one block. The event also keeps how long the
    token waited on the host after its block landed."""
    import chip_smoke
    from generativeaiexamples_tpu_torch.serving.__main__ import build_engine
    from generativeaiexamples_tpu_torch.serving.engine import GenRequest

    eng = build_engine("tiny", "cpu", warmup=False, engine_cfg={
        "max_batch_size": 4, "max_seq_len": 256, "page_size": 16,
        "prefill_buckets": [16, 64], "dtype": "float32",
        "kv_dtype": "float32"}).start()
    try:
        reqs = [eng.submit(GenRequest(prompt_ids=list(range(2, 12 + 9 * i)),
                                      max_new_tokens=3, request_id=f"r{i}"))
                for i in range(6)]
        for req in reqs:
            while not req.stream.get(timeout=60)["finished"]:
                pass
    finally:
        eng.stop()
    rec = chip_smoke._ttft_table(eng)
    assert rec["ok"] and rec["requests"] == 6, rec
    assert rec["worst_vs_hist_ms"] < 1e-6
    assert rec["waits_within_stage"]
    waits = rec["emitted_after_landing_ms"]
    assert 0.0 <= waits["p50"] <= waits["max"]


# -- decompose_decode ---------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_int8():
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, "cpu",
                            torch.Generator().manual_seed(0))
    return cfg, quantize_llama_params(params, "cpu")


def _jax_script_tables(B, maxp, n_pages):
    """scripts/decompose_decode.py:59-63, as the JAX script builds them."""
    rng = np.random.default_rng(0)
    tables = np.zeros((B, maxp), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    for b in range(B):
        tables[b] = perm[b * maxp:(b + 1) * maxp]
    return tables


@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_decompose_full_block_equals_decode_multi_step(tiny_int8, kv):
    cfg, params = tiny_int8
    B, K = 4, decompose_decode.K
    setup = decompose_decode.decode_setup(cfg, B, kv, "cpu")
    ps = 128 if kv == "int8" else 64
    maxp = 384 // ps
    assert setup.pool.page_size == ps
    assert setup.pool.n_pages == B * maxp + 1
    assert setup.pool.quantized == (kv == "int8")
    np.testing.assert_array_equal(setup.tables.numpy(),
                                  _jax_script_tables(B, maxp, B * maxp + 1))
    assert setup.lengths.tolist() == [129] * B
    _, blocks = decompose_decode.run_blocks(params, cfg, setup, 1)
    # The same blocks, called directly on a fresh pool.
    fresh = decompose_decode.decode_setup(cfg, B, kv, "cpu")
    last = torch.zeros((B,), dtype=torch.int32)
    for i in range(2):
        block, last = engine_model.decode_multi_step(
            params, cfg, fresh.pool, last, fresh.tables,
            fresh.lengths + K * i, torch.ones((B,), dtype=torch.bool),
            torch.zeros((B,)), torch.ones((B,)),
            torch.zeros((B,), dtype=torch.int32), None, K,
            sampling_flags=(True, False, False))
        np.testing.assert_array_equal(blocks[i], block.numpy())


def test_decompose_stubs_restore_the_bindings(tiny_int8):
    cfg, params = tiny_int8
    before = {n: getattr(engine_model, n)
              for n in decompose_decode.STUB_NAMES}
    with decompose_decode.stubs(True, True):
        assert engine_model.paged_attention_int8 is not before[
            "paged_attention_int8"]
        assert engine_model.quantize_kv is not before["quantize_kv"]
    assert all(getattr(engine_model, n) is fn for n, fn in before.items())
    with pytest.raises(ZeroDivisionError):
        with decompose_decode.stubs(True, False):
            1 / 0
    assert all(getattr(engine_model, n) is fn for n, fn in before.items())
    rec = decompose_decode.decompose(
        params, cfg, decompose_decode.decode_setup(cfg, 2, "int8", "cpu"), 3)
    assert rec["full_tokens_equal_after_stubs"] and rec["bindings_restored"]
    assert set(rec["variants"]) == set(decompose_decode.VARIANTS)
    # Interleaved rounds: every variant timed once a round, each paired
    # difference reported with its range; no device rows off the card.
    assert rec["rounds"] == 3
    for r in rec["variants"].values():
        w = r["wall_ms"]
        assert 0 < w["min"] <= w["median"] <= w["max"]
        assert r["ms_per_iteration"] == w["median"]
        assert r["device_span_ms"] is None and r["device"] is None
    a = rec["attention_spread_ms"]
    assert a["min"] <= rec["attention_ms"] == a["median"] <= a["max"]
    assert rec["device_attention_ms"] is None
    lines = decompose_decode.format_rows(rec)
    for name in decompose_decode.VARIANTS:
        assert sum(ln.startswith(f"[decompose] {name}:")
                   for ln in lines) == 1


def test_decompose_stubs_refused_while_an_engine_thread_runs():
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="llm-engine")
    t.start()
    try:
        with pytest.raises(RuntimeError, match="engine threads"):
            with decompose_decode.stubs(True, False):
                pass
    finally:
        stop.set()
        t.join()
    assert engine_model.paged_attention_dispatch.__name__ \
        == "paged_attention_dispatch"


def test_decompose_refuses_blocks_past_the_page_capacity(tiny_int8):
    cfg, params = tiny_int8
    setup = decompose_decode.decode_setup(cfg, 1, "int8", "cpu")
    with pytest.raises(ValueError, match="page capacity"):
        decompose_decode.decompose(params, cfg, setup, 32)


# -- decompose_bert_forward ---------------------------------------------------


@pytest.fixture(scope="module")
def tiny_bert():
    jcfg = jb.BertConfig.tiny()
    jparams = jb.init_params(jcfg, jax.random.PRNGKey(5))
    tparams = convert.bert_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 128, (3, 48)).astype(np.int32)
    lengths = np.array([48, 20, 1], np.int32)
    return jcfg, jparams, tb.BertConfig.tiny(), tparams, toks, lengths


def test_bert_variants_equal_jax(tiny_bert):
    jcfg, jparams, tcfg, tparams, toks, lengths = tiny_bert
    t_toks, t_len = torch.from_numpy(toks), torch.from_numpy(lengths)
    got = {m: decompose_bert_forward.forward_variant(
        tparams, tcfg, t_toks, t_len, m).numpy()
        for m in decompose_bert_forward.MODES}
    jfull = np.asarray(jb.forward(jparams, jcfg, jnp.asarray(toks),
                                  lengths=jnp.asarray(lengths),
                                  use_pallas=False)[0][:, 0])
    np.testing.assert_allclose(got["full"], jfull, atol=ATOL, rtol=0)
    jno = np.asarray(jdecompose_bert.forward_variant(
        jparams, jcfg, jnp.asarray(toks), jnp.asarray(lengths), "no_attn"))
    np.testing.assert_allclose(got["no_attn"], jno, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["fused_qkv"], got["full"], atol=1e-5,
                               rtol=0)
    assert np.abs(got["no_attn"] - got["full"]).max() > 1e-2
    # The pre-fused tree the engines hold gives the same full forward.
    fused = decompose_bert_forward.forward_variant(
        tb.fuse_qkv_params(tparams), tcfg, t_toks, t_len, "full").numpy()
    np.testing.assert_array_equal(fused, got["full"])
    assert decompose_bert_forward.flops(tcfg, 3, 48) == \
        jdecompose_bert.flops(jcfg, 3, 48)


def test_bert_decompose_times_every_mode(tiny_bert):
    *_, tcfg, tparams, _, _ = tiny_bert
    rec = decompose_bert_forward.decompose(tparams, tcfg, 2, 32, "cpu")
    assert set(rec["modes"]) == set(decompose_bert_forward.MODES)
    assert all(r["ms"] > 0 and r["per_s"] > 0
               for r in rec["modes"].values())
    # The profiler split has every class and, off the card, no device
    # time to split.
    split = decompose_bert_forward.device_split(tparams, tcfg, 2, 32, "cpu")
    assert set(split["by_class_ms"]) == {
        c for c, _ in decompose_bert_forward.KERNEL_CLASSES} | {
        "other_elementwise"}
    assert split["device_ms"] == 0.0 and split["top"] == []
    assert decompose_bert_forward.format_row("tiny", rec).startswith(
        "tiny B=2 S=32: full ")


# -- decompose_encoders and profile_card --------------------------------------


def test_decompose_encoders_measures_every_stage():
    from generativeaiexamples_tpu_torch.serving.__main__ import (
        ENCODER_GEOMETRIES)
    from generativeaiexamples_tpu_torch.serving.encoders import (
        EmbeddingEngine)
    from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

    cfg = ENCODER_GEOMETRIES["tiny"][0]()
    params = tb.init_params(cfg, "cpu", torch.Generator().manual_seed(0))
    emb = EmbeddingEngine(params, cfg, ByteTokenizer(), max_batch=8,
                          buckets=decompose_encoders.BUCKETS, device="cpu")
    docs = decompose_encoders.mktexts(16, 500)
    rec = decompose_encoders.measure(
        emb, docs, decompose_encoders.mktexts(16, 48, seed=1))
    assert rec["B"] == 8 and rec["S"] == cfg.max_position
    for key in ("tokenize_ms", "batch_chain_ms", "batch_sync_ms",
                "docs_per_s", "queries_per_s", "bound_ms"):
        assert rec[key] > 0, key
    n_bytes, fl = decompose_encoders.forward_cost(emb.params, cfg, 8, 64)
    weights = sum(t.numel() * 4 for t in tree_leaves(emb.params))
    assert n_bytes == weights + 8 * 64 * 4 + 8 * 4 + 8 * cfg.dim * 4
    assert fl == decompose_bert_forward.flops(cfg, 8, 64)


def test_profile_card_rows_on_the_cpu():
    from generativeaiexamples_tpu_torch.ops.quant import (
        QuantizedTensor, mm)

    rows = profile_card.bandwidth_rows("cpu", (4, 64, 256), layers=2)
    assert set(rows) == {"bf16_matmul", "int8_k6", "int8_k6_2_layers"}
    assert rows["int8_k6"]["weight_bytes"] == 64 * 256 + 4 * 256
    assert all(r["ms"] > 0 and r["gb_per_s"] > 0 for r in rows.values())
    over = profile_card.dispatch_overhead("cpu")
    assert over["launch_ms"] > 0 and over["launch_and_read_ms"] > 0
    # ops/quant.mm on a CPU tensor is K6's plain version, (x @ q) * s.
    # The inputs come from seeded numpy draws, so the result does not
    # depend on torch's global RNG state (whatever ran before in this
    # process); several seeds show it. Against the same association
    # order the result is bit-equal. Against x @ (q * s) the two f32
    # sums of 64 terms round apart by at most a few ulps of the sum of
    # |terms|, so the tolerance is 1e-5 x (|x| @ |q * s|) per element
    # (an atol fixed at 1e-4 fails wherever an output lands near zero).
    for seed in range(8):
        rng = np.random.default_rng(seed)
        q = torch.from_numpy(rng.integers(-127, 128, (64, 256),
                                          dtype=np.int8))
        s = torch.from_numpy(rng.random(256, dtype=np.float32))
        x = torch.from_numpy(rng.standard_normal((4, 64),
                                                 dtype=np.float32))
        got = mm(x, QuantizedTensor(q, s)).numpy()
        np.testing.assert_array_equal(got, ((x @ q.float()) * s).numpy())
        w = q.float() * s
        tol = 1e-5 * (x.abs() @ w.abs()).numpy()
        assert np.all(np.abs(got - (x @ w).numpy()) <= tol), seed


@pytest.mark.parametrize("tool", [ttft_breakdown, decompose_decode,
                                  decompose_bert_forward,
                                  decompose_encoders, profile_card],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_main_raises_without_cuda(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main([])


@pytest.mark.parametrize("tool, argv", [
    (decompose_decode, ["1", "int8", "--rounds", "1"]),
    (decompose_bert_forward, []),
    (profile_card, [])],
    ids=["decompose_decode", "decompose_bert_forward", "profile_card"])
def test_main_on_the_cpu(tool, argv, capsys):
    """Each tool's main at tiny size (decompose_encoders' loop over its
    256 documents and profile_card's --engine steps run only on the
    card: `measure` and the rows are tested above)."""
    tool.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.strip() and "nan" not in out
