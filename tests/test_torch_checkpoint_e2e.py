"""Checkpoint -> loader -> engine, end to end, against the JAX package.

The port's mirror of tests/test_checkpoint_e2e.py: its seeded tiny Llama
snapshot in the HF format (config.json + model.safetensors, no
tokenizer.json; written by the JAX test's own helper) goes through
`serving.__main__.build_engine(weights_path=...)` on the CPU, and the
engine's greedy streams must equal, token for token, the JAX package's
offline greedy decode (`llama.greedy_generate`) over JAX `load_llama` of
the same snapshot: f32 weights, and weight-only
int8 quantized at load. (No JAX `LLMEngine` is built: the JAX suite's
chunked-prefill state is order dependent, ROADMAP "Where we are".)
`EngineHub` loads each encoder from its own snapshot with its own
tokenizer, and never pairs a random encoder with a loaded LLM.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import hf_loader as jh
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.serving.encoders import (
    EmbeddingEngine as JEmbed, RerankEngine as JRerank)
from generativeaiexamples_tpu.utils.tokenizer import (
    load_tokenizer as jax_load_tokenizer)
from generativeaiexamples_tpu_torch.config.schema import load_config
from generativeaiexamples_tpu_torch.connectors import factory
from generativeaiexamples_tpu_torch.models import hf_loader as th
from generativeaiexamples_tpu_torch.serving.__main__ import (
    build_encoders, build_engine)
from generativeaiexamples_tpu_torch.utils.tokenizer import (
    ByteTokenizer, HFTokenizer)
from test_checkpoint_e2e import write_tiny_hf_checkpoint  # the JAX test's

PROMPTS = [list(range(5, 25)), [7, 3, 250, 9, 100, 41, 2]]
ENGINE = {"dtype": "float32", "kv_dtype": "float32", "max_batch_size": 2,
          "max_seq_len": 64, "page_size": 8, "prefill_buckets": [32],
          "decode_steps_per_dispatch": 4}
ATOL = 1e-4


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny-llama")
    write_tiny_hf_checkpoint(path)
    return path


def _jax_greedy(path, n, **kw):
    cfg = dataclasses.replace(jh.llama_config_from_hf(path),
                              dtype=jnp.float32)
    params, _ = jh.load_llama(path, cfg=cfg, dtype=jnp.float32, **kw)
    return [np.asarray(jl.greedy_generate(
        params, cfg, jnp.asarray([p]), n, use_pallas=False))[0].tolist()[
            len(p):] for p in PROMPTS]


def _engine_tokens(engine, n):
    engine.start()
    try:
        return [[ev["token_id"] for ev in engine.generate_stream(
            p, max_new_tokens=n) if ev["token_id"] >= 0] for p in PROMPTS]
    finally:
        engine.stop()


def test_config_roundtrip(snapshot):
    got = dataclasses.asdict(th.llama_config_from_hf(snapshot))
    want = dataclasses.asdict(jh.llama_config_from_hf(snapshot))
    got.pop("dtype"), want.pop("dtype")
    assert got == want
    cfg = jl.LlamaConfig.tiny()
    assert (got["dim"], got["n_layers"], got["n_kv_heads"],
            got["vocab_size"]) == (cfg.dim, cfg.n_layers, cfg.n_kv_heads,
                                   cfg.vocab_size)


def test_loaded_engine_matches_jax_offline_greedy(snapshot):
    engine = build_engine(device="cpu", engine_cfg=ENGINE, warmup=False,
                          weights_path=snapshot)
    # The snapshot has no tokenizer.json and a byte-sized vocabulary.
    assert isinstance(engine.tokenizer, ByteTokenizer)
    assert engine.cfg.dtype == torch.float32
    assert _engine_tokens(engine, 12) == _jax_greedy(snapshot, 12)


def test_weights_path_comes_from_the_engine_config(snapshot):
    """APP_ENGINE_WEIGHTSPATH reaches build_engine through load_config."""
    ecfg = load_config(env={"APP_ENGINE_WEIGHTSPATH": snapshot},
                       overrides={"engine": ENGINE}).engine
    assert ecfg.weights_path == snapshot
    engine = build_engine(device="cpu", engine_cfg=ecfg, warmup=False)
    assert engine.cfg.vocab_size == jl.LlamaConfig.tiny().vocab_size
    assert _engine_tokens(engine, 6) == _jax_greedy(snapshot, 6)


def test_quantized_load_serves(snapshot):
    """int8 weights quantized at load: with an f32 pool the streams equal
    JAX's offline greedy over JAX's int8 load; with the int8 pool too
    (the 16 GB deployment's path) they are deterministic and the first
    token agrees."""
    int8 = {**ENGINE, "quantize_weights": "int8"}
    engine = build_engine(device="cpu", engine_cfg=int8, warmup=False,
                          weights_path=snapshot)
    assert engine.params["layers"]["wq"].q.dtype == torch.int8
    assert _engine_tokens(engine, 10) == _jax_greedy(snapshot, 10,
                                                     quantize=True)
    kv8 = {**int8, "kv_dtype": "int8", "page_size": 16}
    runs = [_engine_tokens(build_engine(device="cpu", engine_cfg=kv8,
                                        warmup=False, weights_path=snapshot),
                           8) for _ in range(2)]
    assert runs[0] == runs[1]
    assert [r[0] for r in runs[0]] == [r[0] for r in _jax_greedy(
        snapshot, 1, quantize=True)]


# -- encoders through the hub --------------------------------------------------


def _write_bert(path, n_labels, seed, tokenizer_json=None):
    from safetensors.torch import save_file as save_torch
    from transformers import (BertConfig, BertForSequenceClassification,
                              BertModel)

    torch.manual_seed(seed)
    cfg = BertConfig(vocab_size=512, hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=64,
                     max_position_embeddings=64, num_labels=max(n_labels, 1))
    model = (BertForSequenceClassification(cfg) if n_labels
             else BertModel(cfg))
    os.makedirs(path, exist_ok=True)
    save_torch({k: v.contiguous() for k, v in model.state_dict().items()},
               os.path.join(path, "model.safetensors"))
    cfg.to_json_file(os.path.join(path, "config.json"))
    if tokenizer_json is not None:
        tokenizer_json.save(os.path.join(path, "tokenizer.json"))
    return path


def _wordpiece():
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers
    from tokenizers import trainers

    tk = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tk.normalizer = normalizers.BertNormalizer(lowercase=True)
    tk.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tk.train_from_iterator(
        [f"passage {i} about pages, kernels and the scheduler"
         for i in range(200)],
        trainers.WordPieceTrainer(vocab_size=300, special_tokens=[
            "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]))
    return tk


@pytest.fixture(scope="module")
def encoder_snapshots(tmp_path_factory):
    root = tmp_path_factory.mktemp("encoders")
    return (_write_bert(str(root / "embed"), 0, 1, _wordpiece()),
            _write_bert(str(root / "rerank"), 1, 2))


TEXTS = ["the scheduler keeps pages", "Kernels, pages!", "passage 7"]


def test_hub_loads_each_encoder_with_its_own_tokenizer(snapshot,
                                                       encoder_snapshots):
    embed_path, rerank_path = encoder_snapshots
    config = load_config(env={}, overrides={
        "engine": {**ENGINE, "weights_path": snapshot},
        "embeddings": {"weights_path": embed_path, "dimensions": 32},
        "reranker": {"weights_path": rerank_path, "enabled": True}})
    hub = factory.EngineHub(config, device="cpu")
    emb, rr = hub.embed_engine(), hub.rerank_engine()
    assert isinstance(emb.tokenizer, HFTokenizer)
    assert emb.tokenizer.cls_id is not None
    assert isinstance(rr.tokenizer, ByteTokenizer)  # vocab 512, no json
    assert (emb.cfg.n_labels, rr.cfg.n_labels) == (0, 1)
    # Each against the JAX engine over JAX's load of the same snapshot
    # and JAX's tokenizer for it.
    jparams, jcfg = jh.load_bert(embed_path)
    jemb = JEmbed(jparams, jcfg, jax_load_tokenizer(embed_path),
                  use_pallas=False)
    np.testing.assert_allclose(emb.embed(TEXTS), jemb.embed(TEXTS),
                               atol=ATOL, rtol=0)
    jparams, jcfg = jh.load_bert(rerank_path, n_labels=1)
    jrr = JRerank(jparams, jcfg, jax_load_tokenizer(rerank_path),
                  use_pallas=False)
    np.testing.assert_allclose(rr.score("pages", TEXTS),
                               jrr.score("pages", TEXTS), atol=ATOL, rtol=0)
    assert factory.get_reranker(config, hub) is not None
    assert factory.get_embedder(config, hub).dim == 32
    hub.close()


def test_loaded_llm_is_never_paired_with_a_random_encoder(snapshot):
    config = load_config(env={}, overrides={
        "engine": {**ENGINE, "weights_path": snapshot},
        "reranker": {"enabled": True}})
    hub = factory.EngineHub(config, device="cpu")
    assert hub.embed_engine() is None and hub.rerank_engine() is None
    with pytest.raises(RuntimeError, match="embeddings.weights_path unset "
                                           "with a real LLM"):
        factory.get_embedder(config, hub)
    assert factory.get_reranker(config, hub) is None
    # With no LLM path the encoders stay the random-init tiny ones.
    emb, rr = build_encoders("cpu")
    assert emb.cfg.dim == 32 and rr.cfg.n_labels == 1
    assert build_encoders("cpu", random_init=False) == (None, None)
