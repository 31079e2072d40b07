"""Port parity: models/safetensors_reader.py and models/hf_loader.py.

The port reads the safetensors format itself (the card's machine need not
have the package). Its reader is held against `safetensors.numpy` on
files of every dtype it takes, and its loader against the JAX package's
`load_llama` / `load_bert` on tiny snapshots written by random-init
`transformers` models: the trees must be equal bit for bit (f32 and
bf16, tied and untied), and so must the int8 codes and scales of a
quantized load, including channels whose amax is zero or under 1.27e-6,
where the loader's clip-then-divide order and `quantize_tensor`'s
divide-then-clip part. Logits and encoder outputs are held against
`transformers` at the f32 tolerance 1e-4 of tests/test_llama.py.
"""

import dataclasses
import json
import os
import struct

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from generativeaiexamples_tpu.models import bert as jb
from generativeaiexamples_tpu.models import hf_loader as jh
from generativeaiexamples_tpu_torch.models import bert as tb
from generativeaiexamples_tpu_torch.models import hf_loader as th
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.models.safetensors_reader import (
    SafetensorsFile, SnapshotReader)
from generativeaiexamples_tpu_torch.ops.quant import (
    QuantizedTensor, quantize_tensor)

ATOL = 1e-4


def _bits(a) -> np.ndarray:
    """Raw bit patterns of a port (torch) or JAX (numpy / jax) leaf."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy().view(f"u{a.element_size()}")
    arr = np.asarray(a)
    return arr.view(f"u{arr.dtype.itemsize}")


def _assert_trees_equal(port, theirs, path=""):
    """Same keys, and every leaf equal bit for bit (QuantizedTensor: codes
    and scales)."""
    if isinstance(port, QuantizedTensor):
        _assert_trees_equal(port.q, theirs.q, path + ".q")
        _assert_trees_equal(port.s, theirs.s, path + ".s")
        return
    if isinstance(port, dict):
        assert set(port) == set(theirs), path
        for k in port:
            _assert_trees_equal(port[k], theirs[k], f"{path}/{k}")
        return
    want = _bits(theirs)
    got = _bits(port)
    assert got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


# -- the reader ---------------------------------------------------------------


def _mixed_tensors(rng):
    return {
        "f32": rng.standard_normal((5, 7)).astype(np.float32),
        "bf16": rng.standard_normal((3, 4, 2)).astype(ml_dtypes.bfloat16),
        "f16": rng.standard_normal((6,)).astype(np.float16),
        "i8": rng.integers(-128, 128, (4, 9)).astype(np.int8),
        "empty": np.zeros((0, 3), np.float32),
        "scalar": np.asarray(2.5, np.float32),
    }


def test_reader_matches_safetensors_on_sharded_snapshot(tmp_path):
    rng = np.random.default_rng(0)
    tensors = _mixed_tensors(rng)
    shard_a = {k: tensors[k] for k in ("f32", "bf16", "scalar")}
    shard_b = {k: tensors[k] for k in ("f16", "i8", "empty")}
    save_file(shard_a, str(tmp_path / "model-00001-of-00002.safetensors"),
              metadata={"format": "np"})
    save_file(shard_b, str(tmp_path / "model-00002-of-00002.safetensors"))
    index = {"metadata": {}, "weight_map": {
        **{k: "model-00001-of-00002.safetensors" for k in shard_a},
        **{k: "model-00002-of-00002.safetensors" for k in shard_b}}}
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(index))

    reader = SnapshotReader(str(tmp_path))
    assert set(reader.keys()) == set(tensors)
    assert reader.files[0].metadata == {"format": "np"}
    got = th.read_safetensors_dir(str(tmp_path))
    for shard in ("model-00001-of-00002", "model-00002-of-00002"):
        for name, want in load_file(str(tmp_path / f"{shard}.safetensors")
                                    ).items():
            assert got[name].shape == want.shape, name
            np.testing.assert_array_equal(_bits(got[name]), _bits(want))
    assert got["bf16"].dtype == torch.bfloat16
    assert got["i8"].dtype == torch.int8
    # A slice of rows reads only those rows, zero-copy.
    part = reader.read("f32", slice(1, 3))
    np.testing.assert_array_equal(part.numpy(), tensors["f32"][1:3])
    raw = reader.files[0].get("bf16")
    assert raw.dtype == np.uint16 and np.shares_memory(
        raw, reader.files[0]._data)
    np.testing.assert_array_equal(raw, tensors["bf16"].view(np.uint16))


def _raw_file(path, header, data=b""):
    blob = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(blob)) + blob + data)
    return str(path)


@pytest.mark.parametrize("case, match", [
    ("short", "too short"),
    ("length", "runs past"),
    ("json", "not JSON"),
    ("fields", "lacks dtype"),
    ("offsets", "data_offsets"),
    ("f64", "'F64'"),
    ("bool", "'BOOL'"),
])
def test_reader_refuses_malformed_files(tmp_path, case, match):
    p = tmp_path / "bad.safetensors"
    if case == "short":
        p.write_bytes(b"\x01\x02")
    elif case == "length":
        p.write_bytes(struct.pack("<Q", 1 << 20) + b"{}")
    elif case == "json":
        p.write_bytes(struct.pack("<Q", 3) + b"{x}")
    elif case == "fields":
        _raw_file(p, {"a": {"dtype": "F32", "shape": [1]}}, b"\0" * 4)
    elif case == "offsets":
        _raw_file(p, {"a": {"dtype": "F32", "shape": [2],
                            "data_offsets": [0, 4]}}, b"\0" * 8)
    else:
        dtype = case.upper()
        _raw_file(p, {"a": {"dtype": dtype, "shape": [1],
                            "data_offsets": [0, 8 if dtype == "F64" else 1]}},
                  b"\0" * 8)
    with pytest.raises(ValueError, match=match):
        SafetensorsFile(str(p))


def test_reader_refuses_a_directory_without_safetensors(tmp_path):
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        SnapshotReader(str(tmp_path))


# -- Llama config -------------------------------------------------------------


LLAMA31_JSON = {
    "vocab_size": 128256, "hidden_size": 2048, "num_hidden_layers": 16,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "intermediate_size": 8192, "rope_theta": 500000.0,
    "max_position_embeddings": 131072, "tie_word_embeddings": True,
    "rope_scaling": {
        "rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
}


def _config_fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("dtype")
    return d


@pytest.mark.parametrize("scaling", ["llama3", "none", "head_dim"])
def test_llama_config_from_hf_matches_jax(tmp_path, scaling):
    c = dict(LLAMA31_JSON)
    if scaling == "none":
        c.pop("rope_scaling")
        c["tie_word_embeddings"] = False
    elif scaling == "head_dim":
        c.update(head_dim=128, rms_norm_eps=1e-6)
        c.pop("max_position_embeddings")
    (tmp_path / "config.json").write_text(json.dumps(c))
    got = th.llama_config_from_hf(str(tmp_path))
    want = jh.llama_config_from_hf(str(tmp_path))
    assert _config_fields(got) == _config_fields(want)
    assert got.dtype == torch.bfloat16
    if scaling == "llama3":
        assert got.rope_scaling == tl.RopeScaling(factor=32.0)


def test_llama_config_refuses_other_rope_scaling(tmp_path):
    c = dict(LLAMA31_JSON, rope_scaling={"rope_type": "yarn", "factor": 2.0})
    (tmp_path / "config.json").write_text(json.dumps(c))
    with pytest.raises(ValueError, match="rope_scaling"):
        jh.llama_config_from_hf(str(tmp_path))
    with pytest.raises(ValueError, match="rope_scaling type 'yarn'"):
        th.llama_config_from_hf(str(tmp_path))


# -- Llama snapshots ----------------------------------------------------------


def _hf_llama(tied: bool, seed: int):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(seed)
    cfg = LlamaConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      head_dim=16, intermediate_size=128,
                      max_position_embeddings=128, rope_theta=10000.0,
                      rms_norm_eps=1e-5, tie_word_embeddings=tied)
    model = LlamaForCausalLM(cfg).eval()
    with torch.no_grad():  # norms away from 1, so a swap shows
        for name, p in model.named_parameters():
            if "norm" in name:
                p.copy_(1 + 0.1 * torch.randn_like(p))
    return model


def _write_llama(path, tied, dtype, seed=0, zero_cols=False):
    model = _hf_llama(tied, seed)
    if zero_cols:
        with torch.no_grad():  # two output channels of layer 0's wq
            w = model.model.layers[0].self_attn.q_proj.weight
            w[0].zero_()
            w[1].fill_(1e-7)
            w[2].copy_(torch.linspace(-3e-7, 5e-7, w.shape[1]))
    model.to(dtype).save_pretrained(str(path), safe_serialization=True)
    return model


def _jax_load(path, dtype, **kw):
    cfg = dataclasses.replace(jh.llama_config_from_hf(str(path)),
                              dtype=dtype)
    params, _ = jh.load_llama(str(path), cfg=cfg, dtype=dtype, **kw)
    return params


JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("ckpt", [torch.float32, torch.bfloat16],
                         ids=["f32_ckpt", "bf16_ckpt"])
@pytest.mark.parametrize("load", [torch.float32, torch.bfloat16],
                         ids=["f32_load", "bf16_load"])
def test_llama_tree_equals_jax_bit_for_bit(tmp_path, tied, ckpt, load):
    _write_llama(tmp_path, tied, ckpt)
    params, cfg = th.load_llama(str(tmp_path), device="cpu", dtype=load)
    assert cfg.dtype == load and cfg.tie_embeddings == tied
    assert ("lm_head" in params) == (not tied)
    assert params["layers"]["wq"].dtype == load
    _assert_trees_equal(params, _jax_load(tmp_path, JAX_DTYPE[load]))


def test_llama_state_dict_tree_equals_jax(tmp_path):
    model = _write_llama(tmp_path, False, torch.float32)
    cfg = dataclasses.replace(th.llama_config_from_hf(str(tmp_path)),
                              dtype=torch.float32)
    sd = model.state_dict()
    got = th.llama_params_from_state_dict(sd, cfg, device="cpu")
    jcfg = dataclasses.replace(jh.llama_config_from_hf(str(tmp_path)),
                               dtype=jnp.float32)
    want = jh.llama_params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jcfg)
    _assert_trees_equal(got, want)
    # The streaming load of the same weights gives the same tree.
    loaded, _ = th.load_llama(str(tmp_path), cfg=cfg, device="cpu")
    _assert_trees_equal(loaded, want)


@pytest.mark.parametrize("ckpt", [torch.float32, torch.bfloat16],
                         ids=["f32_ckpt", "bf16_ckpt"])
def test_quantized_load_equals_jax_codes_and_scales(tmp_path, ckpt):
    """Codes and scales of every int8 leaf (and the untied lm_head) equal
    JAX `load_llama(quantize=True)`'s bit for bit, on a snapshot whose
    layer-0 wq holds an all-zero output channel and channels of amax
    1e-7 and 5e-7; the plain leaves stay in the load dtype."""
    _write_llama(tmp_path, False, ckpt, zero_cols=True)
    params, _ = th.load_llama(str(tmp_path), device="cpu",
                              dtype=torch.bfloat16, quantize=True)
    want = _jax_load(tmp_path, jnp.bfloat16, quantize=True)
    _assert_trees_equal(params, want)
    assert isinstance(params["lm_head"], QuantizedTensor)
    assert params["layers"]["ln1"].dtype == torch.bfloat16
    wq = params["layers"]["wq"]
    assert wq.q.dtype == torch.int8 and wq.s.dtype == torch.float32
    # The clip-order trap: quantize_tensor (divide, then clip the scale)
    # gives other scales on those channels, and other codes on the
    # 1e-7 and 5e-7 ones.
    w0 = th.read_safetensors_dir(str(tmp_path))[
        "model.layers.0.self_attn.q_proj.weight"].float().t()
    other = quantize_tensor(w0)
    assert not torch.equal(other.s[:3], wq.s[0, :3])
    assert not torch.equal(other.q[:, 1], wq.q[0][:, 1])
    assert float(wq.s[0, 0]) == np.float32(np.float32(1e-8) / np.float32(127))
    assert int(wq.q[0][:, 1].abs().max()) == 127


def test_f32_checkpoint_quantizes_from_f32_values(tmp_path):
    """A bf16 load of an f32 checkpoint quantizes the stored f32 values,
    not their bf16 rounding (as JAX does)."""
    _write_llama(tmp_path, False, torch.float32, seed=3)
    params, _ = th.load_llama(str(tmp_path), device="cpu",
                              dtype=torch.bfloat16, quantize=True)
    sd = th.read_safetensors_dir(str(tmp_path))
    w = sd["model.layers.1.mlp.down_proj.weight"].t()
    from_f32 = quantize_tensor(w)  # normal channels: both orders agree
    from_bf16 = quantize_tensor(w.bfloat16())
    got = params["layers"]["w_down"]
    assert torch.equal(got.q[1], from_f32.q)
    assert torch.equal(got.s[1], from_f32.s)
    assert not torch.equal(got.q[1], from_bf16.q)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_logits_match_transformers(tmp_path, tied):
    """The HF golden test: the port's forward over the loaded snapshot
    against `LlamaForCausalLM` in f32."""
    model = _write_llama(tmp_path, tied, torch.float32, seed=5)
    params, cfg = th.load_llama(str(tmp_path), device="cpu",
                                dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 24)))
    with torch.no_grad():
        want = model(toks).logits
    got, _ = tl.forward(params, cfg, toks)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_loader_raises_without_cuda_or_explicit_device(tmp_path,
                                                       monkeypatch):
    _write_llama(tmp_path, False, torch.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.load_llama(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.load_bert(str(tmp_path))


# -- BERT ---------------------------------------------------------------------


def _hf_bert_config(**kw):
    from transformers import BertConfig

    return BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=64,
                      max_position_embeddings=64, **kw)


def _write_bert(path, role, prefixed, pooler, seed=0):
    """An HF BERT snapshot: `embed` (BertModel) or `rerank`
    (BertForSequenceClassification, one label); names with or without
    the `bert.` prefix, with or without the pooler."""
    from safetensors.torch import save_file as save_torch
    from transformers import BertForSequenceClassification, BertModel

    torch.manual_seed(seed)
    if role == "embed":
        model = BertModel(_hf_bert_config(), add_pooling_layer=pooler)
    else:
        model = BertForSequenceClassification(_hf_bert_config(num_labels=1))
    model.eval()
    sd = {k: v.contiguous() for k, v in model.state_dict().items()
          if pooler or "pooler" not in k}
    bare = {k[len("bert."):] if k.startswith("bert.") else k: v
            for k, v in sd.items()}
    named = ({("bert." + k if not k.startswith("classifier") else k): v
              for k, v in bare.items()} if prefixed else bare)
    os.makedirs(path, exist_ok=True)
    save_torch(named, os.path.join(path, "model.safetensors"))
    model.config.to_json_file(os.path.join(path, "config.json"))
    return model


BERT_CASES = [("embed", False, True), ("embed", True, False),
              ("rerank", True, True), ("rerank", False, False)]


@pytest.mark.parametrize("role, prefixed, pooler", BERT_CASES,
                         ids=[f"{r}-{'bert.' if p else 'bare'}-"
                              f"{'pooler' if q else 'nopooler'}"
                              for r, p, q in BERT_CASES])
def test_bert_tree_and_outputs_equal_jax(tmp_path, role, prefixed, pooler):
    model = _write_bert(str(tmp_path), role, prefixed, pooler,
                        seed=len(role) + prefixed)
    n_labels = 1 if role == "rerank" else 0
    params, cfg = th.load_bert(str(tmp_path), n_labels=n_labels,
                               device="cpu")
    jparams, jcfg = jh.load_bert(str(tmp_path), n_labels=n_labels)
    _assert_trees_equal(params, jparams)
    if n_labels and not pooler:  # the identity pooler
        assert torch.equal(params["classifier"]["pool_w"], torch.eye(32))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 128, (3, 20)).astype(np.int32)
    lens = np.array([20, 11, 3], np.int32)
    hidden, out = tb.forward(params, cfg, torch.from_numpy(toks),
                             lengths=torch.from_numpy(lens))
    jhidden, jout = jb.forward(jparams, jcfg, jnp.asarray(toks),
                               lengths=jnp.asarray(lens), use_pallas=False)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    if not pooler and n_labels:
        return  # HF would apply its own pooler
    # Against transformers: CLS embedding (normalized) or the score.
    mask = torch.from_numpy(np.arange(20)[None, :] < lens[:, None]).long()
    with torch.no_grad():
        ref = model(torch.from_numpy(toks).long(), attention_mask=mask)
    if n_labels:
        want = ref.logits
    else:
        cls = ref.last_hidden_state[:, 0]
        want = cls / cls.norm(dim=-1, keepdim=True)
    torch.testing.assert_close(out, want, atol=ATOL, rtol=0)


def test_bert_config_matches_jax_and_embedding_ckpt_is_no_reranker(tmp_path):
    _write_bert(str(tmp_path), "embed", False, True)
    for n_labels in (0, 1):
        got = dataclasses.asdict(th.bert_config_from_hf(str(tmp_path),
                                                        n_labels))
        want = dataclasses.asdict(jh.bert_config_from_hf(str(tmp_path),
                                                         n_labels))
        got.pop("dtype"), want.pop("dtype")
        assert got == want
    with pytest.raises(ValueError, match="no classifier.weight"):
        jh.load_bert(str(tmp_path), n_labels=1)
    with pytest.raises(ValueError, match="embedding checkpoint, not a "
                                         "reranker"):
        th.load_bert(str(tmp_path), n_labels=1, device="cpu")
