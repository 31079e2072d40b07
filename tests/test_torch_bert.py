"""Port parity: models/bert.py and models/convert.bert_params_from_numpy.

JAX `bert.init_params` weights are carried across with the converter;
the same seeded tokens go through JAX `bert.forward(..., use_pallas=True,
interpret=True)` (the Pallas encoder kernel in interpret mode) and the
port's `forward` on the CPU (K3's plain version). f32 atol 1e-4 on
hidden states, pooled embeddings and reranker scores: the contract
tolerance for f32 activations of a few layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import bert as jb
from generativeaiexamples_tpu_torch.models import bert as tb
from generativeaiexamples_tpu_torch.models import convert

ATOL = 1e-4
CONFIGS = {
    "tiny_cls": dict(),
    "hd64_mean": dict(dim=128, n_heads=2, mlp_dim=256, pooling="mean"),
    "cross_encoder": dict(dim=128, n_heads=2, mlp_dim=256, n_labels=1,
                          normalize=False),
}


def _pair(**kw):
    base = dict(vocab_size=128, dim=32, n_layers=2, n_heads=2, mlp_dim=64,
                max_position=64)
    base.update(kw)
    return jb.BertConfig(**base), tb.BertConfig(**base)


def _carried(jcfg, seed):
    jparams = jb.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, convert.bert_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax_pallas_interpret(name):
    jcfg, tcfg = _pair(**CONFIGS[name])
    jparams, tparams = _carried(jcfg, seed=len(name))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 128, (3, 40)).astype(np.int32)
    lengths = np.array([40, 9, 1], np.int32)
    types = np.zeros_like(toks)
    types[:, 20:] = 1
    jh, jp = jb.forward(jparams, jcfg, jnp.asarray(toks),
                        lengths=jnp.asarray(lengths),
                        token_types=jnp.asarray(types), use_pallas=True,
                        interpret=True)
    th, tp = tb.forward(tparams, tcfg, torch.from_numpy(toks),
                        lengths=torch.from_numpy(lengths),
                        token_types=torch.from_numpy(types))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL, rtol=0)
    if tcfg.n_labels:
        assert tp.shape == (3, 1)
    elif tcfg.normalize:
        np.testing.assert_allclose(np.linalg.norm(tp.numpy(), axis=-1), 1.0,
                                   atol=1e-5)


def test_fuse_qkv_params_equivalence():
    jcfg, tcfg = _pair()
    jparams, tparams = _carried(jcfg, seed=5)
    fused = tb.fuse_qkv_params(tparams)
    assert tb.fuse_qkv_params(fused) is fused  # idempotent
    jfused = jb.fuse_qkv_params(jparams)
    for key in ("wqkv", "bqkv"):
        np.testing.assert_array_equal(fused["layers"][key].numpy(),
                                      np.asarray(jfused["layers"][key]))
    assert not {"wq", "wk", "wv", "bq", "bk", "bv"} & set(fused["layers"])
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, 128, (2, 12)).astype(np.int32))
    a = tb.forward(tparams, tcfg, toks)[1]
    b = tb.forward(fused, tcfg, toks)[1]
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    # A fused JAX tree carries across as is.
    carried = convert.bert_params_from_numpy(
        jax.tree.map(np.asarray, jfused), "cpu", torch.float32)
    torch.testing.assert_close(tb.forward(carried, tcfg, toks)[1], a,
                               atol=0, rtol=0)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(2)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 5, 16), (16,), (16,)))
    got = tb.layer_norm(*map(torch.from_numpy, (x, w, b)), 1e-12).numpy()
    want = np.asarray(jb.layer_norm(*map(jnp.asarray, (x, w, b)), 1e-12))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("preset", ["arctic_embed_l", "reranker_base",
                                    "tiny"])
def test_presets_equal_jax(preset):
    j = dataclasses.asdict(getattr(jb.BertConfig, preset)())
    t = dataclasses.asdict(getattr(tb.BertConfig, preset)())
    assert j.pop("dtype") == jnp.float32 and t.pop("dtype") == torch.float32
    assert t == j
    assert getattr(tb.BertConfig, preset)().head_dim == \
        getattr(jb.BertConfig, preset)().head_dim


def test_init_params_tree_and_device():
    cfg = dataclasses.replace(tb.BertConfig.tiny(), n_labels=1)
    params = tb.init_params(cfg, "cpu", torch.Generator().manual_seed(0))
    jparams = jb.init_params(jb.BertConfig(**{
        **dataclasses.asdict(cfg), "dtype": jnp.float32}),
        jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
    assert params["tok_emb"].device.type == "cpu"
