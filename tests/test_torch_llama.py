"""Port parity: models/llama.py and models/convert.py.

The JAX package's tiny f32 Llama weights (from a seed) are carried across
with `llama_params_from_numpy`, so both packages run the same model.
Logit tolerance 1e-4 is the JAX package's own for f32 forward passes
(tests/test_llama.py): the two differ only in matmul summation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl

ATOL = 1e-4
PRESETS = ["llama3_8b", "llama3_70b", "llama3_1_8b", "llama3_2_1b", "tiny"]


@pytest.fixture(scope="module")
def tiny():
    cfg = jl.LlamaConfig.tiny()
    jparams = jl.init_params(cfg, jax.random.PRNGKey(0))
    tparams = convert.llama_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return cfg, jparams, tl.LlamaConfig.tiny(), tparams


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("name", PRESETS)
def test_preset_fields_equal_jax(name):
    jc, tc = getattr(jl.LlamaConfig, name)(), getattr(tl.LlamaConfig, name)()
    jf, tf = dataclasses.asdict(jc), dataclasses.asdict(tc)
    assert jnp.dtype(jf.pop("dtype")).name == str(tf.pop("dtype")).split(
        ".")[-1]
    assert jf == tf


@pytest.mark.parametrize("scaling", [None, jl.RopeScaling(factor=32.0)])
def test_rope_freqs_match_jax(scaling):
    tscaling = None if scaling is None else tl.RopeScaling(
        **dataclasses.asdict(scaling))
    np.testing.assert_allclose(
        tl.rope_freqs(64, 500000.0, tscaling).numpy(),
        np.asarray(jl.rope_freqs(64, 500000.0, scaling)), rtol=1e-6)


@pytest.mark.parametrize("scaling", [None, tl.RopeScaling(factor=32.0)])
@pytest.mark.parametrize("head_dim, theta", [(64, 500000.0), (128, 10000.0),
                                             (16, 1e6)])
def test_rope_freqs_bit_equal_to_the_host_copy_form(scaling, head_dim,
                                                    theta):
    """rope_freqs makes its base with a device fill (a decode block
    captured as a CUDA graph calls it once a forward, and a capture
    refuses a host-to-device copy): the frequencies are bit-equal to the
    former form, torch.pow of torch.tensor(theta) (a host copy)."""
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    want = torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    if scaling is not None:
        s = scaling
        wavelen = 2.0 * np.pi / want
        high_wl = s.original_max_position_embeddings / s.high_freq_factor
        low_wl = s.original_max_position_embeddings / s.low_freq_factor
        smooth = (s.original_max_position_embeddings / wavelen
                  - s.low_freq_factor) / (s.high_freq_factor
                                          - s.low_freq_factor)
        mid = (1.0 - smooth) * want / s.factor + smooth * want
        want = torch.where(wavelen < high_wl, want,
                           torch.where(wavelen > low_wl, want / s.factor,
                                       mid))
    got = tl.rope_freqs(head_dim, theta, scaling)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 6, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 6)).astype(np.int32)
    np.testing.assert_allclose(
        tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        atol=1e-6)
    np.testing.assert_allclose(
        tl.rope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                500000.0).numpy(),
        np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)),
        atol=1e-5)


def test_forward_logits_match_jax(tiny):
    jcfg, jparams, tcfg, tparams = tiny
    toks = _tokens(2, 13, jcfg.vocab_size, seed=2)
    lengths = np.array([13, 9], np.int32)
    want, _ = jl.forward(jparams, jcfg, jnp.asarray(toks),
                         lengths=jnp.asarray(lengths))
    got, cache = tl.forward(tparams, tcfg, torch.from_numpy(toks).long(),
                            lengths=torch.from_numpy(lengths))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_prefill_then_decode_equals_full_forward(tiny):
    _, _, cfg, params = tiny
    toks = torch.from_numpy(_tokens(1, 12, cfg.vocab_size, seed=3)).long()
    full, _ = tl.forward(params, cfg, toks)
    cache = tl.KVCache.zeros(cfg, 1, max_len=16, device="cpu")
    logits, cache = tl.forward(params, cfg, toks[:, :8], kv_cache=cache)
    np.testing.assert_allclose(logits.numpy(), full[:, :8].numpy(),
                               atol=ATOL)
    for t in range(8, 12):
        logits, cache = tl.forward(params, cfg, toks[:, t:t + 1],
                                   kv_cache=cache)
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   full[:, t].numpy(), atol=ATOL,
                                   err_msg=f"pos {t}")
    assert int(cache.lengths[0]) == 12


def test_greedy_generate_matches_jax(tiny):
    jcfg, jparams, tcfg, tparams = tiny
    prompt = _tokens(2, 5, jcfg.vocab_size, seed=4)
    want = np.asarray(jl.greedy_generate(jparams, jcfg, jnp.asarray(prompt),
                                         8))
    got = tl.greedy_generate(tparams, tcfg, torch.from_numpy(prompt).long(),
                             8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_params_tree_matches_jax_layout():
    cfg = tl.LlamaConfig.tiny()
    got = tl.init_params(cfg, "cpu", torch.Generator().manual_seed(0))
    want = jl.init_params(jl.LlamaConfig.tiny(), jax.random.PRNGKey(0))
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert shapes(convert.llama_params_to_numpy(got)) == shapes(
        jax.tree.map(np.asarray, want))
    assert all(v.dtype == torch.float32 for v in got["layers"].values())


def test_converter_round_trip_bf16_and_f32():
    cfg = jl.LlamaConfig.tiny()
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        jparams = jl.init_params(dataclasses.replace(cfg, dtype=jdtype),
                                 jax.random.PRNGKey(1))
        tree = jax.tree.map(np.asarray, jparams)
        tparams = convert.llama_params_from_numpy(tree, "cpu", dtype)
        assert tparams["layers"]["wq"].dtype == dtype
        back = convert.llama_params_to_numpy(tparams)
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            np.asarray(a, np.float32), b), tree, back)
