"""Port parity: serving/sampling.py.

Masks and greedy picks must equal the JAX package's on the same logits.
Categorical draws use a torch.Generator and cannot reproduce jax.random's
bits, so sampled tokens are checked against the mask instead: every draw
lies inside the top-k / top-p set that JAX computes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.serving import sampling as js
from generativeaiexamples_tpu_torch.serving import sampling as ts


def _logits(B=4, V=64, seed=0):
    return np.random.default_rng(seed).standard_normal((B, V)).astype(
        np.float32) * 3


@pytest.mark.parametrize("top_k", [[0, 1, 5, 64], [3, 3, 70, 0]])
def test_top_k_mask_matches_jax(top_k):
    lg = _logits()
    k = np.asarray(top_k, np.int32)
    np.testing.assert_array_equal(
        ts._mask_top_k(torch.from_numpy(lg), torch.from_numpy(k)).numpy(),
        np.asarray(js._mask_top_k(jnp.asarray(lg), jnp.asarray(k))))


@pytest.mark.parametrize("top_p", [[1.0, 0.9, 0.5, 0.0], [0.2, 0.99, 1e-3,
                                                          0.75]])
def test_top_p_mask_matches_jax(top_p):
    lg = _logits(seed=1)
    p = np.asarray(top_p, np.float32)
    got = ts._mask_top_p(torch.from_numpy(lg), torch.from_numpy(p)).numpy()
    want = np.asarray(js._mask_top_p(jnp.asarray(lg), jnp.asarray(p)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)],
                                  want[np.isfinite(want)])


def test_greedy_matches_jax():
    lg = _logits(seed=2)
    sp_t = ts.SamplingParams.make(4)
    sp_j = js.SamplingParams.make(4)
    for all_greedy in (True, False):
        got = ts.sample(torch.from_numpy(lg), sp_t, None,
                        all_greedy=all_greedy)
        want = js.sample(jnp.asarray(lg), sp_j, jax.random.PRNGKey(0),
                         all_greedy=all_greedy)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32


def test_sampled_tokens_stay_inside_the_jax_mask():
    lg = _logits(B=4, V=64, seed=3)
    temp = np.array([0.0, 0.7, 1.0, 1.5], np.float32)
    top_p = np.array([1.0, 0.8, 0.9, 0.5], np.float32)
    top_k = np.array([0, 8, 0, 4], np.int32)
    scaled = jnp.asarray(lg) / jnp.maximum(jnp.asarray(temp), 1e-6)[:, None]
    allowed = np.isfinite(np.asarray(js._mask_top_p(
        js._mask_top_k(scaled, jnp.asarray(top_k)), jnp.asarray(top_p))))
    sp = ts.SamplingParams(*(torch.from_numpy(a) for a in (temp, top_p,
                                                           top_k)))
    g = torch.Generator().manual_seed(0)
    greedy = lg.argmax(-1)
    seen = set()
    for _ in range(200):
        tok = ts.sample(torch.from_numpy(lg), sp, g).numpy()
        assert tok[0] == greedy[0]  # temperature 0 rows stay greedy
        for b in range(1, 4):
            assert allowed[b, tok[b]], (b, tok[b])
        seen.add(int(tok[2]))
    assert len(seen) > 1  # the draw is a draw, not an argmax


def test_sampling_params_make_matches_jax():
    t = ts.SamplingParams.make(3, temperature=0.5, top_p=0.9, top_k=7)
    j = js.SamplingParams.make(3, temperature=0.5, top_p=0.9, top_k=7)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert str(a.dtype).split(".")[-1] == np.asarray(b).dtype.name
