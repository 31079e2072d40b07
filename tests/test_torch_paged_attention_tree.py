"""Port parity: tree-verify attention and K4's verify forms.

The same numpy inputs (ragged lengths with room for the tree, page
tables naming pages in a shuffled order) go through the JAX package's
Pallas kernels in interpret mode -- `paged_tree_attention` (the bf16/f32
tree kernel) and `paged_attention_int8` with `q_rep` / `tree` -- and
through the port's plain versions on the CPU: the gather references of
serving/paged_attention.py and K4's `paged_attention_int8_rep_reference`
(its arithmetic `_tree_keep` mask). All f32, atol = rtol = 2e-5, the
JAX suite's own tolerance for its tree kernels against their references
(tests/test_tree_kernel.py): the sides differ only in summation order
and in where the softmax scale is applied.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.serving import engine_model as jem
from generativeaiexamples_tpu.serving import paged_attention as jpa
from generativeaiexamples_tpu.serving import paged_attention_int8 as jpa8
from generativeaiexamples_tpu.serving import paged_attention_tree as jpt
from generativeaiexamples_tpu_torch.serving import engine_model as tem
from generativeaiexamples_tpu_torch.serving import paged_attention as tpa
from generativeaiexamples_tpu_torch.serving import paged_attention_int8 as tpa8
from generativeaiexamples_tpu_torch.serving import paged_attention_tree as tpt
from test_torch_paged_attention import paged_bf16_split_merge
from test_torch_paged_attention_int8 import paged_int8_split_merge

TOL = dict(atol=2e-5, rtol=2e-5)


def _geom(R, seed=0, B=3, H=4, KH=2, Hd=16, ps=16, maxp=4, P=16):
    """Random f32 q [B, H, R, Hd], one layer's pages, a shuffled table
    and ragged lengths with room for R positions."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, R, Hd)).astype(np.float32)
    kp = rng.standard_normal((KH, P, ps, Hd)).astype(np.float32)
    vp = rng.standard_normal((KH, P, ps, Hd)).astype(np.float32)
    table = rng.choice(np.arange(1, P), (B, maxp), replace=False).astype(
        np.int32)
    lengths = rng.integers(1, maxp * ps - R, (B,)).astype(np.int32)
    lengths[0] = 1  # a row whose prefix is the root alone
    return q, kp, vp, table, lengths


def _int8_pool(kp, vp):
    """An L=1 fused int8 pool through the JAX quantizer."""
    kq, ks = jpa8.quantize_kv(jnp.asarray(kp))
    vq, vs = jpa8.quantize_kv(jnp.asarray(vp))
    return (np.asarray(jnp.stack([kq, vq]))[:, None],
            np.asarray(jnp.stack([ks, vs]))[:, None])


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_tree_layout_matches_jax_and_the_canonical_mask(k):
    for M in (1, 2, 3, 4, 8):
        depth, anc = tem._tree_layout(k, M)
        jdepth, janc = jem._tree_layout(k, M)
        np.testing.assert_array_equal(depth, jdepth)
        np.testing.assert_array_equal(anc, janc)
        np.testing.assert_array_equal(tpt._canonical_tree(k, M), anc)
        np.testing.assert_array_equal(jpt._canonical_tree(k, M), anc)
        assert tpt.tree_shape_of(anc, k, M) == (k, M)
        assert tpt.tree_shape_of(anc, k, M + 1) is None  # wrong shape
        if M * k > 1:
            doctored = anc.copy()
            doctored[-1, 1] = not doctored[-1, 1]
            assert tpt.tree_shape_of(doctored, k, M) is None


@pytest.mark.parametrize("k,M", [(2, 2), (3, 4), (2, 8)])
def test_tree_reference_matches_jax_tree_kernel(k, M):
    r = 1 + k * M
    q, kp, vp, table, ln = _geom(r, seed=k * 10 + M)
    anc = tpt._canonical_tree(k, M)
    kernel = np.asarray(jpt.paged_tree_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, table, ln)), (k, M),
        interpret=True))
    jref = np.asarray(jpa.paged_tree_attention_reference(
        *(jnp.asarray(a) for a in (q, kp, vp, table, ln)), anc))
    ref = tpa.paged_tree_attention_reference(*_t(q, kp, vp, table, ln),
                                             anc).numpy()
    np.testing.assert_allclose(ref, kernel, **TOL)
    np.testing.assert_allclose(ref, jref, **TOL)
    # The K5 wrapper and the dispatcher take the same plain version on
    # the CPU.
    wrap = tpt.paged_tree_attention(*_t(q, kp, vp, table, ln), (k, M))
    disp = tpt.paged_tree_attention_dispatch(*_t(q, kp, vp, table, ln), anc,
                                             k, M)
    assert torch.equal(wrap, torch.from_numpy(ref))
    assert torch.equal(disp, torch.from_numpy(ref))


@pytest.mark.parametrize("per", ["1", "2", "maxp"])
@pytest.mark.parametrize("k,M,ps,plan", [
    (2, 2, 16, (64, 2, 16)),
    # 52 query rows a kv head (4 row tiles), 32 keys a step.
    (3, 4, 16, (64, 2, 32)),
    # Pages of 8 slots: a 16-key step straddles two of them.
    (2, 8, 8, (64, 1, 16)),
])
def test_split_merge_matches_jax_tree_kernel(k, M, ps, plan, per):
    """K5's arithmetic (csrc/paged_bf16.cuh: splits of table slots, ring
    stages, key slices, online softmax, merges in order) in f32 against
    the JAX tree kernel in interpret mode and the reference, for runs of
    one table slot, of two, and of the whole table."""
    r = 1 + k * M
    maxp = 64 // ps
    q, kp, vp, table, ln = _geom(r, seed=k * 7 + M, ps=ps, maxp=maxp,
                                 P=3 * maxp + 2)
    stage_keys, key_slices, step = plan
    got = paged_bf16_split_merge(
        *_t(q, kp, vp, table, ln),
        pages_per_split=maxp if per == "maxp" else int(per),
        stage_keys=stage_keys, key_slices=key_slices, keys_per_step=step,
        tree=(k, M)).numpy()
    kernel = np.asarray(jpt.paged_tree_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, table, ln)), (k, M),
        interpret=True))
    np.testing.assert_allclose(got, kernel, **TOL)
    ref = tpa.paged_tree_attention_reference(
        *_t(q, kp, vp, table, ln), tpt._canonical_tree(k, M)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("k,M", [(2, 2), (3, 4), (2, 8)])
def test_int8_tree_form_matches_jax_kernel(k, M):
    r = 1 + k * M
    q, kf, vf, table, ln = _geom(r, seed=k * 100 + M)
    kv, sc = _int8_pool(kf, vf)
    anc = tpt._canonical_tree(k, M)
    qm = q.transpose(0, 2, 1, 3)                 # [B, r, H, Hd]
    kernel = np.asarray(jpa8.paged_attention_int8(
        *(jnp.asarray(a) for a in (qm, kv, sc, table, ln)), 0, q_rep=r,
        tree=(k, M), interpret=True))
    got = tpa8.paged_attention_int8(*_t(qm, kv, sc, table, ln), 0, q_rep=r,
                                    tree=(k, M)).numpy()
    np.testing.assert_allclose(got, kernel, **TOL)
    # The CUDA kernel's arithmetic (scale on the score columns, the page
    # axis split into runs merged in order) against the same kernel.
    for per in (1, 2, 4):
        split = paged_int8_split_merge(
            *_t(qm, kv[:, 0], sc[:, 0], table, ln), pages_per_split=per,
            tree=(k, M)).numpy()
        np.testing.assert_allclose(split, kernel, **TOL)
    # The gather-then-dequantize twin (the CPU route of the dispatcher)
    # against the JAX one and against K4's arithmetic mask.
    jref = np.asarray(jpa.paged_tree_attention_int8_reference_fused(
        *(jnp.asarray(a) for a in (q, kv[:, 0], sc[:, 0], table, ln)), anc))
    ref = tpt.paged_tree_attention_int8_dispatch(
        *_t(q, kv, sc, table, ln), anc, k, M, 0).numpy()
    np.testing.assert_allclose(ref, jref, **TOL)
    np.testing.assert_allclose(ref.transpose(0, 2, 1, 3), got, **TOL)


@pytest.mark.parametrize("R", [2, 4])
def test_int8_linear_q_rep_matches_jax_kernel(R):
    """Query j of each row attends pos < length + j, over the full
    2-layer pool read at layer 1."""
    q, kf, vf, table, ln = _geom(R, seed=R, H=8, KH=2)
    rng = np.random.default_rng(R + 50)
    kv1, sc1 = _int8_pool(kf, vf)
    kv0, sc0 = _int8_pool(*(rng.standard_normal(kf.shape).astype(np.float32)
                            for _ in range(2)))
    kv = np.concatenate([kv0, kv1], axis=1)
    sc = np.concatenate([sc0, sc1], axis=1)
    qm = q.transpose(0, 2, 1, 3)                 # [B, R, H, Hd]
    kernel = np.asarray(jpa8.paged_attention_int8(
        *(jnp.asarray(a) for a in (qm, kv, sc, table, ln)), 1, q_rep=R,
        interpret=True))
    got = tpa8.paged_attention_int8(*_t(qm, kv, sc, table, ln), 1,
                                    q_rep=R).numpy()
    np.testing.assert_allclose(got, kernel, **TOL)
    for per in (1, 3):  # the CUDA kernel's arithmetic, split and merged
        split = paged_int8_split_merge(
            *_t(qm, kv[:, 1], sc[:, 1], table, ln),
            pages_per_split=per).numpy()
        np.testing.assert_allclose(split, kernel, **TOL)
    # Position j equals a one-query call at length + j.
    for j in range(R):
        one = tpa8.paged_attention_int8(
            *_t(qm[:, j], kv, sc, table, ln + j), 1).numpy()
        np.testing.assert_allclose(got[:, j], one, **TOL)


def test_tree_keep_is_the_canonical_mask():
    """_tree_keep over (node j, slot length-1+t) reproduces the canonical
    ancestor mask, and keeps the whole prefix."""
    for k, M in ((1, 1), (2, 3), (3, 4), (2, 8)):
        r = 1 + k * M
        length = torch.tensor(5)
        t = torch.arange(r)
        keep = tpa8._tree_keep(length - 1 + t[None, :], length,
                               t[:, None], r, (k, M))
        np.testing.assert_array_equal(keep.numpy(),
                                      tpt._canonical_tree(k, M))
        prefix = tpa8._tree_keep(torch.arange(4)[None, :], length,
                                 t[:, None], r, (k, M))
        assert bool(prefix.all())


def test_kernels_refuse_a_non_canonical_mask_on_cuda():
    """On CUDA no route reaches a plain version: a mask the kernels'
    arithmetic does not compute raises in both dispatchers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 and K5 are CUDA kernels")
    q, kp, vp, table, ln = (t.cuda() for t in _t(*_geom(5, seed=1)))
    _, anc = tem._tree_layout(2, 2)
    doctored = anc.copy()
    doctored[2, 1] = False
    with pytest.raises(ValueError, match="canonical"):
        tpt.paged_tree_attention_dispatch(q.bfloat16(), kp.bfloat16(),
                                          vp.bfloat16(), table, ln,
                                          doctored, 2, 2)
    kv, sc = (t.cuda() for t in _t(*_int8_pool(kp.cpu().numpy(),
                                                vp.cpu().numpy())))
    with pytest.raises(ValueError, match="canonical"):
        tpt.paged_tree_attention_int8_dispatch(q.bfloat16(), kv, sc, table,
                                               ln, doctored, 2, 2, 0)


def test_tree_kernel_matches_plain_version_on_cuda():
    """K5 on the card (skips without one) against its plain version in
    f32, node by node within 1e-2 of each node's max |out| (bf16 output,
    q scaled up so the scores are sharp): at B = 2 (the span split
    across CTAs) and with pages of 8 slots, and a repeat launch gives the
    same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5 is a CUDA kernel")
    for ps, maxp in ((128, 9), (8, 40)):
        q, kp, vp, table, ln = (t.cuda() for t in _t(*_geom(
            13, seed=ps, B=2, H=32, KH=8, Hd=128, ps=ps, maxp=maxp,
            P=2 * maxp + 2)))
        q, kp, vp = (q * 8).bfloat16(), kp.bfloat16(), vp.bfloat16()
        got = tpt.paged_tree_attention(q, kp, vp, table, ln, (3, 4))
        want = tpa.paged_tree_attention_reference(
            q.float(), kp.float(), vp.float(), table, ln,
            tpt._canonical_tree(3, 4))
        per_node = lambda t: t.transpose(1, 2).reshape(2 * 13, -1)  # noqa: E731
        diff = per_node(got.float() - want).abs().amax(1)
        assert float((diff / per_node(want).abs().amax(1)).max()) <= 1e-2
        assert torch.equal(got, tpt.paged_tree_attention(
            q, kp, vp, table, ln, (3, 4)))
