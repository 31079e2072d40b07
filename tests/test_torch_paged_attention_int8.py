"""Port parity: serving/paged_attention_int8.py (K4's plain version over
the full fused pool).

The same numpy inputs go through the JAX package's `quantize_kv`,
`paged_attention_int8` (Pallas, interpret mode) and
`paged_attention_int8_reference_fused`, and the port's functions on the
CPU. The pool is the FULL fused pool [2, L, KH, P, ps, Hd] with a nonzero
`layer`, page tables name pages in a shuffled order and leave their tail
slots at sink page 0. All f32; tolerance 1e-5: the two sides differ only
in summation order and in where the softmax scale is applied (the kernel
folds it into q, the reference scales the scores), each ~1e-7 here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.serving import paged_attention_int8 as jpa
from generativeaiexamples_tpu_torch.serving import paged_attention_int8 as tpa8

ATOL = 1e-5
N_SMS = 132  # an H100 SXM, the card the plan's choices were measured on
CTA_TARGET = tpa8.CTAS_PER_SM * N_SMS


def paged_int8_split_merge(q, kv_pages, kv_scales, page_table, lengths, *,
                           pages_per_split: int, scale=None, tree=None):
    """K4's split path's arithmetic in plain f32 torch, over ONE layer of
    the fused pool: q [B, R, H, Hd], unscaled, with scale * kscale on the
    score columns. Each run of `pages_per_split` table slots yields a
    partial (running max m, denominator l, unnormalised sum acc) over the
    slots it holds that the query may see; the partials are merged in
    split order (m = max m_i, acc = sum exp(m_i - m) acc_i, l likewise)
    and acc / l returned, as the kernel's last CTA merges its splits'
    workspace. A split past a row's span holds no partial."""
    B, R, H, Hd = q.shape
    KH, ps = kv_pages.shape[1], kv_pages.shape[3]
    maxp = page_table.shape[1]
    s = scale if scale is not None else Hd ** -0.5
    gather = tpa8._gather_pages
    codes = gather(kv_pages[0], page_table).float()   # [B, KH, S, Hd]
    ksc = gather(kv_scales[0], page_table).float()
    vcodes = gather(kv_pages[1], page_table).float()
    vsc = gather(kv_scales[1], page_table).float()
    qg = q.float().reshape(B, R, KH, H // KH, Hd)
    logits = torch.einsum("brkgd,bksd->brkgs", qg, codes) * ksc[:, None, :,
                                                                 None, :] * s
    S = logits.shape[-1]
    length = lengths.clamp(min=1).long()[:, None, None]
    pos = torch.arange(S)[None, None, :]
    jrow = torch.arange(R)[None, :, None]
    keep = (tpa8._tree_keep(pos, length, jrow, R, tree) if tree is not None
            else pos < length + jrow)                          # [B, R, S]
    span = torch.clamp(length[:, 0, 0] + R - 1, max=maxp * ps)
    m = torch.full((B, R, KH, H // KH), tpa8.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, R, KH, H // KH, Hd))
    for start in range(0, maxp * ps, pages_per_split * ps):
        cols = slice(start, start + pages_per_split * ps)
        live = (start < span).float()[:, None, None, None]  # split exists
        k = keep[:, :, cols][:, :, None, None, :]
        lg = torch.where(k, logits[..., cols], torch.full_like(
            logits[..., cols], tpa8.NEG_INF))
        mi = lg.amax(-1)
        p = torch.where(k, torch.exp(lg - mi[..., None]), 0.0)
        li = p.sum(-1)
        ai = torch.einsum("brkgs,bksd->brkgd", p * vsc[:, None, :, None, cols],
                          vcodes[:, :, cols])
        mi = torch.where(live > 0, mi, torch.full_like(mi, tpa8.NEG_INF))
        mn = torch.maximum(m, mi)
        f, g = torch.exp(m - mn), torch.exp(mi - mn) * live
        acc = acc * f[..., None] + ai * g[..., None]
        l = l * f + li * g
        m = mn
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.reshape(B, R, H, Hd)


def _pool(L, KH, P, ps, Hd, seed):
    """Quantized pages from f32 rows, through the JAX quantizer."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, L, KH, P, ps, Hd)).astype(np.float32)
    q, s = jpa.quantize_kv(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


def _inputs(B, H, KH, Hd, ps, maxp, lengths, L=2, seed=0):
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    q = rng.standard_normal((B, H, Hd)).astype(np.float32)
    kv, sc = _pool(L, KH, P, ps, Hd, seed + 1)
    perm = rng.permutation(np.arange(1, P))
    table = np.zeros((B, maxp), np.int32)
    used = 0
    for b, n in enumerate(lengths):
        need = -(-max(n, 1) // ps)
        table[b, :need] = perm[used:used + need]
        used += need
    return q, kv, sc, table, np.asarray(lengths, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_quantize_kv_bit_identical():
    x = np.random.default_rng(0).standard_normal((3, 2, 5, 16, 64)).astype(
        np.float32) * 3
    x[0, 0, 0, 0] = 0.0  # an all-zero row: the 1e-8 clip
    jq, js = jpa.quantize_kv(jnp.asarray(x))
    tq, ts = tpa8.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tpa8.dequantize_pages(tq, ts).numpy(),
        np.asarray(jpa.dequantize_pages(jq, js)))
    kq, vq = tq[0], tq[1]
    ks, vs = ts[0], ts[1]
    fkv, fs = tpa8.fuse_kv(kq, ks, vq, vs)
    jkv, jfs = jpa.fuse_kv(jq[0], js[0], jq[1], js[1])
    np.testing.assert_array_equal(fkv.numpy(), np.asarray(jkv))
    np.testing.assert_array_equal(fs.numpy(), np.asarray(jfs))


@pytest.mark.parametrize("B,H,KH,lengths,layer", [
    (3, 8, 2, [5, 37, 64], 1),     # G = 4, ragged, a full last page
    (3, 2, 2, [1, 16, 50], 0),     # G = 1
    (2, 8, 2, [0, 33], 1),         # a length-0 row: clamped to 1
])
def test_plain_version_matches_jax_kernel_and_reference(B, H, KH, lengths,
                                                        layer):
    Hd, ps, maxp = 128, 16, 4
    q, kv, sc, table, ln = _inputs(B, H, KH, Hd, ps, maxp, lengths)
    kernel = np.asarray(jpa.paged_attention_int8(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(sc),
        jnp.asarray(table), jnp.asarray(ln), layer, interpret=True))
    got = tpa8.paged_attention_int8(*_t(q, kv, sc, table, ln), layer).numpy()
    np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=0)
    # The JAX reference takes lengths as given; compare where none is 0.
    clamped = np.maximum(ln, 1)
    ref = np.asarray(jpa.paged_attention_int8_reference_fused(
        jnp.asarray(q), jnp.asarray(kv[:, layer]), jnp.asarray(sc[:, layer]),
        jnp.asarray(table), jnp.asarray(clamped)))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    tref = tpa8.paged_attention_int8_reference_fused(
        *_t(q, kv[:, layer], sc[:, layer], table, clamped)).numpy()
    np.testing.assert_allclose(tref, ref, atol=ATOL, rtol=0)


def test_layer_is_indexed_inside_the_wrapper():
    """The wrapper takes the FULL fused pool and reads `layer` from it:
    the same as handing it that layer's one-layer pool at layer 0."""
    q, kv, sc, table, ln = _inputs(2, 8, 2, 128, 16, 3, [20, 41], L=3,
                                   seed=3)
    got = tpa8.paged_attention_int8(*_t(q, kv, sc, table, ln), 2)
    want = tpa8.paged_attention_int8(
        *_t(q, kv[:, 2:3], sc[:, 2:3], table, ln), 0)
    assert torch.equal(got, want)


def test_unported_speculative_forms_raise():
    """Kept under its first name: the verify forms are ported
    (tests/test_torch_paged_attention_tree.py), and what they refuse is a
    q that is not [B, q_rep, H, Hd] or a tree whose node count is not
    q_rep."""
    q, kv, sc, table, ln = _t(*_inputs(2, 8, 2, 128, 16, 3, [20, 41]))
    with pytest.raises(ValueError, match="q_rep"):
        tpa8.paged_attention_int8(q, kv, sc, table, ln, 0, q_rep=2)
    with pytest.raises(ValueError, match="q_rep"):
        tpa8.paged_attention_int8(q, kv, sc, table, ln, 0, tree=(2, 2))
    q4 = q[:, None].expand(2, 3, 8, 128).contiguous()
    with pytest.raises(ValueError, match="q_rep"):
        tpa8.paged_attention_int8(q4, kv, sc, table, ln, 0, q_rep=5,
                                  tree=(2, 2))


# K4's 8B geometry (H = 32, KH = 8, head_dim 128, page 128, max_seq 8192)
# and the query rows a kv head of each form: q_rep 1, 2, 4 and the (3, 4)
# and (2, 8) trees.
K4_ROWS = {"q_rep1": 4, "q_rep2": 8, "q_rep4": 16, "tree34": 52, "tree28": 68}


@pytest.mark.parametrize("form", sorted(K4_ROWS))
@pytest.mark.parametrize("B", [8, 128])
def test_paged_int8_plan_fills_the_card(form, B):
    """K4's launch plan at the 8B shapes: 16-row tiles that hold every
    query row, at most 8 consumer warps whose key slices cut a page into
    whole steps, splits only where B x KH CTAs are fewer than the target
    (and then close to it), runs of table slots that cover the table in
    order, and a workspace of one partial per (row, kv head, split, row
    tile) exactly when split."""
    rows, maxp = K4_ROWS[form], 64
    plan = tpa8.paged_int8_plan(B, 8, rows, 128, 128, maxp, N_SMS)
    assert plan.row_tiles == -(-rows // 16) and plan.row_tiles * 16 >= rows
    assert plan.row_tiles * plan.key_slices <= tpa8.MAX_WARPS
    assert (128 // plan.key_slices) % plan.keys_per_step == 0
    # Key slices spread a page's keys over the warps the tiles leave: all
    # of them when split (16 keys a step at least), else 32 keys a step.
    most = tpa8.MAX_WARPS // plan.row_tiles
    assert plan.key_slices == (most if plan.splits > 1 else min(4, most))
    assert plan.keys_per_step == (16 if plan.key_slices == 8 else 32)
    ctas = B * 8
    assert plan.splits * plan.pages_per_split >= maxp
    assert (plan.splits - 1) * plan.pages_per_split < maxp
    if ctas >= CTA_TARGET:
        assert plan.splits == 1
    else:
        assert ctas * plan.splits <= CTA_TARGET
        assert ctas * plan.splits >= 0.5 * CTA_TARGET
    want = (4 * ctas * plan.splits * plan.row_tiles * (128 // 2 + 4) * 32
            if plan.splits > 1 else 0)
    assert plan.workspace_bytes == want
    assert tpa8.paged_int8_plan(B, 8, rows, 128, 128, maxp,
                                N_SMS) is plan  # cached


def test_paged_int8_plan_small_pages_and_limits():
    plan = tpa8.paged_int8_plan(4, 2, 68, 64, 16, 64, N_SMS)  # tree (2, 8)
    assert plan.key_slices == 1 and plan.keys_per_step == 16
    assert tpa8.paged_int8_plan(3, 2, 4, 128, 16, 32,
                                N_SMS).keys_per_step == 16
    assert tpa8.paged_int8_plan(3, 2, 4, 128, 64, 32, N_SMS).key_slices == 4
    assert tpa8.paged_int8_plan(64, 8, 4, 128, 64, 32, N_SMS).key_slices == 2
    with pytest.raises(ValueError, match="query rows"):
        tpa8.paged_int8_plan(1, 1, 129, 128, 128, 4, N_SMS)


@pytest.mark.parametrize("pages_per_split", [1, 2, 3, 8])
@pytest.mark.parametrize("lengths", [[5, 37, 64], [0, 1, 16], [50, 17, 3]])
def test_split_merge_matches_reference(pages_per_split, lengths):
    """The split path's arithmetic (partials per run of table slots,
    merged in split order, scale applied to the score columns) equals the
    plain version in f32, for runs shorter than, across and longer than
    each row's pages."""
    q, kv, sc, table, ln = _t(*_inputs(3, 8, 2, 128, 16, 4, lengths,
                                       seed=sum(lengths)))
    got = paged_int8_split_merge(q[:, None], kv[:, 1], sc[:, 1], table,
                                      ln, pages_per_split=pages_per_split)
    want = tpa8.paged_attention_int8_reference_fused(
        q, kv[:, 1], sc[:, 1], table, ln.clamp(min=1))
    np.testing.assert_allclose(got[:, 0].numpy(), want.numpy(), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("pages_per_split", [1, 3])
def test_scale_off_q_matches_jax_kernel(pages_per_split):
    """The kernel's arithmetic, q unscaled and scale * kscale on the score
    columns, against the JAX Pallas kernel (scale folded into q) in
    interpret mode, on a 2-layer pool read at layer 1."""
    q, kv, sc, table, ln = _inputs(3, 8, 2, 128, 16, 4, [5, 37, 64], seed=9)
    kernel = np.asarray(jpa.paged_attention_int8(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(sc),
        jnp.asarray(table), jnp.asarray(ln), 1, interpret=True))
    qt, kvt, sct, tt, lt = _t(q, kv, sc, table, ln)
    got = paged_int8_split_merge(qt[:, None], kvt[:, 1], sct[:, 1], tt,
                                      lt, pages_per_split=pages_per_split)
    np.testing.assert_allclose(got[:, 0].numpy(), kernel, atol=ATOL, rtol=0)


def _row_rel_err(got, want, rows):
    diff = (got.float() - want).abs().reshape(rows, -1).amax(1)
    return float((diff / want.abs().reshape(rows, -1).amax(1)).max())


def test_paged_int8_kernel_matches_plain_version_on_cuda():
    """K4 on the card (skips without one), bf16 q scaled up so that the
    scores are sharp and every row's output is O(1), within 1e-2 of each
    row's max |out| (the bf16 output rounds by up to 2^-8 of it): the
    unsplit decode form at B = 4, then B = 2 with the page axis split
    (two rows x eight kv heads leave the card idle), the split's workspace
    merge bit-identical on a repeat launch, and the verify forms (q_rep 2
    and the (3, 4) tree) split and unsplit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 is a CUDA kernel")
    q, kv, sc, table, ln = (t.cuda() for t in _t(*_inputs(
        4, 32, 8, 128, 128, 8, [1, 130, 700, 1024], seed=5)))
    q = (q * 8).bfloat16()
    got = tpa8.paged_attention_int8(q, kv, sc, table, ln, 1)
    want = tpa8.paged_attention_int8_reference_fused(
        q.float(), kv[:, 1], sc[:, 1], table, ln)
    assert _row_rel_err(got, want, 4) <= 1e-2
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert tpa8.paged_int8_plan(4, 8, 4, 128, 128, 8, n_sms).splits > 1
    again = tpa8.paged_attention_int8(q, kv, sc, table, ln, 1)
    assert torch.equal(got, again)
    for R, tree in ((2, None), (13, (3, 4))):
        qr = q[:, None].expand(4, R, 32, 128).contiguous()
        got = tpa8.paged_attention_int8(qr, kv, sc, table, ln, 1, q_rep=R,
                                        tree=tree)
        want = tpa8.paged_attention_int8_rep_reference(
            qr.float(), kv[:, 1], sc[:, 1], table, ln, tree=tree)
        assert _row_rel_err(got, want, 4 * R) <= 1e-2
        assert torch.equal(got, tpa8.paged_attention_int8(
            qr, kv, sc, table, ln, 1, q_rep=R, tree=tree))
