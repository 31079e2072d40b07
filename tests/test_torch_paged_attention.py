"""Port parity: serving/paged_attention.py (K2's plain version and the
engine's dispatcher).

The same numpy inputs go through the JAX package's `paged_attention`
(Pallas, interpret mode) and `paged_attention_reference`, and the port's
`paged_attention_dispatch` on the CPU. Page tables name pages in a
shuffled order and leave their tail slots at sink page 0, as the engine
does. All f32; tolerance 2e-5, the bound the JAX package's own
kernel-vs-reference test uses (tests/test_serving.py): the two sides
differ only in summation order.

`paged_bf16_split_merge` is the arithmetic of the CUDA kernels K2 and K5
(csrc/paged_bf16.cuh) in plain f32: runs of table slots split across
CTAs, ring stages cut into key slices, an online softmax over each
slice's steps, slices and splits merged in order. It is held against the
JAX kernels in interpret mode, and `paged_bf16_plan` (the launch plan)
is checked at the card's 132 SMs.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from generativeaiexamples_tpu.serving import paged_attention as jpa
from generativeaiexamples_tpu_torch.serving import paged_attention as tpa
from generativeaiexamples_tpu_torch.serving.paged_attention_int8 import (
    _tree_keep)

ATOL = 2e-5
N_SMS = 132  # an H100 SXM, the card the plan's choices were measured on
CTA_TARGET = tpa.CTAS_PER_SM * N_SMS


def paged_bf16_split_merge(q, k_pages, v_pages, page_table, lengths, *,
                           pages_per_split: int, stage_keys: int = 64,
                           key_slices: int = 1, keys_per_step: int = 16,
                           scale=None, tree=None):
    """The kernels' arithmetic in plain f32 torch over one layer's pages:
    q [B, H, R, Hd] (R = 1 for K2, the tree's nodes for K5, whose lengths
    are clamped to >= 1). Each split of `pages_per_split` table slots
    reads its slots below the row's span in ring stages of `stage_keys`
    slots; key slice i of `key_slices` takes the i-th equal part of every
    stage in steps of `keys_per_step` keys, with an online softmax (m, l,
    acc) over its steps; the slices merge in slice order, then the splits
    in split order (m = max m_i, acc = sum exp(m_i - m) acc_i, l likewise),
    and acc / l is returned, l = 0 divided by 1."""
    B, H, R, Hd = q.shape
    KH, _, ps, _ = k_pages.shape
    maxp = page_table.shape[1]
    s = scale if scale is not None else Hd ** -0.5
    k = tpa._gather_pages(k_pages, page_table).float()   # [B, KH, S, Hd]
    v = tpa._gather_pages(v_pages, page_table).float()
    S = k.shape[2]
    qg = q.float().reshape(B, KH, H // KH, R, Hd)
    logits = torch.einsum("bkgrd,bksd->bkgrs", qg, k) * s
    length = lengths.long().clamp(min=1 if tree is not None else 0)
    pos = torch.arange(S)
    jrow = torch.arange(R)[None, :, None]
    L = length[:, None, None]
    keep = (_tree_keep(pos[None, None, :], L, jrow, R, tree)
            if tree is not None else pos[None, None, :] < L + jrow)
    span = (length + R - 1).clamp(min=0, max=maxp * ps)       # [B]

    def fresh():
        m = torch.full((B, KH, H // KH, R), tpa.NEG_INF)
        return m, torch.zeros_like(m), torch.zeros((B, KH, H // KH, R, Hd))

    def merge(state, part):
        (m, l, acc), (m2, l2, acc2) = state, part
        mn = torch.maximum(m, m2)
        f, g = torch.exp(m - mn), torch.exp(m2 - mn)
        return mn, l * f + l2 * g, acc * f[..., None] + acc2 * g[..., None]

    total = fresh()
    run = pages_per_split * ps
    for s0 in range(0, maxp * ps, run):
        end = torch.minimum(span, torch.tensor(s0 + run))     # [B]
        ok = (keep & (pos < end[:, None, None]))[:, None, None]  # [B,1,1,R,S]
        split = None
        for i in range(key_slices):
            m, l, acc = fresh()
            width = stage_keys // key_slices
            for st in range(s0, s0 + run, stage_keys):
                for c0 in range(st + i * width, st + (i + 1) * width,
                                keys_per_step):
                    cols = slice(c0, min(c0 + keys_per_step, S))
                    if cols.start >= S:
                        continue
                    live = ok[..., cols]
                    lg = torch.where(live, logits[..., cols],
                                     torch.full_like(logits[..., cols],
                                                     tpa.NEG_INF))
                    mn = torch.maximum(m, lg.amax(-1))
                    p = torch.where(live, torch.exp(lg - mn[..., None]), 0.0)
                    a = torch.exp(m - mn)
                    l = l * a + p.sum(-1)
                    acc = acc * a[..., None] + torch.einsum(
                        "bkgrs,bksd->bkgrd", p, v[:, :, cols])
                    m = mn
            split = (m, l, acc) if split is None else merge(split, (m, l, acc))
        total = merge(total, split)
    m, l, acc = total
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.reshape(B, H, R, Hd)


def _inputs(B, H, KH, Hd, ps, maxp, lengths, seed):
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    q = rng.standard_normal((B, H, Hd)).astype(np.float32)
    kp = rng.standard_normal((KH, P, ps, Hd)).astype(np.float32)
    vp = rng.standard_normal((KH, P, ps, Hd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, P))
    table = np.zeros((B, maxp), np.int32)  # tail slots: sink page 0
    used = 0
    for b, n in enumerate(lengths):
        need = -(-n // ps)
        table[b, :need] = perm[used:used + need]
        used += need
    return q, kp, vp, table, np.asarray(lengths, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _port(q, kp, vp, table, lengths):
    return tpa.paged_attention_dispatch(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(lengths)).numpy()


@pytest.mark.parametrize("B,H,KH,Hd,ps,maxp,lengths", [
    (2, 4, 2, 16, 8, 4, [32, 19]),
    (3, 8, 2, 32, 16, 4, [1, 17, 64]),
    (2, 4, 4, 16, 8, 6, [8, 9]),
])
def test_dispatch_matches_jax_kernel_and_reference(B, H, KH, Hd, ps, maxp,
                                                   lengths):
    args = _inputs(B, H, KH, Hd, ps, maxp, lengths, seed=B * ps)
    got = _port(*args)
    jargs = [jnp.asarray(a) for a in args]
    want_ref = np.asarray(jpa.paged_attention_reference(*jargs))
    want_kernel = np.asarray(jpa.paged_attention(*jargs, interpret=True))
    np.testing.assert_allclose(got, want_ref, atol=ATOL)
    np.testing.assert_allclose(got, want_kernel, atol=ATOL)


@pytest.mark.parametrize("per", ["1", "2", "maxp"])
@pytest.mark.parametrize("B,H,KH,Hd,ps,maxp,lengths,plan", [
    # G = 2, pages of 8 slots: a 16-key step straddles two pages and a
    # stage holds eight of them.
    (2, 4, 2, 16, 8, 4, [32, 19], (64, 4, 16)),
    # G = 4 (the 8B group), a length-0 row, 32 keys a step.
    (3, 8, 2, 32, 16, 4, [0, 17, 64], (64, 2, 32)),
    # A page of 24 slots: boxes of gcd(24, 32) = 8 rows, stages that end
    # inside a page.
    (2, 4, 1, 16, 24, 3, [70, 25], (32, 2, 16)),
])
def test_split_merge_matches_jax_kernel(B, H, KH, Hd, ps, maxp, lengths,
                                        plan, per):
    """The kernels' split, stage, slice and merge arithmetic in f32
    against the JAX Pallas kernel in interpret mode and the reference,
    for runs of one table slot, of two, and of the whole table."""
    q, kp, vp, table, ln = _inputs(B, H, KH, Hd, ps, maxp, lengths,
                                   seed=B + ps)
    pages_per_split = maxp if per == "maxp" else int(per)
    stage_keys, key_slices, step = plan
    got = paged_bf16_split_merge(
        *_t(q[:, :, None], kp, vp, table, ln),
        pages_per_split=pages_per_split, stage_keys=stage_keys,
        key_slices=key_slices, keys_per_step=step)[:, :, 0].numpy()
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, ln)]
    kernel = np.asarray(jpa.paged_attention(*jargs, interpret=True))
    np.testing.assert_allclose(got, kernel, atol=ATOL)
    live = ln > 0  # the reference gives a length-0 row no defined value
    want = _port(q, kp, vp, table, ln)
    np.testing.assert_allclose(got[live], want[live], atol=ATOL)
    assert not np.any(got[~live])  # zeros, as the kernel writes


@pytest.mark.parametrize("rows", [4, 52])
@pytest.mark.parametrize("ps", [8, 16, 128])
@pytest.mark.parametrize("B", [1, 8, 32, 64])
def test_paged_bf16_plan_fills_the_card(B, ps, rows):
    """The K2 / K5 launch plan at the 8B shape (KH = 8, head_dim 128,
    max_seq 8192) for decode (4 query rows a kv head) and the (3, 4)
    tree (52): 16-row tiles holding every row, at most 8 consumer warps
    whose key slices cut a 128-slot stage into whole steps, a ring within
    its bytes, splits that cover the table in order and bring B x KH x
    splits close to the target when B x KH alone falls short of it
    (unless the shortest run holds them back), and a workspace of one
    partial per (row, kv head, split, row tile) exactly when split."""
    KH, Hd, maxp = 8, 128, 8192 // ps
    plan = tpa.paged_bf16_plan(B, KH, rows, Hd, ps, maxp, N_SMS)
    assert plan.row_tiles == -(-rows // 16)
    assert plan.row_tiles * plan.key_slices <= tpa.MAX_WARPS
    assert plan.stage_keys == 128 and plan.ring_stages >= 2
    assert plan.ring_stages * 4 * plan.stage_keys * Hd <= tpa.RING_BYTES
    width = plan.stage_keys // plan.key_slices
    assert width % plan.keys_per_step == 0 and width >= 16
    assert plan.keys_per_step == (32 if width % 32 == 0 else 16)
    assert plan.splits * plan.pages_per_split >= maxp
    assert (plan.splits - 1) * plan.pages_per_split < maxp
    shortest = -(-tpa.MIN_SPLIT_SLOTS // ps)
    assert plan.splits == 1 or plan.pages_per_split >= shortest
    ctas = B * KH
    if ctas >= CTA_TARGET:
        assert plan.splits == 1
    else:
        assert ctas * plan.splits <= CTA_TARGET
        assert (ctas * plan.splits >= 0.5 * CTA_TARGET
                or plan.pages_per_split == shortest)
    want = (4 * ctas * plan.splits * plan.row_tiles * (Hd // 2 + 4) * 32
            if plan.splits > 1 else 0)
    assert plan.workspace_bytes == want
    assert tpa.paged_bf16_plan(B, KH, rows, Hd, ps, maxp,
                               N_SMS) is plan  # cached


def test_paged_bf16_plan_small_shapes_and_limits():
    """head_dim 64 stages 128 slots in a deeper ring; a table shorter than
    the shortest run, or a launch that fills the card, is not split and
    keeps 32 keys a step; more than 128 rows a kv head are refused."""
    plan = tpa.paged_bf16_plan(2, 2, 4, 64, 8, 256, N_SMS)
    assert plan.stage_keys == 128 and plan.ring_stages == 4
    assert plan.key_slices == 8 and plan.keys_per_step == 16
    assert plan.pages_per_split == 64 and plan.splits == 4
    plan = tpa.paged_bf16_plan(2, 2, 4, 64, 8, 8, N_SMS)
    assert plan.splits == 1 and plan.key_slices == 4
    plan = tpa.paged_bf16_plan(128, 8, 4, 128, 128, 64, N_SMS)
    assert plan.splits == 1 and plan.workspace_bytes == 0
    assert plan.key_slices == 4 and plan.keys_per_step == 32
    with pytest.raises(ValueError, match="query rows"):
        tpa.paged_bf16_plan(1, 1, 129, 128, 128, 4, N_SMS)


def test_sink_page_contents_do_not_change_the_result():
    """Tail slots point at page 0; whatever the sink holds (padding k/v
    of earlier prefills) is masked out by `lengths`."""
    q, kp, vp, table, lengths = _inputs(2, 4, 2, 16, 8, 4, [5, 20], seed=3)
    base = _port(q, kp, vp, table, lengths)
    kp[:, 0] = 1e3
    vp[:, 0] = -1e3
    np.testing.assert_allclose(_port(q, kp, vp, table, lengths), base,
                               atol=ATOL)


def test_quantized_form_is_not_ported_yet():
    """Kept under its first name, though every form is ported now: the
    fused int8 pool goes to K4's wrapper, whose plain version equals the
    dequantized pages through the dispatcher's bf16/f32 form, and whose
    verify forms take q as [B, R, H, Hd] (a [B, H, Hd] q with q_rep > 1
    is refused)."""
    from generativeaiexamples_tpu_torch.serving import (
        paged_attention_int8 as tpa8)

    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in _inputs(
        1, 2, 1, 16, 8, 2, [3], seed=0))
    (kq, ks), (vq, vs) = tpa8.quantize_kv(kp), tpa8.quantize_kv(vp)
    kv, scales = tpa8.fuse_kv(kq, ks, vq, vs)
    got = tpa8.paged_attention_int8(q, kv[:, None], scales[:, None], table,
                                    lengths, 0)
    want = tpa.paged_attention_dispatch(
        q, tpa8.dequantize_pages(kq, ks), tpa8.dequantize_pages(vq, vs),
        table, lengths)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    with pytest.raises(ValueError, match="q_rep"):
        tpa8.paged_attention_int8(q, kv[:, None], scales[:, None], table,
                                  lengths, 0, q_rep=2)


def test_paged_wrapper_refuses_other_devices():
    q = torch.empty((1, 2, 64), device="meta")
    pages = torch.empty((1, 3, 8, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpa.paged_attention(q, pages, pages,
                            torch.zeros((1, 2), dtype=torch.int32),
                            torch.ones((1,), dtype=torch.int32))


def test_paged_kernel_matches_reference_on_cuda():
    """K2 on the card against the plain version (bf16 inputs, reference
    in f32). Tolerance 2e-2: the output is rounded to bf16; an indexing
    or masking fault gives O(1) errors. B = 3 splits the page axis (3 x 8
    CTAs leave the card idle), pages of 8 slots put two pages in one
    16-key step, and a repeat launch gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 is a CUDA kernel")
    for ps, maxp in ((128, 4), (8, 64)):
        q, kp, vp, table, lengths = (
            torch.from_numpy(a).cuda() for a in _inputs(
                3, 32, 8, 128, ps, maxp, [1, 130, 512], seed=5))
        q, kp, vp = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
        got = tpa.paged_attention_dispatch(q, kp, vp, table, lengths)
        want = tpa.paged_attention_reference(q.float(), kp.float(),
                                             vp.float(), table, lengths)
        torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=0)
        assert torch.equal(got, tpa.paged_attention_dispatch(
            q, kp, vp, table, lengths))
