"""Port parity: training/{trainer,lora,retriever_ft}.py and the
differentiable attention route.

The JAX package's tiny f32 Llama and BERT weights (from a seed) are
carried across with models/convert.py, and the same numpy batches go
through both packages' losses, gradients and optimizer steps (optax in
JAX; the port writes the same chain out). Tolerance: 1e-5 of each
leaf's largest magnitude for losses, gradients and parameters after 3
steps (both sides compute in f32 and differ only in summation order).
"""

import ast
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import bert as jbert
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.training import lora as jlora
from generativeaiexamples_tpu.training import retriever_ft as jrft
from generativeaiexamples_tpu.training import trainer as jtr
from generativeaiexamples_tpu.utils.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.models import bert as tbert
from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.training import lora as tlora
from generativeaiexamples_tpu_torch.training import retriever_ft as trft
from generativeaiexamples_tpu_torch.training import trainer as ttr

RTOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "generativeaiexamples_tpu_torch"


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _close_trees(got, want, rtol=RTOL, noise=()):
    """Every leaf of the port's tree within rtol x the JAX leaf's largest
    magnitude (a numpy tree, same keys). Leaves named in `noise` have a
    zero gradient in exact arithmetic (BERT's key bias: softmax ignores
    a constant added to each query's scores), so both packages hold
    rounding noise there, which Adam then scales up; they are held to be
    small instead of equal."""
    n = 0
    for path, leaf in _walk(got):
        w = np.asarray(_at(want, path), np.float32)
        g = leaf.detach().float().numpy()
        if path[-1] in noise:
            assert max(float(np.abs(w).max()), float(np.abs(g).max())) \
                <= 1e-4, path
            n += 1
            continue
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= rtol * scale, (path, err, scale)
        n += 1
    return n


def _grads_tree(tree, grads):
    return ttr.tree_rebuild(tree, grads)


@pytest.fixture(scope="module")
def llama_pair():
    cfg = jl.LlamaConfig.tiny()
    jparams = jl.init_params(cfg, jax.random.PRNGKey(0))
    tparams = convert.llama_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return cfg, jparams, tl.LlamaConfig.tiny(), tparams


def _batches(jcfg, B=2, S=16, seed=0):
    jb = jtr.synthetic_batch(jcfg, B, S, seed=seed)
    tb = ttr.synthetic_batch(tl.LlamaConfig.tiny(), B, S, seed=seed,
                             device="cpu")
    return jb, tb


def test_synthetic_batch_equals_jax(llama_pair):
    jb, tb = _batches(llama_pair[0], 3, 12, seed=5)
    for k in ("tokens", "targets", "mask"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_equal_jax(llama_pair, remat):
    jcfg, jparams, tcfg, tparams = llama_pair
    jb, tb = _batches(jcfg)
    lf = jtr.loss_fn
    if remat:
        lf = jax.checkpoint(jtr.loss_fn, static_argnums=(1,))
    jloss, jgrads = jax.value_and_grad(lf)(
        jparams, jcfg, jb["tokens"], jb["targets"], jb["mask"])
    tloss, tgrads = ttr.value_and_grad(
        lambda p: ttr.loss_fn(p, tcfg, tb["tokens"], tb["targets"],
                              tb["mask"], remat=remat), tparams)
    assert abs(float(tloss) - float(jloss)) <= RTOL * abs(float(jloss))
    n = _close_trees(_grads_tree(tparams, tgrads),
                     jax.tree.map(np.asarray, jgrads))
    assert n == len(ttr.tree_leaves(tparams))
    np.testing.assert_allclose(
        float(ttr.global_norm(tgrads)),
        float(jax.numpy.sqrt(sum(jnp.sum(g * g)
                                 for g in jax.tree.leaves(jgrads)))),
        rtol=RTOL)


def test_remat_gives_equal_grads(llama_pair):
    _, _, tcfg, tparams = llama_pair
    _, tb = _batches(llama_pair[0])
    out = []
    for remat in (False, True):
        out.append(ttr.value_and_grad(
            lambda p: ttr.loss_fn(p, tcfg, tb["tokens"], tb["targets"],
                                  tb["mask"], remat=remat), tparams))
    assert float(out[0][0]) == float(out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def _run_steps(llama_pair, tcfg_kw, n_steps):
    jcfg, jparams, tcfg_model, tparams = llama_pair
    jb, tb = _batches(jcfg)
    jt = jtr.TrainConfig(**tcfg_kw)
    tt = ttr.TrainConfig(**tcfg_kw)
    jopt, topt = jtr.make_optimizer(jt), ttr.make_optimizer(tt)
    jstep = jax.jit(jtr.make_train_step(jcfg, jt, jopt))
    tstep = ttr.make_train_step(tcfg_model, tt, topt)
    jp, jo, tp, to = jparams, jopt.init(jparams), tparams, topt.init(tparams)
    trace = []
    for _ in range(n_steps):
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, tm = tstep(tp, to, tb)
        trace.append((jm, tm, jp, tp))
    return trace


def test_three_steps_match_jax_and_first_is_a_no_op(llama_pair):
    """lr 1e-3, warmup_steps 2 (examples/tutorials/03_finetuning.py):
    step 1 runs at lr 0 in both packages."""
    _, jparams, _, tparams = llama_pair
    before = {p: t.clone() for p, t in _walk(tparams)}
    trace = _run_steps(llama_pair, {"learning_rate": 1e-3,
                                    "warmup_steps": 2}, 3)
    jm, tm, jp, tp = trace[0]
    for path, t in _walk(tp):
        assert torch.equal(t, before[path]), path
        np.testing.assert_array_equal(np.asarray(_at(jp, path)),
                                      np.asarray(_at(jparams, path)))
    for jm, tm, jp, tp in trace:
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            RTOL * abs(float(jm["loss"]))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
    _close_trees(trace[-1][3], jax.tree.map(np.asarray, trace[-1][2]))
    assert not torch.equal(trace[-1][3]["layers"]["wq"],
                           tparams["layers"]["wq"])
    # The step returned new tensors: the caller's are unchanged.
    for path, t in _walk(tparams):
        assert torch.equal(t, before[path])


def test_clip_fires_as_in_optax(llama_pair):
    """grad_clip far below the gradient norm: the clip scales by
    max_norm / g_norm; grad_norm stays the norm before the clip."""
    trace = _run_steps(llama_pair, {"learning_rate": 1e-3,
                                    "warmup_steps": 2, "grad_clip": 0.05,
                                    "weight_decay": 0.1}, 3)
    for jm, tm, jp, tp in trace:
        assert float(tm["grad_norm"]) > 0.05
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
    _close_trees(trace[-1][3], jax.tree.map(np.asarray, trace[-1][2]))


def test_schedule_matches_optax():
    import optax

    for peak, warmup in ((1e-3, 2), (2e-5, 100), (0.5, 1)):
        want = optax.warmup_cosine_decay_schedule(0.0, peak, warmup,
                                                  100_000)
        got = ttr.warmup_cosine_decay(peak, warmup)
        for count in (0, 1, warmup - 1, warmup, warmup + 1, 5000, 99_999,
                      100_000, 200_000):
            # f32 (optax) against f64: cos(pi) is -1 only in f32.
            np.testing.assert_allclose(got(count), float(want(count)),
                                       rtol=1e-6, atol=1e-7 * peak)
    assert ttr.warmup_cosine_decay(1e-3, 2)(0) == 0.0


# -- LoRA ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def lora_pair(llama_pair):
    jcfg = llama_pair[0]
    lcfg = jlora.LoraConfig(rank=4, targets=("wq", "wv", "w_down"))
    adapters = jlora.init_lora(jcfg, lcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)
    # b is zero at init; a non-zero b makes merge and the grads of a
    # non-trivial.
    adapters = {n: {"a": ab["a"], "b": jnp.asarray(
        rng.standard_normal(ab["b"].shape).astype(np.float32) * 0.05)}
        for n, ab in adapters.items()}
    t_adapters = convert.lora_params_from_numpy(
        jax.tree.map(np.asarray, adapters), "cpu")
    tcfg = tlora.LoraConfig(rank=4, targets=("wq", "wv", "w_down"))
    return lcfg, adapters, tcfg, t_adapters


def test_lora_merge_equals_jax(llama_pair, lora_pair):
    _, jparams, _, tparams = llama_pair
    jlcfg, jad, tlcfg, tad = lora_pair
    want = jax.tree.map(np.asarray, jlora.merge(jparams, jad, jlcfg))
    got = tlora.merge(tparams, tad, tlcfg)
    _close_trees(got, want)
    assert got["layers"]["wq"] is not tparams["layers"]["wq"]
    assert tlcfg.scale == jlcfg.scale


def test_lora_merge_rounds_like_jax_in_bf16(llama_pair, lora_pair):
    _, jparams, _, tparams = llama_pair
    jlcfg, jad, tlcfg, tad = lora_pair
    jb = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    tb = tl.map_params(tparams, lambda t: t.to(torch.bfloat16))
    want = np.asarray(jlora.merge(jb, jad, jlcfg)["layers"]["wq"]
                      .astype(jnp.float32))
    got = tlora.merge(tb, tad, tlcfg)["layers"]["wq"]
    assert got.dtype == torch.bfloat16
    # Both round (w + bf16(delta)) once to bf16: at most one bf16 ulp
    # apart where the f32 deltas' summation orders differ.
    diff = np.abs(got.float().numpy() - want)
    assert float((diff > 0).mean()) < 0.01
    assert float(diff.max()) <= 2.0 ** -7 * float(np.abs(want).max())


def test_lora_loss_grads_and_three_steps_equal_jax(llama_pair, lora_pair):
    jcfg, jparams, tcfg, tparams = llama_pair
    jlcfg, jad, tlcfg, tad = lora_pair
    jb, tb = _batches(jcfg)
    jloss, jgrads = jax.value_and_grad(jlora.loss_with_lora)(
        jad, jparams, jcfg, jlcfg, jb["tokens"], jb["targets"], jb["mask"])
    tloss, tgrads = ttr.value_and_grad(
        lambda lp: tlora.loss_with_lora(lp, tparams, tcfg, tlcfg,
                                        tb["tokens"], tb["targets"],
                                        tb["mask"]), tad)
    assert abs(float(tloss) - float(jloss)) <= RTOL * abs(float(jloss))
    _close_trees(_grads_tree(tad, tgrads), jax.tree.map(np.asarray, jgrads))

    base = {p: t.clone() for p, t in _walk(tparams)}
    kw = {"learning_rate": 1e-3, "warmup_steps": 1}
    jopt = jtr.make_optimizer(jtr.TrainConfig(**kw))
    topt = ttr.make_optimizer(ttr.TrainConfig(**kw))
    jstep = jax.jit(jlora.make_lora_train_step(jcfg, jlcfg, jopt))
    tstep = tlora.make_lora_train_step(tcfg, tlcfg, topt, remat=True)
    ja, jo, ta, to = jad, jopt.init(jad), tad, topt.init(tad)
    for _ in range(3):
        ja, jo, jm = jstep(ja, jo, jparams, jb)
        ta, to, tm = tstep(ta, to, tparams, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(tm["lora_grad_norm"]),
                                   float(jm["lora_grad_norm"]), rtol=RTOL)
    _close_trees(ta, jax.tree.map(np.asarray, ja))
    assert not torch.equal(ta["wq"]["b"], tad["wq"]["b"])
    # The base is untouched and holds no optimizer state.
    for path, t in _walk(tparams):
        assert torch.equal(t, base[path]) and not t.requires_grad
    assert len(to["mu"]) == len(ttr.tree_leaves(tad))


def test_init_lora_shapes_and_zero_b():
    cfg = tl.LlamaConfig.tiny()
    ad = tlora.init_lora(cfg, tlora.LoraConfig(rank=3, targets=("wk", "wo")),
                         device="cpu")
    assert tuple(ad["wk"]["a"].shape) == (cfg.n_layers, cfg.dim,
                                          cfg.n_kv_heads * cfg.head_dim)[:2] \
        + (3,)
    assert tuple(ad["wo"]["b"].shape) == (cfg.n_layers, 3, cfg.dim)
    assert float(ad["wo"]["b"].abs().sum()) == 0.0
    with pytest.raises(ValueError, match="unknown LoRA targets"):
        tlora.init_lora(cfg, tlora.LoraConfig(targets=("wz",)), device="cpu")


def test_lora_adapters_round_trip_through_numpy(lora_pair):
    _, jad, _, tad = lora_pair
    back = convert.lora_params_to_numpy(tad)
    for name in jad:
        for k in ("a", "b"):
            np.testing.assert_array_equal(back[name][k],
                                          np.asarray(jad[name][k]))


# -- the retriever fine-tune ---------------------------------------------------

PAIRS = [
    ("what chips serve llama", "llama models serve on big chips"),
    ("how big is the memory", "each chip carries sixteen gigabytes"),
    ("what links the chips", "links connect chips inside a slice"),
    ("what compiles kernels", "the compiler builds custom kernels"),
    ("who inserts collectives", "the compiler inserts collectives"),
    ("what batches requests", "the engine batches requests continuously"),
]


@pytest.fixture(scope="module")
def bert_pair():
    cfg = jbert.BertConfig.tiny(vocab_size=256)
    jparams = jbert.init_params(cfg, jax.random.PRNGKey(0))
    tparams = convert.bert_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    return cfg, jparams, tbert.BertConfig.tiny(vocab_size=256), tparams


def test_tokenize_pairs_equals_jax():
    tok = ByteTokenizer()
    want = jrft.tokenize_pairs(tok, PAIRS, max_len=24)
    got = trft.tokenize_pairs(tok, PAIRS, max_len=24, device="cpu")
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got[k].dtype == torch.int32


def test_info_nce_and_three_steps_equal_jax(bert_pair):
    jcfg, jparams, tcfg, tparams = bert_pair
    tok = ByteTokenizer()
    jb = jrft.tokenize_pairs(tok, PAIRS, max_len=24)
    tb = trft.tokenize_pairs(tok, PAIRS, max_len=24, device="cpu")
    ft = dict(learning_rate=1e-3, temperature=0.05, grad_clip=1.0)
    (jl_, jm), jg = jax.value_and_grad(
        lambda p: jrft.info_nce_loss(p, jcfg, jb, 0.05), has_aux=True)(
        jparams)
    (tl_, tm), tg = ttr.value_and_grad(
        lambda p: trft.info_nce_loss(p, tcfg, tb, 0.05), tparams,
        has_aux=True)
    np.testing.assert_allclose(float(tl_), float(jl_), rtol=RTOL)
    assert float(tm["retrieval_acc"]) == float(jm["retrieval_acc"])
    _close_trees(_grads_tree(tparams, tg), jax.tree.map(np.asarray, jg),
                 noise=("bk",))

    jft, tft = jrft.RetrieverFTConfig(**ft), trft.RetrieverFTConfig(**ft)
    jopt, topt = jrft.make_optimizer(jft), trft.make_optimizer(tft)
    jstep = jax.jit(jrft.make_train_step(jcfg, jft, jopt))
    tstep = trft.make_train_step(tcfg, tft, topt)
    jp, jo, tp, to = jparams, jopt.init(jparams), tparams, topt.init(tparams)
    for _ in range(3):
        jp, jo, jmet = jstep(jp, jo, jb)
        tp, to, tmet = tstep(tp, to, tb)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=RTOL)
        assert float(tmet["retrieval_acc"]) == float(jmet["retrieval_acc"])
    # Adam divides each gradient element by its own running RMS, so an
    # element whose gradient is small beside its leaf's largest carries
    # its full relative error into the update: the zero-initialised
    # biases land ~1e-5 apart after 3 steps.
    _close_trees(tp, jax.tree.map(np.asarray, jp), rtol=5e-5, noise=("bk",))
    back = convert.bert_params_to_numpy(tp)
    np.testing.assert_array_equal(back["tok_emb"],
                                  tp["tok_emb"].numpy())


def test_encode_equals_jax(bert_pair):
    jcfg, jparams, tcfg, tparams = bert_pair
    tok = ByteTokenizer()
    jb = jrft.tokenize_pairs(tok, PAIRS, max_len=24)
    tb = trft.tokenize_pairs(tok, PAIRS, max_len=24, device="cpu")
    want = np.asarray(jrft.encode(jparams, jcfg, jb["q_tokens"],
                                  jb["q_lengths"]))
    got = trft.encode(tparams, tcfg, tb["q_tokens"], tb["q_lengths"])
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    # The kernel route (the plain version on a CPU tensor) gives the same
    # pooled output, under no_grad.
    _, pooled = tbert.forward(tparams, tcfg, tb["q_tokens"],
                              lengths=tb["q_lengths"])
    assert not pooled.requires_grad
    np.testing.assert_allclose(
        (pooled / pooled.norm(dim=-1, keepdim=True)).numpy(), want,
        atol=1e-5)


def test_finetune_clamps_the_batch_and_warns_as_jax(bert_pair, caplog):
    jcfg, jparams, tcfg, tparams = bert_pair
    tok = ByteTokenizer()
    ft = dict(learning_rate=3e-3)
    logs = {"jax": [], "port": []}
    with caplog.at_level(logging.WARNING):
        jrft.finetune(jparams, jcfg, tok, PAIRS[:5], epochs=1, batch_size=2,
                      ft=jrft.RetrieverFTConfig(**ft),
                      log=logs["jax"].append)
        jwarn = [r.getMessage() for r in caplog.records]
        caplog.clear()
        trft.finetune(tparams, tcfg, tok, PAIRS[:5], epochs=1, batch_size=2,
                      ft=trft.RetrieverFTConfig(**ft),
                      log=logs["port"].append, device="cpu")
        twarn = [r.getMessage() for r in caplog.records]
    assert twarn == jwarn == ["dropping 1 trailing pairs (< batch_size 2)"]
    assert len(logs["port"]) == len(logs["jax"]) == 2
    for a, b in zip(logs["port"], logs["jax"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=RTOL)
    # A batch larger than the corpus is clamped to it: one step an epoch.
    logs = []
    trft.finetune(tparams, tcfg, tok, PAIRS[:3], epochs=2, batch_size=32,
                  ft=trft.RetrieverFTConfig(**ft), log=logs.append,
                  device="cpu")
    assert len(logs) == 2
    with pytest.raises(ValueError, match="at least one"):
        trft.finetune(tparams, tcfg, tok, [], device="cpu")


# -- the differentiable route ---------------------------------------------------


def test_training_route_grads_reach_every_projection(llama_pair, bert_pair):
    """Every projection upstream of attention gets a non-zero gradient on
    the training route (plain attention, autograd through it)."""
    _, _, tcfg, tparams = llama_pair
    _, tb = _batches(llama_pair[0])
    _, grads = ttr.value_and_grad(
        lambda p: ttr.loss_fn(p, tcfg, tb["tokens"], tb["targets"],
                              tb["mask"]), tparams)
    g = _grads_tree(tparams, grads)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "ln1"):
        for layer in range(tcfg.n_layers):
            assert float(g["layers"][name][layer].abs().max()) > 0, (
                name, layer)
    assert float(g["tok_emb"].abs().max()) > 0

    _, _, bcfg, bparams = bert_pair
    tok = ByteTokenizer()
    batch = trft.tokenize_pairs(tok, PAIRS, max_len=24, device="cpu")
    _, bgrads = ttr.value_and_grad(
        lambda p: trft.info_nce_loss(p, bcfg, batch, 0.05)[0], bparams)
    bg = _grads_tree(bparams, bgrads)
    for name in ("wq", "wk", "wv", "bq", "bk"):
        for layer in range(bcfg.n_layers):
            assert float(bg["layers"][name][layer].abs().max()) > 0, (
                name, layer)


def test_attention_route_is_checked():
    q = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError, match="attention route"):
        tl.attn_ops.attention(q, q, q, route="pallas")
    with pytest.raises(ValueError, match="kernel or plain"):
        tbert.forward(tbert.init_params(tbert.BertConfig.tiny(), "cpu"),
                      tbert.BertConfig.tiny(), torch.zeros((1, 4),
                                                           dtype=torch.int64),
                      attention="xla")
    with pytest.raises(ValueError, match="takes no KV cache"):
        cfg = tl.LlamaConfig.tiny()
        tl.forward(tl.init_params(cfg, "cpu"), cfg,
                   torch.zeros((1, 4), dtype=torch.int64), remat=True,
                   kv_cache=tl.KVCache.zeros(cfg, 1, 8, device="cpu"))


def _plain_route_callers():
    """(module, function called) for every call that passes
    attention="plain" to a forward, or route="plain" to attention."""
    found = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            for kw in node.keywords:
                if kw.arg in ("attention", "route") and not (
                        isinstance(kw.value, ast.Constant)
                        and kw.value.value == "kernel"):
                    fn = node.func
                    name = fn.attr if isinstance(fn, ast.Attribute) else \
                        getattr(fn, "id", "?")
                    found.append((path.relative_to(PORT).as_posix(), name,
                                  ast.unparse(kw.value)))
    return found


def test_only_training_modules_ask_for_the_plain_route():
    """No serving or RAG caller passes the plain route to llama.forward,
    forward_hidden or bert.forward: the route stays the training
    modules' choice. Inside the models, the route is only passed on."""
    callers = _plain_route_callers()
    outside = [c for c in callers if not c[0].startswith("training/")
               and not (c[0].startswith(("models/", "ops/"))
                        and c[2] in ("attention", "route"))]
    assert not outside, outside
    training = {(m, f) for m, f, v in callers if m.startswith("training/")}
    assert ("training/trainer.py", "forward") in training
    assert ("training/retriever_ft.py", "forward") in training
    assert all(v == "'plain'" for m, f, v in callers
               if m.startswith("training/"))


def test_kernels_refuse_operands_that_require_grad_on_cuda():
    """K1 and K3 have no backward: a CUDA operand that requires grad
    raises instead of silently dropping the gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K3 are CUDA kernels")
    from generativeaiexamples_tpu_torch.ops import encoder_attention as enc

    q = torch.randn((1, 4, 64, 64), device="cuda").bfloat16() \
        .requires_grad_(True)
    k = torch.randn((1, 4, 64, 64), device="cuda").bfloat16()
    with pytest.raises(RuntimeError, match="requires grad"):
        tl.attn_ops.flash_attention(q, k, k)
    with pytest.raises(RuntimeError, match="requires grad"):
        enc.encoder_attention(q, k, k)
    with torch.no_grad():
        tl.attn_ops.flash_attention(q, k, k)
