"""Port parity: tensor-parallel serving over two rank processes.

Two rank processes (gloo on the CPU, `spawn`) serve the tiny f32 Llama
(vocabulary 260: the byte tokenizer's ids, even so it splits two ways)
at tensor = 2 with `engine.multihost` on: rank 0 runs the scheduler and
publishes its dispatch records, rank 1 replays them. Greedy streams must
equal the single-device port engine's and the JAX package's offline
oracles (`greedy_generate`; for int8, the jitted steps on a JAX
QuantPagePool, tests/test_torch_engine_model_int8.py's `_oracle`), on
the prompts the single-device parity tests use; the follower must have
read every record rank 0 published, with no divergence, and rank 1's
replicated device state (the token chain; on a speculative engine the
draft history and device lengths) must equal rank 0's. Legs: f32
weights and pool, int8 weights and the fused int8 pool, the prefix
cache with the KV pager (hits, demotions and promotions replayed), and
tree speculation with composed step plans and the fused rider (f32 and
int8; a long prompt rides the verify dispatches, then a sampled request
runs the plain fallback on the generator's draws). A
two-rank launcher run (`--devices cpu,cpu`) answers /v1/chat/completions
as the single-process launcher does, and both exit 0 after SIGTERM.

The module starts its two ranks once; each test waits on them with its
own time limit, and teardown kills any rank still alive. No JAX
`LLMEngine` is built; the ranks never import JAX.
"""

import functools
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback
import urllib.request

import numpy as np
import pytest
import torch

from generativeaiexamples_tpu_torch.models import convert
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.serving.engine import LLMEngine
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

VOCAB = 260
ECFG = dict(max_batch_size=4, max_seq_len=64, page_size=8,
            prefill_buckets=(16, 32))
INT8 = dict(kv_dtype="int8", quantize_weights="int8")
PAGER = dict(prefix_cache=True, kv_pager=True, prefix_cache_capacity=0.1,
             kv_host_budget_mb=0)
# Tree speculation with composed step plans and the fused rider.
SPEC = dict(speculative_k=2, speculative_tree_branches=2, step_plans=True,
            fused_prefill=True)
# The single-device parity tests' prompts (tests/test_torch_engine.py),
# and the int8 engine test's (tests/test_torch_engine_model_int8.py: one
# of 45 tokens takes the chunked lane past the 32 bucket).
PROMPTS = [[257, 10, 11, 12, 13, 14], list(range(40, 60)), [257] + list(
    b"hello"), list(range(100, 125)), [257] + list("héllo ✓".encode()),
    [7] * 31]
INT8_PROMPTS = [np.random.default_rng(11).integers(0, 256, n).tolist()
                for n in (6, 20, 45, 13, 30)]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 180


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _streams(engine, prompts, n_new):
    """Greedy token ids of every prompt, submitted from one thread each."""
    out = [None] * len(prompts)

    def run(i):
        out[i] = [ev["token_id"] for ev in engine.generate_stream(
            prompts[i], max_new_tokens=n_new, temperature=0.0)
            if ev["token_id"] >= 0]

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=LIMIT_S)
    return out


def _kv_leg(eng, kv, n_new):
    """KV page moves through `eng` (rank 0, or one device): export the
    cached pages of each prompt in kv["export"] (with how many of them
    were demoted at the time), import each (ids, codes, scales) of
    kv["import"], serve the imported prompts, then export them again."""

    def export(ids):
        cold = eng.run_control_op(lambda: len(eng._cached_page_runs(ids)[1]))
        codes, scales, n_tok = eng.run_control_op(
            lambda: eng.export_prefix_pages(ids))
        return {"cold": cold, "codes": codes, "scales": scales,
                "n_tokens": n_tok}

    out = {"exports": [export(ids) for ids in kv["export"]]}
    out["imported"] = [eng.run_control_op(
        lambda: eng.import_prefix_pages(ids, codes, scales))
        for ids, codes, scales in kv["import"]]
    out["streams"] = _streams(eng, [ids for ids, _, _ in kv["import"]],
                              n_new)
    out["again"] = [export(ids) for ids, _, _ in kv["import"]]
    return out


def _mix_leg(eng, mix):
    """A long prompt arrives while a greedy short stream decodes (its
    chunks can ride the short stream's dispatches), then, once the long
    prompt has its first token, a sampled request (which forces the
    plain fallback while it is live). Returns the greedy streams (short,
    long) and the sampled stream's length."""
    out = {}
    first = {name: threading.Event() for name in ("short", "long")}

    def run(name, temperature):
        toks = []
        for ev in eng.generate_stream(mix[name], temperature=temperature,
                                      max_new_tokens=mix[name + "_new"]):
            if ev["token_id"] >= 0:
                toks.append(ev["token_id"])
                if name in first:
                    first[name].set()
        out[name] = toks

    threads = []
    for name, temperature, after in (("short", 0.0, None),
                                     ("long", 0.0, "short"),
                                     ("sampled", 0.8, "long")):
        if after:
            first[after].wait(LIMIT_S)
        threads.append(threading.Thread(target=run, args=(name,
                                                          temperature)))
        threads[-1].start()
    for t in threads:
        t.join(timeout=LIMIT_S)
    return {"short": out["short"], "long": out["long"],
            "sampled": len(out["sampled"])}


def _device_state(eng):
    """The replicated device state every rank must hold alike: the
    token chain and, on a speculative engine, the draft history and the
    device lengths."""
    out = {"last_tokens": eng._last_tokens.numpy().copy()}
    if eng._spec_k:
        out.update(history=eng._history.numpy().copy(),
                   dev_lengths=eng._dev_lengths.numpy().copy())
    return out


def _rank_main(rank: int, coordinator: str, cmds, results) -> None:
    """A rank process: join the group, then serve each command's engine
    (rank 0 drives the prompts and any KV page moves, rank 1 replays)
    until None."""
    from generativeaiexamples_tpu_torch.config.schema import MeshConfig
    from generativeaiexamples_tpu_torch.parallel import mesh as tm
    from generativeaiexamples_tpu_torch.serving import multihost as mh
    from generativeaiexamples_tpu_torch.serving import sharding as shd

    tm.init_ranks(coordinator, 2, rank, ["cpu", "cpu"])
    mesh = tm.build_mesh(MeshConfig(ici_tensor=2), ["cpu", "cpu"])
    while True:
        cmd = cmds.get()
        if cmd is None:
            break
        try:
            params, ecfg, prompts, n_new, kv, mix = cmd
            cfg = tl.LlamaConfig.tiny(vocab_size=VOCAB)
            # A warmed engine carries a rider only at a warmed shape (as
            # the JAX engine does): the mix's long prompt is warmed.
            warm = ({"long_prompts": True,
                     "long_prompt_lengths": [len(mix["long"])]}
                    if mix else {})
            eng = LLMEngine(shd.shard_llama_params(params, cfg, mesh), cfg,
                            ByteTokenizer(), {**ecfg, "multihost": True},
                            mesh=mesh).warmup(**warm)
            if rank == 0:
                eng.start()
                first = _streams(eng, prompts, n_new)
                again = _streams(eng, prompts, n_new)
                moved = _kv_leg(eng, kv, n_new) if kv else None
                mixed = _mix_leg(eng, mix) if mix else None
                # The pager's tiers before stop() closes it.
                pager = eng.kv_pager
                cold = 0 if pager is None else sum(pager.stats()[k] for k in (
                    "kv_host_pages", "kv_spill_pages"))
                unsent = 0 if pager is None else len(pager._freed_keys)
                eng.stop()
                out = {"first": first, "again": again, "kv": moved,
                       "mix": mixed, "state": _device_state(eng),
                       "metrics": eng.metrics.snapshot(),
                       "pool_heads": eng.pool.k.shape[1]
                       if not eng.pool.quantized else eng.pool.kv.shape[2],
                       "cold_pages": cold, "unsent_frees": unsent}
            else:
                n = mh.run_follower(eng, timeout_s=LIMIT_S)
                pager = eng.kv_pager
                out = {"replayed": n, "consumed": eng._mh_log.consumed,
                       "state": _device_state(eng),
                       "divergence": eng.metrics.replay_divergence,
                       "processes": eng.metrics.multihost_processes,
                       "parked": 0 if pager is None else len(pager._parked),
                       "parked_in_tiers": 0 if pager is None else
                       sum(pager.stats()[k] for k in (
                           "kv_host_pages", "kv_spill_pages"))}
            results.put((rank, "ok", out))
        except BaseException:
            results.put((rank, "error", traceback.format_exc()))
    tm.shutdown()


@pytest.fixture(scope="module")
def ranks():
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    coordinator = f"127.0.0.1:{_free_port()}"
    cmds = [ctx.Queue(), ctx.Queue()]
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, coordinator, cmds[r], results))
             for r in range(2)]
    for p in procs:
        p.start()
    yield cmds, results, procs
    for q in cmds:
        q.put(None)
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()
            p.join()


def _serve(ranks, params, ecfg, prompts, n_new, kv=None, mix=None):
    cmds, results, procs = ranks
    for q in cmds:
        q.put((params, ecfg, prompts, n_new, kv, mix))
    got = {}
    deadline = time.monotonic() + LIMIT_S
    while len(got) < 2:
        assert all(p.is_alive() for p in procs), "a rank process died"
        try:
            rank, status, out = results.get(timeout=max(
                0.1, min(5.0, deadline - time.monotonic())))
        except Exception:
            assert time.monotonic() < deadline, "ranks timed out"
            continue
        assert status == "ok", out
        got[rank] = out
    leader, follower = got[0], got[1]
    m = leader["metrics"]
    assert m["multihost_processes"] == follower["processes"] == 2
    assert m["replay_divergence"] == follower["divergence"] == 0
    # Every record rank 0 published (digests and stop included) was read.
    assert m["replay_records_published"] == follower["consumed"] > 0
    assert follower["replayed"] > 0
    # The rank's pool holds its kv heads: one of the tiny model's two.
    assert leader["pool_heads"] == 1
    # The follower parks its slice of every page the leader holds cold
    # (in its own pager's tiers), plus the pages whose release the
    # leader has not sent yet, and nothing else.
    assert follower["parked"] == follower["parked_in_tiers"] == (
        leader["cold_pages"] + leader["unsent_frees"])
    # The replicated device state is the same on both ranks.
    assert set(leader["state"]) == set(follower["state"])
    for key, value in leader["state"].items():
        assert np.array_equal(value, follower["state"][key]), key
    return leader


@pytest.fixture(scope="module")
def model():
    import jax

    from generativeaiexamples_tpu.models import llama as jl
    from generativeaiexamples_tpu.ops import quant as jq

    jcfg = jl.LlamaConfig.tiny(vocab_size=VOCAB)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    out = {}
    for name, tree in (("f32", jparams),
                       ("int8", jq.quantize_llama_params(jparams))):
        out[name] = (jcfg, tree, tl.LlamaConfig.tiny(vocab_size=VOCAB),
                     convert.llama_params_from_numpy(
                         jax.tree.map(np.asarray, tree), "cpu",
                         torch.float32))
    return out


def _single(params, ecfg, prompts, n_new, kv=None):
    eng = LLMEngine(params, tl.LlamaConfig.tiny(vocab_size=VOCAB),
                    ByteTokenizer(), ecfg, device="cpu").warmup().start()
    try:
        streams = _streams(eng, prompts, n_new)
        return (streams, _kv_leg(eng, kv, n_new)) if kv else streams
    finally:
        eng.stop()


def _greedy(model, prompt, n_new):
    import jax.numpy as jnp

    from generativeaiexamples_tpu.models import llama as jl

    jcfg, jparams, _, _ = model
    out = jl.greedy_generate(jparams, jcfg, jnp.asarray([prompt], jnp.int32),
                             n_new, use_pallas=False)
    toks = np.asarray(out)[0, len(prompt):].tolist()
    eos = ByteTokenizer().eos_id
    return toks[:toks.index(eos) + 1] if eos in toks else toks


def test_tp_f32_streams_equal_single_device_and_jax_greedy(ranks, model):
    params = model["f32"][3]
    got = _serve(ranks, params, ECFG, PROMPTS, 10)
    single = _single(params, ECFG, PROMPTS, 10)
    assert got["first"] == got["again"] == single
    assert single == [_greedy(model["f32"], p, 10) for p in PROMPTS]
    assert got["metrics"]["kernel_launches_flash_attention"] == 0  # CPU


def test_tp_int8_streams_equal_single_device_and_jax_oracle(ranks, model):
    from test_torch_engine_model_int8 import ECFG as INT8_ECFG
    from test_torch_engine_model_int8 import _oracle

    assert INT8_ECFG == {**ECFG, **INT8}
    params = model["int8"][3]
    ecfg = {**ECFG, **INT8}
    got = _serve(ranks, params, ecfg, INT8_PROMPTS, 9)
    single = _single(params, ecfg, INT8_PROMPTS, 9)
    assert got["first"] == got["again"] == single
    assert single == [_oracle(model["int8"], p, 9) for p in INT8_PROMPTS]


@pytest.mark.parametrize("pool", ["f32", "int8"])
def test_tp_tree_spec_step_plans_and_rider(ranks, model, pool):
    """Tree speculation with composed step plans and the fused rider at
    tensor 2: the greedy streams equal the one-device engine with the
    same features and the JAX oracles; then a long prompt rides the
    verify dispatches of a decoding stream while a sampled request
    forces the plain fallback (the generator's draws), and rank 1's
    token chain, history and device lengths still equal rank 0's
    (checked in _serve)."""
    from test_torch_engine_model_int8 import _oracle

    params = model[pool][3]
    ecfg = {**ECFG, **SPEC, **(INT8 if pool == "int8" else {})}
    prompts = INT8_PROMPTS if pool == "int8" else PROMPTS
    n_new = 9 if pool == "int8" else 10
    mix = {"short": [257, 10, 11, 12], "short_new": 40,
           "long": list(range(100, 145)), "long_new": 12,
           "sampled": [257] + list(b"sampled"), "sampled_new": 12}
    got = _serve(ranks, params, ecfg, prompts, n_new, mix=mix)
    single = _single(params, ecfg, prompts, n_new)
    assert got["first"] == got["again"] == single
    oracle = (functools.partial(_oracle, model["int8"]) if pool == "int8"
              else functools.partial(_greedy, model["f32"]))
    assert single == [oracle(p, n_new) for p in prompts]
    want = [oracle(mix[k], mix[k + "_new"]) for k in ("short", "long")]
    assert [got["mix"]["short"], got["mix"]["long"]] == want
    assert got["mix"]["sampled"] == 12
    m = got["metrics"]
    assert m["spec_slot_steps"] > 0 and m["spec_fallback_steps"] > 0
    assert m["fused_steps"] > 0


def test_tp_prefix_hits_and_pager_replay(ranks, model):
    """The prompts run twice: the second pass hits the prefix cache
    (seed records), and a pool-tenth tree capacity with no host tier
    demotes pages to the spill and promotes them back (pager_out /
    pager_in records), on both ranks."""
    params = model["f32"][3]
    ecfg = {**ECFG, **PAGER}
    prompts = [list(range(20, 60)), list(range(20, 50)) + [3, 4],
               [257] + list(range(60, 100)), list(range(20, 60))]
    got = _serve(ranks, params, ecfg, prompts, 6)
    want = [_greedy(model["f32"], p, 6) for p in prompts]
    assert got["first"] == got["again"] == want
    assert _single(params, ecfg, prompts, 6) == want
    m = got["metrics"]
    assert m["prefix_hits"] > 0
    assert m["kv_demotions"] > 0 and m["kv_promotions"] > 0


@pytest.mark.parametrize("pool", ["f32", "int8"])
def test_tp_kv_pages_travel_whole(ranks, model, pool):
    """The disagg transfer's two halves on a tensor-parallel engine: an
    export gathers every rank's kv heads into whole pages (device-
    resident and demoted ones alike), equal to the one-device engine's
    pages of the same prompt; an import of the one-device engine's pages
    seats each rank's slice, so the prompt then serves from the cache as
    on one device, and exporting it again gives the imported bytes
    back."""
    params = model[pool][3]
    ecfg = {**ECFG, **PAGER, **(INT8 if pool == "int8" else {})}
    a, b = list(range(20, 60)), [257] + list(range(120, 159))
    others = [list(range(60, 100)), [3] * 40]
    (single, moved) = _single(params, ecfg, [a] + others + [b], 6,
                              {"export": [a, b], "import": []})
    sa, sb = moved["exports"]
    got = _serve(ranks, params, ecfg, [a] + others, 6, {
        "export": [a], "import": [(b, sb["codes"], sb["scales"])]})
    assert got["first"] == got["again"] == single[:3]
    kv = got["kv"]
    (ta,) = kv["exports"]
    # The tree keeps a tenth of the pool: part of the prompt was demoted
    # (the export's cold_out record).
    assert ta["cold"] > 0
    assert ta["n_tokens"] == sa["n_tokens"] == 40
    assert ta["codes"].shape == sa["codes"].shape  # both kv heads
    if pool == "f32":
        # Each all-reduce adds two f32 partials where one GEMM sums once,
        # so a k/v value may round to the next bf16 value in the pool.
        torch.testing.assert_close(ta["codes"], sa["codes"], rtol=2 ** -7,
                                   atol=1e-5)
    else:
        assert (ta["scales"] is None) == (sa["scales"] is None) is False
    assert kv["imported"] == [5]
    assert kv["streams"] == [single[3]]
    if pool == "f32":
        assert single[3] == _greedy(model["f32"], b, 6)
    (tb,) = kv["again"]
    assert tb["n_tokens"] == 40
    assert torch.equal(tb["codes"], sb["codes"])
    if pool == "int8":
        assert torch.equal(tb["scales"], sb["scales"])
    assert got["metrics"]["prefix_hits"] >= 1
    assert got["metrics"]["kv_transfer_pages"] == 5


def _http(url, body=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    with urllib.request.urlopen(urllib.request.Request(
            url, data=data, method="POST" if data else "GET"),
            timeout=timeout) as resp:
        return json.loads(resp.read())


def test_tp_launcher_chat_equals_single_process_launcher():
    """`python -m generativeaiexamples_tpu_torch.serving --devices
    cpu,cpu` (rank 0 spawns rank 1) answers a greedy chat completion as
    the one-process launcher does; SIGTERM to rank 0 publishes the stop
    record and both processes exit 0."""
    env = {**os.environ, "APP_ENGINE_MAXSEQLEN": "256",
           "APP_ENGINE_PAGESIZE": "8", "APP_ENGINE_PREFILLBUCKETS": "[16, 64]",
           "PYTHONPATH": ROOT}
    ports = [_free_port(), _free_port()]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "generativeaiexamples_tpu_torch.serving",
         "--model-size", "tiny", *flags, "--port", str(port)],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
        for port, flags in zip(ports, (["--devices", "cpu,cpu"],
                                       ["--device", "cpu"]))]
    try:
        deadline = time.monotonic() + LIMIT_S
        answers = []
        for port in ports:
            while True:
                try:
                    _http(f"http://127.0.0.1:{port}/health", timeout=2)
                    break
                except OSError:
                    assert time.monotonic() < deadline, "launcher not up"
                    assert all(p.poll() is None for p in procs)
                    time.sleep(0.5)
            answers.append(_http(
                f"http://127.0.0.1:{port}/v1/chat/completions",
                {"messages": [{"role": "user", "content": "hello there"}],
                 "max_tokens": 12, "temperature": 0}))
        metrics = _http(f"http://127.0.0.1:{ports[0]}/metrics")
        assert metrics["multihost_processes"] == 2
        assert metrics["replay_records_published"] > 0
        assert metrics["replay_divergence"] == 0
        texts = [a["choices"][0]["message"]["content"] for a in answers]
        assert texts[0] == texts[1]
        assert answers[0]["usage"] == answers[1]["usage"]
        for p in procs:
            p.send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=60) for p in procs]
        assert codes == [0, 0], [p.stderr.read()[-2000:] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_launcher_refuses_rank_processes_beside_a_fleet():
    """The JAX launcher's text for engine.multihost beside a replica
    fleet, and the port's own for a mesh of more than one device beside
    one (rank processes serve one engine), which says how to stay on one
    card. --devices lists one device a rank."""
    import dataclasses

    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.serving import __main__ as launcher

    cfg = load_config(env={"APP_FLEET_REPLICAS": "2"})
    launcher.check_mesh_config(cfg, 1)
    with pytest.raises(ValueError, match=(
            r"engine.multihost=true serves ONE engine spanning all "
            r"hosts behind rank 0; it cannot combine with a replica "
            r"fleet \(fleet.replicas=2")):
        launcher.check_mesh_config(dataclasses.replace(
            cfg, engine=dataclasses.replace(cfg.engine, multihost=True)), 1)
    for config in (cfg, load_config(env={
            "APP_FLEET_REPLICAURLS": "http://127.0.0.1:1"})):
        with pytest.raises(ValueError, match=(
                r"a mesh of 2 devices serves ONE engine over rank "
                r"processes behind rank 0; it cannot combine with a "
                r"replica fleet \(fleet.replicas=\d, replica_urls=.*\)\. "
                r"Serve the fleet on one device \(--device cuda:0")):
            launcher.check_mesh_config(config, 2)
    assert launcher.mesh_devices(devices="cpu, cpu") == ["cpu", "cpu"]
    assert launcher.mesh_devices("cpu") == ["cpu"]
    config = launcher.with_mesh_process(cfg, "127.0.0.1:1", 2, 1)
    assert (config.mesh.coordinator_address, config.mesh.num_processes,
            config.mesh.process_id, config.engine.multihost) == (
        "127.0.0.1:1", 2, 1, True)


@pytest.mark.parametrize("env,want", [
    ({}, 2),
    ({"APP_FLEET_REPLICAS": "2"}, 1),
    ({"APP_FLEET_REPLICAURLS": "http://127.0.0.1:1", "APP_FLEET_REPLICAS":
      "0"}, 1),
    ({"APP_ENGINE_SPECULATIVEK": "3"}, 2),
    ({"APP_ENGINE_FUSEDPREFILL": "true"}, 2),
    ({"APP_FLEET_REPLICAS": "2", "APP_MESH_ICITENSOR": "2"}, 2),
    ({"APP_FLEET_REPLICAS": "2", "APP_ENGINE_MULTIHOST": "true"}, 2),
])
def test_launcher_default_devices_on_a_multi_card_host(monkeypatch, env,
                                                       want):
    """On a host of two cards with no --devices, the mesh spans both
    only where rank processes can serve the config: a replica fleet
    stays on the first card (as before the launcher had a mesh), unless
    a [mesh] axis size or engine.multihost asks for the mesh, which
    check_mesh_config and the engine then hold to their rules. Every
    engine profile replays (speculation and the rider included), so
    those span the mesh."""
    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.parallel import mesh as tm
    from generativeaiexamples_tpu_torch.serving import __main__ as launcher

    monkeypatch.setattr(tm, "local_devices", lambda: [
        torch.device("cuda", 0), torch.device("cuda", 1)])
    config = load_config(env=env)
    got = launcher.mesh_devices(config=config)
    assert got == ["cuda:0", "cuda:1"][:want]
    if want == 2 and launcher._has_fleet(config):
        with pytest.raises(ValueError, match="cannot combine with a "
                                             "replica fleet"):
            launcher.check_mesh_config(config, len(got))
