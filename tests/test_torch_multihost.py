"""Port parity: serving/multihost.py against generativeaiexamples_tpu's.

The JAX suite's dispatch-log, follower-loop, divergence and profile cases
(tests/test_multihost.py) run on both packages' modules with the same
stub coordination client: the same records, orderings, error texts and
counters. The port's transport is the process group's TCPStore
(`StoreClient`), held here to the same contract on a real store in this
process. The fetch seams are the port's own (a rank's shard is a tensor
of its own).
"""

import datetime
import socket

import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.config.schema import EngineConfig as JConfig
from generativeaiexamples_tpu.serving import multihost as jmh
from generativeaiexamples_tpu_torch.config.schema import (
    EngineConfig, MeshConfig)
from generativeaiexamples_tpu_torch.parallel import mesh as tm
from generativeaiexamples_tpu_torch.serving import multihost as mh

BOTH = [pytest.param(mh, id="port"), pytest.param(jmh, id="jax")]


class _StubClient:
    """coordination-service KV stand-in: string store + deadline error
    on missing keys (matching blocking_key_value_get semantics)."""

    def __init__(self):
        self.kv = {}

    def key_value_set(self, k, v):
        self.kv[k] = v

    def blocking_key_value_get(self, k, timeout_ms):
        if k not in self.kv:
            raise RuntimeError("Deadline Exceeded")
        return self.kv[k]


def _error(fn, exc):
    with pytest.raises(exc) as e:
        fn()
    return str(e.value)


def test_encode_decode_roundtrip_and_wire_format_equal_jax():
    payload = {"tokens": np.arange(12, dtype=np.int32).reshape(3, 4),
               "temps": np.zeros(3, np.float32),
               "k": np.int32(7)}
    kind, out = mh._decode(mh._encode("prefill", payload))
    assert kind == "prefill"
    assert set(out) == set(payload)
    for k in payload:
        np.testing.assert_array_equal(out[k], payload[k])
    assert mh._decode(mh._encode("stop", {})) == ("stop", {})
    # The same blob either way: a JAX leader's records decode in the
    # port and the other way round.
    blob = mh._encode("plan", payload)
    assert blob == jmh._encode("plan", payload)
    kind, theirs = jmh._decode(blob)
    assert kind == "plan" and set(theirs) == set(payload)
    assert (mh._KEY_PREFIX, mh.DIGEST_EVERY, mh._WINDOW_CAP) == (
        jmh._KEY_PREFIX, jmh.DIGEST_EVERY, jmh._WINDOW_CAP)


@pytest.mark.parametrize("mod", BOTH)
def test_dispatch_log_orders_and_times_out(mod):
    client = _StubClient()
    pub = mod.DispatchLog(client=client)
    sub = mod.DispatchLog(client=client)
    pub.publish("prefill", tokens=np.array([1, 2]))
    pub.publish("decode", k=np.int32(4))
    kind0, rec0 = sub.next_record(timeout_s=1)
    kind1, rec1 = sub.next_record(timeout_s=1)
    assert kind0 == "prefill" and list(rec0["tokens"]) == [1, 2]
    assert kind1 == "decode" and int(rec1["k"]) == 4
    with pytest.raises(mod.MultihostError, match="leader gone"):
        sub.next_record(timeout_s=0.05, poll_s=0.02)


def test_dispatch_log_keys_and_blobs_equal_jax():
    """A port leader writes the JAX leader's keys and values, digests
    included (DIGEST_EVERY records trigger one)."""
    ours, theirs = _StubClient(), _StubClient()
    for client, mod in ((ours, mh), (theirs, jmh)):
        log = mod.DispatchLog(client=client)
        for i in range(mod.DIGEST_EVERY + 3):
            log.publish("plan", b=np.int32(i), row=np.arange(i % 5))
        log.publish("stop")
    assert ours.kv == theirs.kv


@pytest.mark.parametrize("mod", BOTH)
def test_run_follower_replays_until_stop(mod):
    client = _StubClient()
    pub = mod.DispatchLog(client=client)
    pub.publish("prefill", a=np.int32(1))
    pub.publish("plan", b=np.int32(2))
    pub.publish("stop")  # flushes the final digest first

    calls = []

    class _Eng:
        _mh_log = mod.DispatchLog(client=client)

        def _mh_replay_table(self):
            return {
                "prefill": lambda rec: calls.append(
                    ("prefill", int(rec["a"]))),
                "plan": lambda rec: calls.append(("plan", int(rec["b"]))),
            }

    eng = _Eng()
    mod.run_follower(eng, timeout_s=1)
    assert calls == [("prefill", 1), ("plan", 2)]
    assert eng._mh_leader is False
    if mod is mh:
        # Every record read, the digest and the stop included, is what
        # the leader published.
        assert eng._mh_log.consumed == len(client.kv) == 4


@pytest.mark.parametrize("mod", BOTH)
def test_run_follower_rejects_unknown_kind_and_unbuilt_engine(mod):
    client = _StubClient()
    mod.DispatchLog(client=client).publish("mystery")

    class _Eng:
        _mh_log = mod.DispatchLog(client=client)

        def _mh_replay_table(self):
            return {}

    with pytest.raises(mod.MultihostError, match="mystery"):
        mod.run_follower(_Eng(), timeout_s=1)

    class _Plain:
        _mh_log = None

    with pytest.raises(mod.MultihostError, match="multihost=true"):
        mod.run_follower(_Plain())


def _tampered_stream(mod):
    """A 2-record stream whose second record was swapped after the
    leader CRC'd it — the digest that rides ahead of `stop` must name
    exactly that record."""
    client = _StubClient()
    pub = mod.DispatchLog(client=client)
    pub.publish("prefill", a=np.int32(1))
    pub.publish("plan", b=np.int32(2))
    client.kv["gaiemh/000000001"] = mod._encode("plan", {"b": np.int32(99)})
    pub.publish("stop")
    return client


@pytest.mark.parametrize("mod", BOTH)
def test_divergence_detector_names_key_and_kind(mod):
    sub = mod.DispatchLog(client=_tampered_stream(mod))
    assert sub.next_record(timeout_s=1)[0] == "prefill"
    assert sub.next_record(timeout_s=1)[0] == "plan"  # tampered, reads fine
    with pytest.raises(
            mod.MultihostDivergenceError,
            match=r"gaiemh/000000001.*kind 'plan'"):
        sub.next_record(timeout_s=1)  # hits the digest before `stop`


def test_divergence_texts_equal_jax():
    texts = []
    for mod in (mh, jmh):
        sub = mod.DispatchLog(client=_tampered_stream(mod))
        sub.next_record(timeout_s=1)
        sub.next_record(timeout_s=1)
        texts.append(_error(lambda: sub.next_record(timeout_s=1),
                            mod.MultihostDivergenceError))
    assert texts[0] == texts[1]


@pytest.mark.parametrize("mod", BOTH)
def test_run_follower_counts_divergence_and_reraises(mod):
    client = _tampered_stream(mod)

    class _Metrics:
        replay_divergence = 0

    class _Eng:
        _mh_log = mod.DispatchLog(client=client)
        metrics = _Metrics()

        def _mh_replay_table(self):
            return {"prefill": lambda rec: None, "plan": lambda rec: None}

    eng = _Eng()
    with pytest.raises(mod.MultihostDivergenceError):
        mod.run_follower(eng, timeout_s=1)
    assert eng.metrics.replay_divergence == 1


@pytest.mark.parametrize("mod", BOTH)
def test_clean_stream_verifies_at_stop(mod):
    """The digest ahead of `stop` verifies silently on an untampered
    stream (and digest records never surface to the caller)."""
    client = _StubClient()
    pub = mod.DispatchLog(client=client)
    for i in range(5):
        pub.publish("plan", b=np.int32(i))
    pub.publish("stop")
    sub = mod.DispatchLog(client=client)
    kinds = [sub.next_record(timeout_s=1)[0] for _ in range(6)]
    assert kinds == ["plan"] * 5 + ["stop"]


# -- the port's transport: the process group's TCPStore ---------------------


def _store():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    return torch.distributed.TCPStore(
        "127.0.0.1", port, 1, True, timeout=datetime.timedelta(seconds=10))


def test_store_client_carries_the_log_and_times_out():
    client = mh.StoreClient(_store())
    pub, sub = mh.DispatchLog(client=client), mh.DispatchLog(client=client)
    pub.publish("seed", row=np.arange(4, dtype=np.int32), m=np.int32(9))
    for i in range(mh.DIGEST_EVERY):
        pub.publish("plan", b=np.int32(i))
    pub.publish("stop")
    kind, rec = sub.next_record(timeout_s=5)
    assert kind == "seed" and rec["row"].tolist() == [0, 1, 2, 3]
    kinds = [sub.next_record(timeout_s=5)[0]
             for _ in range(mh.DIGEST_EVERY + 1)]
    assert kinds == ["plan"] * mh.DIGEST_EVERY + ["stop"]
    assert sub.consumed == pub._seq
    with pytest.raises(mh.MultihostError, match="leader gone"):
        sub.next_record(timeout_s=0.1, poll_s=0.05)
    with pytest.raises(RuntimeError, match="Deadline Exceeded"):
        client.blocking_key_value_get("gaiemh/nope", 50)
    client.wait_at_barrier("b", 1000, world_size=1)


def test_coordination_client_needs_the_process_group():
    assert tm.coordination_store() is None
    with pytest.raises(mh.MultihostError, match="not initialized"):
        mh.coordination_client()
    with pytest.raises(mh.MultihostError, match="not initialized"):
        mh.DispatchLog()
    assert not mh.is_active()


# -- fetch seams ---------------------------------------------------------------


def test_fetch_seams_and_slice_roundtrip():
    t = torch.arange(24, dtype=torch.int32).reshape(2, 3, 4)
    np.testing.assert_array_equal(mh.fetch_replicated(t, "t"), t.numpy())
    np.testing.assert_array_equal(mh.fetch_addressable(t, "t"), t.numpy())
    out, idx = mh.fetch_addressable_slice(t, "t")
    assert idx == (slice(0, 2), slice(0, 3), slice(0, 4))
    # A rank holding heads 2:3 of a 6-head page record.
    index = (slice(0, 2), slice(2, 5), slice(0, 4))
    out, idx = mh.fetch_addressable_slice(t, "pager demote", index)
    assert idx == index
    back = mh.put_local_slice(out, idx, (2, 6, 4), index)
    assert torch.equal(back, t)
    with pytest.raises(mh.MultihostFetchError, match="does not cover"):
        mh.fetch_addressable_slice(t, "pager demote",
                                   (slice(0, 1),) + index[1:])
    with pytest.raises(mh.MultihostError, match="does not match"):
        mh.put_local_slice(out, idx, (2, 6, 4),
                           (slice(0, 2), slice(1, 4), slice(0, 4)))


# -- profile validation --------------------------------------------------------


class _Mesh:  # duck-typed: validate only reads mesh.shape.get
    shape = {"data": 2, "fsdp": 1, "tensor": 2}


def test_profile_rejects_batch_sharded_mesh_with_jax_text():
    texts = [_error(lambda: mod.validate_multihost_profile(cfg(), _Mesh()),
                    mod.MultihostError)
             for mod, cfg in ((mh, EngineConfig), (jmh, JConfig))]
    assert texts[0] == texts[1]
    assert "data axis = 2" in texts[0]
    mesh = tm.build_mesh(MeshConfig(ici_data=2, ici_tensor=4), ["cpu"] * 8)
    with pytest.raises(mh.MultihostError, match="data axis = 2"):
        mh.validate_multihost_profile(EngineConfig(), mesh)
    mh.validate_multihost_profile(
        EngineConfig(), tm.build_mesh(MeshConfig(ici_tensor=8), ["cpu"] * 8))


def test_profile_accepts_the_replayed_feature_set():
    """Plain decode, chunked prefill, fused-sampling finishes,
    speculation (linear and tree), composed step plans, the fused rider,
    the prefix cache and the KV pager replay in the port, together, as
    in JAX; each accepted name is an engine config field."""
    full = dict(fused_sampling=True, prefix_cache=True, kv_pager=True,
                qos=True, speculative_k=3, speculative_tree_branches=4,
                step_plans=True, fused_prefill=True)
    mh.validate_multihost_profile(EngineConfig(**full))
    jmh.validate_multihost_profile(JConfig(**full))
    fields = set(EngineConfig.__dataclass_fields__)
    assert {name for name, _ in mh.MULTIHOST_ACCEPTED} <= fields


@pytest.mark.parametrize("name,value", [("speculative_k", 2),
                                        ("step_plans", True),
                                        ("fused_prefill", True)])
def test_profile_accepts_full_feature_set(name, value):
    """Speculation, step plans and the fused rider are accepted on both
    packages, and the port's table names the same fields as JAX's, each
    with JAX's mechanism."""
    mh.validate_multihost_profile(EngineConfig(**{name: value}))
    jmh.validate_multihost_profile(JConfig(**{name: value}))
    ours = [(n, why) for n, why in mh.MULTIHOST_ACCEPTED]
    theirs = [(n, why) for n, _, why in jmh.MULTIHOST_ACCEPTED]
    assert [n for n, _ in ours] == [n for n, _ in theirs]
    assert dict(ours)[name] == dict(theirs)[name]


def test_plan_records_equal_jax_key_for_key():
    """Every StepPlan lattice point the scheduler launches crosses the
    wire as the JAX record (same keys, dtypes and values) and comes back
    whole on either side."""
    from generativeaiexamples_tpu.serving import engine_model as jem
    from generativeaiexamples_tpu_torch.serving import engine_model as tem

    plans = [dict(decode_k=8), dict(decode_k=4, rider_width=16,
                                    rider_s_total=48),
             dict(decode_k=2, spec_k=3), dict(decode_k=2, spec_k=3,
                                              tree_branches=4),
             dict(decode_k=2, spec_k=2, tree_branches=3, rider_width=16,
                  rider_s_total=208),
             dict(decode_k=4, spec_state=True),
             dict(rider_width=16, rider_s_total=48),
             dict(rider_width=8, rider_s_total=48, rider_sample=True)]
    for kw in plans:
        ours = tem.plan_to_record(tem.StepPlan(**kw))
        theirs = jem.plan_to_record(jem.StepPlan(**kw))
        assert list(ours) == list(theirs)
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype and ours[k] == theirs[k]
        _, wire = mh._decode(mh._encode("plan", ours))
        assert tem.plan_from_record(wire) == tem.StepPlan(**kw)
        assert jem.plan_from_record(wire) == jem.StepPlan(**kw)


# -- leader / follower replay of the engine -----------------------------------
#
# JAX tests/test_multihost.py's replay cases on the port's engine: a
# leader serves with a stub log injected (stepped inline, so the dispatch
# schedule is a function of the engine state alone), then a fresh
# follower replays only the records. Both must end with the same device
# state, byte for byte; the leader's greedy streams equal the offline
# JAX oracle on the same weights.


@pytest.fixture(scope="module")
def tiny():
    import jax

    from generativeaiexamples_tpu.models import llama as jl
    from generativeaiexamples_tpu_torch.models import convert

    jcfg = jl.LlamaConfig.tiny()
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, convert.llama_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu", torch.float32)


def _tiny_engine(params, **overrides):
    from generativeaiexamples_tpu_torch.models import llama as tl
    from generativeaiexamples_tpu_torch.serving.engine import LLMEngine
    from generativeaiexamples_tpu_torch.utils.tokenizer import (
        ByteTokenizer)

    ecfg = dict(max_batch_size=2, max_seq_len=64, page_size=8,
                prefill_buckets=(16,), pace_emission_max_streams=0,
                dtype="float32", kv_dtype="float32", **overrides)
    return LLMEngine(params, tl.LlamaConfig.tiny(), ByteTokenizer(), ecfg,
                     device="cpu")


def _serve_and_replay(params, prompts, concurrent=False, **features):
    """The leader serves `prompts` ((ids, max_new, temperature) each) with
    `features` on, publishing to a stub log; a fresh follower replays the
    records. `concurrent` submits everything up front (decode traffic
    beside a long prefill: the rider lane). Returns (leader, follower,
    the leader's streams)."""
    from test_torch_fused_prefill import _ids, _run_to_idle

    from generativeaiexamples_tpu_torch.serving.engine import GenRequest

    client = _StubClient()
    leader = _tiny_engine(params, **features)
    leader._mh_log = mh.DispatchLog(client=client)
    leader._mh_leader = True
    if leader.kv_pager is not None:
        leader.kv_pager.mh_log = leader._mh_log
    streams = []

    def serve(batch):
        reqs = [leader.submit(GenRequest(prompt_ids=list(ids),
                                         max_new_tokens=n, temperature=t))
                for ids, n, t in batch]
        _run_to_idle(leader)
        streams.extend(_ids(r) for r in reqs)

    if concurrent:
        serve(prompts)
    else:
        for p in prompts:
            serve([p])
    leader.stop()  # publishes the stop record

    follower = _tiny_engine(params, **features)
    follower._mh_log = mh.DispatchLog(client=client)
    replayed = mh.run_follower(follower, timeout_s=5)
    follower.stop()
    assert replayed > 0
    assert follower._mh_log.consumed == len(client.kv)
    return leader, follower, streams


def _assert_device_state_identical(leader, follower, spec=False):
    assert torch.equal(leader._last_tokens, follower._last_tokens)
    assert torch.equal(leader.pool.k, follower.pool.k)
    assert torch.equal(leader.pool.v, follower.pool.v)
    if spec:
        assert torch.equal(leader._history, follower._history)
        assert torch.equal(leader._dev_lengths, follower._dev_lengths)


def _oracle(tiny, ids, n_new):
    import jax.numpy as jnp

    from generativeaiexamples_tpu.models import llama as jl

    jcfg, jparams, _ = tiny
    out = jl.greedy_generate(jparams, jcfg, jnp.asarray([ids], jnp.int32),
                             n_new, use_pallas=False)
    return np.asarray(out)[0, len(ids):].tolist()


def test_replay_speculative_tree_with_step_plans(tiny):
    """Spec-tree + step-plan serving: every plan-lattice point the
    scheduler picks (tree verify, and the sampled request's plain
    spec-state fallback, drawn with the generator) rides the plan record
    and replays to byte-identical device state INCLUDING the draft
    history and device lengths the next round reads."""
    prompts = [([(7 * i + j) % 250 + 1 for j in range(10)], 6, 0.0)
               for i in range(2)]
    prompts.append(([3, 1, 4, 1, 5, 9, 2, 6], 6, 0.8))
    leader, follower, streams = _serve_and_replay(
        tiny[2], prompts, speculative_k=2, speculative_tree_branches=2,
        step_plans=True)
    assert leader.metrics.spec_slot_steps > 0
    assert leader.metrics.spec_fallback_steps > 0
    _assert_device_state_identical(leader, follower, spec=True)
    for (ids, n, _), got in zip(prompts[:2], streams):
        assert got == _oracle(tiny, ids, n)
    assert len(streams[2]) == 6


def test_replay_fused_prefill_prefix_cache_and_pager(tiny):
    """Chunked fused prefill (prompt > largest bucket) with fused
    sampling, then the SAME prompt again for a warm prefix hit (the seed
    record): the follower replays the chunks, the fused-sample commit and
    the seed gather byte-identically, with the pager wired into the
    record stream."""
    ids = [(3 * j) % 250 + 1 for j in range(40)]
    leader, follower, streams = _serve_and_replay(
        tiny[2], [(ids, 4, 0.0), (ids, 4, 0.0)], fused_prefill=True,
        fused_sampling=True, step_plans=True, prefix_cache=True,
        kv_pager=True)
    assert leader.metrics.prefix_hits > 0
    assert leader.metrics.fused_sample_dispatches > 0
    _assert_device_state_identical(leader, follower)
    assert streams == [_oracle(tiny, ids, 4)] * 2


def test_replay_fused_rider_on_decode(tiny):
    """A short prompt decoding WHILE a long prompt prefills: the long
    prompt's chunks ride inside decode dispatches (the
    fused_decode_prefill plan points) and the follower replays the
    combined launches."""
    short = ([5, 6, 7, 8], 24, 0.0)
    long = ([(3 * j) % 250 + 1 for j in range(40)], 4, 0.0)
    leader, follower, streams = _serve_and_replay(
        tiny[2], [short, long], concurrent=True, fused_prefill=True,
        step_plans=True)
    assert leader.metrics.fused_steps > 0
    _assert_device_state_identical(leader, follower)
    assert streams == [_oracle(tiny, ids, n) for ids, n, _ in (short, long)]
