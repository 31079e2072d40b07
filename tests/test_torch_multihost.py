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
    """Plain decode, chunked prefill, fused-sampling finishes, the prefix
    cache and the KV pager replay in the port; each accepted name is an
    engine config field."""
    mh.validate_multihost_profile(EngineConfig(
        fused_sampling=True, prefix_cache=True, kv_pager=True, qos=True))
    fields = set(EngineConfig.__dataclass_fields__)
    assert {name for name, _ in mh.MULTIHOST_ACCEPTED} <= fields
    assert {name for name, _ in mh.MULTIHOST_REFUSED} <= fields


@pytest.mark.parametrize("name,value", [("speculative_k", 2),
                                        ("step_plans", True),
                                        ("fused_prefill", True)])
def test_profile_refuses_unreplayed_plans_naming_a17(name, value):
    """Speculation, step plans and the fused rider are refused by name
    (the JAX package replays them; the port's records do not yet)."""
    with pytest.raises(mh.MultihostError,
                       match=rf"engine\.{name}=.*ROADMAP A\.17"):
        mh.validate_multihost_profile(EngineConfig(**{name: value}))
    jmh.validate_multihost_profile(JConfig(**{name: value}))
