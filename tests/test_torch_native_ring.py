"""Port parity: native/ring.py and the port's own sdr_ring.c.

The JAX package's tests/test_native_ring.py cases, case for case, on the
port's C ring (built from generativeaiexamples_tpu_torch/native/sdr_ring.c
into build/native/) and on its `PyRing`: round trip and wraparound,
whole-datagram drop when full, partial pop, threaded SPSC integrity, and
the UDP IQ path end to end (the port's replay sender -> the C receive
loop -> numpy equality). Each case also runs on the JAX package's ring
where that one is available, and the two give the same bytes and
counters.
"""

import socket
import threading
from pathlib import Path

import numpy as np
import pytest

from generativeaiexamples_tpu.native import ring as jring
from generativeaiexamples_tpu_torch.native import ring as tring

ROOT = Path(__file__).resolve().parent.parent


def _rings(mod, capacity=1 << 16):
    """The Python ring always (what a host with no compiler runs), the C
    ring when it builds."""
    out = [mod.PyRing(capacity)]
    if mod.native_available():
        out.append(mod.IQRing(capacity))
    return out


def test_the_port_builds_its_own_source_under_build():
    if not tring.native_available():
        pytest.skip("no C compiler on this host")
    so = tring.library_path()
    assert so.exists()
    assert so.parent == ROOT / "build" / "native"
    assert tring.SRC.parent == ROOT / "generativeaiexamples_tpu_torch" / \
        "native"
    # The port's copy defines the JAX source's functions.
    jsrc = (ROOT / "generativeaiexamples_tpu" / "native" /
            "sdr_ring.c").read_text()
    tsrc = tring.SRC.read_text()
    assert tsrc[tsrc.index("#include"):] == jsrc[jsrc.index("#include"):]


def _trace(ring):
    """One scripted sequence of pushes and pops and what it returned."""
    out = []
    payload = bytes(range(256)) * 8  # 2 KB
    for _ in range(64):  # > capacity in total: the indices wrap
        out.append(ring.push(payload))
        out.append(ring.pop(len(payload)) == payload)
    out.append(len(ring))
    big = b"x" * (1 << 15)
    out += [ring.push(big), ring.push(big), ring.push(b"y" * 10),
            ring.dropped, ring.received, ring.pop(4)]
    out.append(ring.pop(1 << 16)[-4:])
    out += [ring.push(b"abcdef"), ring.pop(4), ring.pop(100), ring.pop(10)]
    return out


def test_rings_agree_with_jax():
    want = _trace(jring.PyRing(1 << 16))
    for ring in _rings(tring):
        assert _trace(ring) == want, type(ring).__name__
        ring.close()


@pytest.mark.parametrize("mod", [tring, jring], ids=["port", "jax"])
def test_push_pop_roundtrip_and_wraparound(mod):
    for ring in _rings(mod):
        payload = bytes(range(256)) * 8
        for _ in range(64):
            assert ring.push(payload) == len(payload)
            assert ring.pop(len(payload)) == payload
        assert len(ring) == 0
        ring.close()


@pytest.mark.parametrize("mod", [tring, jring], ids=["port", "jax"])
def test_whole_datagram_drop_when_full(mod):
    for ring in _rings(mod):
        big = b"x" * (1 << 15)
        assert ring.push(big) == len(big)
        assert ring.push(big) == len(big)
        # full now: the next datagram drops entirely, ring unchanged
        assert ring.push(b"y" * 10) == 0
        assert ring.dropped == 10
        assert ring.received == 2 * len(big)
        assert ring.pop(4) == b"xxxx"
        ring.close()


@pytest.mark.parametrize("mod", [tring, jring], ids=["port", "jax"])
def test_partial_pop(mod):
    for ring in _rings(mod):
        ring.push(b"abcdef")
        assert ring.pop(4) == b"abcd"
        assert ring.pop(100) == b"ef"  # clamped to what is there
        assert ring.pop(10) == b""
        ring.close()


def test_spsc_threaded_integrity():
    if not tring.native_available():
        pytest.skip("no C compiler on this host")
    ring = tring.IQRing(1 << 14)
    n_msgs, msg = 2000, bytes(range(128))
    out = bytearray()

    def producer():
        sent = 0
        while sent < n_msgs:
            if ring.push(msg):
                sent += 1

    def consumer():
        while len(out) < n_msgs * len(msg):
            out.extend(ring.pop(4096))

    t1, t2 = threading.Thread(target=producer), \
        threading.Thread(target=consumer)
    t1.start()
    t2.start()
    t1.join(timeout=30)
    t2.join(timeout=30)
    assert bytes(out) == msg * n_msgs  # no tearing, no reordering
    ring.close()


@pytest.mark.parametrize("native", [True, False], ids=["c", "python"])
def test_udp_iq_end_to_end(native):
    """The port's replay sender -> the ring's receive loop -> numpy IQ
    equality, on the C ring and on the Python one."""
    from generativeaiexamples_tpu_torch.streaming import replay

    if native and not tring.native_available():
        pytest.skip("no C compiler on this host")
    samples = (np.random.default_rng(0).standard_normal(4096)
               + 1j * np.random.default_rng(1).standard_normal(4096)
               ).astype(np.complex64)
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    ring = tring.IQRing(1 << 20) if native else tring.PyRing(1 << 20)
    n_bytes = samples.nbytes
    done = []

    def rx():
        done.append(ring.recv_udp(sock, n_bytes, idle_timeout_ms=2000))

    t = threading.Thread(target=rx)
    t.start()
    replay.udp_send_iq(samples, ("127.0.0.1", port), pkt_size=4096)
    t.join(timeout=10)
    sock.close()
    assert done and done[0] == n_bytes
    got = np.frombuffer(ring.pop(n_bytes), np.complex64)
    np.testing.assert_array_equal(got, samples)
    assert ring.dropped == 0
    ring.close()


def test_udp_receive_iq_through_the_ring():
    """replay.udp_receive_iq (a bound socket drained into `make_ring`'s
    ring) returns the bytes sent, as JAX's does."""
    from generativeaiexamples_tpu_torch.streaming import replay

    samples = (np.arange(2048) * (1 + 1j)).astype(np.complex64)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    out = []
    t = threading.Thread(target=lambda: out.append(
        replay.udp_receive_iq(port, samples.nbytes, timeout=5.0)))
    t.start()
    import time

    time.sleep(0.5)  # the receiver binds first
    replay.udp_send_iq(samples, ("127.0.0.1", port), pkt_size=4096)
    t.join(timeout=15)
    assert out, "udp_receive_iq did not return"
    np.testing.assert_array_equal(out[0], samples)
