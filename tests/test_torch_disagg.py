"""Port parity: disaggregated prefill/decode's KV page transfer
(serving/disagg.py, the engine's export/import seams, the pager's
read_pages and the server's /v1/kv routes).

The GKVT1 wire: the port's `serialize_kv_transfer` writes the same bytes
as the JAX package's for f32, bf16 and int8+scales pages (bf16 through
torch, no ml_dtypes), each side's `deserialize_kv_transfer` reads the
other's bytes bit-identical, and truncated, garbage and oversized
payloads raise ValueError with the JAX message (422 bad_kv_payload from
the port's server). The engine: pages exported from one port engine and
imported into another, over the host bounce or the device path, are
bit-identical in the target pool and serve the prompt as a prefix hit,
for f32, bf16 and int8 pools; a pager-demoted tail is read from its cold
tier. `KVPageTransfer`'s windowing equals the JAX one call for call. No
JAX `LLMEngine` is built.
"""

import json
import random
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.serving import disagg as jd
from generativeaiexamples_tpu.serving import kv_cache as jkv
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.ops.quant import quantize_llama_params
from generativeaiexamples_tpu_torch.parallel import mesh as tm
from generativeaiexamples_tpu_torch.serving import disagg as td
from generativeaiexamples_tpu_torch.serving import engine_model as tem
from generativeaiexamples_tpu_torch.serving import kv_cache as tkv
from generativeaiexamples_tpu_torch.serving.engine import LLMEngine
from generativeaiexamples_tpu_torch.serving.openai_server import (
    OpenAIServer, make_http_server)
from generativeaiexamples_tpu_torch.utils.tokenizer import ByteTokenizer

PS = 8
VOCAB = 259
KINDS = ("float32", "bfloat16", "int8")
ECFG = dict(max_batch_size=2, max_seq_len=128, page_size=PS,
            prefill_buckets=(16, 32), decode_steps_per_dispatch=2,
            prefix_cache=True)


def _raw(t):
    """Comparable raw bits of a torch tensor or a numpy array."""
    if isinstance(t, torch.Tensor):
        t = t.contiguous()
        return t.view({torch.bfloat16: torch.int16}.get(t.dtype,
                                                        t.dtype)).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _pages(kind, n=3, seed=0):
    """The same n random pages as (port tensors, JAX numpy arrays)."""
    rng = np.random.default_rng(seed)
    shape = (n, 2, 2, 2, PS, 16)
    if kind == "int8":
        codes = rng.integers(-127, 128, shape).astype(np.int8)
        scales = rng.random(shape[:-1]).astype(np.float32)
        return ((torch.from_numpy(codes), torch.from_numpy(scales)),
                (codes, scales))
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "float32":
        return (torch.from_numpy(x), None), (x, None)
    t = torch.from_numpy(x).to(torch.bfloat16)
    return (t, None), (t.view(torch.int16).numpy().view(jnp.bfloat16), None)


@pytest.mark.parametrize("kind", KINDS)
def test_page_geometry_equals_jax(kind):
    tcfg = tl.LlamaConfig.tiny(vocab_size=VOCAB)
    jcfg = jl.LlamaConfig.tiny(vocab_size=VOCAB)
    tpool = tkv.PagePool.zeros(tcfg, 4, PS, dtype=getattr(torch, kind),
                               device="cpu")
    jpool = jkv.PagePool.zeros(jcfg, 4, PS, dtype=getattr(jnp, kind))
    tc, tdt, ts = td.page_geometry(tpool)
    jc, jdt, js = jd.page_geometry(jpool)
    assert (tc, ts) == (jc, js)
    assert str(tdt).rsplit(".", 1)[-1] == jdt.name


@pytest.mark.parametrize("kind", KINDS)
def test_wire_bytes_equal_jax_and_cross_read(kind):
    (tc, ts), (jc, js) = _pages(kind)
    ids = list(range(3, 3 + 3 * PS))
    ours = td.serialize_kv_transfer(ids, tc, ts)
    theirs = jd.serialize_kv_transfer(ids, jc, js)
    assert ours == theirs
    # numpy input serializes the same where numpy has the dtype.
    if kind != "bfloat16":
        assert td.serialize_kv_transfer(ids, jc, js) == theirs
    # Each side reads the other's bytes bit-identical.
    got_ids, got_c, got_s = td.deserialize_kv_transfer(theirs)
    assert got_ids == ids and got_c.dtype == getattr(torch, kind)
    assert np.array_equal(_raw(got_c), _raw(tc))
    j_ids, j_c, j_s = jd.deserialize_kv_transfer(ours)
    assert j_ids == ids and j_c.dtype.name == kind
    assert np.array_equal(_raw(j_c), _raw(jc))
    if ts is None:
        assert got_s is None and j_s is None
    else:
        assert torch.equal(got_s, ts) and np.array_equal(j_s, js)


def _bad_payloads():
    (tc, ts), _ = _pages("int8", n=2)
    good = td.serialize_kv_transfer([1, 2, 3], tc, ts)
    hlen = int.from_bytes(good[5:9], "little")
    header = json.loads(good[9:9 + hlen])

    def with_header(h):
        hb = json.dumps(h).encode()
        return good[:5] + len(hb).to_bytes(4, "little") + hb + \
            good[9 + hlen:]

    return {
        "empty": b"",
        "short_preamble": good[:7],
        "bad_magic": b"XKVT1" + good[5:],
        "header_overflow": good[:5] + (10 ** 6).to_bytes(4, "little")
        + good[9:40],
        "garbage_header": good[:5] + (4).to_bytes(4, "little") + b"{{{{",
        "header_not_object": with_header([1, 2]),
        "header_missing_key": with_header({k: v for k, v in header.items()
                                           if k != "n_ids"}),
        "negative_dim": with_header({**header, "codes_shape":
                                     [-1] + header["codes_shape"][1:]}),
        "short_ids": with_header({**header, "n_ids": 10 ** 9}),
        "short_codes": good[:9 + hlen + 12 + 100],
        "short_scales": good[:-4],
        "trailing": good + b"\0\0",
    }


@pytest.mark.parametrize("case", sorted(_bad_payloads()))
def test_bad_payloads_raise_the_jax_message(case):
    buf = _bad_payloads()[case]
    with pytest.raises(ValueError) as ours:
        td.deserialize_kv_transfer(buf)
    with pytest.raises(ValueError) as theirs:
        jd.deserialize_kv_transfer(buf)
    assert str(ours.value) == str(theirs.value)


def test_unknown_dtype_is_a_malformed_header_on_both_sides():
    (tc, _), _ = _pages("float32", n=1)
    good = td.serialize_kv_transfer([1], tc, None)
    bad = good.replace(b'"float32"', b'"float99"')
    for mod in (td, jd):
        with pytest.raises(ValueError,
                           match="malformed KV transfer header at offset 9"):
            mod.deserialize_kv_transfer(bad)


# -- the engine's export / import seams --------------------------------------


@pytest.fixture(scope="module")
def params():
    cfg = tl.LlamaConfig.tiny(vocab_size=VOCAB)
    def init():
        return tl.init_params(cfg, "cpu", torch.Generator().manual_seed(0))

    return cfg, init(), quantize_llama_params(init(), "cpu")


def _engine(params, kind, n_pages=None, **kw):
    cfg, p, p8 = params
    ecfg = {**ECFG, "kv_dtype": kind, **kw}
    if kind == "int8":
        ecfg.update(quantize_weights="int8", page_size=16)
    return LLMEngine(p8 if kind == "int8" else p, cfg, ByteTokenizer(), ecfg,
                     n_pages=n_pages, device="cpu")


def _run(eng, prompt, n=6):
    return [ev["token_id"] for ev in eng.generate_stream(
        prompt, max_new_tokens=n) if ev["token_id"] >= 0]


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, 256, n).tolist()


def _pool_pages(eng, ids):
    pages = eng.prefix_cache.match(ids)
    codes, scales = tem.pool_to_pages(eng.pool, torch.tensor(pages))
    return codes, scales


@pytest.mark.parametrize("route", ["host", "wire", "device"])
@pytest.mark.parametrize("kind", KINDS)
def test_transfer_seats_identical_pages_and_serves_a_hit(params, kind,
                                                        route):
    src = _engine(params, kind).start()
    dst = _engine(params, kind).start()
    try:
        ps = src.pool.page_size
        prompt = _prompt(4 * ps + 3, seed=1)
        want = _run(src, prompt)
        if route == "device":
            codes, scales, n_tok = src.run_control_op(
                lambda: src.export_prefix_pages_device(prompt))
        else:
            codes, scales, n_tok = src.run_control_op(
                lambda: src.export_prefix_pages(prompt))
            if route == "wire":
                ids, codes, scales = td.deserialize_kv_transfer(
                    td.serialize_kv_transfer(prompt[:n_tok], codes, scales))
                assert ids == prompt[:n_tok]
        assert n_tok == 4 * ps
        got = dst.run_control_op(lambda: dst.import_prefix_pages(
            prompt[:n_tok], codes, scales, on_device=route == "device"))
        assert got == 4
        # Importing again is a no-op: the prefix is resident.
        assert dst.run_control_op(lambda: dst.import_prefix_pages(
            prompt[:n_tok], codes, scales)) == 0
        for a, b in zip(_pool_pages(src, prompt), _pool_pages(dst, prompt)):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(_raw(a), _raw(b))
        assert _run(dst, prompt) == want
        m = dst.metrics.snapshot()
        assert m["prefix_hits"] == 1 and m["kv_transfer_pages"] == 4
        assert m["kv_transfer_chunks"] == 1
        assert m["kv_transfer_device_pages"] == (4 if route == "device"
                                                 else 0)
        assert m["hist_kv_transfer_ms_per_page"]["count"] == 1
        events = [e for e in dst.flight.snapshot_events() if e["kind"] == 18]
        assert len(events) == 1 and events[0]["a"] == 4.0
    finally:
        src.stop()
        dst.stop()


def test_windows_gaps_and_geometry(params):
    src = _engine(params, "float32").start()
    dst = _engine(params, "float32").start()
    try:
        prompt = _prompt(6 * PS, seed=2)
        _run(src, prompt, n=2)
        codes, scales, n_tok = src.export_prefix_pages(prompt, 2, 2)
        assert codes.shape[0] == 2 and n_tok == 4 * PS
        assert src.export_prefix_pages(prompt, 9, 0) is None
        with pytest.raises(ValueError, match="chunk gap"):
            dst.import_prefix_pages(prompt[:n_tok], codes, scales,
                                    first_page=2)
        first, _, n1 = src.export_prefix_pages(prompt, 0, 2)
        assert dst.import_prefix_pages(prompt[:n1], first, None) == 2
        assert dst.import_prefix_pages(prompt[:n_tok], codes, None,
                                       first_page=2) == 2
        with pytest.raises(ValueError, match="KV import of pages"):
            dst.import_prefix_pages(prompt, codes.to(torch.bfloat16), None)
        # Covered pages (no in-flight prefill): the tree's coverage.
        assert src.publish_prefill_pages(prompt) == 6
    finally:
        src.stop()
        dst.stop()


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_export_reads_a_demoted_tail_from_the_pager(params, kind):
    """With the pager, pages evicted from the pool are demoted to host
    RAM; the export reads them from there (read_pages) without promoting,
    and the bytes equal the pool's copy taken before the demotion."""
    eng = _engine(params, kind, kv_pager=True, prefix_cache_capacity=0.25,
                  kv_host_budget_mb=64).start()
    try:
        ps = eng.pool.page_size
        first = _prompt(3 * ps, seed=3)
        _run(eng, first, n=2)
        before = _pool_pages(eng, first)
        for s in range(4, 12):  # push `first` out of the pool
            _run(eng, _prompt(3 * ps, seed=s), n=2)
        nodes = eng.prefix_cache.match_nodes(first)
        assert nodes and all(n.tier != 0 for n in nodes)
        promotions = eng.kv_pager.stats()["kv_promotions"]
        codes, scales, n_tok = eng.run_control_op(
            lambda: eng.export_prefix_pages(first))
        assert n_tok == 3 * ps
        assert np.array_equal(_raw(codes), _raw(before[0]))
        if kind == "int8":
            assert torch.equal(scales, before[1])
        assert eng.kv_pager.stats()["kv_promotions"] == promotions
        assert eng.export_prefix_pages_device(first) is None
    finally:
        eng.stop()


# -- KVPageTransfer windowing (fake replicas) --------------------------------


class _Src:
    rid = "p"

    def __init__(self, n_pages, ps=PS):
        self.n, self.ps, self.calls = n_pages, ps, []

    def export_kv_pages(self, ids, timeout_s=60.0, start_page=0,
                        max_pages=0):
        self.calls.append(("export", start_page, max_pages))
        hi = self.n if max_pages <= 0 else min(self.n, start_page + max_pages)
        if hi <= start_page:
            return None
        return (np.zeros((hi - start_page, 1), np.float32), None,
                hi * self.ps)


class _Dst:
    rid = "d"

    def __init__(self):
        self.calls = []

    def import_kv_pages(self, ids, codes, scales, timeout_s=60.0,
                        first_page=0):
        self.calls.append(("import", len(ids), codes.shape[0], first_page))
        return codes.shape[0]


@pytest.mark.parametrize("chunk", [0, 1, 3, 7])
def test_transfer_windows_equal_jax(chunk):
    ids = list(range(7 * PS + 2))
    out = []
    for mod in (td, jd):
        src, dst = _Src(7), _Dst()
        mover = mod.KVPageTransfer(chunk_pages=chunk)
        pages, _ = mover.transfer(src, dst, ids, page_size=PS)
        out.append((pages, src.calls, dst.calls))
    assert out[0] == out[1]
    assert out[0][0] == 7


class _DeviceSrc(_Src):
    def transfer_page_size(self):
        return self.ps

    def transfer_device_set(self):
        return {torch.device("cpu")}

    def export_kv_pages_device(self, ids, timeout_s=60.0, start_page=0,
                               max_pages=0):
        raise RuntimeError("peer copy refused")


class _DeviceDst(_Dst):
    def import_kv_pages_device(self, *a, **kw):
        raise AssertionError("never reached")

    def transfer_device_set(self):
        return {torch.device("cpu")}


def test_device_failure_falls_back_to_host_and_marks_the_pair():
    from generativeaiexamples_tpu_torch.serving.fleet import FleetOps

    ops = FleetOps()
    mover = td.KVPageTransfer(device_path=True, ops=ops)
    src, dst = _DeviceSrc(3), _DeviceDst()
    assert mover.device_ok(src, dst)
    assert mover.transfer(src, dst, list(range(3 * PS)), PS)[0] == 3
    assert not mover.device_ok(src, dst)
    assert ops.snapshot()["disagg_device_fallbacks"] == 1
    assert mover.transfer(src, dst, list(range(3 * PS)), PS)[0] == 3
    assert ops.snapshot()["disagg_device_fallbacks"] == 1
    assert not tm.devices_colocated({torch.device("cpu")},
                                    {torch.device("cuda", 1)})


class _Sets(_DeviceSrc, _DeviceDst):
    """A replica exposing the device surface over a given device set."""

    def __init__(self, devices):
        super().__init__(1)
        self.devices = devices

    def transfer_device_set(self):
        return self.devices


@pytest.mark.parametrize("cards,a,b,want", [
    (0, {"cpu"}, {"cpu"}, True),
    (0, {"cuda:0"}, {"cuda:0"}, False),
    (0, {"cuda:0"}, {"cuda:1"}, False),
    (2, {"cuda:0"}, {"cuda:0"}, True),
    (2, {"cuda:0"}, {"cuda:1"}, True),
    (2, {"cuda:0"}, {"cuda:2"}, False),
    (2, set(), {"cuda:0"}, False),
])
def test_device_ok_follows_mesh_devices_colocated(monkeypatch, cards, a, b,
                                                  want):
    """JAX's rule (every device addressable from this process), on
    torch.device sets: pools on two cards of this host take the device
    path (a peer copy), a card this process cannot see does not. The
    cards are faked; nothing touches CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    da, db = ({torch.device(d) for d in x} for x in (a, b))
    mover = td.KVPageTransfer(device_path=True)
    assert tm.devices_colocated(da, db) is want
    assert mover.device_ok(_Sets(da), _Sets(db)) is want


@pytest.mark.parametrize("kind", KINDS)
def test_device_path_windows_equal_host_bounce(params, kind):
    """Two LocalReplicas on the CPU: the device path's windows (the
    replica's move to its pool device, then the scatter) seat the same
    pages, page for page, as the host bounce into a twin replica."""
    from generativeaiexamples_tpu_torch.serving.fleet import LocalReplica

    src = LocalReplica("src", _engine(params, kind).start())
    dsts = [LocalReplica(r, _engine(params, kind).start())
            for r in ("host", "device")]
    try:
        ps = src.engine.pool.page_size
        prompt = _prompt(5 * ps + 3, seed=4)
        _run(src.engine, prompt)
        got = {}
        for dst, device_path in zip(dsts, (False, True)):
            mover = td.KVPageTransfer(device_path=device_path,
                                      chunk_pages=2)
            assert mover.device_ok(src, dst)
            got[dst.rid] = mover.transfer(src, dst, prompt, ps)[0]
        assert got == {"host": 5, "device": 5}
        assert dsts[1].engine.metrics.kv_transfer_device_pages == 5
        assert dsts[0].engine.metrics.kv_transfer_device_pages == 0
        for a, b in zip(_pool_pages(dsts[0].engine, prompt),
                        _pool_pages(dsts[1].engine, prompt)):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(_raw(a), _raw(b))
    finally:
        for r in [src] + dsts:
            r.engine.stop()


def test_ship_async_lands_before_drain():
    mover = td.KVPageTransfer(chunk_pages=2)
    src, dst = _Src(5), _Dst()
    gate = threading.Event()
    orig = dst.import_kv_pages

    def slow(*a, **kw):
        gate.wait(5)
        return orig(*a, **kw)

    dst.import_kv_pages = slow
    mover.ship_async(src, dst, list(range(5 * PS)), start_page=2)
    assert not mover.drain(timeout_s=0.05)
    gate.set()
    assert mover.drain(timeout_s=5)
    assert dst.calls == [("import", 5 * PS, 3, 2)]


# -- the server's /v1/kv routes ----------------------------------------------


def _post(base, path, data, headers=None):
    req = urllib.request.Request(base + path, data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture()
def kv_server(params):
    eng = _engine(params, "bfloat16", n_pages=9).start()
    httpd = make_http_server(OpenAIServer(eng), "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    yield eng, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    eng.stop()


def test_server_kv_routes(kv_server):
    eng, base = kv_server
    prompt = _prompt(3 * PS + 1, seed=5)
    hdr = {"Content-Type": "application/json"}
    status, body = _post(base, "/v1/kv/export",
                         json.dumps({"prompt": prompt}).encode(), hdr)
    assert status == 204 and body == b""
    _run(eng, prompt, n=2)
    status, body = _post(base, "/v1/kv/export", json.dumps(
        {"prompt": prompt, "probe": True}).encode(), hdr)
    assert status == 200 and json.loads(body) == {"pages": 3}
    status, body = _post(base, "/v1/kv/export", json.dumps(
        {"prompt": prompt, "start_page": 1}).encode(), hdr)
    ids, codes, _ = td.deserialize_kv_transfer(body)
    assert status == 200 and ids == prompt[:3 * PS] and codes.shape[0] == 2
    assert codes.dtype == torch.bfloat16
    for name, buf in _bad_payloads().items():
        status, body = _post(base, "/v1/kv/import", buf)
        assert status == 422, name
        err = json.loads(body)["error"]
        assert err["code"] == "bad_kv_payload"
        with pytest.raises(ValueError) as jerr:
            jd.deserialize_kv_transfer(buf)
        assert err["message"] == str(jerr.value)
    # More pages than the pool has: 503, the fleet falls back.
    big, _ = _pages("bfloat16", n=12)
    rng = random.Random(0)
    ids = [rng.randrange(1, 256) for _ in range(12 * PS)]
    codes = torch.zeros((12,) + td.page_geometry(eng.pool)[0],
                        dtype=torch.bfloat16)
    status, body = _post(base, "/v1/kv/import",
                         td.serialize_kv_transfer(ids, codes, None))
    assert status == 503
    assert json.loads(body)["error"]["code"] == "kv_import_failed"
