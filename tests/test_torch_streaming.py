"""Port parity: the streaming RAG path (streaming/{dsp,replay,timestamps,
accumulator,prompts,chains,server}.py) against the JAX package's.

Both sides run the stubs of tests/test_streaming_rag.py from their own
package: `connectors.fakes.EchoLLM`, `HashEmbedder(32)` and
`streaming.asr.FakeASR`. The DSP runs on CPU tensors here (the card's
route is chip_smoke.py's `phase_streaming`), on short signals.
Tolerances: firwin taps 1e-7; fir_filter (real and complex) 1e-5;
fm_demod 1e-6 on a signal whose unwrapped phase stays small, with
samples whose phase step is exactly +pi and -pi, and, on a second of FM
at 250 kHz that wraps tens of thousands of times, 4 ulps of the largest
unwrapped phase (JAX differences the running sum of the unwrap's
corrections, which rounds at that ulp; the port adds each step's
correction and is held to 4 ulps of 2 pi against float64);
resample_poly values 1e-5, its lengths equal; float_to_pcm and
pcm_to_float bit-identical; fm_modulate 1e-3 (an f32 cumsum in another
order); the FMReceiver's PCM within 1 LSB. The pure-Python modules are
held exactly: the same rows, chunks, routing, statuses and text.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.connectors import fakes as jfakes
from generativeaiexamples_tpu.streaming import accumulator as jacc
from generativeaiexamples_tpu.streaming import asr as jasr
from generativeaiexamples_tpu.streaming import chains as jchains
from generativeaiexamples_tpu.streaming import dsp as jdsp
from generativeaiexamples_tpu.streaming import prompts as jprompts
from generativeaiexamples_tpu.streaming import replay as jreplay
from generativeaiexamples_tpu.streaming import server as jserver
from generativeaiexamples_tpu.streaming import timestamps as jts
from generativeaiexamples_tpu_torch.connectors import fakes as tfakes
from generativeaiexamples_tpu_torch.streaming import accumulator as tacc
from generativeaiexamples_tpu_torch.streaming import asr as tasr
from generativeaiexamples_tpu_torch.streaming import chains as tchains
from generativeaiexamples_tpu_torch.streaming import dsp as tdsp
from generativeaiexamples_tpu_torch.streaming import prompts as tprompts
from generativeaiexamples_tpu_torch.streaming import replay as treplay
from generativeaiexamples_tpu_torch.streaming import server as tserver
from generativeaiexamples_tpu_torch.streaming import timestamps as tts

PKGS = {
    "jax": (jfakes, jacc, jasr, jchains, jts, jreplay, jserver),
    "port": (tfakes, tacc, tasr, tchains, tts, treplay, tserver),
}
FS_AUDIO, FS_IQ = 16_000, 250_000


def _t(a):
    return torch.from_numpy(np.array(a))


# -- DSP ----------------------------------------------------------------------


@pytest.mark.parametrize("numtaps,cutoff,fs", [
    (33, 0.2, 2.0), (65, 100_000.0, 250_000), (4001, 1 / 125, 2.0),
    (17, 0.3, 2.0)])
def test_firwin_taps(numtaps, cutoff, fs):
    want = np.asarray(jdsp.firwin(numtaps, cutoff, fs=fs))
    got = tdsp.firwin(numtaps, cutoff, fs=fs, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    assert abs(got.sum() - 1.0) < 1e-6


@pytest.mark.parametrize("complex_in", [False, True])
def test_fir_filter(complex_in):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096).astype(np.float32)
    if complex_in:
        x = (x + 1j * rng.standard_normal(4096)).astype(np.complex64)
    for numtaps, cutoff, fs in ((17, 0.3, 2.0), (65, 100_000.0, FS_IQ)):
        want = np.asarray(jdsp.fir_filter(jdsp.firwin(numtaps, cutoff, fs),
                                          x))
        got = tdsp.fir_filter(tdsp.firwin(numtaps, cutoff, fs, device="cpu"),
                              _t(x)).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _demod_signal():
    """A smooth phase (no wrap) with planted samples: 1 -> -1 (a step of
    exactly +pi, numpy's `ddmod == -pi and dd > 0` case), -1 -> 1 (-pi),
    and -1 - 0j (angle -pi: a wrap each way)."""
    n = 3000
    theta = (2.5 * np.sin(0.05 * np.arange(n))).astype(np.float32)
    z = np.exp(1j * theta).astype(np.complex64)
    z[100:104] = np.array([1, -1, 1, -1], np.complex64)
    z[200:203] = np.array([-1, 1, -1], np.complex64)
    z[301] = complex(-1.0, -0.0)
    z[600] = complex(-1.0, -0.0)
    return z


def test_fm_demod_with_exact_pi_steps():
    z = _demod_signal()
    want = np.asarray(jdsp.fm_demod(z))
    got = tdsp.fm_demod(_t(z)).numpy()
    assert got.shape == want.shape == (len(z) - 1,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # The +pi step stays +pi (not -pi): numpy's rule.
    assert got[100] == np.float32(np.pi) and want[100] == got[100]
    angle = torch.angle(_t(z))
    np.testing.assert_allclose(tdsp.unwrap(angle).numpy(),
                               np.unwrap(angle.numpy()), atol=1e-6, rtol=0)


def test_fm_demod_on_a_wrapping_signal():
    """One second of FM at 250 kHz, 100 kHz deviation: JAX's
    diff(unwrap(angle)) carries the f32 rounding of the accumulated
    phase; the port's step + correction does not."""
    t = np.arange(FS_IQ) / FS_IQ
    audio = (0.5 * np.sin(2 * np.pi * 440 * t)
             + 0.3 * np.sin(2 * np.pi * 1230 * t + 1)
             + 0.1 * np.random.default_rng(0).standard_normal(FS_IQ))
    z = np.exp(1j * 2 * np.pi * 100_000 * np.cumsum(audio) / FS_IQ
               ).astype(np.complex64)
    phase = np.unwrap(np.angle(z).astype(np.float64))
    assert np.sum(np.abs(np.diff(np.angle(z))) > np.pi) > 10_000
    want = np.asarray(jdsp.fm_demod(z))
    got = tdsp.fm_demod(_t(z)).numpy()
    assert got.shape == want.shape == (FS_IQ - 1,)
    ulp_phase = np.spacing(np.float32(np.abs(phase).max()))
    np.testing.assert_allclose(got, want, atol=4 * ulp_phase, rtol=0)
    np.testing.assert_allclose(got, np.diff(phase), rtol=0,
                               atol=4 * np.spacing(np.float32(2 * np.pi)))


@pytest.mark.parametrize("up,down", [
    (16_000, 250_000), (250_000, 16_000), (2, 1), (24_000, 22_050),
    (22_050, 24_000), (3, 7)])
def test_resample_poly(up, down):
    x = np.random.default_rng(1).standard_normal(3000).astype(np.float32)
    want = np.asarray(jdsp.resample_poly(x, up, down))
    got = tdsp.resample_poly(_t(x), up, down).numpy()
    assert got.shape == want.shape
    assert len(got) == -(-len(x) * up // down) or up % down == 0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_resample_identity_returns_its_input():
    x = _t(np.ones(10, np.float32))
    assert tdsp.resample_poly(x, 1, 1) is x
    assert tdsp.resample_poly(x, 5, 5) is x


def test_pcm_conversions_bit_identical():
    rng = np.random.default_rng(2)
    f = np.concatenate([
        np.array([0, 0.5, 2, -2, 0.99999, -0.99999, 1e-6, -3e-5, 1, -1,
                  32767 / 32768, -0.000015], np.float32),
        rng.uniform(-1.5, 1.5, 5000).astype(np.float32)])
    want = np.asarray(jdsp.float_to_pcm(f))
    got = tdsp.float_to_pcm(_t(f)).numpy()
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tdsp.pcm_to_float(_t(want)).numpy(),
                                  np.asarray(jdsp.pcm_to_float(want)))


def test_fm_modulate():
    audio = jreplay.synth_speech_like(0.25, fs=FS_AUDIO)
    want = np.asarray(jdsp.fm_modulate(audio, FS_AUDIO, FS_IQ))
    got = tdsp.fm_modulate(_t(audio), FS_AUDIO, FS_IQ).numpy()
    assert got.dtype == want.dtype == np.complex64
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_fm_receiver_pcm_within_one_lsb():
    audio = jreplay.synth_speech_like(0.5, fs=FS_AUDIO, seed=3)
    iq = np.asarray(jdsp.fm_modulate(audio, FS_AUDIO, FS_IQ))
    for i, chunk in enumerate((iq[:FS_IQ // 4], iq[FS_IQ // 4:])):
        want = np.asarray(jdsp.FMReceiver(fs_in=FS_IQ).process(chunk))
        got = tdsp.FMReceiver(fs_in=FS_IQ, device="cpu").process(
            _t(chunk)).numpy()
        assert got.dtype == want.dtype == np.int16
        assert got.shape == want.shape
        assert int(np.abs(got.astype(np.int32)
                          - want.astype(np.int32)).max()) <= 1
        if i == 0:  # the chain recovers the audio (the filters delay it)
            n = len(got) - 128
            best = max(np.corrcoef(got[64 + lag:64 + lag + n].astype(
                np.float32), audio[64:64 + n])[0, 1] for lag in range(5))
            assert best > 0.95, best


def test_dsp_entry_points_need_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    with pytest.raises(RuntimeError):
        tdsp.FMReceiver(fs_in=FS_IQ)
    with pytest.raises(RuntimeError):
        tdsp.firwin(33, 0.2)
    with pytest.raises(RuntimeError):
        tdsp.fm_modulate(np.zeros(16, np.float32), FS_AUDIO, FS_IQ)


# -- the framework-neutral modules -------------------------------------------


def test_prompts_are_jax_s():
    for name in ("RAG_PROMPT", "INTENT_PROMPT", "RECENCY_PROMPT",
                 "SUMMARIZATION_PROMPT"):
        assert getattr(tprompts, name) == getattr(jprompts, name)


def _docs(rows):
    return [(d.content, d.tstamp, d.source_id) for d in rows]


def test_time_index_windows_hold_the_same_rows():
    out = {}
    for pkg, (_, _, _, _, ts, _, _) in PKGS.items():
        db = ts.TimestampDatabase()
        for i, t in enumerate((1000.0, 1950.0, 2000.0, 2089.0, 2091.0,
                               3000.0)):
            db.insert_docs([f"entry {i}", f"twin {i}"], f"s{i % 2}",
                           tstamp=t)
        out[pkg] = (len(db), _docs(db.recent(1500.0)),
                    _docs(db.recent(2091.0)), _docs(db.past(2000.0, 90)),
                    _docs(db.past(2000.0, 91)), _docs(db.past(5000.0)))
    assert out["port"] == out["jax"]
    assert out["port"][0] == 12


def _stack(pkg, chunk_size=64, chunk_overlap=8):
    fakes, acc, *_ = PKGS[pkg]
    store = acc.StreamingStore(fakes.HashEmbedder(32))
    return store, acc.TextAccumulator(store, chunk_size=chunk_size,
                                      chunk_overlap=chunk_overlap)


def test_accumulator_gives_the_same_chunks_per_source():
    updates = [
        ("radio", "short bit"),
        ("radio", "this is a much longer transcript fragment that should "
                  "definitely flush full chunks into the store"),
        ("tv", "alpha text on another source"),
        ("radio", "and more words keep arriving from the same station "
                  "while the tail stays buffered"),
        ("tv", "beta " * 30),
    ]
    out = {}
    for pkg in PKGS:
        store, acc = _stack(pkg, chunk_size=40, chunk_overlap=8)
        statuses = [acc.update(s, t) for s, t in updates]
        tails = dict(acc.accumulators)
        flushed = [acc.flush("radio"), acc.flush("radio"), acc.flush("tv")]
        rows = [(d.content, d.source_id)
                for d in acc.timestamp_db.recent(0.0)]
        hits = [(h.text, h.metadata) for h in store.search("station words",
                                                           max_entries=3)]
        out[pkg] = (statuses, tails, flushed, rows, len(store.store), hits)
    assert out["port"] == out["jax"]


def test_classify_clean_dirty_and_invalid_json():
    cases = [
        ("UserIntent", '{"intentType": "RecentSummary"}'),
        ("UserIntent", 'Sure! {"intentType": "TimeWindow"} there'),
        ("UserIntent", '{"intentType": "Bogus"}'),
        ("UserIntent", "no json here"),
        ("UserIntent", '["a list"]'),
        ("TimeResponse", '{"timeNum": 5, "timeUnit": "minutes"}'),
        ("TimeResponse", 'ok {"timeNum": 2, "timeUnit": "hours", "x": 1}'),
        ("TimeResponse", '{"timeNum": 5, "bogus": 1}'),
        ("TimeResponse", "{not json}"),
    ]
    for cls_name, reply in cases:
        res = {}
        for pkg, (fakes, _, _, chains, *_) in PKGS.items():
            llm = fakes.EchoLLM(script=[("q", reply)])
            got = chains.classify(llm, "q?", "sys",
                                  getattr(chains, cls_name))
            res[pkg] = None if got is None else dict(vars(got))
        assert res["port"] == res["jax"], (cls_name, reply)
    for unit in ("s", "minutes", "Hours ", "d", "weeks"):
        assert tchains.TimeResponse(3, unit).to_seconds() == \
            jchains.TimeResponse(3, unit).to_seconds()
    with pytest.raises(ValueError, match="unknown time unit"):
        tchains.TimeResponse(1, "fortnights").to_seconds()


def _scripted(fakes, intent, num=10, unit="minutes", extra=()):
    return fakes.EchoLLM(script=[
        ("Classify the intent", json.dumps({"intentType": intent})),
        ("Extract how far back", json.dumps({"timeNum": num,
                                             "timeUnit": unit})),
        *extra])


def _routing_cases():
    now = 10_000.0

    def recent(pkg):
        fakes = PKGS[pkg][0]
        store, acc = _stack(pkg)
        acc.timestamp_db.insert_docs(["ancient news"], "s", tstamp=now - 5000)
        acc.timestamp_db.insert_docs(["fresh news about tpus"], "s",
                                     tstamp=now - 60)
        return (_scripted(fakes, "RecentSummary"), acc, store,
                dict(now=now), "what happened in the last 10 minutes?")

    def window(pkg):
        fakes = PKGS[pkg][0]
        store, acc = _stack(pkg)
        for text, age in (("too old", 800), ("window hit", 300),
                          ("too new", 30)):
            acc.timestamp_db.insert_docs([text], "s", tstamp=now - age)
        return (_scripted(fakes, "TimeWindow", 5, "minutes"), acc, store,
                dict(now=now), "what were they saying 5 minutes ago?")

    def topic(pkg):
        fakes = PKGS[pkg][0]
        store, acc = _stack(pkg)
        acc.update("s", "the quick brown fox jumped over the lazy dog and "
                        "kept running through the quiet forest all night")
        acc.flush("s")
        return (_scripted(fakes, "SpecificTopic"), acc, store, {},
                "tell me about the fox")

    def unknown(pkg):
        fakes = PKGS[pkg][0]
        store, acc = _stack(pkg)
        return (fakes.EchoLLM(script=[("Classify the intent", "garbage")]),
                acc, store, {}, "anything")

    def bad_unit(pkg):
        fakes = PKGS[pkg][0]
        store, acc = _stack(pkg)
        acc.update("s", "words about the harbour and the ships at dawn")
        acc.flush("s")
        return (_scripted(fakes, "RecentSummary", 3, "fortnights"), acc,
                store, dict(now=now), "recap the harbour")

    def summarize(pkg):
        fakes = PKGS[pkg][0]
        store, acc = _stack(pkg, chunk_size=200, chunk_overlap=0)
        for i in range(12):
            acc.timestamp_db.insert_docs(
                [f"entry number {i} with some distinct content"], "s",
                tstamp=now - 60 - i)
        llm = _scripted(fakes, "RecentSummary", extra=[
            ("Summarize", "condensed summary")])
        return llm, acc, store, dict(now=now, max_docs=4,
                                     allow_summary=True), \
            "summarize the last 10 minutes"

    def truncate(pkg):
        fakes = PKGS[pkg][0]
        store, acc = _stack(pkg)
        for i in range(8):
            acc.timestamp_db.insert_docs([f"e{i}"], "s", tstamp=now - 60 - i)
        return (_scripted(fakes, "RecentSummary"), acc, store,
                dict(now=now, max_docs=3, allow_summary=False),
                "recap please")

    def truncate_window(pkg):
        fakes = PKGS[pkg][0]
        store, acc = _stack(pkg)
        for i in range(8):
            acc.timestamp_db.insert_docs([f"w{i}"], "s",
                                         tstamp=now - 300 + 7 * i)
        return (_scripted(fakes, "TimeWindow", 5, "minutes"), acc, store,
                dict(now=now, max_docs=3, allow_summary=False),
                "what was said 5 minutes ago")

    return [recent, window, topic, unknown, bad_unit, summarize, truncate,
            truncate_window]


@pytest.mark.parametrize("case", _routing_cases(),
                         ids=lambda f: f.__name__)
def test_chain_routing_and_context_budgeting(case):
    """The same intent routing, summarization and truncation decisions
    and the same streamed text, with the LLM calls made in the same
    order."""
    out = {}
    for pkg in PKGS:
        chains = PKGS[pkg][3]
        llm, acc, store, kw, question = case(pkg)
        chain = chains.StreamingRagChain(llm, acc, store, **kw)
        pieces = list(chain.answer(question))
        out[pkg] = (pieces, llm.calls)
    assert out["port"] == out["jax"]


def test_no_knowledge_base_is_plain_chat():
    out = {}
    for pkg in PKGS:
        fakes, chains = PKGS[pkg][0], PKGS[pkg][3]
        store, acc = _stack(pkg)
        chain = chains.StreamingRagChain(fakes.EchoLLM(), acc, store)
        out[pkg] = "".join(chain.answer("hi there", use_knowledge_base=False))
    assert out["port"] == out["jax"] and "hi there" in out["port"]


def _sse_frames(raw: str):
    return [json.loads(ln[6:]) for ln in raw.split("\n\n")
            if ln.startswith("data: ")]


def test_streaming_server_rest_contract():
    """Both servers answer one request sequence with the same status
    codes, JSON bodies and SSE frames."""
    from aiohttp.test_utils import TestClient, TestServer

    requests = [
        ("get", "/serverStatus", None, None),
        ("post", "/storeStreamingText", {
            "transcript": "the reactor output is stable at nine hundred "
                          "megawatts this afternoon", "source_id": "fm"},
         None),
        ("post", "/storeStreamingText", {}, None),
        ("post", "/storeStreamingText", '"hello"', "application/json"),
        ("post", "/storeStreamingText", "{bad", "application/json"),
        ("post", "/flush", {"source_id": "fm"}, None),
        ("post", "/flush", "[1]", "application/json"),
        ("post", "/storeStreamingText", {
            "transcript": "final words", "source_id": "fm",
            "end_of_stream": True}, None),
        ("post", "/storeStreamingText", {"source_id": "fm",
                                         "end_of_stream": True}, None),
        ("post", "/generate", {"question": "what about the reactor?"}, None),
        ("post", "/generate", {"question": ""}, None),
        ("post", "/generate", "nope", "application/json"),
        ("post", "/generate", {"question": "hello",
                               "use_knowledge_base": False}, None),
    ]

    async def drive(srv):
        client = TestClient(TestServer(srv.app))
        await client.start_server()
        seen = []
        try:
            for method, path, body, ctype in requests:
                kw = {"json": body} if ctype is None and body is not None \
                    else {}
                if ctype is not None:
                    kw = {"data": body, "headers": {"Content-Type": ctype}}
                r = await getattr(client, method)(path, **kw)
                raw = (await r.read()).decode()
                payload = (_sse_frames(raw) if path == "/generate"
                           and r.status == 200 else json.loads(raw))
                seen.append((r.status, payload))
        finally:
            await client.close()
        return seen

    out = {}
    for pkg in PKGS:
        fakes, server = PKGS[pkg][0], PKGS[pkg][6]
        llm = fakes.EchoLLM(script=[
            ("Classify the intent", '{"intentType": "SpecificTopic"}')])
        srv = server.StreamingServer(llm, fakes.HashEmbedder(32),
                                     chunk_size=32, chunk_overlap=0)
        out[pkg] = asyncio.run(drive(srv))
    assert out["port"] == out["jax"]
    frames = out["port"][9][1]
    assert frames[-1] == {"done": True}
    assert "reactor" in "".join(f.get("content", "") for f in frames)


def test_stream_pump_end_to_end():
    """FM modulate -> receive chain (CPU tensors) -> FakeASR ->
    accumulator -> time index -> the recent-summary answer: the same
    transcripts and the same answer as JAX's pump."""
    transcripts = [
        "breaking news the launch window opens tonight",
        "weather on the coast is clearing before the launch",
        "engineers report all systems are go for liftoff",
    ]
    audio = jreplay.synth_speech_like(3.0, fs=FS_AUDIO)
    np.testing.assert_array_equal(
        treplay.synth_speech_like(3.0, fs=FS_AUDIO), audio)
    out = {}
    for pkg in PKGS:
        fakes, acc_mod, asr, chains, _, replay, _ = PKGS[pkg]
        store, acc = _stack(pkg, chunk_size=48, chunk_overlap=0)
        fake = asr.FakeASR(script=list(transcripts))
        kw = {"device": "cpu"} if pkg == "port" else {}
        pump = replay.StreamPump(
            fake, on_transcript=lambda sid, text: acc.update(sid, text),
            **kw)
        delivered = pump.run(audio, chunk_time=1.0)
        for sid in list(acc.accumulators):
            acc.flush(sid)
        rows = [d.content for d in acc.timestamp_db.recent(0.0)]
        llm = _scripted(fakes, "RecentSummary", 5, "minutes")
        chain = chains.StreamingRagChain(llm, acc, store, max_docs=8)
        answer = "".join(chain.answer("what happened in the last 5 "
                                      "minutes?"))
        out[pkg] = (delivered, fake.calls, rows, answer)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 3
    assert "entries from the last 300s" in out["port"][3]
    assert "launch" in out["port"][3]


def test_stream_pump_over_udp_receive_iq():
    """IQ sent over loopback UDP, received by `udp_receive_iq` (a 4 MB
    receive buffer asked of the host) and pushed through
    `StreamPump.run_iq`, delivers what `run` delivers in process: the
    same PCM to the ASR, the same transcripts."""
    import socket
    import threading
    import time

    audio = treplay.synth_speech_like(0.3, fs=FS_AUDIO, seed=5)
    chunks = list(treplay.iq_chunks(audio, FS_AUDIO, FS_IQ, chunk_time=0.1,
                                    device="cpu"))
    iq = np.concatenate(chunks)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]

    def send():
        time.sleep(0.5)  # the receiver binds first
        for i in range(0, len(iq), 4096):
            treplay.udp_send_iq(iq[i:i + 4096], ("127.0.0.1", port))
            time.sleep(0.002)

    sender = threading.Thread(target=send)
    sender.start()
    got = treplay.udp_receive_iq(port, iq.nbytes, timeout=5.0)
    sender.join()
    np.testing.assert_array_equal(got, iq)

    def pump_run(feed):
        pcms, texts = [], []

        class Recording(tasr.FakeASR):
            def transcribe(self, pcm, sample_rate):
                pcms.append(pcm)
                return super().transcribe(pcm, sample_rate)

        pump = treplay.StreamPump(
            Recording(script=["one", "two", "three"]),
            on_transcript=lambda sid, text: texts.append((sid, text)),
            device="cpu")
        return feed(pump), pcms, texts

    n = len(chunks[0])
    via_udp = pump_run(lambda p: p.run_iq(
        got[i:i + n] for i in range(0, len(got), n)))
    in_process = pump_run(lambda p: p.run(audio, chunk_time=0.1))
    assert via_udp[0] == in_process[0] == 3
    assert via_udp[2] == in_process[2]
    for a, b in zip(via_udp[1], in_process[1]):
        np.testing.assert_array_equal(a, b)


def test_iq_chunks_equal_jax_within_tolerance():
    audio = jreplay.synth_speech_like(0.3, fs=FS_AUDIO, seed=5)
    want = list(jreplay.iq_chunks(audio, FS_AUDIO, FS_IQ, chunk_time=0.1))
    got = list(treplay.iq_chunks(audio, FS_AUDIO, FS_IQ, chunk_time=0.1,
                                 device="cpu"))
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.complex64
        np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)


def test_wav_round_trip(tmp_path):
    pcm = (np.sin(np.arange(1600) / 5) * 12000).astype(np.int16)
    path = tmp_path / "a.wav"
    path.write_bytes(jasr.pcm_to_wav_bytes(pcm, 16000))
    (ga, gr), (wa, wr) = treplay.load_wav(str(path)), jreplay.load_wav(
        str(path))
    assert gr == wr == 16000
    np.testing.assert_array_equal(ga, wa)
