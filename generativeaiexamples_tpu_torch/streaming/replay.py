"""File-replay signal source and the stream pump.

Counterpart of generativeaiexamples_tpu/streaming/replay.py: FM-modulate
audio and feed it to the receive chain in chunks, so the whole
SDR -> demod -> ASR -> accumulator path runs without radio hardware,
in-process or over UDP packets into the native ring (native/ring.py).
The modulation and the receiver run in torch on the device the caller
names (CUDA unless it asks for the CPU); what crosses a socket or goes
to the ASR is numpy.
"""

from __future__ import annotations

import socket
import wave
from typing import Callable, Iterable, Iterator

import numpy as np

from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device
from generativeaiexamples_tpu_torch.streaming import dsp


def load_wav(path: str) -> "tuple[np.ndarray, int]":
    """Mono float audio in [-1, 1] and its sample rate, stdlib only."""
    with wave.open(path, "rb") as w:
        fs = w.getframerate()
        n = w.getnframes()
        raw = np.frombuffer(w.readframes(n), np.int16)
        if w.getnchannels() > 1:
            raw = raw.reshape(-1, w.getnchannels()).mean(axis=1)
    return np.asarray(raw, np.float32) / 32768.0, fs


def synth_speech_like(duration_s: float, fs: int = 16_000,
                      seed: int = 0) -> np.ndarray:
    """Synthetic non-silent audio (band-limited noise), the stand-in for
    a WAV file; numpy's draw from `seed`, as the JAX package makes it."""
    rng = np.random.default_rng(seed)
    n = int(duration_s * fs)
    x = rng.standard_normal(n).astype(np.float32)
    # Crude band-limit: moving average -> speech-ish spectrum.
    kernel = np.hamming(9).astype(np.float32)
    x = np.convolve(x, kernel / kernel.sum(), mode="same")
    return 0.5 * x / max(1e-6, np.abs(x).max())


def iq_chunks(audio: np.ndarray, fs_in: int, fs_iq: int,
              chunk_time: float = 1.0,
              device: DeviceLike = None) -> Iterator[np.ndarray]:
    """FM-modulate audio on `device` and yield fixed-size complex64 IQ
    chunks (the last one zero-padded)."""
    samples = dsp.fm_modulate(audio, fs_in, fs_iq,
                              device=resolve_device(device)).cpu().numpy()
    chunk = int(fs_iq * chunk_time)
    for i in range(0, len(samples) - chunk + 1, chunk):
        yield samples[i: i + chunk]
    tail = len(samples) % chunk
    if tail:
        yield np.pad(samples[-tail:], (0, chunk - tail))


def udp_send_iq(samples: np.ndarray, dst: tuple, pkt_size: int = 4096
                ) -> int:
    """Send complex64 IQ over UDP; returns the number of packets sent."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    data = np.asarray(samples, np.complex64).tobytes()
    sent = 0
    for i in range(0, len(data), pkt_size):
        sock.sendto(data[i: i + pkt_size], dst)
        sent += 1
    sock.close()
    return sent


# The receive buffer `udp_receive_iq` asks of the host (which caps it):
# a burst larger than the socket's buffer is dropped before the ring
# drains it, and loopback drops past the default (~208 KB) at IQ rates.
RCVBUF_BYTES = 4 << 20


def udp_receive_iq(port: int, n_bytes: int, host: str = "127.0.0.1",
                   timeout: float = 5.0) -> np.ndarray:
    """Collect n_bytes of IQ from UDP through the native ring's GIL-free
    drain (the Python ring on a host with no C compiler), on a socket
    that asks for an `RCVBUF_BYTES` receive buffer."""
    from generativeaiexamples_tpu_torch.native.ring import make_ring

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, RCVBUF_BYTES)
    sock.bind((host, port))
    ring = make_ring(max(n_bytes * 2, 1 << 20))
    try:
        got = ring.recv_udp(sock, n_bytes,
                            idle_timeout_ms=int(timeout * 1000))
        if got < n_bytes:
            raise TimeoutError(
                f"IQ receive stalled: got {got} of {n_bytes} bytes "
                f"within {timeout}s")
        data = ring.pop(n_bytes)
    finally:
        sock.close()
        ring.close()
    return np.frombuffer(data, np.complex64)


class StreamPump:
    """Drive audio through modulate -> receive -> ASR -> sink, the
    in-process form of the file-replay -> SDR -> chain-server path. The
    modulator and `FMReceiver` run on `device`."""

    def __init__(self, asr, on_transcript: Callable[[str, str], None],
                 fs_audio: int = 16_000, fs_iq: int = 250_000,
                 source_id: str = "replay", device: DeviceLike = None):
        self.asr = asr
        self.on_transcript = on_transcript
        self.fs_audio = fs_audio
        self.fs_iq = fs_iq
        self.source_id = source_id
        self.device = resolve_device(device)
        self.receiver = dsp.FMReceiver(fs_in=fs_iq, fs_audio=fs_audio,
                                       device=self.device)

    def run(self, audio: np.ndarray, chunk_time: float = 1.0) -> int:
        """Returns the number of non-empty transcripts delivered."""
        return self.run_iq(iq_chunks(audio, self.fs_audio, self.fs_iq,
                                     chunk_time, device=self.device))

    def run_iq(self, chunks: Iterable[np.ndarray]) -> int:
        """Received complex64 IQ chunks (from `iq_chunks`, or
        `udp_receive_iq`'s samples split) through the receiver, the ASR
        and the sink; returns the number of non-empty transcripts
        delivered."""
        delivered = 0
        for iq in chunks:
            pcm = self.receiver.process(iq).cpu().numpy()
            text = self.asr.transcribe(pcm, self.fs_audio)
            if text:
                self.on_transcript(self.source_id, text)
                delivered += 1
        return delivered
