"""Pluggable ASR / TTS clients: the playground's voice seam.

Counterpart of generativeaiexamples_tpu/streaming/asr.py: the protocols,
WAV packing, HTTP clients for any OpenAI-audio-compatible endpoint
(`/v1/audio/transcriptions`, `/v1/audio/speech`) and scripted fakes for
hermetic tests. The HTTP clients ride `urllib` (utils/http.py) and send
the multipart and JSON bodies of the JAX clients' `requests` calls; the
TTS reply is resampled to the asked rate by `dsp.resample_poly` and
`dsp.float_to_pcm`, as the JAX client does, on the CPU (a host audio
buffer of one reply).
"""

from __future__ import annotations

import io
import json
import wave
from typing import List, Optional, Protocol

import numpy as np

from generativeaiexamples_tpu_torch.utils import http


class ASRClient(Protocol):
    def transcribe(self, pcm: np.ndarray, sample_rate: int) -> str:
        """int16 PCM chunk -> transcript text ('' when silence)."""
        ...


class TTSClient(Protocol):
    def synthesize(self, text: str, sample_rate: int = 22050) -> np.ndarray:
        """Text -> int16 PCM audio."""
        ...


def pcm_to_wav_bytes(pcm: np.ndarray, sample_rate: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(np.asarray(pcm, np.int16).tobytes())
    return buf.getvalue()


def wav_bytes_to_pcm(data: bytes) -> "tuple[np.ndarray, int]":
    """WAV bytes -> (mono int16 PCM, sample_rate). Multi-channel input
    is averaged to mono (browser recorders often emit stereo)."""
    with wave.open(io.BytesIO(data), "rb") as w:
        rate = w.getframerate()
        nch = w.getnchannels()
        width = w.getsampwidth()
        frames = w.readframes(w.getnframes())
    if width != 2:
        raise ValueError(f"expected 16-bit PCM WAV, got {8 * width}-bit")
    pcm = np.frombuffer(frames, np.int16)
    if nch > 1:
        pcm = pcm.reshape(-1, nch).mean(axis=1).astype(np.int16)
    return pcm, rate


def create_voice_clients(cfg):
    """(asr, tts) from AppConfig.voice: HTTP clients where URLs are
    configured, None otherwise (the playground hides the voice
    controls)."""
    voice = getattr(cfg, "voice", None)
    if voice is None:
        return None, None
    asr = HTTPASRClient(voice.asr_server_url, voice.asr_model) \
        if voice.asr_server_url else None
    tts = HTTPTTSClient(voice.tts_server_url, voice.tts_model,
                        voice.tts_voice) if voice.tts_server_url else None
    return asr, tts


def _auth(api_key: str) -> dict:
    return {"Authorization": f"Bearer {api_key}"} if api_key else {}


class HTTPASRClient:
    """POSTs WAV chunks to an OpenAI-compatible /v1/audio/transcriptions
    endpoint (any Whisper server works)."""

    def __init__(self, base_url: str, model: str = "whisper-1",
                 api_key: str = ""):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.api_key = api_key

    def transcribe(self, pcm: np.ndarray, sample_rate: int) -> str:
        url = f"{self.base_url}/v1/audio/transcriptions"
        body, ctype = http.multipart_body(
            {"model": self.model},
            [("file", ("chunk.wav", pcm_to_wav_bytes(pcm, sample_rate),
                       "audio/wav"))])
        status, out = http.request(
            "POST", url, body=body, timeout=60,
            headers={**_auth(self.api_key), "Content-Type": ctype})
        return json.loads(http.checked(status, out, url)).get("text", "")


class HTTPTTSClient:
    """POSTs text to an OpenAI-compatible /v1/audio/speech endpoint and
    decodes the WAV reply, resampled to the asked rate."""

    def __init__(self, base_url: str, model: str = "tts-1",
                 voice: str = "alloy", api_key: str = ""):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.voice = voice
        self.api_key = api_key

    def synthesize(self, text: str, sample_rate: int = 22050) -> np.ndarray:
        url = f"{self.base_url}/v1/audio/speech"
        status, out = http.request(
            "POST", url, timeout=120,
            body=http.json_body({"model": self.model, "voice": self.voice,
                                 "input": text, "response_format": "wav"}),
            headers={**_auth(self.api_key),
                     "Content-Type": "application/json"})
        with wave.open(io.BytesIO(http.checked(status, out, url)), "rb") as w:
            got_rate = w.getframerate()
            frames = w.readframes(w.getnframes())
        pcm = np.frombuffer(frames, np.int16)
        if got_rate != sample_rate:
            # Endpoints pick their own rate (commonly 24 kHz): resample
            # so callers get the rate they asked for.
            import torch

            from generativeaiexamples_tpu_torch.streaming import dsp

            audio = torch.from_numpy(np.asarray(pcm, np.float32) / 32768.0)
            audio = dsp.resample_poly(audio, sample_rate, got_rate)
            pcm = dsp.float_to_pcm(torch.clamp(audio, -1.0, 1.0)).numpy()
        return pcm


class FakeASR:
    """Scripted transcription: the next transcript line per non-silent
    chunk."""

    def __init__(self, script: Optional[List[str]] = None,
                 silence_threshold: int = 50):
        self.script = list(script or [])
        self.silence_threshold = silence_threshold
        self.calls = 0

    def transcribe(self, pcm: np.ndarray, sample_rate: int) -> str:
        self.calls += 1
        if np.abs(np.asarray(pcm, np.int32)).mean() < self.silence_threshold:
            return ""
        return self.script.pop(0) if self.script else ""


class FakeTTS:
    """Deterministic tone-per-word synthesis for tests."""

    def synthesize(self, text: str, sample_rate: int = 22050) -> np.ndarray:
        n_words = max(1, len(text.split()))
        t = np.arange(int(0.05 * n_words * sample_rate)) / sample_rate
        return (np.sin(2 * np.pi * 440.0 * t) * 16000).astype(np.int16)
