"""Signal ops for the SDR -> audio front end, in torch on an explicit
device.

Counterpart of generativeaiexamples_tpu/streaming/dsp.py (plain jnp there,
plain torch here: no `pl.pallas_call` sits on this path):

- firwin            Hamming-window FIR design
- fir_filter        causal FIR filtering (lfilter(taps, [1], x))
- fm_demod          phase-unwrap discrete differentiator
- resample_poly     rational resampler, scipy's filter choice
- float_to_pcm      float audio -> int16 PCM
- fm_modulate       audio -> complex baseband FM

Every function works on the device of the tensor it is given; a numpy
input goes to `device` (CUDA unless the caller asks for the CPU). The
numbers follow the JAX functions':

- `jnp.convolve` is a true convolution: the taps are applied flipped, as
  a product with each input window (a matmul, which computes in f32 on
  the card as on the CPU), and a complex input is filtered in its real
  and imaginary parts apart;
- the resampler's zero-stuffed convolution is evaluated only at the kept
  outputs and only at the nonzero inputs (polyphase), which is the same
  sum with the zero terms left out;
- `unwrap` is numpy's rule written out, `ddmod == -pi and dd > 0 -> pi`
  included, with JAX's floor remainder; `fm_demod` takes the unwrapped
  phase's differences from the same rule without the running sum;
- `fm_modulate` integrates with an f32 `cumsum`, which sums in another
  order on CUDA than on the CPU (and than XLA does): the IQ phase agrees
  to the rounding of the running sum.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from generativeaiexamples_tpu_torch.device import DeviceLike, resolve_device

# Output rows a polyphase block evaluates at once (bounds the gather).
_RESAMPLE_BLOCK = 1 << 16


def _as_tensor(x, device: DeviceLike = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def _firwin_np(numtaps: int, cutoff: float, fs: float) -> np.ndarray:
    nyq = fs / 2.0
    fc = cutoff / nyq
    n = np.arange(numtaps) - (numtaps - 1) / 2.0
    taps = np.sinc(fc * n) * fc * np.hamming(numtaps)
    return (taps / taps.sum()).astype(np.float32)


def firwin(numtaps: int, cutoff: float, fs: float = 2.0,
           device: DeviceLike = None) -> torch.Tensor:
    """Hamming-windowed sinc lowpass with unity DC gain, f32 on
    `device` (designed in f64 numpy, as the JAX function does)."""
    return torch.from_numpy(_firwin_np(numtaps, cutoff, fs)).to(
        resolve_device(device))


def _fir_real(taps: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[n] = sum_k taps[k] x[n - k] over the rows of x [..., N]."""
    T = taps.shape[0]
    xp = torch.nn.functional.pad(x, (T - 1, 0))
    return xp.unfold(-1, T, 1) @ taps.to(x.dtype).flip(0)


def fir_filter(taps: torch.Tensor, x, device: DeviceLike = None
               ) -> torch.Tensor:
    """Causal FIR filter, the length of x (lfilter(taps, [1], x)). A
    complex x is filtered in its real and imaginary parts apart."""
    x = _as_tensor(x, device)
    taps = taps.to(x.device)
    if x.is_complex():
        parts = _fir_real(taps, torch.stack([x.real, x.imag]))
        return torch.complex(parts[0], parts[1]).to(x.dtype)
    return _fir_real(taps, x).to(x.dtype)


def _floor_remainder(a: torch.Tensor, b: float) -> torch.Tensor:
    """jnp.remainder: fmod, moved into b's sign."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def _unwrap_steps(p: torch.Tensor):
    """(the phase steps dd, each step's correction) by numpy's unwrap
    rule, period 2 pi: a step of at least pi is replaced by its remainder
    into [-pi, pi), a step of exactly -pi after a positive one becoming
    +pi."""
    interval = math.pi
    dd = torch.diff(p, dim=-1)
    ddmod = _floor_remainder(dd + interval, 2 * math.pi) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0),
                        torch.full_like(ddmod, interval), ddmod)
    correct = torch.where(dd.abs() < interval, torch.zeros_like(dd),
                          ddmod - dd)
    return dd, correct


def unwrap(p: torch.Tensor) -> torch.Tensor:
    """numpy's (and jnp's) unwrap over the last axis, period 2 pi."""
    _, correct = _unwrap_steps(p)
    return torch.cat([p[..., :1], p[..., 1:] + torch.cumsum(correct, -1)],
                     dim=-1)


def fm_demod(x, device: DeviceLike = None) -> torch.Tensor:
    """Demodulate complex baseband FM: the differences of the unwrapped
    instantaneous phase (one sample shorter than x). JAX takes
    diff(unwrap(angle)); in exact arithmetic that is each step plus its
    correction, which is what this returns: it skips the running sum of
    the corrections, whose f32 rounding (an ulp of the accumulated phase)
    the difference would carry and which CUDA and the CPU sum in other
    orders."""
    dd, correct = _unwrap_steps(torch.angle(_as_tensor(x, device)))
    return dd + correct


@functools.lru_cache(maxsize=64)
def _resample_filter_np(up: int, down: int,
                        ntaps_per_phase: int = 16) -> np.ndarray:
    max_rate = max(up, down)
    numtaps = 2 * ntaps_per_phase * max_rate + 1
    return _firwin_np(numtaps, 1.0 / max_rate, 2.0)


def _resample_filter(up: int, down: int, device: DeviceLike = None
                     ) -> torch.Tensor:
    """Anti-aliasing lowpass at the tighter of the two Nyquists, gain
    `up` (scipy's resample_poly filter), f32 on `device`."""
    return torch.from_numpy(_resample_filter_np(up, down)).to(
        resolve_device(device)) * up


def _resample_apply(x: torch.Tensor, taps: torch.Tensor, up: int,
                    down: int) -> torch.Tensor:
    """The JAX function's convolve(zero-stuffed x, taps)[delay:
    delay + n * up][::down], evaluated per kept output over the taps that
    meet a nonzero (unstuffed) input: output m reads full-convolution
    index c = delay + m * down, i.e. x[c // up - q] times
    taps[c % up + q * up]."""
    n, T = x.shape[0], taps.shape[0]
    dev = x.device
    delay = (T - 1) // 2
    n_out = -(-n * up // down)
    Q = -(-T // up)
    q = torch.arange(Q, device=dev)
    tap_idx = torch.arange(up, device=dev)[:, None] + q[None, :] * up
    table = torch.where(tap_idx < T, taps.to(x.dtype)[tap_idx.clamp(
        max=T - 1)], torch.zeros((), dtype=x.dtype, device=dev))
    out = torch.empty((n_out,), dtype=x.dtype, device=dev)
    for start in range(0, n_out, _RESAMPLE_BLOCK):
        m = torch.arange(start, min(n_out, start + _RESAMPLE_BLOCK),
                         device=dev)
        c = delay + m * down
        src = (c // up)[:, None] - q[None, :]
        inside = (src >= 0) & (src < n)
        xv = torch.where(inside, x[src.clamp(0, n - 1)],
                         torch.zeros((), dtype=x.dtype, device=dev))
        out[start:start + m.shape[0]] = (table[c % up] * xv).sum(-1)
    return out


def resample_poly(x, up: int, down: int,
                  device: DeviceLike = None) -> torch.Tensor:
    """Rational-rate resampler; output length ceil(len(x) * up / down).
    `x` itself when the reduced rates are 1 and 1."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return x
    x = _as_tensor(x, device)
    return _resample_apply(x, _resample_filter(up, down, x.device), up,
                           down)


def float_to_pcm(f_data, device: DeviceLike = None) -> torch.Tensor:
    """Float audio in [-1, 1] -> int16 PCM (scaled by 32768, clipped,
    truncated toward zero)."""
    f_data = _as_tensor(f_data, device)
    scaled = f_data * 32768.0
    return torch.clamp(scaled, -32768, 32767).to(torch.int16)


def pcm_to_float(pcm, device: DeviceLike = None) -> torch.Tensor:
    return _as_tensor(pcm, device).to(torch.float32) / 32768.0


def fm_modulate(audio, fs_in: int, fs_out: int,
                deviation: float = 100_000.0,
                device: DeviceLike = None) -> torch.Tensor:
    """Audio -> complex64 baseband FM IQ at fs_out: resample, integrate,
    frequency-modulate."""
    x = resample_poly(_as_tensor(audio, device).to(torch.float32), fs_out,
                      fs_in)
    integrated = torch.cumsum(x, 0) / fs_out
    phase = integrated * (2.0 * math.pi * deviation)
    return torch.complex(torch.cos(phase), torch.sin(phase))


class FMReceiver:
    """The SDR demod chain: lowpass -> fm_demod -> resample -> PCM, on
    `device` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, fs_in: int, fs_audio: int = 16_000,
                 cutoff: float = 100_000.0, numtaps: int = 65,
                 gain: float = 4.0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.fs_in = fs_in
        self.fs_audio = fs_audio
        self.taps = firwin(numtaps, cutoff, fs=fs_in, device=self.device)
        self.gain = gain

    def process(self, iq_chunk) -> torch.Tensor:
        """IQ baseband chunk -> int16 PCM audio at fs_audio (a tensor on
        the receiver's device)."""
        iq = _as_tensor(iq_chunk, self.device).to(self.device)
        demod = fm_demod(fir_filter(self.taps, iq))
        audio = resample_poly(demod, self.fs_audio, self.fs_in)
        # Normalize the FM discriminator slope to unit audio amplitude.
        audio = audio * (self.gain * self.fs_in / (2 * math.pi * 100_000.0))
        return float_to_pcm(torch.clamp(audio, -1.0, 1.0))
