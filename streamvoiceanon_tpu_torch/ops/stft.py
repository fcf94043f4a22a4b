"""Causal STFT / log-mel front end, as `streamvoiceanon_tpu.ops.stft`.

Left-pad `win - hop` zeros, non-centered frames, periodic Hann window,
`sqrt(re^2 + im^2 + 1e-6)` magnitude, slaney-scale/slaney-norm mel filter
bank, `log(clamp(x, 1e-5))`.  The DFT is a matmul of the framed signal with
a precomputed windowed cos/sin table — the JAX package's formulation, not
`torch.stft` — so the features, and the tokenizer's sign bits downstream,
match it to float32 rounding.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from streamvoiceanon_tpu_torch.config import MelConfig


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window(win, periodic=True))."""
    n = np.arange(win_length)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))


def _hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep,
        freq / f_sp,
    )


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel,
        min_log_hz * np.exp(logstep * (mels - min_log_mel)),
        mels * f_sp,
    )


def mel_filterbank(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                   sample_rate: int) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular filters, (n_freqs, n_mels)."""
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_slaney(np.array(f_min)),
                        _hz_to_mel_slaney(np.array(f_max)), n_mels + 2)
    f_pts = _mel_to_hz_slaney(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
    return (fb * enorm[None, :]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def dft_matrix(n_fft: int, win_length: int) -> np.ndarray:
    """Windowed real DFT as a (n_fft, 2 * n_bins) matrix: columns are
    [real_0..real_{K-1}, imag_0..imag_{K-1}], K = n_fft // 2 + 1."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    lpad = (n_fft - win_length) // 2
    win = np.pad(hann_window(win_length), (lpad, n_fft - win_length - lpad))[:, None]
    real = (np.cos(ang) * win).astype(np.float32)
    imag = (-np.sin(ang) * win).astype(np.float32)
    return np.concatenate([real, imag], axis=1)


@functools.lru_cache(maxsize=8)
def mel_matrix(cfg: MelConfig) -> np.ndarray:
    return mel_filterbank(cfg.n_fft // 2 + 1, cfg.f_min, cfg.fmax, cfg.n_mels,
                          cfg.sample_rate)


def log_mel_frames(x: torch.Tensor, cfg: MelConfig, dft: torch.Tensor,
                   fb: torch.Tensor) -> torch.Tensor:
    """(B, T) float32 samples, already padded with their left context ->
    (B, frames, n_mels) log-mel of every full window at hop spacing."""
    frames = x.unfold(1, cfg.win_length, cfg.hop_length)  # (B, F, win)
    spec = frames @ dft
    n_bins = cfg.n_fft // 2 + 1
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    mag = torch.sqrt(re * re + im * im + 1e-6)
    return torch.log(torch.clamp(mag @ fb, min=1e-5))


def linear_spectrogram(wav: torch.Tensor, cfg: MelConfig, *, causal_pad: bool = True,
                       center: bool = False, pow2_sqrt_eps: bool = None) -> torch.Tensor:
    """Magnitude spectrogram (B, frames, n_bins) of a whole utterance.

    `causal_pad` left-pads `win - hop` zeros (frames = T // hop for T a
    multiple of hop); `center` instead reflect-pads n_fft // 2 on both
    sides (torch.stft center=True, the speaker encoder's front end).  The
    1e-6 under the square root follows `causal_pad` unless given."""
    if wav.ndim == 1:
        wav = wav[None]
    if wav.ndim != 2:
        raise ValueError(f"expected mono audio of shape (T,) or (B, T), got "
                         f"{tuple(wav.shape)}; mix multi-channel audio down to mono first")
    if causal_pad and center:
        raise ValueError("causal_pad and center are mutually exclusive")
    x = wav.float()
    if causal_pad:
        x = torch.nn.functional.pad(x, (cfg.win_length - cfg.hop_length, 0))
    elif center:
        x = torch.nn.functional.pad(x[:, None], (cfg.n_fft // 2, cfg.n_fft // 2),
                                    mode="reflect")[:, 0]
    dft = torch.from_numpy(dft_matrix(cfg.n_fft, cfg.win_length)).to(x.device)
    spec = x.unfold(1, cfg.n_fft, cfg.hop_length) @ dft
    n_bins = cfg.n_fft // 2 + 1
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    if pow2_sqrt_eps is None:
        pow2_sqrt_eps = causal_pad
    return torch.sqrt(re * re + im * im + (1e-6 if pow2_sqrt_eps else 0.0))


def mel_spectrogram_center(wav: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """torchaudio MelSpectrogram(power=1, slaney, center=True): the speaker
    encoder's front end, (B, frames, n_mels)."""
    spec = linear_spectrogram(wav, cfg, causal_pad=False, center=True)
    return spec @ torch.from_numpy(mel_matrix(cfg)).to(spec.device)


def log_mel_spectrogram(wav: torch.Tensor, cfg: MelConfig, *, causal_pad: bool = True,
                        pow2_sqrt_eps: bool = True) -> torch.Tensor:
    """Causal log-mel features of a whole utterance, (B, frames, n_mels)."""
    spec = linear_spectrogram(wav, cfg, causal_pad=causal_pad, pow2_sqrt_eps=pow2_sqrt_eps)
    mel = spec @ torch.from_numpy(mel_matrix(cfg)).to(spec.device)
    return torch.log(torch.clamp(mel, min=1e-5))
