"""Kaldi-compatible log-mel filterbank features, as the JAX package's
audio/fbank.py (torchaudio.compliance.kaldi.fbank with num_mel_bins 80,
dither 0, 16 kHz): 25 ms Povey-windowed frames every 10 ms (snip_edges),
DC removal, pre-emphasis 0.97, a 512-point power spectrum through DFT
matrices, Kaldi's mel triangles (20 Hz to Nyquist), natural log with an
epsilon floor."""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def povey_window(n: int) -> np.ndarray:
    i = np.arange(n)
    return (0.5 - 0.5 * np.cos(2 * np.pi * i / (n - 1))) ** 0.85


def _mel(hz):
    return 1127.0 * np.log(1.0 + np.asarray(hz, np.float64) / 700.0)


@functools.lru_cache(maxsize=4)
def kaldi_mel_banks(num_bins: int, padded_window_size: int, sample_freq: float,
                    low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Kaldi mel banks (n_fft // 2 + 1, num_bins); the Nyquist row is zero
    (Kaldi weighs padded // 2 bins)."""
    if high_freq <= 0.0:
        high_freq = sample_freq / 2 + high_freq
    num_fft_bins = padded_window_size // 2
    fft_bin_width = sample_freq / padded_window_size
    mel_low = _mel(low_freq)
    mel_high = _mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    mel = _mel(fft_bin_width * np.arange(num_fft_bins))[None, :]
    left = mel_low + np.arange(num_bins)[:, None] * mel_delta
    center = left + mel_delta
    right = center + mel_delta
    up = (mel - left) / mel_delta
    down = (right - mel) / mel_delta
    fb = np.maximum(0.0, np.minimum(up, down))
    out = np.zeros((num_fft_bins + 1, num_bins), np.float32)
    out[:num_fft_bins] = fb.T
    return out


@functools.lru_cache(maxsize=4)
def _dft_mats(padded: int):
    n = np.arange(padded)[:, None]
    k = np.arange(padded // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / padded
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def fbank(wav: torch.Tensor, sample_frequency: int = 16000, num_mel_bins: int = 80,
          frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
          preemphasis: float = 0.97, remove_dc_offset: bool = True) -> torch.Tensor:
    """wav (B, T) float in [-1, 1] -> (B, frames, num_mel_bins) float32."""
    if wav.ndim == 1:
        wav = wav[None]
    win = int(sample_frequency * frame_length_ms / 1000)
    hop = int(sample_frequency * frame_shift_ms / 1000)
    padded = _next_pow2(win)
    x = wav.float()
    frames = x.unfold(-1, win, hop)  # (B, m, win), snip_edges
    if remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis * prev
    dev = x.device
    frames = frames * torch.from_numpy(povey_window(win).astype(np.float32)).to(dev)
    frames = torch.nn.functional.pad(frames, (0, padded - win))
    cos_m, sin_m = (torch.from_numpy(m).to(dev) for m in _dft_mats(padded))
    re = frames @ cos_m
    im = frames @ sin_m
    power = re * re + im * im
    fb = torch.from_numpy(kaldi_mel_banks(num_mel_bins, padded, float(sample_frequency)))
    mel = power @ fb.to(dev)
    return torch.log(torch.clamp(mel, min=sys.float_info.epsilon))
