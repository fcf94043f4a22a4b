"""Polyphase sinc resampling, as the JAX package's audio/resample.py
(torchaudio's `resample` with sinc_interp_hann, lowpass_filter_width 6,
rolloff 0.99): the 44.1 kHz -> 16 kHz speaker branch.  The windowed-sinc
kernel is built once in numpy and applied as one strided conv1d."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
            rolloff: float = 0.99):
    """(kernel (up, 1, K) float32, width, up, down) of the polyphase conv."""
    gcd = math.gcd(orig_freq, new_freq)
    up = new_freq // gcd
    down = orig_freq // gcd
    base_freq = min(down, up) * rolloff
    width = int(np.ceil(lowpass_filter_width * down / base_freq))
    idx = np.arange(-width, width + down, dtype=np.float64)[None] / down
    t = np.arange(0, -up, -1, dtype=np.float64)[:, None] / up + idx
    t = np.clip(t * base_freq, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * base_freq / down  # (up, K)
    return kernel.astype(np.float32)[:, None, :], width, up, down


def resample(wav: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """wav (B, T) -> (B, ceil(T * new / orig)) float32."""
    if orig_freq == new_freq:
        return wav
    if wav.ndim == 1:
        wav = wav[None]
    kern, width, up, down = _kernel(orig_freq, new_freq)
    T = wav.shape[1]
    target_len = int(np.ceil(T * up / down))
    x = F.pad(wav.float(), (width, width + down))[:, None]  # (B, 1, T + pad)
    w = torch.from_numpy(kern).to(x.device)
    y = F.conv1d(x, w, stride=down)  # (B, up, frames)
    return y.transpose(1, 2).reshape(y.shape[0], -1)[:, :target_len]
