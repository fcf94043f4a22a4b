"""Host-side wav I/O on scipy, as the JAX package's audio/io.py; resampling
through the port's own `audio/resample.py` on the CPU."""

from __future__ import annotations

import numpy as np
import torch
from scipy.io import wavfile

from streamvoiceanon_tpu_torch.audio import resample as _resample


def read_wav(path: str, target_sr: int | None = None,
             mono: bool = True) -> tuple[np.ndarray, int]:
    """(wav float32 in [-1, 1] of shape (T,), sample rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if mono and wav.ndim == 2:
        wav = wav.mean(axis=1)
    if target_sr is not None and sr != target_sr:
        wav = _resample.resample(torch.from_numpy(wav)[None], sr, target_sr)[0].numpy()
        sr = target_sr
    return wav, sr


def write_wav(path: str, wav: np.ndarray, sr: int) -> None:
    wav = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
    wavfile.write(path, sr, (wav * 32767.0).astype(np.int16))
