"""Plain PyTorch building blocks of the reference: norms, RoPE, causal convs,
the causal log-mel and centred mel front ends, Kaldi fbank, polyphase
resampling and the quantizers' encode and decode.

Frozen copy of the port's plain paths at commit b084fe3:
`streamvoiceanon_tpu_torch/ops/norm.py`, `ops/rope.py`, `ops/conv.py`
(whole-sequence forms only), `ops/stft.py`, `audio/fbank.py`,
`audio/resample.py`, `ops/quantizers.py` (encode and decode only).
Departures: no streaming states, no device-constant caches, no
distributed reductions; configurations are plain namespaces made from the
configuration file (`ns`); the mel filter bank takes its numbers, not a
config object.
"""

from __future__ import annotations

import functools
import math
import sys
from types import SimpleNamespace
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def ns(d):
    """A configuration dict as nested attribute namespaces, lists as tuples."""
    if isinstance(d, dict):
        return SimpleNamespace(**{k: ns(v) for k, v in d.items()})
    if isinstance(d, list):
        return tuple(ns(v) for v in d)
    return d


# ---------------------------------------------------------------------------
# norms and RoPE
# ---------------------------------------------------------------------------


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def rms_norm(x, weight, eps: float = 1e-5):
    xf = x.to(compute_dtype(x.dtype))
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return y.to(x.dtype) * weight


def layer_norm(x, weight, bias, eps: float = 1e-6):
    xf = x.to(compute_dtype(x.dtype))
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * weight + bias


@functools.lru_cache(maxsize=16)
def freqs_cis(seq_len: int, n_elem: int, base: float = 10000.0) -> np.ndarray:
    """(seq_len, n_elem // 2, 2) [cos, sin], computed in float64 and stored
    through bfloat16, as the published models keep their RoPE cache."""
    freqs = 1.0 / (base ** (np.arange(0, n_elem, 2)[: n_elem // 2].astype(np.float64) / n_elem))
    ang = np.outer(np.arange(seq_len, dtype=np.float64), freqs)
    cache = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(cache).to(torch.bfloat16).float().numpy()


def apply_rope(x, freqs):
    """x (B, T, H, D), freqs (T, D // 2, 2), interleaved pairs."""
    cd = compute_dtype(x.dtype)
    xs = x.to(cd).reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    cos = freqs[None, :, None, :, 0].to(cd)
    sin = freqs[None, :, None, :, 1].to(cd)
    x0, x1 = xs[..., 0], xs[..., 1]
    return torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1).reshape(
        x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# causal convs, channels-last (B, T, C); weights in PyTorch's layouts
# ---------------------------------------------------------------------------


def conv1d(x, w, b=None, *, stride=1, dilation=1, groups=1, pad_left=0):
    xt = x.to(w.dtype).transpose(1, 2)
    if pad_left:
        xt = F.pad(xt, (pad_left, 0))
    return F.conv1d(xt, w, b, stride=stride, dilation=dilation, groups=groups
                    ).transpose(1, 2).to(x.dtype)


def causal_conv1d(x, w, b=None, *, stride=1, dilation=1, groups=1):
    k_eff = (w.shape[-1] - 1) * dilation + 1
    return conv1d(x, w, b, stride=stride, dilation=dilation, groups=groups,
                  pad_left=k_eff - stride)


def fish_trans_conv1d(x, w, b=None, *, stride: int):
    """Causal upsampling transposed conv, output length stride * T."""
    k = w.shape[-1]
    if stride == k // 2:
        x = F.pad(x, (0, 0, 1, 0))
    elif stride == k:
        x = F.pad(x, (0, 0, 1, 1))
    xt = x.to(w.dtype).transpose(1, 2)
    y = F.conv_transpose1d(xt, w, b, stride=stride, padding=stride,
                           output_padding=stride % 2)
    return y.transpose(1, 2).to(x.dtype)


# ---------------------------------------------------------------------------
# spectral front ends
# ---------------------------------------------------------------------------


def _hz_to_mel(freq):
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = math.log(6.4) / 27.0
    return np.where(freq >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep,
                    freq / f_sp)


def _mel_to_hz(mels):
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    mels * f_sp)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                   sample_rate: int) -> np.ndarray:
    """Slaney-scale, slaney-normalised triangles (n_freqs, n_mels)."""
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    f_pts = _mel_to_hz(np.linspace(_hz_to_mel(np.array(f_min)), _hz_to_mel(np.array(f_max)),
                                   n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / f_diff[:-1], slopes[:, 2:] / f_diff[1:]))
    return (fb * (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def dft_matrix(n_fft: int, win_length: int) -> np.ndarray:
    """Periodic-Hann-windowed real DFT, (n_fft, 2 * (n_fft // 2 + 1))."""
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * np.arange(n_fft)[:, None] * k / n_fft
    lpad = (n_fft - win_length) // 2
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length) / win_length))
    win = np.pad(hann, (lpad, n_fft - win_length - lpad))[:, None]
    return np.concatenate([(np.cos(ang) * win).astype(np.float32),
                           (-np.sin(ang) * win).astype(np.float32)], axis=1)


def _fmax(mel) -> float:
    return float(mel.sample_rate // 2) if mel.f_max is None else float(mel.f_max)


def _spectrogram(wav, mel, causal_pad: bool, center: bool, eps: float):
    x = wav.float()
    if causal_pad:
        x = F.pad(x, (mel.win_length - mel.hop_length, 0))
    elif center:
        x = F.pad(x[:, None], (mel.n_fft // 2, mel.n_fft // 2), mode="reflect")[:, 0]
    spec = x.unfold(1, mel.n_fft, mel.hop_length) @ torch.from_numpy(
        dft_matrix(mel.n_fft, mel.win_length)).to(x.device)
    nb = mel.n_fft // 2 + 1
    re, im = spec[..., :nb], spec[..., nb:]
    return torch.sqrt(re * re + im * im + eps)


def _melbank(mel, device):
    return torch.from_numpy(mel_filterbank(mel.n_fft // 2 + 1, float(mel.f_min), _fmax(mel),
                                           mel.n_mels, mel.sample_rate)).to(device)


def log_mel(wav, mel):
    """Causal log-mel (B, T // hop, n_mels): left pad win - hop, no centring."""
    spec = _spectrogram(wav, mel, True, False, 1e-6)
    return torch.log(torch.clamp(spec @ _melbank(mel, spec.device), min=1e-5))


def mel_center(wav, mel):
    """Centred mel with power 1 (the speaker encoder's front end)."""
    spec = _spectrogram(wav, mel, False, True, 0.0)
    return spec @ _melbank(mel, spec.device)


@functools.lru_cache(maxsize=4)
def _kaldi_banks(num_bins: int, padded: int, sample_freq: float) -> np.ndarray:
    mel_of = lambda hz: 1127.0 * np.log(1.0 + np.asarray(hz, np.float64) / 700.0)
    nfb = padded // 2
    lo, hi = mel_of(20.0), mel_of(sample_freq / 2)
    delta = (hi - lo) / (num_bins + 1)
    m = mel_of(sample_freq / padded * np.arange(nfb))[None, :]
    left = lo + np.arange(num_bins)[:, None] * delta
    fb = np.maximum(0.0, np.minimum((m - left) / delta, (left + 2 * delta - m) / delta))
    out = np.zeros((nfb + 1, num_bins), np.float32)
    out[:nfb] = fb.T
    return out


def fbank(wav, sample_frequency: int = 16000, num_mel_bins: int = 80):
    """Kaldi fbank (25 ms Povey frames every 10 ms, DC removal, pre-emphasis
    0.97, 512-point power spectrum, natural log): (B, frames, 80)."""
    win, hop = sample_frequency * 25 // 1000, sample_frequency * 10 // 1000
    padded = 1 << (win - 1).bit_length()
    frames = wav.float().unfold(-1, win, hop)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    frames = frames - 0.97 * torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    i = np.arange(win)
    povey = ((0.5 - 0.5 * np.cos(2 * np.pi * i / (win - 1))) ** 0.85).astype(np.float32)
    frames = F.pad(frames * torch.from_numpy(povey).to(wav.device), (0, padded - win))
    ang = 2.0 * np.pi * np.arange(padded)[:, None] * np.arange(padded // 2 + 1)[None, :] / padded
    re = frames @ torch.from_numpy(np.cos(ang).astype(np.float32)).to(wav.device)
    im = frames @ torch.from_numpy((-np.sin(ang)).astype(np.float32)).to(wav.device)
    mel = (re * re + im * im) @ torch.from_numpy(
        _kaldi_banks(num_mel_bins, padded, float(sample_frequency))).to(wav.device)
    return torch.log(torch.clamp(mel, min=sys.float_info.epsilon))


@functools.lru_cache(maxsize=8)
def _resample_kernel(orig: int, new: int, width_taps: int = 6, rolloff: float = 0.99):
    g = math.gcd(orig, new)
    up, down = new // g, orig // g
    base = min(down, up) * rolloff
    width = int(np.ceil(width_taps * down / base))
    idx = np.arange(-width, width + down, dtype=np.float64)[None] / down
    t = np.clip((np.arange(0, -up, -1, dtype=np.float64)[:, None] / up + idx) * base,
                -width_taps, width_taps)
    window = np.cos(t * np.pi / width_taps / 2) ** 2
    t = t * np.pi
    kern = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t)) * window * base / down
    return kern.astype(np.float32)[:, None, :], width, up, down


def resample(wav, orig: int, new: int):
    """Windowed-sinc polyphase resampling (Hann window, 6 zero crossings,
    rolloff 0.99): (B, T) -> (B, ceil(T * new / orig))."""
    if orig == new:
        return wav
    kern, width, up, down = _resample_kernel(orig, new)
    T = wav.shape[1]
    x = F.pad(wav.float(), (width, width + down))[:, None]
    y = F.conv1d(x, torch.from_numpy(kern).to(x.device), stride=down)
    return y.transpose(1, 2).reshape(y.shape[0], -1)[:, : int(np.ceil(T * up / down))]


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


def linear(p: Dict, x):
    dt = torch.promote_types(x.dtype, p["w"].dtype)
    y = x.to(dt) @ p["w"].to(dt)
    return y + p["b"].to(dt) if p.get("b") is not None else y


def lfq_encode(p: Dict, x, bits: int):
    """Sign bits of the projection, most significant first."""
    h = linear(p["project_in"], x).float()
    w = torch.from_numpy(np.power(2, np.arange(bits - 1, -1, -1)).astype(np.int32)).to(x.device)
    return torch.sum((h > 0).to(torch.int32) * w, dim=-1, dtype=torch.int32)


def lfq_margin(p: Dict, x):
    """The smallest |projection| of each latent: how near its token is to a
    bit flip (B, T)."""
    return linear(p["project_in"], x).float().abs().amin(dim=-1)


def _fsq_consts(levels: Sequence[int]):
    lv = np.asarray(levels, np.int64)
    return lv, np.concatenate([[1], np.cumprod(lv[:-1])]).astype(np.int64), lv // 2


def _fsq_bound(z, levels, eps: float = 1e-3):
    lv = torch.tensor(levels, dtype=torch.float32, device=z.device)
    half_l = (lv - 1.0) * (1.0 + eps) / 2.0
    offset = torch.tensor([0.5 if l % 2 == 0 else 0.0 for l in levels], dtype=torch.float32,
                          device=z.device)
    return torch.tanh(z + torch.atanh(offset / half_l)) * half_l - offset


def _rfsq_scales(levels, num_quantizers):
    lv = np.asarray(levels, np.float64)
    return np.stack([(lv - 1.0) ** (-float(i)) for i in range(num_quantizers)]).astype(np.float32)


def residual_fsq_encode(p: Dict, x, levels, num_quantizers: int) -> Tuple:
    """(quantized (B, T, dim), indices (B, T, Q))."""
    h = (linear(p["project_in"], x) if "project_in" in p else x).float()
    _, basis, hw = _fsq_consts(levels)
    hw_t = torch.from_numpy(hw.astype(np.float32)).to(h.device)
    basis_t = torch.from_numpy(basis.astype(np.float32)).to(h.device)
    residual, out, idx = h, torch.zeros_like(h), []
    for s in _rfsq_scales(levels, num_quantizers):
        s = torch.from_numpy(s).to(h.device)
        codes = torch.round(_fsq_bound(residual / s, levels)) / hw_t
        idx.append(torch.sum((codes * hw_t + hw_t) * basis_t, dim=-1).to(torch.int32))
        residual = residual - codes * s
        out = out + codes * s
    if "project_out" in p:
        out = linear(p["project_out"], out)
    return out, torch.stack(idx, dim=-1)


def residual_fsq_decode(p: Dict, indices, levels, num_quantizers: int):
    lv, basis, hw = _fsq_consts(levels)
    dev = indices.device
    total = 0.0
    for i, s in enumerate(_rfsq_scales(levels, num_quantizers)):
        lvl = torch.remainder(torch.div(indices[..., i].long()[..., None],
                                        torch.from_numpy(basis).to(dev), rounding_mode="floor"),
                              torch.from_numpy(lv).to(dev))
        hwt = torch.from_numpy(hw).to(dev).float()
        total = total + (lvl.float() - hwt) / hwt * torch.from_numpy(s).to(dev)
    return linear(p["project_out"], total) if "project_out" in p else total


def grouped_fsq_encode(p: Dict, x, groups: int, levels, nq: int):
    outs, idxs = zip(*(residual_fsq_encode(p[f"group_{g}"], c, levels, nq)
                       for g, c in enumerate(torch.chunk(x, groups, dim=-1))))
    return torch.cat(outs, dim=-1), torch.cat(idxs, dim=-1)


def grouped_fsq_decode(p: Dict, indices, groups: int, levels, nq: int):
    per = torch.chunk(indices, groups, dim=-1)
    return torch.cat([residual_fsq_decode(p[f"group_{g}"], per[g], levels, nq)
                      for g in range(groups)], dim=-1)


def bits_of(codebook_size: int) -> int:
    return int(round(math.log2(codebook_size)))


def no_tf32():
    """Float32 matrix products and convolutions in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
