"""Rotary position embeddings on interleaved (even, odd) feature pairs.

As `streamvoiceanon_tpu.ops.rope`: the cos/sin table is computed in float64,
stored through bfloat16 (the reference keeps its cache in bf16) and applied
in float32 (float64 for float64 input).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from streamvoiceanon_tpu_torch.ops.norm import compute_dtype


@functools.lru_cache(maxsize=16)
def precompute_freqs_cis(seq_len: int, n_elem: int, base: float = 10000.0,
                         bf16_quantize: bool = True) -> np.ndarray:
    """(seq_len, n_elem // 2, 2) float32 [cos, sin] table."""
    freqs = 1.0 / (
        base ** (np.arange(0, n_elem, 2)[: n_elem // 2].astype(np.float64) / n_elem)
    )
    t = np.arange(seq_len, dtype=np.float64)
    ang = np.outer(t, freqs)
    cache = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    if bf16_quantize:
        cache = torch.from_numpy(cache).to(torch.bfloat16).float().numpy()
    return cache


def apply_rope(x: torch.Tensor, freqs_cis: torch.Tensor) -> torch.Tensor:
    """x: (B, T, H, D); freqs_cis: (T, D//2, 2).  Float32 math (float64 for
    float64 x), cast back."""
    cd = compute_dtype(x.dtype)
    xs = x.to(cd).reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    cos = freqs_cis[None, :, None, :, 0].to(cd)
    sin = freqs_cis[None, :, None, :, 1].to(cd)
    x0, x1 = xs[..., 0], xs[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
