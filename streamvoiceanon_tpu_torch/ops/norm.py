"""Normalization layers (functional), as `streamvoiceanon_tpu.ops.norm`.

Both compute in float32 (float64 for float64 input) and cast back to the
input dtype before the weight multiply, so bf16 activations round where
the JAX package rounds.
"""

from __future__ import annotations

import torch


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the port's reductions and softmaxes run in: float32, or
    float64 for float64 input (a float64 reference keeps its precision)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(compute_dtype(x.dtype))
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return y.to(x.dtype) * weight


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(compute_dtype(x.dtype))
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * weight + bias
