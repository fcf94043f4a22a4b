"""Quantizer ops, as `streamvoiceanon_tpu.ops.quantizers`.

* LFQ / BSQ encode — content tokens are the sign pattern of a 13-d
  projection, most significant bit first — the codes of given indices
  (`lfq_indices_to_codes`), the quantized latents of the tokenizer's
  training forward (`lfq_quantize`) and the BSQ soft entropy loss, whose
  codebook usage is averaged over a `torch.distributed` group under data
  parallelism (`lfq_soft_entropy_loss`).
* FSQ encode and decode — the grouped residual finite scalar quantizer of
  the vocoder (8 groups x levels (8, 5, 5, 5) = 8 codebooks of 1000) and
  the speaker encoder's residual FSQ (levels 4^6).
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from streamvoiceanon_tpu_torch.parallel.mesh import all_reduce_mean


def _linear(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """x @ w + b in the promoted dtype of x and the weights, as JAX's
    matmul promotes (float32 activations against bf16 weights)."""
    dt = torch.promote_types(x.dtype, p["w"].dtype)
    y = x.to(dt) @ p["w"].to(dt)
    if p.get("b") is not None:
        y = y + p["b"].to(dt)
    return y


def lfq_encode(params: Dict, x: torch.Tensor, codebook_bits: int) -> torch.Tensor:
    """x (B, T, dim) -> int32 indices (B, T): bit d (MSB first) is 1 iff
    projection dim d is positive."""
    h = _linear(params["project_in"], x).float()
    mask = _on(x.device, "bits", codebook_bits)
    return torch.sum((h > 0).to(torch.int32) * mask, dim=-1, dtype=torch.int32)


def lfq_quantize(params: Dict, x: torch.Tensor,
                 codebook_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval-mode forward: (the sign bits as +-1 / sqrt(bits) through
    project_out (B, T, dim), the indices (B, T) int32).  The sign has no
    straight-through gradient: nothing reaches x through it, as in the JAX
    package."""
    h = _linear(params["project_in"], x).float()
    indices = torch.sum((h > 0).to(torch.int32) * _on(x.device, "bits", codebook_bits),
                        dim=-1, dtype=torch.int32)
    q = torch.where(h > 0, 1.0, -1.0) / float(np.sqrt(np.float32(codebook_bits)))
    return _linear(params["project_out"], q), indices


def lfq_indices_to_codes(params: Dict, indices: torch.Tensor,
                         codebook_bits: int) -> torch.Tensor:
    """indices (B, T) -> codes (B, T, dim): the +-1 bits, l2-normalised,
    through project_out."""
    bits = (indices.to(torch.int32)[..., None] & _on(indices.device, "bits", codebook_bits)) != 0
    codes = bits.float() * 2.0 - 1.0
    codes = codes / float(np.sqrt(np.float32(codebook_bits)))
    return _linear(params["project_out"], codes)


def lfq_soft_entropy_loss(h: torch.Tensor, tau: float = 1.0, gamma: float = 1.0,
                          group=None) -> torch.Tensor:
    """The BSQ soft entropy aux loss of pre-sign latents h (N, L): the mean
    per-sample entropy of each bit minus gamma times the entropy of the
    mean bit usage.

    With a `torch.distributed` process group (data parallelism) the usage
    distribution is averaged over the group's ranks before its entropy
    (`all_reduce`, then / the group's size, as the JAX package's `pmean`
    over `axis_name`), through an autograd-aware reduction; the
    per-sample term stays local, its global mean coming from the gradients'
    average."""
    L = h.shape[-1]
    corners = torch.tensor([-1.0, 1.0], dtype=h.dtype, device=h.device) / float(
        np.sqrt(np.float32(L)))
    prob = torch.sigmoid(2.0 * tau * corners[None, None, :] * h[..., None])
    ent_per_dim = -torch.sum(prob * torch.log(torch.clamp(prob, min=1e-20)), dim=-1)
    term1 = torch.mean(ent_per_dim)
    expected = torch.mean(prob.reshape(-1, L, 2), dim=0)
    expected = all_reduce_mean(expected, group)
    term2 = torch.mean(-torch.sum(expected * torch.log(torch.clamp(expected, min=1e-20)),
                                  dim=-1))
    return term1 - gamma * term2


@functools.lru_cache(maxsize=64)
def _on(device: torch.device, kind: str, *args) -> torch.Tensor:
    """A constant of the quantizers on `device`, copied there once: a copy
    from pageable host memory would make the stream's chunk step wait for
    the device."""
    if kind == "bits":  # LFQ bit weights, MSB first
        a = np.power(2, np.arange(args[0] - 1, -1, -1)).astype(np.int32)
    elif kind == "scale":  # residual FSQ layer i's scale
        a = _rfsq_scales(args[0], args[1])[args[2]]
    else:  # "lv", "basis", "half_width" of FSQ levels
        a = dict(zip(("lv", "basis", "half_width"), _fsq_consts(args[0])))[kind]
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _fsq_consts(levels: Sequence[int]):
    lv = np.asarray(levels, np.int64)
    basis = np.concatenate([[1], np.cumprod(lv[:-1])]).astype(np.int64)
    return lv, basis, lv // 2


def fsq_bound(z: torch.Tensor, levels: Sequence[int], eps: float = 1e-3) -> torch.Tensor:
    lv = torch.tensor(levels, dtype=torch.float32, device=z.device)
    half_l = (lv - 1.0) * (1.0 + eps) / 2.0
    offset = torch.tensor([0.5 if l % 2 == 0 else 0.0 for l in levels],
                          dtype=torch.float32, device=z.device)
    shift = torch.atanh(offset / half_l)
    return torch.tanh(z + shift) * half_l - offset


def fsq_quantize(z: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
    """Round to the grid (half to even), renormalised to [-1, 1]."""
    half_width = torch.from_numpy(_fsq_consts(levels)[2].astype(np.float32)).to(z.device)
    return torch.round(fsq_bound(z.float(), levels)) / half_width


def fsq_codes_to_indices(codes: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
    _, basis, half_width = _fsq_consts(levels)
    hw = torch.from_numpy(half_width.astype(np.float32)).to(codes.device)
    zint = codes * hw + hw
    return torch.sum(zint * torch.from_numpy(basis.astype(np.float32)).to(codes.device),
                     dim=-1).to(torch.int32)


def fsq_indices_to_codes(indices: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
    dev, lv = indices.device, tuple(levels)
    level_idx = torch.remainder(
        torch.div(indices.long()[..., None], _on(dev, "basis", lv), rounding_mode="floor"),
        _on(dev, "lv", lv))
    hw = _on(dev, "half_width", lv).float()
    return (level_idx.float() - hw) / hw


def _rfsq_scales(levels: Sequence[int], num_quantizers: int) -> np.ndarray:
    lv = np.asarray(levels, np.float64)
    return np.stack(
        [(lv - 1.0) ** (-float(i)) for i in range(num_quantizers)]
    ).astype(np.float32)


def residual_fsq_encode(params: Dict, x: torch.Tensor, levels: Sequence[int],
                        num_quantizers: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, dim) -> (quantized (B, T, dim), indices (B, T, Q)): each
    layer quantizes residual / scale_i on the FSQ grid, scales back and
    subtracts."""
    h = _linear(params["project_in"], x) if "project_in" in params else x
    h = h.float()
    scales = _rfsq_scales(levels, num_quantizers)
    residual = h
    out = torch.zeros_like(h)
    idx = []
    for i in range(num_quantizers):
        s = torch.from_numpy(scales[i]).to(h.device)
        codes = fsq_quantize(residual / s, levels)
        idx.append(fsq_codes_to_indices(codes, levels))
        q = codes * s
        residual = residual - q
        out = out + q
    if "project_out" in params:
        out = _linear(params["project_out"], out)
    return out, torch.stack(idx, dim=-1)


def residual_fsq_decode(params: Dict, indices: torch.Tensor, levels: Sequence[int],
                        num_quantizers: int) -> torch.Tensor:
    """indices (B, T, Q) -> (B, T, dim)."""
    total = 0.0
    for i in range(num_quantizers):
        codes = fsq_indices_to_codes(indices[..., i], levels)
        total = total + codes * _on(codes.device, "scale", tuple(levels), num_quantizers, i)
    return _linear(params["project_out"], total) if "project_out" in params else total


def grouped_residual_fsq_decode(params: Dict, indices: torch.Tensor, groups: int,
                                levels: Sequence[int],
                                num_quantizers: int) -> torch.Tensor:
    """indices (B, T, groups * Q) -> (B, T, dim)."""
    per = torch.chunk(indices, groups, dim=-1)
    return torch.cat([
        residual_fsq_decode(params[f"group_{g}"], per[g], levels, num_quantizers)
        for g in range(groups)
    ], dim=-1)


def grouped_residual_fsq_encode(params: Dict, x: torch.Tensor, groups: int,
                                levels: Sequence[int], num_quantizers: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, dim) -> (quantized (B, T, dim), indices (B, T, groups * Q))."""
    outs, idxs = zip(*(residual_fsq_encode(params[f"group_{g}"], chunk, levels,
                                           num_quantizers)
                       for g, chunk in enumerate(torch.chunk(x, groups, dim=-1))))
    return torch.cat(outs, dim=-1), torch.cat(idxs, dim=-1)
