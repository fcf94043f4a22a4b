"""Per-head decode attention: plain version, CUDA kernel wrapper.

Replaces the TPU kernel `decode_attention` / `decode_attention_prepadded`
(`_kernel`) of the JAX package's ops/pallas_attention.py.  One call per
layer of the dual-AR frame step: for each of the H heads, write the T new
key and value rows at rows pos .. pos+T-1 of the (S, D) caches IN PLACE and
attend each query t over the cache rows <= pos + t.  The caches keep the
true head dim: the JAX package pads it to 128 lanes only for the TPU's
tiles, and those lanes are zeros that no product reads.

Arithmetic, as the TPU kernel: q, k and v arrive in the cache dtype; q is
divided by sqrt(D) in float32 and rounded back to the cache dtype; scores
and the softmax are float32; the weights are normalized before the value
mix; the output is rounded to the cache dtype.

What bounds the kernel on the card: bytes.  At the published width (H 12,
D 64, T 2, a bf16 cache) a call at pos 1000 must read 2 x 12 x 1000 x 64 x
2 B = 3.1 MB of old rows, about 0.9 us at 3.35 TB/s; its 2 x 2 x 2 x 12 x
1000 x 64 operations are negligible.

What this first design does about it (csrc/decode_attention.cu): one block
per head reads only the rows < pos + T (the TPU kernel reads and writes
back the whole (S, D) block, a VMEM artefact), 16-byte loads with 4 rows
in flight per lane group, the scores of a head in shared memory between
the score and value passes.  Not yet done: 12 blocks leave most of the 132
SMs idle; a split over row tiles with a combining pass would fill them.

The plain version slices the caches to pos + T rows before the products,
so stale or NaN rows beyond them never reach the value mix.
"""

from __future__ import annotations

import numpy as np
import torch

from streamvoiceanon_tpu_torch.ops import _build
from streamvoiceanon_tpu_torch.ops.decode_common import DTYPE_CODE, check_cuda


def decode_attention_plain(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                           k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int):
    """q, k_new, v_new (H, T, D); caches (H, S, D), updated in place.
    Returns (out (H, T, D) in the cache dtype, k_cache, v_cache)."""
    H, T, D = q.shape
    cd = k_cache.dtype
    qs = (q.to(cd).float() / float(np.sqrt(D))).to(cd)
    k_cache[:, pos : pos + T] = k_new.to(cd)
    v_cache[:, pos : pos + T] = v_new.to(cd)
    P = pos + T
    scores = qs.float() @ k_cache[:, :P].float().transpose(1, 2)  # (H, T, P)
    col = torch.arange(P, device=q.device)
    mask = col[None, :] <= (pos + torch.arange(T, device=q.device))[:, None]
    w = torch.softmax(torch.where(mask, scores, float("-inf")), dim=-1)
    out = (w @ v_cache[:, :P].float()).to(cd)
    return out, k_cache, v_cache


def decode_attention(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int):
    """The decode attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Same arguments and results as
    `decode_attention_plain`."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_new, v_new, k_cache, v_cache, pos)
    cd = k_cache.dtype
    if cd not in DTYPE_CODE:
        raise ValueError(f"decode_attention: unsupported cache dtype {cd}")
    q, k_new, v_new = (t.to(cd).contiguous() for t in (q, k_new, v_new))
    H, T, D = q.shape
    S = k_cache.shape[1]
    lanes = D * k_cache.element_size() / 16
    if (k_new.shape != q.shape or v_new.shape != q.shape or T not in (1, 2)
            or lanes not in (2, 4, 8, 16, 32)):
        raise ValueError(f"decode_attention: unsupported geometry q {tuple(q.shape)}, "
                         f"new rows {tuple(k_new.shape)} (T 1 or 2, D * itemsize in "
                         "32 .. 512 bytes, a power of two)")
    if k_cache.shape != (H, S, D) or v_cache.shape != (H, S, D) or not 0 <= pos <= S - T:
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} and pos {pos} against q {tuple(q.shape)}")
    named = {"q": q, "k_new": k_new, "v_new": v_new, "k_cache": k_cache, "v_cache": v_cache}
    dev = check_cuda("decode_attention", named, cd)
    if any(t.data_ptr() % 16 for t in named.values()):
        raise ValueError("decode_attention: tensors must be 16-byte aligned")
    out = torch.empty_like(q)
    rc = _build.load("decode_attention")(
        DTYPE_CODE[cd], q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(), H, T, S, D, int(pos),
        float(np.sqrt(D)), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention: CUDA launch failed with error {rc}")
    decode_attention.launches += 1
    return out, k_cache, v_cache


decode_attention.launches = 0
