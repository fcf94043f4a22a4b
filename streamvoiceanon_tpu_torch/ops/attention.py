"""Per-head decode attention: plain version, CUDA kernel wrapper, split plan.

Replaces the TPU kernel `decode_attention` / `decode_attention_prepadded`
(`_kernel`) of the JAX package's ops/pallas_attention.py.  One call per
layer of the dual-AR frame step: for each of the B x H heads of a batch,
write the T new key and value rows at rows pos .. pos+T-1 of the (S, D)
caches IN PLACE and attend each query t over the cache rows <= pos + t.  The caches keep the
true head dim: the JAX package pads it to 128 lanes only for the TPU's
tiles, and those lanes are zeros that no product reads.

Arithmetic, as the TPU kernel: q, k and v arrive in the cache dtype; q is
divided by sqrt(D) in float32 and rounded back to the cache dtype; scores
and the softmax are float32; the weights are normalized before the value
mix; the output is rounded to the cache dtype.

What bounds the kernel on the card: bytes, and at batch 1 the latency of
reaching them.  At the published width (12 heads x 64, T 2, a bf16 cache)
a call at pos 1000 must read 2 x 12 x 1000 x 64 x 2 B = 3.1 MB of old
rows, about 0.9 us at 3.35 TB/s; its 2 x 2 x 2 x 12 x 1000 x 64
operations are negligible.  At batch 8 (96 heads) and pos 1600 it reads
39.3 MB, 11.7 us.  A first design ran one block a head: 12 blocks on 132
SMs, each walking its 1000 rows as a chain of dependent loads, 0.035 ms.

What the design does about it (csrc/decode_attention.cu): the grid is
(heads, splits).  `split_plan` cuts each head's pos + T rows into splits
of R rows, R a multiple of a block's lane groups: as many splits as one
pass of DA_U rows a lane group needs (128 rows in bf16 at D 64), but no
more than the card holds blocks at once, 3 an SM (8 splits of 128 rows
at 12 heads, pos 1000; 4 of 416 at 96 heads, pos 1600).  A block loads
DA_U rows of both caches a lane group at once (16-byte loads), folds
them into its running max, sum and value sums, and writes one partial a
query to kept scratch; the last block of a head (an atomic ticket) merges
the partials in split order, so the result does not depend on block
timing.  One device launch a call, by programmatic dependent launch; no
allocation or fill but the output.  Measured (NVIDIA H100 80GB HBM3,
700 W; PERF.md): a split of one pass beats a split that fills one wave
of SMs (11 of 96 rows at 12 heads), and more blocks than the card holds
at once lose.  Not yet done: a split of several passes waits on memory once a
pass (no loads of the next pass in flight); the wrapper's host work,
about 28 us a call, exceeds the launch's device time; the kept scratch is
shared by the calls of one geometry on one card, so calls on two streams
must not overlap.

Tolerance, kernel against `decode_attention_plain`: they differ only in
float32 summation order (the plain version, as the TPU kernel, normalizes
the weights before the value mix; the kernel divides the merged value
sums by the merged denominator).  float32 outputs within 1e-4 absolute at
unit-scale inputs; bf16 outputs within one bf16 ulp of the larger of the
two plus 1e-4 (an output near zero is a sum that cancels, where the
float32 difference can exceed its own bf16 spacing); the cache rows
written are equal.

The plain version slices the caches to pos + T rows before the products,
so stale or NaN rows beyond them never reach the value mix.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

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


# must match DA_THREADS and DA_U of csrc/decode_attention.cu
DA_THREADS = 128
DA_U = 8
# blocks of the kernel an SM holds at once: 168 registers a thread (bf16,
# T 2; fewer in float32) x 128 threads of the 65,536 registers an SM has
DA_BLOCKS_PER_SM = 3
H100_SMS = 132


def lane_groups(head_dim: int, cache_dtype) -> int:
    """Rows a block of the kernel reads at once, one a lane group: a row
    is head_dim * itemsize / 16 lanes of one 16-byte load each."""
    return DA_THREADS // (head_dim * cache_dtype.itemsize // 16)


@functools.lru_cache(maxsize=4096)
def split_plan(heads: int, rows: int, head_dim: int, cache_dtype,
               n_sm: int = H100_SMS) -> Tuple[int, int]:
    """(R, nsplit): the kernel's split of a head's `rows` = pos + T rows.
    As many splits as a pass of DA_U rows a lane group covers the rows in,
    but no more than the card holds blocks at once (`max_splits`), R
    rounded up to a multiple of the lane groups; nsplit = ceil(rows / R)."""
    tile = lane_groups(head_dim, cache_dtype)
    want = min(max_splits(heads, n_sm), _cdiv(rows, tile * DA_U))
    R = _cdiv(_cdiv(rows, want), tile) * tile
    return R, _cdiv(rows, R)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def max_splits(heads: int, n_sm: int = H100_SMS) -> int:
    """Splits a head such that all heads' blocks are on the card at once."""
    return max(1, DA_BLOCKS_PER_SM * n_sm // heads)


_KEPT: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def kept_scratch(heads: int, T: int, head_dim: int, cache_dtype, device: torch.device,
                 n_sm: int):
    """(partials, tickets) that the kernel's calls at this geometry on
    `device` share (so calls on two streams must not overlap): per head and
    split, per query, the max, the sum and the head_dim value sums in
    float32; one ticket a head, zeroed once here and left at zero by every
    launch.  A launch writes each partial it reads."""
    if device.type == "cuda" and device.index is None:  # tensors name their card
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device, heads, T, head_dim, cache_dtype)
    if key not in _KEPT:
        n = heads * max_splits(heads, n_sm) * T * (head_dim + 2)
        _KEPT[key] = (torch.empty(n, dtype=torch.float32, device=device),
                      torch.zeros(heads, dtype=torch.int32, device=device))
    return _KEPT[key]


@functools.lru_cache(maxsize=8)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=1)
def _kernel():
    return _build.load("decode_attention")


def decode_attention(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int):
    """The decode attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Same arguments and results as
    `decode_attention_plain`; the heads may be B x H heads of a batch."""
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
    n_sm = sm_count(dev)
    R, nsplit = split_plan(H, pos + T, D, cd, n_sm)
    part, tickets = kept_scratch(H, T, D, cd, dev, n_sm)
    out = torch.empty_like(q)
    rc = _kernel()(
        DTYPE_CODE[cd], q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(), part.data_ptr(),
        tickets.data_ptr(), H, T, S, D, int(pos), R, nsplit, math.sqrt(D),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention: CUDA launch failed with error {rc}")
    decode_attention.launches += 1
    return out, k_cache, v_cache


decode_attention.launches = 0
