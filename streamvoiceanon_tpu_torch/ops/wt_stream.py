"""The windowed-transformer ring step: plain versions, CUDA kernel wrapper.

Replaces the TPU kernel `wt_stream_step` (`_wt_step_kernel`) of the JAX
package's ops/pallas_wt_stream.py.  The content tokenizer's window-limited
transformer runs one new token per chunk through its L layers against a
W-slot KV ring.  Keys are stored roped at an ABSOLUTE position and written
circularly (slot = count mod W), so the ring is read-only apart from one
fresh row per layer:

* key and query positions are `p(t) = W + (t mod R)` with `R = table_rows -
  W`; RoPE scores depend only on position differences;
* every R tokens (`count % R == 0`, count > 0) `maybe_rebase_ring` rotates
  every stored key by -R positions, BEFORE the step, so in-window
  distances stay exact and the stream runs forever;
* attention covers the written slots `< min(count, W)` except the current
  slot (its stale row is never read) plus the fresh row, under one max and
  one denominator (slot order needs no unshuffling: softmax is
  permutation-invariant).

The ring is flat, (L, B, W, n_head*head_dim).  Batch 1 runs the kernel;
`circular_stream_step` is the batched form with the same semantics.  Both
write the fresh K/V rows into the ring IN PLACE at the current slot and
return it: the stream state owns its ring.

What bounds the kernel on the card: bytes.  At float32 (the main path) one
step reads 109 MB of layer weights (8 x 13.6 MB) and up to 17 MB of ring
(8 layers x 2 x 512 x 512 x 4 B), against 3.35 TB/s; one row per weight
makes its operations negligible.

What this first design does about it (csrc/wt_stream.cu on
csrc/decode_common.cuh): per layer, four split-K matrix-vector launches
(every weight byte read once, hundreds of blocks in flight, RMSNorm fused
into the QKV and SwiGLU launches, the LayerScale residual fused into the wo
and w2 epilogues) and one ring-attention launch, one block per head, which
reads only the valid slots and writes the fresh rows in place.  Not yet
done: the 40 launches in sequence pay launch latency comparable to the
weight stream, and 8 attention blocks leave most SMs idle.

The plain version repeats the TPU kernel's arithmetic and rounding points
(q and k roped in float32 and rounded to the weight dtype; score products
taken in the ring dtype and summed in float32; old and fresh rows under one
max and one denominator) and is the CPU path and the kernel's oracle.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from streamvoiceanon_tpu_torch.ops import _build
from streamvoiceanon_tpu_torch.ops.decode_common import (
    DTYPE_CODE, check_cuda, dot, matvec_scratch)
from streamvoiceanon_tpu_torch.ops.norm import rms_norm

# rope-table rows: positions live in [W, TABLE); the ring is re-based every
# TABLE - W tokens
TABLE = 4096


def partner(x: torch.Tensor) -> torch.Tensor:
    """Rotate-partner on the last axis: out[2i] = x[2i+1], out[2i+1] = x[2i]."""
    return x.reshape(*x.shape[:-1], -1, 2).flip(-1).reshape(x.shape)


@functools.lru_cache(maxsize=8)
def signed_tables(n_rows: int, head_dim: int, n_head: int,
                  rope_base: float) -> Tuple[np.ndarray, np.ndarray]:
    """(n_rows, dim) float32 cos/sin rows, pair-expanded and head-tiled; the
    sin row carries the rotate-partner sign (negative on even lanes), so
    rope(x, p) = x * cos[p] + partner(x) * sin[p]."""
    freqs = 1.0 / (
        rope_base ** (np.arange(0, head_dim, 2)[: head_dim // 2] / head_dim)
    )
    ang = np.arange(n_rows)[:, None] * freqs[None, :]
    sign = np.tile(np.array([-1.0, 1.0]), head_dim // 2)
    cos = np.tile(np.repeat(np.cos(ang), 2, axis=-1), (1, n_head))
    sin = np.tile(np.repeat(np.sin(ang), 2, axis=-1) * sign[None, :head_dim],
                  (1, n_head))
    return cos.astype(np.float32), sin.astype(np.float32)


@functools.lru_cache(maxsize=16)
def table_tensors(n_rows: int, head_dim: int, n_head: int, rope_base: float,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """`signed_tables` as tensors on `device`, made once per device."""
    cos, sin = signed_tables(n_rows, head_dim, n_head, rope_base)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def rope_rows(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Apply rope rows (broadcast over leading axes) in float32, keep x's dtype."""
    xf = x.float()
    return (xf * cos + partner(xf) * sin).to(x.dtype)


def maybe_rebase_ring(k_ring: torch.Tensor, count: int, *, head_dim: int, n_head: int,
                      rope_base: float = 10000.0, table_rows: int = TABLE) -> torch.Tensor:
    """Every R tokens (count % R == 0, count > 0) rotate every stored key
    (..., W, dim) by -R positions; else return the ring as it is.  `count`
    is the host's token counter, so no device read is needed."""
    W = k_ring.shape[-2]
    R = table_rows - W
    if count % R or count <= 0:
        return k_ring
    cos, sin = table_tensors(table_rows, head_dim, n_head, rope_base, k_ring.device)
    # rotation by -R: the conjugate of row R
    return rope_rows(k_ring, cos[R], -sin[R])


def _old_valid(count: int, W: int, device) -> torch.Tensor:
    """Slots written before this token, without the current slot."""
    srow = torch.arange(W, device=device)
    return (srow < min(count, W)) & (srow != count % W)


def circular_stream_step(layers: Dict, x: torch.Tensor, k_ring: torch.Tensor,
                         v_ring: torch.Tensor, count: int, *, n_head: int,
                         head_dim: int, rope_base: float = 10000.0,
                         norm_eps: float = 1e-5, table_rows: int = TABLE):
    """The batched form, as `circular_stream_step_xla` of the JAX package:
    x (B, 1, dim), rings (L, B, W, dim) -> (h (B, 1, dim), k_ring, v_ring),
    the fresh rows written in place at slot count % W.  The caller applies
    `maybe_rebase_ring` first."""
    L, B, W, dim = k_ring.shape
    R = table_rows - W
    cos, sin = table_tensors(table_rows, head_dim, n_head, rope_base, x.device)
    p = W + count % R
    cosq, sinq = cos[p], sin[p]
    slot = count % W
    valid = _old_valid(count, W, x.device)
    valid[slot] = True  # the fresh key attends
    h = x
    for l in range(L):
        hn = rms_norm(h, layers["attention_norm"]["w"][l], norm_eps)
        q, k, v = torch.chunk(hn @ layers["wqkv"]["w"][l], 3, dim=-1)
        qr = rope_rows(q[:, 0], cosq, sinq)
        kn = rope_rows(k[:, 0], cosq, sinq)
        k_ring[l, :, slot] = kn.to(k_ring.dtype)
        v_ring[l, :, slot] = v[:, 0].to(v_ring.dtype)
        kh = k_ring[l].reshape(B, W, n_head, head_dim).transpose(1, 2)
        vh = v_ring[l].reshape(B, W, n_head, head_dim).transpose(1, 2)
        qh = qr.reshape(B, n_head, 1, head_dim)
        scores = (qh.float() @ kh.to(h.dtype).float().transpose(-1, -2)) / np.sqrt(head_dim)
        scores = torch.where(valid, scores, float("-inf"))
        w = torch.softmax(scores, dim=-1).to(h.dtype)
        out = (w @ vh.to(h.dtype)).transpose(1, 2).reshape(B, 1, n_head * head_dim)
        h = h + layers["attn_scale"][l] * (out @ layers["wo"]["w"][l])
        f = rms_norm(h, layers["ffn_norm"]["w"][l], norm_eps)
        f = (F.silu(f @ layers["w1"]["w"][l]) * (f @ layers["w3"]["w"][l])) @ layers["w2"]["w"][l]
        h = h + layers["ffn_scale"][l] * f
    return h, k_ring, v_ring


def wt_stream_step_plain(layers: Dict, x1: torch.Tensor, k_ring: torch.Tensor,
                         v_ring: torch.Tensor, count: int, *, n_head: int,
                         head_dim: int, rope_base: float = 10000.0,
                         norm_eps: float = 1e-5, table_rows: int = TABLE):
    """x1 (1, dim), rings (L, W, dim) -> (x_out (1, dim), k_ring, v_ring),
    the final norm not applied and the fresh rows written in place at slot
    count % W.  The caller applies `maybe_rebase_ring` first."""
    wd = layers["wqkv"]["w"].dtype
    rd = k_ring.dtype
    L, dim, _ = layers["wqkv"]["w"].shape
    W = k_ring.shape[1]
    H, hd = n_head, head_dim
    cos, sin = table_tensors(table_rows, hd, H, rope_base, x1.device)
    p = W + count % (table_rows - W)
    cosq, sinq = cos[p : p + 1], sin[p : p + 1]
    slot = count % W
    valid = _old_valid(count, W, x1.device)[:, None]  # (W, 1)
    inv_scale = 1.0 / np.sqrt(hd)
    h = x1.to(wd)
    for l in range(L):
        qkv = dot(rms_norm(h, layers["attention_norm"]["w"][l].to(wd), norm_eps),
                  layers["wqkv"]["w"][l])
        q32, k32 = qkv[:, :dim].float(), qkv[:, dim : 2 * dim].float()
        qr = (q32 * cosq + partner(q32) * sinq).to(wd)
        kr = (k32 * cosq + partner(k32) * sinq).to(wd)
        v_new = qkv[:, 2 * dim :]
        # products in the ring dtype, head sums in float32
        qt = qr.to(rd)
        s_old = (k_ring[l] * qt).float().reshape(W, H, hd).sum(-1) * inv_scale
        s_old = torch.where(valid, s_old, float("-inf"))
        s_new = (kr.to(rd) * qt).float().reshape(1, H, hd).sum(-1) * inv_scale
        m = torch.maximum(torch.amax(s_old, dim=0, keepdim=True), s_new)
        eo = torch.where(valid, torch.exp(s_old - m), 0.0)  # (W, H)
        en = torch.exp(s_new - m)  # (1, H)
        denom = torch.sum(eo, dim=0) + en[0]
        attn = torch.einsum("wh,whd->hd", eo, v_ring[l].float().reshape(W, H, hd))
        attn = attn + en[0][:, None] * v_new.float().reshape(H, hd)
        attn = (attn / denom[:, None]).reshape(1, dim).to(wd)
        ascale = layers["attn_scale"][l].to(wd)
        h = h + ascale * dot(attn, layers["wo"]["w"][l])
        fn = rms_norm(h, layers["ffn_norm"]["w"][l].to(wd), norm_eps)
        a = dot(fn, layers["w1"]["w"][l]).float()
        gate = (a / (1.0 + torch.exp(-a))).to(wd) * dot(fn, layers["w3"]["w"][l])
        h = h + layers["ffn_scale"][l].to(wd) * dot(gate, layers["w2"]["w"][l])
        k_ring[l, slot] = kr[0].to(rd)
        v_ring[l, slot] = v_new[0].to(rd)
    return h, k_ring, v_ring


def wt_stream_step(layers: Dict, x1: torch.Tensor, k_ring: torch.Tensor,
                   v_ring: torch.Tensor, count: int, *, n_head: int, head_dim: int,
                   rope_base: float = 10000.0, norm_eps: float = 1e-5,
                   table_rows: int = TABLE):
    """The ring step: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  Same arguments and results as `wt_stream_step_plain`."""
    kw = dict(n_head=n_head, head_dim=head_dim, rope_base=rope_base,
              norm_eps=norm_eps, table_rows=table_rows)
    if x1.device.type == "cpu":
        return wt_stream_step_plain(layers, x1, k_ring, v_ring, count, **kw)
    w = {k: layers[k]["w"] for k in ("wqkv", "wo", "w1", "w3", "w2",
                                     "attention_norm", "ffn_norm")}
    wd = w["wqkv"].dtype
    rd = k_ring.dtype
    if wd not in DTYPE_CODE or rd not in DTYPE_CODE:
        raise ValueError(f"wt_stream_step: unsupported dtypes {wd}, {rd}")
    w["attn_scale"] = layers["attn_scale"].to(wd)
    w["ffn_scale"] = layers["ffn_scale"].to(wd)
    L, dim, three = w["wqkv"].shape
    inter = w["w1"].shape[-1]
    W = k_ring.shape[1]
    if (three != 3 * dim or n_head * head_dim != dim or head_dim % 2
            or head_dim > 128 or dim % 8 or inter % 8):
        raise ValueError("wt_stream_step: unsupported geometry "
                         f"(dim={dim}, heads={n_head}x{head_dim}, inter={inter})")
    if k_ring.shape != (L, W, dim) or v_ring.shape != (L, W, dim):
        raise ValueError(f"wt_stream_step: rings must be (L, W, dim), got "
                         f"{tuple(k_ring.shape)} and {tuple(v_ring.shape)}")
    if not 0 < W <= table_rows - W or count < 0:
        raise ValueError(f"wt_stream_step: window {W}, table {table_rows}, count {count}")
    if x1.shape != (1, dim):
        raise ValueError(f"wt_stream_step: x1 must be (1, {dim})")
    dev = check_cuda("wt_stream_step", w, wd)
    check_cuda("wt_stream_step", {"k_ring": k_ring, "v_ring": v_ring, "wqkv": w["wqkv"]})
    check_cuda("wt_stream_step", {"k_ring": k_ring, "v_ring": v_ring}, rd)
    cos, sin = table_tensors(table_rows, head_dim, n_head, rope_base, dev)
    p = W + count % (table_rows - W)

    h = x1.to(device=dev, dtype=wd).contiguous().clone()
    qkv = torch.empty((1, 3 * dim), dtype=wd, device=dev)
    attn = torch.empty((1, dim), dtype=wd, device=dev)
    gate = torch.empty((1, inter), dtype=wd, device=dev)
    partials, counters = matvec_scratch(
        1, [(dim, 3 * dim, 1), (dim, dim, 1), (dim, inter, 2), (inter, dim, 1)], dev)
    ptr = lambda t: t.data_ptr()
    rc = _build.load("wt_stream")(
        DTYPE_CODE[wd], DTYPE_CODE[rd], ptr(h), ptr(w["wqkv"]), ptr(w["wo"]),
        ptr(w["w1"]), ptr(w["w3"]), ptr(w["w2"]), ptr(w["attention_norm"]),
        ptr(w["ffn_norm"]), ptr(w["attn_scale"]), ptr(w["ffn_scale"]), ptr(k_ring),
        ptr(v_ring), ptr(cos), ptr(sin), int(p), int(count), ptr(qkv), ptr(attn),
        ptr(gate), ptr(partials), ptr(counters), L, dim, n_head, head_dim, inter, W,
        float(norm_eps), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wt_stream_step: CUDA launch failed with error {rc}")
    wt_stream_step.launches += 1
    return h, k_ring, v_ring


wt_stream_step.launches = 0
