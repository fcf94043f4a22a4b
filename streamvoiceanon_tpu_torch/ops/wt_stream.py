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

What bounds the kernel on the card: bytes and latency.  At float32 (the
main path) one step reads 109 MB of layer weights (8 x 13.6 MB, above the
50 MB L2) and up to 17 MB of ring (8 layers x 2 x 512 x 512 x 4 B),
37.6 us at 3.35 TB/s; one row per weight makes its operations negligible.
The layers' 40 matrix-vector products and attentions depend on each other
in sequence, and each moves 1 to 6.3 MB, so a design of one launch each
pays a launch and a drain per step of work.

The design (csrc/wt_stream.cu): one cooperative launch a token, one block
per SM (`wt_stream_step.launches` counts one a call).  The TPU kernel's
program order becomes grid barriers, five phases a layer and 5 L - 1
barriers a call (39 at 8 layers):

    A  RMSNorm(h), qkv; q and k roped and rounded; fresh k, v into the ring
    B  attention items (head, split of the old slots), dealt round robin
    C  merge of B's items in split order plus the fresh row; wo + residual
    D  RMSNorm(h), w1 and w3 with the SwiGLU gate
    E  w2 + residual

Each block owns fixed runs of 16-byte column units of every matvec phase
(`work_plan`, the rule of `column_plan` in ops/decode_common.py) and sums
each column over the whole K in a fixed order, over weights packed once
per tensor (`packed`): no split-K partials, no tickets, and the result does
not depend on block timing.  A unit holds whole RoPE pairs, and the w1 and
w3 columns of a unit share a block.  The attention is split across the
grid (`attention_splits`: 8 heads x 16 splits of 32 slots = 128 items at
W = 512); an item keeps its max, its sum of exp and its unnormalised value
sums, and every block that owns wo columns merges all items of every head
in split order, the fresh row's term last, then divides by the
denominator, so phase C is deterministic.  An item with no valid slot
writes max -inf and sum 0, which the merge skips.  The barriers guard:
A -> B the query and fresh key; B -> C the partials, and A's reads of h
before C writes it; C -> D and E -> A the whole h; D -> E the gate, and D's
reads of h before E writes it.  The old ring rows B reads and the weights
are not written during a call (the fresh rows go to the current slot,
which B skips).  The scratch (`kept_scratch`: qkv, gate, the partials)
and the packed weights are kept across calls; the output row is new each
call and the input row is only read, so a call is one device launch.
`wt_stream_step_timeline` stamps each block's entry to and exit from each
phase with the card's global timer.

Not done: each phase loads its weights and ring rows after the barrier
before it (plain 16-byte loads; other blocks' data through L2).  Bulk
copies (TMA) of the next phase's weights and rows into shared memory,
issued one phase ahead or just before the barrier, made the call slower on
the H100, and loads into registers issued before the barrier no faster,
since the barrier's release and acquire wait for them (PERF.md §6).  A
phase now costs about 2.6 to 4.1 us and a barrier about 1 us.

The plain version repeats the TPU kernel's arithmetic and rounding points
(q and k roped in float32 and rounded to the weight dtype; score products
taken in the ring dtype and summed in float32; old and fresh rows under one
max and one denominator) and is the CPU path and the kernel's oracle.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from streamvoiceanon_tpu_torch.ops import _build
from streamvoiceanon_tpu_torch.ops.decode_common import (
    COOPERATIVE_TOO_LARGE, DTYPE_CODE, MAX_SMEM, barrier_count, check_cuda, column_plan,
    dot, packed, unit_cols)
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


# the kernel's plan (csrc/wt_stream.cu)
PHASES = ("qkv", "wo", "w13", "w2")  # the plan's columns; w13: a w1 and a w3 slice a unit
MAX_SPLITS = 16  # attention splits a head
PART = 4  # an item's partial: max, sum of exp, fresh score (split 0), 0, then value sums
THREADS = 512  # PK_THREADS (csrc/decode_common.cuh)
MAX_ROW = 2560  # PK_ROW * PK_THREADS: dim and inter
MAX_HEAD_DIM = 128  # RS_MAXD


def phases(L: int) -> List[Tuple[int, str]]:
    """The kernel's phases in order, (layer, "A".."E"); a grid barrier
    between each two."""
    return [(l, k) for l in range(L) for k in "ABCDE"]


def phase_units(dim: int, inter: int, dtype) -> Tuple[int, ...]:
    """Units of each phase of PHASES (w13: one unit is a w1 and a w3 slice)."""
    u = unit_cols(dtype)
    return (3 * dim // u, dim // u, inter // u, dim // u)


def unit_bytes(dim: int, inter: int) -> Tuple[int, ...]:
    """Weight bytes of one unit of each phase in one layer."""
    return (dim * 16, dim * 16, 2 * dim * 16, inter * 16)


@functools.lru_cache(maxsize=16)
def work_plan(dim: int, inter: int, n_blocks: int, dtype) -> np.ndarray:
    """(n_blocks, 4, 2) int32: per block and phase of PHASES, the first unit
    it owns and how many, a contiguous run.  The same for every layer."""
    return column_plan(phase_units(dim, inter, dtype), unit_bytes(dim, inter), n_blocks)


def attention_splits(W: int) -> Tuple[int, int]:
    """(splits a head, slots a split): at most MAX_SPLITS splits of equal
    span; split i holds slots [i span, min(W, (i + 1) span)) of the ring,
    none empty."""
    span = -(-W // min(MAX_SPLITS, W))
    return -(-W // span), span


def attention_items(n_head: int, W: int, n_blocks: int) -> List[List[Tuple[int, int]]]:
    """Per block, its attention items (head, split) in the order it runs
    them: item i = head * n_split + split goes to block i % n_blocks."""
    n_split, _ = attention_splits(W)
    items: List[List[Tuple[int, int]]] = [[] for _ in range(n_blocks)]
    for i in range(n_head * n_split):
        items[i % n_blocks].append(divmod(i, n_split))
    return items


def part_stride(head_dim: int) -> int:
    """Floats of one item's partial, a multiple of 4 (16-byte loads)."""
    return -(-(head_dim + PART) // 4) * 4


def smem_bytes(dim: int, inter: int, n_head: int, head_dim: int, W: int) -> int:
    """Shared memory of one block (csrc/wt_stream.cu `smem_floats`): a
    phase's input row, the staged partials, the block's h columns, an
    item's query and fresh key, its scores and the value sums by group."""
    n_split, span = attention_splits(W)
    return 4 * (max(dim, inter) + n_head * n_split * part_stride(head_dim) + dim
                + 2 * head_dim + span + THREADS)


def check_geometry(L: int, dim: int, n_head: int, head_dim: int, inter: int, W: int,
                   dtype) -> None:
    """Raise on a geometry the kernel does not take."""
    u = unit_cols(dtype)
    if (n_head * head_dim != dim or head_dim % 2 or head_dim > MAX_HEAD_DIM or dim % u
            or inter % u or max(dim, inter) > MAX_ROW or L < 1
            or smem_bytes(dim, inter, n_head, head_dim, W) > MAX_SMEM):
        raise ValueError("wt_stream_step: unsupported geometry "
                         f"(dim={dim}, heads={n_head}x{head_dim}, inter={inter}, W={W})")


_KEPT: Dict[Tuple, Dict[str, torch.Tensor]] = {}


def kept_scratch(L: int, dim: int, n_head: int, head_dim: int, inter: int, W: int,
                 dtype, device) -> Dict[str, torch.Tensor]:
    """The scratch that the kernel's calls at this geometry and weight type
    on `device` share (so calls on two streams must not overlap): `qkv`
    (roped q, roped k, v), `gate` and `part` (the attention items'
    partials).  Every call writes each before it reads it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:  # tensors name their card
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (L, dim, n_head, head_dim, inter, W, dtype, dev)
    if key not in _KEPT:
        n_split, _ = attention_splits(W)
        _KEPT[key] = {
            "qkv": torch.empty(3 * dim, dtype=dtype, device=dev),
            "gate": torch.empty(inter, dtype=dtype, device=dev),
            "part": torch.empty(n_head * n_split * part_stride(head_dim),
                                dtype=torch.float32, device=dev)}
    return _KEPT[key]


@functools.lru_cache(maxsize=16)
def _plan_on(dim: int, inter: int, n_blocks: int, dtype, device: torch.device):
    plan = work_plan(dim, inter, n_blocks, dtype).reshape(n_blocks, -1)
    return torch.from_numpy(np.ascontiguousarray(plan)).to(device)


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
    h, _ = _launch(layers, x1, k_ring, v_ring, count, timeline=False, **kw)
    return h, k_ring, v_ring


def wt_stream_step_timeline(layers: Dict, x1: torch.Tensor, k_ring: torch.Tensor,
                            v_ring: torch.Tensor, count: int, **kw) -> torch.Tensor:
    """One launch of the kernel (arguments as `wt_stream_step`, CUDA
    tensors; the fresh rows are written as by a call) that also records,
    per block, the card's global time in ns where it enters and where it
    leaves each phase: (5 L, blocks, 2) int64, the phases as `phases`
    lists them."""
    return _launch(layers, x1, k_ring, v_ring, count, timeline=True, **kw)[1]


def _launch(layers, x1, k_ring, v_ring, count, *, n_head, head_dim, rope_base=10000.0,
            norm_eps=1e-5, table_rows=TABLE, timeline=False):
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
    if three != 3 * dim:
        raise ValueError(f"wt_stream_step: wqkv must be (L, dim, 3 dim), got {three}")
    check_geometry(L, dim, n_head, head_dim, inter, W, wd)
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
    n_blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = _plan_on(dim, inter, n_blocks, wd, dev)
    n_split, span = attention_splits(W)
    mats = [packed(w[k]) for k in ("wqkv", "wo", "w1", "w3", "w2")]
    kept = kept_scratch(L, dim, n_head, head_dim, inter, W, wd, dev)

    x = x1.to(device=dev, dtype=wd).contiguous()
    h = torch.empty((1, dim), dtype=wd, device=dev)
    stamps = (torch.zeros((len(phases(L)), n_blocks, 2), dtype=torch.int64, device=dev)
              if timeline else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _build.load("wt_stream")(
        DTYPE_CODE[wd], DTYPE_CODE[rd], ptr(x), ptr(h), *[ptr(m) for m in mats],
        ptr(w["attention_norm"]), ptr(w["ffn_norm"]), ptr(w["attn_scale"]),
        ptr(w["ffn_scale"]), ptr(k_ring), ptr(v_ring), ptr(cos[p]), ptr(sin[p]), ptr(plan),
        ptr(kept["qkv"]), ptr(kept["gate"]), ptr(kept["part"]), ptr(stamps),
        ptr(barrier_count("wt_stream", dev)), n_blocks, int(count), L, dim, n_head,
        head_dim, inter, W, n_split, span, float(norm_eps), float(1.0 / np.sqrt(head_dim)),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc == COOPERATIVE_TOO_LARGE:
        raise RuntimeError(f"wt_stream_step: a grid of {n_blocks} blocks, one per SM, cannot "
                           "be resident at once (cudaErrorCooperativeLaunchTooLarge)")
    if rc != 0:
        raise RuntimeError(f"wt_stream_step: CUDA launch failed with error {rc}")
    wt_stream_step.launches += 1
    return h, stamps


wt_stream_step.launches = 0
