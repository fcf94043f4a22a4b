"""The dual-AR slow step at batch 1: plain version, CUDA kernel wrapper.

Replaces the TPU kernel `slow_decode_step` (`_slow_step_kernel`) of the
JAX package's ops/pallas_slow_decode.py.  One call runs the L-layer step on
the frame's two tokens [audio_emb, cond_emb]: RMSNorm -> QKV -> RoPE at pos
and pos+1 -> attention over the flat cache rows < pos plus the two fresh
rows under one softmax -> wo -> RMSNorm -> SwiGLU; then the final norm, the
output head and the exact nucleus sampler for the semantic token.  It
returns the two fresh roped K/V rows per layer; the caller writes them into
the cache at pos.

What bounds it on the card: bytes.  At bf16 the step reads about 184 MB of
layer weights (12 x 15.3 MB), 12.6 MB of output head and
12 * 2 * pos * 768 * 2 bytes of cache, against 3.35 TB/s; its operations
(two rows per weight) are far below the tensor cores' rate.

What the design does about it (csrc/slow_decode.cu, csrc/decode_common.cuh):
per layer, four split-K matrix-vector launches and one attention launch,
then the output head and the sampler, 62 launches.  Each matvec reads every
weight byte once and uses it for both rows, with hundreds of blocks in
flight.  The attention splits each head's pos + 2 rows across a grid fixed
by the cache length (16 blocks a head at 2048 rows in bf16, 192 in all):
each block reads its rows with 16-byte loads, all in flight at once, and
keeps per query a max, a sum of exp and unnormalized value sums; the last
block of a head merges them in split order (an atomic ticket), so the
result does not depend on block timing.  A first design with one block per
head spent 81 % of the step's device time there at pos 1000.  Every launch
goes out by programmatic dependent launch, so the next one's weight or
cache loads overlap the previous one's tail.  What is left: the matvecs,
about 7 us each against 1 to 2 us of weight stream, and the host, which
takes about as long to enqueue the step as the card to run it —
a CUDA graph or one persistent kernel is later work.

The plain version below repeats the TPU kernel's arithmetic, including its
rounding points in bf16, and is the CPU path and the kernel's oracle.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from streamvoiceanon_tpu_torch.ops import _build
from streamvoiceanon_tpu_torch.ops.decode_common import (
    DTYPE_CODE, check_cuda, dot, freqs_table, matvec_scratch, nucleus_sample, rope_rows)
from streamvoiceanon_tpu_torch.ops.norm import rms_norm


def slow_attention_plain(qkv: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         pos: int, *, n_head: int, head_dim: int,
                         rope_base: float = 10000.0):
    """One layer's attention of the slow step.  qkv (2, 3*dim) in the weight
    dtype, caches (S, dim) of that layer, rows < pos valid.  Returns (attn
    (2, dim) in the weight dtype, the fresh roped k and v rows (2, dim) in
    the cache dtype)."""
    wd, cd = qkv.dtype, k_cache.dtype
    dim = qkv.shape[1] // 3
    H, hd = n_head, head_dim
    fr = freqs_table(k_cache.shape[0], hd, rope_base, qkv.device)[pos : pos + 2]
    inv_scale = 1.0 / np.sqrt(hd)
    causal = torch.tensor([[True, False], [True, True]], device=qkv.device)
    q32, k32, v = qkv[:, :dim].float(), qkv[:, dim : 2 * dim].float(), qkv[:, 2 * dim :]
    qr = rope_rows(q32, fr, H).to(wd)
    kr = rope_rows(k32, fr, H).to(wd)
    # scores against the valid cache rows and the two fresh rows: the
    # products are taken in the cache dtype, the head sums in float32
    qt = qr.to(cd)
    keys = torch.cat([k_cache[:pos], kr.to(cd)], dim=0)  # (pos+2, dim)
    s = (keys[None] * qt[:, None]).float().reshape(2, pos + 2, H, hd).sum(-1)
    s = s * inv_scale
    s[:, pos:] = torch.where(causal[..., None], s[:, pos:], float("-inf"))
    e = torch.exp(s - torch.amax(s, dim=1, keepdim=True))  # (2, pos+2, H)
    vals = torch.cat([v_cache[:pos].float(), v.float()], dim=0)
    attn = torch.einsum("tjh,jhd->thd", e, vals.reshape(pos + 2, H, hd))
    attn = attn / torch.sum(e, dim=1)[..., None]
    return attn.reshape(2, dim).to(wd), kr.to(cd), v.to(cd)


def slow_decode_step_plain(
    layers: Dict, x2: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    pos: int, out_norm: torch.Tensor, out_head: torch.Tensor,
    gumbel: Optional[torch.Tensor], *, n_head: int, head_dim: int,
    rope_base: float = 10000.0, norm_eps: float = 1e-5, temperature: float = 0.7,
    top_p: float = 0.7, greedy: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (x_out (2, dim), k_rows (L, 2, dim), v_rows (L, 2, dim),
    token (1,) int32).  Caches (L, S, dim) flat rows, rows < pos valid."""
    wd = layers["wqkv"]["w"].dtype
    L = layers["wqkv"]["w"].shape[0]
    h = x2.to(wd)
    k_rows, v_rows = [], []
    for l in range(L):
        qkv = dot(rms_norm(h, layers["attention_norm"]["w"][l], norm_eps),
                  layers["wqkv"]["w"][l])
        attn, kr, vr = slow_attention_plain(qkv, k_cache[l], v_cache[l], pos, n_head=n_head,
                                            head_dim=head_dim, rope_base=rope_base)
        k_rows.append(kr)
        v_rows.append(vr)
        h = h + dot(attn, layers["wo"]["w"][l])
        fn = rms_norm(h, layers["ffn_norm"]["w"][l], norm_eps)
        a = dot(fn, layers["w1"]["w"][l]).float()
        gate = (a / (1.0 + torch.exp(-a))).to(wd) * dot(fn, layers["w3"]["w"][l])
        h = h + dot(gate, layers["w2"]["w"][l])
    logits = dot(rms_norm(h[1:2], out_norm.to(wd), norm_eps), out_head.to(wd)).float()[0]
    token = nucleus_sample(logits, None if gumbel is None else gumbel.reshape(-1),
                           greedy=greedy, temperature=temperature, top_p=top_p)
    return h, torch.stack(k_rows), torch.stack(v_rows), token


MAX_VOCAB = 16384  # the sampler's values a block


def check_geometry(dim: int, n_head: int, head_dim: int, inter: int, V: int,
                   cache_dtype) -> None:
    """Raise on a geometry the kernel does not take."""
    if (n_head * head_dim != dim or not row_lanes_ok(head_dim, cache_dtype)
            or dim % 8 or inter % 8 or V % 8 or V > MAX_VOCAB):
        raise ValueError("slow_decode_step: unsupported geometry "
                         f"(dim={dim}, heads={n_head}x{head_dim}, inter={inter}, V={V})")


def slow_decode_step(
    layers: Dict, x2: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    pos: int, out_norm: torch.Tensor, out_head: torch.Tensor,
    gumbel: Optional[torch.Tensor], *, n_head: int, head_dim: int,
    rope_base: float = 10000.0, norm_eps: float = 1e-5, temperature: float = 0.7,
    top_p: float = 0.7, greedy: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The slow step: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  Same arguments and results as `slow_decode_step_plain`.
    The kernel's (vocab,) float32 logits stay in `slow_decode_step.last_logits`
    for diagnostics."""
    kw = dict(n_head=n_head, head_dim=head_dim, rope_base=rope_base,
              norm_eps=norm_eps, temperature=temperature, top_p=top_p, greedy=greedy)
    if x2.device.type == "cpu":
        return slow_decode_step_plain(layers, x2, k_cache, v_cache, pos, out_norm,
                                      out_head, gumbel, **kw)
    w = {k: layers[k]["w"] for k in ("wqkv", "wo", "w1", "w3", "w2",
                                     "attention_norm", "ffn_norm")}
    wd = w["wqkv"].dtype
    cd = k_cache.dtype
    if wd not in DTYPE_CODE or cd not in DTYPE_CODE:
        raise ValueError(f"slow_decode_step: unsupported dtypes {wd}, {cd}")
    L, dim, three = w["wqkv"].shape
    inter = w["w1"].shape[-1]
    S = k_cache.shape[1]
    V = out_head.shape[-1]
    if three != 3 * dim:
        raise ValueError(f"slow_decode_step: wqkv must be (L, dim, 3 dim), got {three}")
    check_geometry(dim, n_head, head_dim, inter, V, cd)
    if k_cache.shape != (L, S, dim) or v_cache.shape != (L, S, dim):
        raise ValueError(f"slow_decode_step: caches must be (L, S, dim), got "
                         f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}")
    if not 0 <= pos <= S - 2:
        raise ValueError(f"slow_decode_step: pos {pos} outside the {S}-row cache")
    if x2.shape != (2, dim):
        raise ValueError(f"slow_decode_step: x2 must be (2, {dim})")
    if not greedy and (gumbel is None or gumbel.numel() != V):
        raise ValueError(f"slow_decode_step: sampling needs a ({V},) Gumbel row")
    out_norm, out_head = out_norm.to(wd), out_head.to(wd)
    dev = check_cuda("slow_decode_step", {**w, "out_norm": out_norm,
                                          "out_head": out_head}, wd)
    check_cuda("slow_decode_step", {"k_cache": k_cache, "v_cache": v_cache}, cd)
    if gumbel is not None:
        gumbel = gumbel.reshape(-1).float().contiguous()
        check_cuda("slow_decode_step", {"gumbel": gumbel, "k_cache": k_cache})
    freqs = freqs_table(S, head_dim, rope_base, dev)

    h = x2.to(device=dev, dtype=wd).contiguous().clone()
    k_rows = torch.empty((L, 2, dim), dtype=cd, device=dev)
    v_rows = torch.empty((L, 2, dim), dtype=cd, device=dev)
    token = torch.empty(1, dtype=torch.int32, device=dev)
    qkv = torch.empty((2, 3 * dim), dtype=wd, device=dev)
    attn = torch.empty((2, dim), dtype=wd, device=dev)
    gate = torch.empty((2, inter), dtype=wd, device=dev)
    logits = torch.empty(V, dtype=torch.float32, device=dev)
    partials, counters = matvec_scratch(
        2, [(dim, 3 * dim, 1), (dim, dim, 1), (dim, inter, 2), (inter, dim, 1),
            (dim, V, 1)], dev)
    attn_part, tickets = attention_scratch(n_head, head_dim, S, cd, dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _build.load("slow_decode")(
        DTYPE_CODE[wd], DTYPE_CODE[cd], ptr(h), ptr(w["wqkv"]), ptr(w["wo"]),
        ptr(w["w1"]), ptr(w["w3"]), ptr(w["w2"]), ptr(w["attention_norm"]),
        ptr(w["ffn_norm"]), ptr(k_cache), ptr(v_cache), ptr(freqs), int(pos),
        ptr(out_norm), ptr(out_head), ptr(gumbel), ptr(k_rows), ptr(v_rows),
        ptr(token), ptr(qkv), ptr(attn), ptr(gate), ptr(logits), ptr(partials),
        ptr(counters), ptr(attn_part), ptr(tickets), L, dim, n_head, head_dim, inter, S,
        V, float(norm_eps),
        float(max(temperature, 1e-5)), float(top_p), int(bool(greedy)),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"slow_decode_step: CUDA launch failed with error {rc}")
    slow_decode_step.launches += 1
    slow_decode_step.last_logits = logits
    return h, k_rows, v_rows, token


slow_decode_step.launches = 0
slow_decode_step.last_logits = None


# must match SA_THREADS and SA_U in csrc/slow_decode.cu
SA_THREADS, SA_U = 128, 8


def row_lanes_ok(head_dim: int, cache_dtype) -> bool:
    """The attention reads a head's cache row as 1, 2, 4, 8, 16 or 32 lanes
    of one 16-byte load each."""
    nbytes = head_dim * torch.empty((), dtype=cache_dtype).element_size()
    return nbytes % 16 == 0 and nbytes // 16 in (1, 2, 4, 8, 16, 32)


def attention_splits(S: int, head_dim: int, cache_dtype) -> int:
    """Blocks per head of the step's attention: the S cache rows in runs of
    (SA_THREADS / lanes a row) * SA_U rows, a row read as 16-byte loads."""
    lanes = head_dim * torch.empty((), dtype=cache_dtype).element_size() // 16
    return -(-S // (SA_THREADS // lanes * SA_U))


def attention_scratch(n_head: int, head_dim: int, S: int, cache_dtype, device):
    """(partials, tickets) of the attention launches: per head and split,
    the two queries' max, sum and value sums; one zeroed ticket per head
    (each launch leaves them at zero)."""
    n = n_head * attention_splits(S, head_dim, cache_dtype) * 2 * (head_dim + 2)
    return (torch.empty(n, dtype=torch.float32, device=device),
            torch.zeros(n_head, dtype=torch.int32, device=device))


def slow_attention(qkv: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                   pos: int, *, n_head: int, head_dim: int, rope_base: float = 10000.0,
                   reps: int = 1):
    """One layer's attention of the slow step, alone: for CUDA tensors the
    launch the step makes for it, `reps` times in a row (for timing it
    without the host between launches); for CPU tensors the plain version.
    Same arguments and results as `slow_attention_plain`.  The step does
    not call this; chip_smoke.py and the card tests do."""
    if qkv.device.type == "cpu":
        return slow_attention_plain(qkv, k_cache, v_cache, pos, n_head=n_head,
                                    head_dim=head_dim, rope_base=rope_base)
    wd, cd = qkv.dtype, k_cache.dtype
    S, dim = k_cache.shape
    if (wd not in DTYPE_CODE or cd not in DTYPE_CODE or not 0 <= pos <= S - 2
            or qkv.shape != (2, 3 * dim) or n_head * head_dim != dim
            or not row_lanes_ok(head_dim, cd)):
        raise ValueError(f"slow_attention: unsupported dtypes {wd}, {cd}, pos {pos} or "
                         f"geometry (qkv {tuple(qkv.shape)}, heads {n_head}x{head_dim})")
    dev = check_cuda("slow_attention", {"qkv": qkv}, wd)
    if check_cuda("slow_attention", {"k_cache": k_cache, "v_cache": v_cache}, cd) != dev:
        raise ValueError("slow_attention: qkv and the caches are on different devices")
    freqs = freqs_table(S, head_dim, rope_base, dev)
    attn = torch.empty((2, dim), dtype=wd, device=dev)
    k_rows = torch.empty((2, dim), dtype=cd, device=dev)
    v_rows = torch.empty((2, dim), dtype=cd, device=dev)
    part, tickets = attention_scratch(n_head, head_dim, S, cd, dev)
    ptr = lambda t: t.data_ptr()
    rc = _build.load("svd_slow_attention")(
        DTYPE_CODE[wd], DTYPE_CODE[cd], ptr(qkv), ptr(k_cache), ptr(v_cache), ptr(freqs),
        int(pos), ptr(k_rows), ptr(v_rows), ptr(attn), ptr(part), ptr(tickets), n_head,
        head_dim, S, int(reps), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"slow_attention: CUDA launch failed with error {rc}")
    return attn, k_rows, v_rows
