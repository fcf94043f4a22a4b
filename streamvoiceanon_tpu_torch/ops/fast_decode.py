"""The dual-AR fast codebook loop at batch 1: plain version, CUDA kernel wrapper.

Replaces the TPU kernel `fast_decode` (`_fast_decode_kernel`) of the JAX
package's ops/pallas_fast_decode.py.  One call runs the nq autoregressive
codebook steps of a frame through the L fast layers with a fresh nq-slot KV
scratch (RoPE at slot s): each step runs the fast head (vocab 1000), the
exact nucleus sampler, and feeds `fast_embeddings[code]` back in.  It also
returns the next frame's audio embedding, the sum over codebooks of
`codebook_embeddings[q * vocab + code_q]`, summed in the weight dtype.

What bounds it on the card: bytes.  The 4 fast layers are 61 MB at bf16,
above the 50 MB L2, so a design that re-reads them in each of the 8 steps
moves about 490 MB per frame; reading them once would move 61 MB plus the
1.5 MB head.  Its operations (one row per weight) are negligible.  What
held the first design back was latency: 176 dependent launches a frame,
each a few microseconds of launch gap and round trips for 1 to 4 MB of
weights.

The design (csrc/fast_decode.cu): one cooperative launch a frame, one block
per SM, the whole loop inside it.  The TPU kernel's program order becomes
grid-wide barriers, 4 a layer and 1 after the head (136 a frame at 4 layers
and 8 codebooks):

    A  RMSNorm, then qkv; q roped (float32), k roped and rounded, v into slot s
    B  attention over slots <= s (every block, redundantly), then wo + residual
    C  RMSNorm, then w1 and w3 with the SwiGLU gate
    D  w2 + residual
    head  RMSNorm, then the 1000 float32 logits

After the head's barrier every block runs the same sampler on the logits,
so all know the code without a further barrier: each reads
`fast_embeddings[code]` as the next step's input, the owners of h's columns
write them, and block 0 adds the codebook row to the audio embedding.

Each block owns fixed output columns of every phase (`work_plan`, computed
here) in units of 16 bytes a weight row, and sums each column over the whole
K in a fixed order: no split-K partials, and the result does not depend on
block timing.  A unit holds whole RoPE pairs, and the w1 and w3 columns of
a unit share a block.  The weights are read in a packed layout (`packed`):
each unit's K x 16-byte column slice contiguous, made once per weight tensor
and kept.  What the TPU kernel keeps in VMEM stays on chip here in shared
memory (`resident_plan`): each block keeps its first tasks of every slice
resident, about 40 % of its weights (168 KB a block in bf16), loaded once by
bulk copies (TMA) in step 0; the rest, about 40 MB a step, which L2 can
hold, is streamed into a 36 KB ring by bulk copies issued before the
barrier that precedes each phase.  The barrier is a release/acquire arrival
count (`barrier_count`, ops/decode_common.py, with the column plan and the
packed layout), and the sampler runs across the block.

The plain version below repeats the TPU kernel's arithmetic and is the CPU
path and the kernel's oracle.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from streamvoiceanon_tpu_torch.ops import _build
from streamvoiceanon_tpu_torch.ops.decode_common import (
    COOPERATIVE_TOO_LARGE, DTYPE_CODE, MAX_SMEM, barrier_count, check_cuda, column_plan, dot,
    freqs_table, nucleus_sample, packed, rope_rows, unit_cols)
from streamvoiceanon_tpu_torch.ops.norm import rms_norm

# the kernel's phases, in the order of the plan's columns (csrc/fast_decode.cu)
PHASES = ("qkv", "wo", "w13", "w2", "head")
MAX_NQ = 16  # FD_MAXQ: attention slots
MAX_VOCAB = 1024  # FD_VOC values a thread of the sampler
MAX_ROW = 2560  # FD_ROW values a thread of a row (dim, inter, the audio embedding)
MAX_ROUNDS = 4  # FD_MAXR: the attention's rounds of 32 / (head_dim / unit_cols) slots
MAX_LAYERS = 8  # FD_MAXL: one mbarrier a layer for the resident weights
RING_BYTES = 36864  # FD_RING: one phase's streamed weights (3 x 12 KB or 1 x 36 KB)
# the kernel's static shared memory: red, scal, part, bv, bi, the
# resident offsets and the mbarriers
STATIC_SMEM = (16 * 8 * 4 + 32 * 4 + 2 * 4 * 16 * 4 + 2 * 16 * 4
               + (4 * MAX_LAYERS + 1) * 4 + (MAX_LAYERS + 2) * 8)


def fast_decode_plain(
    fast_layers: Dict, fast_norm: torch.Tensor, fast_output: torch.Tensor,
    fast_embeddings: torch.Tensor, codebook_embeddings: torch.Tensor,
    hidden: torch.Tensor, gumbel: Optional[torch.Tensor], *, nq: int, n_head: int,
    head_dim: int, rope_base: float = 10000.0, norm_eps: float = 1e-5,
    temperature: float = 0.7, top_p: float = 0.7, greedy: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden (1, dim) -> (codes (1, nq) int32, audio_emb (1, mdim) in the
    weight dtype).  gumbel: (1, nq, vocab) float32, unused when greedy."""
    wd = fast_output.dtype
    L, dim, _ = fast_layers["wqkv"]["w"].shape
    V = fast_output.shape[-1]
    H, hd = n_head, head_dim
    fr = freqs_table(nq, hd, rope_base, hidden.device)
    inv_scale = 1.0 / np.sqrt(hd)
    kc = torch.zeros((L, nq, dim), dtype=wd, device=hidden.device)
    vc = torch.zeros_like(kc)
    x = hidden.reshape(1, dim).to(wd)
    codes, aemb = [], None
    for s in range(nq):
        h = x
        for l in range(L):
            qkv = dot(rms_norm(h, fast_layers["attention_norm"]["w"][l], norm_eps),
                      fast_layers["wqkv"]["w"][l])
            qr = rope_rows(qkv[:, :dim].float(), fr[s : s + 1], H)
            kc[l, s] = rope_rows(qkv[:, dim : 2 * dim].float(), fr[s : s + 1], H)[0].to(wd)
            vc[l, s] = qkv[0, 2 * dim :]
            # slots <= s: this frame's earlier steps and the fresh one
            sc = (qr * kc[l, : s + 1].float()).reshape(s + 1, H, hd).sum(-1) * inv_scale
            w = torch.softmax(sc, dim=0)  # (s+1, H)
            attn = torch.einsum("jh,jhd->hd", w, vc[l, : s + 1].float().reshape(s + 1, H, hd))
            h = h + dot(attn.reshape(1, dim).to(wd), fast_layers["wo"]["w"][l])
            fn = rms_norm(h, fast_layers["ffn_norm"]["w"][l], norm_eps)
            a = dot(fn, fast_layers["w1"]["w"][l]).float()
            gate = (a / (1.0 + torch.exp(-a))).to(wd) * dot(fn, fast_layers["w3"]["w"][l])
            h = h + dot(gate, fast_layers["w2"]["w"][l])
        logits = dot(rms_norm(h, fast_norm.to(wd), norm_eps), fast_output).float()[0]
        code = nucleus_sample(logits, None if gumbel is None else gumbel.reshape(nq, V)[s],
                              greedy=greedy, temperature=temperature, top_p=top_p)
        codes.append(code)
        x = fast_embeddings[code].to(wd)
        contrib = codebook_embeddings[s * V + code].to(wd)
        aemb = contrib if s == 0 else aemb + contrib
    return torch.cat(codes).reshape(1, nq), aemb


def phase_units(dim: int, inter: int, V: int, dtype) -> Tuple[int, ...]:
    """Units of each phase of PHASES (w13: one unit is a w1 and a w3 slice)."""
    u = unit_cols(dtype)
    return (3 * dim // u, dim // u, inter // u, dim // u, V // u)


def unit_bytes(L: int, dim: int, inter: int) -> Tuple[int, ...]:
    """Weight bytes of one unit of each phase over a codebook step (all L
    layers; the head once)."""
    return (L * dim * 16, L * dim * 16, L * 2 * dim * 16, L * inter * 16, dim * 16)


def check_geometry(L: int, dim: int, n_head: int, head_dim: int, inter: int, V: int,
                   nq: int, mdim: int, dtype) -> None:
    """Raise on a geometry the kernel does not take."""
    u = unit_cols(dtype)
    cph = head_dim // u  # 16-byte chunks of a head's row
    if (n_head * head_dim != dim or head_dim % u or cph > 32
            or cph & (cph - 1) or (nq - 1) // (32 // max(cph, 1)) >= MAX_ROUNDS
            or dim % u or inter % u or V % u
            or not 1 <= nq <= MAX_NQ or V > MAX_VOCAB or max(dim, inter, mdim) > MAX_ROW
            or not 1 <= L <= MAX_LAYERS
            or smem_bytes(dim, inter, V, nq, head_dim) > MAX_SMEM):
        raise ValueError("fast_decode: unsupported geometry "
                         f"(dim={dim}, heads={n_head}x{head_dim}, inter={inter}, V={V}, "
                         f"nq={nq}, layers={L}, rows={mdim})")


def smem_bytes(dim: int, inter: int, V: int, nq: int, head_dim: int) -> int:
    """Shared memory of one block besides its resident weights: a phase's
    input row and the RoPE table in float32, the ring, and the static
    buffers."""
    return 4 * (max(dim, inter) + nq * head_dim) + RING_BYTES + STATIC_SMEM


@functools.lru_cache(maxsize=16)
def work_plan(L: int, dim: int, inter: int, V: int, n_blocks: int, dtype) -> np.ndarray:
    """(n_blocks, 5, 2) int32: per block and phase of PHASES, the first unit
    it owns and how many, a contiguous run.  The same for every layer.

    The rule is `column_plan`'s (ops/decode_common.py)."""
    return column_plan(phase_units(dim, inter, V, dtype), unit_bytes(L, dim, inter), n_blocks)


def slice_shapes(L: int, dim: int, inter: int) -> Tuple[Tuple[int, int, int], ...]:
    """(phase index, matrices a unit, bytes a task) of each weight slice of
    a codebook step in the kernel's order: layer by layer A, B, C, D, then
    the head.  A task is one matrix's K x 16-byte slice of one unit."""
    per_layer = ((0, 1, dim * 16), (1, 1, dim * 16), (2, 2, dim * 16), (3, 1, inter * 16))
    return per_layer * L + ((4, 1, dim * 16),)


@functools.lru_cache(maxsize=16)
def resident_plan(L: int, dim: int, inter: int, V: int, n_blocks: int, dtype, nq: int,
                  head_dim: int) -> np.ndarray:
    """(n_blocks, 4 L + 1) int32: per block and slice (`slice_shapes`), how
    many of its first tasks stay in shared memory across the nq steps.  The
    rest of a slice is streamed each step: up to RING_BYTES into the ring
    ahead of the phase, the remainder read from global memory in the phase.

    Each block fills its own budget: first what its ring cannot take, slice
    by slice, then more in slice order, to cut what is re-read each step."""
    counts = work_plan(L, dim, inter, V, n_blocks, dtype)[:, :, 1]
    shapes = slice_shapes(L, dim, inter)
    budget = MAX_SMEM - smem_bytes(dim, inter, V, nq, head_dim)
    res = np.zeros((n_blocks, len(shapes)), dtype=np.int32)
    for b in range(n_blocks):
        left = budget
        tasks = [counts[b, p] * nmat for p, nmat, _ in shapes]
        for i, (_, _, tb) in enumerate(shapes):
            over = -(-(tasks[i] * tb - RING_BYTES) // tb)
            r = max(0, min(tasks[i], over, left // tb))
            res[b, i] = r
            left -= r * tb
        for i, (_, _, tb) in enumerate(shapes):
            r = min(tasks[i] - res[b, i], left // tb)
            res[b, i] += r
            left -= r * tb
    return res


def resident_bytes(res: np.ndarray, L: int, dim: int, inter: int) -> np.ndarray:
    """Each block's resident weight bytes."""
    return res @ np.asarray([tb for _, _, tb in slice_shapes(L, dim, inter)])


@functools.lru_cache(maxsize=16)
def _plan_on(L: int, dim: int, inter: int, V: int, n_blocks: int, dtype, nq: int,
             head_dim: int, device: torch.device) -> Tuple[torch.Tensor, int]:
    """The kernel's int table, a row a block: the 5 (first unit, units)
    pairs, then the resident tasks of each slice; and the largest block's
    resident bytes."""
    ranges = work_plan(L, dim, inter, V, n_blocks, dtype)
    res = resident_plan(L, dim, inter, V, n_blocks, dtype, nq, head_dim)
    table = np.concatenate([ranges.reshape(n_blocks, -1), res], axis=1)
    return (torch.from_numpy(np.ascontiguousarray(table)).to(device),
            int(resident_bytes(res, L, dim, inter).max()))


def fast_decode(
    fast_layers: Dict, fast_norm: torch.Tensor, fast_output: torch.Tensor,
    fast_embeddings: torch.Tensor, codebook_embeddings: torch.Tensor,
    hidden: torch.Tensor, gumbel: Optional[torch.Tensor], *, nq: int, n_head: int,
    head_dim: int, rope_base: float = 10000.0, norm_eps: float = 1e-5,
    temperature: float = 0.7, top_p: float = 0.7, greedy: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fast loop: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  Same arguments and results as `fast_decode_plain`.  The
    kernel's (nq, vocab) float32 logits stay in `fast_decode.last_logits`
    for diagnostics."""
    kw = dict(nq=nq, n_head=n_head, head_dim=head_dim, rope_base=rope_base,
              norm_eps=norm_eps, temperature=temperature, top_p=top_p, greedy=greedy)
    if hidden.device.type == "cpu":
        return fast_decode_plain(fast_layers, fast_norm, fast_output, fast_embeddings,
                                 codebook_embeddings, hidden, gumbel, **kw)
    codes, aemb, _ = _launch(fast_layers, fast_norm, fast_output, fast_embeddings,
                             codebook_embeddings, hidden, gumbel, timeline=False, **kw)
    return codes, aemb


def fast_decode_timeline(
    fast_layers: Dict, fast_norm: torch.Tensor, fast_output: torch.Tensor,
    fast_embeddings: torch.Tensor, codebook_embeddings: torch.Tensor,
    hidden: torch.Tensor, gumbel: Optional[torch.Tensor], **kw,
) -> torch.Tensor:
    """One launch of the kernel (arguments as `fast_decode`, CUDA tensors)
    that also records, per block, the card's global time in ns where it
    reaches and where it leaves each grid barrier: (points, blocks, 2)
    int64, point 0 the start, then the nq (4 L + 1) barriers in order, the
    last point the end."""
    return _launch(fast_layers, fast_norm, fast_output, fast_embeddings,
                   codebook_embeddings, hidden, gumbel, timeline=True, **kw)[2]


def _launch(fast_layers, fast_norm, fast_output, fast_embeddings, codebook_embeddings,
            hidden, gumbel, *, nq, n_head, head_dim, rope_base=10000.0, norm_eps=1e-5,
            temperature=0.7, top_p=0.7, greedy=False, timeline=False):
    w = {k: fast_layers[k]["w"] for k in ("wqkv", "wo", "w1", "w3", "w2",
                                          "attention_norm", "ffn_norm")}
    wd = fast_output.dtype
    if wd not in DTYPE_CODE:
        raise ValueError(f"fast_decode: unsupported dtype {wd}")
    L, dim, three = w["wqkv"].shape
    inter = w["w1"].shape[-1]
    V = fast_output.shape[-1]
    mdim = codebook_embeddings.shape[-1]
    if three != 3 * dim:
        raise ValueError(f"fast_decode: wqkv must be (L, dim, 3 dim), got {three}")
    check_geometry(L, dim, n_head, head_dim, inter, V, nq, mdim, wd)
    if (fast_embeddings.shape != (V, dim) or codebook_embeddings.shape != (nq * V, mdim)
            or hidden.numel() != dim):
        raise ValueError("fast_decode: embedding tables or hidden have the wrong shape")
    if not greedy and (gumbel is None or gumbel.numel() != nq * V):
        raise ValueError(f"fast_decode: sampling needs a (1, {nq}, {V}) Gumbel block")
    fast_norm = fast_norm.to(wd)
    dev = check_cuda("fast_decode", {
        **w, "fast_norm": fast_norm, "fast_output": fast_output,
        "fast_embeddings": fast_embeddings, "codebook_embeddings": codebook_embeddings},
        wd)
    if gumbel is not None:
        gumbel = gumbel.reshape(-1).float().contiguous()
        check_cuda("fast_decode", {"gumbel": gumbel, "fast_output": fast_output})
    freqs = freqs_table(nq, head_dim, rope_base, dev)
    n_blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    plan, res_bytes = _plan_on(L, dim, inter, V, n_blocks, wd, nq, head_dim, dev)
    mats = [packed(w[k]) for k in ("wqkv", "wo", "w1", "w3", "w2")] + [packed(fast_output)]

    hidden = hidden.reshape(dim).to(device=dev, dtype=wd).contiguous()
    h = torch.empty(dim, dtype=wd, device=dev)
    codes = torch.empty(nq, dtype=torch.int32, device=dev)
    aemb = torch.empty(mdim, dtype=wd, device=dev)
    kc = torch.empty((L, nq, dim), dtype=wd, device=dev)
    vc = torch.empty((L, nq, dim), dtype=wd, device=dev)
    q = torch.empty(dim, dtype=torch.float32, device=dev)
    gate = torch.empty(inter, dtype=wd, device=dev)
    logits = torch.empty((nq, V), dtype=torch.float32, device=dev)
    stamps = (torch.zeros((nq * (4 * L + 1) + 2, n_blocks, 2), dtype=torch.int64, device=dev)
              if timeline else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _build.load("fast_decode")(
        DTYPE_CODE[wd], ptr(hidden), ptr(h), ptr(gumbel), *[ptr(m) for m in mats[:5]],
        ptr(w["attention_norm"]), ptr(w["ffn_norm"]), ptr(fast_norm), ptr(mats[5]),
        ptr(fast_embeddings), ptr(codebook_embeddings), ptr(freqs), ptr(plan), ptr(codes),
        ptr(aemb), ptr(kc), ptr(vc), ptr(q), ptr(gate), ptr(logits), ptr(stamps),
        ptr(barrier_count("fast_decode", dev)), n_blocks, res_bytes,
        L, nq, dim, n_head, head_dim, inter, V, mdim, float(norm_eps),
        float(1.0 / np.sqrt(head_dim)), float(max(temperature, 1e-5)), float(top_p),
        int(bool(greedy)), torch.cuda.current_stream(dev).cuda_stream)
    if rc == COOPERATIVE_TOO_LARGE:
        raise RuntimeError(f"fast_decode: a grid of {n_blocks} blocks, one per SM, cannot "
                           "be resident at once (cudaErrorCooperativeLaunchTooLarge)")
    if rc != 0:
        raise RuntimeError(f"fast_decode: CUDA launch failed with error {rc}")
    fast_decode.launches += 1
    fast_decode.last_logits = logits
    return codes.reshape(1, nq), aemb.reshape(1, mdim), stamps


fast_decode.launches = 0
fast_decode.last_logits = None
