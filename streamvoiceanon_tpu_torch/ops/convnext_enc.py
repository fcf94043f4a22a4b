"""The tokenizer's ConvNeXt front in one call: packed state, plain version,
CUDA kernel wrapper.

Replaces the TPU kernel `encoder_front_step` (`_make_kernel`) of the JAX
package's ops/pallas_convnext_enc.py.  One call turns a chunk's T0 mel
frames into the pre-transformer features at batch 1: stem conv (k over
[tail; mel]) + LayerNorm, the ConvNeXt blocks of every stage (causal
depthwise conv k -> LN -> pointwise C->4C -> exact GELU -> pointwise 4C->C
-> LayerScale -> residual) with LN + 1x1 transitions between stages, a
final LN, then per downsample a stride-f conv of kernel f and one block.
Every depthwise tail lives in `PackedEncState`, the JAX package's layout:
8-row slots (rows k-1 .. 7 stay as they are), a stem buffer (B, 8, C_in),
one (B, depth*8, C_i) buffer per stage and a (B, n_down*8, C_q) buffer for
the downsample blocks, every leaf a view of one flat buffer in that order
(`init_packed_state`, `pack_enc_state` and every call's output state), which
the kernel reads and writes as one.  `pack_enc_state` / `unpack_enc_state`
convert to and from the dict layout of `models/tokenizer_stream.py`, where
batch > 1 runs.

What bounds the kernel on the card: bytes and latency.  At the published
width (stem 160 -> 128, blocks 3-3-9-3 at 128/256/384/512, two 512-wide
downsamples) one call reads about 99 MB of float32 weights, 0.030 ms at
3.35 TB/s, while its products over at most 4 rows (about 0.2 GFLOP) take
0.003 ms at 67 TFLOP/s.  Its 46 products depend on each other in
sequence, and each moves 0.1 to 4.2 MB, so a design of one launch each
pays a launch and a drain per product.

The design (csrc/convnext_enc.cu): one cooperative launch a call, one
block per SM (`encoder_front_step.launches` counts one a launch of at
most `launch_frames` frames).  The TPU kernel's program order becomes grid
barriers between the phases `phases` lists, 46 and 45 barriers at the
published geometry:

    stem  im2col of [tail; mel], the stem product + bias
    P     a block's depthwise conv + bias + LN (the stem LN first in the
          phase after the stem), pw1 + bias + GELU into g
    Q     g @ pw2 + bias, times gamma, plus x, in place (the last: into z)
    M     a transition: LN, then the 1x1 product + bias
    D     a downsample: (final LN,) the rows viewed as (T/f, f C) times
          the tap-major weight + bias
    L     only without a downsample: the final LN into z

Every block reads a phase's whole input rows into shared memory and
recomputes the row-wise steps itself, thread c taking columns c, c + 512,
...; it then owns fixed runs of 4-column units of the phase's product
(`work_plan`, the rule of `column_plan` in ops/decode_common.py) and sums
each column of each row over the whole K in a fixed order, every weight
load serving four rows: no split-K partials, no tickets, and the result
does not depend on block timing.  The matrices are unit-packed once per
parameter tree (`unit_weights`, `tokenizer_params["enc_units"]`, made by
`params.Converter` beside `enc_packed`), the last unit of a width that is
no multiple of 4 zero-padded.  The phases come to the kernel as a table of
records (`_table`: weight pointers, then per phase its matrix, K, N,
width, kind, weights, block, tail slot, factor and flags), copied to the
card once per weight tree and geometry, so no count of stages,
downsamples or phases is capped; the row buffers and shared memory follow
the plan (`_sizes`), and `_checked` refuses only what the JAX kernel
refuses and a block whose shared memory would overflow.  A launch takes
whole downsample groups (4 frames, or the product where it is larger).
The barriers guard: stem -> P the stem rows; P -> Q the whole g, and P's
reads of x before Q writes its columns in place; Q -> next phase the whole
x, and Q's reads of g before the next P writes it; M -> P and D -> P the
product's rows, which go to the other activation buffer because other
blocks still read x in that phase.  The activation buffers, g and the plan
are kept across calls (`kept_scratch`); the output state and z are new
each call and the input state is only read, so a call is one device
launch.  `encoder_front_step_timeline` stamps each block's entry to each
phase, the start of its product and its exit with the card's global
timer.  A longer chunk runs as consecutive launches (the front is causal,
so the result is the same).

Weights W and tails S are each float32 or bf16, as the TPU kernel takes
them: activations hold values of W, tails are stored as S, and the rounding
points below round to W (a no-op in float32).

On the H100 the register design took about 0.25 ms a call (PERF.md §6): 45
barriers of about 1 us, P phases of 5 to 7.5 us (the rows' loads, the
depthwise conv and two block reductions before the product) and Q phases
of 3 to 4.5 us.  Without any weight traffic the same launch takes about
0.21 ms, so the skeleton of dependent steps, not the weight stream, bounds
it.  Its hot code has to stay small: it runs from the instruction cache,
kind after kind (PERF.md §6).

The plain version repeats the TPU kernel's arithmetic and rounding points
(after the depthwise conv + bias, after each LN, after each pointwise +
bias, after GELU, after the LayerScale product and the residual sum), in
the weights' dtype; the concatenation of a tail with new rows promotes to
promote(S, W), as the TPU kernel's does.  GELU is exact erf: the TPU
kernel's polynomial erf exists only because Mosaic cannot lower
`lax.erf`.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from streamvoiceanon_tpu_torch.config import TokenizerConfig
from streamvoiceanon_tpu_torch.ops import _build
from streamvoiceanon_tpu_torch.ops.conv import ConvState
from streamvoiceanon_tpu_torch.ops.decode_common import (
    COOPERATIVE_TOO_LARGE, MAX_SMEM, barrier_count, check_cuda, column_plan)
from streamvoiceanon_tpu_torch.ops.norm import layer_norm

SLOT = 8  # rows of one packed tail slot
LN_EPS = 1e-6


class PackedEncState(NamedTuple):
    """Packed depthwise-conv tails (B leading): the stem, one buffer per
    stage, and the downsample blocks'."""

    stem: torch.Tensor  # (B, 8, C_in)
    stages: Tuple[torch.Tensor, ...]  # (B, depth*8, C_i)
    down: torch.Tensor  # (B, n_down*8, C_q)


def init_packed_state(cfg: TokenizerConfig, batch: int = 1, dtype=torch.float32,
                      device=None) -> PackedEncState:
    """Zero tails, every leaf a view of one flat buffer (`state_sizes`
    order), the layout the kernel reads without a copy."""
    flat = torch.zeros(batch * sum(state_sizes(cfg)), dtype=dtype, device=device)
    return _views(flat, cfg, batch)


def _put_slots(buf: torch.Tensor, tails: List[torch.Tensor]) -> None:
    for i, t in enumerate(tails):
        buf[:, i * SLOT : i * SLOT + t.shape[1]] = t.to(buf.dtype)


def pack_enc_state(backbone_state: Dict, down_states, cfg: TokenizerConfig) -> PackedEncState:
    """Dict layout (`models/tokenizer_stream.py`) -> packed, its leaves views
    of one buffer (`init_packed_state`).  `down_states` is the
    TokenizerStreamState.down tuple ({"conv": ConvState, "block":
    ConvState})."""
    stem = backbone_state["stem"].tail
    out = init_packed_state(cfg, stem.shape[0], stem.dtype, stem.device)
    _put_slots(out.stem, [stem])
    for buf, stage in zip(out.stages, backbone_state["stages"]):
        _put_slots(buf, [st.tail for st in stage])
    _put_slots(out.down, [st["block"].tail for st in down_states])
    return out


def unpack_enc_state(packed: PackedEncState, cfg: TokenizerConfig):
    """Packed -> (backbone dict, down tuple) in the dict layout."""
    k = cfg.backbone.kernel_size
    slot = lambda buf, i: ConvState(buf[:, i * SLOT : i * SLOT + k - 1])
    backbone = {
        "stem": slot(packed.stem, 0),
        "stages": [[slot(packed.stages[i], bi) for bi in range(d)]
                   for i, d in enumerate(cfg.backbone.depths)],
    }
    B, _, cq = packed.down.shape
    empty = packed.down.new_zeros((B, 0, cq))  # stride == kernel: no conv tail
    down = tuple({"conv": ConvState(empty), "block": slot(packed.down, i)}
                 for i in range(len(cfg.quantizer.downsample_factor)))
    return backbone, down


# ---------------------------------------------------------------------------
# Weight packing (once per parameter tree: params.Converter)
# ---------------------------------------------------------------------------


def _conv_rows(w: torch.Tensor) -> torch.Tensor:
    """Conv1d weight (C_out, C_in, k) -> (k * C_in, C_out), tap-major rows."""
    co, ci, k = w.shape
    return w.permute(2, 1, 0).reshape(k * ci, co).contiguous()


def _stage_pack(blocks) -> Dict:
    stack = lambda f: torch.stack([f(b) for b in blocks]).contiguous()
    return {
        "dw_w": stack(lambda b: b["dwconv"]["w"][:, 0, :].t()),  # (d, k, C)
        "dw_b": stack(lambda b: b["dwconv"]["b"]),
        "ln_w": stack(lambda b: b["norm"]["w"]),
        "ln_b": stack(lambda b: b["norm"]["b"]),
        "pw1": torch.cat([b["pwconv1"]["w"] for b in blocks]).contiguous(),  # (d*C, 4C)
        "pw1_b": stack(lambda b: b["pwconv1"]["b"]),
        "pw2": torch.cat([b["pwconv2"]["w"] for b in blocks]).contiguous(),  # (d*4C, C)
        "pw2_b": stack(lambda b: b["pwconv2"]["b"]),
        "gamma": stack(lambda b: b["gamma"]),
    }


def _check_geometry(tok_params: Dict, cfg: TokenizerConfig) -> None:
    k = cfg.backbone.kernel_size
    if k > SLOT + 1:
        raise NotImplementedError("the fused ConvNeXt front: kernel_size > 9 overflows "
                                  "the 8-row packed tail slots")
    if cfg.backbone.gin_channels:
        raise NotImplementedError("the fused ConvNeXt front takes no global conditioning")
    for d, f in zip(tok_params["downsample"], cfg.quantizer.downsample_factor):
        if d["block"]["dwconv"]["w"].shape[-1] != k:
            raise NotImplementedError("the fused ConvNeXt front: the downsample block's "
                                      "depthwise kernel must equal backbone.kernel_size")
        if d["conv"]["w"].shape[-1] != f:
            raise NotImplementedError("the fused ConvNeXt front: each downsample conv's "
                                      "kernel must equal its stride")


def packed_weights(tok_params: Dict, cfg: TokenizerConfig) -> Dict:
    """The front's weights in the kernel's layouts, as the JAX package's
    `packed_weights` (from the port's PyTorch layouts): stem (k*C_in, C0)
    with (1, C) bias and norm rows; per stage the blocks' depthwise taps
    (d, k, C), row-stacked pointwise weights (d*C, 4C) and (d*4C, C) and
    (d, .) biases, norms and LayerScales; per transition its norm rows and
    1x1 weight (C_i, C_i+1); per downsample its tap-major (f*C, C_q) weight
    and one block packed as a stage."""
    _check_geometry(tok_params, cfg)
    p = tok_params["backbone"]
    n = len(cfg.backbone.depths)
    row = lambda t: t[None].contiguous()
    return {
        "stem_w": _conv_rows(p["stem_conv"]["w"]), "stem_b": row(p["stem_conv"]["b"]),
        "stem_ln_w": row(p["stem_norm"]["w"]), "stem_ln_b": row(p["stem_norm"]["b"]),
        "stages": [_stage_pack(p[f"stage_{i}"]) for i in range(n)],
        "mids": [{"ln_w": row(p[f"mid_norm_{i}"]["w"]), "ln_b": row(p[f"mid_norm_{i}"]["b"]),
                  "w": p[f"mid_conv_{i}"]["w"].contiguous(),
                  "b": row(p[f"mid_conv_{i}"]["b"])} for i in range(n - 1)],
        "final_ln_w": row(p["final_norm"]["w"]), "final_ln_b": row(p["final_norm"]["b"]),
        "downs": [{"w": _conv_rows(d["conv"]["w"]), "b": row(d["conv"]["b"]),
                   "blk": _stage_pack([d["block"]])} for d in tok_params["downsample"]],
    }


# ---------------------------------------------------------------------------
# Plain version and kernel wrapper
# ---------------------------------------------------------------------------


def _block(x: torch.Tensor, sp: Dict, bi: int, tail: torch.Tensor, k: int):
    """One ConvNeXt block on x (T, C) with its tail rows; returns (x', the
    block's new tail rows)."""
    T, C = x.shape
    dt = x.dtype
    pt = torch.promote_types(tail.dtype, dt)  # the TPU kernel's concatenation promotes
    full = torch.cat([tail[: k - 1].to(pt), x.to(pt)])
    dw = sp["dw_w"][bi].float()
    acc = torch.zeros((T, C), dtype=torch.float32, device=x.device)
    for j in range(k):
        acc = acc + full[j : j + T].float() * dw[j]
    h = (acc + sp["dw_b"][bi].float()).to(dt)
    h = layer_norm(h, sp["ln_w"][bi], sp["ln_b"][bi], LN_EPS)
    hid = sp["pw1"].shape[1]
    h = (h.float() @ sp["pw1"][bi * C : (bi + 1) * C].float() + sp["pw1_b"][bi].float()).to(dt)
    h = F.gelu(h.float()).to(dt)
    h = (h.float() @ sp["pw2"][bi * hid : (bi + 1) * hid].float()
         + sp["pw2_b"][bi].float()).to(dt)
    return x + h * sp["gamma"][bi], full[T : T + k - 1]


def _splice(buf: torch.Tensor, rows: List[torch.Tensor]) -> torch.Tensor:
    """buf (n*8, C) with the first rows of slot i replaced by rows[i]."""
    out = buf.clone()
    for i, r in enumerate(rows):
        out[i * SLOT : i * SLOT + r.shape[0]] = r.to(out.dtype)
    return out


def encoder_front_step_plain(pw: Dict, state: PackedEncState, mel: torch.Tensor,
                             cfg: TokenizerConfig) -> Tuple[PackedEncState, torch.Tensor]:
    """One front step at batch 1: mel (1, T0, C_in) -> (state', z (1, T0 /
    prod(downsample_factor), C_q))."""
    k = cfg.backbone.kernel_size
    dt = pw["stem_w"].dtype
    x = mel[0].to(dt)
    T = x.shape[0]
    stem_tail = state.stem[0]
    pt = torch.promote_types(stem_tail.dtype, dt)
    full = torch.cat([stem_tail[: k - 1].to(pt), x.to(pt)])
    stem_out = _splice(stem_tail, [full[T : T + k - 1]])
    cols = torch.cat([full[j : j + T] for j in range(k)], dim=1)
    x = (cols.float() @ pw["stem_w"].float() + pw["stem_b"].float()).to(dt)
    x = layer_norm(x, pw["stem_ln_w"], pw["stem_ln_b"], LN_EPS)
    stage_out = []
    for i, d in enumerate(cfg.backbone.depths):
        if i > 0:
            m = pw["mids"][i - 1]
            x = layer_norm(x, m["ln_w"], m["ln_b"], LN_EPS)
            x = (x.float() @ m["w"].float() + m["b"].float()).to(dt)
        sp, tail = pw["stages"][i], state.stages[i][0]
        rows = []
        for bi in range(d):
            x, r = _block(x, sp, bi, tail[bi * SLOT :], k)
            rows.append(r)
        stage_out.append(_splice(tail, rows))
    x = layer_norm(x, pw["final_ln_w"], pw["final_ln_b"], LN_EPS)
    down_tail, rows = state.down[0], []
    for i, f in enumerate(cfg.quantizer.downsample_factor):
        dp = pw["downs"][i]
        T, C = x.shape[0] // f, x.shape[1]
        x = (x.reshape(T, f * C).float() @ dp["w"].float() + dp["b"].float()).to(dt)
        x, r = _block(x, dp["blk"], 0, down_tail[i * SLOT :], k)
        rows.append(r)
    new = PackedEncState(stem_out[None], tuple(s[None] for s in stage_out),
                         _splice(down_tail, rows)[None])
    return new, x[None]


# ---------------------------------------------------------------------------
# The kernel's plan (csrc/convnext_enc.cu)
# ---------------------------------------------------------------------------

ROWS = 4  # rows of one pass of the kernel's matvec (RG in csrc/convnext_enc.cu)
THREADS = 512  # the kernel's threads (FT): a narrow geometry's widest row
UNIT = 4  # columns of one plan unit (16 bytes of a float32 weight row, 8 of bf16)
PHASE_FIELDS = 13  # int64 of a phase record (PH_FIELDS in csrc/convnext_enc.cu)
# the narrow build's most phases: their records' integer fields (K .. flags)
# go in its launch parameters (PH_PARAMS)
NARROW_PHASES = 96
KINDS = {"stem": 0, "P": 1, "Q": 2, "M": 3, "D": 4, "L": 5}  # PhaseKind
FL_STEM_LN, FL_FINAL_LN, FL_TO_Z = 1, 2, 4  # PhaseFlag
_TYPES = (torch.float32, torch.bfloat16)  # of the weights and of the state, each


class Phase(NamedTuple):
    """One phase of the kernel: its kind ("stem", "P", "Q", "M" for a
    transition, "D" for a downsample, "L" for the final LN where there is
    no downsample), where it runs ("s2b4": stage 2 block 4; "m1": the
    transition into stage 1; "d0": downsample 0, "d0b" its block) and its
    product's K and N (L: K 0, N the row width)."""

    kind: str
    where: str
    K: int
    N: int


def _geo_key(cfg: TokenizerConfig) -> Tuple:
    bb, q = cfg.backbone, cfg.quantizer
    return (bb.input_channels, bb.kernel_size, tuple(bb.depths), tuple(bb.dims),
            q.input_dim, tuple(q.downsample_factor))


@functools.lru_cache(maxsize=16)
def _phases(key: Tuple) -> Tuple[Phase, ...]:
    cin, k, depths, dims, cq, factors = key
    out = [Phase("stem", "stem", k * cin, dims[0])]
    for i, (d, c) in enumerate(zip(depths, dims)):
        if i > 0:
            out.append(Phase("M", f"m{i}", dims[i - 1], c))
        for bi in range(d):
            out += [Phase("P", f"s{i}b{bi}", c, 4 * c), Phase("Q", f"s{i}b{bi}", 4 * c, c)]
    c = dims[-1]
    for i, f in enumerate(factors):
        out += [Phase("D", f"d{i}", f * c, cq), Phase("P", f"d{i}b", cq, 4 * cq),
                Phase("Q", f"d{i}b", 4 * cq, cq)]
        c = cq
    if not factors:
        out.append(Phase("L", "final", 0, c))
    return tuple(out)


def phases(cfg: TokenizerConfig) -> List[Phase]:
    """The kernel's phases in order; a grid barrier between each two."""
    return list(_phases(_geo_key(cfg)))


@functools.lru_cache(maxsize=16)
def _work_plan(key: Tuple, n_blocks: int) -> np.ndarray:
    ph = _phases(key)
    return column_plan([-(-p.N // UNIT) for p in ph], [p.K * 16 for p in ph], n_blocks)


def work_plan(cfg: TokenizerConfig, n_blocks: int) -> np.ndarray:
    """(n_blocks, phases, 2) int32: per block and phase of `phases`, the
    first column unit it owns and how many, a contiguous run."""
    return _work_plan(_geo_key(cfg), n_blocks)


def widest(cfg: TokenizerConfig) -> int:
    return max(*cfg.backbone.dims, cfg.quantizer.input_dim)


def _rows(key: Tuple) -> Tuple[int, int]:
    """(frames of one launch at most, rows of the kernel's row buffers): a
    launch takes whole downsample groups, as many as fit in ROWS frames and
    at least one, and the buffers hold them in whole passes of ROWS."""
    factor = math.prod(key[5])
    step = max(ROWS // factor, 1) * factor
    return step, -(-step // ROWS) * ROWS


def launch_frames(cfg: TokenizerConfig) -> int:
    """Frames one launch takes at most; a longer chunk runs as several."""
    return _rows(_geo_key(cfg))[0]


@functools.lru_cache(maxsize=32)
def _sizes(key: Tuple, n_blocks: int) -> Dict[str, int]:
    """The kernel's shared-memory parts in elements: `rows` x `max_k` row
    floats, `pre_c` x SLOT tail-row floats (the wide build's), (2 + rows) x
    `ep_cols` epilogue floats, `n_tab` int64 of the table; `bytes`, the
    whole; and `wide`, whether the geometry takes the wide build."""
    cin, k, depths, dims, cq, factors = key
    ph = _phases(key)
    rows = _rows(key)[1]
    max_k = max(max(p.K for p in ph), max(*dims, cq, cin))
    pre_c = max(*dims, cq)
    ep_cols = UNIT * int(_work_plan(key, n_blocks)[:, :, 1].max())
    # the narrow build holds a column of every row in registers: rows at
    # most THREADS wide and multiples of UNIT, one pass of ROWS rows, at
    # most THREADS columns a block (its epilogue inputs THREADS apart), at
    # most NARROW_PHASES phases; any other geometry takes the wide build
    wide = int(pre_c > THREADS or rows > ROWS or ep_cols > THREADS
               or any(c % UNIT for c in (*dims, cq)) or len(ph) > NARROW_PHASES)
    ep_cols = max(ep_cols, 1) if wide else THREADS
    pre_c = pre_c if wide else 0  # the tail rows stage in shared memory in the wide build
    n_tab = 2 + PHASE_FIELDS * len(ph)
    nbytes = (8 * (n_tab + n_tab % 2)
              + 4 * (SLOT * pre_c + rows * max_k + (2 + rows) * ep_cols))
    return {"rows": rows, "max_k": max_k, "pre_c": pre_c, "ep_cols": ep_cols,
            "n_tab": n_tab, "bytes": nbytes, "wide": wide}


def smem_bytes(cfg: TokenizerConfig, n_blocks: int) -> int:
    """Dynamic shared memory of one block of the kernel at this geometry."""
    return _sizes(_geo_key(cfg), n_blocks)["bytes"]


def check_kernel_geometry(cfg: TokenizerConfig, n_blocks: int = 132) -> None:
    """Raise on a geometry the kernel does not take (on `n_blocks` SMs)."""
    _checked(_geo_key(cfg), n_blocks)


@functools.lru_cache(maxsize=16)
def _checked(key: Tuple, n_blocks: int) -> bool:
    """What the JAX package's `_check_geometry` refuses, and a block that
    would need more shared memory than the card has."""
    cin, k, depths, dims, cq, factors = key
    if k > SLOT + 1:
        raise ValueError("encoder_front_step: kernel_size > 9 overflows the 8-row packed "
                         "tail slots")
    need = _sizes(key, n_blocks)["bytes"]
    if need > MAX_SMEM:
        raise ValueError(
            f"encoder_front_step: this geometry (C_in {cin}, depths {depths}, dims {dims}, "
            f"C_q {cq}, downsample {factors}) needs {need} bytes of shared memory a block "
            f"on {n_blocks} SMs, more than the card's {MAX_SMEM}")
    return True


def _to_units(w: torch.Tensor, blocks: int = 1) -> torch.Tensor:
    """w (blocks * K, N), `blocks` matrices stacked by rows -> (blocks,
    ceil(N / UNIT), K, UNIT): each unit's column slice contiguous over the
    whole K, the last one zero-padded."""
    K, N = w.shape[0] // blocks, w.shape[1]
    w = F.pad(w, (0, -N % UNIT))
    return w.reshape(blocks, K, -1, UNIT).transpose(1, 2).contiguous()


def _matrices(pw: Dict) -> Iterator[Tuple[Tuple, torch.Tensor, int]]:
    """(place in `unit_weights`, source matrix, blocks stacked in it) of
    every matrix the kernel reads unit-packed."""
    yield ("stem_w",), pw["stem_w"], 1
    for i, sp in enumerate(pw["stages"]):
        for n in ("pw1", "pw2"):
            yield ("stages", i, n), sp[n], sp["dw_w"].shape[0]
    for i, m in enumerate(pw["mids"]):
        yield ("mids", i), m["w"], 1
    for i, dp in enumerate(pw["downs"]):
        yield ("downs", i, "w"), dp["w"], 1
        for n in ("pw1", "pw2"):
            yield ("downs", i, n), dp["blk"][n], 1


def unit_weights(pw: Dict) -> Dict:
    """The matrices of `packed_weights` unit-packed for the kernel, once per
    parameter tree (`params.Converter` keeps them beside the packed
    weights, `tokenizer_params["enc_units"]`): {"stem_w", "stages": [{"pw1",
    "pw2"}], "mids": [w], "downs": [{"w", "pw1", "pw2"}]}, each (blocks,
    ceil(N / 4), K, 4), in the weights' dtype."""
    out = {"stages": [{} for _ in pw["stages"]], "mids": [None] * len(pw["mids"]),
           "downs": [{} for _ in pw["downs"]]}
    for place, w, blocks in _matrices(pw):
        node = out
        for key in place[:-1]:
            node = node[key]
        node[place[-1]] = _to_units(w, blocks)
    return out


def _unit_at(units: Dict, place: Tuple) -> torch.Tensor:
    for key in place:
        units = units[key]
    return units


def _tensors(tree) -> Iterator[torch.Tensor]:
    """Every tensor of a nested dict/list tree."""
    if isinstance(tree, dict):
        tree = tree.values()
    if isinstance(tree, (list, tuple)) or not torch.is_tensor(tree):
        for t in tree:
            yield from _tensors(t)
    else:
        yield tree


def state_sizes(cfg: TokenizerConfig) -> List[int]:
    """Elements of each leaf of a batch-1 `PackedEncState` (stem, stages,
    down): the kernel reads and writes the state as one flat buffer in that
    order."""
    bb, q = cfg.backbone, cfg.quantizer
    return ([SLOT * bb.input_channels] + [d * SLOT * c for d, c in zip(bb.depths, bb.dims)]
            + [len(q.downsample_factor) * SLOT * q.input_dim])


def _views(flat: torch.Tensor, cfg: TokenizerConfig, batch: int = 1) -> PackedEncState:
    """A flat buffer of `batch` states as a PackedEncState of views (each
    leaf contiguous, in the order of `state_sizes`)."""
    bb, q = cfg.backbone, cfg.quantizer
    widths = [bb.input_channels, *bb.dims, q.input_dim]
    leaves, off = [], 0
    for n, c in zip(state_sizes(cfg), widths):
        leaves.append(flat[off : off + batch * n].view(batch, n // c, c))
        off += batch * n
    return PackedEncState(leaves[0], tuple(leaves[1:-1]), leaves[-1])


def _flat(state: PackedEncState, cfg: TokenizerConfig) -> torch.Tensor:
    """The state's leaves as one flat buffer: the buffer they are views of
    where they are (every call's output state, `init_packed_state`), else a
    copy."""
    leaves = [state.stem, *state.stages, state.down]
    base = leaves[0]
    es = base.element_size()
    off = 0
    for t, n in zip(leaves, state_sizes(cfg)):
        if (not t.is_contiguous() or t.dtype != base.dtype or t.device != base.device
                or t.numel() != n or t.data_ptr() != base.data_ptr() + off * es):
            return torch.cat([x.reshape(-1) for x in leaves]).to(base.dtype)
        off += n
    return base.as_strided((off,), (1,))


def _table(pw: Dict, units: Dict, cfg: TokenizerConfig) -> List[int]:
    """The kernel's table (csrc/convnext_enc.cu `tab`): the stem LN's
    weight and bias, then per phase a record of PHASE_FIELDS ints
    (`PhaseField`): its matrix (the block's slice of a stack), K, N, its
    input rows' width, its kind, its tail slot's offset in the flat state,
    its downsample factor, its flags, and the pointers of the vectors it
    reads (0 where it has none)."""
    key = _geo_key(cfg)
    cin, k, depths, dims, cq, factors = key
    ptr = lambda t: t.data_ptr()
    tab = [ptr(pw["stem_ln_w"]), ptr(pw["stem_ln_b"])]
    stage_off = np.cumsum([0] + state_sizes(cfg))
    ph = _phases(key)
    C = dims[0]
    for p, phase in enumerate(ph):
        flags = FL_STEM_LN if p == 1 else 0
        mat, slot, f, vecs = 0, 0, 1, []
        width = C
        if phase.kind == "stem":
            mat, width, vecs = ptr(units["stem_w"]), cin, [ptr(pw["stem_b"])]
        elif phase.kind == "M":
            i = int(phase.where[1:])
            m = pw["mids"][i - 1]
            mat, vecs = ptr(units["mids"][i - 1]), [ptr(m["ln_w"]), ptr(m["ln_b"]), ptr(m["b"])]
            C = phase.N
        elif phase.kind == "D":
            i = int(phase.where[1:])
            fin = [ptr(pw["final_ln_w"]), ptr(pw["final_ln_b"])] if i == 0 else [0, 0]
            mat, f = ptr(units["downs"][i]["w"]), factors[i]
            vecs = fin + [ptr(pw["downs"][i]["b"])]
            flags |= FL_FINAL_LN if i == 0 else 0
            C = phase.N
        elif phase.kind == "L":
            vecs = [ptr(pw["final_ln_w"]), ptr(pw["final_ln_b"])]
            flags |= FL_FINAL_LN | FL_TO_Z
        else:
            if phase.where.startswith("s"):
                i, bi = map(int, phase.where[1:].split("b"))
                sp, u = pw["stages"][i], units["stages"][i]
                slot = stage_off[1 + i] + bi * SLOT * C
            else:
                i, bi = int(phase.where[1:-1]), 0
                sp, u = pw["downs"][i]["blk"], units["downs"][i]
                slot = stage_off[-2] + i * SLOT * C
            if phase.kind == "P":
                mat = ptr(u["pw1"][bi])
                vecs = [ptr(sp[n][bi]) for n in ("dw_w", "dw_b", "ln_w", "ln_b", "pw1_b")]
            else:
                mat = ptr(u["pw2"][bi])
                vecs = [ptr(sp["pw2_b"][bi]), ptr(sp["gamma"][bi])]
                if p == len(ph) - 1:
                    flags |= FL_TO_Z
        vecs += [0] * (5 - len(vecs))
        tab += [mat, phase.K, phase.N, width, KINDS[phase.kind], int(slot), f, flags, *vecs]
    return tab


_KEPT: Dict[Tuple, Dict[str, torch.Tensor]] = {}


def kept_scratch(cfg: TokenizerConfig, device) -> Dict[str, torch.Tensor]:
    """The scratch that the kernel's calls at this geometry on `device`
    share (so calls on two streams must not overlap): the activation
    buffers `xa` and `xb` (rows x widest floats, the rows of `_rows`) and
    the hidden rows `g` (rows x 4 widest).  Every call writes each before
    it reads it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:  # tensors name their card
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (_geo_key(cfg), dev)
    if key not in _KEPT:
        n = _rows(key[0])[1] * widest(cfg)
        _KEPT[key] = {name: torch.empty(m * n, dtype=torch.float32, device=dev)
                      for name, m in (("xa", 1), ("xb", 1), ("g", 4))}
    return _KEPT[key]


@functools.lru_cache(maxsize=16)
def _plan_on(key: Tuple, n_blocks: int, device: torch.device) -> torch.Tensor:
    plan = _work_plan(key, n_blocks).reshape(n_blocks, -1)
    return torch.from_numpy(np.ascontiguousarray(plan)).to(device)


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_TABLES: Dict[Tuple, Tuple[Dict, Dict, torch.Tensor, np.ndarray]] = {}
_TABLES_MAX = 8


def _device_table(pw: Dict, units: Dict, cfg: TokenizerConfig,
                  dev: torch.device) -> Tuple[torch.Tensor, np.ndarray]:
    """The kernel's table for `pw` and its `units` on `dev`, checked and
    copied to the card at their first call, and a host int32 copy of each
    record's fields K .. flags (the narrow build's launch parameters): kept
    while `units` is the same dict with the same `pw` beside it (a tree is
    read as it was then; `params.Converter` makes a new one for new
    weights)."""
    key = (id(units), _geo_key(cfg), dev)
    hit = _TABLES.get(key)
    if hit is not None and hit[0] is pw and hit[1] is units:
        return hit[2], hit[3]
    for place, m, blocks in _matrices(pw):
        u = _unit_at(units, place)
        K, N = m.shape[0] // blocks, m.shape[1]
        if tuple(u.shape) != (blocks, -(-N // UNIT), K, UNIT) or u.dtype != m.dtype:
            raise ValueError(f"encoder_front_step: units{list(place)} is {u.dtype} "
                             f"{tuple(u.shape)}, not the unit_weights of pw")
    w = list(_tensors(pw)) + list(_tensors(units))
    wd = pw["stem_w"].dtype
    if wd not in _TYPES:
        raise ValueError(f"encoder_front_step: weights {wd}; the kernel takes float32 or "
                         "bfloat16")
    if check_cuda("encoder_front_step", {f"w{i}": t for i, t in enumerate(w)}, wd) != dev:
        raise ValueError(f"encoder_front_step: the weights are not on {dev}")
    while len(_TABLES) >= _TABLES_MAX:
        _TABLES.pop(next(iter(_TABLES)))
    host = _table(pw, units, cfg)
    ints = np.ascontiguousarray(
        np.array(host[2:], dtype=np.int64).reshape(-1, PHASE_FIELDS)[:, 1:8], dtype=np.int32)
    tab = torch.tensor(host, dtype=torch.int64).to(dev)
    _TABLES[key] = (pw, units, tab, ints)
    return tab, ints


def encoder_front_step(pw: Dict, state: PackedEncState, mel: torch.Tensor,
                       cfg: TokenizerConfig, units: Optional[Dict] = None
                       ) -> Tuple[PackedEncState, torch.Tensor]:
    """The fused front step: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Same arguments and results as
    `encoder_front_step_plain`, and for CUDA tensors `units`, the
    `unit_weights` of `pw`; the new state is a new tensor tree."""
    if mel.device.type == "cpu":
        return encoder_front_step_plain(pw, state, mel, cfg)
    return _launch(pw, state, mel, cfg, units, timeline=False)[:2]


def encoder_front_step_timeline(pw: Dict, state: PackedEncState, mel: torch.Tensor,
                                cfg: TokenizerConfig, units: Dict) -> torch.Tensor:
    """One launch of the kernel (arguments as `encoder_front_step`, CUDA
    tensors, at most `launch_frames` frames) that also records, per block,
    the card's global time in ns where it enters each phase, where its
    product starts (0 for a block that owns no columns of the phase) and
    where it leaves the phase: (phases, blocks, 3) int64, the phases as
    `phases` lists them."""
    if mel.shape[1] > launch_frames(cfg):
        raise ValueError(f"encoder_front_step_timeline: at most {launch_frames(cfg)} frames")
    return _launch(pw, state, mel, cfg, units, timeline=True)[2]


def _launch(pw, state, mel, cfg, units, timeline):
    key = _geo_key(cfg)
    cin, k, depths, _, cq, factors = key
    T0 = mel.shape[1]
    factor = math.prod(factors)
    if mel.ndim != 3 or mel.shape[0] != 1 or mel.shape[2] != cin or T0 % factor:
        raise ValueError(f"encoder_front_step: batch 1, mel (1, T0, {cin}) with T0 a "
                         f"multiple of {factor}; got {tuple(mel.shape)}")
    if len(pw["stages"]) != len(depths) or len(pw["downs"]) != len(factors):
        raise ValueError("encoder_front_step: one packed stage per depth, one packed "
                         "downsample per factor")
    if state.stem.shape[0] != 1:
        raise ValueError("encoder_front_step: batch 1")
    sd = state.stem.dtype
    if sd not in _TYPES:
        raise ValueError(f"encoder_front_step: state {sd}; the kernel takes float32 or "
                         "bfloat16")
    flat = _flat(state, cfg)
    dev = check_cuda("encoder_front_step", {"state": flat, "mel": mel.contiguous()})
    if units is None:
        raise ValueError("encoder_front_step: CUDA tensors need `units`, the unit_weights of "
                         "pw (params.Converter keeps them as tokenizer_params['enc_units'])")
    tab, ints = _device_table(pw, units, cfg, dev)
    wd = pw["stem_w"].dtype
    n_blocks = _sm_count(dev)
    _checked(key, n_blocks)
    sz = _sizes(key, n_blocks)
    plan = _plan_on(key, n_blocks, dev)
    kept = kept_scratch(cfg, dev)
    mel = mel.to(wd).float().contiguous()  # the frames as the TPU kernel takes them
    stamps = (torch.zeros((len(_phases(key)), n_blocks, 3), dtype=torch.int64, device=dev)
              if timeline else None)
    z = torch.empty((1, T0 // factor, cq), dtype=wd, device=dev)
    step = _rows(key)[0]
    for r0 in range(0, T0, step):
        T = min(step, T0 - r0)
        out = torch.empty_like(flat)
        rc = _build.load("convnext_enc")(
            tab.data_ptr(), ints.ctypes.data, 2, len(_phases(key)), flat.data_ptr(),
            out.data_ptr(), mel[0, r0].data_ptr(), z[0, r0 // factor].data_ptr(),
            kept["xa"].data_ptr(), kept["xb"].data_ptr(), kept["g"].data_ptr(),
            plan.data_ptr(), None if stamps is None else stamps.data_ptr(),
            barrier_count("enc", dev).data_ptr(), T, k, sz["rows"], sz["max_k"], sz["pre_c"],
            sz["ep_cols"], int(wd == torch.bfloat16), int(sd == torch.bfloat16), sz["wide"],
            n_blocks,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc == COOPERATIVE_TOO_LARGE:
            raise RuntimeError(f"encoder_front_step: a grid of {n_blocks} blocks, one per SM, "
                               "cannot be resident at once (cudaErrorCooperativeLaunchTooLarge)")
        if rc != 0:
            raise RuntimeError(f"encoder_front_step: CUDA launch failed with error {rc}")
        encoder_front_step.launches += 1
        flat = out
    return _views(flat, cfg), z, stamps


encoder_front_step.launches = 0
