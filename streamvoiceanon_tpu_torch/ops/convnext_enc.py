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
the downsample blocks.  `pack_enc_state` / `unpack_enc_state` convert to
and from the dict layout of `models/tokenizer_stream.py`, where batch > 1
runs.

What bounds the kernel on the card: bytes and latency.  At the published
width (stem 160 -> 128, blocks 3-3-9-3 at 128/256/384/512, two 512-wide
downsamples) one call reads about 99 MB of float32 weights, 0.030 ms at
3.35 TB/s, while its products over at most 4 rows (about 0.2 GFLOP) take
0.003 ms at 67 TFLOP/s.  Its 46 products depend on each other in
sequence, and each moves 0.1 to 4.2 MB, so a design of one launch each
pays a launch and a drain per product.

The design (csrc/convnext_enc.cu): one cooperative launch a call, one
block per SM (`encoder_front_step.launches` counts one a call of at most 4
frames).  The TPU kernel's program order becomes grid barriers between
the phases `phases` lists, 46 and 45 barriers at the published geometry:

    stem  im2col of [tail; mel], the stem product + bias
    P     a block's depthwise conv + bias + LN (the stem LN first in the
          first block of stage 0), pw1 + bias + GELU into g
    Q     g @ pw2 + bias, times gamma, plus x, in place (the last: into z)
    M     a transition: LN, then the 1x1 product + bias
    D     a downsample: (final LN,) the rows viewed as (T/f, f C) times
          the tap-major weight + bias

Every block reads a phase's whole input rows (at most 4 of at most 2048
floats) and recomputes the row-wise steps itself, one column a thread (so
rows are at most 512 wide); it then owns fixed runs of 16-byte column
units of the phase's product (`work_plan`, the rule of `column_plan` in
ops/decode_common.py) and sums each column of each row over the whole K
in a fixed order, every weight load serving all rows: no split-K
partials, no tickets, and the result does not depend on block timing.  The matrices are unit-packed once per parameter tree
(`unit_weights`, `tokenizer_params["enc_units"]`, made by
`params.Converter` beside `enc_packed`).  The barriers guard: stem -> P
the stem rows; P -> Q the whole g, and P's reads of x before Q writes its
columns in place; Q -> next phase the whole x, and Q's reads of g before
the next P writes it; M -> P and D -> P the product's rows, which go to
the other activation buffer because other blocks still read x in that
phase.  The activation buffers, g and the plan are kept across calls
(`kept_scratch`); the output state and z are new each call and the input
state is only read, so a call is one device launch.
`encoder_front_step_timeline` stamps each block's entry to each phase, the
start of its product and its exit with the card's global timer.  A chunk of more than 4 frames
runs as consecutive launches of at most 4 (the front is causal, so the
result is the same).

On the H100 a call takes about 0.25 ms against the parent design's 0.56
to 0.65 (PERF.md §6): 45 barriers of about 1 us, P phases of 5 to 7.5 us
(the rows' loads, the depthwise conv and two block reductions before the
product) and Q phases of 3 to 4.5 us.  Without any weight traffic the
same launch takes about 0.21 ms, so the skeleton of dependent steps, not
the weight stream, bounds it.

The plain version repeats the TPU kernel's arithmetic and rounding points
(after the depthwise conv + bias, after each LN, after each pointwise +
bias, after GELU, after the LayerScale product).  GELU is exact erf: the
TPU kernel's polynomial erf exists only because Mosaic cannot lower
`lax.erf`.
"""

from __future__ import annotations

import ctypes
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
    bb = cfg.backbone
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return PackedEncState(
        stem=z(batch, SLOT, bb.input_channels),
        stages=tuple(z(batch, d * SLOT, c) for d, c in zip(bb.depths, bb.dims)),
        down=z(batch, len(cfg.quantizer.downsample_factor) * SLOT, cfg.quantizer.input_dim),
    )


def _put_slots(B: int, C: int, tails: List[torch.Tensor], dtype, device) -> torch.Tensor:
    buf = torch.zeros((B, len(tails) * SLOT, C), dtype=dtype, device=device)
    for i, t in enumerate(tails):
        buf[:, i * SLOT : i * SLOT + t.shape[1]] = t.to(dtype)
    return buf


def pack_enc_state(backbone_state: Dict, down_states, cfg: TokenizerConfig) -> PackedEncState:
    """Dict layout (`models/tokenizer_stream.py`) -> packed.  `down_states` is
    the TokenizerStreamState.down tuple ({"conv": ConvState, "block":
    ConvState})."""
    stem = backbone_state["stem"].tail
    B, dtype, dev = stem.shape[0], stem.dtype, stem.device
    stages = tuple(
        _put_slots(B, c, [st.tail for st in backbone_state["stages"][i]], dtype, dev)
        for i, c in enumerate(cfg.backbone.dims))
    down = _put_slots(B, cfg.quantizer.input_dim, [st["block"].tail for st in down_states],
                      dtype, dev)
    return PackedEncState(_put_slots(B, stem.shape[2], [stem], dtype, dev), stages, down)


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
    full = torch.cat([tail[: k - 1].to(dt), x])
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
    full = torch.cat([stem_tail[: k - 1].to(dt), x])
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

ROWS = 4  # rows of one launch, at most (ROWS in csrc/convnext_enc.cu)
UNIT = 4  # float32 columns of one 16-byte plan unit
THREADS = 512  # PK_THREADS (csrc/decode_common.cuh): the widest row, one column a thread
MAX_STAGES, MAX_DOWN, MAX_PHASES = 8, 4, 96
EPILOGUE_INPUTS = 2 + ROWS  # a column's bias, LayerScale and residual rows (EPV)


class Phase(NamedTuple):
    """One phase of the kernel: its kind ("stem", "P", "Q", "M" for a
    transition, "D" for a downsample), where it runs ("s2b4": stage 2 block
    4; "m1": the transition into stage 1; "d0": downsample 0, "d0b" its
    block) and its product's K and N."""

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
    return tuple(out)


def phases(cfg: TokenizerConfig) -> List[Phase]:
    """The kernel's phases in order; a grid barrier between each two."""
    return list(_phases(_geo_key(cfg)))


@functools.lru_cache(maxsize=16)
def _work_plan(key: Tuple, n_blocks: int) -> np.ndarray:
    ph = _phases(key)
    return column_plan([p.N // UNIT for p in ph], [p.K * 16 for p in ph], n_blocks)


def work_plan(cfg: TokenizerConfig, n_blocks: int) -> np.ndarray:
    """(n_blocks, phases, 2) int32: per block and phase of `phases`, the
    first column unit it owns and how many, a contiguous run."""
    return _work_plan(_geo_key(cfg), n_blocks)


def widest(cfg: TokenizerConfig) -> int:
    return max(*cfg.backbone.dims, cfg.quantizer.input_dim)


def check_kernel_geometry(cfg: TokenizerConfig) -> None:
    """Raise on a geometry the kernel does not take."""
    _checked(_geo_key(cfg))


@functools.lru_cache(maxsize=16)
def _checked(key: Tuple) -> bool:
    cin, k, depths, dims, cq, factors = key
    wide = max(*dims, cq)
    smem = 4 * (ROWS * max(p.K for p in _phases(key)) + EPILOGUE_INPUTS * THREADS)
    if (not 1 <= len(depths) <= MAX_STAGES or not 1 <= len(factors) <= MAX_DOWN
            or min(depths) < 1 or any(c % UNIT for c in (*dims, cq))
            or max(wide, cin) > THREADS or math.prod(factors) > ROWS or k > SLOT + 1
            or len(_phases(key)) > MAX_PHASES or smem > MAX_SMEM):
        raise ValueError(f"encoder_front_step: unsupported geometry (C_in {cin}, depths "
                         f"{depths}, dims {dims}, C_q {cq}, downsample {factors}): every "
                         f"stage at least one block, widths multiples of {UNIT} and at most "
                         f"{THREADS}, prod(downsample) <= {ROWS}")
    return True


@functools.lru_cache(maxsize=32)
def _geometry(key: Tuple, T: int) -> ctypes.Array:
    """The `geo` int array of csrc/convnext_enc.cu: an 8-int header (T,
    C_in, k, stages, downsamples, C_q, phases, widest), then (depth, C) per
    stage, then the factor per downsample."""
    cin, k, depths, dims, cq, factors = key
    geo = [T, cin, k, len(depths), len(factors), cq, len(_phases(key)), max(*dims, cq)]
    for d, c in zip(depths, dims):
        geo += [d, c]
    geo += list(factors)
    return (ctypes.c_int * len(geo))(*geo)


def _to_units(w: torch.Tensor, blocks: int = 1) -> torch.Tensor:
    """w (blocks * K, N), `blocks` matrices stacked by rows -> (blocks, N /
    UNIT, K, UNIT): each unit's column slice contiguous over the whole K."""
    K, N = w.shape[0] // blocks, w.shape[1]
    return w.reshape(blocks, K, N // UNIT, UNIT).transpose(1, 2).contiguous()


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
    "pw2"}], "mids": [w], "downs": [{"w", "pw1", "pw2"}]}, each (blocks, N /
    4, K, 4)."""
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


def _weight_list(pw: Dict, u: Dict) -> List[torch.Tensor]:
    """The kernel's weights in the order of csrc/convnext_enc.cu `w`: the
    matrices from the unit-packed `u`, the rest from `pw`."""
    w = [u["stem_w"], pw["stem_b"], pw["stem_ln_w"], pw["stem_ln_b"]]
    block = lambda sp, su: [sp["dw_w"], sp["dw_b"], sp["ln_w"], sp["ln_b"], su["pw1"],
                            sp["pw1_b"], su["pw2"], sp["pw2_b"], sp["gamma"]]
    for sp, su in zip(pw["stages"], u["stages"]):
        w += block(sp, su)
    for m, mu in zip(pw["mids"], u["mids"]):
        w += [m["ln_w"], m["ln_b"], mu, m["b"]]
    w += [pw["final_ln_w"], pw["final_ln_b"]]
    for dp, du in zip(pw["downs"], u["downs"]):
        w += [du["w"], dp["b"], *block(dp["blk"], du)]
    return w


_KEPT: Dict[Tuple, Dict[str, torch.Tensor]] = {}


def kept_scratch(cfg: TokenizerConfig, device) -> Dict[str, torch.Tensor]:
    """The scratch that the kernel's calls at this geometry on `device`
    share (so calls on two streams must not overlap): the activation
    buffers `xa` and `xb` (ROWS x widest floats) and the hidden rows `g`
    (ROWS x 4 widest).  Every call writes each before it reads it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:  # tensors name their card
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (_geo_key(cfg), dev)
    if key not in _KEPT:
        n = ROWS * widest(cfg)
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


_WEIGHTS: Dict[int, Tuple[Dict, Dict, ctypes.Array]] = {}
_WEIGHTS_MAX = 8


def _weight_pointers(pw: Dict, units: Dict, dev: torch.device) -> ctypes.Array:
    """The kernel's weight pointers for `pw` and its `units`, checked at
    their first call: kept while `units` is the same dict with the same
    `pw` beside it (a tree is read as it was then; `params.Converter` makes
    a new one for new weights)."""
    hit = _WEIGHTS.get(id(units))
    if hit is not None and hit[0] is pw and hit[1] is units:
        return hit[2]
    for place, m, blocks in _matrices(pw):
        u = _unit_at(units, place)
        K, N = m.shape[0] // blocks, m.shape[1]
        if tuple(u.shape) != (blocks, N // UNIT, K, UNIT):
            raise ValueError(f"encoder_front_step: units{list(place)} has shape "
                             f"{tuple(u.shape)}, not the unit_weights of pw")
    w = _weight_list(pw, units)
    if check_cuda("encoder_front_step", {f"w{i}": t for i, t in enumerate(w)},
                  torch.float32) != dev:
        raise ValueError(f"encoder_front_step: the weights are not on {dev}")
    while len(_WEIGHTS) >= _WEIGHTS_MAX:
        _WEIGHTS.pop(next(iter(_WEIGHTS)))
    arr = (ctypes.c_void_p * len(w))(*[t.data_ptr() for t in w])
    _WEIGHTS[id(units)] = (pw, units, arr)
    return arr


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
    tensors, at most 4 frames) that also records, per block, the card's
    global time in ns where it enters each phase, where its product starts
    (0 for a block that owns no columns of the phase) and where it leaves
    the phase: (phases, blocks, 3) int64, the phases as `phases` lists
    them."""
    if mel.shape[1] > ROWS:
        raise ValueError(f"encoder_front_step_timeline: at most {ROWS} frames")
    return _launch(pw, state, mel, cfg, units, timeline=True)[2]


def _launch(pw, state, mel, cfg, units, timeline):
    key = _geo_key(cfg)
    cin, _, depths, _, cq, factors = key
    T0 = mel.shape[1]
    factor = math.prod(factors)
    if mel.ndim != 3 or mel.shape[0] != 1 or mel.shape[2] != cin or T0 % factor:
        raise ValueError(f"encoder_front_step: batch 1, mel (1, T0, {cin}) with T0 a "
                         f"multiple of {factor}; got {tuple(mel.shape)}")
    if len(pw["stages"]) != len(depths) or len(pw["downs"]) != len(factors):
        raise ValueError("encoder_front_step: one packed stage per depth, one packed "
                         "downsample per factor")
    _checked(key)
    mel = mel.contiguous()
    st_in = [state.stem, *state.stages, state.down]
    named = {f"state{i}": t for i, t in enumerate(st_in)}
    named["mel"] = mel
    dev = check_cuda("encoder_front_step", named, torch.float32)
    if state.stem.shape[0] != 1:
        raise ValueError("encoder_front_step: batch 1")
    if units is None:
        raise ValueError("encoder_front_step: CUDA tensors need `units`, the unit_weights of "
                         "pw (params.Converter keeps them as tokenizer_params['enc_units'])")
    w_c = _weight_pointers(pw, units, dev)
    n_blocks = _sm_count(dev)
    plan = _plan_on(key, n_blocks, dev)
    kept = kept_scratch(cfg, dev)
    arr = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    stamps = (torch.zeros((len(_phases(key)), n_blocks, 3), dtype=torch.int64, device=dev)
              if timeline else None)
    z = torch.empty((1, T0 // factor, cq), dtype=torch.float32, device=dev)
    step = ROWS // factor * factor
    for r0 in range(0, T0, step):
        T = min(step, T0 - r0)
        st_out = [torch.empty_like(t) for t in st_in]
        geo_c = _geometry(key, T)
        in_c, out_c = arr(st_in), arr(st_out)
        rc = _build.load("convnext_enc")(
            ctypes.addressof(geo_c), len(geo_c), ctypes.addressof(w_c), len(w_c),
            ctypes.addressof(in_c), ctypes.addressof(out_c), mel[0, r0].data_ptr(),
            z[0, r0 // factor].data_ptr(), kept["xa"].data_ptr(), kept["xb"].data_ptr(),
            kept["g"].data_ptr(), plan.data_ptr(),
            None if stamps is None else stamps.data_ptr(),
            barrier_count("enc", dev).data_ptr(), n_blocks,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc == COOPERATIVE_TOO_LARGE:
            raise RuntimeError(f"encoder_front_step: a grid of {n_blocks} blocks, one per SM, "
                               "cannot be resident at once (cudaErrorCooperativeLaunchTooLarge)")
        if rc != 0:
            raise RuntimeError(f"encoder_front_step: CUDA launch failed with error {rc}")
        encoder_front_step.launches += 1
        st_in = st_out
    new = PackedEncState(st_in[0], tuple(st_in[1 : 1 + len(depths)]), st_in[-1])
    return new, z, stamps


encoder_front_step.launches = 0
