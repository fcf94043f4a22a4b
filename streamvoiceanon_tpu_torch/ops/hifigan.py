"""The streaming HiFiGAN head in one call: packed state, plain version, CUDA
kernel wrapper.

Replaces the TPU kernel `head_stream_step` (`_make_kernel`) of the JAX
package's ops/pallas_hifigan.py.  One call runs the whole head on T0 new
frames at batch 1: conv_pre -> per stage [SiLU -> transposed upsample
(k = 2 * stride) -> mean of the ResBlock branches] -> SiLU -> conv_post ->
tanh, about a hundred small causal convs.  Every conv's input tail lives in
`PackedHeadState`: per stage one (8, C_in) upsample buffer (row 0 used) and
one (RES_ROWS, C_out) buffer of ResBlock tails at 8-row-aligned offsets
(`res_slots`), plus the conv_pre and conv_post tails.  `pack_head_state` /
`unpack_head_state` convert to and from the dict-of-tails layout of
`models/hifigan.py` (the batch > 1 path runs there).

What bounds the kernel on the card: operations.  At the published width
and T0 = 4 one call does about 2.6 GFLOP in float32 (the stage-1 ResBlocks,
256 rows x 128 channels, are the largest part) against 67 TFLOP/s of the
CUDA cores, and reads about 68 MB of weights (half of it the stage-0
ResBlocks at 32 rows) against 3.35 TB/s: 0.039 ms against 0.020 ms.

What the design does about it (csrc/hifigan_head.cu): one launch per
dependency level, 37 at the published geometry for 97 convs, planned here
(`level_plan`, `_geometry`) and handed to the kernel as plain integers:
conv_pre; per stage the upsample, then six rounds, round r running conv
r % 2 of dilation r // 2 of all three ResBlock branches side by side (each
branch with its own first-conv buffer and running residual); conv_post.
A round of more than MAX_CONV (4) branches runs as several launches.  The
branch mean moves into its consumer: the next upsample and conv_post
compute ((D_0 + D_1) + D_2) / 3 as they load a row, then SiLU (the first
MAX_CONV D_b loaded ahead; any more read as the row is stored, by the
kernel's WIDE instantiations, which only such levels launch).  A level's
blocks walk its work list (per conv, per output tile, per K split), one
implicit-GEMM conv tile each, full float32 on the CUDA cores (TF32 would
miss the 1e-3 check), the dilated taps read straight from [tail; x], the
next K-chunk's raw loads in flight while the current one is multiplied,
bias, residual and tanh in the epilogue.  Each level takes the tile of
`TILES` with the least padding (`level_tile`): 16 or 32 rows where T is 4
or 32, 32 columns where C_out is 16 or 32.  The upsample is the same conv
with two taps: its row-major (T, s*C_out) result is the de-interleaved
(T*s, C_out) output.  K splits aim at one wave of blocks a level
(`TARGET_BLOCKS`), one split length for the whole level so that blocks do
equal work; the last block of a tile to take its ticket sums the partials
in split order and runs the epilogue, so no second launch is needed and
the result does not depend on block timing.  Levels are chained by
programmatic dependent launch: a block loads its first weights, then waits
for the level before it, which guards every activation, partial, ticket
and tail that consecutive levels share.  The scratch (activation buffers,
partials, tickets) and the ctypes `geo` array are kept across calls
(`kept_scratch`).  Not yet done: the tile loop is bound by instruction
issue (a few us a K-chunk at three blocks a SM), the levels still pay a
launch and a drain each, and nothing uses the tensor cores.

The plain version repeats the TPU kernel's arithmetic: each conv
accumulates in float32, adds the bias in float32 and rounds once; SiLU and
tanh run in float32; the branches are averaged in float32.  Dtypes as the
TPU kernel takes them: the weights W and the state tails S as given, mixed
or not; the input rows rounded to W; the activations in promote(W, S),
rounded there after each conv, residual sum, branch mean and SiLU; the
tails stored as S; the waveform as W.  The kernel keeps its activation
buffers in float32 and rounds their values to bf16 at those points when W
and S are both bf16.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, NamedTuple, Tuple

import torch

from streamvoiceanon_tpu_torch.config import HiFiGANConfig
from streamvoiceanon_tpu_torch.ops import _build
from streamvoiceanon_tpu_torch.ops.conv import ConvState, TransConvState
from streamvoiceanon_tpu_torch.ops.decode_common import check_cuda

# the kernel's tiles and launch plan (csrc/hifigan_head.cu)
TILES = ((16, 64), (32, 64), (64, 64), (64, 32))  # (rows, columns) of a block's tile
PART = 4096  # floats of split partial a block: the largest tile
KC = 16  # K rows a chunk
TARGET_BLOCKS = 396  # blocks a level: one wave, MIN_BLOCKS (3) a SM on 132 SMs
MAX_CONV = 4  # convs a launch; more ResBlock branches run a round in several launches
HDR = 5  # header ints of `geo`
LVL = 3  # ints before a level's records: conv count, tile rows, tile columns
# one conv's record in `geo`, in order (the `Field` enum of the CUDA source)
CONV_FIELDS = ("x", "x_n", "silu", "T", "cin", "k", "d", "n", "w", "w_off", "w2", "b",
               "b_off", "bias_mod", "resid", "out", "tanh", "tail", "tail_off", "rows",
               "rows_pad", "tiles_m", "tiles_n", "ksplit", "per")
# buffer ids in a record: the call's input, its waveform, then the scratch
# buffers A, B, C_0.., D_0..
BUF_X, BUF_WAV, BUF_FIRST = 0, 1, 2
_TYPES = (torch.float32, torch.bfloat16)  # of the weights and of the state, each


def _pad8(n: int) -> int:
    return (n + 7) // 8 * 8


def _silu(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf / (1.0 + torch.exp(-xf))).to(x.dtype)


# ---------------------------------------------------------------------------
# Geometry: traversal order and packed-tail offsets
# ---------------------------------------------------------------------------


def res_slots(cfg: HiFiGANConfig) -> List[Tuple[int, int, int, int]]:
    """Per-stage ResBlock conv slots in traversal order [(k, d, rows,
    offset), ...]: conv1 then conv2 per dilation, dilations inner, kernel
    sizes outer (models/hifigan.resblock_apply_stream)."""
    if any(tuple(d) != tuple(cfg.resblock_dilation_sizes[0])
           for d in cfg.resblock_dilation_sizes):
        raise NotImplementedError(
            "the fused HiFiGAN head requires uniform resblock_dilation_sizes")
    slots = []
    off = 0
    for k in cfg.resblock_kernel_sizes:
        for d in cfg.resblock_dilation_sizes[0]:
            for _ in range(2):  # convs1[di], convs2[di]
                rows = (k - 1) * d
                slots.append((k, d, rows, off))
                off += _pad8(rows)
    return slots


def res_rows(cfg: HiFiGANConfig) -> int:
    k, d, rows, off = res_slots(cfg)[-1]
    return off + _pad8(rows)


def stage_channels(cfg: HiFiGANConfig) -> List[Tuple[int, int]]:
    """(C_in, C_out) per upsample stage."""
    c = cfg.upsample_initial_channel
    return [(c // 2 ** i, c // 2 ** (i + 1)) for i in range(len(cfg.upsample_rates))]


class PackedHeadState(NamedTuple):
    """Packed streaming state of the fused head (B leading on every leaf)."""

    pre: torch.Tensor  # (B, pad8(k_pre - 1), num_mels)
    ups: Tuple[torch.Tensor, ...]  # per stage (B, 8, C_in), row 0 used
    res: Tuple[torch.Tensor, ...]  # per stage (B, RES_ROWS, C_out)
    post: torch.Tensor  # (B, pad8(k_post - 1), C_last)


def init_packed_state(cfg: HiFiGANConfig, batch: int = 1, dtype=torch.float32,
                      device=None) -> PackedHeadState:
    chans = stage_channels(cfg)
    rows = res_rows(cfg)
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return PackedHeadState(
        pre=z(batch, _pad8(cfg.pre_conv_kernel_size - 1), cfg.num_mels),
        ups=tuple(z(batch, 8, ci) for ci, _ in chans),
        res=tuple(z(batch, rows, co) for _, co in chans),
        post=z(batch, _pad8(cfg.post_conv_kernel_size - 1), chans[-1][1]),
    )


def _pad_rows(t: torch.Tensor, target: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, 0, 0, target - t.shape[1]))


def pack_head_state(state: Dict, cfg: HiFiGANConfig) -> PackedHeadState:
    """dict of tails (models/hifigan.hifigan_init_stream layout) -> packed."""
    pre = state["conv_pre"].tail
    B, dtype, dev = pre.shape[0], pre.dtype, pre.device
    slots = res_slots(cfg)
    ups, res = [], []
    for i, (ci, co) in enumerate(stage_channels(cfg)):
        ups.append(_pad_rows(state["ups"][i].tail, 8))
        buf = torch.zeros((B, res_rows(cfg), co), dtype=dtype, device=dev)
        si = iter(slots)
        for blk, rd in zip(state["res"][i], cfg.resblock_dilation_sizes):
            for di in range(len(rd)):
                for cs in (blk["convs1"][di], blk["convs2"][di]):
                    k, d, rows, off = next(si)
                    buf[:, off : off + rows] = cs.tail.to(dtype)
        res.append(buf)
    return PackedHeadState(
        pre=_pad_rows(pre, _pad8(cfg.pre_conv_kernel_size - 1)),
        ups=tuple(ups), res=tuple(res),
        post=_pad_rows(state["conv_post"].tail, _pad8(cfg.post_conv_kernel_size - 1)),
    )


def unpack_head_state(packed: PackedHeadState, cfg: HiFiGANConfig) -> Dict:
    """packed -> dict of tails (ConvState / TransConvState leaves)."""
    slots = res_slots(cfg)
    state: Dict = {
        "conv_pre": ConvState(packed.pre[:, : cfg.pre_conv_kernel_size - 1]),
        "ups": [], "res": [],
    }
    for i in range(len(cfg.upsample_rates)):
        state["ups"].append(TransConvState(packed.ups[i][:, :1]))
        si = iter(slots)
        blocks = []
        for rd in cfg.resblock_dilation_sizes:
            blk = {"convs1": [], "convs2": []}
            for _ in rd:
                for name in ("convs1", "convs2"):
                    k, d, rows, off = next(si)
                    blk[name].append(ConvState(packed.res[i][:, off : off + rows]))
            blocks.append(blk)
        state["res"].append(blocks)
    state["conv_post"] = ConvState(packed.post[:, : cfg.post_conv_kernel_size - 1])
    return state


# ---------------------------------------------------------------------------
# Weight packing (once per parameter tree: params.Converter)
# ---------------------------------------------------------------------------


def _conv_rows(cp: Dict) -> torch.Tensor:
    """Conv1d weight (C_out, C_in, k) -> (k * C_in, C_out), tap-major rows."""
    co, ci, k = cp["w"].shape
    return cp["w"].permute(2, 1, 0).reshape(k * ci, co).contiguous()


def packed_weights(p: Dict, cfg: HiFiGANConfig) -> Dict:
    """The head's weights in the kernel's layouts (the JAX package's
    `packed_weights`, from the port's PyTorch conv layouts): conv weights
    (k * C_in, C_out); per stage the upsample's two taps wa = W[s:] and
    wb = W[:s] as (C_in, s * C_out), its bias (1, C_out), the ResBlock conv
    weights stacked in slot order and their biases (n_conv, C_out)."""
    stages = []
    for i, (s, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        if k != 2 * s:
            raise NotImplementedError("the fused HiFiGAN head requires k == 2 * stride")
        w = p["ups"][i]["w"]  # (C_in, C_out, 2s)
        ci, co, _ = w.shape
        tap = lambda t: t.permute(0, 2, 1).reshape(ci, s * co).contiguous()
        rws, rbs = [], []
        for blk, rd in zip(p["resblocks"][i], cfg.resblock_dilation_sizes):
            for di in range(len(rd)):
                for cp in (blk["convs1"][di], blk["convs2"][di]):
                    rws.append(_conv_rows(cp))
                    rbs.append(cp["b"][None])
        stages.append({"wa": tap(w[:, :, s:]), "wb": tap(w[:, :, :s]),
                       "ub": p["ups"][i]["b"][None].contiguous(),
                       "rw": torch.cat(rws, dim=0), "rb": torch.cat(rbs, dim=0)})
    return {
        "pre_w": _conv_rows(p["conv_pre"]), "pre_b": p["conv_pre"]["b"][None].contiguous(),
        "stages": stages,
        "post_w": _conv_rows(p["conv_post"]), "post_b": p["conv_post"]["b"][None].contiguous(),
    }


# ---------------------------------------------------------------------------
# Plain version and kernel wrapper
# ---------------------------------------------------------------------------


def _conv(full: torch.Tensor, T: int, k: int, d: int, w_rows: torch.Tensor,
          b_row: torch.Tensor) -> torch.Tensor:
    """Causal dilated conv of the rows [tail; x] = full: float32 accumulate,
    float32 bias add, round once."""
    cols = torch.cat([full[j * d : j * d + T] for j in range(k)], dim=1)
    y = cols.float() @ w_rows.float() + b_row.float()
    return y.to(full.dtype)


def head_stream_step_plain(pw: Dict, state: PackedHeadState, x: torch.Tensor,
                           cfg: HiFiGANConfig) -> Tuple[PackedHeadState, torch.Tensor]:
    """One streaming head step at batch 1: x (1, T0, num_mels) ->
    (state', wav (1, T0 * prod(rates)))."""
    slots = res_slots(cfg)
    k_pre, k_post = cfg.pre_conv_kernel_size, cfg.post_conv_kernel_size
    T = x.shape[1]
    wd, sd = pw["pre_w"].dtype, state.pre.dtype
    dtype = torch.promote_types(wd, sd)  # the TPU kernel's concatenations promote

    pre_tail = state.pre[0]
    full = torch.cat([pre_tail[: k_pre - 1].to(dtype), x[0].to(wd).to(dtype)], dim=0)
    pre_out = torch.cat([full[T : T + k_pre - 1].to(sd), pre_tail[k_pre - 1 :]], dim=0)
    h = _conv(full, T, k_pre, 1, pw["pre_w"], pw["pre_b"])

    ups_out, res_out = [], []
    for i, s in enumerate(cfg.upsample_rates):
        st = pw["stages"][i]
        up_tail, res_tail = state.ups[i][0], state.res[i][0]
        co = st["wa"].shape[1] // s
        full = torch.cat([up_tail[:1].to(dtype), _silu(h)], dim=0)  # (T + 1, C_in)
        ups_out.append(torch.cat([full[T : T + 1].to(sd), up_tail[1:]], dim=0))
        y = full[:T].float() @ st["wa"].float() + full[1 : T + 1].float() @ st["wb"].float()
        T = T * s
        # row-major (T, s * C_out) is the de-interleaved (T * s, C_out)
        h = (y.reshape(T, co) + st["ub"].float()).to(dtype)

        new_res = res_tail.clone()
        si, woff, branches = 0, 0, []
        for _k in cfg.resblock_kernel_sizes:
            xr = h
            for _d in cfg.resblock_dilation_sizes[0]:
                hc = xr
                for _conv_i in range(2):
                    k, d, rows, off = slots[si]
                    fullc = torch.cat([res_tail[off : off + rows].to(dtype), _silu(hc)],
                                      dim=0)
                    new_res[off : off + rows] = fullc[T : T + rows]
                    hc = _conv(fullc, T, k, d, st["rw"][woff : woff + k * co],
                               st["rb"][si : si + 1])
                    woff += k * co
                    si += 1
                xr = xr + hc
            branches.append(xr)
        acc = branches[0].float()
        for brn in branches[1:]:
            acc = acc + brn.float()
        h = (acc / float(len(branches))).to(dtype)
        res_out.append(new_res)

    post_tail = state.post[0]
    full = torch.cat([post_tail[: k_post - 1].to(dtype), _silu(h)], dim=0)
    post_out = torch.cat([full[T : T + k_post - 1].to(sd), post_tail[k_post - 1 :]], dim=0)
    y = _conv(full, T, k_post, 1, pw["post_w"], pw["post_b"])
    wav = torch.tanh(y.float()).to(wd)[:, 0][None]
    new = PackedHeadState(pre_out[None], tuple(u[None] for u in ups_out),
                          tuple(r[None] for r in res_out), post_out[None])
    return new, wav


def _record(**f) -> Dict[str, int]:
    return {**dict.fromkeys(CONV_FIELDS, 0), "x_n": 1, "d": 1, "w2": -1, "resid": -1, **f}


def level_plan(cfg: HiFiGANConfig, T0: int) -> List[List[Dict[str, int]]]:
    """The kernel's launches, one per dependency level, each a list of conv
    records (`CONV_FIELDS`): conv_pre; per stage the upsample, then round r
    of 2 x dilations, conv r % 2 of dilation r // 2 of every ResBlock
    branch; conv_post.  Buffers: A (conv_pre's output), B (the upsample's),
    per branch C_b (its first conv's output) and D_b (its running residual,
    at the end its output); a stage's input after the first, and conv_post's,
    is the mean of the D_b.  A round of more than MAX_CONV branches runs
    as several launches of at most MAX_CONV convs each (its branches do not
    read each other's buffers).  Every conv's K is split by `_split`."""
    n_stage = len(cfg.upsample_rates)
    nb = len(cfg.resblock_kernel_sizes)
    n_dil = len(cfg.resblock_dilation_sizes[0])
    slots = res_slots(cfg)
    A, B = BUF_FIRST, BUF_FIRST + 1
    C = [BUF_FIRST + 2 + b for b in range(nb)]
    D = [BUF_FIRST + 2 + nb + b for b in range(nb)]
    k_pre, k_post, C0 = cfg.pre_conv_kernel_size, cfg.post_conv_kernel_size, \
        cfg.upsample_initial_channel
    levels = [[_record(x=BUF_X, T=T0, cin=cfg.num_mels, k=k_pre, n=C0, w=0, b=1,
                     bias_mod=C0, out=A, tail=0, rows=k_pre - 1,
                     rows_pad=_pad8(k_pre - 1))]]
    T = T0
    for i, (s, (ci, co)) in enumerate(zip(cfg.upsample_rates, stage_channels(cfg))):
        levels.append([_record(x=A if i == 0 else D[0], x_n=1 if i == 0 else nb, silu=1, T=T,
                             cin=ci, k=2, n=s * co, w=2 + 5 * i, w2=3 + 5 * i, b=4 + 5 * i,
                             bias_mod=co, out=B, tail=1 + 2 * i, rows=1, rows_pad=8)])
        T *= s
        wrow = [0]
        for k, _, _, _ in slots:
            wrow.append(wrow[-1] + k * co)
        for r in range(2 * n_dil):
            di, cv = divmod(r, 2)
            level = []
            for br in range(nb):
                si = br * 2 * n_dil + r
                k, d, rows, off = slots[si]
                xr = B if di == 0 else D[br]
                level.append(_record(
                    x=xr if cv == 0 else C[br], silu=1, T=T, cin=co, k=k, d=d, n=co,
                    w=5 + 5 * i, w_off=wrow[si] * co, b=6 + 5 * i, b_off=si * co, bias_mod=co,
                    resid=-1 if cv == 0 else xr, out=C[br] if cv == 0 else D[br],
                    tail=2 + 2 * i, tail_off=off * co, rows=rows, rows_pad=_pad8(rows)))
            levels += [level[j : j + MAX_CONV] for j in range(0, nb, MAX_CONV)]
    c_last = stage_channels(cfg)[-1][1]
    levels.append([_record(x=D[0], x_n=nb, silu=1, T=T, cin=c_last, k=k_post, n=1,
                         w=2 + 5 * n_stage, b=3 + 5 * n_stage, bias_mod=1, out=BUF_WAV,
                         tanh=1, tail=1 + 2 * n_stage, rows=k_post - 1,
                         rows_pad=_pad8(k_post - 1))])
    for level in levels:
        _split(level)
    return levels


def level_tile(level: List[Dict[str, int]]) -> Tuple[int, int]:
    """The level's tile: the least padded output, then the largest tile
    (`TILES` in order on a tie).  Every conv of a level has one shape."""
    T, N = level[0]["T"], level[0]["n"]
    assert all((c["T"], c["n"]) == (T, N) for c in level)
    pad = lambda tm, tn: -(-T // tm) * tm * -(-N // tn) * tn
    return min(TILES, key=lambda t: (pad(*t), -t[0] * t[1]))


def _split(level: List[Dict[str, int]]) -> None:
    """Tiles and K splits of one level: one chunk count a split (`per`) for
    the whole level, the least that keeps the level within about
    TARGET_BLOCKS blocks, so that every block does about the same work."""
    tm, tn = level_tile(level)
    for c in level:
        c["tiles_m"], c["tiles_n"] = -(-c["T"] // tm), -(-c["n"] // tn)
    nch = [-(-c["k"] * c["cin"] // KC) for c in level]
    work = sum(c["tiles_m"] * c["tiles_n"] * n for c, n in zip(level, nch))
    per = -(-work // TARGET_BLOCKS)
    for c, n in zip(level, nch):
        c["per"] = min(per, n)
        c["ksplit"] = -(-n // c["per"])


def level_blocks(level: List[Dict[str, int]]) -> int:
    return sum(c["tiles_m"] * c["tiles_n"] * c["ksplit"] for c in level)


@functools.lru_cache(maxsize=None)
def _geometry(cfg: HiFiGANConfig, T0: int) -> Tuple[int, ...]:
    """The `geo` int array of csrc/hifigan_head.cu: the header (levels,
    scratch buffers, their size, partial floats, tickets), then per level
    its conv count and tile (LVL ints) and each conv's record
    (`CONV_FIELDS`)."""
    levels = level_plan(cfg, T0)
    nb = len(cfg.resblock_kernel_sizes)
    convs = [c for level in levels for c in level]
    buf_elems = max(c["T"] * c["n"] for c in convs if c["out"] != BUF_WAV)
    part_elems = max(level_blocks(level) for level in levels) * PART
    n_ticket = max(sum(c["tiles_m"] * c["tiles_n"] for c in level) for level in levels)
    geo = [len(levels), 2 + 2 * nb, buf_elems, part_elems, n_ticket]
    for level in levels:
        geo += [len(level), *level_tile(level)]
        for c in level:
            geo += [c[f] for f in CONV_FIELDS]
    return tuple(geo)


def device_launches(cfg: HiFiGANConfig, T0: int) -> int:
    """Device launches of one kernel call: one per level."""
    return _geometry(cfg, T0)[0]


_kept: Dict = {}


def kept_scratch(cfg: HiFiGANConfig, T0: int, device) -> Tuple[torch.Tensor, int]:
    """The scratch that the kernel's calls at this geometry on `device`
    share (so calls on two streams must not overlap), and how many of its
    leading floats are activations and split partials; the int tickets
    after them are zero between launches."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:  # tensors name their card
        dev = torch.device("cuda", torch.cuda.current_device())
    return _kept_plan(cfg, T0, dev)[2:]


def _kept_plan(cfg: HiFiGANConfig, T0: int, dev: torch.device):
    key = (cfg, T0, dev)
    if key not in _kept:
        geo = _geometry(cfg, T0)
        n_level, n_buf, buf_elems, part_elems, n_ticket = geo[:HDR]
        floats = n_buf * buf_elems + part_elems
        _kept[key] = ((ctypes.c_int * len(geo))(*geo), len(geo),
                      torch.zeros(floats + n_ticket, dtype=torch.float32, device=dev), floats)
    return _kept[key]


def head_stream_step(pw: Dict, state: PackedHeadState, x: torch.Tensor,
                     cfg: HiFiGANConfig) -> Tuple[PackedHeadState, torch.Tensor]:
    """The fused head step: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Same arguments and results as
    `head_stream_step_plain`; the new state is a new tensor tree."""
    if x.device.type == "cpu":
        return head_stream_step_plain(pw, state, x, cfg)
    return _launch(pw, state, x, cfg, timeline=False)[:2]


def head_stream_step_timeline(pw: Dict, state: PackedHeadState, x: torch.Tensor,
                              cfg: HiFiGANConfig) -> torch.Tensor:
    """One call of the kernel (arguments as `head_stream_step`, CUDA
    tensors) that also records each block's global time in ns where it
    starts, starts its K loop, ends it and exits: (levels, blocks, 4) int64,
    zero past a level's blocks (`level_plan`)."""
    return _launch(pw, state, x, cfg, timeline=True)[2]


def _launch(pw, state, x, cfg, timeline):
    n_stage = len(cfg.upsample_rates)
    if len(pw["stages"]) != n_stage or state.pre.shape[0] != 1 or x.shape[0] != 1:
        raise ValueError("head_stream_step: batch 1 and one packed stage per rate")
    if x.ndim != 3 or x.shape[2] != cfg.num_mels:
        raise ValueError(f"head_stream_step: x must be (1, T0, {cfg.num_mels})")
    w = [pw["pre_w"], pw["pre_b"]]
    for st in pw["stages"]:
        w += [st["wa"], st["wb"], st["ub"], st["rw"], st["rb"]]
    w += [pw["post_w"], pw["post_b"]]
    st_in = [state.pre]
    for u, r in zip(state.ups, state.res):
        st_in += [u, r]
    st_in.append(state.post)
    wd, sd = w[0].dtype, st_in[0].dtype
    if wd not in _TYPES or sd not in _TYPES:
        raise ValueError(f"head_stream_step: weights {wd} and state {sd}; the kernel takes "
                         "float32 or bfloat16 for each")
    x = x.to(wd).float().contiguous()  # the input rows as the TPU kernel takes them
    dev = check_cuda("head_stream_step", {f"w{i}": t for i, t in enumerate(w)}, wd)
    if check_cuda("head_stream_step", {**{f"state{i}": t for i, t in enumerate(st_in)},
                                       "x": x}) != dev:
        raise ValueError(f"head_stream_step: the state and x are not on {dev}")
    if any(t.dtype != sd for t in st_in):
        raise ValueError(f"head_stream_step: every state tail must be {sd}")

    T0 = x.shape[1]
    geo_c, n_geo, scratch, _ = _kept_plan(cfg, T0, dev)
    st_out = [torch.empty_like(t) for t in st_in]
    wav = torch.empty((1, T0 * math.prod(cfg.upsample_rates)), dtype=torch.float32, device=dev)
    stamps = None
    if timeline:
        n_level, _, _, part_elems, _ = geo_c[:HDR]
        stamps = torch.zeros((n_level, part_elems // PART, 4), dtype=torch.int64, device=dev)
    arr = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    w_c, in_c, out_c = arr(w), arr(st_in), arr(st_out)
    rc = _build.load("hifigan_head")(
        ctypes.addressof(geo_c), ctypes.addressof(w_c), ctypes.addressof(in_c),
        ctypes.addressof(out_c), x.data_ptr(), wav.data_ptr(), n_geo,
        scratch.data_ptr(), None if stamps is None else stamps.data_ptr(),
        int(wd == torch.bfloat16), int(sd == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"head_stream_step: CUDA launch failed with error {rc}")
    head_stream_step.launches += 1
    new = PackedHeadState(st_out[0], tuple(st_out[1 : 1 + 2 * n_stage : 2]),
                          tuple(st_out[2 : 2 + 2 * n_stage : 2]), st_out[-1])
    return new, wav.to(wd), stamps


head_stream_step.launches = 0
