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

What this first design does about it (csrc/hifigan_head.cu): one
implicit-GEMM conv kernel, launched once per conv (97 convs): 64 x 64
output tiles, 4 x 4 per thread, full float32 on the CUDA cores (TF32 would
miss the 1e-3 check), the dilated taps read straight from [tail; x] with
SiLU on load and bias, residual, branch sum and tanh in the epilogue.  The
upsample is the same kernel with two taps: its row-major (T, s*C_out)
result is the de-interleaved (T*s, C_out) output.  Each block keeps the
next K-chunk's loads in flight while it multiplies the current one.
Launches with few output tiles split K across blocks (about four blocks
per SM), and a second launch sums the splits in a fixed order.  Not yet
done: the launches in sequence pay launch latency comparable to the
arithmetic, the 64-row tiles are mostly empty at the 4- and 32-row stages,
and nothing uses the tensor cores.

The plain version repeats the TPU kernel's arithmetic: each conv
accumulates in float32, adds the bias in float32 and rounds once; SiLU and
tanh run in float32; the branches are averaged in float32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Tuple

import torch

from streamvoiceanon_tpu_torch.config import HiFiGANConfig
from streamvoiceanon_tpu_torch.ops import _build
from streamvoiceanon_tpu_torch.ops.conv import ConvState, TransConvState
from streamvoiceanon_tpu_torch.ops.decode_common import check_cuda

# split-K partial buffers: at most this many splits of the largest output
MAX_SPLITS = 64


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
    dtype = state.pre.dtype

    pre_tail = state.pre[0]
    full = torch.cat([pre_tail[: k_pre - 1], x[0].to(dtype)], dim=0)
    pre_out = torch.cat([full[T : T + k_pre - 1], pre_tail[k_pre - 1 :]], dim=0)
    h = _conv(full, T, k_pre, 1, pw["pre_w"], pw["pre_b"])

    ups_out, res_out = [], []
    for i, s in enumerate(cfg.upsample_rates):
        st = pw["stages"][i]
        up_tail, res_tail = state.ups[i][0], state.res[i][0]
        co = st["wa"].shape[1] // s
        full = torch.cat([up_tail[:1], _silu(h)], dim=0)  # (T + 1, C_in)
        ups_out.append(torch.cat([full[T : T + 1], up_tail[1:]], dim=0))
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
                    fullc = torch.cat([res_tail[off : off + rows], _silu(hc)], dim=0)
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
    full = torch.cat([post_tail[: k_post - 1], _silu(h)], dim=0)
    post_out = torch.cat([full[T : T + k_post - 1], post_tail[k_post - 1 :]], dim=0)
    y = _conv(full, T, k_post, 1, pw["post_w"], pw["post_b"])
    wav = torch.tanh(y.float()).to(dtype)[:, 0][None]
    new = PackedHeadState(pre_out[None], tuple(u[None] for u in ups_out),
                          tuple(r[None] for r in res_out), post_out[None])
    return new, wav


def _geometry(cfg: HiFiGANConfig, T0: int) -> List[int]:
    """The `geo` int array of csrc/hifigan_head.cu: a 13-int header, then
    (rate, C_in, C_out) per stage, then (k, d, rows, offset) per ResBlock
    slot."""
    chans = stage_channels(cfg)
    slots = res_slots(cfg)
    # (rows, columns) of every launch's output, for the scratch sizes
    shapes = [(T0, cfg.upsample_initial_channel)]
    T = T0
    for s, (ci, co) in zip(cfg.upsample_rates, chans):
        shapes.append((T, s * co))
        T *= s
        shapes.append((T, co))
    shapes.append((T, 1))
    buf_elems = max(r * c for r, c in shapes)
    geo = [T0, cfg.num_mels, cfg.upsample_initial_channel, len(chans),
           cfg.pre_conv_kernel_size, _pad8(cfg.pre_conv_kernel_size - 1),
           cfg.post_conv_kernel_size, _pad8(cfg.post_conv_kernel_size - 1),
           len(cfg.resblock_kernel_sizes), len(cfg.resblock_dilation_sizes[0]),
           res_rows(cfg), buf_elems, MAX_SPLITS * buf_elems]
    for s, (ci, co) in zip(cfg.upsample_rates, chans):
        geo += [s, ci, co]
    for slot in slots:
        geo += list(slot)
    return geo


def head_stream_step(pw: Dict, state: PackedHeadState, x: torch.Tensor,
                     cfg: HiFiGANConfig) -> Tuple[PackedHeadState, torch.Tensor]:
    """The fused head step: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Same arguments and results as
    `head_stream_step_plain`; the new state is a new tensor tree."""
    if x.device.type == "cpu":
        return head_stream_step_plain(pw, state, x, cfg)
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
    x = x.float().contiguous()
    named = {f"w{i}": t for i, t in enumerate(w)}
    named.update({f"state{i}": t for i, t in enumerate(st_in)})
    named["x"] = x
    dev = check_cuda("head_stream_step", named, torch.float32)

    T0 = x.shape[1]
    geo = _geometry(cfg, T0)
    buf_elems, part_cap = geo[11], geo[12]
    st_out = [torch.empty_like(t) for t in st_in]
    wav = torch.empty((1, T0 * math.prod(cfg.upsample_rates)), dtype=torch.float32, device=dev)
    scratch = torch.empty(4 * buf_elems + part_cap, dtype=torch.float32, device=dev)
    geo_c = (ctypes.c_int * len(geo))(*geo)
    arr = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    w_c, in_c, out_c = arr(w), arr(st_in), arr(st_out)
    rc = _build.load("hifigan_head")(
        ctypes.addressof(geo_c), ctypes.addressof(w_c), ctypes.addressof(in_c),
        ctypes.addressof(out_c), x.data_ptr(), wav.data_ptr(), len(geo),
        scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"head_stream_step: CUDA launch failed with error {rc}")
    head_stream_step.launches += 1
    new = PackedHeadState(st_out[0], tuple(st_out[1 : 1 + 2 * n_stage : 2]),
                          tuple(st_out[2 : 2 + 2 * n_stage : 2]), st_out[-1])
    return new, wav


head_stream_step.launches = 0
