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

What bounds the kernel on the card: bytes.  At the published width (stem
160 -> 128, blocks 3-3-9-3 at 128/256/384/512, two 512-wide downsamples)
one call reads about 98 MB of float32 weights, 0.029 ms at 3.35 TB/s,
while its products over at most 4 rows (about 0.2 GFLOP) take 0.003 ms at
67 TFLOP/s.

What this first design does about it (csrc/convnext_enc.cu on the split-K
matvec of csrc/decode_common.cuh): every weight byte is read once per
call, by hundreds of blocks per product.  Per block one row kernel (the
depthwise conv + bias + LN, which also writes the block's new tail into
the output state) and two matvec launches over the rows (bias + GELU; bias
+ LayerScale + residual); the stem is an im2col launch and one matvec,
each transition an LN and one matvec, each downsample one matvec of the
rows viewed as (T/f, f*C) against the tap-major weight.  Not yet done:
about 72 launches in sequence pay launch latency comparable to the
weight stream.

The plain version repeats the TPU kernel's arithmetic and rounding points
(after the depthwise conv + bias, after each LN, after each pointwise +
bias, after GELU, after the LayerScale product).  GELU is exact erf: the
TPU kernel's polynomial erf exists only because Mosaic cannot lower
`lax.erf`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from streamvoiceanon_tpu_torch.config import TokenizerConfig
from streamvoiceanon_tpu_torch.ops import _build
from streamvoiceanon_tpu_torch.ops.conv import ConvState
from streamvoiceanon_tpu_torch.ops.decode_common import check_cuda, matvec_scratch
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


def _geometry(cfg: TokenizerConfig, T0: int) -> List[int]:
    """The `geo` int array of csrc/convnext_enc.cu: an 8-int header, then
    (depth, C) per stage, then the factor per downsample."""
    bb, q = cfg.backbone, cfg.quantizer
    widest = max(*bb.dims, q.input_dim)
    geo = [T0, bb.input_channels, bb.kernel_size, len(bb.depths),
           len(q.downsample_factor), q.input_dim, T0 * widest, 4 * T0 * widest]
    for d, c in zip(bb.depths, bb.dims):
        geo += [d, c]
    return geo + list(q.downsample_factor)


def _matvec_shapes(cfg: TokenizerConfig):
    """(K, N, n_matrices) of every matvec launch of one call."""
    bb, q = cfg.backbone, cfg.quantizer
    shapes = [(bb.kernel_size * bb.input_channels, bb.dims[0], 1)]
    shapes += [(a, b, 1) for a, b in zip(bb.dims, bb.dims[1:])]
    c = bb.dims[-1]
    for f in q.downsample_factor:
        shapes.append((f * c, q.input_dim, 1))
        c = q.input_dim
    for c in (*bb.dims, q.input_dim):
        shapes += [(c, 4 * c, 1), (4 * c, c, 1)]
    return shapes


def encoder_front_step(pw: Dict, state: PackedEncState, mel: torch.Tensor,
                       cfg: TokenizerConfig) -> Tuple[PackedEncState, torch.Tensor]:
    """The fused front step: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Same arguments and results as
    `encoder_front_step_plain`; the new state is a new tensor tree."""
    if mel.device.type == "cpu":
        return encoder_front_step_plain(pw, state, mel, cfg)
    bb, q = cfg.backbone, cfg.quantizer
    n_stage = len(bb.depths)
    T0 = mel.shape[1]
    factor = math.prod(q.downsample_factor)
    if (mel.ndim != 3 or mel.shape[0] != 1 or mel.shape[2] != bb.input_channels
            or T0 % factor or state.stem.shape[0] != 1):
        raise ValueError(f"encoder_front_step: batch 1, mel (1, T0, {bb.input_channels}) "
                         f"with T0 a multiple of {factor}; got {tuple(mel.shape)}")
    if any(c % 4 for c in (*bb.dims, q.input_dim)) or len(pw["stages"]) != n_stage:
        raise ValueError("encoder_front_step: widths must be multiples of 4, one packed "
                         "stage per depth")
    w = [pw["stem_w"], pw["stem_b"], pw["stem_ln_w"], pw["stem_ln_b"]]
    names = ("dw_w", "dw_b", "ln_w", "ln_b", "pw1", "pw1_b", "pw2", "pw2_b", "gamma")
    for sp in pw["stages"]:
        w += [sp[n] for n in names]
    for m in pw["mids"]:
        w += [m["ln_w"], m["ln_b"], m["w"], m["b"]]
    w += [pw["final_ln_w"], pw["final_ln_b"]]
    for dp in pw["downs"]:
        w += [dp["w"], dp["b"], *(dp["blk"][n] for n in names)]
    st_in = [state.stem, *state.stages, state.down]
    mel = mel.contiguous()
    named = {f"w{i}": t for i, t in enumerate(w)}
    named.update({f"state{i}": t for i, t in enumerate(st_in)})
    named["mel"] = mel
    dev = check_cuda("encoder_front_step", named, torch.float32)

    geo = _geometry(cfg, T0)
    x_elems, g_elems = geo[6], geo[7]
    st_out = [torch.empty_like(t) for t in st_in]
    z = torch.empty((1, T0 // factor, q.input_dim), dtype=torch.float32, device=dev)
    scratch = torch.empty(2 * x_elems + g_elems + T0 * bb.kernel_size * bb.input_channels,
                          dtype=torch.float32, device=dev)
    partials, counters = matvec_scratch(min(T0, 4), _matvec_shapes(cfg), dev)
    geo_c = (ctypes.c_int * len(geo))(*geo)
    arr = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    w_c, in_c, out_c = arr(w), arr(st_in), arr(st_out)
    rc = _build.load("convnext_enc")(
        ctypes.addressof(geo_c), ctypes.addressof(w_c), ctypes.addressof(in_c),
        ctypes.addressof(out_c), mel.data_ptr(), z.data_ptr(), len(geo),
        scratch.data_ptr(), partials.data_ptr(), counters.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"encoder_front_step: CUDA launch failed with error {rc}")
    encoder_front_step.launches += 1
    return PackedEncState(st_out[0], tuple(st_out[1 : 1 + n_stage]), st_out[-1]), z


encoder_front_step.launches = 0
