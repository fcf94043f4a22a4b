"""Operations and bytes of the work a configuration asks for, counted from
its shapes and stated dtypes, never from what the program allocates.

Rules: an operation is a multiply or an add (a multiply-accumulate is 2);
every weight is read once a call, every input and output moved once; a KV
cache or ring contributes the rows the step really attends (rows below the
position, within the window), not the rows allocated.  Norms, activations,
RoPE and sampling are left out of the operations (a few per element); the
count is then a lower bound, and so is the least time made from it.

`least_s` turns a count into the least time on the card: the larger of the
operations over the peak of the dtype that computes them and the bytes over
the memory rate (H100 SXM peaks, `core.PEAK_FLOPS`, `core.PEAK_BYTES_PER_S`).
"""

from __future__ import annotations

from typing import Dict, Tuple

from portbench import weights
from portbench.core import PEAK_BYTES_PER_S, PEAK_FLOPS

BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}
Count = Tuple[float, float]  # (operations, bytes)


def least_s(count: Count, dtype: str) -> float:
    ops, nbytes = count
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def add(*counts: Count) -> Count:
    return (sum(c[0] for c in counts), sum(c[1] for c in counts))


def _params(tree) -> int:
    return weights.count(tree)


def _layer_params(dim, n_head, n_local, head_dim, inter) -> int:
    return dim * (n_head + 2 * n_local) * head_dim + n_head * head_dim * dim + 3 * dim * inter


def _slow(d: Dict):
    nl = d["n_local_heads"] if d["n_local_heads"] > 0 else d["n_head"]
    return d["n_layer"], d["dim"], _layer_params(d["dim"], d["n_head"], nl, d["head_dim"],
                                                  d["intermediate_size"]), nl * d["head_dim"]


def slow_rows(d: Dict, pos: int, rows: int, wb: int, cb: int, head: bool) -> Count:
    """`rows` new rows through the slow stack at cache position `pos`: every
    layer's matrices once, the cache rows below pos + i for new row i, the
    new rows' K and V written; with `head` the output head on the last row."""
    L, D, P, kv = _slow(d)
    attended = sum(pos + i + 1 for i in range(rows))
    ops = 2 * rows * L * P + L * 2 * 2 * attended * d["n_head"] * d["head_dim"]
    nbytes = wb * L * P + cb * L * 2 * kv * (pos + rows) + wb * 2 * rows * D
    if head:
        ops += 2 * D * d["vocab_size"]
        nbytes += wb * D * d["vocab_size"] + 4 * d["vocab_size"]  # the head and its noise
    return ops, nbytes


def slow_step(d: Dict, pos: int, wb: int, cb: int) -> Count:
    """The frame's two-row slow step with its semantic head (kernel `slow_decode`)."""
    return slow_rows(d, pos, 2, wb, cb, head=True)


def fast_loop(d: Dict, wb: int) -> Count:
    """The frame's codebook loop (kernel `fast_decode`): nq steps of the fast
    stack over 1..nq rows, the codebook head and sampler a step."""
    nl = d["fast_n_local_heads"] if d["fast_n_local_heads"] > 0 else d["fast_n_head"]
    L, D, V, nq = d["n_fast_layer"], d["fast_dim"], d["codebook_size"], d["num_codebooks"]
    P = _layer_params(D, d["fast_n_head"], nl, d["fast_head_dim"], d["fast_intermediate_size"])
    hd = d["fast_n_head"] * d["fast_head_dim"]
    ops = nq * 2 * (L * P + D * V) + L * 2 * 2 * hd * sum(range(1, nq + 1))
    nbytes = wb * (L * P + D * V) + wb * (nq - 1) * D + wb * nq * d["dim"] + 4 * nq * V
    return ops, nbytes


def ring_step(t: Dict, count: int, wb: int, sb: int) -> Count:
    """One token through the windowed transformer's ring (kernel `wt_stream`):
    the layers' matrices, the ring rows inside the window read, one row written."""
    L, D, F = t["n_layer"], t["dim"], t["intermediate_size"]
    kv = t["n_head"] * t["head_dim"]
    rows = min(count, t["window_size"] or count)
    P = D * 3 * kv + kv * D + 3 * D * F
    ops = 2 * L * P + L * 2 * 2 * kv * (rows + 1)
    return ops, wb * L * P + sb * L * 2 * kv * (rows + 1)


def _conv_tree_ops(tree, rows: int) -> float:
    """2 x parameters x output rows: every weight of a stride-1 conv or a
    matrix is used once an output row."""
    return 2.0 * _params(tree) * rows


def head(h: Dict, rows: int, wb: int) -> Count:
    """The HiFiGAN head over `rows` input rows (kernel `hifigan_head`)."""
    spec = weights.hifigan(h)
    ops = _conv_tree_ops(spec["conv_pre"], rows)
    T = rows
    for i, r in enumerate(h["upsample_rates"]):
        ops += _conv_tree_ops(spec["ups"][i], T)  # a transposed conv: its taps per input row
        T *= r
        ops += _conv_tree_ops(spec["resblocks"][i], T)
    ops += _conv_tree_ops(spec["conv_post"], T)
    nbytes = wb * _params(spec) + 4 * (rows * h["num_mels"] + T)
    return ops, nbytes


def encode_stage(tok: Dict, count: int, frames: int, wb: int, sb: int) -> Dict[str, Count]:
    """One chunk of `frames` frames through the content encoder: the mel
    front's DFT, the ConvNeXt front over 4 mel rows a frame, the stride-2
    downsamples, then `frames` ring steps (the ring holding `count` rows)."""
    spec = weights.tokenizer(tok)
    hop_rows = 4 * frames
    m = tok["mel"]
    nbins = m["n_fft"] // 2 + 1
    mel_ops = 2.0 * hop_rows * (m["win_length"] * 2 * nbins + nbins * m["n_mels"])
    front = (_conv_tree_ops(spec["backbone"], hop_rows),
             wb * _params(spec["backbone"]) + 4 * hop_rows * (m["n_mels"] + 2048 // 4))
    rows, down = hop_rows, []
    for st, f in zip(spec["downsample"], tok["quantizer"]["downsample_factor"]):
        rows //= f
        down.append((_conv_tree_ops(st, rows), wb * _params(st)))
    lfq = (_conv_tree_ops(spec["lfq"]["project_in"], frames), wb * _params(spec["lfq"]["project_in"]))
    ring = add(*(ring_step(tok["transformer"], count + i, wb, sb) for i in range(frames)))
    return {"front": add((mel_ops, 0.0), front, *down, lfq), "ring": ring}


def vocode_stage(voc: Dict, frames: int, wb: int) -> Dict[str, Count]:
    """One chunk of `frames` frames through the codec's decode: the FSQ
    projections, the two upsample stages (transposed conv and ConvNeXt
    block), then the head over 4 rows a frame."""
    spec = weights.vocoder(voc)
    rows, ups = frames, []
    for st, f in zip(spec["upsample"], reversed(voc["quantizer"]["downsample_factor"])):
        ups.append((_conv_tree_ops(st["conv"], rows), wb * _params(st["conv"])))
        rows *= f
        ups.append((_conv_tree_ops(st["block"], rows), wb * _params(st["block"])))
    fsq = (_conv_tree_ops(spec["fsq"], frames), wb * _params(spec["fsq"]))
    return {"upsample": add(fsq, *ups), "head": head(voc["head"], rows, wb)}


def vocoder_decode(voc: Dict, frames: int, wb: int) -> Count:
    return add(*vocode_stage(voc, frames, wb).values())


def codec_encode(voc: Dict, frames: int, wb: int) -> Count:
    """The codec's encode of `frames` frames: DFT, ConvNeXt, downsamples, FSQ."""
    spec = weights.vocoder(voc)
    hop_rows = 4 * frames
    m = voc["mel"]
    nbins = m["n_fft"] // 2 + 1
    ops = 2.0 * hop_rows * (m["win_length"] * 2 * nbins + nbins * m["n_mels"])
    ops += _conv_tree_ops(spec["backbone"], hop_rows)
    nbytes = wb * (_params(spec["backbone"]) + _params(spec["downsample"]) + _params(spec["fsq"]))
    rows = hop_rows
    for st, f in zip(spec["downsample"], voc["quantizer"]["downsample_factor"]):
        rows //= f
        ops += _conv_tree_ops(st, rows)
    ops += _conv_tree_ops(spec["fsq"], frames)
    return ops, nbytes


def tokenizer_encode(tok: Dict, frames: int, wb: int) -> Count:
    """The whole-utterance content encode of `frames` frames (window-limited attention)."""
    st = encode_stage(tok, 0, frames, wb, wb)
    t = tok["transformer"]
    L, D, F = t["n_layer"], t["dim"], t["intermediate_size"]
    kv = t["n_head"] * t["head_dim"]
    P = D * 3 * kv + kv * D + 3 * D * F
    W = t["window_size"] or frames
    attended = sum(min(i + 1, W) for i in range(frames))
    ring = (2.0 * frames * L * P + L * 4 * kv * attended, wb * L * P)
    return add(st["front"], ring)
