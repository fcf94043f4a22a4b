"""Causal HiFiGAN generator head, streaming form.

As `streamvoiceanon_tpu.models.hifigan`: conv_pre (causal) -> [silu ->
FishTransConv upsample -> mean of three ResBlocks] per stage -> silu ->
conv_post -> tanh.  Each ResBlock is 3 x (silu -> dilated causal conv ->
silu -> dilated causal conv) with residual; every conv carries its input
tail, so the stream equals the offline head.

The state is a dict of tails, or with `use_pallas_stream` at batch 1 (and
k == 2 * stride upsamples) the fused head kernel's `PackedHeadState`
(ops/hifigan.py); a packed state at batch > 1 runs the dict path and is
repacked.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from streamvoiceanon_tpu_torch.config import HiFiGANConfig
from streamvoiceanon_tpu_torch.ops import conv as convops
from streamvoiceanon_tpu_torch.ops import hifigan as headops


def packed_eligible(cfg: HiFiGANConfig, batch: int) -> bool:
    """Whether a stream state of this batch takes the packed layout."""
    return cfg.use_pallas_stream and batch == 1 and all(
        k == 2 * s for k, s in zip(cfg.upsample_kernel_sizes, cfg.upsample_rates))


def hifigan_init_stream(p: Dict, cfg: HiFiGANConfig, batch: int = 1,
                        dtype=torch.float32, device=None):
    if packed_eligible(cfg, batch):
        return headops.init_packed_state(cfg, batch, dtype, device)

    def cs(conv_p, dilation=1):
        _, cin, k = conv_p["w"].shape
        return convops.causal_conv1d_init_state(batch, cin, k, dilation=dilation,
                                                dtype=dtype, device=device)

    state: Dict = {"conv_pre": cs(p["conv_pre"]), "ups": [], "res": []}
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        cin = p["ups"][i]["w"].shape[0]
        state["ups"].append(
            convops.fish_trans_conv1d_init_state(batch, cin, k, u, dtype=dtype,
                                                 device=device))
        state["res"].append([
            {
                "convs1": [cs(c, d) for c, d in zip(rb["convs1"], rd)],
                "convs2": [cs(c, d) for c, d in zip(rb["convs2"], rd)],
            }
            for rb, rd in zip(p["resblocks"][i], cfg.resblock_dilation_sizes)
        ])
    state["conv_post"] = cs(p["conv_post"])
    return state


def resblock_apply_stream(p: Dict, state: Dict, x: torch.Tensor, dilations):
    new1, new2 = [], []
    for c1, c2, s1, s2, d in zip(p["convs1"], p["convs2"], state["convs1"],
                                 state["convs2"], dilations):
        s1, h = convops.causal_conv1d_stream(s1, F.silu(x), c1["w"], c1["b"],
                                             dilation=d)
        s2, h = convops.causal_conv1d_stream(s2, F.silu(h), c2["w"], c2["b"],
                                             dilation=d)
        x = x + h
        new1.append(s1)
        new2.append(s2)
    return {"convs1": new1, "convs2": new2}, x


def hifigan_apply_stream(p: Dict, cfg: HiFiGANConfig, state, x: torch.Tensor,
                         packed_w: Dict = None):
    """(state, (B, T, num_mels)) -> (state', (B, T * hop)).

    A `PackedHeadState` at batch 1 runs the fused head kernel with
    `packed_w` (ops.hifigan.packed_weights, made once per parameter tree;
    packed here when not given); at batch > 1 it is unpacked, run on the
    dict path and repacked."""
    if isinstance(state, headops.PackedHeadState):
        if x.shape[0] == 1:
            pw = packed_w if packed_w is not None else headops.packed_weights(p, cfg)
            return headops.head_stream_step(pw, state, x, cfg)
        nd, wav = hifigan_apply_stream(p, cfg, headops.unpack_head_state(state, cfg), x)
        return headops.pack_head_state(nd, cfg), wav
    new_state: Dict = {"ups": [], "res": []}
    new_state["conv_pre"], x = convops.causal_conv1d_stream(
        state["conv_pre"], x, p["conv_pre"]["w"], p["conv_pre"]["b"])
    for i, stride in enumerate(cfg.upsample_rates):
        us, x = convops.fish_trans_conv1d_stream(
            state["ups"][i], F.silu(x), p["ups"][i]["w"], p["ups"][i]["b"],
            stride=stride)
        new_state["ups"].append(us)
        branches, bstates = [], []
        for rb, rs, rd in zip(p["resblocks"][i], state["res"][i],
                              cfg.resblock_dilation_sizes):
            ns, y = resblock_apply_stream(rb, rs, x, rd)
            branches.append(y)
            bstates.append(ns)
        x = sum(branches) / len(branches)
        new_state["res"].append(bstates)
    new_state["conv_post"], x = convops.causal_conv1d_stream(
        state["conv_post"], F.silu(x), p["conv_post"]["w"], p["conv_post"]["b"])
    return new_state, torch.tanh(x)[..., 0]


def resblock_apply(p: Dict, x: torch.Tensor, dilations) -> torch.Tensor:
    """One ResBlock over a whole sequence x (B, T, C)."""
    for c1, c2, d in zip(p["convs1"], p["convs2"], dilations):
        h = convops.causal_conv1d(F.silu(x), c1["w"], c1["b"], dilation=d)
        h = convops.causal_conv1d(F.silu(h), c2["w"], c2["b"], dilation=d)
        x = x + h
    return x


def hifigan_apply(p: Dict, cfg: HiFiGANConfig, x: torch.Tensor) -> torch.Tensor:
    """The head over a whole sequence: x (B, T, num_mels) -> waveform (B, T *
    hop_length) in [-1, 1]."""
    x = convops.causal_conv1d(x, p["conv_pre"]["w"], p["conv_pre"]["b"])
    for i, stride in enumerate(cfg.upsample_rates):
        x = convops.fish_trans_conv1d(F.silu(x), p["ups"][i]["w"], p["ups"][i]["b"],
                                      stride=stride)
        branches = [resblock_apply(rb, x, rd)
                    for rb, rd in zip(p["resblocks"][i], cfg.resblock_dilation_sizes)]
        x = sum(branches) / len(branches)
    x = convops.causal_conv1d(F.silu(x), p["conv_post"]["w"], p["conv_post"]["b"])
    return torch.tanh(x)[..., 0]
