"""Plain PyTorch reference of the content tokenizer (44.1 kHz audio to content
tokens) and of the codec (audio to codes, codes to audio), over whole
utterances.

Frozen copy of the port's plain paths at commit b084fe3:
`streamvoiceanon_tpu_torch/models/convnext.py` (whole-sequence forms),
`models/windowed_transformer.py` (without the LConv1d branch, which the
published tokenizer does not have), `models/tokenizer.py` `encode`,
`models/vocoder.py` `encode` and `decode`, `models/hifigan.py`
`hifigan_apply`.  The port's stream forms (`tokenizer_stream`,
`vocoder.decode_stream`) equal these whole-utterance forms by
construction, so the reference of a stream is the whole-utterance
computation over the stream's audio.  Departure: `pre_quant_latents`
also returns the LFQ projection's margin to a bit flip.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import nn


def convnext_block(p: Dict, x):
    h = nn.causal_conv1d(x, p["dwconv"]["w"], p["dwconv"]["b"], groups=x.shape[-1])
    h = nn.layer_norm(h, p["norm"]["w"], p["norm"]["b"], eps=1e-6)
    h = F.gelu(h @ p["pwconv1"]["w"] + p["pwconv1"]["b"], approximate="none")
    h = h @ p["pwconv2"]["w"] + p["pwconv2"]["b"]
    return x + h * p["gamma"]


def convnext_encoder(p: Dict, c, x):
    for i in range(len(c.depths)):
        if i == 0:
            x = nn.causal_conv1d(x, p["stem_conv"]["w"], p["stem_conv"]["b"])
            x = nn.layer_norm(x, p["stem_norm"]["w"], p["stem_norm"]["b"], eps=1e-6)
        else:
            x = nn.layer_norm(x, p[f"mid_norm_{i-1}"]["w"], p[f"mid_norm_{i-1}"]["b"], eps=1e-6)
            x = x @ p[f"mid_conv_{i-1}"]["w"] + p[f"mid_conv_{i-1}"]["b"]
        for blk in p[f"stage_{i}"]:
            x = convnext_block(blk, x)
    return nn.layer_norm(x, p["final_norm"]["w"], p["final_norm"]["b"], eps=1e-6)


def window_mask(T: int, window, device):
    row = torch.arange(T, device=device)[:, None]
    col = torch.arange(T, device=device)[None, :]
    mask = col <= row
    if window is not None:
        mask &= col >= torch.clamp(row - window + 1, min=0)
    return mask


def windowed_transformer(params: Dict, t, x):
    """Window-limited causal transformer (B, T, dim) -> (B, T, dim)."""
    B, T, _ = x.shape
    H, D = t.n_head, t.head_dim
    freqs = torch.from_numpy(nn.freqs_cis(T, D, t.rope_base)).to(x.device)
    mask = window_mask(T, t.window_size, x.device)
    lay = params["layers"]
    for l in range(t.n_layer):
        h = nn.rms_norm(x, lay["attention_norm"]["w"][l], t.norm_eps)
        q, k, v = torch.chunk(h @ lay["wqkv"]["w"][l], 3, dim=-1)
        q = nn.apply_rope(q.reshape(B, T, H, D), freqs)
        k = nn.apply_rope(k.reshape(B, T, H, D), freqs)
        v = v.reshape(B, T, H, D)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / np.sqrt(D)
        w = torch.softmax(torch.where(mask[None, None], s, float("-inf")), dim=-1).to(x.dtype)
        a = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, T, H * D) @ lay["wo"]["w"][l]
        x = x + lay["attn_scale"][l] * a
        f = nn.rms_norm(x, lay["ffn_norm"]["w"][l], t.norm_eps)
        f = (F.silu(f @ lay["w1"]["w"][l]) * (f @ lay["w3"]["w"][l])) @ lay["w2"]["w"][l]
        x = x + lay["ffn_scale"][l] * f
    return nn.rms_norm(x, params["final_norm"]["w"], t.norm_eps)


def _downsample(stages, x, factors):
    for st, f in zip(stages, factors):
        x = convnext_block(st["block"], nn.causal_conv1d(x, st["conv"]["w"], st["conv"]["b"],
                                                         stride=f))
    return x


def content_latents(p: Dict, c, wav):
    """wav (B, T) -> pre-quantisation latents (B, T // 2048, dim)."""
    mel = nn.log_mel(wav.to(p["backbone"]["stem_conv"]["w"].dtype), c.mel).to(
        p["backbone"]["stem_conv"]["w"].dtype)
    z = _downsample(p["downsample"], convnext_encoder(p["backbone"], c.backbone, mel),
                    c.quantizer.downsample_factor)
    return windowed_transformer(p["pre_module"], c.transformer, z)


def content_tokens(p: Dict, c, wav):
    """wav (B, T) -> (content tokens (B, T // 2048) int32, each token's
    margin to a bit flip (B, T // 2048))."""
    z = content_latents(p, c, wav)
    return (nn.lfq_encode(p["lfq"], z, nn.bits_of(c.quantizer.codebook_size)),
            nn.lfq_margin(p["lfq"], z))


def codec_encode(p: Dict, c, wav):
    """wav (B, T) -> codes (B, n_codebooks, T // 2048) int32."""
    dt = p["backbone"]["stem_conv"]["w"].dtype
    mel = nn.log_mel(wav, c.mel).to(dt)
    z = _downsample(p["downsample"], convnext_encoder(p["backbone"], c.backbone, mel),
                    c.quantizer.downsample_factor)
    q = c.quantizer
    _, idx = nn.grouped_fsq_encode(p["fsq"], z, q.n_groups, q.levels, q.n_codebooks)
    return idx.transpose(1, 2)


def _resblock(p, x, dilations):
    for c1, c2, d in zip(p["convs1"], p["convs2"], dilations):
        h = nn.causal_conv1d(F.silu(x), c1["w"], c1["b"], dilation=d)
        x = x + nn.causal_conv1d(F.silu(h), c2["w"], c2["b"], dilation=d)
    return x


def hifigan(p: Dict, h, x):
    x = nn.causal_conv1d(x, p["conv_pre"]["w"], p["conv_pre"]["b"])
    for i, stride in enumerate(h.upsample_rates):
        x = nn.fish_trans_conv1d(F.silu(x), p["ups"][i]["w"], p["ups"][i]["b"], stride=stride)
        x = sum(_resblock(rb, x, rd) for rb, rd in zip(p["resblocks"][i],
                                                       h.resblock_dilation_sizes)) / len(
            p["resblocks"][i])
    x = nn.causal_conv1d(F.silu(x), p["conv_post"]["w"], p["conv_post"]["b"])
    return torch.tanh(x)[..., 0]


def codec_decode(p: Dict, c, codes):
    """codes (B, n_codebooks, T') -> wav (B, T' * 2048)."""
    q = c.quantizer
    z = nn.grouped_fsq_decode(p["fsq"], codes.transpose(1, 2), q.n_groups, q.levels,
                              q.n_codebooks).to(p["head"]["conv_pre"]["w"].dtype)
    for st, f in zip(p["upsample"], reversed(q.downsample_factor)):
        z = convnext_block(st["block"], nn.fish_trans_conv1d(z, st["conv"]["w"], st["conv"]["b"],
                                                             stride=f))
    return hifigan(p["head"], c.head, z)
