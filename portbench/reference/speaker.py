"""Plain PyTorch reference of the prompt side: the CAM++ style vector and the
speaker encoder's timbre latents of a 44.1 kHz reference, noise-mixed.

Frozen copy of the port's plain paths at commit b084fe3:
`streamvoiceanon_tpu_torch/models/campplus.py` `apply`,
`models/speaker_encoder.py` `tokenize_wav` (ECAPA-TDNN, perceiver, residual
FSQ), `runtime/pipeline.py` `speaker_embeddings` (one reference, the
"concat_mel" collate) and `apply_noise_mixing`.  Departures: the inputs
take no lengths (one unpadded reference), the x-vector head is left out.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import nn


def _bn(p: Dict, x, eps: float = 1e-5):
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = (x - p["mean"].view(shape)) * torch.rsqrt(p["var"] + eps).view(shape)
    if "w" in p:
        y = y * p["w"].view(shape) + p["b"].view(shape)
    return y


def _res_block(p, x, stride):
    h = F.relu(_bn(p["bn1"], F.conv2d(x, p["conv1"], stride=(stride, 1), padding=1)))
    h = _bn(p["bn2"], F.conv2d(h, p["conv2"], padding=1))
    s = (_bn(p["shortcut_bn"], F.conv2d(x, p["shortcut_conv"], stride=(stride, 1)))
         if "shortcut_conv" in p else x)
    return F.relu(h + s)


def _cam_layer(p, x, kernel, dilation, seg_len: int = 100):
    y = F.conv1d(x, p["local_w"], dilation=dilation, padding=(kernel - 1) // 2 * dilation)
    B, C, T = x.shape
    nseg = -(-T // seg_len)
    seg = F.pad(x, (0, nseg * seg_len - T)).reshape(B, C, nseg, seg_len).sum(dim=3)
    seg = seg / torch.clamp(T - torch.arange(nseg, device=x.device) * seg_len, 1,
                            seg_len).to(x.dtype)
    ctx = (x.mean(dim=2, keepdim=True) + seg.repeat_interleave(seg_len, dim=2)[:, :, :T]
           ).transpose(1, 2)
    m = torch.sigmoid(F.relu(ctx @ p["fc1_w"] + p["fc1_b"]) @ p["fc2_w"] + p["fc2_b"])
    return y * m.transpose(1, 2)


def campplus(params: Dict, c, feat, n_valid: int):
    """Kaldi fbank less its mean (B, T, 80) -> style vector (B, 192);
    `n_valid` frames at the pooled rate enter the statistics."""
    fcm = params["fcm"]
    h = F.relu(_bn(fcm["bn1"], F.conv2d(feat.transpose(1, 2)[:, None], fcm["conv1"], padding=1)))
    for layer in ("layer1", "layer2"):
        for i, blk in enumerate(fcm[layer]):
            h = _res_block(blk, h, 2 if i == 0 else 1)
    h = F.relu(_bn(fcm["bn2"], F.conv2d(h, fcm["conv2"], stride=(2, 1), padding=1)))
    B, C, Fp, T = h.shape
    x = h.reshape(B, C * Fp, T)
    x = F.relu(_bn(params["tdnn_bn"], F.conv1d(x, params["tdnn_conv"], stride=2, padding=2)))
    for bi, (k, dil) in enumerate(zip(c.block_kernels, c.block_dilations)):
        for lp in params[f"block{bi + 1}"]:
            d = F.relu(_bn(lp["nl2"], F.conv1d(F.relu(_bn(lp["nl1"], x)), lp["lin1_w"])))
            x = torch.cat([x, _cam_layer(lp["cam"], d, k, dil)], dim=1)
        tp = params[f"transit{bi + 1}"]
        x = F.conv1d(F.relu(_bn(tp["bn"], x)), tp["w"])
    x = F.relu(_bn(params["out_bn"], x))
    T = x.shape[2]
    mask = (torch.arange(T, device=x.device) < n_valid).to(x.dtype)[None, None]
    mean = (x * mask).sum(dim=2) / n_valid
    var = ((x - mean[:, :, None]) ** 2 * mask).sum(dim=2) / max(n_valid - 1.0, 1.0)
    stats = torch.cat([mean, torch.sqrt(var)], dim=-1)
    return _bn(params["dense_bn"], stats @ params["dense_w"][:, :, 0].t())


def _res2(p, x, dilation, scale: int = 8):
    h = _bn(p["bn1"], F.relu(F.conv1d(x, p["conv1_w"], p["conv1_b"])))
    sp = torch.chunk(h, scale, dim=1)
    outs, carry = [], sp[0]
    for i in range(scale - 1):
        if i >= 1:
            carry = carry + sp[i]
        r = p["res2"][i]
        carry = _bn(r["bn"], F.relu(F.conv1d(carry, r["w"], r["b"], dilation=dilation,
                                             padding=dilation)))
        outs.append(carry)
    outs.append(sp[scale - 1])
    h = _bn(p["bn2"], F.relu(F.conv1d(torch.cat(outs, dim=1), p["conv2_w"], p["conv2_b"])))
    s = torch.sigmoid(F.relu(h.mean(dim=2) @ p["se1_w"] + p["se1_b"]) @ p["se2_w"] + p["se2_b"])
    return x + h * s[:, :, None]


def timbre(params: Dict, c, wav16k):
    """16 kHz audio (B, T) -> timbre latents (B, 32, 128)."""
    mel = nn.mel_center(wav16k, nn.ns(dict(sample_rate=c.sample_rate, n_fft=c.n_fft,
                                             win_length=c.win_length, hop_length=c.hop_length,
                                             n_mels=c.n_mels, f_min=c.mel_fmin,
                                             f_max=c.mel_fmax)))
    e = params["ecapa"]
    mel = mel.to(e["layer1_w"].dtype)
    h = _bn(e["layer1_bn"], F.relu(F.conv1d(mel.transpose(1, 2), e["layer1_w"], e["layer1_b"],
                                            padding=2)))
    o2 = _res2(e["layer2"], h, 2)
    o3 = _res2(e["layer3"], o2, 3)
    o4 = _res2(e["layer4"], o3, 4)
    ctx = F.relu(F.conv1d(torch.cat([o2, o3, o4], dim=1), e["conv_w"], e["conv_b"])
                 ).transpose(1, 2)
    pp = params["perceiver"]
    B = ctx.shape[0]
    x = ctx @ pp["proj_w"] + pp["proj_b"]
    lat = pp["latents"].expand(B, *pp["latents"].shape)
    # the keys are the latents then the frames; the last centred frame is
    # past the audio's hop count and left out
    n_keys = lat.shape[1] + x.shape[1]
    keep = torch.arange(n_keys, device=x.device) < lat.shape[1] + wav16k.shape[-1] // c.hop_length
    for layer in pp["layers"]:
        kv = torch.cat([lat, x], dim=1) @ layer["to_kv"]
        k, v = torch.chunk(kv, 2, dim=-1)
        q = (lat @ layer["to_q"]).reshape(B, -1, 8, 64)
        sim = torch.einsum("bihd,bjhd->bhij", q, k.reshape(B, -1, 8, 64)) / np.sqrt(64)
        sim = torch.where(keep, sim, torch.full_like(sim, -torch.finfo(sim.dtype).max))
        att = torch.softmax(sim, dim=-1)
        lat = torch.einsum("bhij,bjhd->bihd", att, v.reshape(B, -1, 8, 64)).reshape(
            B, -1, 512) @ layer["to_out"] + lat
        a, g = torch.chunk(lat @ layer["ff1_w"] + layer["ff1_b"], 2, dim=-1)
        lat = (F.gelu(g) * a) @ layer["ff2_w"] + layer["ff2_b"] + lat
    lat = lat / torch.clamp(torch.linalg.norm(lat, dim=-1, keepdim=True), min=1e-12)
    lat = lat * np.sqrt(lat.shape[-1]) * pp["norm"]["gamma"]
    out, _ = nn.residual_fsq_encode(params["fsq"], lat, c.fsq_levels, c.fsq_num_quantizers)
    return out


def noise_mix(x, alpha: float, noise: Optional[torch.Tensor]):
    """alpha * x + (1 - alpha) * N(mean(x), std(x)) with the standard normal draw `noise`."""
    if alpha >= 1.0:
        return x
    return alpha * x + (1.0 - alpha) * (noise.to(x) * torch.std(x, unbiased=False)
                                        + torch.mean(x))


def speaker_embeddings(campplus_p: Dict, speaker_p: Dict, cfg, ref_wav, alpha: float,
                       noise: Tuple = (None, None)):
    """(style (1, 192), timbre (1, 32, 128)) of one 44.1 kHz reference (T,)."""
    w16 = nn.resample(ref_wav[None].float(), cfg.sample_rate, cfg.resample_rate)
    dt = campplus_p["tdnn_conv"].dtype
    feat = nn.fbank(w16)
    feat = (feat - feat.mean(dim=1, keepdim=True)).to(dt)
    style = campplus(campplus_p, cfg.campplus, feat, feat.shape[1] // 2)
    tim = timbre(speaker_p, cfg.speaker, w16.to(dt))
    return noise_mix(style.float(), alpha, noise[0]), noise_mix(tim.float(), alpha, noise[1])
