"""SparkTTS / BiCodec timbre encoder, as the JAX package's
models/speaker_encoder.py: wav at 16 kHz -> MelSpectrogram (128 mels, hop
320, power 1, centred) -> ECAPA-TDNN (c512) latent sequence (1536-d) ->
PerceiverResampler (32 learned latents of 128, 2 layers, the queries
included in the context) -> ResidualFSQ (levels 4^6, 1 quantizer) ->
timbre latents (B, 32, 128).  Frozen at inference; BatchNorm uses running
statistics.  ECAPA runs channels-first on PyTorch conv layouts
(`params.speaker_params`); linear weights are (in, out).  `x_vector` is the
pooled speaker embedding of the reference's forward (off the timbre path);
`convert` maps the reference's state_dict to the JAX package's numpy tree,
which `params.speaker_params` carries over."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from streamvoiceanon_tpu_torch.config import MelConfig, SpeakerEncoderConfig
from streamvoiceanon_tpu_torch.models.campplus import _bn
from streamvoiceanon_tpu_torch.ops import quantizers, stft


def _res2_block(p: Dict, x: torch.Tensor, dilation: int, scale: int = 8,
                bn_fn=_bn) -> torch.Tensor:
    """SE_Res2Block on x (B, C, T): 1x1 -> Res2 convs with carry -> 1x1 ->
    squeeze-excitation, plus x.  `bn_fn` lets a training caller
    (evals/ecapa_asv.py) normalise with batch statistics."""
    h = bn_fn(p["bn1"], F.relu(F.conv1d(x, p["conv1_w"], p["conv1_b"])))
    sp = torch.chunk(h, scale, dim=1)
    outs = []
    carry = sp[0]
    for i in range(scale - 1):
        if i >= 1:
            carry = carry + sp[i]
        r = p["res2"][i]
        carry = F.conv1d(carry, r["w"], r["b"], dilation=dilation, padding=dilation)
        carry = bn_fn(r["bn"], F.relu(carry))
        outs.append(carry)
    outs.append(sp[scale - 1])
    h = bn_fn(p["bn2"], F.relu(F.conv1d(torch.cat(outs, dim=1), p["conv2_w"], p["conv2_b"])))
    s = F.relu(h.mean(dim=2) @ p["se1_w"] + p["se1_b"])
    s = torch.sigmoid(s @ p["se2_w"] + p["se2_b"])
    return x + h * s[:, :, None]


def ecapa_latents(params: Dict, mel: torch.Tensor, bn_fn=_bn) -> torch.Tensor:
    """mel (B, T, n_mels) -> latent sequence (B, T, latent width)."""
    x = mel.transpose(1, 2)
    h = bn_fn(params["layer1_bn"],
              F.relu(F.conv1d(x, params["layer1_w"], params["layer1_b"], padding=2)))
    o2 = _res2_block(params["layer2"], h, dilation=2, bn_fn=bn_fn)
    o3 = _res2_block(params["layer3"], o2, dilation=3, bn_fn=bn_fn)
    o4 = _res2_block(params["layer4"], o3, dilation=4, bn_fn=bn_fn)
    cat = torch.cat([o2, o3, o4], dim=1)
    return F.relu(F.conv1d(cat, params["conv_w"], params["conv_b"])).transpose(1, 2)


def x_vector(params: Dict, mel: torch.Tensor) -> torch.Tensor:
    """The pooled speaker embedding (B, out_dim): ECAPA latents -> attentive
    statistics pooling with global context (the latents beside their mean
    and std over time) -> BatchNorm -> linear (-> BatchNorm where the
    checkpoint has `bn2`).  The timbre path does not use it."""
    lat = ecapa_latents(params["ecapa"], mel)  # (B, T, C)
    xv = params["xvec"]
    mean_c = lat.mean(dim=1, keepdim=True)
    std_c = torch.sqrt(lat.var(dim=1, unbiased=False, keepdim=True) + 1e-7)
    x_in = torch.cat([lat, mean_c.expand_as(lat), std_c.expand_as(lat)], dim=-1)
    alpha = torch.tanh(x_in @ xv["pool_lin1_w"][:, :, 0].t() + xv["pool_lin1_b"])
    alpha = torch.softmax(alpha @ xv["pool_lin2_w"][:, :, 0].t() + xv["pool_lin2_b"], dim=1)
    mean = (alpha * lat).sum(dim=1)
    var = (alpha * lat * lat).sum(dim=1) - mean * mean
    std = torch.sqrt(torch.clamp(var, min=1e-7))
    out = _bn(xv["bn"], torch.cat([mean, std], dim=-1))
    out = out @ xv["lin_w"] + xv["lin_b"]
    if "bn2" in xv:
        out = _bn(xv["bn2"], out)
    return out


def perceiver(params: Dict, cfg: SpeakerEncoderConfig, context: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """context (B, T, 1536) -> latents (B, 32, latent_dim); the keys are the
    latents then the context, so `mask` covers 32 + T keys."""
    B = context.shape[0]
    x = context @ params["proj_w"] + params["proj_b"]
    lat = params["latents"].expand(B, *params["latents"].shape)
    heads, dim_head = 8, 64
    for layer in params["layers"]:
        ctx = torch.cat([lat, x], dim=1)
        q = (lat @ layer["to_q"]).reshape(B, -1, heads, dim_head)
        k, v = torch.chunk(ctx @ layer["to_kv"], 2, dim=-1)
        k = k.reshape(B, -1, heads, dim_head)
        v = v.reshape(B, -1, heads, dim_head)
        sim = torch.einsum("bihd,bjhd->bhij", q, k) / np.sqrt(dim_head)
        if mask is not None:
            sim = torch.where(mask[:, None, None, :], sim,
                              torch.full_like(sim, -torch.finfo(sim.dtype).max))
        att = torch.softmax(sim, dim=-1)
        out = torch.einsum("bhij,bjhd->bihd", att, v).reshape(B, -1, heads * dim_head)
        lat = out @ layer["to_out"] + lat
        a, g = torch.chunk(lat @ layer["ff1_w"] + layer["ff1_b"], 2, dim=-1)
        lat = (F.gelu(g) * a) @ layer["ff2_w"] + layer["ff2_b"] + lat
    n = lat / torch.clamp(torch.linalg.norm(lat, dim=-1, keepdim=True), min=1e-12)
    return n * np.sqrt(lat.shape[-1]) * params["norm"]["gamma"]


def mel_config(cfg: SpeakerEncoderConfig) -> MelConfig:
    return MelConfig(sample_rate=cfg.sample_rate, n_fft=cfg.n_fft, win_length=cfg.win_length,
                     hop_length=cfg.hop_length, n_mels=cfg.n_mels, f_min=cfg.mel_fmin,
                     f_max=cfg.mel_fmax)


def tokenize_wav(params: Dict, cfg: SpeakerEncoderConfig, wav16k: torch.Tensor,
                 wav_lens: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """wav (B, T) at 16 kHz -> (timbre latents (B, 32, latent_dim), FSQ
    indices (B, 32, quantizers))."""
    mel = stft.mel_spectrogram_center(wav16k, mel_config(cfg))
    feats = ecapa_latents(params["ecapa"], mel)
    T = feats.shape[1]
    mask = None
    if wav_lens is not None:
        mel_lens = wav_lens // cfg.hop_length
        mask = (torch.arange(cfg.token_num + T, device=feats.device)[None, :]
                < (mel_lens + cfg.token_num)[:, None])
    lat = perceiver(params["perceiver"], cfg, feats, mask)
    return quantizers.residual_fsq_encode(params["fsq"], lat, cfg.fsq_levels,
                                          cfg.fsq_num_quantizers)


# ---------------------------------------------------------------------------
# Converter
# ---------------------------------------------------------------------------


def convert(sd, cfg: SpeakerEncoderConfig) -> Dict:
    """The reference speaker encoder's state_dict -> the JAX package's numpy
    tree (`utils/randparams.speaker_encoder_params_np`'s): ECAPA, the
    perceiver, the residual FSQ's projections and the x-vector head (the
    checkpoint carries it, so strict coverage consumes it)."""
    from streamvoiceanon_tpu_torch.runtime.convert import to_numpy

    sd = to_numpy(sd)

    def bn(prefix):
        return {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"],
                "w": sd[f"{prefix}.weight"], "b": sd[f"{prefix}.bias"]}

    def conv_w(prefix):
        return np.transpose(sd[f"{prefix}.weight"], (2, 1, 0))

    def lin_w(prefix):
        return np.transpose(sd[f"{prefix}.weight"])

    e = "speaker_encoder"

    def res2(prefix):
        b = f"{prefix}.se_res2block"
        return {
            "conv1_w": conv_w(f"{b}.0.conv"), "conv1_b": sd[f"{b}.0.conv.bias"],
            "bn1": bn(f"{b}.0.bn"),
            "conv2_w": conv_w(f"{b}.2.conv"), "conv2_b": sd[f"{b}.2.conv.bias"],
            "bn2": bn(f"{b}.2.bn"),
            "se1_w": lin_w(f"{b}.3.linear1"), "se1_b": sd[f"{b}.3.linear1.bias"],
            "se2_w": lin_w(f"{b}.3.linear2"), "se2_b": sd[f"{b}.3.linear2.bias"],
            "res2": [{"w": conv_w(f"{b}.1.convs.{i}"), "b": sd[f"{b}.1.convs.{i}.bias"],
                      "bn": bn(f"{b}.1.bns.{i}")} for i in range(7)],  # scale 8: 7 convs
        }

    ecapa = {
        "layer1_w": conv_w(f"{e}.layer1.conv"), "layer1_b": sd[f"{e}.layer1.conv.bias"],
        "layer1_bn": bn(f"{e}.layer1.bn"),
        "layer2": res2(f"{e}.layer2"), "layer3": res2(f"{e}.layer3"),
        "layer4": res2(f"{e}.layer4"),
        "conv_w": conv_w(f"{e}.conv"), "conv_b": sd[f"{e}.conv.bias"],
    }
    pv = "perceiver_sampler"
    layers = [{
        "to_q": lin_w(f"{pv}.layers.{i}.0.to_q"),
        "to_kv": lin_w(f"{pv}.layers.{i}.0.to_kv"),
        "to_out": lin_w(f"{pv}.layers.{i}.0.to_out"),
        "ff1_w": lin_w(f"{pv}.layers.{i}.1.0"), "ff1_b": sd[f"{pv}.layers.{i}.1.0.bias"],
        "ff2_w": lin_w(f"{pv}.layers.{i}.1.2"), "ff2_b": sd[f"{pv}.layers.{i}.1.2.bias"],
    } for i in range(2)]
    perceiver_p = {
        "proj_w": lin_w(f"{pv}.proj_context"), "proj_b": sd[f"{pv}.proj_context.bias"],
        "latents": sd[f"{pv}.latents"], "layers": layers,
        "norm": {"gamma": sd[f"{pv}.norm.gamma"]},
    }
    fsq_p = {}
    if "quantizer.project_in.weight" in sd:
        fsq_p = {name: {"w": lin_w(f"quantizer.{name}"), "b": sd[f"quantizer.{name}.bias"]}
                 for name in ("project_in", "project_out")}
    xvec = {
        "pool_lin1_w": conv_w(f"{e}.pool.linear1"),  # a k=1 conv (1, in, bottleneck)
        "pool_lin1_b": sd[f"{e}.pool.linear1.bias"],
        "pool_lin2_w": conv_w(f"{e}.pool.linear2"),
        "pool_lin2_b": sd[f"{e}.pool.linear2.bias"],
        "bn": bn(f"{e}.bn"),
        "lin_w": lin_w(f"{e}.linear"), "lin_b": sd[f"{e}.linear.bias"],
    }
    if f"{e}.bn2.running_mean" in sd:  # the emb_bn variant
        xvec["bn2"] = bn(f"{e}.bn2")
    return {"ecapa": ecapa, "perceiver": perceiver_p, "fsq": fsq_p, "xvec": xvec}
