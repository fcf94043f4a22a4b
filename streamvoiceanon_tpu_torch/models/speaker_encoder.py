"""SparkTTS / BiCodec timbre encoder, as the JAX package's
models/speaker_encoder.py: wav at 16 kHz -> MelSpectrogram (128 mels, hop
320, power 1, centred) -> ECAPA-TDNN (c512) latent sequence (1536-d) ->
PerceiverResampler (32 learned latents of 128, 2 layers, the queries
included in the context) -> ResidualFSQ (levels 4^6, 1 quantizer) ->
timbre latents (B, 32, 128).  Frozen at inference; BatchNorm uses running
statistics.  ECAPA runs channels-first on PyTorch conv layouts
(`params.speaker_params`); linear weights are (in, out)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from streamvoiceanon_tpu_torch.config import MelConfig, SpeakerEncoderConfig
from streamvoiceanon_tpu_torch.models.campplus import _bn
from streamvoiceanon_tpu_torch.ops import quantizers, stft


def _res2_block(p: Dict, x: torch.Tensor, dilation: int, scale: int = 8) -> torch.Tensor:
    """SE_Res2Block on x (B, C, T): 1x1 -> Res2 convs with carry -> 1x1 ->
    squeeze-excitation, plus x."""
    h = _bn(p["bn1"], F.relu(F.conv1d(x, p["conv1_w"], p["conv1_b"])))
    sp = torch.chunk(h, scale, dim=1)
    outs = []
    carry = sp[0]
    for i in range(scale - 1):
        if i >= 1:
            carry = carry + sp[i]
        r = p["res2"][i]
        carry = F.conv1d(carry, r["w"], r["b"], dilation=dilation, padding=dilation)
        carry = _bn(r["bn"], F.relu(carry))
        outs.append(carry)
    outs.append(sp[scale - 1])
    h = _bn(p["bn2"], F.relu(F.conv1d(torch.cat(outs, dim=1), p["conv2_w"], p["conv2_b"])))
    s = F.relu(h.mean(dim=2) @ p["se1_w"] + p["se1_b"])
    s = torch.sigmoid(s @ p["se2_w"] + p["se2_b"])
    return x + h * s[:, :, None]


def ecapa_latents(params: Dict, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, T, 128) -> latent sequence (B, T, 1536)."""
    x = mel.transpose(1, 2)
    h = _bn(params["layer1_bn"],
            F.relu(F.conv1d(x, params["layer1_w"], params["layer1_b"], padding=2)))
    o2 = _res2_block(params["layer2"], h, dilation=2)
    o3 = _res2_block(params["layer3"], o2, dilation=3)
    o4 = _res2_block(params["layer4"], o3, dilation=4)
    cat = torch.cat([o2, o3, o4], dim=1)
    return F.relu(F.conv1d(cat, params["conv_w"], params["conv_b"])).transpose(1, 2)


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
