"""Firefly codec, as `streamvoiceanon_tpu.models.vocoder`: `encode` (log-mel
-> ConvNeXt encoder -> stride-f downsample stages -> grouped residual FSQ),
the offline `decode_codes` / `decode`, and the streaming decode
(`init_stream_state`, `decode_stream`).

codes -> grouped residual FSQ decode -> two stride-2 causal upsampling
stages (transposed conv + ConvNeXt block) -> HiFiGAN head -> 2048 samples
per frame.  Every conv carries its input tail, so the stream equals the
offline decode.  With `HiFiGANConfig.use_pallas_stream` the head runs the
fused head kernel on its packed state, with the weights packed once into
`params["head_packed"]` by `params.Converter`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from streamvoiceanon_tpu_torch.config import VocoderConfig
from streamvoiceanon_tpu_torch.models import convnext, hifigan
from streamvoiceanon_tpu_torch.ops import conv as convops
from streamvoiceanon_tpu_torch.ops import hifigan as headops
from streamvoiceanon_tpu_torch.ops import quantizers, stft


def _downsample(p, x: torch.Tensor, factors) -> torch.Tensor:
    for stage, f in zip(p, factors):
        x = convops.causal_conv1d(x, stage["conv"]["w"], stage["conv"]["b"], stride=f)
        x = convnext.convnext_block_apply(stage["block"], x)
    return x


def _upsample(p, x: torch.Tensor, factors) -> torch.Tensor:
    # the reference builds its upsample stack over reversed(factors)
    for stage, f in zip(p, reversed(factors)):
        x = convops.fish_trans_conv1d(x, stage["conv"]["w"], stage["conv"]["b"], stride=f)
        x = convnext.convnext_block_apply(stage["block"], x)
    return x


def encode(params: Dict, cfg: VocoderConfig, wav: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """wav (B, T) -> (codes (B, n_codebooks, T // 2048) int32, quantized
    latents (B, T // 2048, input_dim))."""
    mel = stft.log_mel_spectrogram(wav, cfg.mel)
    feat = convnext.convnext_encoder_apply(params["backbone"], cfg.backbone, mel)
    z = _downsample(params["downsample"], feat, cfg.quantizer.downsample_factor)
    quantized, idx = quantizers.grouped_residual_fsq_encode(
        params["fsq"], z, cfg.quantizer.n_groups, cfg.quantizer.levels,
        cfg.quantizer.n_codebooks)
    return idx.transpose(1, 2), quantized


def decode_codes(params: Dict, cfg: VocoderConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, n_codebooks, T') -> the quantizer's output (B, T' * 4, input_dim)."""
    z = quantizers.grouped_residual_fsq_decode(
        params["fsq"], codes.transpose(1, 2), cfg.quantizer.n_groups, cfg.quantizer.levels,
        cfg.quantizer.n_codebooks)
    return _upsample(params["upsample"], z, cfg.quantizer.downsample_factor)


def decode(params: Dict, cfg: VocoderConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, n_codebooks, T') -> wav (B, T' * 2048)."""
    return hifigan.hifigan_apply(params["head"], cfg.head, decode_codes(params, cfg, codes))


def init_stream_state(params: Dict, cfg: VocoderConfig, batch: int = 1,
                      dtype=torch.float32, device=None) -> Dict:
    up = [
        {
            "conv": convops.fish_trans_conv1d_init_state(
                batch, stage["conv"]["w"].shape[0], stage["conv"]["w"].shape[-1], f,
                dtype=dtype, device=device),
            "block": convnext.convnext_block_init_stream(stage["block"], batch,
                                                         dtype, device),
        }
        for stage, f in zip(params["upsample"],
                            reversed(cfg.quantizer.downsample_factor))
    ]
    return {
        "upsample": up,
        "head": hifigan.hifigan_init_stream(params["head"], cfg.head, batch,
                                            dtype, device),
    }


def convert_head_layout(state: Dict, hcfg, target_batch: int = 0) -> Dict:
    """Move the head's stream state between the dict-of-tails layout and the
    fused kernel's `PackedHeadState`, as `hcfg.use_pallas_stream` and the
    batch ask.  `target_batch` overrides the state's own batch in that
    check (a batch-1 state about to be tiled to more streams unpacks
    first: the packed kernel takes batch 1 only)."""
    head = state["head"]
    packed = isinstance(head, headops.PackedHeadState)
    batch = target_batch or (head.pre.shape[0] if packed
                             else head["conv_pre"].tail.shape[0])
    want = hifigan.packed_eligible(hcfg, batch)
    if want and not packed:
        return {**state, "head": headops.pack_head_state(head, hcfg)}
    if not want and packed:
        return {**state, "head": headops.unpack_head_state(head, hcfg)}
    return state


def decode_stream(params: Dict, cfg: VocoderConfig, state: Dict, codes: torch.Tensor):
    """(state, codes (B, nq, k)) -> (state', wav (B, k*2048))."""
    head = state["head"]
    head_dtype = (head.pre.dtype if isinstance(head, headops.PackedHeadState)
                  else head["conv_pre"].tail.dtype)
    z = quantizers.grouped_residual_fsq_decode(
        params["fsq"], codes.transpose(1, 2), cfg.quantizer.n_groups,
        cfg.quantizer.levels, cfg.quantizer.n_codebooks,
    ).to(head_dtype)
    new_up = []
    # the reference builds its upsample stack over reversed(factors)
    for stage, st, f in zip(params["upsample"], state["upsample"],
                            reversed(cfg.quantizer.downsample_factor)):
        cs, z = convops.fish_trans_conv1d_stream(
            st["conv"], z, stage["conv"]["w"], stage["conv"]["b"], stride=f)
        bs, z = convnext.convnext_block_apply_stream(stage["block"], st["block"], z)
        new_up.append({"conv": cs, "block": bs})
    hs, wav = hifigan.hifigan_apply_stream(params["head"], cfg.head, head, z,
                                           packed_w=params.get("head_packed"))
    return {"upsample": new_up, "head": hs}, wav
