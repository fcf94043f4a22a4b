"""Content tokens of a whole utterance, as the JAX package's
models/tokenizer.py `encode`: causal log-mel -> ConvNeXt encoder -> the
stride-f downsample convs, each with one ConvNeXt block -> the
window-limited transformer -> LFQ sign bits (vocab 8192)."""

from __future__ import annotations

from typing import Dict

import torch

from streamvoiceanon_tpu_torch.config import TokenizerConfig
from streamvoiceanon_tpu_torch.models import convnext, windowed_transformer
from streamvoiceanon_tpu_torch.ops import conv as convops
from streamvoiceanon_tpu_torch.ops import quantizers, stft


def _downsample(p, x: torch.Tensor, factors) -> torch.Tensor:
    for stage, f in zip(p, factors):
        x = convops.causal_conv1d(x, stage["conv"]["w"], stage["conv"]["b"], stride=f)
        x = convnext.convnext_block_apply(stage["block"], x)
    return x


def pre_quant_latents(params: Dict, cfg: TokenizerConfig, wav: torch.Tensor) -> torch.Tensor:
    """wav (B, T) -> pre-quantisation latents (B, T // 2048, input_dim)."""
    mel = stft.log_mel_spectrogram(wav, cfg.mel)
    feat = convnext.convnext_encoder_apply(params["backbone"], cfg.backbone, mel)
    z = _downsample(params["downsample"], feat, cfg.quantizer.downsample_factor)
    return windowed_transformer.apply(params["pre_module"], cfg.transformer, z)


def encode(params: Dict, cfg: TokenizerConfig, wav: torch.Tensor) -> torch.Tensor:
    """wav (B, T) -> content token ids (B, T // 2048) int32."""
    z = pre_quant_latents(params, cfg, wav)
    return quantizers.lfq_encode(params["lfq"], z, cfg.quantizer.codebook_bits)
