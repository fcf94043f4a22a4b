"""Content tokens of a whole utterance, as the JAX package's
models/tokenizer.py `encode`: causal log-mel -> ConvNeXt encoder -> the
stride-f downsample convs, each with one ConvNeXt block -> the
window-limited transformer -> LFQ sign bits (vocab 8192).

Also the training forward of the content encoder (`quantized_latents`,
`forward`): the quantized latents through the post-quantization
transformer, then the ConvNeXt distillation head that predicts the
w2v-BERT teacher's features; its tree comes from
`params.tokenizer_params(..., with_head=True)`."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def quantized_latents(params: Dict, cfg: TokenizerConfig,
                      wav: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the quantized latents through post_module (B, T', input_dim), the
    indices (B, T'))."""
    z = pre_quant_latents(params, cfg, wav)
    zq, idx = quantizers.lfq_quantize(params["lfq"], z, cfg.quantizer.codebook_bits)
    return windowed_transformer.apply(params["post_module"], cfg.transformer, zq), idx


def forward(params: Dict, cfg: TokenizerConfig, wav: torch.Tensor,
            target_len: Optional[int] = None,
            g: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
    """The training forward: (the head's prediction of the teacher features
    (B, target_len, head dims[-1]), {"latents", "codes"}).  The latents are
    resampled to `target_len` frames by nearest neighbour (frame
    (t * T') // target_len), then the head runs with the global
    conditioning `g` (B, 1, gin_channels)."""
    zq, idx = quantized_latents(params, cfg, wav)
    return head_prediction(params["head"], cfg, zq, target_len, g), {"latents": zq, "codes": idx}


def head_prediction(head: Dict, cfg: TokenizerConfig, latents: torch.Tensor,
                    target_len: Optional[int] = None,
                    g: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`forward`'s head on the post-module latents (B, T', input_dim):
    resampled to `target_len` frames by nearest neighbour, then the ConvNeXt
    head with `g`."""
    x = latents
    if target_len is not None and target_len != x.shape[1]:
        src = (torch.arange(target_len, device=x.device) * x.shape[1]) // target_len
        x = x[:, src]
    return convnext.convnext_encoder_apply(head, cfg.head, x, g=g)
