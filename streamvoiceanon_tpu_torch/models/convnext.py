"""Causal ConvNeXt blocks and encoder (channels-last, functional).

As `streamvoiceanon_tpu.models.convnext`: causal depthwise conv (k=7),
LayerNorm over channels, pointwise MLP with exact GELU, LayerScale gamma,
residual.  Only the depthwise conv carries state (its input tail).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from streamvoiceanon_tpu_torch.ops import conv as convops
from streamvoiceanon_tpu_torch.ops.norm import layer_norm


def convnext_block_init_stream(p: Dict, batch: int, dtype=torch.float32,
                               device=None) -> convops.ConvState:
    dim, _, k = p["dwconv"]["w"].shape
    return convops.causal_conv1d_init_state(batch, dim, k, dtype=dtype,
                                            device=device)


def convnext_block_apply_stream(p: Dict, state: convops.ConvState, x: torch.Tensor):
    state, h = convops.causal_conv1d_stream(
        state, x, p["dwconv"]["w"], p["dwconv"]["b"], groups=x.shape[-1])
    h = layer_norm(h, p["norm"]["w"], p["norm"]["b"], eps=1e-6)
    h = h @ p["pwconv1"]["w"] + p["pwconv1"]["b"]
    h = F.gelu(h, approximate="none")
    h = h @ p["pwconv2"]["w"] + p["pwconv2"]["b"]
    if p.get("gamma") is not None:
        h = h * p["gamma"]
    return state, x + h


def convnext_block_apply(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """One block over a whole sequence x (B, T, C)."""
    h = convops.causal_conv1d(x, p["dwconv"]["w"], p["dwconv"]["b"], groups=x.shape[-1])
    h = layer_norm(h, p["norm"]["w"], p["norm"]["b"], eps=1e-6)
    h = F.gelu(h @ p["pwconv1"]["w"] + p["pwconv1"]["b"], approximate="none")
    h = h @ p["pwconv2"]["w"] + p["pwconv2"]["b"]
    if p.get("gamma") is not None:
        h = h * p["gamma"]
    return x + h


def convnext_encoder_apply(p: Dict, cfg, x: torch.Tensor,
                           g: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ConvNeXt encoder over a whole sequence: x (B, T, C_in) -> (B, T,
    dims[-1]); stem conv + LN, per stage a LN + 1x1 transition (stages > 0)
    and its blocks, final LN.  `g` (B, 1, gin_channels), where given and
    the tree has `g_in`, is added to the input through that 1x1 conv (the
    tokenizer's distillation head)."""
    if g is not None and "g_in" in p:
        x = x + (g @ p["g_in"]["w"] + p["g_in"]["b"])
    for i in range(len(cfg.depths)):
        if i == 0:
            x = convops.causal_conv1d(x, p["stem_conv"]["w"], p["stem_conv"]["b"])
            x = layer_norm(x, p["stem_norm"]["w"], p["stem_norm"]["b"], eps=1e-6)
        else:
            x = layer_norm(x, p[f"mid_norm_{i-1}"]["w"], p[f"mid_norm_{i-1}"]["b"], eps=1e-6)
            x = x @ p[f"mid_conv_{i-1}"]["w"] + p[f"mid_conv_{i-1}"]["b"]
        for blk in p[f"stage_{i}"]:
            x = convnext_block_apply(blk, x)
    return layer_norm(x, p["final_norm"]["w"], p["final_norm"]["b"], eps=1e-6)
