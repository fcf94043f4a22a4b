"""Window-limited causal transformer over a whole sequence (the tokenizer's
pre-quantisation module), as the JAX package's
models/windowed_transformer.py: RMSNorm -> attention (RoPE, window-limited
causal mask) with LayerScale, the optional depthwise-conv (LConv1d) branch,
RMSNorm -> SwiGLU FFN with LayerScale, final RMSNorm.  Channels-last (B, T,
C); the softmax in float32 with a 1/sqrt(head_dim) scale.  The layers come
stacked, every leaf with a leading layer axis (`params.
windowed_transformer_params`); the LConv1d depthwise weight keeps the JAX
package's (k, 1, dim)."""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from streamvoiceanon_tpu_torch.config import WindowedTransformerConfig
from streamvoiceanon_tpu_torch.ops.norm import rms_norm
from streamvoiceanon_tpu_torch.ops.rope import apply_rope, precompute_freqs_cis


@functools.lru_cache(maxsize=8)
def window_limited_mask(length: int, window_size: Optional[int]) -> np.ndarray:
    """Causal mask limited to `window_size` past positions; True = attend."""
    row = np.arange(length)[:, None]
    col = np.arange(length)[None, :]
    mask = col <= row
    if window_size is not None:
        mask &= col >= np.maximum(row - window_size + 1, 0)
    return mask


def layer(tree, l: int):
    """Layer l of a tree of stacked (L, ...) leaves."""
    if isinstance(tree, dict):
        return {k: layer(v, l) for k, v in tree.items()}
    return tree[l]


def attention(p: Dict, cfg: WindowedTransformerConfig, x: torch.Tensor,
              freqs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    B, T, _ = x.shape
    H, D = cfg.n_head, cfg.head_dim
    qkv = x @ p["wqkv"]["w"]
    if "b" in p["wqkv"]:
        qkv = qkv + p["wqkv"]["b"]
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    q = apply_rope(q.reshape(B, T, H, D), freqs)
    k = apply_rope(k.reshape(B, T, H, D), freqs)
    v = v.reshape(B, T, H, D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / np.sqrt(D)
    scores = torch.where(mask[None, None], scores, float("-inf"))
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, T, H * D)
    return out @ p["wo"]["w"]


def lconv_apply(p: Dict, cfg: WindowedTransformerConfig, x: torch.Tensor) -> torch.Tensor:
    """The depthwise-conv branch: RMS -> GLU -> causal depthwise conv ->
    RMS -> SiLU -> linear, LayerScale residual."""
    y = rms_norm(x, p["pre_norm"]["w"], cfg.norm_eps) @ p["w_start"]["w"]
    a, b = torch.chunk(y, 2, dim=-1)
    y = a * torch.sigmoid(b)
    w = p["dw"]["w"][:, 0, :].t()[:, None, :]  # (dim, 1, k)
    k = w.shape[-1]
    y = F.conv1d(F.pad(y.transpose(1, 2), (k - 1, 0)), w.to(y.dtype),
                 groups=cfg.dim).transpose(1, 2)
    y = rms_norm(y, p["conv_norm"]["w"], cfg.norm_eps)
    return x + p["scale"] * (F.silu(y) @ p["w_end"]["w"])


def block_apply(p: Dict, cfg: WindowedTransformerConfig, x: torch.Tensor,
                freqs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    h = x + p["attn_scale"] * attention(
        p, cfg, rms_norm(x, p["attention_norm"]["w"], cfg.norm_eps), freqs, mask)
    if "lconv" in p:
        h = lconv_apply(p["lconv"], cfg, h)
    ff = rms_norm(h, p["ffn_norm"]["w"], cfg.norm_eps)
    ff = (F.silu(ff @ p["w1"]["w"]) * (ff @ p["w3"]["w"])) @ p["w2"]["w"]
    return h + p["ffn_scale"] * ff


def apply(params: Dict, cfg: WindowedTransformerConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, dim) -> (B, T, dim), window-limited causal over the sequence."""
    T = x.shape[1]
    freqs = torch.from_numpy(precompute_freqs_cis(T, cfg.head_dim, cfg.rope_base)).to(x.device)
    mask = torch.from_numpy(window_limited_mask(T, cfg.window_size)).to(x.device)
    for l in range(cfg.n_layer):
        x = block_apply(layer(params["layers"], l), cfg, x, freqs, mask)
    return rms_norm(x, params["final_norm"]["w"], cfg.norm_eps)
