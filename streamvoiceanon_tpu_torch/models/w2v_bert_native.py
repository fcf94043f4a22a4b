"""The w2v-BERT 2.0 conformer encoder, as the JAX package's
models/w2v_bert_native.py (HF `Wav2Vec2BertModel` with the default
`relative_key` position embeddings): feature projection -> N conformer
blocks, each a macaron feed-forward x 0.5, self-attention with a learned
bias by clamped relative distance, the causal depthwise-conv module with
GLU, a second feed-forward x 0.5 and a final LayerNorm.  It is the
distillation teacher of the content encoder (truncated at layer 17,
`models/w2v_bert.py`) and the backbone of the conformer ASR_eval
recogniser (`evals/asr_eval_w2v.py`).

Trees.  `convert` turns a HF state_dict into the JAX package's numpy tree
(layers stacked on a leading axis, linears (in, out), the depthwise conv
(k, 1, H)), equal to JAX's `convert` leaf for leaf; `params.w2v_bert_params`
carries such a tree to torch, where the depthwise conv becomes PyTorch's
(L, H, 1, k).  `init_params` draws a random tree in the port's layout on a
`torch.Generator`'s device with the JAX package's distributions.

`stacked_features` is the SeamlessM4T featurisation without a checkpoint:
Kaldi 80-bin power fbank with HF's pre-emphasis, per-utterance per-bin
mean and variance (ddof 1) over the valid frames, stride-2 stacking to 160.

`apply` computes in its weights' dtype: with float16 weights (the
content encoder's frozen teacher, `models/w2v_bert.py`) every matrix
product, the attention and the convolution run in float16, and each
LayerNorm takes its statistics in float32.

All of it is plain PyTorch: the JAX package computes it outside any Pallas
kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from streamvoiceanon_tpu_torch.audio.fbank import _dft_mats, kaldi_mel_banks, povey_window


@dataclasses.dataclass(frozen=True)
class W2VBertConfig:
    feat_dim: int = 160           # stacked-fbank input features
    hidden: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    intermediate: int = 4096
    conv_kernel: int = 31
    left_max_pos: int = 64        # relative_key clamp range
    right_max_pos: int = 8
    eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads


def _ln(p, x, eps):
    """LayerNorm with the biased variance, as `jnp.var`, in x's dtype: on
    half tensors its statistics, scale and shift are taken in float32, as
    `torch.nn.LayerNorm` takes them."""
    return F.layer_norm(x, (x.shape[-1],), p["w"].to(x.dtype), p["b"].to(x.dtype), eps)


def _lin(p, x):
    return x @ p["w"] + p["b"] if "b" in p else x @ p["w"]


def _ffn(p, x):
    return _lin(p["out"], F.silu(_lin(p["in"], x)))


def _rel_key_bias(q, table, left, right):
    """relative_key bias: the learned key embedding of the clamped distance
    r - l, dotted with the query of row l."""
    T = q.shape[2]
    ar = torch.arange(T, device=q.device)
    dist = torch.clamp(ar[None, :] - ar[:, None], -left, right) + left
    return torch.einsum("bhld,lrd->bhlr", q, table[dist].to(q.dtype))


def _attention(p, cfg: W2VBertConfig, x, bias):
    B, T, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    split = lambda t: t.reshape(B, T, H, hd).transpose(1, 2)
    q, k, v = split(_lin(p["q"], x)), split(_lin(p["k"], x)), split(_lin(p["v"], x))
    scale = float(np.sqrt(hd))
    scores = q @ k.transpose(-1, -2) / scale
    scores = scores + _rel_key_bias(q, p["dist"], cfg.left_max_pos, cfg.right_max_pos) / scale
    if bias is not None:
        scores = scores + bias
    out = (torch.softmax(scores, -1) @ v).transpose(1, 2).reshape(B, T, H * hd)
    return _lin(p["o"], out)


def _conv_module(p, cfg: W2VBertConfig, x, pad_mask):
    """LN -> pointwise -> GLU -> causal depthwise conv -> LN -> SiLU ->
    pointwise."""
    h = _ln(p["ln"], x, cfg.eps)
    if pad_mask is not None:
        h = h * pad_mask[..., None]
    a, b = torch.chunk(h @ p["pw1"], 2, dim=-1)
    h = (a * torch.sigmoid(b)).transpose(1, 2)  # (B, H, T)
    h = F.conv1d(F.pad(h, (cfg.conv_kernel - 1, 0)), p["dw"], groups=cfg.hidden)
    h = F.silu(_ln(p["dw_ln"], h.transpose(1, 2), cfg.eps))
    return h @ p["pw2"]


def _layer_params(layers: Dict, l: int) -> Dict:
    if isinstance(layers, dict):
        return {k: _layer_params(v, l) for k, v in layers.items()}
    return layers[l]


def _layer(p, cfg: W2VBertConfig, x, bias, pad_mask):
    x = x + 0.5 * _ffn(p["ffn1"], _ln(p["ffn1_ln"], x, cfg.eps))
    x = x + _attention(p["attn"], cfg, _ln(p["attn_ln"], x, cfg.eps), bias)
    x = x + _conv_module(p["conv"], cfg, x, pad_mask)
    x = x + 0.5 * _ffn(p["ffn2"], _ln(p["ffn2_ln"], x, cfg.eps))
    return _ln(p["final_ln"], x, cfg.eps)


def apply(params: Dict, cfg: W2VBertConfig, feats: torch.Tensor,
          mask: Optional[torch.Tensor] = None,
          num_layers: Optional[int] = None) -> torch.Tensor:
    """feats (B, T, feat_dim), mask (B, T) 1 = valid -> the hidden states
    after `num_layers` conformer blocks (None: all of them), in the
    weights' dtype: the featurisation's LayerNorm runs on `feats` as they
    come (float32 from `stacked_features`) and its output is cast to the
    weights' dtype at the projection.  Padded keys take a bias of the
    dtype's most negative finite value, as in the JAX package (finite, not
    -inf)."""
    x = _lin(params["proj"],
             _ln(params["fp_ln"], feats, cfg.eps).to(params["proj"]["w"].dtype))
    bias = pad_mask = None
    if mask is not None:
        pad_mask = mask.to(x.dtype)
        x = x * pad_mask[..., None]
        bias = (1.0 - pad_mask)[:, None, None, :] * torch.finfo(x.dtype).min
    n = cfg.n_layers if num_layers is None else num_layers
    for l in range(n):
        x = _layer(_layer_params(params["layers"], l), cfg, x, bias, pad_mask)
    return x


def stacked_features(wav16k: torch.Tensor,
                     x_lens: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """wav (B, T) float in [-1, 1] at 16 kHz -> (features (B, T', 160) float32,
    mask (B, T') int32), the teacher's input featurisation: Kaldi mel 80-bin
    power-2 fbank (400 / 160 / 512, Povey window, DC removal, pre-emphasis
    0.97 with HF's first-sample scaling, mel floor 2^-23), per-bin mean and
    variance normalisation (ddof 1) over each utterance's valid frames, then
    stride-2 frame stacking (a half-valid last row is masked out)."""
    if wav16k.ndim == 1:
        wav16k = wav16k[None]
    win, hop, padded, n_mel = 400, 160, 512, 80
    x = wav16k.float() * 32768.0
    B, T = x.shape
    dev = x.device
    m = 1 + (T - win) // hop
    if x_lens is None:
        x_lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    frame_lens = 1 + (x_lens.to(dev).long() - win) // hop

    frames = x.unfold(-1, win, hop)  # (B, m, win)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    pre = frames - 0.97 * prev
    frames = torch.cat([frames[..., :1] * (1.0 - 0.97), pre[..., 1:]], dim=-1)
    frames = frames * torch.from_numpy(povey_window(win).astype(np.float32)).to(dev)
    frames = F.pad(frames, (0, padded - win))
    cos_m, sin_m = (torch.from_numpy(a).to(dev) for a in _dft_mats(padded))
    re, im = frames @ cos_m, frames @ sin_m
    power = re * re + im * im
    mel_fb = torch.from_numpy(kaldi_mel_banks(n_mel, padded, 16000.0)).to(dev)
    mel = torch.log(torch.clamp(power @ mel_fb, min=1.192092955078125e-07))

    valid = (torch.arange(m, device=dev)[None, :] < frame_lens[:, None]).float()
    n = torch.clamp(frame_lens.float(), min=1.0)[:, None]
    mean = torch.sum(mel * valid[..., None], dim=1) / n
    var = torch.sum((mel - mean[:, None]) ** 2 * valid[..., None], dim=1) / torch.clamp(
        n - 1.0, min=1.0)
    mel = (mel - mean[:, None]) / torch.sqrt(var[:, None] + 1e-7)
    mel = mel * valid[..., None]

    m2 = (m + 1) // 2
    mel = F.pad(mel, (0, 0, 0, m2 * 2 - m))
    feats = mel.reshape(B, m2, 2 * n_mel)
    mask = (torch.arange(m2, device=dev)[None, :] < (frame_lens // 2)[:, None]).to(torch.int32)
    return feats, mask


def init_params(generator: torch.Generator, cfg: W2VBertConfig,
                dtype=torch.float32) -> Dict:
    """A random tree in the port's layout on the generator's device: He-normal
    linears with zero biases, identity LayerNorms, distance embeddings
    N(0, 0.02^2), the conv module's weights He-normal by fan-in (the JAX
    package's `init_params` distributions, not its draws)."""
    dev, H, L = generator.device, cfg.hidden, cfg.n_layers
    rn = lambda *s, std: torch.randn(s, generator=generator, device=dev, dtype=dtype) * std

    def lin(din, dout, stack=True):
        shape = (L, din, dout) if stack else (din, dout)
        return {"w": rn(*shape, std=float(np.sqrt(2.0 / din))),
                "b": torch.zeros(shape[:-2] + (dout,), device=dev, dtype=dtype)}

    def ln(n=H, stack=True):
        shape = (L, n) if stack else (n,)
        return {"w": torch.ones(shape, device=dev, dtype=dtype),
                "b": torch.zeros(shape, device=dev, dtype=dtype)}

    layers = {
        "ffn1_ln": ln(), "ffn1": {"in": lin(H, cfg.intermediate), "out": lin(cfg.intermediate, H)},
        "attn_ln": ln(),
        "attn": {"q": lin(H, H), "k": lin(H, H), "v": lin(H, H), "o": lin(H, H),
                 "dist": rn(L, cfg.left_max_pos + cfg.right_max_pos + 1, cfg.head_dim,
                            std=0.02)},
        "conv": {"ln": ln(), "pw1": rn(L, H, 2 * H, std=float(np.sqrt(2.0 / H))),
                 "dw": rn(L, H, 1, cfg.conv_kernel,
                          std=float(np.sqrt(2.0 / cfg.conv_kernel))),
                 "dw_ln": ln(), "pw2": rn(L, H, H, std=float(np.sqrt(2.0 / H)))},
        "ffn2_ln": ln(), "ffn2": {"in": lin(H, cfg.intermediate), "out": lin(cfg.intermediate, H)},
        "final_ln": ln(),
    }
    return {"fp_ln": ln(cfg.feat_dim, stack=False), "proj": lin(cfg.feat_dim, H, stack=False),
            "layers": layers}


# ---------------------------------------------------------------------------
# HF state_dict converter (numpy in, the JAX package's numpy tree out)
# ---------------------------------------------------------------------------


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def convert(sd: Dict, cfg: W2VBertConfig) -> Dict:
    """HF Wav2Vec2BertModel state_dict (arrays or tensors) -> the stacked
    numpy tree of the JAX package's `convert`."""

    def t(name):
        a = sd[name]
        if torch.is_tensor(a):
            a = a.detach().cpu().numpy()
        return np.asarray(a, np.float32)

    def lin(prefix):
        return {"w": t(prefix + ".weight").T, "b": t(prefix + ".bias")}

    def ln(prefix):
        return {"w": t(prefix + ".weight"), "b": t(prefix + ".bias")}

    def layer(i):
        pre = f"encoder.layers.{i}."
        return {
            "ffn1_ln": ln(pre + "ffn1_layer_norm"),
            "ffn1": {"in": lin(pre + "ffn1.intermediate_dense"),
                     "out": lin(pre + "ffn1.output_dense")},
            "attn_ln": ln(pre + "self_attn_layer_norm"),
            "attn": {
                "q": lin(pre + "self_attn.linear_q"),
                "k": lin(pre + "self_attn.linear_k"),
                "v": lin(pre + "self_attn.linear_v"),
                "o": lin(pre + "self_attn.linear_out"),
                "dist": t(pre + "self_attn.distance_embedding.weight"),
            },
            "conv": {
                "ln": ln(pre + "conv_module.layer_norm"),
                # pointwise conv (out, in, 1) -> (in, out); depthwise (H, 1, k) -> (k, 1, H)
                "pw1": t(pre + "conv_module.pointwise_conv1.weight")[:, :, 0].T,
                "dw": t(pre + "conv_module.depthwise_conv.weight").transpose(2, 1, 0),
                "dw_ln": ln(pre + "conv_module.depthwise_layer_norm"),
                "pw2": t(pre + "conv_module.pointwise_conv2.weight")[:, :, 0].T,
            },
            "ffn2_ln": ln(pre + "ffn2_layer_norm"),
            "ffn2": {"in": lin(pre + "ffn2.intermediate_dense"),
                     "out": lin(pre + "ffn2.output_dense")},
            "final_ln": ln(pre + "final_layer_norm"),
        }

    return {
        "fp_ln": ln("feature_projection.layer_norm"),
        "proj": lin("feature_projection.projection"),
        "layers": _stack([layer(i) for i in range(cfg.n_layers)]),
    }
