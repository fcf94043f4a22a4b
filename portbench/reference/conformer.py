"""Plain PyTorch reference of the content encoder's teacher: the w2v-BERT 2.0
conformer (`facebook/w2v-bert-2.0`, Hugging Face's `Wav2Vec2BertModel` with
`position_embeddings_type="relative_key"`) over the SeamlessM4T stacked
fbank of 16 kHz audio.

Written from the published description, not from the program:

- features (`SeamlessM4TFeatureExtractor`): the waveform times 2^15; 25 ms
  frames every 10 ms with no centring; each frame's mean removed, then
  pre-emphasis 0.97 (its first sample scaled by 0.03); a Povey window
  (a symmetric Hann window to the power 0.85); the power of a 512-point
  FFT through 80 Kaldi mel triangles between 20 Hz and 8 kHz; the natural
  log of at least 1.192092955078125e-07; each bin's mean and variance
  (ddof 1) over the utterance's frames taken out, (x - mean) / sqrt(var +
  1e-7); two frames stacked to one 160-wide row, an odd last frame
  dropped;
- the feature projection: LayerNorm, then a linear map to the hidden size;
- each conformer layer (`Wav2Vec2BertEncoderLayer`): x + 0.5 FFN1(LN x)
  with a SiLU FFN; x + MHSA(LN x), whose scores are (q k^T + q . E[clamp(r -
  l, -64, 8) + 64]) / sqrt(head size), E the learned distance embedding;
  x + Conv(x), the convolution module: LN, a 1x1 conv to twice the width,
  GLU over channels, a causal depthwise conv of kernel 31, LN, SiLU, a 1x1
  conv; x + 0.5 FFN2(LN x); a closing LayerNorm;
- the hidden states after the first `layers` layers (`hidden_states[17]`
  for the teacher of `trainers/asr_trainer.py`).

The weights are the port's tree layout (linear (in, out), layers stacked
on a leading axis, the depthwise conv (L, H, 1, k)), which `portbench`'s
trees use.  Departures: no attention mask (every frame of the padded batch
valid, as the content encoder's trainer runs the teacher); the compute
runs in the weights' dtype with each LayerNorm in float32 and the float32
features cast in at the projection, so that the same function gives the
float32 reference and, with bfloat16 weights, the control one precision
below the program's float16.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import nn


@functools.lru_cache(maxsize=2)
def _povey(n: int) -> np.ndarray:
    i = np.arange(n)
    return ((0.5 - 0.5 * np.cos(2 * np.pi * i / (n - 1))) ** 0.85).astype(np.float32)


def stacked_fbank(wav16k: torch.Tensor) -> torch.Tensor:
    """wav (B, T) at 16 kHz in [-1, 1] -> features (B, frames // 2, 160) float32."""
    x = wav16k.float() * 32768.0
    frames = x.unfold(-1, 400, 160)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    frames = torch.cat([frames[..., :1] * 0.03, frames[..., 1:] - 0.97 * frames[..., :-1]], -1)
    frames = frames * torch.from_numpy(_povey(400)).to(x.device)
    power = torch.fft.rfft(frames, n=512).abs() ** 2
    banks = torch.from_numpy(nn._kaldi_banks(80, 512, 16000.0)).to(x.device)
    mel = torch.log(torch.clamp(power @ banks, min=1.192092955078125e-07))
    mean = mel.mean(dim=1, keepdim=True)
    var = mel.var(dim=1, keepdim=True, unbiased=True)
    mel = (mel - mean) / torch.sqrt(var + 1e-7)
    n = mel.shape[1] // 2
    return mel[:, :2 * n].reshape(mel.shape[0], n, 160)


def _norm(p: Dict, x):
    return F.layer_norm(x.float(), (x.shape[-1],), p["w"].float(), p["b"].float(),
                        1e-5).to(x.dtype)


def _dense(p: Dict, x):
    return x @ p["w"] + p["b"]


def _ffn(p: Dict, x):
    return _dense(p["out"], F.silu(_dense(p["in"], x)))


def _mhsa(p: Dict, x, heads: int, left: int, right: int):
    B, T, D = x.shape
    hd = D // heads
    q, k, v = (_dense(p[n], x).view(B, T, heads, hd).transpose(1, 2) for n in "qkv")
    pos = torch.arange(T, device=x.device)
    rel = (pos[None, :] - pos[:, None]).clamp(-left, right) + left  # (l, r)
    scores = (q @ k.transpose(-1, -2)
              + torch.einsum("bhld,lrd->bhlr", q, p["dist"][rel])) / math.sqrt(hd)
    ctx = torch.softmax(scores, dim=-1) @ v
    return _dense(p["o"], ctx.transpose(1, 2).reshape(B, T, D))


def _conv(p: Dict, x, kernel: int):
    h = _norm(p["ln"], x).transpose(1, 2)  # (B, D, T)
    h = F.conv1d(h, p["pw1"].t()[:, :, None])
    h = F.glu(h, dim=1)
    h = F.conv1d(F.pad(h, (kernel - 1, 0)), p["dw"], groups=h.shape[1])
    h = F.silu(_norm(p["dw_ln"], h.transpose(1, 2)))
    return h @ p["pw2"]


def hidden_states(params: Dict, cfg, feats: torch.Tensor, layers: int) -> torch.Tensor:
    """The hidden states (B, T, hidden) float32 after `layers` layers of
    stacked features (B, T, 160)."""
    dt = params["proj"]["w"].dtype
    x = _dense(params["proj"], F.layer_norm(feats.float(), (feats.shape[-1],),
                                            params["fp_ln"]["w"].float(),
                                            params["fp_ln"]["b"].float(), 1e-5).to(dt))
    L = params["layers"]
    for i in range(layers):
        p = {k: _layer(v, i) for k, v in L.items()}
        x = x + 0.5 * _ffn(p["ffn1"], _norm(p["ffn1_ln"], x))
        x = x + _mhsa(p["attn"], _norm(p["attn_ln"], x), cfg.n_heads, cfg.left_max_pos,
                      cfg.right_max_pos)
        x = x + _conv(p["conv"], x, cfg.conv_kernel)
        x = x + 0.5 * _ffn(p["ffn2"], _norm(p["ffn2_ln"], x))
        x = _norm(p["final_ln"], x)
    return x.float()


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def teacher(params: Dict, cfg, wav16k: torch.Tensor, layers: int) -> torch.Tensor:
    """The teacher's features of a padded batch at 16 kHz: +-160 samples of
    zeros on each side, the stacked fbank, `layers` layers."""
    return hidden_states(params, cfg, stacked_fbank(F.pad(wav16k.float(), (160, 160))), layers)
