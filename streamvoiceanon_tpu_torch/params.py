"""The weight bridge: the JAX package's parameter trees (numpy arrays) to
the port's (torch tensors on one device).

Covers the three trees a voice converter holds — tokenizer, vocoder and
ARVC — from `utils/randparams` or from the JAX package's
`runtime/convert.py` (layer lists) or `dual_ar.prepare_params` (stacked
layers).  Conv weights change from the channels-last layouts of
`runtime/convert.py` to PyTorch's:

  Conv1d           (k, in/groups, out) -> (out, in/groups, k)
  ConvTranspose1d  (k, in, out)        -> (in, out, k)
  Linear           (in, out)           kept: the port computes x @ w

Only the parts of the tokenizer and vocoder trees the streaming path uses
are carried (the pre-quantization transformer, not the post one; the
decode side of the codec, not its encoder).  Layer lists are stacked once
here into one tree of (L, ...) arrays (the dual-AR layers and the windowed
transformer's).  A `Converter` packs, once, the weights of the fused
kernels its program set runs: with `HiFiGANConfig.use_pallas_stream` the
head's (`vocoder_params["head_packed"]`), with
`TokenizerConfig.use_pallas_encoder` the ConvNeXt front's
(`tokenizer_params["enc_packed"]`, and beside it its matrices unit-packed
for the front kernel, `tokenizer_params["enc_units"]`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from streamvoiceanon_tpu_torch import resolve_device
from streamvoiceanon_tpu_torch.config import PipelineConfig
from streamvoiceanon_tpu_torch.ops import convnext_enc as encops
from streamvoiceanon_tpu_torch.ops import hifigan as headops


def _np(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes arrays: go through float32
        a = a.astype(np.float32)
    return a


def _t(a, device, dtype=None) -> torch.Tensor:
    a = _np(a)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a)
    t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def tree(x, device, dtype=None):
    """Every array of a nested dict/list tree as a tensor; floating leaves
    cast to `dtype` when given."""
    if isinstance(x, dict):
        return {k: tree(v, device, dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [tree(v, device, dtype) for v in x]
    return _t(x, device, dtype)


def _stack(layers):
    """A list of per-layer trees -> one tree of arrays with a layer axis."""
    if isinstance(layers, dict):
        return layers
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lp[k] for lp in layers]) for k in first}
    return np.stack([_np(a) for a in layers])


def conv_weight(w) -> np.ndarray:
    """Conv1d (k, in/groups, out) -> (out, in/groups, k)."""
    return np.transpose(_np(w), (2, 1, 0))


def trans_conv_weight(w) -> np.ndarray:
    """ConvTranspose1d (k, in, out) -> (in, out, k)."""
    return np.transpose(_np(w), (1, 2, 0))


def _conv(p, device, dtype):
    return {"w": _t(conv_weight(p["w"]), device, dtype), "b": _t(p["b"], device, dtype)}


def _tconv(p, device, dtype):
    return {"w": _t(trans_conv_weight(p["w"]), device, dtype),
            "b": _t(p["b"], device, dtype)}


def _block(p, device, dtype):
    out = tree({k: v for k, v in p.items() if k != "dwconv"}, device, dtype)
    out["dwconv"] = _conv(p["dwconv"], device, dtype)
    return out


def windowed_transformer_params(p: Dict, device, dtype=torch.float32) -> Dict:
    """The windowed transformer with its layer list stacked: every leaf of
    `layers` gains a leading (L,) axis."""
    q = dict(p)
    q["layers"] = _stack(p["layers"])
    return tree(q, device, dtype)


def tokenizer_params(p: Dict, device, dtype=torch.float32) -> Dict:
    bb = p["backbone"]
    backbone = {}
    for k, v in bb.items():
        if k == "stem_conv":
            backbone[k] = _conv(v, device, dtype)
        elif k.startswith("mid_conv_"):  # a 1x1 conv: x @ w[0]
            backbone[k] = {"w": _t(_np(v["w"])[0], device, dtype),
                           "b": _t(v["b"], device, dtype)}
        elif k.startswith("stage_"):
            backbone[k] = [_block(b, device, dtype) for b in v]
        else:
            backbone[k] = tree(v, device, dtype)
    return {
        "backbone": backbone,
        "downsample": [{"conv": _conv(s["conv"], device, dtype),
                        "block": _block(s["block"], device, dtype)}
                       for s in p["downsample"]],
        "pre_module": windowed_transformer_params(p["pre_module"], device, dtype),
        "lfq": tree(p["lfq"], device, dtype),
    }


def hifigan_params(h: Dict, device, dtype=torch.float32) -> Dict:
    return {
        "conv_pre": _conv(h["conv_pre"], device, dtype),
        "ups": [_tconv(u, device, dtype) for u in h["ups"]],
        "resblocks": [
            [{"convs1": [_conv(c, device, dtype) for c in rb["convs1"]],
              "convs2": [_conv(c, device, dtype) for c in rb["convs2"]]}
             for rb in stage]
            for stage in h["resblocks"]
        ],
        "conv_post": _conv(h["conv_post"], device, dtype),
    }


def vocoder_params(p: Dict, device, dtype=torch.float32) -> Dict:
    """The decode side of the codec."""
    return {
        "upsample": [{"conv": _tconv(s["conv"], device, dtype),
                      "block": _block(s["block"], device, dtype)}
                     for s in p["upsample"]],
        "fsq": tree(p["fsq"], device, dtype),
        "head": hifigan_params(p["head"], device, dtype),
    }


def dual_ar_params(p: Dict, device, dtype=torch.float32) -> Dict:
    q = dict(p)
    q["layers"] = _stack(p["layers"])
    q["fast_layers"] = _stack(p["fast_layers"])
    return tree(q, device, dtype)


def arvc_params(p: Dict, device, dtype=torch.float32) -> Dict:
    model = p["model"] if "model" in p else p["decoder"]["model"]
    out = tree({k: v for k, v in p.items() if k in ("embedding", "context_in",
                                                     "style_in", "wait4start",
                                                     "wait4end")}, device, dtype)
    if "wait4start" not in p and "decoder" in p:  # runtime/convert.py layout
        out["wait4start"] = _t(p["decoder"]["wait4start"], device, dtype)
        out["wait4end"] = _t(p["decoder"]["wait4end"], device, dtype)
    out["model"] = dual_ar_params(model, device, dtype)
    return out


@dataclass
class Converter:
    """The three parameter trees of a voice converter, on one device."""

    cfg: PipelineConfig
    tokenizer_params: Dict
    vocoder_params: Dict
    arvc_params: Dict
    device: torch.device

    def __post_init__(self):
        """Pack the weights of the fused kernels `cfg` runs where the trees
        lack them (also for a converter re-used under another program set
        through `dataclasses.replace`)."""
        tcfg, hcfg = self.cfg.tokenizer, self.cfg.vocoder.head
        if tcfg.use_pallas_encoder and "enc_units" not in self.tokenizer_params:
            pw = (self.tokenizer_params.get("enc_packed")
                  or encops.packed_weights(self.tokenizer_params, tcfg))
            self.tokenizer_params = {**self.tokenizer_params, "enc_packed": pw,
                                     "enc_units": encops.unit_weights(pw)}
        if hcfg.use_pallas_stream and "head_packed" not in self.vocoder_params:
            self.vocoder_params = {**self.vocoder_params,
                                   "head_packed": headops.packed_weights(
                                       self.vocoder_params["head"], hcfg)}


def converter_from_numpy(cfg: PipelineConfig, tokenizer_np: Dict, vocoder_np: Dict,
                         arvc_np: Dict, *, device: Optional[str] = None,
                         lm_dtype=torch.float32) -> Converter:
    """Carry the JAX-layout numpy trees over to `device` (the CUDA card
    unless given).  `lm_dtype` applies to the whole ARVC tree (bf16 is the
    serving point); the tokenizer and vocoder stay in float32."""
    dev = resolve_device(device)
    return Converter(
        cfg=cfg,
        tokenizer_params=tokenizer_params(tokenizer_np, dev),
        vocoder_params=vocoder_params(vocoder_np, dev),
        arvc_params=arvc_params(arvc_np, dev, lm_dtype),
        device=dev,
    )
