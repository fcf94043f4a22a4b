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

Only the parts of the tokenizer tree that encoding uses are carried (the
pre-quantization transformer, not the post one), unless the training
forward asks for the post-quantization transformer and the distillation
head as well (`with_head`).  The ASR side's trees (the w2v-BERT conformer,
the ASR decoder, the two ASR_eval recognisers) come over with their
layouts kept but for the conformer's convolutions.  Layer lists are stacked once
here into one tree of (L, ...) arrays (the dual-AR layers and the windowed
transformer's).  A `Converter` packs, once, the weights of the fused
kernels its program set runs: with `HiFiGANConfig.use_pallas_stream` the
head's (`vocoder_params["head_packed"]`), with
`TokenizerConfig.use_pallas_encoder` the ConvNeXt front's
(`tokenizer_params["enc_packed"]`, and beside it its matrices unit-packed
for the front kernel, `tokenizer_params["enc_units"]`).
"""

from __future__ import annotations

import functools
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


def _backbone(bb: Dict, device, dtype) -> Dict:
    """A ConvNeXt encoder (stem conv, 1x1 transitions as x @ w, blocks)."""
    backbone = {}
    for k, v in bb.items():
        if k == "stem_conv":
            backbone[k] = _conv(v, device, dtype)
        elif k.startswith("mid_conv_") or k == "g_in":  # a 1x1 conv: x @ w[0]
            backbone[k] = {"w": _t(_np(v["w"])[0], device, dtype),
                           "b": _t(v["b"], device, dtype)}
        elif k.startswith("stage_"):
            backbone[k] = [_block(b, device, dtype) for b in v]
        else:
            backbone[k] = tree(v, device, dtype)
    return backbone


def _downsample(stages, device, dtype):
    return [{"conv": _conv(s["conv"], device, dtype), "block": _block(s["block"], device, dtype)}
            for s in stages]


def tokenizer_params(p: Dict, device, dtype=torch.float32, with_head: bool = False) -> Dict:
    out = {
        "backbone": _backbone(p["backbone"], device, dtype),
        "downsample": _downsample(p["downsample"], device, dtype),
        "pre_module": windowed_transformer_params(p["pre_module"], device, dtype),
        "lfq": tree(p["lfq"], device, dtype),
    }
    if with_head:  # the training forward's parts
        out["post_module"] = windowed_transformer_params(p["post_module"], device, dtype)
        out["head"] = _backbone(p["head"], device, dtype)
    return out


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
    """The codec: its encode side (ConvNeXt encoder, downsample stages) and
    its decode side (upsample stages, FSQ, HiFiGAN head)."""
    return {
        "backbone": _backbone(p["backbone"], device, dtype),
        "downsample": _downsample(p["downsample"], device, dtype),
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


def w2v_bert_params(p: Dict, device, dtype=torch.float32) -> Dict:
    """The w2v-BERT conformer (models/w2v_bert_native.py) from the JAX
    package's numpy tree (`init_params`, or `convert` of either package):
    the stacked depthwise conv (L, k, 1, H) in PyTorch's (L, H, 1, k),
    every other leaf as it is."""
    out = tree(p, device, dtype)
    conv = out["layers"]["conv"]
    conv["dw"] = conv["dw"].permute(0, 3, 2, 1).contiguous()
    return out


def asr_decoder_params(p: Dict, device, dtype=torch.float32) -> Dict:
    """The ASR decoder (models/asr_decoder.py), its layers stacked."""
    return tree({**p, "layers": _stack(p["layers"])}, device, dtype)


def asr_eval_params(p: Dict, device, dtype=torch.float32) -> Dict:
    """The compact CTC recogniser (evals/asr_eval_train.py): its two stride-2
    convs in PyTorch's layout, the rest as it is."""
    return {**tree({k: v for k, v in p.items() if k not in ("conv1", "conv2")}, device, dtype),
            "conv1": _conv(p["conv1"], device, dtype), "conv2": _conv(p["conv2"], device, dtype)}


def asr_eval_w2v_params(p: Dict, device, dtype=torch.float32) -> Dict:
    """The conformer CTC recogniser (evals/asr_eval_w2v.py)."""
    return {"encoder": w2v_bert_params(p["encoder"], device, dtype),
            "ctc": tree(p["ctc"], device, dtype)}


def _conv2d_weight(w) -> np.ndarray:
    """Conv2d (kh, kw, in, out) -> (out, in, kh, kw)."""
    return np.transpose(_np(w), (3, 2, 0, 1))


def _convs(x, device, dtype):
    """A tree whose 3-D leaves are Conv1d weights (k, in, out) and 4-D leaves
    Conv2d weights (kh, kw, in, out), carried over in PyTorch's layouts;
    every other leaf (BatchNorm vectors, linear (in, out)) as it is."""
    if isinstance(x, dict):
        return {k: _convs(v, device, dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_convs(v, device, dtype) for v in x]
    a = _np(x)
    if a.ndim == 3:
        a = conv_weight(a)
    elif a.ndim == 4:
        a = _conv2d_weight(a)
    return _t(a, device, dtype)


def campplus_params(p: Dict, device, dtype=torch.float32) -> Dict:
    """CAM++ (models/campplus.py): its 2-D and 1-D convs in PyTorch's
    layouts, the CAM masks' linear weights (in, out)."""
    return _convs(p, device, dtype)


def speaker_params(p: Dict, device, dtype=torch.float32) -> Dict:
    """The speaker encoder (models/speaker_encoder.py): ECAPA's convs in
    PyTorch's layout, the perceiver's and FSQ's linear weights (in, out),
    and where the tree has it the x-vector head (`x_vector`; its k=1 pooling
    convs in PyTorch's layout, its linear (in, out))."""
    return _convs({k: p[k] for k in ("ecapa", "perceiver", "fsq", "xvec") if k in p},
                  device, dtype)


def ecapa_params(p: Dict, device, dtype=torch.float32) -> Dict:
    """The ECAPA attacker of evals/ecapa_asv.py ({'backbone', 'head'}): its
    convs in PyTorch's layout, its linear weights (in, out)."""
    return _convs(p, device, dtype)


def cast_tree(x, dtype):
    """Every floating tensor of a nested dict/list tree in `dtype`."""
    if isinstance(x, dict):
        return {k: cast_tree(v, dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [cast_tree(v, dtype) for v in x]
    return x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x


@dataclass
class Converter:
    """The parameter trees of a voice converter, on one device: tokenizer,
    vocoder and ARVC, and for the prompt side from audio the CAM++ and
    speaker-encoder trees."""

    cfg: PipelineConfig
    tokenizer_params: Dict
    vocoder_params: Dict
    arvc_params: Dict
    device: torch.device
    campplus_params: Optional[Dict] = None  # the speaker branch (runtime/pipeline.py)
    speaker_params: Optional[Dict] = None

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

    @functools.cached_property
    def float32_trees(self) -> Dict[str, Dict]:
        """The tokenizer and vocoder trees in float32, without the fused
        kernels' packed weights, by field name: the offline encoders and
        decode run on them (runtime/pipeline.py).  Float32 trees share their
        tensors; bf16 ones are cast once a converter."""
        packed = ("enc_packed", "enc_units", "head_packed")
        return {n: cast_tree({k: v for k, v in getattr(self, n).items() if k not in packed},
                             torch.float32)
                for n in ("tokenizer_params", "vocoder_params")}


def converter_from_numpy(cfg: PipelineConfig, tokenizer_np: Dict, vocoder_np: Dict,
                         arvc_np: Dict, *, device: Optional[str] = None,
                         lm_dtype=torch.float32, dsp_dtype=torch.float32,
                         campplus_np: Optional[Dict] = None,
                         speaker_np: Optional[Dict] = None) -> Converter:
    """Carry the JAX-layout numpy trees over to `device` (the CUDA card
    unless given).  `lm_dtype` applies to the whole ARVC tree and
    `dsp_dtype` to the tokenizer and vocoder trees (bf16 for both is the
    JAX package's serving point, bench.py `_dsp_dtype`); the packed weights
    of the fused kernels follow `dsp_dtype`.  The CAM++ and speaker-encoder
    trees, where given, stay in float32."""
    dev = resolve_device(device)
    return Converter(
        cfg=cfg,
        tokenizer_params=tokenizer_params(tokenizer_np, dev, dsp_dtype),
        vocoder_params=vocoder_params(vocoder_np, dev, dsp_dtype),
        arvc_params=arvc_params(arvc_np, dev, lm_dtype),
        device=dev,
        campplus_params=None if campplus_np is None else campplus_params(campplus_np, dev),
        speaker_params=None if speaker_np is None else speaker_params(speaker_np, dev),
    )
