"""CAM++ (D-TDNN) speaker style encoder, as the JAX package's
models/campplus.py: FCM 2-D residual stem -> dense CAM-TDNN blocks with
transit layers -> masked statistics pooling -> 192-d embedding.  Frozen at
inference; BatchNorm uses running statistics.

The input is Kaldi fbank features (B, T, 80), mean-normalised per
utterance.  Inside, activations are channels-first (B, C, T) and the 2-D
stem NCHW with H the frequency axis; weights are in PyTorch's conv layouts
(`params.campplus_params`), linear weights (in, out).  `convert` maps the
reference's state_dict to the JAX package's numpy tree, which
`params.campplus_params` carries over."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from streamvoiceanon_tpu_torch.config import CAMPPlusConfig


def _bn(p: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference BatchNorm over dim 1."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = (x - p["mean"].view(shape)) * torch.rsqrt(p["var"] + eps).view(shape)
    if "w" in p:
        y = y * p["w"].view(shape) + p["b"].view(shape)
    return y


def _res_block(p: Dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    h = F.relu(_bn(p["bn1"], F.conv2d(x, p["conv1"], stride=(stride, 1), padding=1)))
    h = _bn(p["bn2"], F.conv2d(h, p["conv2"], padding=1))
    if "shortcut_conv" in p:
        s = _bn(p["shortcut_bn"], F.conv2d(x, p["shortcut_conv"], stride=(stride, 1)))
    else:
        s = x
    return F.relu(h + s)


def _fcm(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, F) -> (B, 32 * F // 8, T), channel-major over frequency."""
    h = x.transpose(1, 2)[:, None]  # (B, 1, F, T)
    h = F.relu(_bn(p["bn1"], F.conv2d(h, p["conv1"], padding=1)))
    for layer in ("layer1", "layer2"):
        for i, blk in enumerate(p[layer]):
            h = _res_block(blk, h, stride=2 if i == 0 else 1)
    h = F.relu(_bn(p["bn2"], F.conv2d(h, p["conv2"], stride=(2, 1), padding=1)))
    B, C, Fp, T = h.shape
    return h.reshape(B, C * Fp, T)


def _cam_layer(p: Dict, x: torch.Tensor, kernel: int, dilation: int,
               seg_len: int = 100) -> torch.Tensor:
    """Context-aware masked conv on x (B, C, T): the local conv times a
    sigmoid mask of the utterance mean plus 100-frame segment means."""
    pad = (kernel - 1) // 2 * dilation
    y = F.conv1d(x, p["local_w"], dilation=dilation, padding=pad)
    B, C, T = x.shape
    nseg = -(-T // seg_len)
    seg = F.pad(x, (0, nseg * seg_len - T)).reshape(B, C, nseg, seg_len).sum(dim=3)
    counts = torch.clamp(T - torch.arange(nseg, device=x.device) * seg_len, 1, seg_len)
    seg = seg / counts.to(x.dtype)
    ctx = x.mean(dim=2, keepdim=True) + seg.repeat_interleave(seg_len, dim=2)[:, :, :T]
    ctx = ctx.transpose(1, 2)  # (B, T, C)
    m = F.relu(ctx @ p["fc1_w"] + p["fc1_b"])
    m = torch.sigmoid(m @ p["fc2_w"] + p["fc2_b"])
    return y * m.transpose(1, 2)


def _dense_layer(p: Dict, x: torch.Tensor, kernel: int, dilation: int) -> torch.Tensor:
    h = F.relu(_bn(p["nl1"], x))
    h = F.relu(_bn(p["nl2"], F.conv1d(h, p["lin1_w"])))
    return _cam_layer(p["cam"], h, kernel, dilation)


def apply(params: Dict, cfg: CAMPPlusConfig, feat: torch.Tensor,
          feat_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """feat (B, T, 80) mean-normalised -> style vector (B, embedding_size).
    `feat_lens` counts valid frames at the pooled (stride-2) rate."""
    x = _fcm(params["fcm"], feat)
    x = F.relu(_bn(params["tdnn_bn"], F.conv1d(x, params["tdnn_conv"], stride=2, padding=2)))
    for bi, (k, dil) in enumerate(zip(cfg.block_kernels, cfg.block_dilations)):
        for lp in params[f"block{bi + 1}"]:
            x = torch.cat([x, _dense_layer(lp, x, k, dil)], dim=1)
        tp = params[f"transit{bi + 1}"]
        x = F.conv1d(F.relu(_bn(tp["bn"], x)), tp["w"])
    x = F.relu(_bn(params["out_bn"], x))
    # masked statistics pooling over time: mean and unbiased std
    B, C, T = x.shape
    if feat_lens is None:
        n = torch.full((B, 1), float(T), device=x.device)
        mask = torch.ones((B, 1, T), device=x.device)
    else:
        mask = (torch.arange(T, device=x.device)[None, :] < feat_lens[:, None]).float()[:, None]
        n = feat_lens[:, None].float()
    mean = (x * mask).sum(dim=2) / n
    var = ((x - mean[:, :, None]) ** 2 * mask).sum(dim=2) / torch.clamp(n - 1.0, min=1.0)
    stats = torch.cat([mean, torch.sqrt(var)], dim=-1)
    return _bn(params["dense_bn"], stats @ params["dense_w"][:, :, 0].t())


# ---------------------------------------------------------------------------
# Converter
# ---------------------------------------------------------------------------


def _t_bn(sd, prefix) -> Dict:
    p = {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]}
    if f"{prefix}.weight" in sd:
        p["w"] = sd[f"{prefix}.weight"]
        p["b"] = sd[f"{prefix}.bias"]
    return p


def _t_conv2d(sd, prefix) -> np.ndarray:
    return np.transpose(sd[f"{prefix}.weight"], (2, 3, 1, 0))  # -> (kh, kw, in, out)


def _t_conv1d_w(sd, prefix) -> np.ndarray:
    return np.transpose(sd[f"{prefix}.weight"], (2, 1, 0))


def convert(sd, cfg: CAMPPlusConfig) -> Dict:
    """The reference CAMPPlus state_dict -> the JAX package's numpy tree
    (`utils/randparams.campplus_params_np`'s), with the reference's key
    remap of `xvector.stats` / `xvector.dense` to `stats` / `dense`."""
    from streamvoiceanon_tpu_torch.runtime.convert import rename_keys, to_numpy

    sd = rename_keys(
        to_numpy(sd),
        lambda k: k.replace("xvector.stats", "stats").replace("xvector.dense", "dense"),
    )

    def res_block(prefix):
        p = {
            "conv1": _t_conv2d(sd, f"{prefix}.conv1"),
            "bn1": _t_bn(sd, f"{prefix}.bn1"),
            "conv2": _t_conv2d(sd, f"{prefix}.conv2"),
            "bn2": _t_bn(sd, f"{prefix}.bn2"),
        }
        if f"{prefix}.shortcut.0.weight" in sd:
            p["shortcut_conv"] = _t_conv2d(sd, f"{prefix}.shortcut.0")
            p["shortcut_bn"] = _t_bn(sd, f"{prefix}.shortcut.1")
        return p

    fcm = {
        "conv1": _t_conv2d(sd, "head.conv1"),
        "bn1": _t_bn(sd, "head.bn1"),
        "conv2": _t_conv2d(sd, "head.conv2"),
        "bn2": _t_bn(sd, "head.bn2"),
        "layer1": [res_block(f"head.layer1.{i}") for i in range(2)],
        "layer2": [res_block(f"head.layer2.{i}") for i in range(2)],
    }
    p: Dict = {
        "fcm": fcm,
        "tdnn_conv": _t_conv1d_w(sd, "xvector.tdnn.linear"),
        "tdnn_bn": _t_bn(sd, "xvector.tdnn.nonlinear.batchnorm"),
        "out_bn": _t_bn(sd, "xvector.out_nonlinear.batchnorm"),
        "dense_w": _t_conv1d_w(sd, "dense.linear"),
        "dense_bn": _t_bn(sd, "dense.nonlinear.batchnorm"),
    }
    for bi, n_layers in enumerate(cfg.block_layers):
        layers = []
        for li in range(n_layers):
            lp = f"xvector.block{bi + 1}.tdnnd{li + 1}"
            layers.append({
                "nl1": _t_bn(sd, f"{lp}.nonlinear1.batchnorm"),
                "lin1_w": _t_conv1d_w(sd, f"{lp}.linear1"),
                "nl2": _t_bn(sd, f"{lp}.nonlinear2.batchnorm"),
                "cam": {
                    "local_w": _t_conv1d_w(sd, f"{lp}.cam_layer.linear_local"),
                    "fc1_w": _t_conv1d_w(sd, f"{lp}.cam_layer.linear1")[0],
                    "fc1_b": sd[f"{lp}.cam_layer.linear1.bias"],
                    "fc2_w": _t_conv1d_w(sd, f"{lp}.cam_layer.linear2")[0],
                    "fc2_b": sd[f"{lp}.cam_layer.linear2.bias"],
                },
            })
        p[f"block{bi + 1}"] = layers
        p[f"transit{bi + 1}"] = {
            "bn": _t_bn(sd, f"xvector.transit{bi + 1}.nonlinear.batchnorm"),
            "w": _t_conv1d_w(sd, f"xvector.transit{bi + 1}.linear"),
        }
    return p
