"""Reference state_dicts -> the JAX package's channels-last numpy trees, as
the JAX package's runtime/convert.py (the port's own copy).

The published StreamVoiceAnon checkpoints are PyTorch state_dicts of the
reference modules.  These converters map them (or any state_dict in the
reference's key layout) to numpy trees in the JAX package's layouts, which
`params.py` then carries over to the port's tensors (`tokenizer_params`,
`vocoder_params`, `arvc_params` after `prepare_params`, and through
`models/campplus.convert` / `models/speaker_encoder.convert` the CAM++ and
speaker-encoder trees).

Layout conventions converted here:
  Conv1d          (out, in/g, k) -> (k, in/g, out)
  ConvTranspose1d (in, out, k)   -> (k, in, out)
  Linear          (out, in)      -> (in, out)
Weight-norm parametrizations (`...parametrizations.weight.original{0,1}`)
are resolved to plain weights with the dim-0 norm, as
torch.nn.utils.parametrizations.weight_norm computes them.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List

import numpy as np

from streamvoiceanon_tpu_torch.config import (
    ARVCConfig,
    ConvNeXtConfig,
    DualARConfig,
    HiFiGANConfig,
    TokenizerConfig,
    VocoderConfig,
    WindowedTransformerConfig,
)


def to_numpy(sd: Dict) -> Dict[str, np.ndarray]:
    """Accepts a torch state_dict or a dict of arrays; returns numpy dict.
    A CoverageDict passes through unchanged (already numpy, keeps tracking)."""
    if isinstance(sd, CoverageDict):
        return sd
    out = {}
    for k, v in sd.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu()
            if str(v.dtype) == "torch.bfloat16":  # numpy has no bf16
                v = v.float()
            v = v.numpy()
        out[k] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# Key-coverage contract
#
# The reference loads checkpoints non-strict (evaluations/infer_arvc.py:70-83,
# 160-165), silently dropping keys a rename or geometry mismatch orphaned.
# Here every converter can run under a CoverageDict that records exactly which
# checkpoint keys were consumed; convert_strict() then refuses a load that
# leaves keys behind, listing them — no silent drops.
# ---------------------------------------------------------------------------


class CoverageDict:
    """Read-tracking view over a numpy state_dict.

    Plain `sd[k]` / `sd.get(k)` accesses mark `k` (resolved to the ORIGINAL
    checkpoint key through renames/subsets) as consumed; membership tests and
    iteration do not.  `subset`/`rename` build linked views that report reads
    into the same root `read` set, so prefix-stripping (arvc decoder.*) and
    key remaps (campplus xvector.*) keep the contract intact."""

    def __init__(self, data: Dict[str, np.ndarray], _read=None, _alias=None):
        self._d = dict(data)
        self.read = set() if _read is None else _read
        self._alias = _alias or {}

    def __getitem__(self, k):
        v = self._d[k]
        self.read.add(self._alias.get(k, k))
        return v

    def get(self, k, default=None):
        return self[k] if k in self._d else default

    def __contains__(self, k):
        return k in self._d

    def __iter__(self):
        return iter(self._d)

    def __len__(self):
        return len(self._d)

    def keys(self):
        return self._d.keys()

    def values(self):  # untracked — only converters' key plumbing uses it
        return self._d.values()

    def items(self):  # untracked — used for prefix filtering, not reads
        return self._d.items()

    def subset(self, prefix: str) -> "CoverageDict":
        sub, alias = {}, {}
        for k, v in self._d.items():
            if k.startswith(prefix):
                kk = k[len(prefix):]
                sub[kk] = v
                alias[kk] = self._alias.get(k, k)
        return CoverageDict(sub, _read=self.read, _alias=alias)

    def rename(self, fn: Callable[[str], str]) -> "CoverageDict":
        sub, alias = {}, {}
        for k, v in self._d.items():
            kk = fn(k)
            sub[kk] = v
            alias[kk] = self._alias.get(k, k)
        return CoverageDict(sub, _read=self.read, _alias=alias)

    def unread(self):
        return sorted(set(self._alias.get(k, k) for k in self._d) - self.read)


def strip_prefix(sd, prefix: str):
    """Subset `sd` to keys under `prefix` (tracking-preserving)."""
    if isinstance(sd, CoverageDict):
        return sd.subset(prefix)
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def rename_keys(sd, fn: Callable[[str], str]):
    """Remap keys of `sd` (tracking-preserving)."""
    if isinstance(sd, CoverageDict):
        return sd.rename(fn)
    return {fn(k): v for k, v in sd.items()}


# torch bookkeeping / derived-constant buffers no converter should consume
DEFAULT_IGNORED_KEYS = (
    r"\.num_batches_tracked$",
    r"(^|\.)freqs_cis$",      # precomputed rope buffers, rebuilt natively
    r"(^|\.)causal_mask$",
    # BSQ bit-weight constant 2**arange(bits) (reference bsq.py:230),
    # derived from codebook_bits in ops/quantizers.lfq_encode
    r"\.rvqs\.\d+\.mask$",
)


def convert_with_coverage(fn: Callable, sd: Dict, *args, ignore=DEFAULT_IGNORED_KEYS,
                          **kw):
    """Run converter `fn(sd, *args, **kw)` under read tracking.

    Returns (params, leftover): `leftover` is every checkpoint key the
    converter never consumed (after dropping `ignore` patterns)."""
    cov = CoverageDict(to_numpy(sd))
    params = fn(cov, *args, **kw)
    leftover = [k for k in cov.unread()
                if not any(re.search(p, k) for p in ignore)]
    return params, leftover


def convert_strict(fn: Callable, sd: Dict, *args, ignore=DEFAULT_IGNORED_KEYS, **kw):
    """Like `fn(sd, ...)` but refuses loads that leave checkpoint keys
    unconsumed — the strict counterpart of the reference's non-strict
    `load_state_dict(..., strict=False)` (infer_arvc.py:70-83)."""
    params, leftover = convert_with_coverage(fn, sd, *args, ignore=ignore, **kw)
    if leftover:
        shown = ", ".join(leftover[:12]) + (" ..." if len(leftover) > 12 else "")
        raise KeyError(
            f"checkpoint has {len(leftover)} key(s) the converter never "
            f"consumed (silent drops disallowed): {shown}")
    return params


def _weight(sd: Dict[str, np.ndarray], prefix: str) -> np.ndarray:
    """Fetch `<prefix>.weight`, resolving weight-norm parametrizations."""
    if f"{prefix}.weight" in sd:
        return sd[f"{prefix}.weight"]
    g = sd[f"{prefix}.parametrizations.weight.original0"]
    v = sd[f"{prefix}.parametrizations.weight.original1"]
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
    return g * v / norm


def conv1d(sd, prefix) -> Dict:
    w = _weight(sd, prefix)  # (out, in/g, k)
    p = {"w": np.transpose(w, (2, 1, 0))}
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def conv_transpose1d(sd, prefix) -> Dict:
    w = _weight(sd, prefix)  # (in, out, k)
    p = {"w": np.transpose(w, (2, 0, 1))}
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def linear(sd, prefix) -> Dict:
    p = {"w": np.transpose(_weight(sd, prefix))}
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def norm(sd, prefix) -> Dict:
    p = {"w": sd[f"{prefix}.weight"]}
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def embedding(sd, prefix) -> np.ndarray:
    return sd[f"{prefix}.weight"]


# ---------------------------------------------------------------------------
# ConvNeXt
# ---------------------------------------------------------------------------


def convnext_block(sd, prefix) -> Dict:
    return {
        "dwconv": conv1d(sd, f"{prefix}.dwconv.conv"),
        "norm": norm(sd, f"{prefix}.norm"),
        "pwconv1": linear(sd, f"{prefix}.pwconv1"),
        "pwconv2": linear(sd, f"{prefix}.pwconv2"),
        "gamma": sd.get(f"{prefix}.gamma"),
    }


def convnext_encoder(sd, cfg: ConvNeXtConfig, prefix: str) -> Dict:
    p: Dict = {
        "stem_conv": conv1d(sd, f"{prefix}.downsample_layers.0.0.conv"),
        "stem_norm": norm(sd, f"{prefix}.downsample_layers.0.1"),
        "final_norm": norm(sd, f"{prefix}.norm"),
    }
    for i in range(len(cfg.depths) - 1):
        p[f"mid_norm_{i}"] = norm(sd, f"{prefix}.downsample_layers.{i+1}.0")
        p[f"mid_conv_{i}"] = conv1d(sd, f"{prefix}.downsample_layers.{i+1}.1")
    for i, depth in enumerate(cfg.depths):
        p[f"stage_{i}"] = [
            convnext_block(sd, f"{prefix}.stages.{i}.{j}") for j in range(depth)
        ]
    if f"{prefix}.g_in.weight" in sd:
        p["g_in"] = conv1d(sd, f"{prefix}.g_in")
    return p


# ---------------------------------------------------------------------------
# HiFiGAN
# ---------------------------------------------------------------------------


def hifigan(sd, cfg: HiFiGANConfig, prefix: str) -> Dict:
    p: Dict = {
        "conv_pre": conv1d(sd, f"{prefix}.conv_pre.conv"),
        "conv_post": conv1d(sd, f"{prefix}.conv_post.conv"),
        "ups": [],
        "resblocks": [],
    }
    for i in range(len(cfg.upsample_rates)):
        p["ups"].append(conv_transpose1d(sd, f"{prefix}.ups.{i}.conv"))
        blocks = []
        for j in range(len(cfg.resblock_kernel_sizes)):
            bp = f"{prefix}.resblocks.{i}.blocks.{j}"
            n = len(cfg.resblock_dilation_sizes[j])
            blocks.append(
                {
                    "convs1": [conv1d(sd, f"{bp}.convs1.{k}.conv") for k in range(n)],
                    "convs2": [conv1d(sd, f"{bp}.convs2.{k}.conv") for k in range(n)],
                }
            )
        p["resblocks"].append(blocks)
    return p


# ---------------------------------------------------------------------------
# Quantizer stacks
# ---------------------------------------------------------------------------


def downsample_stack(sd, prefix: str, n: int) -> List[Dict]:
    """FishConvNet + ConvNeXtBlock pairs (fsq.py:46-59 / bsq_no_upsample.py:48-61)."""
    return [
        {
            "conv": conv1d(sd, f"{prefix}.{i}.0.conv"),
            "block": convnext_block(sd, f"{prefix}.{i}.1"),
        }
        for i in range(n)
    ]


def upsample_stack(sd, prefix: str, n: int) -> List[Dict]:
    return [
        {
            "conv": conv_transpose1d(sd, f"{prefix}.{i}.0.conv"),
            "block": convnext_block(sd, f"{prefix}.{i}.1"),
        }
        for i in range(n)
    ]


def grouped_residual_fsq(sd, prefix: str, groups: int) -> Dict:
    p = {}
    for g in range(groups):
        gp = {}
        if f"{prefix}.rvqs.{g}.project_in.weight" in sd:
            gp["project_in"] = linear(sd, f"{prefix}.rvqs.{g}.project_in")
            gp["project_out"] = linear(sd, f"{prefix}.rvqs.{g}.project_out")
        p[f"group_{g}"] = gp
    return p


def lfq(sd, prefix: str) -> Dict:
    return {
        "project_in": linear(sd, f"{prefix}.project_in"),
        "project_out": linear(sd, f"{prefix}.project_out"),
    }


# ---------------------------------------------------------------------------
# Full models (state_dicts of the reference top-level modules)
# ---------------------------------------------------------------------------


def vocoder(sd, cfg: VocoderConfig) -> Dict:
    """Reference firefly.FireflyArchitecture state_dict -> FireflyCodec params."""
    sd = to_numpy(sd)
    nf = len(cfg.quantizer.downsample_factor)
    return {
        "backbone": convnext_encoder(sd, cfg.backbone, "backbone"),
        "head": hifigan(sd, cfg.head, "head"),
        "downsample": downsample_stack(sd, "quantizer.downsample", nf),
        "upsample": upsample_stack(sd, "quantizer.upsample", nf),
        "fsq": grouped_residual_fsq(sd, "quantizer.residual_fsq", cfg.quantizer.n_groups),
    }


def windowed_transformer(sd, cfg: WindowedTransformerConfig, prefix: str) -> Dict:
    layers = []
    for i in range(cfg.n_layer):
        lp = f"{prefix}.layers.{i}"
        layers.append(
            {
                "wqkv": linear(sd, f"{lp}.attention.wqkv"),
                "wo": linear(sd, f"{lp}.attention.wo"),
                "attention_norm": norm(sd, f"{lp}.attention_norm"),
                "ffn_norm": norm(sd, f"{lp}.ffn_norm"),
                "w1": linear(sd, f"{lp}.feed_forward.w1"),
                "w2": linear(sd, f"{lp}.feed_forward.w2"),
                "w3": linear(sd, f"{lp}.feed_forward.w3"),
                "attn_scale": sd[f"{lp}.attention_layer_scale.gamma"],
                "ffn_scale": sd[f"{lp}.ffn_layer_scale.gamma"],
            }
        )
        if f"{lp}.lconv1d.linear_start.weight" in sd:
            # depthwise-conv branch (windowed_transformer.py:197-234);
            # torch depthwise Conv1d weight (d, 1, k) -> channels-last (k, 1, d)
            layers[-1]["lconv"] = {
                "pre_norm": norm(sd, f"{lp}.lconv1d.pre_layer_norm"),
                "conv_norm": norm(sd, f"{lp}.lconv1d.conv_norm"),
                "w_start": linear(sd, f"{lp}.lconv1d.linear_start"),
                "dw": {"w": np.transpose(sd[f"{lp}.lconv1d.depthwise_conv1d.weight"], (2, 1, 0))},
                "w_end": linear(sd, f"{lp}.lconv1d.linear_end"),
                "scale": sd[f"{lp}.lconv1d.layer_scale.gamma"],
            }
    return {"layers": layers, "final_norm": norm(sd, f"{prefix}.norm")}


def tokenizer(sd, cfg: TokenizerConfig) -> Dict:
    """Reference firefly_encoder.FireflyArchitecture state_dict -> params."""
    sd = to_numpy(sd)
    nf = len(cfg.quantizer.downsample_factor)
    p = {
        "backbone": convnext_encoder(sd, cfg.backbone, "backbone"),
        "downsample": downsample_stack(sd, "quantizer.downsample", nf),
        "pre_module": windowed_transformer(sd, cfg.transformer, "quantizer.pre_module"),
        "post_module": windowed_transformer(sd, cfg.transformer, "quantizer.post_module"),
        "lfq": lfq(sd, "quantizer.residual_bsq.rvqs.0"),
    }
    if "head.downsample_layers.0.0.conv.weight" in sd or any(
        k.startswith("head.") for k in sd
    ):
        p["head"] = convnext_encoder(sd, cfg.head, "head")
    return p


def _attention(sd, prefix: str, qkv_bias: bool = False) -> Dict:
    return {"wqkv": linear(sd, f"{prefix}.wqkv"), "wo": linear(sd, f"{prefix}.wo")}


def _transformer_block(sd, prefix: str) -> Dict:
    return {
        "wqkv": linear(sd, f"{prefix}.attention.wqkv"),
        "wo": linear(sd, f"{prefix}.attention.wo"),
        "attention_norm": norm(sd, f"{prefix}.attention_norm"),
        "ffn_norm": norm(sd, f"{prefix}.ffn_norm"),
        "w1": linear(sd, f"{prefix}.feed_forward.w1"),
        "w2": linear(sd, f"{prefix}.feed_forward.w2"),
        "w3": linear(sd, f"{prefix}.feed_forward.w3"),
    }


def dual_ar(sd, cfg: DualARConfig, prefix: str = "model") -> Dict:
    """Reference DualARTransformer (inside DualARWrapper) -> params."""
    sd = to_numpy(sd)
    pre = f"{prefix}." if prefix else ""
    p: Dict = {
        "embeddings": embedding(sd, f"{pre}embeddings"),
        "codebook_embeddings": embedding(sd, f"{pre}codebook_embeddings"),
        "layers": [_transformer_block(sd, f"{pre}layers.{i}") for i in range(cfg.n_layer)],
        "norm": norm(sd, f"{pre}norm"),
        "fast_embeddings": embedding(sd, f"{pre}fast_embeddings"),
        "fast_layers": [
            _transformer_block(sd, f"{pre}fast_layers.{i}")
            for i in range(cfg.n_fast_layer)
        ],
        "fast_norm": norm(sd, f"{pre}fast_norm"),
        "fast_output": linear(sd, f"{pre}fast_output"),
    }
    if not cfg.tie_word_embeddings:
        p["output"] = linear(sd, f"{pre}output")
    if f"{pre}fast_project_in.weight" in sd:
        p["fast_project_in"] = linear(sd, f"{pre}fast_project_in")
    return p


def dual_ar_wrapper(sd, cfg: DualARConfig) -> Dict:
    """Reference DualARWrapper state_dict -> {model, wait4start, wait4end}."""
    sd = to_numpy(sd)
    p = {"model": dual_ar(sd, cfg, prefix="model")}
    if "wait4start_embedding.weight" in sd:
        p["wait4start"] = sd["wait4start_embedding.weight"]
        p["wait4end"] = sd["wait4end_embedding.weight"]
    return p


def arvc(sd, cfg: ARVCConfig) -> Dict:
    """Reference ARVCWrapper state_dict -> full VC-model params."""
    sd = to_numpy(sd)
    return {
        "embedding": embedding(sd, "embedding"),
        "context_in": linear(sd, "context_in"),
        "style_in": linear(sd, "style_in"),
        "decoder": dual_ar_wrapper(strip_prefix(sd, "decoder."), cfg.decoder),
    }
