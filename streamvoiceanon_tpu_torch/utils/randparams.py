"""Seeded numpy parameter factories at any geometry (benchmarks, smoke runs).

The port's own copy of the JAX package's `utils/randparams.py` for the
trees the streaming path needs: the same shapes, the same draw order, so a
seed gives the same weights in both packages.  Trees are in the JAX
package's layouts; `streamvoiceanon_tpu_torch.params` carries them over.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from streamvoiceanon_tpu_torch.config import ARVCConfig, DualARConfig


class _R:
    def __init__(self, seed: int, dtype):
        self.rng = np.random.default_rng(seed)
        self.dtype = dtype

    def n(self, *shape, std=0.02):
        return (self.rng.standard_normal(shape, dtype=np.float32) * std).astype(
            self.dtype
        )

    def he(self, *shape):
        """Fan-in-scaled init (std = sqrt(2/fan_in), last axis = out
        channels): variance-preserving through deep conv stacks, where a
        fixed std would decay activations exponentially."""
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
        return self.n(*shape, std=float(np.sqrt(2.0 / fan_in)))

    def ones(self, *shape):
        return np.ones(shape, self.dtype)

    def zeros(self, *shape):
        return np.zeros(shape, self.dtype)


def dual_ar_params_np(cfg: DualARConfig, seed: int = 0, dtype=np.float32) -> Dict:
    """Dual-AR LM tree with stacked layers (leading layer axis)."""
    r = _R(seed, dtype)

    def blocks(n, dim, n_head, n_local, head_dim, inter):
        total = (n_head + 2 * n_local) * head_dim
        return {
            "wqkv": {"w": r.n(n, dim, total)},
            "wo": {"w": r.n(n, n_head * head_dim, dim)},
            "attention_norm": {"w": r.ones(n, dim)},
            "ffn_norm": {"w": r.ones(n, dim)},
            "w1": {"w": r.n(n, dim, inter)},
            "w3": {"w": r.n(n, dim, inter)},
            "w2": {"w": r.n(n, inter, dim)},
        }

    p = {
        "embeddings": r.n(cfg.vocab_size, cfg.dim),
        "codebook_embeddings": r.n(cfg.codebook_size * cfg.num_codebooks, cfg.dim),
        "layers": blocks(cfg.n_layer, cfg.dim, cfg.n_head, cfg.n_local_heads,
                         cfg.head_dim, cfg.intermediate_size),
        "norm": {"w": r.ones(cfg.dim)},
        "fast_embeddings": r.n(cfg.codebook_size, cfg.fast_dim),
        "fast_layers": blocks(cfg.n_fast_layer, cfg.fast_dim, cfg.fast_n_head,
                              cfg.fast_n_local_heads, cfg.fast_head_dim,
                              cfg.fast_intermediate_size),
        "fast_norm": {"w": r.ones(cfg.fast_dim)},
        "fast_output": {"w": r.n(cfg.fast_dim, cfg.codebook_size)},
    }
    if not cfg.tie_word_embeddings:
        p["output"] = {"w": r.n(cfg.dim, cfg.vocab_size)}
    return p


def arvc_params_np(cfg: ARVCConfig, seed: int = 0, dtype=np.float32) -> Dict:
    r = _R(seed, dtype)
    d = cfg.decoder
    return {
        "embedding": r.n(d.vocab_size, d.dim),
        "context_in": {"w": r.n(cfg.context_dim, d.dim), "b": r.zeros(d.dim)},
        "style_in": {"w": r.n(cfg.style_dim, d.dim), "b": r.zeros(d.dim)},
        "model": dual_ar_params_np(d, seed + 1, dtype),
        "wait4start": r.n(8, d.dim),
        "wait4end": r.n(8, d.dim),
    }


def asr_decoder_params_np(cfg, seed: int = 0, dtype=np.float32) -> Dict:
    """The ASR decoder (models/asr_decoder.py `ASRDecoderConfig`): stacked
    layers, N(0, 0.02^2) matrices and embeddings, unit norms, zero biases,
    as the JAX package's `asr_decoder.init` draws them (not its draws)."""
    r = _R(seed, dtype)
    d, h, n = cfg.hidden_dim, cfg.intermediate_size, cfg.depth
    kv = cfg.num_heads * cfg.head_dim
    p = {
        "layers": {
            "wqkv": {"w": r.n(n, d, 3 * kv)},
            "wo": {"w": r.n(n, kv, d)},
            "attention_norm": {"w": r.ones(n, d)},
            "ffn_norm": {"w": r.ones(n, d)},
            "w1": {"w": r.n(n, d, h)},
            "w3": {"w": r.n(n, d, h)},
            "w2": {"w": r.n(n, h, d)},
        },
        "norm": {"w": r.ones(d)},
        "text_embedding": r.n(cfg.n_vocab, d),
        "prediction_head": {"w": r.n(d, cfg.n_vocab), "b": r.zeros(cfg.n_vocab)},
    }
    if cfg.in_channels != d:
        p["audio_proj"] = {"w": r.n(cfg.in_channels, d), "b": r.zeros(d)}
    return p


def _convnext_block_np(r: _R, dim: int, k: int = 7, mlp: float = 4.0) -> Dict:
    h = int(mlp * dim)
    return {
        "dwconv": {"w": r.n(k, 1, dim), "b": r.zeros(dim)},
        "norm": {"w": r.ones(dim), "b": r.zeros(dim)},
        "pwconv1": {"w": r.n(dim, h), "b": r.zeros(h)},
        "pwconv2": {"w": r.n(h, dim), "b": r.zeros(dim)},
        "gamma": np.full((dim,), 1e-6, r.dtype),
    }


def convnext_encoder_np(cfg, seed: int = 0, dtype=np.float32) -> Dict:
    r = _R(seed, dtype)
    p = {
        "stem_conv": {"w": r.n(7, cfg.input_channels, cfg.dims[0]),
                      "b": r.zeros(cfg.dims[0])},
        "stem_norm": {"w": r.ones(cfg.dims[0]), "b": r.zeros(cfg.dims[0])},
        "final_norm": {"w": r.ones(cfg.dims[-1]), "b": r.zeros(cfg.dims[-1])},
    }
    for i in range(len(cfg.depths) - 1):
        p[f"mid_norm_{i}"] = {"w": r.ones(cfg.dims[i]), "b": r.zeros(cfg.dims[i])}
        p[f"mid_conv_{i}"] = {"w": r.n(1, cfg.dims[i], cfg.dims[i + 1]),
                              "b": r.zeros(cfg.dims[i + 1])}
    for i, depth in enumerate(cfg.depths):
        p[f"stage_{i}"] = [
            _convnext_block_np(r, cfg.dims[i], cfg.kernel_size) for _ in range(depth)
        ]
    if cfg.gin_channels > 0:
        p["g_in"] = {"w": r.n(1, cfg.gin_channels, cfg.input_channels),
                     "b": r.zeros(cfg.input_channels)}
    return p


def tokenizer_params_np(cfg, seed: int = 0, dtype=np.float32, with_head: bool = False) -> Dict:
    """The tokenizer tree; with `with_head` also the ConvNeXt distillation
    head of the training forward (`cfg.head`, its own seed + 2 stream, so
    the other leaves are the same draws either way)."""
    r = _R(seed, dtype)
    t = cfg.transformer
    dims = cfg.quantizer.input_dim

    def wt_layers(n):
        kv = t.n_head * t.head_dim
        return {
            "layers": [
                {
                    "wqkv": {"w": r.n(t.dim, 3 * kv)},
                    "wo": {"w": r.n(kv, t.dim)},
                    "attention_norm": {"w": r.ones(t.dim)},
                    "ffn_norm": {"w": r.ones(t.dim)},
                    "w1": {"w": r.n(t.dim, t.intermediate_size)},
                    "w3": {"w": r.n(t.dim, t.intermediate_size)},
                    "w2": {"w": r.n(t.intermediate_size, t.dim)},
                    "attn_scale": np.full((t.dim,), 1e-2, r.dtype),
                    "ffn_scale": np.full((t.dim,), 1e-2, r.dtype),
                }
                for _ in range(n)
            ],
            "final_norm": {"w": r.ones(t.dim)},
        }

    return {
        "backbone": convnext_encoder_np(cfg.backbone, seed + 1, dtype),
        "downsample": [
            {"conv": {"w": r.n(f, dims, dims), "b": r.zeros(dims)},
             "block": _convnext_block_np(r, dims)}
            for f in cfg.quantizer.downsample_factor
        ],
        "pre_module": wt_layers(t.n_layer),
        "post_module": wt_layers(t.n_layer),
        "lfq": {
            "project_in": {"w": r.n(dims, cfg.quantizer.codebook_bits),
                           "b": r.zeros(cfg.quantizer.codebook_bits)},
            "project_out": {"w": r.n(cfg.quantizer.codebook_bits, dims),
                            "b": r.zeros(dims)},
        },
        **({"head": convnext_encoder_np(cfg.head, seed + 2, dtype)} if with_head else {}),
    }


def vocoder_params_np(cfg, seed: int = 0, dtype=np.float32) -> Dict:
    r = _R(seed, dtype)
    dims = cfg.quantizer.input_dim
    h = cfg.head
    p = {
        "backbone": convnext_encoder_np(cfg.backbone, seed + 1, dtype),
        "downsample": [
            {"conv": {"w": r.n(f, dims, dims), "b": r.zeros(dims)},
             "block": _convnext_block_np(r, dims)}
            for f in cfg.quantizer.downsample_factor
        ],
        "upsample": [
            {"conv": {"w": r.n(f, dims, dims), "b": r.zeros(dims)},
             "block": _convnext_block_np(r, dims)}
            for f in cfg.quantizer.downsample_factor
        ],
        "fsq": {
            f"group_{g}": {
                "project_in": {
                    "w": r.n(dims // cfg.quantizer.n_groups, len(cfg.quantizer.levels)),
                    "b": r.zeros(len(cfg.quantizer.levels)),
                },
                "project_out": {
                    "w": r.n(len(cfg.quantizer.levels), dims // cfg.quantizer.n_groups),
                    "b": r.zeros(dims // cfg.quantizer.n_groups),
                },
            }
            for g in range(cfg.quantizer.n_groups)
        },
    }
    ch = h.upsample_initial_channel
    p["head"] = {
        "conv_pre": {"w": r.n(h.pre_conv_kernel_size, h.num_mels, ch), "b": r.zeros(ch)},
        "ups": [],
        "resblocks": [],
    }
    for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
        cin, cout = ch // (2**i), ch // (2 ** (i + 1))
        p["head"]["ups"].append({"w": r.n(k, cin, cout), "b": r.zeros(cout)})
        p["head"]["resblocks"].append(
            [
                {
                    "convs1": [{"w": r.n(rk, cout, cout), "b": r.zeros(cout)}
                               for _ in rd],
                    "convs2": [{"w": r.n(rk, cout, cout), "b": r.zeros(cout)}
                               for _ in rd],
                }
                for rk, rd in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes)
            ]
        )
    last = ch // (2 ** len(h.upsample_rates))
    p["head"]["conv_post"] = {"w": r.n(h.post_conv_kernel_size, last, 1),
                              "b": r.zeros(1)}
    return p


def campplus_params_np(cfg, seed: int = 0, dtype=np.float32) -> Dict:
    """Random CAMPPlus params (same tree as models/campplus.convert output)."""
    r = _R(seed, dtype)

    def bn(c):
        return {"mean": r.zeros(c), "var": r.ones(c), "w": r.ones(c), "b": r.zeros(c)}

    def bn_noaff(c):
        return {"mean": r.zeros(c), "var": r.ones(c)}

    def res_block(cin, cout, stride):
        p = {
            "conv1": r.he(3, 3, cin, cout), "bn1": bn(cout),
            "conv2": r.he(3, 3, cout, cout), "bn2": bn(cout),
        }
        if stride != 1 or cin != cout:
            p["shortcut_conv"] = r.he(1, 1, cin, cout)
            p["shortcut_bn"] = bn(cout)
        return p

    m = 32
    fcm = {
        "conv1": r.he(3, 3, 1, m), "bn1": bn(m),
        "conv2": r.he(3, 3, m, m), "bn2": bn(m),
        "layer1": [res_block(m, m, 2), res_block(m, m, 1)],
        "layer2": [res_block(m, m, 2), res_block(m, m, 1)],
    }
    ch = m * (cfg.feat_dim // 8)
    p = {"fcm": fcm, "tdnn_conv": r.he(5, ch, cfg.init_channels),
         "tdnn_bn": bn(cfg.init_channels)}
    ch = cfg.init_channels
    for bi, (n_layers, k, dil) in enumerate(
        zip(cfg.block_layers, cfg.block_kernels, cfg.block_dilations)
    ):
        layers = []
        for li in range(n_layers):
            cin = ch + li * cfg.growth_rate
            bnc = cfg.bn_size * cfg.growth_rate
            layers.append({
                "nl1": bn(cin), "lin1_w": r.he(1, cin, bnc), "nl2": bn(bnc),
                "cam": {
                    "local_w": r.he(k, bnc, cfg.growth_rate),
                    "fc1_w": r.he(bnc, bnc // 2), "fc1_b": r.zeros(bnc // 2),
                    "fc2_w": r.he(bnc // 2, cfg.growth_rate), "fc2_b": r.zeros(cfg.growth_rate),
                },
            })
        p[f"block{bi+1}"] = layers
        ch = ch + n_layers * cfg.growth_rate
        p[f"transit{bi+1}"] = {"bn": bn(ch), "w": r.he(1, ch, ch // 2)}
        ch //= 2
    p["out_bn"] = bn(ch)
    p["dense_w"] = r.he(1, ch * 2, cfg.embedding_size)
    p["dense_bn"] = bn_noaff(cfg.embedding_size)
    return p


def speaker_encoder_params_np(cfg, seed: int = 0, dtype=np.float32) -> Dict:
    """Random SparkTTS speaker-encoder params (tree of speaker_encoder.convert)."""
    r = _R(seed, dtype)
    C = cfg.ecapa_channels

    def bn(c):
        return {"mean": r.zeros(c), "var": r.ones(c), "w": r.ones(c), "b": r.zeros(c)}

    def res2():
        width = C // 8
        return {
            "conv1_w": r.n(1, C, C), "conv1_b": r.zeros(C), "bn1": bn(C),
            "conv2_w": r.n(1, C, C), "conv2_b": r.zeros(C), "bn2": bn(C),
            "se1_w": r.n(C, 128), "se1_b": r.zeros(128),
            "se2_w": r.n(128, C), "se2_b": r.zeros(C),
            "res2": [
                {"w": r.n(3, width, width), "b": r.zeros(width), "bn": bn(width)}
                for _ in range(7)
            ],
        }

    ecapa = {
        "layer1_w": r.n(5, cfg.input_dim, C), "layer1_b": r.zeros(C),
        "layer1_bn": bn(C),
        "layer2": res2(), "layer3": res2(), "layer4": res2(),
        "conv_w": r.n(1, 3 * C, 1536), "conv_b": r.zeros(1536),
    }
    d = cfg.latent_dim
    layers = []
    for _ in range(2):
        inner = int(d * 4 * 2 / 3)
        layers.append({
            "to_q": r.n(d, 512), "to_kv": r.n(d, 1024), "to_out": r.n(512, d),
            "ff1_w": r.n(d, inner * 2), "ff1_b": r.zeros(inner * 2),
            "ff2_w": r.n(inner, d), "ff2_b": r.zeros(d),
        })
    perceiver = {
        "proj_w": r.n(1536, d), "proj_b": r.zeros(d),
        "latents": r.n(cfg.token_num, d),
        "layers": layers, "norm": {"gamma": np.ones((d,), dtype)},
    }
    fsq = {
        "project_in": {"w": r.n(d, len(cfg.fsq_levels)), "b": r.zeros(len(cfg.fsq_levels))},
        "project_out": {"w": r.n(len(cfg.fsq_levels), d), "b": r.zeros(d)},
    }
    xvec = {  # ASTP (global-context) + BN + linear head, ecapa_tdnn.py:179-206
        "pool_lin1_w": r.n(1, 3 * 1536, 128), "pool_lin1_b": r.zeros(128),
        "pool_lin2_w": r.n(1, 128, 1536), "pool_lin2_b": r.zeros(1536),
        "bn": bn(2 * 1536),
        "lin_w": r.n(2 * 1536, cfg.out_dim), "lin_b": r.zeros(cfg.out_dim),
    }
    return {"ecapa": ecapa, "perceiver": perceiver, "fsq": fsq, "xvec": xvec}
