"""Seeded random weights of the content encoder's training
(`sva-content-train`), drawn on the card by `weights.draw` (one `randn`
and one `rand` for every tree): the tokenizer with its post-module and
distillation head and the ASR decoder (trained), CAM++ and the w2v-BERT
conformer's first `teacher_layers` layers (frozen), in the port's
layouts."""

from __future__ import annotations

from typing import Dict

from portbench import core, weights
from portbench.weights import n, ones, zeros


def intermediate(dim: int) -> int:
    """The ASR decoder's feed-forward width (`ASRDecoderConfig.intermediate_size`)."""
    inter = int(2 * (4 * dim) / 3)
    return inter if inter % 256 == 0 else inter + 256 - inter % 256


def conformer(t: Dict, layers: int) -> Dict:
    """The w2v-BERT conformer's first `layers` layers and its feature
    projection in the port's layout, drawn as the published model's
    initialisation draws them: linear weights N(0, 0.02^2) with zero
    biases, the projection uniform in +-1/sqrt(fan_in), the convolution
    module's convs He-normal by fan-in, the distance embedding N(0, 1) (an
    `nn.Embedding`'s draw), unit LayerNorms."""
    H, F, L, k = t["hidden"], t["intermediate"], layers, t["conv_kernel"]
    lin = lambda a, b: {"w": n(L, a, b), "b": zeros(L, b)}  # noqa: E731
    ln = lambda: {"w": ones(L, H), "b": zeros(L, H)}  # noqa: E731
    bound = t["feat_dim"] ** -0.5
    return {
        "fp_ln": weights.norm(t["feat_dim"]),
        "proj": {"w": weights.uniform(bound, t["feat_dim"], H), "b": weights.uniform(bound, H)},
        "layers": {
            "ffn1_ln": ln(), "ffn1": {"in": lin(H, F), "out": lin(F, H)},
            "attn_ln": ln(),
            "attn": {"q": lin(H, H), "k": lin(H, H), "v": lin(H, H), "o": lin(H, H),
                     "dist": n(L, t["left_max_pos"] + t["right_max_pos"] + 1,
                               H // t["n_heads"], std=1.0)},
            "conv": {"ln": ln(), "pw1": n(L, H, 2 * H, std=weights.he(1, H, 2 * H)),
                     "dw": n(L, H, 1, k, std=weights.he(k, 1, H)),
                     "dw_ln": ln(), "pw2": n(L, H, H, std=weights.he(1, H, H))},
            "ffn2_ln": ln(), "ffn2": {"in": lin(H, F), "out": lin(F, H)},
            "final_ln": ln(),
        },
    }


def asr_decoder(a: Dict) -> Dict:
    """The ASR decoder (`utils/randparams.asr_decoder_params_np`'s tree):
    its layer stack, norm, text embedding, output head and, where the
    latents are narrower, the audio projection."""
    D, V, H = a["hidden_dim"], a["n_vocab"], a["num_heads"]
    inter = intermediate(D)
    p = {"layers": weights._blocks(a["depth"], D, H, H, D // H, inter),
         "norm": {"w": ones(D)}, "text_embedding": n(V, D),
         "prediction_head": weights.linear(D, V)}
    if a["in_channels"] != D:
        p["audio_proj"] = weights.linear(a["in_channels"], D)
    return p


def specs(config: Dict) -> Dict[str, Dict]:
    """The four trees of a configuration file, as `weights.Leaf` trees."""
    tok = config["tokenizer"]
    tspec = weights.tokenizer(tok)
    tspec["post_module"] = weights.windowed_transformer(tok["transformer"])
    tspec["head"] = weights.convnext_encoder(tok["head"])
    return {"tokenizer": tspec, "asr": asr_decoder(config["asr_decoder"]),
            "campplus": weights.campplus(config["campplus"]),
            "teacher": conformer(config["teacher"], config["teacher_layers"])}


def draw(config: Dict, seed: int, device) -> Dict[str, Dict]:
    """The four trees on the card from the seed (one randn, one rand), the
    teacher in its configured dtype, the rest float32."""
    return weights.draw(specs(config), seed, device,
                        {"teacher": core.DTYPES[config["dtypes"]["teacher"]]})
