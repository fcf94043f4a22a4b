"""Operations and bytes of the content encoder's training step, counted from
the configuration's shapes by `counts.py`'s rules (a multiply-accumulate is
2 operations; norms, activations and the softmax left out, so the count is
a lower bound), each row of a batch at its own frames.

`conformer` is the w2v-BERT teacher, `step` the whole step: the teacher's
forward at float16's peak, the student (the tokenizer's input side
forward only, since no gradient reaches it; the post-module, the head and
the ASR decoder forward and backward, 3 x the forward, no recompute) at
float32's, and AdamW's reads and writes of the trained leaves at the
memory rate.  CAM++, the resampler and the fbank fronts are not counted.
"""

from __future__ import annotations

from typing import Dict, List

from portbench import counts, weights, weights_content
from portbench.counts import Count


def conformer(t: Dict, layers: int, frames: int, wb: int) -> Count:
    """One row of `frames` stacked frames through the feature projection and
    `layers` conformer layers: per layer and frame the two feed-forwards,
    q, k, v and o, the convolution module's two pointwise convs and its
    depthwise taps; per layer the scores, the relative-position bias (each
    query dotted with the embedding of each key's distance) and the
    weighted values over frames x frames.  Every weight read once."""
    H, F, k = t["hidden"], t["intermediate"], t["conv_kernel"]
    macs = 2 * 2 * H * F + 4 * H * H + 3 * H * H + k * H
    ops = 2.0 * frames * t["feat_dim"] * H + layers * (2.0 * frames * macs
                                                        + 3 * 2.0 * frames * frames * H)
    params = t["feat_dim"] * H + layers * (macs + (t["left_max_pos"] + t["right_max_pos"] + 1)
                                           * (H // t["n_heads"]))
    return ops, wb * params + 4.0 * frames * (t["feat_dim"] + H)


def _transformer(t: Dict, frames: int) -> float:
    L, D, F = t["n_layer"], t["dim"], t["intermediate_size"]
    kv = t["n_head"] * t["head_dim"]
    W = t["window_size"] or frames
    attended = sum(min(i + 1, W) for i in range(frames))
    return 2.0 * frames * L * (D * 3 * kv + kv * D + 3 * D * F) + L * 4.0 * kv * attended


def asr_decoder(a: Dict, audio: int, text: int) -> float:
    """One row's forward: `audio` latents and `text` tokens, with bos and eos."""
    D = a["hidden_dim"]
    rows = audio + text + 2
    layer = 4 * D * D + 3 * D * weights_content.intermediate(D)
    ops = 2.0 * rows * a["depth"] * layer + a["depth"] * 4.0 * D * rows * (rows + 1) / 2
    if a["in_channels"] != D:
        ops += 2.0 * audio * a["in_channels"] * D
    return ops + 2.0 * (text + 1) * D * a["n_vocab"]


def student_params(config: Dict) -> int:
    """The trained leaves: the tokenizer with its post-module and head, the ASR decoder."""
    spec = weights_content.specs(config)
    return weights.count(spec["tokenizer"]) + weights.count(spec["asr"])


def step(config: Dict, frame_lens: List[int], text_lens: List[int],
         teacher_frames: List[int]) -> Dict[str, Count]:
    """The counted work of one step of a batch, by part."""
    tok, t = config["tokenizer"], config["teacher"]
    head = weights.convnext_encoder(tok["head"])
    teacher = fwd = train = 0.0
    for T, n, Tt in zip(frame_lens, text_lens, teacher_frames):
        teacher += conformer(t, config["teacher_layers"], int(Tt), 2)[0]
        fwd += counts.tokenizer_encode(tok, int(T), 4)[0]
        train += (_transformer(tok["transformer"], int(T)) + 2.0 * weights.count(head) * int(Tt)
                  + asr_decoder(config["asr_decoder"], int(T), int(n)))
    n_params = student_params(config)
    return {"teacher": (teacher, 0.0), "student": (fwd + 3 * train, 0.0),
            "optim": (0.0, 7.0 * 4 * n_params)}


def least_s(parts: Dict[str, Count], teacher_dtype: str) -> float:
    """The least seconds of a step's parts: the teacher at its dtype's peak,
    the rest at float32's."""
    return sum(counts.least_s(c, teacher_dtype if k == "teacher" else "float32")
               for k, c in parts.items())
