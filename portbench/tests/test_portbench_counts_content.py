"""The content encoder's counts (`counts_content.py`): the conformer by hand
at a tiny geometry, and a step's parts at the configuration's widths."""

import pytest

from portbench import core, counts_content

CFG = core.load_json(core.ROOT / "configs" / "sva-content-train.json")


def test_conformer_by_hand():
    t = {"feat_dim": 2, "hidden": 4, "n_heads": 2, "intermediate": 8, "conv_kernel": 3,
         "left_max_pos": 1, "right_max_pos": 1}
    # a layer's weights a frame: ffn1 and ffn2 2 x 2 x 4 x 8 = 128, q k v o 4 x 16 = 64,
    # the conv module's pointwise 4 x 8 + 4 x 4 = 48 and depthwise 3 x 4 = 12: 252;
    # 2 frames: 2 x 2 x 252 = 1008; scores, position bias and values 3 x 2 x 2 x 2 x 4 = 96;
    # the projection 2 x 2 x 2 x 4 = 32
    ops, nbytes = counts_content.conformer(t, 1, 2, 2)
    assert ops == 1008 + 96 + 32
    # weights 2 B x (2 x 4 + 252 + 3 distances x 2 head dims); features in, states out 4 B x 2 x 6
    assert nbytes == 2 * 266 + 48


def test_conformer_grows_with_layers_and_the_square_of_frames():
    t = CFG["teacher"]
    one, two = (counts_content.conformer(t, n, 450, 2)[0] for n in (1, 2))
    proj = 2.0 * 450 * t["feat_dim"] * t["hidden"]
    assert two - proj == pytest.approx(2 * (one - proj))
    # two rows of half the frames: the same linear work, half the attention's
    whole, halves = (counts_content.conformer(t, 1, 900, 2)[0],
                     2 * counts_content.conformer(t, 1, 450, 2)[0])
    assert whole - halves == pytest.approx(3 * 900 ** 2 * t["hidden"])


def test_a_mean_batch_of_the_published_step():
    """8 rows of 9 s: about 3 TFLOP of teacher at layer 17, the student's
    forward and backward, and AdamW over about 300 M parameters."""
    frames, text, tt = [194] * 8, [27] * 8, [450] * 8
    parts = counts_content.step(CFG, frames, text, tt)
    assert 2.5e12 < parts["teacher"][0] < 3.5e12
    assert 250e6 < counts_content.student_params(CFG) < 350e6
    assert parts["optim"] == (0.0, 28.0 * counts_content.student_params(CFG))
    assert counts_content.least_s(parts, "float16") > parts["teacher"][0] / core.PEAK_FLOPS["float16"]
