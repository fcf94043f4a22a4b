"""The port's CUDA kernels against their plain versions on the card.

Marked `gpu`: they skip without a CUDA card (the decision is made inside
each test).  This file imports no JAX, so it also runs where JAX is not
installed; `tests/conftest.py` imports JAX, so there run it without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Float32: tokens and codes equal, float outputs (rings and packed tails
included) within 1e-3 (the kernels sum in another order than cuBLAS and
ATen).  Each new kernel is held at the published width and at tiny
geometries; the tiny converter's head narrows to one channel, which the
head kernel takes.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from streamvoiceanon_tpu_torch import config as C


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


TINY_RING = C.WindowedTransformerConfig(n_layer=3, n_head=2, dim=32, intermediate_size=64,
                                        head_dim=16, window_size=8, rope_table_rows=16)
TINY_HEADS = {
    "pallas_tiny": C.HiFiGANConfig(
        num_mels=16, upsample_initial_channel=16, upsample_rates=(2, 2),
        upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3, 5),
        resblock_dilation_sizes=((1, 2), (1, 2)), pre_conv_kernel_size=5,
        post_conv_kernel_size=5, hop_length=4),
    "converter_tiny": C.HiFiGANConfig(num_mels=32, upsample_initial_channel=32,
                                      pre_conv_kernel_size=7, post_conv_kernel_size=7),
}


@pytest.mark.gpu
def test_kernels_match_plain_versions_at_full_width():
    _need_card()
    d = C.fast_slow_config(C.PipelineConfig()).arvc.decoder
    stats = chip_smoke.compare_kernels(d, "cuda", torch.float32, torch.float32,
                                             1000, 3, check=True)
    for name in ("slow", "fast"):
        assert stats[name]["agree"] == stats[name]["n"] == 6
        assert stats[name]["err"] <= chip_smoke.TOL


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["full", "tiny"])
def test_ring_step_kernel_matches_plain(size):
    """At the published width across a rebase (3583, 3584), and at the tiny
    ring through three rebases (W = R = 8)."""
    _need_card()
    if size == "full":
        wcfg, counts = C.PipelineConfig().tokenizer.transformer, chip_smoke.RING_COUNTS
    else:
        wcfg, counts = TINY_RING, range(26)
    assert chip_smoke.compare_ring(wcfg, "cuda", torch.float32, counts, True) <= chip_smoke.TOL


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["full", *sorted(TINY_HEADS)])
def test_head_kernel_matches_plain(size):
    _need_card()
    hcfg = C.HiFiGANConfig() if size == "full" else TINY_HEADS[size]
    assert chip_smoke.compare_head(hcfg, "cuda", 6, True) <= chip_smoke.TOL


@pytest.mark.gpu
@pytest.mark.parametrize("program", ["fast_slow", "tpu_optimized"])
def test_main_path_launches_each_kernel_once_per_frame(program):
    _need_card()
    from streamvoiceanon_tpu_torch.ops.fast_decode import fast_decode
    from streamvoiceanon_tpu_torch.ops.hifigan import head_stream_step
    from streamvoiceanon_tpu_torch.ops.slow_decode import slow_decode_step
    from streamvoiceanon_tpu_torch.ops.wt_stream import wt_stream_step

    cfg = (C.tpu_optimized if program == "tpu_optimized" else C.fast_slow_config)(
        C.PipelineConfig())
    scfg = C.StreamConfig(max_prompt_frames=8, max_seq_frames=32, buffer_frames=2,
                          delay=2)
    sess, rng, _, _, _ = chip_smoke.build_session(cfg, "cuda", scfg, C.SamplingConfig(),
                                                  torch.bfloat16, torch.bfloat16)
    for w in (slow_decode_step, fast_decode, wt_stream_step, head_stream_step):
        w.launches = 0
    times = chip_smoke.stream(sess, rng, 8)
    assert len(times) == 8 and np.isfinite(times).all()
    assert slow_decode_step.launches == fast_decode.launches == sess.frames_decoded == 6
    on = program == "tpu_optimized"
    assert wt_stream_step.launches == (sess.tokens_seen if on else 0) == (8 if on else 0)
    assert head_stream_step.launches == (6 if on else 0)
