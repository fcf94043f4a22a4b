"""The port's CUDA kernels against their plain versions on the card.

Marked `gpu`: they skip without a CUDA card (the decision is made inside
each test).  This file imports no JAX, so it also runs where JAX is not
installed; `tests/conftest.py` imports JAX, so there run it without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Float32: tokens and codes equal, float outputs (rings, caches and packed
tails included) within 1e-3 (the kernels sum in another order than cuBLAS
and ATen).  Each kernel after the first two is held at the published width
and at tiny geometries; the tiny converter's head narrows to one channel,
which the head kernel takes.
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
    **chip_smoke.branch_heads(),  # 5 and 6 branches: rounds in several launches
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


TINY_FAST = C.DualARConfig(vocab_size=64, n_layer=1, n_head=2, dim=32, intermediate_size=64,
                           head_dim=16, max_seq_len=16, codebook_size=40, num_codebooks=4,
                           n_fast_layer=2, fast_dim=64, fast_n_head=4, fast_head_dim=16,
                           fast_intermediate_size=128)


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["full", "tiny"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fast_loop_kernel_matches_plain(size, dtype):
    """The persistent fast loop alone, one launch a call, greedy and sampled
    on random hidden rows: at the published width (4 x 768, vocab 1000, 8
    codebooks) and at a tiny one (2 x 64, vocab 40, 4 codebooks); float32
    codes equal and the audio embedding within 1e-3; bf16 is run."""
    _need_card()
    d = C.fast_slow_config(C.PipelineConfig()).arvc.decoder if size == "full" else TINY_FAST
    f32 = dtype == torch.float32
    agree, n, err = chip_smoke.compare_fast(d, "cuda", dtype, 3, check=f32)
    assert n == 6
    if f32:
        assert agree == n and err <= chip_smoke.TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_slow_step_kernel_matches_plain_at_split_edges(dtype):
    """The slow step at pos 0, 1, around its attention's split edges and at
    S - 2, and its attention alone at every pos of 0 .. 259 and beyond; NaN
    cache rows >= pos are never read (checked inside).  bf16: the attention
    within its rounding of the output."""
    _need_card()
    d = C.fast_slow_config(C.PipelineConfig()).arvc.decoder
    f32 = dtype == torch.float32
    agree, n, err, attn_err = chip_smoke.compare_slow_positions(
        d, "cuda", dtype, chip_smoke.SLOW_POS, check=f32)
    assert n == len(chip_smoke.SLOW_POS)
    if f32:
        assert agree == n and err <= chip_smoke.TOL and attn_err <= chip_smoke.TOL
    else:
        assert attn_err <= 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["full", "full_early", "tiny"])
def test_ring_step_kernel_matches_plain(size):
    """At the published width across a rebase (3583, 3584); at counts < W
    where most of the 16 attention splits of a head hold no valid slot
    (count 2: one old slot, in split 0; 33: splits 0 and 1 only); and at
    the tiny ring through three rebases (W = R = 8)."""
    _need_card()
    if size == "full":
        wcfg, counts = C.PipelineConfig().tokenizer.transformer, chip_smoke.RING_COUNTS
    elif size == "full_early":
        wcfg, counts = C.PipelineConfig().tokenizer.transformer, (2, 31, 32, 33, 100)
    else:
        wcfg, counts = TINY_RING, range(26)
    assert chip_smoke.compare_ring(wcfg, "cuda", torch.float32, counts, True) <= chip_smoke.TOL


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["full", "tiny"])
def test_ring_timeline_phases_are_separated_by_grid_barriers(size):
    """Every block stamps each of the 5 L phases, entry before exit, and no
    block enters a phase before every block has left the one before."""
    _need_card()
    from streamvoiceanon_tpu_torch.ops.wt_stream import phases, wt_stream_step_timeline

    wcfg = C.PipelineConfig().tokenizer.transformer if size == "full" else TINY_RING
    layers = chip_smoke.wt_layers(wcfg, "cuda", torch.float32)
    g = torch.Generator(device="cuda").manual_seed(5)
    x, kr, vr = chip_smoke.ring_inputs(wcfg, "cuda", torch.float32, 3, g)
    t = wt_stream_step_timeline(layers, x, kr, vr, 3, n_head=wcfg.n_head,
                                head_dim=wcfg.head_dim, rope_base=wcfg.rope_base,
                                norm_eps=wcfg.norm_eps, table_rows=wcfg.rope_table_rows)
    t = t.cpu().numpy()
    assert t.shape[0] == len(phases(wcfg.n_layer)) == 5 * wcfg.n_layer
    assert (t > 0).all() and (t[:, :, 1] >= t[:, :, 0]).all()
    assert (t[1:, :, 0].min(axis=1) >= t[:-1, :, 1].max(axis=1)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["full", *sorted(TINY_HEADS)])
def test_head_kernel_matches_plain(size):
    _need_card()
    hcfg = C.HiFiGANConfig() if size == "full" else TINY_HEADS[size]
    assert chip_smoke.compare_head(hcfg, "cuda", 6, True)[0] <= chip_smoke.TOL


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["full", *sorted(TINY_HEADS)])
def test_head_timeline_stamps_every_block_in_order(size):
    """Each level's blocks start, loop and exit in order, and a level's last
    exit comes before the next level's last exit."""
    _need_card()
    from streamvoiceanon_tpu_torch.ops.hifigan import (
        head_stream_step_timeline, init_packed_state, level_blocks, level_plan)

    hcfg = C.HiFiGANConfig() if size == "full" else TINY_HEADS[size]
    _, pw = chip_smoke.head_params(hcfg, "cuda")
    x = torch.randn((1, 4, hcfg.num_mels), device="cuda")
    t = head_stream_step_timeline(pw, init_packed_state(hcfg, 1, device="cuda"), x, hcfg)
    t = t.cpu().numpy()
    ends = []
    for lvl, lv in enumerate(level_plan(hcfg, 4)):
        b = t[lvl, : level_blocks(lv)]
        assert (b > 0).all() and (np.diff(b, axis=1) >= 0).all(), lvl
        assert (t[lvl, level_blocks(lv):] == 0).all()
        ends.append(b[:, 3].max())
    assert (np.diff(ends) > 0).all()


TINY_FRONT = C.replace(C.TokenizerConfig(), quantizer=C.BSQConfig(input_dim=32),
                       backbone=C.ConvNeXtConfig(depths=(2, 1, 3, 1), dims=(16, 24, 28, 32)))


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["full", "tiny"])
def test_front_kernel_matches_plain(size):
    """Over 6 chunks, state carried, the kept scratch NaN before chunk 3: at
    the published width and at a tiny front with several blocks per
    stage."""
    _need_card()
    tcfg = C.all_five(C.PipelineConfig()).tokenizer if size == "full" else TINY_FRONT
    assert chip_smoke.compare_front(tcfg, "cuda", 6, True)[0] <= chip_smoke.TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", ["bf16", "bf16_weights", "bf16_tails"])
@pytest.mark.parametrize("size", ["full", *sorted(TINY_HEADS)])
def test_head_kernel_in_bf16_matches_plain(size, dtypes):
    """bf16 weights and tails, and each mixed with float32: within
    HEAD_BF16_ULPS bf16 ulps where bf16 rounds (with bf16 weights also
    within HEAD_FLIP_SHARE, `chip_smoke.flip_share`), 1e-3 where both are
    float32 but for the rounding of one operand."""
    _need_card()
    hcfg = C.HiFiGANConfig() if size == "full" else TINY_HEADS[size]
    wd, sd = {"bf16": (torch.bfloat16,) * 2, "bf16_weights": (torch.bfloat16, torch.float32),
              "bf16_tails": (torch.float32, torch.bfloat16)}[dtypes]
    chip_smoke.compare_head(hcfg, "cuda", 4, True, wd, sd)


# more phases than the narrow build takes (ops/convnext_enc.py NARROW_PHASES)
DEEP_FRONT = C.replace(TINY_FRONT, backbone=C.ConvNeXtConfig(depths=(48,), dims=(32,)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", ["f32", "bf16", "bf16_weights", "bf16_tails"])
@pytest.mark.parametrize("size", ["full", "tiny", "wide", "down8", "deep"])
def test_front_kernel_at_every_dtype_and_wider_geometries(size, dtypes):
    """The published front, a tiny one, rows wider than the kernel's 512
    threads, a downsample product of 8 and more phases than the narrow
    build takes, in float32, bf16 and mixed."""
    _need_card()
    full = C.all_five(C.PipelineConfig()).tokenizer
    tcfg = {"full": full, "tiny": TINY_FRONT, "deep": DEEP_FRONT,
            **chip_smoke.wider_fronts(full)}[size]
    wd, sd = {"f32": (torch.float32,) * 2, "bf16": (torch.bfloat16,) * 2,
              "bf16_weights": (torch.bfloat16, torch.float32),
              "bf16_tails": (torch.float32, torch.bfloat16)}[dtypes]
    chip_smoke.compare_front(tcfg, "cuda", 4, True, wd, sd)


@pytest.mark.gpu
def test_front_is_one_device_launch_a_call():
    """torch.profiler sees one device launch a call of the front at the
    published width (checked inside `front_breakdown`), and its timeline
    has the 46 phases of `phases`."""
    _need_card()
    out = chip_smoke.front_breakdown(C.all_five(C.PipelineConfig()).tokenizer, "cuda", n=5)
    assert out["launches"] == 1 and len(out["phases"]["work_us"]) == 46


@pytest.mark.gpu
@pytest.mark.parametrize("size", ["full", "tiny"])
def test_front_timeline_phases_are_separated_by_grid_barriers(size):
    """Every block stamps each phase, entry before its product's start (where
    it owns columns) before exit, and no block enters a phase before every
    block has left the one before."""
    _need_card()
    from streamvoiceanon_tpu_torch.ops.convnext_enc import (
        encoder_front_step_timeline, phases, work_plan)

    tcfg = C.all_five(C.PipelineConfig()).tokenizer if size == "full" else TINY_FRONT
    pw, units = chip_smoke.front_weights(tcfg, "cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    mel = torch.randn((1, 4, tcfg.backbone.input_channels), generator=g, device="cuda")
    t = encoder_front_step_timeline(pw, chip_smoke.front_state(tcfg, "cuda", g), mel, tcfg,
                                    units).cpu().numpy()
    assert t.shape == (len(phases(tcfg)), t.shape[1], 3)
    owns = work_plan(tcfg, t.shape[1])[:, :, 1].T > 0
    assert (t[:, :, [0, 2]] > 0).all() and ((t[:, :, 1] > 0) == owns).all()
    start = np.where(owns, t[:, :, 1], t[:, :, 0])
    assert (start >= t[:, :, 0]).all() and (t[:, :, 2] >= start).all()
    assert (t[1:, :, 0].min(axis=1) >= t[:-1, :, 2].max(axis=1)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("geo", ["full", "tiny", "tiny_one_row", "tiny_bf16"])
def test_decode_attention_kernel_matches_plain(geo):
    """(heads, new rows, head dim, cache rows) at the published dual-AR
    width and tiny ones; bf16 within its rounding of the output.  NaN rows
    beyond pos + T are never read (checked inside)."""
    _need_card()
    shape, dtype, pos, tol = {
        "full": ((12, 2, 64, 2048), torch.float32, chip_smoke.ATTN_POS, chip_smoke.TOL),
        "tiny": ((2, 2, 16, 64), torch.float32, (0, 5, 62), chip_smoke.TOL),
        "tiny_one_row": ((3, 1, 32, 40), torch.float32, (0, 17, 39), chip_smoke.TOL),
        "tiny_bf16": ((2, 2, 16, 64), torch.bfloat16, (0, 5, 62), 0.05),
    }[geo]
    assert chip_smoke.compare_attention(*shape, "cuda", dtype, pos, False) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [12, 48, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decode_attention_over_batched_heads_at_split_edges(heads, dtype):
    """Batch 1, 4 and 8 of the dual-AR's 12 heads at pos 0, 1, the split
    edges, 1000 and 2046: caches equal, the output within the kernel's
    tolerance (checked inside, with NaN stale rows and NaN kept partials
    before the middle position)."""
    _need_card()
    geo = (heads, 2, 64, 2048)
    pos = chip_smoke.attn_positions(*geo, dtype, torch.cuda.get_device_properties(0)
                                    .multi_processor_count)
    assert chip_smoke.compare_attention(*geo, "cuda", dtype, pos, True) >= 0.0


@pytest.mark.gpu
def test_decode_attention_is_one_device_launch_a_call():
    _need_card()
    from streamvoiceanon_tpu_torch.ops.attention import decode_attention

    g = torch.Generator(device="cuda").manual_seed(3)
    q, kn, vn, kc, vc = chip_smoke.attn_inputs(96, 2, 64, 2048, "cuda", torch.bfloat16, g)
    launches, by_kernel, _ = chip_smoke.profile_launches(
        lambda: decode_attention(q, kn, vn, kc, vc, 1600), lambda c: c == 1)
    assert launches == 1 and all("decode_attn_kernel" in k for k in by_kernel)


@pytest.mark.gpu
def test_batched_decode_launches_and_agrees_with_the_plain_flags():
    """The tiny dual-AR at batch 3 in bf16: 12 frames under
    `per_head_decode` launch the decode attention once a layer a frame and
    nothing else, and agree with the plain flags up to explained flips
    (checked inside)."""
    _need_card()
    from streamvoiceanon_tpu_torch import params as P
    from streamvoiceanon_tpu_torch.ops.attention import decode_attention
    from streamvoiceanon_tpu_torch.ops.convnext_enc import encoder_front_step
    from streamvoiceanon_tpu_torch.ops.fast_decode import fast_decode
    from streamvoiceanon_tpu_torch.ops.hifigan import head_stream_step
    from streamvoiceanon_tpu_torch.ops.slow_decode import slow_decode_step
    from streamvoiceanon_tpu_torch.ops.wt_stream import wt_stream_step
    from streamvoiceanon_tpu_torch.utils import randparams as rp

    acfg = C.ARVCConfig(decoder=C.DualARConfig(
        vocab_size=512, n_layer=2, n_head=2, dim=32, intermediate_size=64, head_dim=16,
        max_seq_len=256, codebook_size=100, num_codebooks=4, n_fast_layer=1, fast_dim=32,
        fast_n_head=2, fast_head_dim=16, fast_intermediate_size=64), model_dim=32)
    ap = P.arvc_params(rp.arvc_params_np(acfg, 5), "cuda", torch.bfloat16)
    wrappers = {"slow": slow_decode_step, "fast": fast_decode, "ring": wt_stream_step,
                "head": head_stream_step, "enc": encoder_front_step, "attn": decode_attention}
    counts, st = chip_smoke.batched_decode(ap, acfg, "cuda", wrappers, batch=3, Tp=60,
                                           frames=12)
    assert counts == chip_smoke.counts_of(attn=acfg.decoder.n_layer * 12)
    assert st["agree"] >= 0.9 * st["compared"]


PROGRAMS = {
    "fast_slow": (C.fast_slow_config,
                  lambda f, t: chip_smoke.counts_of(slow=f, fast=f)),
    "tpu_optimized": (C.tpu_optimized,
                      lambda f, t: chip_smoke.counts_of(slow=f, fast=f, ring=t, head=f)),
    "all_five": (C.all_five,
                 lambda f, t: chip_smoke.counts_of(slow=f, fast=f, ring=t, head=f, enc=t)),
    "per_head": (C.per_head_decode,
                 lambda f, t: chip_smoke.counts_of(fast=f, ring=t, head=f, attn=12 * f)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_main_path_launches_each_kernel_once_per_frame(program):
    _need_card()
    from streamvoiceanon_tpu_torch.ops.attention import decode_attention
    from streamvoiceanon_tpu_torch.ops.convnext_enc import encoder_front_step
    from streamvoiceanon_tpu_torch.ops.fast_decode import fast_decode
    from streamvoiceanon_tpu_torch.ops.hifigan import head_stream_step
    from streamvoiceanon_tpu_torch.ops.slow_decode import slow_decode_step
    from streamvoiceanon_tpu_torch.ops.wt_stream import wt_stream_step

    make, expect = PROGRAMS[program]
    scfg = C.StreamConfig(max_prompt_frames=8, max_seq_frames=32, buffer_frames=2,
                          delay=2)
    sess, rng, _, _, _ = chip_smoke.build_session(make(C.PipelineConfig()), "cuda", scfg,
                                                  C.SamplingConfig(), torch.bfloat16,
                                                  torch.bfloat16)
    wrappers = {"slow": slow_decode_step, "fast": fast_decode, "ring": wt_stream_step,
                "head": head_stream_step, "enc": encoder_front_step, "attn": decode_attention}
    for w in wrappers.values():
        w.launches = 0
    times = chip_smoke.stream(sess, rng, 8)
    assert len(times) == 8 and np.isfinite(times).all()
    assert sess.frames_decoded == 6 and sess.tokens_seen == 8
    assert {k: w.launches for k, w in wrappers.items()} == expect(6, 8)


# ---------------------------------------------------------------------------
# serving on the card (chip_smoke.py phase 6, shortened)
# ---------------------------------------------------------------------------


def _wrappers():
    from streamvoiceanon_tpu_torch.ops import (attention, convnext_enc, fast_decode, hifigan,
                                               slow_decode, wt_stream)

    return {"slow": slow_decode.slow_decode_step, "fast": fast_decode.fast_decode,
            "ring": wt_stream.wt_stream_step, "head": hifigan.head_stream_step,
            "enc": convnext_enc.encoder_front_step, "attn": attention.decode_attention}


@pytest.fixture(scope="module")
def served():
    """Full-width random weights under tpu_optimized (LM bf16), and the cut
    stream geometry of chip_smoke.py phase 3."""
    _need_card()
    scfg = C.StreamConfig(max_prompt_frames=32, max_seq_frames=64, buffer_frames=8, delay=2)
    *_, cv = chip_smoke.build_session(C.tpu_optimized(C.PipelineConfig()), "cuda", scfg,
                                      C.SamplingConfig(), torch.bfloat16, torch.bfloat16)
    return cv, scfg


@pytest.mark.gpu
def test_realtime_engine_on_the_card(served):
    """The engine's launches and its output against the restored session
    driven synchronously; one chunk under set_sync_debug_mode("error")."""
    cv, scfg = served
    out = chip_smoke.realtime_phase(cv, "cuda", scfg, _wrappers(), n=12)
    assert out["err"] <= 1e-5 and out["counts"]["slow"] == 12


@pytest.mark.gpu
def test_fanout_engine_on_the_card(served):
    """fanout(2) under per_head_decode in a MultiStreamEngine: 12 attention
    launches a frame, each stream equal to the restored session."""
    cv, scfg = served
    out = chip_smoke.multistream_phase(cv, "cuda", scfg, _wrappers(), B=2, n=8)
    assert out["counts"]["attn"] == 12 * out["ticks"] and out["counts"]["slow"] == 0
