#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (streamvoiceanon_tpu_torch) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --breakdown          # phase 2's breakdowns alone
    python3 chip_smoke.py --session per_head_decode --chunks 40
    python3 chip_smoke.py --training           # phase 7 alone
    python3 chip_smoke.py --eval               # phase 8 alone

Phases, each reported on its own lines:

1. the card's name and power limit (nvidia-smi), and the build of the six
   CUDA kernels from csrc/ with nvcc, one process per source, all started
   together (seconds, ptxas register use);
2. each kernel against its plain PyTorch version at the published width:
   - the slow step at pos 1000 of a 2048-row cache and the fast loop,
     greedy and sampled with shared Gumbel noise, 8 frames each: float32
     must agree in every token and code with max abs error <= 1e-3 on the
     float outputs; bf16 (weights and cache) is reported;
   - the slow step at pos 0, 1, around its attention's split edges (runs
     of 64 rows in float32, 128 in bf16) and 2046, and its attention alone
     at every pos of 0 .. 259 and at 1000, 1023, 1024 and 2046, same
     bounds; cache rows >= pos poisoned with NaN must leave the step's
     outputs finite and unchanged;
   - the windowed-transformer ring step at counts 0, 1, 511, 512, 1000,
     3583 and 3584 (the last re-bases the ring first), float32: max abs
     error <= 1e-3 over the output row and both whole rings; before count
     512 the kernel's kept scratch and attention partials are filled with
     NaN, which must not reach any output; bf16 is reported;
   - the fused HiFiGAN head over 8 consecutive chunks, each side carrying
     its own state, float32: max abs error <= 1e-3 over the waveform and
     every packed tail; before chunk 4 the kernel's kept scratch and split
     partials are filled with NaN, which must not reach any output;
   - the fused ConvNeXt front over 8 consecutive chunks, each side
     carrying its own packed state, float32: max abs error <= 1e-3 over z
     and every packed buffer; before chunk 4 the kernel's kept scratch is
     filled with NaN, which must not reach any output;
   - the head and the front with bf16 weights and tails over 4 chunks
     (kept scratch NaN before chunk 2): every output within
     HEAD_BF16_ULPS / FRONT_BF16_ULPS bf16 ulps of its largest value, and
     the share of bf16 values that differ (`flip_share`) within
     HEAD_FLIP_SHARE / FRONT_FLIP_SHARE, which the control without the
     rounding (`unrounded`) must exceed;
     the front also at two geometries its kernel took only from this
     design on (`wider_fronts`: rows of 1024, a downsample product of 8),
     in float32 (1e-3) and bf16;
   - the per-head decode attention (12, 48 and 96 heads x 64: batch 1, 4
     and 8; 2 new rows, 2048 cache rows) at pos 0, 1, its split edges near
     the start and near 1000, 1000 and 2046: caches equal, the output
     within 1e-4 in float32 and within one bf16 ulp plus 1e-4 in bf16;
     cache rows >= pos + 2 poisoned with NaN must leave the output finite
     and unchanged, and the kernel's kept partials are filled with NaN
     before the middle position;
   - for each bf16 token or code that differs from the plain version, the
     plain race's lead of its choice over the kernel's (in logit units),
     beside the largest logit difference kernel against plain;
   then, in a child process (`python3 chip_smoke.py --breakdown`), for
   the slow step (bf16, sampled) at pos 150, 1000 and 1600, its device
   time a step by kernel family (torch.profiler), its CUDA-event
   time, the host's time to enqueue it, its time replayed from a CUDA
   graph, and one layer's attention alone; for the fast loop (bf16,
   sampled) its CUDA-event time, the host's time to enqueue it, its device
   launches a call (torch.profiler: must be one) and its time replayed
   from a CUDA graph where the cooperative launch can be captured; for the
   HiFiGAN head (float32, T0 = 4) the same, its device launches a call
   (must equal the launch plan's levels), the device span of a call and
   each launch's advance; for the ring step (float32, count 1000) the
   same, its device launches a call (must be one) and one launch's
   phases split into work and barrier wait by the card's global timer;
   for the ConvNeXt front (float32, T0 = 4) the same (`front_breakdown`:
   one device launch a call, its 46 phases grouped by kind and place);
   for the decode attention (bf16, 12 heads at pos 1000 and 96 at 1600)
   the same (`attn_breakdown`: one device launch a call, its device time
   at the planned split size against other split sizes, and the wrapper's
   host time against its C entry point's), then its kernel ms by batch 1,
   4, 8 x
   pos 150, 1000, 1600; `--breakdown` runs against whatever package sits
   beside the script, so a copy of it in an earlier tree times that tree;
   then kernel and plain times
   (CUDA events; the slow step at pos 150, 1000 and 1600) beside the least
   time the card could take for the same work, and for the attention (at
   batch 1, 4, 8 x pos 150, 1000, 1600) the time of
   `F.scaled_dot_product_attention` over the valid rows; the head and the
   front in float32 beside bf16, and the front at the wider geometries
   (`time_dsp`), each beside its bound at its type's bytes;
3. the main path, `tpu_optimized` (four kernels): a full-width
   StreamSession from seeded random weights (LM weights in bf16, the
   tokenizer and vocoder in float32, the KV cache and the stream tails in
   bf16: `state_dtype`) streams 40 chunks through
   prompt refills; every output must be finite, 2048 samples, silent
   only while the delay fills; the slow, fast and head launches must each
   equal the frames decoded and the ring-step launches the tokens encoded.
   Reports p50/p90 chunk ms and a stage split.  Then, on the same weights,
   three shorter sessions, each with its own launch check and stage
   split: `fast_slow_config` (the LM kernels only, 12 chunks), `all_five`
   (also the ConvNeXt front kernel, 16 chunks: front launches = tokens)
   and `per_head_decode` (the per-head KV cache, 16 chunks: 12 attention
   launches a frame, no slow step); then the batched decode: the
   dual-AR frame at batch 4 (`arvc.prefill_prompt` to pos 1002, 16 greedy
   frames of `arvc.decode_one` under `per_head_decode`: 12 attention
   launches a frame, no slow-step or fast-loop launch), each frame also
   from a copy of the state under `PipelineConfig()`'s plain flags; tokens
   and codes agree up to bf16 flips that logit noise explains (at least
   90 %); frame ms p50/p90 of both;
5. the prompt side on phase 3's weights (`prompt_side`): a 10 s synthetic
   reference's speaker embeddings (seeded random CAM++ and speaker encoder
   at their default configs), content tokens and codes, timed;
   `StreamSession(cv, scfg, ref_wavs=[ref])` under tpu_optimized for 40
   chunks with the launch check, in float32 state and at the JAX package's
   serving point (bf16 tokenizer and vocoder weights, bf16 state), each
   with its set-up ms; `VoiceConverter.infer` of a 4 s source (greedy,
   delay 2): one fast-loop launch a generated frame, one slow-step launch
   a frame after the first, its ms and real-time factor;
6. serving on phase 3's weights and cut geometry (`serving`):
   `RealtimeEngine` under tpu_optimized (sampled), warmed, its refill
   programs run, snapshotted, then fed 40 chunks by a producer thread at
   the real rate: delivery ms p50/p90 (`latency_log`), the rings' overruns
   and underruns, the largest fetch batch; slow, fast and head launches
   equal to the frames, ring launches to the tokens; its output equal
   (within 1e-5 of the largest sample) to a `restore`d copy driven
   synchronously with the same chunks; one `process_chunk_async` under
   `torch.cuda.set_sync_debug_mode("error")`; a short `all_five` engine
   run (front launches = tokens).  `MultiStreamEngine` at batch 4 under
   per_head_decode (greedy), built by `fanout(4)`, four producer threads:
   tick ms p50/p90, missed ticks, audio-seconds a second, 12 attention
   launches a frame and no other kernel, each stream equal to the
   restored fanned-out session driven synchronously, and the share of
   codes equal to a directly built batch-4 session (reported).
   `transfer` of a session prepared on the CPU to the card, 16 chunks with
   the launch check, its codes against a session prepared on the card (at
   least 90 % with the LM and state in float32; reported in bf16).  Window
   mode, 8 chunks (one slow-step and one fast-loop launch a frame).
   `BatchServer` of four 4 s sources under per_head_decode (12 attention
   launches a frame; ms and real-time factor in bf16; with the LM in
   float32 at least 90 % of the codes equal to four single
   `VoiceConverter.infer` calls).  `cli.main(["convert", ...])` on
   synthetic wavs: the written wav's length;
7. training (`training_phase`): the ARVC trainer at full width
   (`PipelineConfig()`'s LM in float32, about 145 M trainable parameters,
   frozen tokenizer, vocoder, CAM++ and speaker encoder from phase 3's and
   phase 5's seeds) on synthetic batches of 4 sources of 86 to 215 frames:
   the first step's two losses and gradient norm against a float64
   `forward_train` on the card within 1e-4 relative; six steps with finite
   losses, steps 2-6 timed (`_features` and `_step` apart, CUDA events),
   frames a second, `max_memory_allocated`; 30 steps of
   `muon_adamw(lr=3e-3)` on one batch of features must end below half the
   first loss; a checkpoint into a fresh trainer bit-equal, `resume_latest`
   the highest step; a greedy `arvc.generate` on the trained weights under
   tpu_optimized (one slow-step launch a frame after the first, one
   fast-loop launch a frame) whose codes agree with the plain flags' at
   least 90 %;
8. checkpoints and the evals (`eval_phase`): the five published
   checkpoint files written from phase 3's and phase 5's random trees in
   the reference's state_dict layout, loaded by `cli.build_converter`
   with strict key coverage, every leaf bit-equal to
   `converter_from_numpy`; `cli anonymize` over a synthetic Kaldi
   directory of 4 speakers x 3 utterances of 3 s with two target
   references (one fast-loop launch a generated frame, one slow-step
   launch a frame after the first); `cli evaluate` with cosine and PLDA
   scoring, ASV_eval^anon on both backbones at their default configs, the
   SER fold heads and WER from cached hypotheses: every metric finite and
   in range, the training losses falling, CAM++ on the card against the
   CPU within 1e-4; each step's seconds and `max_memory_allocated`;
4. a {"kernels": [...]} line (six kernels; each one's launches from the
   session that runs it, plus phase 6's, 7's and 8's counted runs), the
   card line, and as the last line {"ok": true, "device": {...}}.

Any failed check raises, so the exit code is nonzero and no result line is
printed.  Without a CUDA card, or without the package beside this file, it
exits nonzero before any phase.
"""

from __future__ import annotations

import contextlib
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12  # CUDA cores, outside the tensor cores
RING_COUNTS = (0, 1, 511, 512, 1000, 3583, 3584)
ATTN_POS = (0, 1000, 2046)
ATTN_HEADS = (12, 48, 96)  # batch 1, 4 and 8 of the dual-AR's 12 heads
ATTN_TIME_BATCHES = (1, 4, 8)
ATTN_TIME_POS = (150, 1000, 1600)
ATTN_TOL = 1e-4  # ops/attention.py: the kernel's tolerance against its plain version
# the slow step's attention takes its rows in runs of 64 (float32) or 128
# (bf16) rows a block: positions at, around and between those edges
SLOW_POS = (0, 1, 62, 63, 64, 65, 126, 127, 128, 129, 1000, 2046)
SLOW_TIME_POS = (150, 1000, 1600)
SPF = 2048
FRAME_MS = 1000.0 * SPF / 44100
TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, n: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def lm_params(cfg, device, dtype):
    from streamvoiceanon_tpu_torch import params as P
    from streamvoiceanon_tpu_torch.utils import randparams as rp

    return P.dual_ar_params(rp.dual_ar_params_np(cfg, seed=11), device, dtype)


@contextlib.contextmanager
def plain_logits():
    """Collect the float32 logits the two plain decode versions hand their
    sampler, in call order."""
    from streamvoiceanon_tpu_torch.ops import fast_decode as fmod
    from streamvoiceanon_tpu_torch.ops import slow_decode as smod

    rec, orig = [], fmod.nucleus_sample

    def sample(logits, gumbel, **kw):
        rec.append(logits.detach().clone())
        return orig(logits, gumbel, **kw)

    fmod.nucleus_sample = smod.nucleus_sample = sample
    try:
        yield rec
    finally:
        fmod.nucleus_sample = smod.nucleus_sample = orig


def flip_gap(logits, gumbel, samp, want: int, got: int) -> float:
    """How far the plain sampler's choice `want` led the kernel's `got` in
    the plain version's race, in logit units (the race gap times the
    temperature when sampled); inf where `got` lies outside the nucleus."""
    from streamvoiceanon_tpu_torch.ops.decode_common import nucleus_race

    race = nucleus_race(logits, gumbel, **samp)
    unit = 1.0 if samp["greedy"] else max(samp["temperature"], 1e-5)
    return float(race[want] - race[got]) * unit


def compare_kernels(cfg, device, dtype, cache_dtype, pos0: int, frames: int,
                    check: bool):
    """Run both kernels and their plain versions on the same inputs for
    `frames` frames, greedy then sampled.  Returns per-kernel stats: tokens
    or codes that agree, frames, max abs error of the float outputs, the
    largest logit difference kernel against plain over the steps that had
    the same inputs, and for each token or code that differs, (greedy,
    frame, codebook step, `flip_gap`)."""
    import torch

    from streamvoiceanon_tpu_torch.ops.fast_decode import fast_decode, fast_decode_plain
    from streamvoiceanon_tpu_torch.ops.slow_decode import (
        slow_decode_step, slow_decode_step_plain)

    p = lm_params(cfg, device, dtype)
    g = torch.Generator(device=device).manual_seed(5)
    L, S, D = cfg.n_layer, cfg.max_seq_len, cfg.n_head * cfg.head_dim
    kc = (torch.randn((L, S, D), generator=g, device=device) * 0.5).to(cache_dtype)
    vc = (torch.randn((L, S, D), generator=g, device=device) * 0.5).to(cache_dtype)
    skw = dict(n_head=cfg.n_head, head_dim=cfg.head_dim, rope_base=cfg.rope_base,
               norm_eps=cfg.norm_eps)
    fkw = dict(nq=cfg.num_codebooks, n_head=cfg.fast_n_head, head_dim=cfg.fast_head_dim,
               rope_base=cfg.rope_base, norm_eps=cfg.norm_eps)
    stats = {k: {"agree": 0, "n": 0, "err": 0.0, "logit_diff": 0.0, "flips": []}
             for k in ("slow", "fast")}
    for greedy in (True, False):
        samp = dict(temperature=0.7, top_p=0.7, greedy=greedy)
        for f in range(frames):
            pos = pos0 + 2 * f
            x2 = torch.randn((2, D), generator=g, device=device).to(dtype)
            gs = -torch.log(-torch.log(torch.rand((1, cfg.vocab_size), generator=g,
                                                  device=device)))
            gf = -torch.log(-torch.log(torch.rand(
                (1, cfg.num_codebooks, cfg.codebook_size), generator=g, device=device)))
            args = (p["layers"], x2, kc, vc, pos, p["norm"]["w"], p["output"]["w"], gs)
            ko = slow_decode_step(*args, **skw, **samp)
            with plain_logits() as rec:
                po = slow_decode_step_plain(*args, **skw, **samp)
            err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(ko[:3], po[:3]))
            st = stats["slow"]
            st["n"] += 1
            st["agree"] += int(torch.equal(ko[3], po[3]))
            st["err"] = max(st["err"], err)
            st["logit_diff"] = max(st["logit_diff"], float(
                (slow_decode_step.last_logits - rec[0]).abs().max()))
            if not torch.equal(ko[3], po[3]):
                st["flips"].append((greedy, f, 0, flip_gap(
                    rec[0], gs.reshape(-1), samp, int(po[3][0]), int(ko[3][0]))))
            hidden = po[0][1:2]
            fargs = (p["fast_layers"], p["fast_norm"]["w"], p["fast_output"]["w"],
                     p["fast_embeddings"], p["codebook_embeddings"], hidden, gf)
            kf = fast_decode(*fargs, **fkw, **samp)
            with plain_logits() as rec:
                pf = fast_decode_plain(*fargs, **fkw, **samp)
            st = stats["fast"]
            st["n"] += 1
            st["agree"] += int(torch.equal(kf[0], pf[0]))
            st["err"] = max(st["err"], float((kf[1].float() - pf[1].float()).abs().max()))
            # steps up to the first differing code had the same inputs
            differ = (kf[0][0] != pf[0][0]).nonzero()
            s1 = int(differ[0, 0]) if len(differ) else cfg.num_codebooks - 1
            st["logit_diff"] = max(st["logit_diff"], float(
                (fast_decode.last_logits[: s1 + 1] - torch.stack(rec[: s1 + 1])).abs().max()))
            if len(differ):
                st["flips"].append((greedy, f, s1, flip_gap(
                    rec[s1], gf[0, s1], samp, int(pf[0][0, s1]), int(kf[0][0, s1]))))
            if check:
                if not torch.equal(ko[3], po[3]) or err > TOL:
                    raise AssertionError(f"slow step disagrees (greedy={greedy}, frame {f}): "
                                         f"tokens {ko[3].item()} vs {po[3].item()}, err {err:.3e}")
                if not torch.equal(kf[0], pf[0]) or stats["fast"]["err"] > TOL:
                    raise AssertionError(f"fast loop disagrees (greedy={greedy}, frame {f}): "
                                         f"{kf[0].tolist()} vs {pf[0].tolist()}, "
                                         f"err {stats['fast']['err']:.3e}")
            kc[:, pos : pos + 2] = po[1]
            vc[:, pos : pos + 2] = po[2]
    return stats


def compare_fast(cfg, device, dtype, frames: int, check: bool):
    """The fast loop alone against its plain version on random hidden rows,
    greedy then sampled: (codes that agree, calls, max abs error of the
    audio embedding).  Each call must be one launch."""
    import torch

    from streamvoiceanon_tpu_torch.ops.fast_decode import fast_decode, fast_decode_plain

    p = lm_params(cfg, device, dtype)
    g = torch.Generator(device=device).manual_seed(37)
    fkw = dict(nq=cfg.num_codebooks, n_head=cfg.fast_n_head, head_dim=cfg.fast_head_dim,
               rope_base=cfg.rope_base, norm_eps=cfg.norm_eps)
    agree, n, worst = 0, 0, 0.0
    for greedy in (True, False):
        samp = dict(temperature=0.7, top_p=0.7, greedy=greedy)
        for f in range(frames):
            hidden = torch.randn((1, cfg.fast_dim), generator=g, device=device).to(dtype)
            gf = -torch.log(-torch.log(torch.rand(
                (1, cfg.num_codebooks, cfg.codebook_size), generator=g, device=device)))
            fargs = (p["fast_layers"], p["fast_norm"]["w"], p["fast_output"]["w"],
                     p["fast_embeddings"], p["codebook_embeddings"], hidden, gf)
            before = fast_decode.launches
            kf = fast_decode(*fargs, **fkw, **samp)
            if fast_decode.launches != before + 1:
                raise AssertionError("fast loop: not one launch a call")
            pf = fast_decode_plain(*fargs, **fkw, **samp)
            err = float((kf[1].float() - pf[1].float()).abs().max())
            n += 1
            agree += int(torch.equal(kf[0], pf[0]))
            worst = max(worst, err)
            if check and (not torch.equal(kf[0], pf[0]) or err > TOL):
                raise AssertionError(f"fast loop disagrees (greedy={greedy}, frame {f}): "
                                     f"{kf[0].tolist()} vs {pf[0].tolist()}, err {err:.3e}")
    return agree, n, worst


def compare_slow_positions(cfg, device, dtype, positions, check: bool):
    """The slow step (sampled) against its plain version at each position,
    and again with the cache rows >= pos poisoned with NaN, which must leave
    the kernel's outputs finite and bitwise unchanged; then one layer's
    attention alone against its plain version at every position of
    0 .. 259 and at 1000, 1023, 1024 and S - 2.  Returns (tokens that agree,
    steps, max abs err of the step's float outputs, max abs err of the
    attention's outputs)."""
    import torch

    from streamvoiceanon_tpu_torch.ops.slow_decode import (
        slow_attention, slow_attention_plain, slow_decode_step, slow_decode_step_plain)

    p = lm_params(cfg, device, dtype)
    g = torch.Generator(device=device).manual_seed(19)
    L, S, D = cfg.n_layer, cfg.max_seq_len, cfg.n_head * cfg.head_dim
    kc = (torch.randn((L, S, D), generator=g, device=device) * 0.5).to(dtype)
    vc = (torch.randn((L, S, D), generator=g, device=device) * 0.5).to(dtype)
    skw = dict(n_head=cfg.n_head, head_dim=cfg.head_dim, rope_base=cfg.rope_base,
               norm_eps=cfg.norm_eps, temperature=0.7, top_p=0.7, greedy=False)
    agree, worst = 0, 0.0
    for pos in positions:
        x2 = torch.randn((2, D), generator=g, device=device).to(dtype)
        gs = -torch.log(-torch.log(torch.rand((1, cfg.vocab_size), generator=g,
                                              device=device)))
        rest = (pos, p["norm"]["w"], p["output"]["w"], gs)
        ko = slow_decode_step(p["layers"], x2, kc, vc, *rest, **skw)
        po = slow_decode_step_plain(p["layers"], x2, kc, vc, *rest, **skw)
        kp, vp = kc.clone(), vc.clone()
        kp[:, pos:], vp[:, pos:] = float("nan"), float("nan")
        poisoned = slow_decode_step(p["layers"], x2, kp, vp, *rest, **skw)
        del kp, vp
        if not all(torch.isfinite(a.float()).all() and torch.equal(a, b)
                   for a, b in zip(poisoned, ko)):
            raise AssertionError(f"slow step at pos {pos} read a stale cache row")
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(ko[:3], po[:3]))
        agree += int(torch.equal(ko[3], po[3]))
        worst = max(worst, err)
        if check and (not torch.equal(ko[3], po[3]) or err > TOL):
            raise AssertionError(f"slow step disagrees at pos {pos}: tokens "
                                 f"{ko[3].item()} vs {po[3].item()}, err {err:.3e}")
    akw = dict(n_head=cfg.n_head, head_dim=cfg.head_dim, rope_base=cfg.rope_base)
    attn_worst = 0.0
    for pos in [*range(260), 1000, 1023, 1024, S - 2]:
        qkv = torch.randn((2, 3 * D), generator=g, device=device).to(dtype)
        ka = slow_attention(qkv, kc[0], vc[0], pos, **akw)
        pa = slow_attention_plain(qkv, kc[0], vc[0], pos, **akw)
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(ka, pa))
        attn_worst = max(attn_worst, err)
        if check and not err <= TOL:
            raise AssertionError(f"slow attention disagrees at pos {pos}: err {err:.3e}")
    return agree, len(positions), worst, attn_worst


def slow_bound(cfg, p, pos, wsize, csize):
    lay = p["layers"]
    weights = nbytes(*(lay[k]["w"] for k in lay), p["norm"]["w"], p["output"]["w"])
    D = cfg.n_head * cfg.head_dim
    cache = 2 * cfg.n_layer * pos * D * csize
    io = 2 * D * wsize * 2 + 2 * cfg.n_layer * 2 * D * csize + cfg.vocab_size * 4 + 4
    flops = 2 * 2 * sum(lay[k]["w"].numel() for k in ("wqkv", "wo", "w1", "w3", "w2"))
    flops += 2 * p["output"]["w"].numel() + 2 * 2 * 2 * cfg.n_layer * pos * D
    return weights + cache + io, flops


def fast_bound(cfg, p, wsize):
    lay = p["fast_layers"]
    nq, D = cfg.num_codebooks, cfg.fast_dim
    weights = nbytes(*(lay[k]["w"] for k in lay), p["fast_norm"]["w"], p["fast_output"]["w"])
    rows = 2 * nq * D * wsize  # the sampled fast-embedding and codebook rows
    io = D * wsize + nq * cfg.codebook_size * 4 + nq * 4 + D * wsize
    flops = nq * 2 * (sum(lay[k]["w"].numel() for k in ("wqkv", "wo", "w1", "w3", "w2"))
                      + p["fast_output"]["w"].numel())
    return weights + rows + io, flops


def time_kernels(cfg, device, pos: int, names=("slow", "fast")):
    """bf16 weights and cache at pos: kernel and plain times, bounds."""
    import torch

    from streamvoiceanon_tpu_torch.ops.fast_decode import fast_decode, fast_decode_plain
    from streamvoiceanon_tpu_torch.ops.slow_decode import (
        slow_decode_step, slow_decode_step_plain)

    dt = torch.bfloat16
    p = lm_params(cfg, device, dt)
    g = torch.Generator(device=device).manual_seed(7)
    L, S, D = cfg.n_layer, cfg.max_seq_len, cfg.n_head * cfg.head_dim
    kc = (torch.randn((L, S, D), generator=g, device=device) * 0.5).to(dt)
    vc = (torch.randn((L, S, D), generator=g, device=device) * 0.5).to(dt)
    x2 = torch.randn((2, D), generator=g, device=device).to(dt)
    gs = -torch.log(-torch.log(torch.rand((1, cfg.vocab_size), generator=g, device=device)))
    gf = -torch.log(-torch.log(torch.rand((1, cfg.num_codebooks, cfg.codebook_size),
                                          generator=g, device=device)))
    samp = dict(temperature=0.7, top_p=0.7, greedy=False)
    skw = dict(n_head=cfg.n_head, head_dim=cfg.head_dim, rope_base=cfg.rope_base,
               norm_eps=cfg.norm_eps, **samp)
    fkw = dict(nq=cfg.num_codebooks, n_head=cfg.fast_n_head, head_dim=cfg.fast_head_dim,
               rope_base=cfg.rope_base, norm_eps=cfg.norm_eps, **samp)
    sargs = (p["layers"], x2, kc, vc, pos, p["norm"]["w"], p["output"]["w"], gs)
    fargs = (p["fast_layers"], p["fast_norm"]["w"], p["fast_output"]["w"],
             p["fast_embeddings"], p["codebook_embeddings"], x2[1:2], gf)
    out = {}
    # turns: plain, kernel, kernel, plain
    for name, kern, plain, args, kw in (
            ("slow", slow_decode_step, slow_decode_step_plain, sargs, skw),
            ("fast", fast_decode, fast_decode_plain, fargs, fkw)):
        if name not in names:
            continue
        p1 = cuda_ms(lambda: plain(*args, **kw), 5)
        k1 = cuda_ms(lambda: kern(*args, **kw), 30)
        k2 = cuda_ms(lambda: kern(*args, **kw), 30)
        p2 = cuda_ms(lambda: plain(*args, **kw), 5)
        out[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "ms_runs": [k1, k2],
                     "plain_runs": [p1, p2]}
    bs, fs = slow_bound(cfg, p, pos, 2, 2)
    bf, ff = fast_bound(cfg, p, 2)
    for name, (b, fl) in (("slow", (bs, fs)), ("fast", (bf, ff))):
        if name not in names:
            continue
        t_bytes = 1e3 * b / HBM_BYTES_PER_S
        t_ops = 1e3 * fl / BF16_FLOPS
        out[name].update(bound_ms=max(t_bytes, t_ops), bytes=b, flops=fl,
                         bound_by="bytes" if t_bytes >= t_ops else "operations")
    return out


FAMILIES = ("matvec", "attention", "sample", "memset/copy", "other")


def family(kernel: str) -> str:
    if "matvec_kernel" in kernel:
        return "matvec"
    if "attn" in kernel:
        return "attention"
    if "sample_kernel" in kernel:
        return "sample"
    if any(w in kernel.lower() for w in ("memset", "memcpy", "copy", "fill")):
        return "memset/copy"
    return "other"


def slow_breakdown(cfg, device, positions, n: int = 30):
    """The slow step (bf16, sampled) at each position: device ms per step by
    kernel family from torch.profiler over n steps, and launches per step;
    the step's CUDA-event time, the host's time to enqueue one, and the
    time of one step replayed from a CUDA graph (no host between launches);
    one layer's attention alone (CUDA events over 30 back-to-back launches
    of the step's attention launch)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from streamvoiceanon_tpu_torch.ops.slow_decode import slow_attention, slow_decode_step

    dt = torch.bfloat16
    p = lm_params(cfg, device, dt)
    g = torch.Generator(device=device).manual_seed(7)
    L, S, D = cfg.n_layer, cfg.max_seq_len, cfg.n_head * cfg.head_dim
    kc = (torch.randn((L, S, D), generator=g, device=device) * 0.5).to(dt)
    vc = (torch.randn((L, S, D), generator=g, device=device) * 0.5).to(dt)
    x2 = torch.randn((2, D), generator=g, device=device).to(dt)
    qkv = torch.randn((2, 3 * D), generator=g, device=device).to(dt)
    gs = -torch.log(-torch.log(torch.rand((1, cfg.vocab_size), generator=g, device=device)))
    skw = dict(n_head=cfg.n_head, head_dim=cfg.head_dim, rope_base=cfg.rope_base,
               norm_eps=cfg.norm_eps, temperature=0.7, top_p=0.7, greedy=False)
    akw = dict(n_head=cfg.n_head, head_dim=cfg.head_dim, rope_base=cfg.rope_base)
    out = {}
    for pos in positions:
        step = lambda: slow_decode_step(p["layers"], x2, kc, vc, pos, p["norm"]["w"],
                                        p["output"]["w"], gs, **skw)
        step_ms = cuda_ms(step, n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step()
        host_ms = 1e3 * (time.perf_counter() - t0) / 10
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        graph_ms = cuda_ms(graph.replay, n)
        del graph
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
        fam = dict.fromkeys(FAMILIES, 0.0)
        launches = dict.fromkeys(FAMILIES, 0)
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            fam[family(e.key)] += us / 1e3 / n
            launches[family(e.key)] += e.count / n
        attn_ms = cuda_ms(lambda: slow_attention(qkv, kc[0], vc[0], pos, reps=30, **akw),
                          3, warmup=1) / 30
        out[pos] = {"step_ms": step_ms, "device_ms": sum(fam.values()), "family_ms": fam,
                    "launches": launches, "attn_layer_ms": attn_ms, "host_ms": host_ms,
                    "graph_ms": graph_ms}
        log(f"[2] slow step bf16 pos {pos}: {step_ms:.4f} ms a step (CUDA events), "
            f"{host_ms:.4f} ms to enqueue one (host clock, 10 steps), {graph_ms:.4f} ms a "
            f"step replayed from a CUDA graph (CUDA events: the device alone); device "
            f"time a step by family (torch.profiler over {n} steps): "
            + ", ".join(f"{k} {v:.4f} ms ({launches[k]:g} launches)" for k, v in fam.items())
            + f", all {sum(fam.values()):.4f} ms"
            + ("" if sum(fam.values()) > 0 else " (the profiler saw no device time)")
            + f"; one layer's attention alone {attn_ms:.4f} ms (CUDA events), "
            f"x {L} layers {L * attn_ms:.4f} ms")
    return out


def fast_breakdown(cfg, device, n: int = 30):
    """The fast loop (bf16, sampled): its CUDA-event time a call, the host's
    time to enqueue one, its device launches a call and their device time
    (torch.profiler over n calls; the launches must be one, the loop's own
    kernel), and its time replayed from a CUDA graph, or why the
    cooperative launch could not be captured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from streamvoiceanon_tpu_torch.ops.fast_decode import fast_decode, fast_decode_timeline

    dt = torch.bfloat16
    p = lm_params(cfg, device, dt)
    g = torch.Generator(device=device).manual_seed(7)
    hidden = torch.randn((1, cfg.fast_dim), generator=g, device=device).to(dt)
    gf = -torch.log(-torch.log(torch.rand((1, cfg.num_codebooks, cfg.codebook_size),
                                          generator=g, device=device)))
    fkw = dict(nq=cfg.num_codebooks, n_head=cfg.fast_n_head, head_dim=cfg.fast_head_dim,
               rope_base=cfg.rope_base, norm_eps=cfg.norm_eps, temperature=0.7, top_p=0.7,
               greedy=False)
    args = (p["fast_layers"], p["fast_norm"]["w"], p["fast_output"]["w"],
            p["fast_embeddings"], p["codebook_embeddings"], hidden, gf)
    call = lambda: fast_decode(*args, **fkw)
    call_ms = cuda_ms(call, n)
    phases = phase_split(fast_decode_timeline(*args, **fkw), cfg.n_fast_layer)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        call()
    host_ms = 1e3 * (time.perf_counter() - t0) / 10
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    launches, own, device_ms = 0.0, 0.0, 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        launches += e.count / n
        device_ms += us / 1e3 / n
        if "fast_loop_kernel" in e.key:
            own += e.count / n
    # the profiler may drop a record at the edge of its window: every launch
    # it saw must be the loop's kernel, one a call
    if launches != own or round(own) != 1:
        raise AssertionError(f"fast loop: {launches:g} device launches a call "
                             f"({own:g} of its kernel), expected one")
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            call()
        graph_ms = cuda_ms(graph.replay, n)
        graph_note = f"{graph_ms:.4f} ms a call replayed from a CUDA graph"
        del graph
    except Exception as e:  # report, do not fail: capture is a measurement here
        graph_ms = None
        graph_note = f"no CUDA graph: the capture failed ({type(e).__name__}: {e})"
    log(f"[2] fast loop bf16: {call_ms:.4f} ms a call (CUDA events), {host_ms:.4f} ms to "
        f"enqueue one (host clock, 10 calls), {launches:g} device launch a call, "
        f"{device_ms:.4f} ms of device time (torch.profiler over {n} calls); {graph_note}")
    log("[2] fast loop bf16, one launch's phases (the card's global timer at each grid "
        "barrier): " + ", ".join(
            f"{k} {v['n']} x (work {v['work_us']:.2f} + barrier {v['wait_us']:.2f} us)"
            for k, v in phases["kinds"].items())
        + f"; all {phases['total_us']:.1f} us, of it in barriers {phases['wait_us']:.1f} us")
    return {"ms": call_ms, "host_ms": host_ms, "launches": launches, "device_ms": device_ms,
            "graph_ms": graph_ms, "phases": phases}


def head_breakdown(hcfg, device, n: int = 30):
    """The HiFiGAN head (float32, T0 = 4): its CUDA-event time a call, the
    host's time to enqueue one, its time replayed from a CUDA graph, and
    from torch.profiler over 10 calls its device launches a call by kernel
    (they must equal `device_launches`, the kernel's own plan), the device
    span of a call (first launch's start to last launch's end) and each
    launch's advance (its end less the previous launch's end).  Launches
    chained by programmatic dependent launch overlap, so their summed spans
    exceed the call's span; the advances add up to it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from streamvoiceanon_tpu_torch.ops.hifigan import (
        device_launches, head_stream_step, head_stream_step_timeline, init_packed_state,
        level_blocks, level_plan, level_tile)

    _, pw = head_params(hcfg, device)
    g = torch.Generator(device=device).manual_seed(17)
    st = init_packed_state(hcfg, 1, device=device)
    x = torch.randn((1, 4, hcfg.num_mels), generator=g, device=device)
    call = lambda: head_stream_step(pw, st, x, hcfg)
    call_ms = cuda_ms(call, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        call()
    host_ms = 1e3 * (time.perf_counter() - t0) / 10
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call()
    graph_ms = cuda_ms(graph.replay, n)
    del graph
    # the profiler may drop device records (one run of this script saw 27.3
    # of 37 launches a call): it never adds any, so take the first of up to
    # three windows of m calls that holds every launch
    want, m = device_launches(hcfg, 4), 10
    for window in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(m):
                call()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if len(spans) > m * want:
            raise AssertionError(f"head: {len(spans) / m:g} device launches a call, its plan "
                                 f"has {want}")
        if len(spans) == m * want:
            break
    else:
        raise AssertionError(f"head: {len(spans) / m:g} device launches a call in the last of "
                             f"three profiler windows, its plan has {want}")
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = re.sub(r"\(.*", "", e.key.replace("(anonymous namespace)::", ""))
        k = by_kernel.setdefault(name, [0.0, 0.0])
        k[0] += e.count / m
        k[1] += us / 1e3 / m
    launches = sum(c for c, _ in by_kernel.values())
    calls = np.asarray(spans, dtype=np.float64).reshape(m, want, 2)
    ends = np.maximum.accumulate(calls[:, :, 1], axis=1)
    span_ms = float(np.mean(ends[:, -1] - calls[:, 0, 0])) / 1e3
    advance_us = np.mean(np.diff(np.concatenate([calls[:, :1, 0], ends], axis=1), axis=1),
                         axis=0).tolist()
    log(f"[2] head f32 T0 4: {call_ms:.4f} ms a call (CUDA events), {host_ms:.4f} ms to "
        f"enqueue one (host clock, 10 calls), {graph_ms:.4f} ms a call replayed from a CUDA "
        f"graph; torch.profiler over {m} calls (window {window + 1} of at most 3): "
        f"{launches:g} device launches a call (plan {want}), device span a call "
        f"{span_ms:.4f} ms; summed launch spans by kernel: " + ", ".join(
            f"{k} {c:g} launches {ms:.4f} ms" for k, (c, ms) in by_kernel.items()))
    log("[2] head f32 T0 4, each launch's advance in call order, us (torch.profiler, mean "
        f"over {m} calls): " + " ".join(f"{u:.2f}" for u in advance_us))
    # one call's blocks by the card's global timer: per level its tile and
    # blocks, its advance (last exit less the level before's), and the
    # medians over its blocks of start to K loop (the wait for the level
    # before, then the tail), the K loop, and K loop to exit (the split
    # partial and ticket, or the merge and the epilogue; also the largest)
    t = head_stream_step_timeline(pw, st, x, hcfg).cpu().numpy().astype(np.int64)
    parts, prev = [], None
    for lvl, lv in enumerate(level_plan(hcfg, 4)):
        b = t[lvl, : level_blocks(lv)] / 1e3
        end = b[:, 3].max()
        adv = end - (b[:, 0].min() if prev is None else prev)
        prev = end
        tm, tn = level_tile(lv)
        parts.append(f"L{lvl} {tm}x{tn} {len(b)} blocks: {adv:.2f} | "
                     f"{np.median(b[:, 1] - b[:, 0]):.2f} {np.median(b[:, 2] - b[:, 1]):.2f} "
                     f"{np.median(b[:, 3] - b[:, 2]):.2f}/{(b[:, 3] - b[:, 2]).max():.2f}")
    log("[2] head f32 T0 4, one call by the global timer, us (level tile blocks: advance | "
        "median start to K loop, K loop, K loop to exit/largest): " + "; ".join(parts))
    return {"ms": call_ms, "host_ms": host_ms, "launches": launches, "span_ms": span_ms,
            "graph_ms": graph_ms, "by_kernel": by_kernel, "advance_us": advance_us}


def call_times(call, n: int):
    """A call's CUDA-event ms, the host's ms to enqueue one (10 calls), and
    its ms replayed from a CUDA graph (None, with the reason in the note,
    where the capture fails)."""
    import torch

    call_ms = cuda_ms(call, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        call()
    host_ms = 1e3 * (time.perf_counter() - t0) / 10
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            call()
        graph_ms = cuda_ms(graph.replay, n)
        graph_note = f"{graph_ms:.4f} ms a call replayed from a CUDA graph"
        del graph
    except Exception as e:  # report, do not fail: capture is a measurement here
        graph_ms = None
        graph_note = f"no CUDA graph: the capture failed ({type(e).__name__}: {e})"
    return call_ms, host_ms, graph_ms, graph_note


def profile_launches(call, ok, m: int = 10):
    """torch.profiler over m calls: (device launches a call, {kernel:
    [launches, device ms] a call}, window).  The profiler may drop device
    records at the edge of its window, never adds any: take the first of up
    to three windows whose launch count `ok` accepts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for window in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(m):
                call()
            torch.cuda.synchronize()
        by_kernel = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            name = re.sub(r"\(.*", "", e.key.replace("(anonymous namespace)::", ""))
            k = by_kernel.setdefault(name, [0.0, 0.0])
            k[0] += e.count / m
            k[1] += us / 1e3 / m
        launches = sum(c for c, _ in by_kernel.values())
        if ok(launches):
            break
    return launches, by_kernel, window


def ring_breakdown(wcfg, device, count: int = 1000, n: int = 30):
    """The ring step (float32, as on the main path) at `count`: its
    CUDA-event time a call, the host's time to enqueue one, its time
    replayed from a CUDA graph, and from torch.profiler its device launches
    a call and their device time by kernel.  Where the package has
    `wt_stream_step_timeline` (the persistent kernel), the launches must
    be one a call, and one call's phases are split by the card's global
    timer (`ring_phase_split`); an earlier tree's launches are reported."""
    import torch

    from streamvoiceanon_tpu_torch.ops import wt_stream as wts

    dt = torch.float32
    layers = wt_layers(wcfg, device, dt)
    g = torch.Generator(device=device).manual_seed(17)
    x, kr, vr = ring_inputs(wcfg, device, dt, count, g)
    rkw = dict(n_head=wcfg.n_head, head_dim=wcfg.head_dim, rope_base=wcfg.rope_base,
               norm_eps=wcfg.norm_eps, table_rows=wcfg.rope_table_rows)
    persistent = hasattr(wts, "wt_stream_step_timeline")
    call = lambda: wts.wt_stream_step(layers, x, kr, vr, count, **rkw)
    call_ms, host_ms, graph_ms, graph_note = call_times(call, n)
    m = 10
    launches, by_kernel, window = profile_launches(
        call, lambda c: c == round(c) and (c == 1 or not persistent), m)
    if persistent and launches != 1:
        raise AssertionError(f"ring step: {launches:g} device launches a call, expected one: "
                             + ", ".join(f"{k} {c:g}" for k, (c, _) in by_kernel.items()))
    device_ms = sum(ms for _, ms in by_kernel.values())
    log(f"[2] ring step f32 count {count}: {call_ms:.4f} ms a call (CUDA events), "
        f"{host_ms:.4f} ms to enqueue one (host clock, 10 calls); {graph_note}; "
        f"torch.profiler over {m} calls (window {window + 1} of at most 3): {launches:g} "
        f"device launches a call, {device_ms:.4f} ms of device time a call; by kernel: "
        + ", ".join(f"{k} {c:g} launches {ms:.4f} ms" for k, (c, ms) in by_kernel.items()))
    out = {"ms": call_ms, "host_ms": host_ms, "graph_ms": graph_ms, "launches": launches,
           "device_ms": device_ms, "by_kernel": by_kernel}
    if persistent:
        out["phases"] = ring_phase_split(
            wts.wt_stream_step_timeline(layers, x, kr, vr, count, **rkw))
        ph = out["phases"]
        log(f"[2] ring step f32 count {count}, one launch's phases by the card's global "
            "timer, mean over layers, us (work: first entry to last exit; barrier: last "
            "exit to the next phase's last entry; busy: median block's entry to exit): "
            + ", ".join(f"{k} work {v['work_us']:.2f} + barrier {v['wait_us']:.2f} "
                        f"(busy {v['busy_us']:.2f})" for k, v in ph["kinds"].items())
            + f"; all {ph['total_us']:.1f} us, of it in barriers {ph['wait_us']:.1f} us")
    return out


def front_breakdown(tcfg, device, n: int = 30):
    """The ConvNeXt front (float32, T0 = 4, as on the `all_five` path): its
    CUDA-event time a call, the host's time to enqueue one, its time
    replayed from a CUDA graph, and from torch.profiler its device launches
    a call and their device time by kernel.  Where the package has
    `encoder_front_step_timeline` (the persistent kernel), the launches
    must be one a call, and one call's phases are split by the card's
    global timer (`front_phase_split`); an earlier tree's launches are
    reported."""
    import torch

    from streamvoiceanon_tpu_torch.ops import convnext_enc as enc

    persistent = hasattr(enc, "encoder_front_step_timeline")
    if persistent:
        pw, units = front_weights(tcfg, device)
        kw = {"units": units}
    else:  # an earlier tree: packed weights only
        from streamvoiceanon_tpu_torch import params as P

        pw = enc.packed_weights(P.tokenizer_params(front_tree_np(tcfg), device), tcfg)
        kw = {}
    g = torch.Generator(device=device).manual_seed(19)
    st = front_state(tcfg, device, g)
    mel = torch.randn((1, 4, tcfg.backbone.input_channels), generator=g, device=device)
    call = lambda: enc.encoder_front_step(pw, st, mel, tcfg, **kw)
    call_ms, host_ms, graph_ms, graph_note = call_times(call, n)
    m = 10
    launches, by_kernel, window = profile_launches(
        call, lambda c: c == round(c) and (c == 1 or not persistent), m)
    if persistent and launches != 1:
        raise AssertionError(f"front: {launches:g} device launches a call, expected one: "
                             + ", ".join(f"{k} {c:g}" for k, (c, _) in by_kernel.items()))
    device_ms = sum(ms for _, ms in by_kernel.values())
    log(f"[2] front f32 T0 4: {call_ms:.4f} ms a call (CUDA events), {host_ms:.4f} ms to "
        f"enqueue one (host clock, 10 calls); {graph_note}; torch.profiler over {m} calls "
        f"(window {window + 1} of at most 3): {launches:g} device launches a call, "
        f"{device_ms:.4f} ms of device time a call; by kernel: "
        + ", ".join(f"{k} {c:g} launches {ms:.4f} ms" for k, (c, ms) in by_kernel.items()))
    out = {"ms": call_ms, "host_ms": host_ms, "graph_ms": graph_ms, "launches": launches,
           "device_ms": device_ms, "by_kernel": by_kernel}
    if persistent:
        out["phases"] = ph = front_phase_split(
            enc.encoder_front_step_timeline(pw, st, mel, tcfg, units), enc.phases(tcfg))
        log("[2] front f32 T0 4, one launch's phases by the card's global timer, by kind "
            "and place, mean us (work: first entry to last exit; barrier: last exit to the "
            "next phase's last entry; busy: median block's entry to exit; rows and product: "
            "median owning block's entry to its product's start, and the product to its "
            "exit; MB: the phase's weight bytes): " + ", ".join(
                f"{k} {v['n']} x (work {v['work_us']:.2f} + barrier {v['wait_us']:.2f}, busy "
                f"{v['busy_us']:.2f}, rows {v['rows_us']:.2f} + product "
                f"{v['product_us']:.2f}, {v['mb']:.3f} MB)" for k, v in ph["kinds"].items())
            + f"; all {ph['total_us']:.1f} us, of it in barriers {ph['wait_us']:.1f} us")
        log("[2] front f32 T0 4, the same launch phase by phase, work + barrier us: " + " ".join(
            f"{p.kind}{p.where}:{w:.2f}+{b:.2f}" for p, w, b in zip(
                enc.phases(tcfg), ph["work_us"], ph["barrier_us"])))
    return out


def attn_breakdown(dcfg, device, n: int = 30):
    """The decode attention (bf16 cache) at batch 1 and pos 1000 (12 heads)
    and batch 8 and pos 1600 (96 heads): its CUDA-event time a call, the
    host's time to enqueue one, its time replayed from a CUDA graph, and
    from torch.profiler its device launches a call (must be one) and
    device time; where the package has `split_plan`, the planned split
    size against others (`attn_split_times`); then kernel times over
    ATTN_TIME_BATCHES x ATTN_TIME_POS.
    Runs against whatever package sits beside this script, so an earlier
    tree's kernel is timed the same way."""
    import torch

    from streamvoiceanon_tpu_torch.ops.attention import decode_attention

    g = torch.Generator(device=device).manual_seed(33)
    D, S, T = dcfg.head_dim, dcfg.max_seq_len, 2
    out = {}
    for B, pos in ((1, 1000), (8, 1600)):
        H = B * dcfg.n_head
        q, kn, vn, kc, vc = attn_inputs(H, T, D, S, device, torch.bfloat16, g)
        call = lambda: decode_attention(q, kn, vn, kc, vc, pos)
        call_ms, host_ms, graph_ms, graph_note = call_times(call, n)
        m = 10
        launches, by_kernel, window = profile_launches(call, lambda c: c == 1, m)
        if launches != 1:
            raise AssertionError(f"decode attention: {launches:g} device launches a call, "
                                 "expected one: " + ", ".join(
                                     f"{k} {c:g}" for k, (c, _) in by_kernel.items()))
        device_ms = sum(ms for _, ms in by_kernel.values())
        log(f"[2] decode attention bf16 {H} heads pos {pos}: {call_ms:.4f} ms a call (CUDA "
            f"events), {host_ms:.4f} ms to enqueue one (host clock, 10 calls); {graph_note}; "
            f"torch.profiler over {m} calls (window {window + 1} of at most 3): "
            f"{launches:g} device launches a call, {device_ms:.4f} ms of device time a "
            "call; " + ", ".join(f"{k} {c:g} launches {ms:.4f} ms"
                                 for k, (c, ms) in by_kernel.items()))
        out[H, pos] = {"ms": call_ms, "host_ms": host_ms, "graph_ms": graph_ms,
                       "launches": launches, "device_ms": device_ms}
        del q, kn, vn, kc, vc
    from streamvoiceanon_tpu_torch.ops import attention as att

    if hasattr(att, "split_plan"):  # this tree's split kernel: the plan against others
        for H, pos in ((12, 1000), (96, 1600)):
            out["splits", H, pos] = attn_split_times(H, pos, D, S, device, g)
    grid = {}
    for B in ATTN_TIME_BATCHES:
        H = B * dcfg.n_head
        q, kn, vn, kc, vc = attn_inputs(H, T, D, S, device, torch.bfloat16, g)
        for pos in ATTN_TIME_POS:
            call = lambda: decode_attention(q, kn, vn, kc, vc, pos)
            runs = [cuda_ms(call, 30), cuda_ms(call, 30)]
            grid[B, pos] = {"ms": min(runs), **attn_bound(H, T, D, pos, 2)}
    log("[2] decode attention bf16 kernel ms (best of two runs of 30 calls) / bound ms "
        "by batch x pos: " + ", ".join(
            f"B {B} ({B * dcfg.n_head} heads) pos {pos} {t['ms']:.4f} / {t['bound_ms']:.4f}"
            for (B, pos), t in grid.items()))
    out["grid"] = grid
    return out


def attn_split_times(H: int, pos: int, D: int, S: int, device, g, reps: int = 20):
    """The split kernel's device ms a launch (a CUDA graph of `reps`
    back-to-back launches, best of three replays) at `split_plan`'s rows a
    split and at other splits a head: one, one wave of SMs, twice the
    plan's, the most the card holds at once; and the host's us a call for
    the whole wrapper against its C entry point alone (2000 calls)."""
    import torch

    from streamvoiceanon_tpu_torch.ops import attention as att

    dt, T, P = torch.bfloat16, 2, pos + 2
    q, kn, vn, kc, vc = attn_inputs(H, T, D, S, device, dt, g)
    dev = q.device
    n_sm = att.sm_count(dev)
    tile = att.lane_groups(D, dt)
    plan = att.split_plan(H, P, D, dt, n_sm)
    part = torch.empty(H * 64 * T * (D + 2), dtype=torch.float32, device=dev)
    tickets = torch.zeros(H, dtype=torch.int32, device=dev)
    out = torch.empty_like(q)

    def args(R, ns):  # on the stream current at the call (a graph captures its own)
        return (1, q.data_ptr(), kn.data_ptr(), vn.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                out.data_ptr(), part.data_ptr(), tickets.data_ptr(), H, T, S, D, pos, R, ns,
                float(D) ** 0.5, torch.cuda.current_stream(dev).cuda_stream)

    res = {}
    for n in sorted({1, -(-n_sm // H), plan[1], 2 * plan[1], att.max_splits(H, n_sm)}):
        R = att._cdiv(att._cdiv(P, n), tile) * tile
        ns = att._cdiv(P, R)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                if att._kernel()(*args(R, ns)) != 0:
                    raise RuntimeError(f"decode attention: launch at R {R} refused")
        res[R, ns] = min(cuda_ms(graph.replay, 10) for _ in range(3)) / reps
        del graph
    host = {}
    for name, call in (("wrapper", lambda: att.decode_attention(q, kn, vn, kc, vc, pos)),
                       ("C entry alone", lambda: att._kernel()(*args(*plan)))):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            call()
        host[name] = 1e6 * (time.perf_counter() - t0) / 2000
        torch.cuda.synchronize()
    log(f"[2] decode attention bf16 {H} heads pos {pos}, device ms a launch (CUDA graph of "
        f"{reps}) by rows a split R and splits (plan R {plan[0]}, {plan[1]} splits): "
        + ", ".join(f"R {R} x {n} ({H * n} blocks) {ms:.4f}" for (R, n), ms in res.items())
        + "; host us a call: " + ", ".join(f"{k} {v:.2f}" for k, v in host.items()))
    return {"splits": res, "host_us": host}


def front_phase_split(stamps, phase_list):
    """Mean times of the front's phases grouped by kind and place (the stem;
    P, Q of each stage and each downsample block; each transition M and
    downsample D) from the kernel's stamps (phases, blocks, 3: entry,
    product start, exit): work, barrier and busy as in `ring_phase_split`;
    of the blocks that own columns, the median time to their product
    (loading and computing the rows) and of the product itself; and each
    group's weight MB a phase."""
    t = stamps.cpu().numpy().astype(np.int64)
    entry, start, exit_ = t[:, :, 0], t[:, :, 1], t[:, :, 2]
    work = (exit_.max(1) - entry.min(1)) / 1e3
    wait = np.append((entry[1:].max(1) - exit_[:-1].max(1)) / 1e3, 0.0)
    busy = np.median(exit_ - entry, axis=1) / 1e3
    owns = start > 0
    rows = np.array([np.median(start[i, o] - entry[i, o]) for i, o in enumerate(owns)]) / 1e3
    prod = np.array([np.median(exit_[i, o] - start[i, o]) for i, o in enumerate(owns)]) / 1e3
    kinds = {}
    for i, p in enumerate(phase_list):
        key = p.kind if p.kind == "stem" else f"{p.kind} {p.where.split('b')[0]}"
        k = kinds.setdefault(key, {"n": 0, "work_us": 0.0, "wait_us": 0.0, "busy_us": 0.0,
                                   "rows_us": 0.0, "product_us": 0.0,
                                   "mb": p.K * p.N * 4 / 1e6})
        k["n"] += 1
        for key_, v in (("work_us", work), ("wait_us", wait), ("busy_us", busy),
                        ("rows_us", rows), ("product_us", prod)):
            k[key_] += float(v[i])
    for k in kinds.values():
        for key in ("work_us", "wait_us", "busy_us", "rows_us", "product_us"):
            k[key] /= k["n"]
    return {"kinds": kinds, "total_us": float(exit_[-1].max() - entry[0].min()) / 1e3,
            "wait_us": float(wait.sum()), "work_us": work.tolist(), "barrier_us": wait.tolist()}


def ring_phase_split(stamps):
    """Mean times of each phase kind (A..E) of the ring step from the
    kernel's stamps (phases, blocks, 2: entry, exit): work from the first
    block's entry to the last block's exit, the barrier after it from that
    exit to the last block's entry into the next phase, and the median
    block's own entry-to-exit time."""
    t = stamps.cpu().numpy().astype(np.int64)
    entry, exit_ = t[:, :, 0], t[:, :, 1]
    work = (exit_.max(1) - entry.min(1)) / 1e3
    wait = np.append((entry[1:].max(1) - exit_[:-1].max(1)) / 1e3, 0.0)
    busy = np.median(exit_ - entry, axis=1) / 1e3
    kinds = {}
    for i in range(len(t)):
        k = kinds.setdefault("ABCDE"[i % 5], {"n": 0, "work_us": 0.0, "wait_us": 0.0,
                                              "busy_us": 0.0})
        k["n"] += 1
        k["work_us"] += float(work[i])
        k["wait_us"] += float(wait[i])
        k["busy_us"] += float(busy[i])
    for k in kinds.values():
        for key in ("work_us", "wait_us", "busy_us"):
            k[key] /= k["n"]
    return {"kinds": kinds, "total_us": float(exit_[-1].max() - entry[0].min()) / 1e3,
            "wait_us": float(wait.sum())}


def phase_split(stamps, L: int):
    """Mean time of each kind of interval of the fast loop from the kernel's
    barrier stamps (points, blocks, 2): work from the first block to leave
    the last barrier to the last block to reach this one, then the barrier
    from that arrival to the last block to leave it.  Kinds: the four phases
    of a layer, the head, A after a step's sampler (layer 0 of steps > 0,
    which also holds the sampler) and the last sampler."""
    t = stamps.cpu().numpy().astype(np.int64)
    arrive, leave = t[:, :, 0], t[:, :, 1]
    work = (arrive[1:].max(1) - leave[:-1].min(1)) / 1e3
    wait = (leave[1:].max(1) - arrive[1:].max(1)) / 1e3
    per_step = 4 * L + 1
    kinds = {}
    for i in range(len(work)):
        if i == len(work) - 1:
            kind = "last sampler"
        elif i % per_step == 4 * L:
            kind = "head"
        elif i % per_step == 0 and i > 0:
            kind = "sampler+A"
        else:
            kind = "ABCD"[i % per_step % 4]
        k = kinds.setdefault(kind, {"n": 0, "work_us": 0.0, "wait_us": 0.0})
        k["n"] += 1
        k["work_us"] += float(work[i])
        k["wait_us"] += float(wait[i])
    for k in kinds.values():
        k["work_us"] /= k["n"]
        k["wait_us"] /= k["n"]
    return {"kinds": kinds, "total_us": float(leave[-1].max() - leave[0].min()) / 1e3,
            "wait_us": float(wait.sum())}


def bound(nbytes_: int, flops: int, peak: float):
    t_bytes = 1e3 * nbytes_ / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / peak
    return {"bound_ms": max(t_bytes, t_ops), "bytes": nbytes_, "flops": flops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "peak": peak}


def wt_layers(wcfg, device, dtype, seed: int = 21):
    """Seeded stacked ring-step layers, with norms and LayerScales away from
    1 and 0.01 so that every term of the step shows in the output."""
    from streamvoiceanon_tpu_torch import params as P

    rng = np.random.default_rng(seed)
    L, d, i = wcfg.n_layer, wcfg.dim, wcfg.intermediate_size
    n = lambda *sh: (rng.standard_normal(sh) / np.sqrt(sh[-2])).astype(np.float32)
    u = lambda lo, hi: rng.uniform(lo, hi, (L, d)).astype(np.float32)
    layers = {"wqkv": {"w": n(L, d, 3 * d)}, "wo": {"w": n(L, d, d)},
              "w1": {"w": n(L, d, i)}, "w3": {"w": n(L, d, i)}, "w2": {"w": n(L, i, d)},
              "attention_norm": {"w": u(0.5, 1.5)}, "ffn_norm": {"w": u(0.5, 1.5)},
              "attn_scale": u(0.1, 0.5), "ffn_scale": u(0.1, 0.5)}
    return P.tree(layers, device, dtype)


def ring_inputs(wcfg, device, dtype, count: int, g):
    """A ring holding `count` written tokens (random rows), and a new row."""
    import torch

    from streamvoiceanon_tpu_torch.ops.wt_stream import maybe_rebase_ring

    L, W, d = wcfg.n_layer, wcfg.window_size, wcfg.dim
    kr, vr = (torch.randn((L, W, d), generator=g, device=device).to(dtype)
              for _ in range(2))
    x = torch.randn((1, d), generator=g, device=device).to(dtype)
    kr = maybe_rebase_ring(kr, count, head_dim=wcfg.head_dim, n_head=wcfg.n_head,
                           rope_base=wcfg.rope_base, table_rows=wcfg.rope_table_rows)
    return x, kr, vr


def compare_ring(wcfg, device, dtype, counts, check: bool):
    """The ring step against its plain version at each count (the ring
    re-based first where due).  Before the middle count the kernel's kept
    scratch (qkv, gate and the attention items' partials) is filled with
    NaN, so that a phase that reads what its call did not write shows up.
    Returns the max abs error over the output row and both whole rings (the
    fresh rows included)."""
    import torch

    from streamvoiceanon_tpu_torch.ops.wt_stream import (
        kept_scratch, wt_stream_step, wt_stream_step_plain)

    layers = wt_layers(wcfg, device, dtype)
    g = torch.Generator(device=device).manual_seed(9)
    kw = dict(n_head=wcfg.n_head, head_dim=wcfg.head_dim, rope_base=wcfg.rope_base,
              norm_eps=wcfg.norm_eps, table_rows=wcfg.rope_table_rows)
    worst = 0.0
    for i, count in enumerate(counts):
        x, kr, vr = ring_inputs(wcfg, device, dtype, count, g)
        if i == len(counts) // 2 and torch.device(device).type == "cuda":
            for t in kept_scratch(wcfg.n_layer, wcfg.dim, wcfg.n_head, wcfg.head_dim,
                                  wcfg.intermediate_size, wcfg.window_size, dtype,
                                  device).values():
                t.fill_(float("nan"))
        ko = wt_stream_step(layers, x, kr.clone(), vr.clone(), count, **kw)
        po = wt_stream_step_plain(layers, x, kr.clone(), vr.clone(), count, **kw)
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(ko, po))
        worst = max(worst, err)
        if check and not err <= TOL:
            raise AssertionError(f"ring step disagrees at count {count}: err {err:.3e}")
    return worst


def head_params(hcfg, device, seed: int = 31):
    """Seeded head weights with random biases, and their packed form."""
    from streamvoiceanon_tpu_torch import params as P
    from streamvoiceanon_tpu_torch.ops.hifigan import packed_weights, stage_channels

    rng = np.random.default_rng(seed)

    def conv(k, ci, co):
        return {"w": (rng.standard_normal((k, ci, co)) * 0.02).astype(np.float32),
                "b": (rng.standard_normal(co) * 0.1).astype(np.float32)}

    chans = stage_channels(hcfg)
    h = {"conv_pre": conv(hcfg.pre_conv_kernel_size, hcfg.num_mels, chans[0][0]),
         "ups": [conv(k, ci, co) for k, (ci, co) in zip(hcfg.upsample_kernel_sizes, chans)],
         "resblocks": [[{"convs1": [conv(rk, co, co) for _ in rd],
                         "convs2": [conv(rk, co, co) for _ in rd]}
                        for rk, rd in zip(hcfg.resblock_kernel_sizes,
                                          hcfg.resblock_dilation_sizes)]
                       for _, co in chans],
         "conv_post": conv(hcfg.post_conv_kernel_size, chans[-1][1], 1)}
    p = P.hifigan_params(h, device)
    return p, packed_weights(p, hcfg)


def front_tree_np(tcfg, seed: int = 41):
    """Seeded tokenizer weights in the JAX package's numpy layout whose
    ConvNeXt front has random biases, norm weights near 1 and LayerScales
    of 0.1 to 0.5, so that every term of every block shows in the output."""
    from streamvoiceanon_tpu_torch.utils import randparams as rp

    rng = np.random.default_rng(seed)

    def walk(x, key):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v, key) for v in x]
        if key == "gamma":
            return rng.uniform(0.1, 0.5, x.shape).astype(np.float32)
        if key == "b":
            return (rng.standard_normal(x.shape) * 0.1).astype(np.float32)
        if x.ndim == 1:  # a norm's weight
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        fan_in = int(np.prod(x.shape[:-1]))
        return (rng.standard_normal(x.shape) / np.sqrt(fan_in)).astype(np.float32)

    tree = rp.tokenizer_params_np(tcfg, seed)
    tree["backbone"] = walk(tree["backbone"], "")
    tree["downsample"] = walk(tree["downsample"], "")
    return tree


def front_state(tcfg, device, g, dtype=None):
    """A packed front state of random tails (padding rows included), in
    `dtype` (float32 unless given), its leaves views of one buffer as every
    state the package makes."""
    import torch

    from streamvoiceanon_tpu_torch.ops.convnext_enc import init_packed_state

    st = init_packed_state(tcfg, 1, dtype or torch.float32, device=device)
    for t in front_leaves(st):
        t.copy_(torch.randn(t.shape, generator=g, device=device))
    return st


def front_leaves(state):
    return [state.stem, *state.stages, state.down]


def front_weights(tcfg, device, dtype=None):
    """The seeded front's packed weights (in `dtype`, float32 unless given)
    and their unit-packed matrices."""
    import torch

    from streamvoiceanon_tpu_torch import params as P
    from streamvoiceanon_tpu_torch.ops.convnext_enc import packed_weights, unit_weights

    tp = P.tokenizer_params(front_tree_np(tcfg), device, dtype or torch.float32)
    pw = packed_weights(tp, tcfg)
    return pw, unit_weights(pw)


# bf16 tolerances of the head and front kernels against their plain
# versions, in bf16 ulps of each output's largest value: both round at the
# same points, but sum in other orders, so a sum may round the other way
# and the one-ulp flip passes on through the later layers (97 convs in the
# head at the published width, where the H100 measured 2.0 ulps; 46
# products and their LayerNorms in the front)
HEAD_BF16_ULPS, FRONT_BF16_ULPS = 4, 4
# The ulp bounds cannot tell a kernel that rounds where the plain version
# rounds from one that leaves the rounding out: a one-ulp flip anywhere
# passes through the LayerNorms and later convs, so both end a few ulps
# away.  Where both sides round at the same points, most values of the
# first rounded outputs still agree bit for bit: `flip_share`, the mean
# share of bf16 values that differ over the head's tails and wave, and over
# the front's first stage of tails (its stem, stem LN and first blocks;
# later stages differ in most values either way).  The control,
# `unrounded`, is the plain version with every activation held in
# float32; it must exceed these bounds, or the check could not see a
# missing rounding.
HEAD_FLIP_SHARE, FRONT_FLIP_SHARE = 0.1, 0.15


def _tmap(fn, x):
    """fn on every tensor of a tree of dicts, lists and (named) tuples."""
    import torch

    if torch.is_tensor(x):
        return fn(x)
    if isinstance(x, dict):
        return {k: _tmap(fn, v) for k, v in x.items()}
    if isinstance(x, list):
        return [_tmap(fn, v) for v in x]
    if isinstance(x, tuple):
        vals = [_tmap(fn, v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def unrounded(plain):
    """The control of the bf16 rounding checks: `plain` (the head's or the
    front's plain step) with the weights' and tails' values in float32, so
    that every activation stays float32; only the new tails and the output
    are rounded to their types, once, at the end of the step."""
    import torch

    def step(pw, state, x, cfg, **_):
        wd = (pw["stem_w"] if "stem_w" in pw else pw["pre_w"]).dtype
        sd = state[0].dtype
        new, y = plain(_tmap(lambda t: t.float(), pw), _tmap(lambda t: t.float(), state), x,
                       cfg)
        return _tmap(lambda t: t.to(sd), new), y.to(wd)

    return step


def flip_share(got, want) -> float:
    """The mean over the leaves of the share of their values whose bf16
    roundings differ."""
    import torch

    shares = [float((a.to(torch.bfloat16) != b.to(torch.bfloat16)).float().mean())
              for a, b in zip(got, want) if a.numel()]
    return sum(shares) / len(shares)


def leaf_err(got, want) -> tuple:
    """(max abs error over the leaves, the largest error in bf16 ulps of its
    leaf's largest magnitude)."""
    import torch

    worst, ulps = 0.0, 0.0
    for a, b in zip(got, want):
        if a.numel() == 0:
            continue
        e = float((a.float() - b.float()).abs().max())
        top = b.float().abs().max().clamp_min(1e-30)
        ulps = max(ulps, e / float(torch.exp2(torch.floor(torch.log2(top)) - 7)))
        worst = max(worst, e)
    return worst, ulps


def compare_front(tcfg, device, chunks: int, check: bool, wd=None, sd=None, kern=None):
    """The fused ConvNeXt front against its plain version over `chunks`
    launches' worth of mel frames (`launch_frames`), weights in `wd` and
    tails in `sd` (float32 unless given), each side carrying its own packed
    state from the same random tails; before the middle chunk the kernel's
    kept scratch (both activation buffers and the hidden rows) is filled
    with NaN, so that a phase that reads what its call did not write shows
    up.  `kern` takes the kernel's place where given (the control).
    Returns (max abs error over z and every packed buffer, the same in bf16
    ulps, the largest `flip_share` of the first stage's tails); float32
    within TOL; bf16 within FRONT_BF16_ULPS, and with bf16 weights within
    FRONT_FLIP_SHARE."""
    import torch

    from streamvoiceanon_tpu_torch.ops.convnext_enc import (
        encoder_front_step, encoder_front_step_plain, kept_scratch, launch_frames)

    wd, sd = wd or torch.float32, sd or torch.float32
    bf16 = torch.bfloat16 in (wd, sd)
    pw, units = front_weights(tcfg, device, wd)
    step = kern or functools.partial(encoder_front_step, units=units)
    g = torch.Generator(device=device).manual_seed(23)
    sk = sp = front_state(tcfg, device, g, sd)
    T = launch_frames(tcfg)
    Tz = T // int(np.prod(tcfg.quantizer.downsample_factor))
    worst = (0.0, 0.0, 0.0)
    for c in range(chunks):
        mel = torch.randn((1, T, tcfg.backbone.input_channels), generator=g, device=device)
        if c == chunks // 2 and torch.device(device).type == "cuda":
            for t in kept_scratch(tcfg, device).values():
                t.fill_(float("nan"))
        sk, zk = step(pw, sk, mel, tcfg)
        sp, zp = encoder_front_step_plain(pw, sp, mel, tcfg)
        if not (torch.isfinite(zk).all() and zk.shape == (1, Tz, tcfg.quantizer.input_dim)
                and zk.dtype == wd and sk.stem.dtype == sd):
            raise AssertionError(f"front chunk {c}: {zk.dtype} {tuple(zk.shape)}, state "
                                 f"{sk.stem.dtype}, or not finite")
        err = (*leaf_err([zk, *front_leaves(sk)], [zp, *front_leaves(sp)]),
               flip_share(sk.stages[:1], sp.stages[:1]))
        worst = tuple(max(a, b) for a, b in zip(worst, err))
        ok = (err[1] <= FRONT_BF16_ULPS and (wd != torch.bfloat16 or err[2] <= FRONT_FLIP_SHARE)
              if bf16 else err[0] <= TOL)
        if check and not ok:
            raise AssertionError(f"front ({wd}, {sd}) disagrees at chunk {c}: err "
                                 f"{err[0]:.3e} ({err[1]:.2f} bf16 ulps, flip share "
                                 f"{err[2]:.3f})")
    return worst


def attn_inputs(H: int, T: int, D: int, S: int, device, dtype, g):
    import torch

    r = lambda *s: torch.randn(s, generator=g, device=device).to(dtype)
    return r(H, T, D), r(H, T, D), r(H, T, D), r(H, S, D), r(H, S, D)


def attn_positions(H: int, T: int, D: int, S: int, dtype, n_sm: int):
    """0, 1, positions at the kernel's split edges (the rows end at a
    split's last or first row, or the new rows straddle two splits) near
    the start and near 1000, 1000 and S - T (those that fit S rows)."""
    from streamvoiceanon_tpu_torch.ops.attention import split_plan

    def edges(start, n):
        out = []
        for pos in range(start, S - T + 1):
            R, _ = split_plan(H, pos + T, D, dtype, n_sm)
            if (pos + T) % R in (0, 1) or (T == 2 and pos % R == R - 1):
                out.append(pos)
                if len(out) == n:
                    break
        return out

    near = {0, 1, *edges(2, 3), *edges(1000, 2), 1000, S - T}
    return sorted(p for p in near if p <= S - T)


def bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    import torch

    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def compare_attention(H: int, T: int, D: int, S: int, device, dtype, positions,
                      check: bool):
    """The decode attention against its plain version at each position:
    max abs error over the output and both whole caches.  Rows >= pos + T
    poisoned with NaN must leave the kernel's output finite and unchanged,
    and before the middle position the kernel's kept partials are filled
    with NaN (both checked at every type).  With `check`: the caches equal,
    the output within ATTN_TOL (float32) or one bf16 ulp of the larger of
    the two plus ATTN_TOL (bf16; see ops/attention.py)."""
    import torch

    from streamvoiceanon_tpu_torch.ops import attention as att

    g = torch.Generator(device=device).manual_seed(29)
    worst = 0.0
    for i, pos in enumerate(positions):
        q, kn, vn, kc, vc = attn_inputs(H, T, D, S, device, dtype, g)
        if i == len(positions) // 2 and torch.device(device).type == "cuda":
            dev = torch.device(device)
            att.kept_scratch(H, T, D, dtype, dev, att.sm_count(dev))[0].fill_(float("nan"))
        ko = att.decode_attention(q, kn, vn, kc.clone(), vc.clone(), pos)
        po = att.decode_attention_plain(q, kn, vn, kc.clone(), vc.clone(), pos)
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(ko, po))
        kp, vp = kc.clone(), vc.clone()
        kp[:, pos + T :], vp[:, pos + T :] = float("nan"), float("nan")
        poisoned = att.decode_attention(q, kn, vn, kp, vp, pos)[0]
        if not (torch.isfinite(poisoned).all() and torch.equal(poisoned, ko[0])):
            raise AssertionError(f"decode attention at {H} heads, pos {pos} read a stale "
                                 "row")
        worst = max(worst, err)
        if not check:
            continue
        a, b = ko[0].float(), po[0].float()
        room = ATTN_TOL + (bf16_ulp(torch.maximum(a.abs(), b.abs()))
                           if dtype == torch.bfloat16 else 0.0)
        if not (torch.equal(ko[1], po[1]) and torch.equal(ko[2], po[2])
                and bool(((a - b).abs() <= room).all())):
            raise AssertionError(f"decode attention disagrees at {H} heads, pos {pos} "
                                 f"({dtype}): err {err:.3e}")
    return worst


def front_flops(tcfg, T0: int) -> int:
    """Multiply-adds x 2 of one front step on T0 mel frames."""
    bb, q = tcfg.backbone, tcfg.quantizer
    k = bb.kernel_size
    blk = lambda T, c: T * (k * c + 8 * c * c)
    f = T0 * k * bb.input_channels * bb.dims[0]
    f += sum(T0 * a * b for a, b in zip(bb.dims, bb.dims[1:]))
    f += sum(d * blk(T0, c) for d, c in zip(bb.depths, bb.dims))
    T, c = T0, bb.dims[-1]
    for fac in q.downsample_factor:
        T //= fac
        f += T * fac * c * q.input_dim + blk(T, q.input_dim)
        c = q.input_dim
    return 2 * f


def attn_bound(H: int, T: int, D: int, pos: int, es: int):
    """The decode attention's bound: q and the new rows read, the output
    written, the old rows < pos of both caches read, the new rows written;
    float32 products and sums."""
    nbytes_ = 4 * H * T * D * es + 2 * H * pos * D * es + 2 * H * T * D * es
    return bound(nbytes_, 2 * 2 * H * T * (pos + T) * D, FP32_FLOPS)


def time_attention(dcfg, device, batches, positions):
    """The decode attention at each batch (B x the dual-AR's heads, bf16
    cache of its rows) and pos: kernel and plain times (turns plain,
    kernel, kernel, plain), the time of `F.scaled_dot_product_attention`
    over the valid rows after the two row copies, and the bound."""
    import torch
    import torch.nn.functional as F

    from streamvoiceanon_tpu_torch.ops.attention import (
        decode_attention, decode_attention_plain)

    g = torch.Generator(device=device).manual_seed(31)
    D, S, T = dcfg.head_dim, dcfg.max_seq_len, 2
    out = {}
    for B in batches:
        H = B * dcfg.n_head
        q, kn, vn, kc, vc = attn_inputs(H, T, D, S, device, torch.bfloat16, g)
        for pos in positions:
            P_ = pos + T
            mask = (torch.arange(P_, device=device)[None, :]
                    <= (pos + torch.arange(T, device=device))[:, None])

            def library():
                kc[:, pos:P_] = kn
                vc[:, pos:P_] = vn
                return F.scaled_dot_product_attention(q, kc[:, :P_], vc[:, :P_],
                                                      attn_mask=mask)

            kern = lambda: decode_attention(q, kn, vn, kc, vc, pos)
            plain = lambda: decode_attention_plain(q, kn, vn, kc, vc, pos)
            p1 = cuda_ms(plain, 5)
            k1 = cuda_ms(kern, 30)
            k2 = cuda_ms(kern, 30)
            p2 = cuda_ms(plain, 5)
            out[B, pos] = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "ms_runs": [k1, k2],
                           "plain_runs": [p1, p2],
                           "library_ms": min(cuda_ms(library, 30), cuda_ms(library, 30)),
                           **attn_bound(H, T, D, pos, 2)}
        del q, kn, vn, kc, vc
    return out


def time_front_attention(tcfg, dcfg, device):
    """Kernel, plain and bound times of the front (float32, T0 = 4, as on
    the main path), and the decode attention's at ATTN_TIME_BATCHES x
    ATTN_TIME_POS (`time_attention`)."""
    import torch

    from streamvoiceanon_tpu_torch.ops.convnext_enc import (
        encoder_front_step, encoder_front_step_plain)

    pw, units = front_weights(tcfg, device)
    g = torch.Generator(device=device).manual_seed(31)
    st = front_state(tcfg, device, g)
    mel = torch.randn((1, 4, tcfg.backbone.input_channels), generator=g, device=device)
    kern = lambda: encoder_front_step(pw, st, mel, tcfg, units=units)
    plain = lambda: encoder_front_step_plain(pw, st, mel, tcfg)
    p1 = cuda_ms(plain, 5)
    k1 = cuda_ms(kern, 30)
    k2 = cuda_ms(kern, 30)
    p2 = cuda_ms(plain, 5)
    out = {"enc": {"ms": min(k1, k2), "plain_ms": min(p1, p2), "ms_runs": [k1, k2],
                   "plain_runs": [p1, p2]}}
    # front: every packed weight once, the state in and out, mel and z
    w = [t for k_, t in pw.items() if torch.is_tensor(t)]
    for grp in (pw["stages"], pw["mids"], pw["downs"]):
        for d in grp:
            for v in d.values():
                w += list(v.values()) if isinstance(v, dict) else [v]
    front_bytes = (nbytes(*w) + 2 * nbytes(*front_leaves(st)) + nbytes(mel)
                   + tcfg.quantizer.input_dim * 4)
    out["enc"].update(bound(front_bytes, front_flops(tcfg, 4), FP32_FLOPS))
    out["attn_grid"] = time_attention(dcfg, device, ATTN_TIME_BATCHES, ATTN_TIME_POS)
    out["attn"] = out["attn_grid"][1, 1000]
    return out


def head_leaves(state):
    return [state.pre, *state.ups, *state.res, state.post]


def compare_head(hcfg, device, chunks: int, check: bool, wd=None, sd=None, kern=None):
    """The fused head against its plain version over `chunks` chunks,
    weights in `wd` and tails in `sd` (float32 unless given), each side
    carrying its own state; before the middle chunk the kernel's kept
    scratch (activations and split partials) is filled with NaN, so that a
    launch that reads what no earlier launch of its call wrote shows up.
    `kern` takes the kernel's place where given (the control).  Returns
    (max abs error over the waveforms and every packed tail, the same in
    bf16 ulps, the largest `flip_share` of the tails and the wave); float32
    within TOL; bf16 within HEAD_BF16_ULPS, and with bf16 weights within
    HEAD_FLIP_SHARE."""
    import torch

    from streamvoiceanon_tpu_torch.ops.hifigan import (
        head_stream_step, head_stream_step_plain, init_packed_state, kept_scratch)

    wd, sd = wd or torch.float32, sd or torch.float32
    bf16 = torch.bfloat16 in (wd, sd)
    _, pw = head_params(hcfg, device)
    pw = {k: [{n: t.to(wd) for n, t in s_.items()} for s_ in v] if k == "stages"
          else v.to(wd) for k, v in pw.items()}
    g = torch.Generator(device=device).manual_seed(13)
    sk = sp = init_packed_state(hcfg, 1, sd, device=device)
    step = kern or head_stream_step
    worst = (0.0, 0.0, 0.0)
    for c in range(chunks):
        x = torch.randn((1, 4, hcfg.num_mels), generator=g, device=device)
        if c == chunks // 2:
            scratch, floats = kept_scratch(hcfg, 4, device)
            scratch[:floats] = float("nan")
        sk, wk = step(pw, sk, x, hcfg)
        sp, wp = head_stream_step_plain(pw, sp, x, hcfg)
        got, want = [wk, *head_leaves(sk)], [wp, *head_leaves(sp)]
        err = (*leaf_err(got, want), flip_share(got, want))
        if not (torch.isfinite(wk).all() and wk.dtype == wd and sk.pre.dtype == sd
                and wk.shape == (1, 4 * int(np.prod(hcfg.upsample_rates)))):
            raise AssertionError(f"head chunk {c}: {wk.dtype} {tuple(wk.shape)}, state "
                                 f"{sk.pre.dtype}, or not finite")
        worst = tuple(max(a, b) for a, b in zip(worst, err))
        ok = (err[1] <= HEAD_BF16_ULPS and (wd != torch.bfloat16 or err[2] <= HEAD_FLIP_SHARE)
              if bf16 else err[0] <= TOL)
        if check and not ok:
            raise AssertionError(f"head ({wd}, {sd}) disagrees at chunk {c}: err "
                                 f"{err[0]:.3e} ({err[1]:.2f} bf16 ulps, flip share "
                                 f"{err[2]:.3f})")
    return worst


def time_ring_head(wcfg, hcfg, device, count: int):
    """float32 (the main path's type): kernel and plain times and bounds of
    the ring step at `count` and of the head at T0 = 4."""
    import torch

    from streamvoiceanon_tpu_torch.ops.hifigan import (
        head_stream_step, head_stream_step_plain, init_packed_state)
    from streamvoiceanon_tpu_torch.ops.wt_stream import wt_stream_step, wt_stream_step_plain

    dt = torch.float32
    layers = wt_layers(wcfg, device, dt)
    g = torch.Generator(device=device).manual_seed(17)
    x, kr, vr = ring_inputs(wcfg, device, dt, count, g)
    rkw = dict(n_head=wcfg.n_head, head_dim=wcfg.head_dim, rope_base=wcfg.rope_base,
               norm_eps=wcfg.norm_eps, table_rows=wcfg.rope_table_rows)
    _, pw = head_params(hcfg, device)
    st = init_packed_state(hcfg, 1, device=device)
    xh = torch.randn((1, 4, hcfg.num_mels), generator=g, device=device)
    out = {}
    for name, kern, plain, n in (
            ("ring", lambda: wt_stream_step(layers, x, kr, vr, count, **rkw),
             lambda: wt_stream_step_plain(layers, x, kr, vr, count, **rkw), 30),
            ("head", lambda: head_stream_step(pw, st, xh, hcfg),
             lambda: head_stream_step_plain(pw, st, xh, hcfg), 30)):
        p1 = cuda_ms(plain, 5)
        k1 = cuda_ms(kern, n)
        k2 = cuda_ms(kern, n)
        p2 = cuda_ms(plain, 5)
        out[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "ms_runs": [k1, k2],
                     "plain_runs": [p1, p2]}
    # ring: each weight byte once, the valid old rows of both rings, the
    # fresh rows written, the row in and out, the RoPE row
    L, W, d = wcfg.n_layer, wcfg.window_size, wcfg.dim
    nv = min(count, W) - (1 if count >= W else 0)
    mats = sum(layers[k]["w"].numel() for k in ("wqkv", "wo", "w1", "w3", "w2"))
    ring_bytes = (nbytes(*(layers[k]["w"] for k in ("wqkv", "wo", "w1", "w3", "w2",
                                                     "attention_norm", "ffn_norm")),
                         layers["attn_scale"], layers["ffn_scale"])
                  + 2 * L * nv * d * 4 + 2 * L * d * 4 + 2 * d * 4 + 2 * d * 4)
    ring_flops = 2 * mats + 4 * L * (nv + 1) * d
    out["ring"].update(bound(ring_bytes, ring_flops, FP32_FLOPS))
    # head: every packed weight once, the state in and out, x and the wave
    w = [pw["pre_w"], pw["pre_b"], pw["post_w"], pw["post_b"]]
    for s_ in pw["stages"]:
        w += list(s_.values())
    head_bytes = (nbytes(*w) + 2 * nbytes(*head_leaves(st)) + nbytes(xh)
                  + 4 * 4 * int(np.prod(hcfg.upsample_rates)))
    out["head"].update(bound(head_bytes, head_flops(hcfg, 4), FP32_FLOPS))
    return out


def wider_fronts(tcfg):
    """Front geometries the kernel takes since its rows follow the plan:
    rows wider than its 512 threads (dims 192 .. 1024, C_q 1024) and a
    downsample product of 8 (one launch takes 8 frames)."""
    from streamvoiceanon_tpu_torch import config as C

    return {"wide": C.replace(tcfg, backbone=C.replace(tcfg.backbone,
                                                       dims=(192, 384, 768, 1024)),
                              quantizer=C.replace(tcfg.quantizer, input_dim=1024)),
            "down8": C.replace(tcfg, quantizer=C.replace(tcfg.quantizer,
                                                         downsample_factor=(2, 2, 2)))}


def time_dsp(hcfg, tcfg, device):
    """The head (T0 = 4) and the front (a launch's frames) with weights and
    tails in float32 and in bf16, kernels alternated in one loop (f32, bf16,
    bf16, f32): ms and the bound at each type's bytes and peak rate; the
    front also at the wider geometries in float32."""
    import torch

    from streamvoiceanon_tpu_torch.ops.convnext_enc import encoder_front_step, launch_frames
    from streamvoiceanon_tpu_torch.ops.hifigan import head_stream_step, init_packed_state

    f32, b16 = torch.float32, torch.bfloat16
    peak = {f32: FP32_FLOPS, b16: BF16_FLOPS}  # by the operands' type
    g = torch.Generator(device=device).manual_seed(37)
    _, hp = head_params(hcfg, device)
    xh = torch.randn((1, 4, hcfg.num_mels), generator=g, device=device)
    calls, bounds = {}, {}
    for dt in (f32, b16):
        pw = {k: [{n: t.to(dt) for n, t in s_.items()} for s_ in v] if k == "stages"
              else v.to(dt) for k, v in hp.items()}
        st = init_packed_state(hcfg, 1, dt, device=device)
        calls[("head", dt)] = functools.partial(head_stream_step, pw, st, xh, hcfg)
        w = [pw["pre_w"], pw["pre_b"], pw["post_w"], pw["post_b"]]
        for s_ in pw["stages"]:
            w += list(s_.values())
        nb = (nbytes(*w) + 2 * nbytes(*head_leaves(st)) + nbytes(xh)
              + 4 * int(np.prod(hcfg.upsample_rates)) * torch.empty((), dtype=dt).itemsize)
        bounds[("head", dt)] = bound(nb, head_flops(hcfg, 4), peak[dt])
    fronts = {"enc": tcfg, **{f"enc_{k}": v for k, v in wider_fronts(tcfg).items()}}
    for key, tc in fronts.items():
        for dt in ((f32, b16) if key == "enc" else (f32,)):
            pw, units = front_weights(tc, device, dt)
            st = front_state(tc, device, g, dt)
            T = launch_frames(tc)
            mel = torch.randn((1, T, tc.backbone.input_channels), generator=g, device=device)
            calls[(key, dt)] = functools.partial(encoder_front_step, pw, st, mel, tc,
                                                 units=units)
            w = [t for k_, t in pw.items() if torch.is_tensor(t)]
            for grp in (pw["stages"], pw["mids"], pw["downs"]):
                for d_ in grp:
                    for v in d_.values():
                        w += list(v.values()) if isinstance(v, dict) else [v]
            zb = T // int(np.prod(tc.quantizer.downsample_factor)) * tc.quantizer.input_dim
            nb = (nbytes(*w) + 2 * nbytes(*front_leaves(st)) + nbytes(mel)
                  + zb * torch.empty((), dtype=dt).itemsize)
            bounds[(key, dt)] = bound(nb, front_flops(tc, T), peak[dt])
    runs = {k: [] for k in calls}
    for order in ((f32, b16), (b16, f32)):
        for key in ("head", *fronts):
            for dt in order:
                if (key, dt) in calls:
                    runs[(key, dt)].append(cuda_ms(calls[(key, dt)], 30))
    return {k: {"ms": min(v), "ms_runs": v, **bounds[k]} for k, v in runs.items()}


def synthetic_voice(seconds: float, f0: float, seed: int) -> np.ndarray:
    """Seeded synthetic speech-like audio at 44.1 kHz: five harmonics of a
    slowly gliding f0 under a syllable-rate envelope, plus noise."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 44100)
    t = np.arange(n) / 44100.0
    f = f0 * (1.0 + 0.1 * np.sin(2 * np.pi * 0.7 * t))
    phase = 2 * np.pi * np.cumsum(f) / 44100.0
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t + rng.uniform(0, 6.28)) ** 2
    wav = sum(np.sin(h * phase + rng.uniform(0, 6.28)) / h for h in range(1, 6))
    return (0.1 * env * wav + 0.005 * rng.standard_normal(n)).astype(np.float32)


# ---------------------------------------------------------------------------
# Phase 8's checkpoints: the JAX-layout numpy trees written back into the
# reference's state_dict layout, the inverse of runtime/convert.py and the
# `convert` functions of models/campplus.py and models/speaker_encoder.py
# ---------------------------------------------------------------------------


class _StateDict(dict):
    """A state_dict under construction: the layer writers of `state_dicts`."""

    def conv(self, prefix, p, weight_norm=False, transpose=False):
        """Conv1d (k, in/g, out) -> (out, in/g, k); ConvTranspose1d (k, in,
        out) -> (in, out, k).  With `weight_norm` as the parametrization's
        original0 (the dim-0 norm) and original1 (the direction)."""
        w = np.transpose(np.asarray(p["w"]), (1, 2, 0) if transpose else (2, 1, 0))
        if weight_norm:
            g = np.sqrt(np.sum(w * w, axis=tuple(range(1, w.ndim)), keepdims=True))
            self[f"{prefix}.parametrizations.weight.original0"] = g
            self[f"{prefix}.parametrizations.weight.original1"] = w
        else:
            self[f"{prefix}.weight"] = w
        if "b" in p:
            self[f"{prefix}.bias"] = p["b"]

    def linear(self, prefix, p):
        self[f"{prefix}.weight"] = np.transpose(np.asarray(p["w"]))
        if "b" in p:
            self[f"{prefix}.bias"] = p["b"]

    def norm(self, prefix, p):
        self[f"{prefix}.weight"] = p["w"]
        if "b" in p:
            self[f"{prefix}.bias"] = p["b"]

    def bn(self, prefix, p):
        self[f"{prefix}.running_mean"] = p["mean"]
        self[f"{prefix}.running_var"] = p["var"]
        self[f"{prefix}.num_batches_tracked"] = np.asarray(7, np.int64)  # ignored
        if "w" in p:
            self[f"{prefix}.weight"] = p["w"]
            self[f"{prefix}.bias"] = p["b"]

    def block(self, prefix, p):  # ConvNeXt block
        self.conv(f"{prefix}.dwconv.conv", p["dwconv"])
        self.norm(f"{prefix}.norm", p["norm"])
        self.linear(f"{prefix}.pwconv1", p["pwconv1"])
        self.linear(f"{prefix}.pwconv2", p["pwconv2"])
        if p.get("gamma") is not None:
            self[f"{prefix}.gamma"] = p["gamma"]

    def encoder(self, prefix, p):  # ConvNeXt encoder
        self.conv(f"{prefix}.downsample_layers.0.0.conv", p["stem_conv"])
        self.norm(f"{prefix}.downsample_layers.0.1", p["stem_norm"])
        self.norm(f"{prefix}.norm", p["final_norm"])
        n = sum(1 for k in p if k.startswith("stage_"))
        for i in range(n - 1):
            self.norm(f"{prefix}.downsample_layers.{i + 1}.0", p[f"mid_norm_{i}"])
            self.conv(f"{prefix}.downsample_layers.{i + 1}.1", p[f"mid_conv_{i}"])
        for i in range(n):
            for j, b in enumerate(p[f"stage_{i}"]):
                self.block(f"{prefix}.stages.{i}.{j}", b)
        if "g_in" in p:
            self.conv(f"{prefix}.g_in", p["g_in"])

    def stages(self, prefix, stages, transpose=False):  # quantizer down/upsample
        for i, st in enumerate(stages):
            self.conv(f"{prefix}.{i}.0.conv", st["conv"], transpose=transpose)
            self.block(f"{prefix}.{i}.1", st["block"])

    def wt(self, prefix, p):  # windowed transformer, layer lists
        for i, lp in enumerate(p["layers"]):
            q = f"{prefix}.layers.{i}"
            self.linear(f"{q}.attention.wqkv", lp["wqkv"])
            self.linear(f"{q}.attention.wo", lp["wo"])
            self.norm(f"{q}.attention_norm", lp["attention_norm"])
            self.norm(f"{q}.ffn_norm", lp["ffn_norm"])
            for w in ("w1", "w2", "w3"):
                self.linear(f"{q}.feed_forward.{w}", lp[w])
            self[f"{q}.attention_layer_scale.gamma"] = lp["attn_scale"]
            self[f"{q}.ffn_layer_scale.gamma"] = lp["ffn_scale"]
        self.norm(f"{prefix}.norm", p["final_norm"])

    def lm_block(self, prefix, lp):
        self.linear(f"{prefix}.attention.wqkv", lp["wqkv"])
        self.linear(f"{prefix}.attention.wo", lp["wo"])
        self.norm(f"{prefix}.attention_norm", lp["attention_norm"])
        self.norm(f"{prefix}.ffn_norm", lp["ffn_norm"])
        for w in ("w1", "w2", "w3"):
            self.linear(f"{prefix}.feed_forward.{w}", lp[w])


def _unstack(tree, i):
    return {k: _unstack(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def state_dicts(trees, weight_norm: bool = False):
    """Reference-layout state_dicts (numpy arrays by key) of the JAX-layout
    numpy trees `trees` (`tokenizer`, `vocoder`, `arvc` with stacked layers
    as `utils/randparams` draws them, `campplus`, `speaker`; any subset):
    the keys and layouts that the reference modules' state_dicts hold, so
    that `runtime/convert.py` consumes every key and gives the trees back.
    With `weight_norm` the HiFiGAN head's convs are weight-norm
    parametrizations (resolved by the converters within rounding)."""
    out = {}
    if "tokenizer" in trees:
        t, sd = trees["tokenizer"], _StateDict()
        sd.encoder("backbone", t["backbone"])
        sd.stages("quantizer.downsample", t["downsample"])
        sd.wt("quantizer.pre_module", t["pre_module"])
        sd.wt("quantizer.post_module", t["post_module"])
        for name in ("project_in", "project_out"):
            sd.linear(f"quantizer.residual_bsq.rvqs.0.{name}", t["lfq"][name])
        # the BSQ bit-weight constant, derived from codebook_bits by the port
        sd["quantizer.residual_bsq.rvqs.0.mask"] = 2 ** np.arange(
            t["lfq"]["project_in"]["w"].shape[1])
        out["tokenizer"] = dict(sd)
    if "vocoder" in trees:
        v, sd = trees["vocoder"], _StateDict()
        sd.encoder("backbone", v["backbone"])
        h = v["head"]
        sd.conv("head.conv_pre.conv", h["conv_pre"], weight_norm)
        sd.conv("head.conv_post.conv", h["conv_post"], weight_norm)
        for i, (up, rbs) in enumerate(zip(h["ups"], h["resblocks"])):
            sd.conv(f"head.ups.{i}.conv", up, weight_norm, transpose=True)
            for j, rb in enumerate(rbs):
                for name in ("convs1", "convs2"):
                    for k, c in enumerate(rb[name]):
                        sd.conv(f"head.resblocks.{i}.blocks.{j}.{name}.{k}.conv", c,
                                weight_norm)
        sd.stages("quantizer.downsample", v["downsample"])
        sd.stages("quantizer.upsample", v["upsample"], transpose=True)
        for g, gp in v["fsq"].items():
            for name, lp in gp.items():
                sd.linear(f"quantizer.residual_fsq.rvqs.{g.split('_')[1]}.{name}", lp)
        out["vocoder"] = dict(sd)
    if "arvc" in trees:
        a, sd = trees["arvc"], _StateDict()
        m = a["model"]
        sd["embedding.weight"] = a["embedding"]
        sd.linear("context_in", a["context_in"])
        sd.linear("style_in", a["style_in"])
        d = "decoder.model"
        for name in ("embeddings", "codebook_embeddings", "fast_embeddings"):
            sd[f"{d}.{name}.weight"] = m[name]
        for stack, n in (("layers", m["layers"]["wqkv"]["w"].shape[0]),
                         ("fast_layers", m["fast_layers"]["wqkv"]["w"].shape[0])):
            for i in range(n):
                sd.lm_block(f"{d}.{stack}.{i}", _unstack(m[stack], i))
        sd.norm(f"{d}.norm", m["norm"])
        sd.norm(f"{d}.fast_norm", m["fast_norm"])
        for name in ("fast_output", "output", "fast_project_in"):
            if name in m:
                sd.linear(f"{d}.{name}", m[name])
        sd["decoder.wait4start_embedding.weight"] = a["wait4start"]
        sd["decoder.wait4end_embedding.weight"] = a["wait4end"]
        sd["decoder.model.freqs_cis"] = np.zeros((4, 2), np.float32)  # a rebuilt buffer
        out["arvc"] = dict(sd)
    if "campplus" in trees:
        c, sd = trees["campplus"], _StateDict()
        conv2d = lambda w: np.transpose(np.asarray(w), (3, 2, 0, 1))  # noqa: E731
        conv1d = lambda w: np.transpose(np.asarray(w), (2, 1, 0))  # noqa: E731
        f = c["fcm"]
        for name in ("conv1", "conv2"):
            sd[f"head.{name}.weight"] = conv2d(f[name])
        sd.bn("head.bn1", f["bn1"])
        sd.bn("head.bn2", f["bn2"])
        for layer in ("layer1", "layer2"):
            for i, rb in enumerate(f[layer]):
                q = f"head.{layer}.{i}"
                sd[f"{q}.conv1.weight"] = conv2d(rb["conv1"])
                sd[f"{q}.conv2.weight"] = conv2d(rb["conv2"])
                sd.bn(f"{q}.bn1", rb["bn1"])
                sd.bn(f"{q}.bn2", rb["bn2"])
                if "shortcut_conv" in rb:
                    sd[f"{q}.shortcut.0.weight"] = conv2d(rb["shortcut_conv"])
                    sd.bn(f"{q}.shortcut.1", rb["shortcut_bn"])
        sd["xvector.tdnn.linear.weight"] = conv1d(c["tdnn_conv"])
        sd.bn("xvector.tdnn.nonlinear.batchnorm", c["tdnn_bn"])
        sd.bn("xvector.out_nonlinear.batchnorm", c["out_bn"])
        # the reference nests the pooling's dense layer under xvector.
        sd["xvector.dense.linear.weight"] = conv1d(c["dense_w"])
        sd.bn("xvector.dense.nonlinear.batchnorm", c["dense_bn"])
        b = 1
        while f"block{b}" in c:
            for li, lp in enumerate(c[f"block{b}"]):
                q = f"xvector.block{b}.tdnnd{li + 1}"
                sd.bn(f"{q}.nonlinear1.batchnorm", lp["nl1"])
                sd[f"{q}.linear1.weight"] = conv1d(lp["lin1_w"])
                sd.bn(f"{q}.nonlinear2.batchnorm", lp["nl2"])
                cam = lp["cam"]
                sd[f"{q}.cam_layer.linear_local.weight"] = conv1d(cam["local_w"])
                for n in ("1", "2"):
                    sd[f"{q}.cam_layer.linear{n}.weight"] = conv1d(
                        np.asarray(cam[f"fc{n}_w"])[None])
                    sd[f"{q}.cam_layer.linear{n}.bias"] = cam[f"fc{n}_b"]
            sd.bn(f"xvector.transit{b}.nonlinear.batchnorm", c[f"transit{b}"]["bn"])
            sd[f"xvector.transit{b}.linear.weight"] = conv1d(c[f"transit{b}"]["w"])
            b += 1
        out["campplus"] = dict(sd)
    if "speaker" in trees:
        s_, sd = trees["speaker"], _StateDict()
        e = "speaker_encoder"
        conv = lambda prefix, w, b: sd.conv(prefix, {"w": w, "b": b})  # noqa: E731
        ec = s_["ecapa"]
        conv(f"{e}.layer1.conv", ec["layer1_w"], ec["layer1_b"])
        sd.bn(f"{e}.layer1.bn", ec["layer1_bn"])
        for layer in ("layer2", "layer3", "layer4"):
            r, q = ec[layer], f"{e}.{layer}.se_res2block"
            conv(f"{q}.0.conv", r["conv1_w"], r["conv1_b"])
            sd.bn(f"{q}.0.bn", r["bn1"])
            conv(f"{q}.2.conv", r["conv2_w"], r["conv2_b"])
            sd.bn(f"{q}.2.bn", r["bn2"])
            sd.linear(f"{q}.3.linear1", {"w": r["se1_w"], "b": r["se1_b"]})
            sd.linear(f"{q}.3.linear2", {"w": r["se2_w"], "b": r["se2_b"]})
            for i, rr in enumerate(r["res2"]):
                conv(f"{q}.1.convs.{i}", rr["w"], rr["b"])
                sd.bn(f"{q}.1.bns.{i}", rr["bn"])
        conv(f"{e}.conv", ec["conv_w"], ec["conv_b"])
        pv, pp = "perceiver_sampler", s_["perceiver"]
        sd.linear(f"{pv}.proj_context", {"w": pp["proj_w"], "b": pp["proj_b"]})
        sd[f"{pv}.latents"] = pp["latents"]
        sd[f"{pv}.norm.gamma"] = pp["norm"]["gamma"]
        for i, lp in enumerate(pp["layers"]):
            for name in ("to_q", "to_kv", "to_out"):
                sd.linear(f"{pv}.layers.{i}.0.{name}", {"w": lp[name]})
            sd.linear(f"{pv}.layers.{i}.1.0", {"w": lp["ff1_w"], "b": lp["ff1_b"]})
            sd.linear(f"{pv}.layers.{i}.1.2", {"w": lp["ff2_w"], "b": lp["ff2_b"]})
        for name, lp in s_["fsq"].items():
            sd.linear(f"quantizer.{name}", lp)
        xv = s_["xvec"]
        conv(f"{e}.pool.linear1", xv["pool_lin1_w"], xv["pool_lin1_b"])
        conv(f"{e}.pool.linear2", xv["pool_lin2_w"], xv["pool_lin2_b"])
        sd.bn(f"{e}.bn", xv["bn"])
        sd.linear(f"{e}.linear", {"w": xv["lin_w"], "b": xv["lin_b"]})
        if "bn2" in xv:
            sd.bn(f"{e}.bn2", xv["bn2"])
        out["speaker"] = dict(sd)
    return out


def write_checkpoints(ckpt_dir, sds) -> None:
    """`state_dicts`'s output as the five published files of
    `cli.CHECKPOINTS` (torch tensors): the vocoder's under a `net` key and
    the ARVC's keys with DataParallel's `module.` prefix, as the converter's
    loader accepts both."""
    import torch

    from streamvoiceanon_tpu_torch.cli import CHECKPOINTS

    for part, sd in sds.items():
        t = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
        if part == "vocoder":
            t = {"net": t}
        elif part == "arvc":
            t = {f"module.{k}": v for k, v in t.items()}
        torch.save(t, str(Path(ckpt_dir) / CHECKPOINTS[part]))


def prompt_side(cv, device, scfg, wrappers):
    """Phase 5: the prompt side at full width on `cv`'s weights plus seeded
    random CAM++ and speaker-encoder weights (their default configs): a 10 s
    synthetic reference's speaker embeddings, content tokens and codes
    (each timed after one warm-up call), then `StreamSession(cv, scfg,
    ref_wavs=[ref])` under tpu_optimized for 40 chunks with drive()'s
    launch check in float32 state, and again at the JAX package's serving
    point (bf16 tokenizer and vocoder weights, bf16 state), then
    `VoiceConverter.infer` of a 4 s source, greedy, delay 2: one fast-loop
    launch a generated frame and one slow-step launch a frame after the
    first (whose codes come from the prompt's last hidden)."""
    import dataclasses

    import torch

    from streamvoiceanon_tpu_torch import config as C
    from streamvoiceanon_tpu_torch import params as P
    from streamvoiceanon_tpu_torch.runtime.pipeline import VoiceConverter
    from streamvoiceanon_tpu_torch.runtime.streaming import StreamSession
    from streamvoiceanon_tpu_torch.utils import randparams as rp

    cfg = cv.cfg
    vc = VoiceConverter(dataclasses.replace(
        cv, campplus_params=P.campplus_params(rp.campplus_params_np(cfg.campplus, 5), device),
        speaker_params=P.speaker_params(rp.speaker_encoder_params_np(cfg.speaker, 6), device)))
    ref = synthetic_voice(10.0, 150.0, 51)
    sync = torch.cuda.synchronize

    def timed(fn):
        fn()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, 1e3 * (time.perf_counter() - t0)

    (style, timbre), spk_ms = timed(lambda: vc.speaker_embeddings([ref], scfg.alpha))
    toks, tok_ms = timed(lambda: vc.content_tokens(ref[None]))
    codes, code_ms = timed(lambda: vc.audio_codes(ref[None]))
    n_frames = len(ref) // SPF
    for name, x, shape in (("style", style, (1, cfg.campplus.embedding_size)),
                           ("timbre", timbre, (1, cfg.speaker.token_num,
                                               cfg.speaker.latent_dim)),
                           ("tokens", toks, (1, n_frames)),
                           ("codes", codes, (1, cfg.arvc.decoder.num_codebooks, n_frames))):
        if tuple(x.shape) != shape or not torch.isfinite(x.float()).all():
            raise AssertionError(f"prompt side: {name} {tuple(x.shape)}, expected {shape}, "
                                 "or not finite")
    out = {"spk_ms": spk_ms, "tok_ms": tok_ms, "code_ms": code_ms}
    log(f"[5] prompt side, 10 s reference at 44.1 kHz: speaker embeddings (resample, "
        f"fbank, CAM++, speaker encoder) {spk_ms:.2f} ms, content tokens {tok_ms:.2f} ms, "
        f"codes {code_ms:.2f} ms (each after one warm-up call); {n_frames} frames, "
        f"{len(np.unique(toks.cpu().numpy()))} distinct tokens")
    packed = ("enc_packed", "enc_units", "head_packed")  # packed anew from the bf16 trees
    bf16 = lambda t: P.cast_tree({k: v for k, v in t.items() if k not in packed},
                                 torch.bfloat16)
    cv = vc.converter
    cv16 = dataclasses.replace(cv, tokenizer_params=bf16(cv.tokenizer_params),
                               vocoder_params=bf16(cv.vocoder_params))
    for label, conv, sd in (("float32 state", cv, torch.float32),
                            ("bf16 DSP and state", cv16, torch.bfloat16)):
        sync()
        t0 = time.perf_counter()
        sess = StreamSession(conv, scfg, [ref], state_dtype=sd)
        sync()
        setup_ms = 1e3 * (time.perf_counter() - t0)
        if sess.Tp != scfg.max_prompt_frames:
            raise AssertionError(f"ref_wavs session: prompt of {sess.Tp} frames")
        drive(f"ref_wavs session, {label}", sess, np.random.default_rng(55), 40,
              lambda f, t: counts_of(slow=f, fast=f, ring=t, head=f), wrappers)
        out[label] = {"setup_ms": setup_ms}
        log(f"[5] StreamSession(ref_wavs=[10 s]) {label}: set-up (speaker embeddings, "
            f"codes, tokens, prompt prefill) {setup_ms:.1f} ms")
    src = synthetic_voice(4.0, 200.0, 56)
    for w in wrappers.values():
        w.launches = 0
    sync()
    t0 = time.perf_counter()
    wav = vc.infer(src, [ref], delay=2, sampling=C.SamplingConfig(greedy=True))
    sync()
    infer_s = time.perf_counter() - t0
    Ts = len(src) // SPF
    frames = -(-Ts // 16) * 16
    counts = {k: w.launches for k, w in wrappers.items()}
    if counts != counts_of(slow=frames - 1, fast=frames):
        raise AssertionError(f"infer: launch counts {counts}, expected "
                             f"{counts_of(slow=frames - 1, fast=frames)} ({frames} frames)")
    if wav.shape != (Ts * SPF,) or not np.all(np.isfinite(wav)) or not np.any(wav != 0):
        raise AssertionError(f"infer: wav {wav.shape}, finite {np.all(np.isfinite(wav))}")
    out["infer"] = {"s": infer_s, "rtf": infer_s / (len(src) / 44100.0), "frames": frames}
    out["converter"] = vc.converter
    log(f"[5] VoiceConverter.infer, 4 s source ({Ts} frames, {frames} generated), 10 s "
        f"reference, greedy, delay 2: {1e3 * infer_s:.1f} ms, real-time factor "
        f"{out['infer']['rtf']:.4f}; launches {counts}")
    return out


def head_flops(hcfg, T0: int) -> int:
    """Multiply-adds x 2 of one head step on T0 frames."""
    from streamvoiceanon_tpu_torch.ops.hifigan import stage_channels

    chans = stage_channels(hcfg)
    f = T0 * hcfg.pre_conv_kernel_size * hcfg.num_mels * chans[0][0]
    T = T0
    nconv = len(hcfg.resblock_dilation_sizes[0]) * 2
    for s_, (ci, co) in zip(hcfg.upsample_rates, chans):
        f += T * 2 * ci * s_ * co
        T *= s_
        f += sum(T * k * co * co * nconv for k in hcfg.resblock_kernel_sizes)
    f += T * hcfg.post_conv_kernel_size * chans[-1][1]
    return 2 * f


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def build_session(cfg, device, scfg, sampling, lm_dtype, state_dtype, seed: int = 0,
                  converter=None, dsp_dtype=None, **session_kw):
    """A StreamSession under `cfg`, on seeded random weights (the tokenizer
    and vocoder in `dsp_dtype`, float32 unless given), or on the weights of
    `converter` (built under a program set whose parameter tree holds what
    `cfg` needs); `session_kw` go to the session (`incremental`)."""
    import dataclasses

    import torch

    from streamvoiceanon_tpu_torch import params as P
    from streamvoiceanon_tpu_torch.runtime.streaming import StreamSession
    from streamvoiceanon_tpu_torch.utils import randparams as rp

    t0 = time.time()
    if converter is None:
        cv = P.converter_from_numpy(
            cfg, rp.tokenizer_params_np(cfg.tokenizer, seed + 1),
            rp.vocoder_params_np(cfg.vocoder, seed + 2),
            rp.arvc_params_np(cfg.arvc, seed + 3), device=device, lm_dtype=lm_dtype,
            dsp_dtype=dsp_dtype or torch.float32)
    else:
        cv = dataclasses.replace(converter, cfg=cfg)
    t_params = time.time() - t0
    rng = np.random.default_rng(seed)
    d = cfg.arvc.decoder
    Tp = scfg.max_prompt_frames
    t0 = time.time()
    sess = StreamSession(
        cv, scfg, sampling=sampling, seed=seed,
        style=rng.standard_normal((1, cfg.arvc.style_dim)).astype(np.float32),
        timbre=rng.standard_normal((1, 32, cfg.arvc.context_dim)).astype(np.float32),
        ref_tokens=rng.integers(0, d.vocab_size, (1, Tp)).astype(np.int32),
        ref_codes=rng.integers(0, d.codebook_size, (1, d.num_codebooks, Tp)).astype(np.int32),
        state_dtype=state_dtype, **session_kw)
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()
    return sess, rng, t_params, time.time() - t0, cv


def stream(sess, rng, n_chunks: int):
    """Stream n_chunks of noise through `sess`; check every output.
    Returns per-chunk host ms (each ends in a device-to-host copy)."""
    src = (rng.standard_normal(n_chunks * SPF) * 0.1).astype(np.float32)
    times = []
    for i in range(n_chunks):
        decoding = sess.delay_prefilled and sess.tokens_seen + 1 > sess.delay
        t0 = time.perf_counter()
        out = sess.process_chunk(src[i * SPF : (i + 1) * SPF])
        times.append(1e3 * (time.perf_counter() - t0))
        if out.shape != (SPF,) or not np.all(np.isfinite(out)):
            raise AssertionError(f"chunk {i}: shape {out.shape}, finite "
                                 f"{bool(np.all(np.isfinite(out)))}")
        if decoding != bool(np.any(out != 0)):
            raise AssertionError(f"chunk {i}: silent={not np.any(out != 0)} but the "
                                 f"stream is {'decoding' if decoding else 'filling the delay'}")
    return times


def stage_split(sess, rng, n_chunks: int):
    """Device-synchronized medians over n_chunks of the three stages and of
    the background refill's history prefill (`refill_history`, run on the
    chunks of the refill window), and how many chunks ran each."""
    import torch

    from streamvoiceanon_tpu_torch.models import arvc, tokenizer_stream, vocoder

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    acc = {"encode": [], "lm_decode": [], "vocode": [], "refill_history": []}
    originals = []

    def timed(mod, name, key):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            sync()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            sync()
            acc[key].append(1e3 * (time.perf_counter() - t0))
            return r

        originals.append((mod, name, fn))
        setattr(mod, name, wrapper)

    timed(tokenizer_stream, "encode_stream", "encode")
    timed(arvc, "decode_one", "lm_decode")
    timed(vocoder, "decode_stream", "vocode")
    timed(arvc, "prefill_history", "refill_history")
    try:
        stream(sess, rng, n_chunks)
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    return {k: (float(np.median(v)), len(v)) for k, v in acc.items() if v}


def counts_of(slow=0, fast=0, ring=0, head=0, enc=0, attn=0):
    return {"slow": slow, "fast": fast, "ring": ring, "head": head, "enc": enc,
            "attn": attn}


def drive(name, sess, rng, n_chunks: int, expect, wrappers):
    """Warm up, zero every wrapper's count, stream n_chunks, check the
    counts against expect(frames, tokens), report, and split the stages.
    Returns (counts, refills)."""
    stream(sess, rng, 4)  # warm-up: delay fill, delay prefill, first decodes
    for w in wrappers.values():
        w.launches = 0
    f0, k0, r0 = sess.frames_decoded, sess.tokens_seen, sess.refill_count
    times = stream(sess, rng, n_chunks)
    counts = {k: w.launches for k, w in wrappers.items()}
    frames, tokens = sess.frames_decoded - f0, sess.tokens_seen - k0
    want = expect(frames, tokens)
    if counts != want or frames != n_chunks:
        raise AssertionError(f"{name}: launch counts {counts}, expected {want} "
                             f"({frames} frames decoded of {n_chunks} chunks)")
    p50, p90 = np.percentile(times, 50), np.percentile(times, 90)
    log(f"[3] {name}: {n_chunks} chunks, {frames} frames, {tokens} tokens, "
        f"{sess.refill_count - r0} refills, {sess.truncation_count} sampler "
        f"truncations; launches {counts}; chunk ms p50 {p50:.3f} p90 {p90:.3f} "
        f"max {max(times):.3f}; p50 / {FRAME_MS:.2f} ms = {p50 / FRAME_MS:.4f}")
    split = stage_split(sess, rng, 10)
    log(f"[3] {name} stage medians over 10 chunks (synchronized): " + fmt_split(split))
    return counts, sess.refill_count - r0


@contextlib.contextmanager
def recorded_samples():
    """Record (logits, tokens) of every `sample_token` call the dual-AR
    frame decode makes (the semantic token, then one a codebook step on the
    plain codebook loop), in call order."""
    from streamvoiceanon_tpu_torch.models import dual_ar

    rec, orig = [], dual_ar.sample_token

    def sample(logits, *a, **kw):
        r = orig(logits, *a, **kw)
        rec.append((logits.detach().float().clone(), r[0] if isinstance(r, tuple) else r))
        return r

    dual_ar.sample_token = sample
    try:
        yield rec
    finally:
        dual_ar.sample_token = orig


def batched_decode(ap, acfg, device, wrappers, batch: int = 4, Tp: int = 483,
                   delay: int = 2, frames: int = 16):
    """The dual-AR frame decode at batch `batch` at full width (bf16
    weights and cache, 2048 cache rows): `arvc.prefill_prompt` of a Tp-frame
    prompt and the delay prefill (pos 33 + 2 Tp + 2 delay - 1, about 1000),
    then `frames` greedy frames of `arvc.decode_one` under `per_head_decode`
    (the decode attention over batch x 12 heads, 12 launches a frame; the
    slow step and the fast loop take batch 1 only, so neither launches).
    Each frame also runs from a copy of the state under `PipelineConfig()`'s
    flags (every layer plain).  Semantic tokens and codes must agree up to
    bf16 flips: where the two differ, the plain choice's lead in the plain
    logits must be at most twice the largest logit difference of that step
    (a flip that logit noise explains); a row's codes are compared up to
    its first flip (after it the steps have other inputs); at least 90 % of
    what is compared must agree.  `ap` and `acfg` are the ARVC weights and
    configuration, whose decoder flags this sets.  Returns (launch counts,
    stats)."""
    import torch

    from streamvoiceanon_tpu_torch import config as C
    from streamvoiceanon_tpu_torch.models import arvc

    flags = lambda **kw: C.replace(acfg, decoder=C.replace(acfg.decoder, **kw))
    kcfg = flags(use_pallas_slow_decode=False, use_pallas_decode=True,
                 use_pallas_fast_decode=True)
    pcfg = flags(use_pallas_slow_decode=False, use_pallas_decode=False,
                 use_pallas_fast_decode=False)
    d = kcfg.decoder
    wd = ap["embedding"].dtype
    sync = torch.cuda.synchronize if str(device).startswith("cuda") else (lambda: None)
    rng = np.random.default_rng(23)
    ints = lambda hi, *shape: torch.from_numpy(rng.integers(0, hi, shape)).to(device)
    ref_tok, src = ints(d.vocab_size, batch, Tp), ints(d.vocab_size, batch, delay + frames)
    ref_codes = ints(d.codebook_size, batch, d.num_codebooks, Tp)
    style = torch.from_numpy(rng.standard_normal((batch, kcfg.style_dim))).to(device, wd)
    timbre = torch.from_numpy(rng.standard_normal((batch, 32, kcfg.context_dim))).to(
        device, wd)
    st = arvc.prefill_prompt(ap, kcfg, ref_tok, ref_codes, style, timbre, delay,
                             cache_dtype=torch.bfloat16)
    st = arvc.prefill_src_condition4delay(ap, kcfg, st, src[:, :delay], delay)
    pos0 = st.decode.pos
    greedy = C.SamplingConfig(greedy=True)
    stats = {"compared": 0, "agree": 0, "flips": [], "logit_diff": 0.0}
    k_ms, p_ms = [], []

    def compare(kr, pr, f, step):
        (lk, tk), (lp, tp) = kr, pr
        diff = (lk - lp).abs().amax(dim=-1)
        stats["logit_diff"] = max(stats["logit_diff"], float(diff.max()))
        same = tk == tp
        stats["compared"] += len(same)
        stats["agree"] += int(same.sum())
        for b in (~same).nonzero()[:, 0].tolist():
            want, got = int(tp[b]), int(tk[b])
            gap = float(lp[b, want] - lp[b, got])
            stats["flips"].append((f, b, step, gap, float(diff[b])))
            if not gap <= 2 * float(diff[b]):
                raise AssertionError(
                    f"batched decode frame {f} row {b} step {step}: token {got} against "
                    f"{want}, the plain lead {gap:.4g} beyond twice the logit difference "
                    f"{float(diff[b]):.4g}")
        return same

    for w in wrappers.values():
        w.launches = 0
    for f in range(frames):
        tok = src[:, delay + f : delay + f + 1]
        dcopy = st.decode._replace(k_cache=st.decode.k_cache.clone(),
                                   v_cache=st.decode.v_cache.clone())
        sync()
        with recorded_samples() as prec:
            t0 = time.perf_counter()
            arvc.decode_one(ap, pcfg, st._replace(decode=dcopy), tok, greedy)
            sync()
            p_ms.append(1e3 * (time.perf_counter() - t0))
        with recorded_samples() as krec:
            t0 = time.perf_counter()
            st, kcodes = arvc.decode_one(ap, kcfg, st, tok, greedy)
            sync()
            k_ms.append(1e3 * (time.perf_counter() - t0))
        del dcopy
        if len(krec) != 1 + d.num_codebooks or len(prec) != len(krec):
            raise AssertionError(f"batched decode: {len(krec)} and {len(prec)} sampler "
                                 "calls a frame")
        if not (torch.isfinite(st.audio_emb.float()).all() and kcodes.shape == (
                batch, d.num_codebooks) and int(kcodes.min()) >= 0
                and int(kcodes.max()) < d.codebook_size):
            raise AssertionError(f"batched decode frame {f}: codes {kcodes.tolist()}")
        compare(krec[0], prec[0], f, "semantic")
        live = torch.ones(batch, dtype=torch.bool, device=device)
        for s in range(d.num_codebooks):
            rows = live.nonzero()[:, 0]
            if len(rows) == 0:
                break
            (lk, tk), (lp, tp) = krec[1 + s], prec[1 + s]
            same = compare((lk[rows], tk[rows]), (lp[rows], tp[rows]), f, s)
            live[rows[~same]] = False
    counts = {k: w.launches for k, w in wrappers.items()}
    if counts != counts_of(attn=d.n_layer * frames):
        raise AssertionError(f"batched decode: launch counts {counts}, expected "
                             f"{counts_of(attn=d.n_layer * frames)}")
    if stats["agree"] < 0.9 * stats["compared"]:
        raise AssertionError(f"batched decode: {stats['agree']} of {stats['compared']} "
                             "tokens and codes agree")
    stats.update(pos=(pos0, st.decode.pos), kernel_ms=(np.percentile(k_ms, 50),
                                                        np.percentile(k_ms, 90)),
                 plain_ms=(np.percentile(p_ms, 50), np.percentile(p_ms, 90)))
    return counts, stats


# ---------------------------------------------------------------------------
# phase 6: serving
# ---------------------------------------------------------------------------


def recorded_inputs(sess):
    """Record every chunk given to `sess.process_chunk_async` (an instance
    attribute over the method), so that a synchronous copy can be driven
    with exactly the blocks an engine assembled."""
    seen, orig = [], sess.process_chunk_async

    def rec(chunk):
        seen.append(np.array(chunk, np.float32, copy=True))
        return orig(chunk)

    sess.process_chunk_async = rec
    return seen


def paced(push, src, n: int, period: float = FRAME_MS / 1e3) -> None:
    """Push n chunks of src at the real rate, one every `period` s."""
    t_next = time.perf_counter()
    for i in range(n):
        push(src[i * SPF : (i + 1) * SPF])
        t_next += period
        dt = t_next - time.perf_counter()
        if dt > 0:
            time.sleep(dt)


def wait_for(cond, seconds: float, what: str) -> None:
    deadline = time.time() + seconds
    while not cond():
        if time.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def zero(wrappers):
    for w in wrappers.values():
        w.launches = 0


def read_counts(wrappers):
    return {k: w.launches for k, w in wrappers.items()}


def same_within(got, want, what: str) -> float:
    """Max abs difference, which must be within 1e-5 of want's largest sample."""
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    if got.shape != want.shape or not scale > 0 or not err <= 1e-5 * scale:
        raise AssertionError(f"{what}: shapes {got.shape} / {want.shape}, max abs difference "
                             f"{err:.3e} against 1e-5 of the largest sample {scale:.3e}")
    return err


def pct(xs):
    return float(np.percentile(xs, 50)), float(np.percentile(xs, 90))


def sync_free_chunk(sess, chunk) -> float:
    """One `process_chunk_async` behind a device sleep of about half a
    second, under `torch.cuda.set_sync_debug_mode("error")`: a host
    synchronisation that the debug mode sees raises, and any other (the
    mode does not see every kind) would wait out the sleep, which must
    still be running when the call returns.  Returns the call's host ms."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)  # about 0.5 s at the H100's 1.98 GHz
    asleep = torch.cuda.Event()
    asleep.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        wav = sess.process_chunk_async(chunk)
        ms = 1e3 * (time.perf_counter() - t0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if asleep.query():
        raise AssertionError(f"process_chunk_async waited for the device ({ms:.1f} ms)")
    if not (wav.is_cuda and tuple(wav.shape) == (SPF,)):
        raise AssertionError(f"process_chunk_async: {wav.device} {tuple(wav.shape)}")
    torch.cuda.synchronize()
    return ms


def realtime_phase(cv, device, scfg, wrappers, n: int = 40):
    """`RealtimeEngine` under tpu_optimized at batch 1, sampled: warm-up and
    the refill programs, a snapshot, then a producer thread pushing n
    chunks at the real rate; the four kernels' launches over the run; the
    engine's output against a session restored from the snapshot and
    driven synchronously through `process_chunk`.  Then a short
    `all_five` engine run (front launches = tokens)."""
    import torch

    from streamvoiceanon_tpu_torch import config as C
    from streamvoiceanon_tpu_torch.runtime.realtime import RealtimeEngine
    from streamvoiceanon_tpu_torch.runtime.streaming import StreamSession

    sess, rng, _, _, _ = build_session(C.tpu_optimized(C.PipelineConfig()), device, scfg,
                                       C.SamplingConfig(), torch.bfloat16, torch.bfloat16,
                                       seed=61, converter=cv)
    eng = RealtimeEngine(sess, ring_seconds=4.0)
    eng.warm_up()
    sess.warm_refill_programs()
    snap = sess.snapshot()
    src = (rng.standard_normal(n * SPF) * 0.1).astype(np.float32)
    chk = StreamSession.restore(sess.cv, snap)
    chk.process_chunk_async(src[:SPF])
    async_ms = sync_free_chunk(chk, src[SPF : 2 * SPF])
    seen = recorded_inputs(sess)
    f0, k0 = sess.frames_decoded, sess.tokens_seen
    zero(wrappers)
    eng.start()
    try:
        paced(eng.push_input, src, n)
        wait_for(lambda: eng.chunks_processed >= n, 60, "the engine's chunks")
    finally:
        eng.stop()
    counts = read_counts(wrappers)
    frames, tokens = sess.frames_decoded - f0, sess.tokens_seen - k0
    want = counts_of(slow=frames, fast=frames, ring=tokens, head=frames)
    if counts != want or frames != n:
        raise AssertionError(f"RealtimeEngine: launch counts {counts}, expected {want} "
                             f"({frames} frames of {n} chunks)")
    got = eng.pull_output(n * SPF)
    ref = StreamSession.restore(sess.cv, snap)
    err = same_within(got, np.concatenate([ref.process_chunk(x) for x in seen]),
                      "RealtimeEngine against the restored session")
    lat = [1e3 * (t1 - t0) for t0, t1 in eng.latency_log]
    out = {"counts": counts, "delivery_ms": pct(lat), "err": err, "async_ms": async_ms,
           "in_overruns": eng.in_ring.overruns(), "in_underruns": eng.in_ring.underruns(),
           "out_overruns": eng.out_ring.overruns(), "out_underruns": eng.out_ring.underruns(),
           "max_fetch_batch": eng.max_fetch_batch}
    log(f"[6] RealtimeEngine tpu_optimized, batch 1, {n} chunks pushed at the real rate "
        f"({FRAME_MS:.2f} ms): delivery ms p50 {out['delivery_ms'][0]:.3f} p90 "
        f"{out['delivery_ms'][1]:.3f} (chunk read to output delivered); rings in "
        f"overruns {out['in_overruns']} underruns {out['in_underruns']}, out overruns "
        f"{out['out_overruns']} underruns {out['out_underruns']}; max fetch batch "
        f"{out['max_fetch_batch']}; launches {counts}; against the restored session driven "
        f"synchronously: max abs difference {err:.3e}; one process_chunk_async under "
        f"set_sync_debug_mode('error') returned in {async_ms:.3f} ms of host time while "
        "a device sleep before it still ran (no host synchronisation)")

    five, frng, _, _, _ = build_session(C.all_five(C.PipelineConfig()), device, scfg,
                                        C.SamplingConfig(), torch.bfloat16, torch.bfloat16,
                                        seed=62, converter=cv)
    eng5 = RealtimeEngine(five, ring_seconds=4.0)
    eng5.warm_up()
    m = 12
    src5 = (frng.standard_normal(m * SPF) * 0.1).astype(np.float32)
    f0, k0 = five.frames_decoded, five.tokens_seen
    zero(wrappers)
    eng5.start()
    try:
        eng5.push_input(src5)
        wait_for(lambda: eng5.chunks_processed >= m, 60, "the all_five engine's chunks")
    finally:
        eng5.stop()
    c5 = read_counts(wrappers)
    frames, tokens = five.frames_decoded - f0, five.tokens_seen - k0
    want = counts_of(slow=frames, fast=frames, ring=tokens, head=frames, enc=tokens)
    if c5 != want or frames != m:
        raise AssertionError(f"all_five RealtimeEngine: launch counts {c5}, expected {want}")
    out5 = eng5.pull_output(m * SPF)
    if not (np.all(np.isfinite(out5)) and np.any(out5 != 0)):
        raise AssertionError("all_five RealtimeEngine: output not finite or silent")
    log(f"[6] RealtimeEngine all_five, {m} chunks pushed at once: launches {c5}; max fetch "
        f"batch {eng5.max_fetch_batch}")
    out["all_five_counts"] = c5
    return out


def multistream_phase(cv, device, scfg, wrappers, B: int = 4, n: int = 40):
    """`MultiStreamEngine` under per_head_decode at batch B, greedy, built by
    `fanout(B)` from a one-stream session warmed by delay + 3 chunks; four
    producer threads push n chunks each at the real rate.  12 decode-
    attention launches a frame and no slow-step or fast-loop launch (batch
    1 kernels); each stream's output against the fanned-out session
    restored from a snapshot and driven synchronously with the blocks the
    engine assembled.  Reported beside it: the share of codes equal to a
    B-stream session built directly and warmed with the same chunks (its
    prompt prefill and warm frames ran at batch B, the fanned-out one's at
    batch 1 on the batch-1 kernels: bf16 sums in other orders)."""
    import threading

    import torch

    from streamvoiceanon_tpu_torch import config as C
    from streamvoiceanon_tpu_torch.runtime.realtime import MultiStreamEngine
    from streamvoiceanon_tpu_torch.runtime.streaming import StreamSession

    greedy = C.SamplingConfig(greedy=True)
    cfg = C.per_head_decode(C.PipelineConfig())
    one, rng, _, _, _ = build_session(cfg, device, scfg, greedy, torch.bfloat16,
                                      torch.bfloat16, seed=63, converter=cv)
    warm = (rng.standard_normal((scfg.delay + 3) * SPF) * 0.1).astype(np.float32)
    for i in range(scfg.delay + 3):
        one.process_chunk(warm[i * SPF : (i + 1) * SPF])
    multi = one.fanout(B)
    snap = multi.snapshot()
    eng = MultiStreamEngine(multi, ring_seconds=4.0)
    seen = recorded_inputs(multi)
    src = (rng.standard_normal((B, n * SPF)) * 0.1).astype(np.float32)
    f0 = multi.frames_decoded
    zero(wrappers)
    eng.start()
    try:
        producers = [threading.Thread(target=paced, args=(
            lambda x, i=i: eng.push_input(i, x), src[i], n)) for i in range(B)]
        for t in producers:
            t.start()
        for t in producers:
            t.join(timeout=60)
        wait_for(lambda: all(r.available() < eng.chunk for r in eng.in_rings)
                 and eng.ticks_processed == len(seen), 60, "the multistream engine's ticks")
    finally:
        eng.stop()
    counts = read_counts(wrappers)
    frames = multi.frames_decoded - f0
    want = counts_of(attn=cfg.arvc.decoder.n_layer * frames)
    if counts != want or frames != len(seen):
        raise AssertionError(f"MultiStreamEngine: launch counts {counts}, expected {want}")
    ticks = eng.ticks_processed
    got = np.stack([eng.pull_output(i, ticks * SPF) for i in range(B)])
    ref = StreamSession.restore(multi.cv, snap)
    direct = StreamSession(
        one.cv, scfg, sampling=greedy, seed=0, state_dtype=torch.bfloat16, batch=B,
        style=one.style.float().repeat(B, 1), timbre=one.timbre.float().repeat(B, 1, 1),
        ref_tokens=one.ref_tokens.repeat(B, 1), ref_codes=one.ref_codes.repeat(B, 1, 1))
    for i in range(scfg.delay + 3):
        direct.process_chunk(np.repeat(warm[None, i * SPF : (i + 1) * SPF], B, 0))
    outs, agree, compared = [], 0, 0
    for x in seen:
        outs.append(ref.process_chunk(x))
        direct.process_chunk(x)
        a, b = ref.fstate.code_ring[:, :, -1], direct.fstate.code_ring[:, :, -1]
        agree += int((a == b).sum())
        compared += a.numel()
    want_wav = np.concatenate(outs, axis=-1)
    err = max(same_within(got[i], want_wav[i], f"MultiStreamEngine stream {i}")
              for i in range(B))
    lat = [1e3 * (t1 - t0) for t0, t1 in eng.latency_log]
    span = eng.latency_log[-1][1] - eng.latency_log[0][0]
    out = {"counts": counts, "tick_ms": pct(lat), "missed": list(eng.missed), "err": err,
           "audio_s_per_s": B * ticks * (SPF / 44100.0) / span, "ticks": ticks,
           "direct_agree": (agree, compared), "max_fetch_batch": eng.max_fetch_batch}
    log(f"[6] MultiStreamEngine per_head_decode, fanout({B}), {n} chunks a stream from "
        f"{B} producer threads at the real rate: {ticks} ticks, tick ms p50 "
        f"{out['tick_ms'][0]:.3f} p90 {out['tick_ms'][1]:.3f}, missed {out['missed']}, "
        f"{out['audio_s_per_s']:.3f} audio-s/s delivered, max fetch batch "
        f"{out['max_fetch_batch']}; launches {counts}; each stream against the restored "
        f"session driven synchronously: max abs difference {err:.3e}; codes equal to a "
        f"directly built {B}-stream session: {agree}/{compared}")
    return out


def transfer_phase(cv, device, scfg, wrappers, n: int = 16):
    """`transfer` from the CPU to the card: a session prepared on the CPU
    (prompt, delay and 3 warm chunks, on phase 3's weights carried to the
    CPU) continues on the card for n chunks under tpu_optimized, with its
    launch check; the share of its codes equal to a session prepared on
    the card.  Greedy.  Gated with the LM and the state in float32, where
    the CPU's and the card's sums differ in the last float32 bits; reported
    at the bf16 serving point, where one flipped code sends a free-running
    stream elsewhere."""
    import dataclasses

    import torch

    from streamvoiceanon_tpu_torch import config as C
    from streamvoiceanon_tpu_torch import params as P

    cpu = torch.device("cpu")
    to_cpu = lambda tree: (tree.cpu() if torch.is_tensor(tree) else
                           {k: to_cpu(v) for k, v in tree.items()} if isinstance(tree, dict)
                           else [to_cpu(v) for v in tree] if isinstance(tree, (list, tuple))
                           else tree)
    greedy = C.SamplingConfig(greedy=True)
    cfg = C.tpu_optimized(C.PipelineConfig())
    out, counted = {}, counts_of()
    for label, dt, gate in (("float32", torch.float32, True),
                            ("bf16", torch.bfloat16, False)):
        card = dataclasses.replace(cv, cfg=cfg, arvc_params=P.cast_tree(cv.arvc_params, dt))
        host = dataclasses.replace(card, tokenizer_params=to_cpu(cv.tokenizer_params),
                                   vocoder_params=to_cpu(cv.vocoder_params),
                                   arvc_params=to_cpu(card.arvc_params), device=cpu)
        sessions = {}
        t0 = time.perf_counter()
        for where, conv, d in (("cpu", host, "cpu"), ("card", card, device)):
            sess, rng, _, _, _ = build_session(cfg, d, scfg, greedy, dt, dt, seed=64,
                                               converter=conv)
            src = (rng.standard_normal((scfg.delay + 3 + n) * SPF) * 0.1).astype(np.float32)
            for i in range(scfg.delay + 3):
                sess.process_chunk(src[i * SPF : (i + 1) * SPF])
            sessions[where] = sess
        prep_s = time.perf_counter() - t0
        moved = sessions["cpu"].transfer(card)
        f0, k0 = moved.frames_decoded, moved.tokens_seen
        zero(wrappers)
        codes = []
        for i in range(scfg.delay + 3, scfg.delay + 3 + n):
            wav = moved.process_chunk(src[i * SPF : (i + 1) * SPF])
            if wav.shape != (SPF,) or not np.all(np.isfinite(wav)):
                raise AssertionError(f"transfer: chunk {i} {wav.shape} not finite")
            codes.append(moved.fstate.code_ring[:, :, -1].clone())
        counts = read_counts(wrappers)
        frames, tokens = moved.frames_decoded - f0, moved.tokens_seen - k0
        want = counts_of(slow=frames, fast=frames, ring=tokens, head=frames)
        if counts != want or frames != n:
            raise AssertionError(f"transfer ({label}): launch counts {counts}, expected {want}")
        counted = {k: counted[k] + counts[k] for k in counted}
        agree = 0
        for i, c in zip(range(scfg.delay + 3, scfg.delay + 3 + n), codes):
            sessions["card"].process_chunk(src[i * SPF : (i + 1) * SPF])
            agree += int((sessions["card"].fstate.code_ring[:, :, -1] == c).sum())
        total = n * cfg.arvc.decoder.num_codebooks
        out[label] = {"agree": (agree, total), "prep_s": prep_s}
        log(f"[6] transfer CPU -> card, LM and state in {label}, greedy: prep (prompt, delay, "
            f"3 warm chunks on the CPU, the same on the card) {prep_s:.1f} s; {n} chunks on "
            f"the card, launches {counts}; codes equal to the session prepared on the card: "
            f"{agree}/{total}" + (" (at least 90 % required)" if gate else " (reported)"))
        if gate and agree < 0.9 * total:
            raise AssertionError(f"transfer ({label}): {agree} of {total} codes agree")
    out["counts"] = counted
    return out


def window_phase(cv, device, scfg, wrappers, n: int = 8):
    """Window mode (`incremental=False`) under tpu_optimized: n chunks after
    the delay, one slow-step and one fast-loop launch a frame (the offline
    tokenizer and vocoder run plain)."""
    import torch

    from streamvoiceanon_tpu_torch import config as C

    sess, rng, _, _, _ = build_session(C.tpu_optimized(C.PipelineConfig()), device, scfg,
                                       C.SamplingConfig(), torch.bfloat16, torch.bfloat16,
                                       seed=65, converter=cv, incremental=False)
    src = (rng.standard_normal((scfg.delay + 1 + n) * SPF) * 0.1).astype(np.float32)
    for i in range(scfg.delay + 1):
        sess.process_chunk(src[i * SPF : (i + 1) * SPF])
    f0 = sess.frames_decoded
    zero(wrappers)
    times = []
    for i in range(scfg.delay + 1, scfg.delay + 1 + n):
        t0 = time.perf_counter()
        wav = sess.process_chunk(src[i * SPF : (i + 1) * SPF])
        times.append(1e3 * (time.perf_counter() - t0))
        if wav.shape != (SPF,) or not np.all(np.isfinite(wav)) or not np.any(wav != 0):
            raise AssertionError(f"window mode: chunk {i} {wav.shape}, finite or silent")
    counts = read_counts(wrappers)
    frames = sess.frames_decoded - f0
    if counts != counts_of(slow=frames, fast=frames) or frames != n:
        raise AssertionError(f"window mode: launch counts {counts}, {frames} frames")
    log(f"[6] window mode (incremental=False), tpu_optimized, {n} chunks: launches {counts}; "
        f"chunk ms p50 {np.percentile(times, 50):.3f} p90 {np.percentile(times, 90):.3f}")
    return {"counts": counts, "chunk_ms": pct(times)}


def batch_server_phase(cv, device, wrappers, B: int = 4, frames: int = 86,
                       ref_s: float = 10.0):
    """`BatchServer.convert` of B sources of `frames` frames (4 s) in one
    bucket under per_head_decode, greedy, against one `ref_s` reference: at
    the bf16 serving point timed, 12 decode-attention launches a frame
    after the first and no other kernel; then with the LM in float32 the
    codes of every row against B single `VoiceConverter.infer` calls (the
    codes of the frames before the source's last `delay`, which infer's
    padded tokens do not reach), at least 90 % equal."""
    import dataclasses

    import torch

    from streamvoiceanon_tpu_torch import config as C
    from streamvoiceanon_tpu_torch import params as P
    from streamvoiceanon_tpu_torch.models import arvc
    from streamvoiceanon_tpu_torch.parallel.serving import BatchServer
    from streamvoiceanon_tpu_torch.runtime.pipeline import VoiceConverter

    greedy = C.SamplingConfig(greedy=True)
    delay = 2
    conv = dataclasses.replace(cv, cfg=C.per_head_decode(C.PipelineConfig()))
    vc = VoiceConverter(conv)
    ref = synthetic_voice(ref_s, 150.0, 51)
    srcs = np.stack([synthetic_voice(frames * SPF / 44100.0, 120.0 + 30 * i, 70 + i)[
        : frames * SPF] for i in range(B)])
    style, timbre = vc.speaker_embeddings([ref], 1.0)
    tokens, codes = vc.content_tokens(ref[None]), vc.audio_codes(ref[None])
    Tr = tokens.shape[1] // 8 * 8
    rows = lambda t: t.repeat_interleave(B, 0).cpu().numpy()
    prompt = (rows(tokens[:, :Tr]), rows(codes[:, :, :Tr]), rows(style), rows(timbre))
    zero(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wav = BatchServer(conv).convert(srcs, *prompt, sampling=greedy, delay=delay)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    counts = read_counts(wrappers)
    want = counts_of(attn=conv.cfg.arvc.decoder.n_layer * (frames - 1))
    if counts != want:
        raise AssertionError(f"BatchServer: launch counts {counts}, expected {want}")
    if wav.shape != (B, frames * SPF) or not np.all(np.isfinite(wav)):
        raise AssertionError(f"BatchServer: wav {wav.shape}")
    audio_s = B * frames * SPF / 44100.0
    recorded, orig = [], arvc.generate

    def generate(*a, **kw):
        recorded.append(orig(*a, **kw))
        return recorded[-1]

    conv32 = dataclasses.replace(conv, arvc_params=P.cast_tree(conv.arvc_params, torch.float32))
    arvc.generate = generate
    try:
        BatchServer(conv32).convert(srcs, *prompt, sampling=greedy, delay=delay)
        for i in range(B):
            VoiceConverter(conv32).infer(srcs[i], [ref], delay=delay, sampling=greedy)
    finally:
        arvc.generate = orig
    keep = frames - delay
    batched = recorded[0][:, :, :keep]
    singles = torch.cat([c[:, :, :keep] for c in recorded[1:]])
    agree, total = int((batched == singles).sum()), batched.numel()
    out = {"s": s, "rtf": s / audio_s, "counts": counts, "agree": (agree, total)}
    log(f"[6] BatchServer per_head_decode, {B} sources of {frames} frames in one bucket, "
        f"greedy, bf16 LM: {1e3 * s:.1f} ms for {audio_s:.2f} s of audio, real-time factor "
        f"{out['rtf']:.4f}; launches {counts}; float32 LM: codes equal to {B} single "
        f"VoiceConverter.infer calls {agree}/{total} (at least 90 % required)")
    if agree < 0.9 * total:
        raise AssertionError(f"BatchServer: {agree} of {total} codes agree with infer")
    return out


def cli_phase():
    """`cli.main(["convert", ...])` in this process on synthetic wavs (its own
    seeded random weights, tpu_optimized on the card): the written wav's
    length must be the source's whole frames."""
    import tempfile

    from scipy.io import wavfile

    from streamvoiceanon_tpu_torch import cli
    from streamvoiceanon_tpu_torch.audio.io import write_wav

    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as d:
        src, ref, out = (str(Path(d) / f) for f in ("src.wav", "ref.wav", "out.wav"))
        wav = synthetic_voice(2.0, 200.0, 81)
        write_wav(src, wav, 44100)
        write_wav(ref, synthetic_voice(3.0, 150.0, 82), 44100)
        t0 = time.perf_counter()
        cli.main(["convert", "--src", src, "--ref", ref, "--out", out])
        s = time.perf_counter() - t0
        sr, data = wavfile.read(out)
    if sr != 44100 or len(data) != len(wav) // SPF * SPF:
        raise AssertionError(f"cli convert: {len(data)} samples at {sr} Hz, expected "
                             f"{len(wav) // SPF * SPF}")
    log(f"[6] cli convert, 2 s source, 3 s reference (the CLI's own random weights): "
        f"{s:.1f} s with building the converter; {len(data)} samples written")
    return {"s": s}


def serving(cv, spk_cv, device, scfg, wrappers):
    """Phase 6: the serving surfaces on phase 3's weights and cut geometry.
    Returns the launches it counted, by kernel."""
    t0 = time.time()
    rt = realtime_phase(cv, device, scfg, wrappers)
    ms = multistream_phase(cv, device, scfg, wrappers)
    tr = transfer_phase(cv, device, scfg, wrappers)
    wn = window_phase(cv, device, scfg, wrappers)
    bs = batch_server_phase(spk_cv, device, wrappers)
    cli_phase()
    runs = (rt["counts"], rt["all_five_counts"], ms["counts"], tr["counts"], wn["counts"],
            bs["counts"])
    log(f"[6] done in {time.time() - t0:.1f} s")
    return {k: sum(c[k] for c in runs) for k in wrappers}


TRAIN_BATCH = 4
TRAIN_FRAMES = (86, 216)  # sources of 86 to 215 frames: 4 to 10 s
TRAIN_REL = 1e-4  # float32 step against the float64 forward_train
OVERFIT_STEPS = 30
F32_NORM_MAX = 1.8446744e19  # sqrt of float32's largest value: a larger norm's square overflows


def train_flops(d, shape, delay: int) -> int:
    """Operations of one `forward_train` (multiply-adds x 2) on content of
    `shape` (B, T): both stacks' products, their attention over the whole
    (T, T) score matrices as the plain path computes them, the two
    heads."""
    B, T = shape
    L = 33 + 2 * (T + delay)

    def stack(n_layer, dim, H, nl, hd, inter, rows, seq):
        per_row = 2 * dim * (H + 2 * nl) * hd + 2 * H * hd * dim + 3 * 2 * dim * inter
        return n_layer * (rows * per_row + (rows // seq) * 2 * 2 * seq * seq * H * hd)

    slow = stack(d.n_layer, d.dim, d.n_head, d.n_local_heads, d.head_dim,
                 d.intermediate_size, B * L, L)
    nq = d.num_codebooks
    fast = stack(d.n_fast_layer, d.fast_dim, d.fast_n_head, d.fast_n_local_heads,
                 d.fast_head_dim, d.fast_intermediate_size, B * T * nq, nq)
    heads = 2 * B * T * (d.dim * d.vocab_size + nq * d.fast_dim * d.codebook_size)
    return slow + fast + heads


def ns_flops(leaves, steps: int = 6) -> int:
    """Operations of `newton_schulz5` on each (..., m, n) leaf: per step
    x x^T, A A and B x, 4 m^2 n + 2 m^3 with m <= n."""
    total = 0
    for g in leaves:
        m, n = sorted(g.shape[-2:])
        total += steps * (4 * m * m * n + 2 * m ** 3) * int(np.prod(g.shape[:-2]))
    return total


def lm_tree_np(cfg, seed: int = 3, input_biases: bool = True):
    """The trained LM's numpy tree from `seed` (phase 3's), and with
    `input_biases` the biases of `context_in` and `style_in` drawn as
    torch.nn.Linear draws them, U(+-1/sqrt(fan_in)), in place of
    randparams' zeros.  With zero biases the random speaker encoder's
    all-zero timbre rows (20 to 25 of 32 at the default config, for any
    input) enter the LM as exact-zero leading rows, which stay zero through
    every layer: their input gradient grows by about 1/sqrt(eps) at each of
    the 24 RMSNorms, to about 1e21 in `context_in.b`, and the float32
    global norm overflows, in optax's sum of squares as in the port's
    (`zero_prefix_step`)."""
    from streamvoiceanon_tpu_torch.utils import randparams as rp

    tree = rp.arvc_params_np(cfg.arvc, seed)
    if input_biases:
        rng = np.random.default_rng(seed + 1000)
        for name, fan_in in (("context_in", cfg.arvc.context_dim),
                             ("style_in", cfg.arvc.style_dim)):
            b = tree[name]["b"]
            tree[name]["b"] = rng.uniform(-fan_in ** -0.5, fan_in ** -0.5, b.shape).astype(
                b.dtype)
    return tree


def zero_prefix_step(cfg, feats, delay: int, device):
    """The first step with randparams' zero input biases on the same
    features: losses within TRAIN_REL of float64; the float32 gradient norm
    inf exactly where the float64 one is beyond float32's reach (optax's sum
    of squares overflows there too), else within TRAIN_REL; and where it is
    inf, the trainer's chain (clip 1000 -> MuonAdamW -> schedule) turns
    every leaf's update into its weight decay alone, -lr * wd * p, as
    optax's does (a clipped gradient g / inf * 1000 is 0).  Returns
    {dtype: (codebook loss, token loss, gradient norm)}."""
    import torch

    from streamvoiceanon_tpu_torch import params as P
    from streamvoiceanon_tpu_torch.models import arvc
    from streamvoiceanon_tpu_torch.train import muon
    from streamvoiceanon_tpu_torch.train import step as step_mod
    from streamvoiceanon_tpu_torch.utils.tree import flatten, tree_map

    tree = P.arvc_params(lm_tree_np(cfg, input_biases=False), device)
    res = {}
    for dt in (torch.float64, torch.float32):
        p = step_mod.trainable(tree, dt)
        f = {k: v.to(dt) if v.is_floating_point() else v for k, v in feats.items()}
        cb, tok = arvc.forward_train(p, cfg.arvc, f["content"], f["base_target"], f["target"],
                                     f["x_lens"], f["style"], f["timbre"], delay)
        grads = step_mod.grads_of(cb + tok, p)
        res[dt] = (cb.item(), tok.item(), muon.global_norm(grads).item())
        worst = 0.0
        if dt == torch.float32 and res[dt][2] == float("inf"):
            lr, wd = 1e-4, 0.01
            tx = muon.chain(muon.clip_by_global_norm(1000.0), muon.muon_adamw(lr=lr),
                            muon.scale_by_schedule(muon.exp_decay_schedule(lr)))
            flat = flatten(tree_map(lambda t: t.detach(), p))
            with torch.no_grad():
                upd, _ = tx.update(grads, tx.init(flat), flat)
                worst = max(float((u + lr * wd * flat[k]).abs().max()
                                  / max(float((lr * wd * flat[k]).abs().max()), 1e-30))
                            for k, u in upd.items())
        del p, grads
    (c32, t32, n32), (c64, t64, n64) = res[torch.float32], res[torch.float64]
    rel = max(abs(c32 - c64) / c64, abs(t32 - t64) / t64)
    overflow = n64 > F32_NORM_MAX
    log(f"[7] zero input biases (randparams): step 1 losses {c32:.6f}, {t32:.6f} against "
        f"float64 {c64:.6f}, {t64:.6f} (rel {rel:.2e}); gradient norm float64 {n64:.6e}, "
        f"float32 {n32:.6e}" + (f" (its square overflows past {F32_NORM_MAX:.4e}, in "
                                f"optax's sum of squares too); every update of the clipped "
                                f"chain is the weight decay alone (largest departure "
                                f"{worst:.2e} of it)" if overflow else ""))
    norm_ok = n32 == float("inf") if overflow else abs(n32 - n64) <= TRAIN_REL * n64
    if not (rel <= TRAIN_REL and norm_ok and worst <= 1e-6):
        raise AssertionError(f"zero-prefix step: rel {rel}, norms {n64} / {n32}, update {worst}")
    return res


def training_phase(device, wrappers):
    """Phase 7: the ARVC trainer at full width (`PipelineConfig()`'s LM in
    float32, about 145 M trainable parameters; phase 3's tokenizer and
    vocoder seeds, phase 5's CAM++ and speaker-encoder seeds, all frozen) on
    `train/data.synthetic_dataset` batches of 4 sources of 86 to 215 frames,
    the LM's input biases drawn as `lm_tree_np` says.
    Checks: the first step with randparams' zero input biases as
    `zero_prefix_step` holds it; the first step's two losses and gradient
    norm against a float64 `forward_train` on the same features within
    TRAIN_REL; six steps with
    finite losses (steps 2-6 timed by CUDA events, `_features` and `_step`
    apart); OVERFIT_STEPS steps of `muon_adamw(lr=3e-3)` on one batch of
    features end below half the first loss (then that batch's LM step timed
    in parts beside its operations' bound); `save_checkpoint` -> a fresh
    trainer -> `load_checkpoint` gives bit-equal parameters and
    `resume_latest` the highest step; a greedy `arvc.generate` on the trained
    weights under tpu_optimized launches the slow step once a frame after
    the first and the fast loop once a frame, and its codes agree with the
    same call under `PipelineConfig()`'s plain flags at least 90 %.
    Returns the measurements and the launches it counted."""
    import os
    import tempfile

    import torch

    from streamvoiceanon_tpu_torch import config as C
    from streamvoiceanon_tpu_torch import params as P
    from streamvoiceanon_tpu_torch.models import arvc
    from streamvoiceanon_tpu_torch.train import data, muon
    from streamvoiceanon_tpu_torch.train import step as step_mod
    from streamvoiceanon_tpu_torch.train.arvc_trainer import ARVCTrainer, TrainerConfig
    from streamvoiceanon_tpu_torch.utils import randparams as rp
    from streamvoiceanon_tpu_torch.utils.tree import flatten, tree_map

    t_phase = time.time()
    cfg = C.PipelineConfig()
    trees = {
        "arvc_params": P.arvc_params(lm_tree_np(cfg), device),
        "tokenizer_params": P.tokenizer_params(rp.tokenizer_params_np(cfg.tokenizer, 1), device),
        "vocoder_params": P.vocoder_params(rp.vocoder_params_np(cfg.vocoder, 2), device),
        "campplus_params": P.campplus_params(rp.campplus_params_np(cfg.campplus, 5), device),
        "speaker_params": P.speaker_params(rp.speaker_encoder_params_np(cfg.speaker, 6),
                                           device)}
    n_params = sum(t.numel() for t in flatten(trees["arvc_params"]).values())
    tmp = tempfile.TemporaryDirectory()
    log_dir = os.path.join(tmp.name, "run")
    trainer = ARVCTrainer(cfg, TrainerConfig(log_dir=log_dir), **trees, device=device)
    dcfg = data.DataConfig(batch_size=TRAIN_BATCH)
    batches = data.batches(data.synthetic_dataset(dcfg, seed=71, frames=TRAIN_FRAMES,
                                                  with_text=False), dcfg)
    log(f"[7] training set-up {time.time() - t_phase:.1f} s: {n_params} trainable "
        f"parameters in float32 (the input projections' biases drawn as torch.nn.Linear "
        f"draws them), batches of {TRAIN_BATCH} sources of {TRAIN_FRAMES[0]} to "
        f"{TRAIN_FRAMES[1] - 1} frames, delays drawn from {cfg.arvc.decoder.delay}")

    # step 1 against float64, first with randparams' zero input biases
    batch = next(batches)
    feats1 = trainer._features(batch["waves"], batch["frame_lens"])
    delay = trainer.draw_delay()
    zero_rows = int((feats1["timbre"].abs().amax(-1) == 0).sum())
    log(f"[7] batch 1: timbre latents with every value zero: {zero_rows} of "
        f"{feats1['timbre'].shape[0] * feats1['timbre'].shape[1]} rows")
    zero_prefix_step(cfg, feats1, delay, device)
    p64 = tree_map(lambda t: t.detach().double().requires_grad_(True), trainer.state.params)
    f64 = {k: v.double() if v.is_floating_point() else v for k, v in feats1.items()}
    cb, tok = arvc.forward_train(p64, cfg.arvc, f64["content"], f64["base_target"],
                                 f64["target"], f64["x_lens"], f64["style"], f64["timbre"],
                                 delay)
    want = {"codebook_loss": cb.item(), "token_loss": tok.item(),
            "grad_norm": muon.global_norm(step_mod.grads_of(cb + tok, p64)).item()}
    del p64, f64, cb, tok
    aux = {k: float(v) for k, v in trainer._step(feats1, delay).items()}
    errs = {k: abs(aux[k] - v) / abs(v) for k, v in want.items()}
    log(f"[7] step 1 (delay {delay}, {int(batch['frame_lens'].sum())} frames) against a "
        "float64 forward_train on the card: " + ", ".join(
            f"{k} {aux[k]:.6f} / {want[k]:.6f} (rel {errs[k]:.2e})" for k in want)
        + f" (bound {TRAIN_REL})")
    if not max(errs.values()) <= TRAIN_REL:
        raise AssertionError(f"training step 1 against float64: {errs}")
    losses = [aux["loss"]]

    # steps 2-6, timed
    torch.cuda.reset_peak_memory_stats(device)
    feat_ms, step_ms, fps = [], [], []
    for i in range(2, 7):
        batch = next(batches)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        feats = trainer._features(batch["waves"], batch["frame_lens"])
        ev[1].record()
        aux = trainer._step(feats, trainer.draw_delay())
        ev[2].record()
        torch.cuda.synchronize()
        feat_ms.append(ev[0].elapsed_time(ev[1]))
        step_ms.append(ev[1].elapsed_time(ev[2]))
        fps.append(int(batch["frame_lens"].sum()) / (1e-3 * (feat_ms[-1] + step_ms[-1])))
        losses.append(float(aux["loss"]))
    peak = torch.cuda.max_memory_allocated(device)
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"training losses not finite: {losses}")
    out = {"feat_ms": float(np.median(feat_ms)), "step_ms": float(np.median(step_ms)),
           "fps": float(np.median(fps)), "peak_bytes": int(peak), "losses": losses}
    log(f"[7] six steps, losses {', '.join(f'{x:.4f}' for x in losses)}; steps 2-6 p50: "
        f"_features {out['feat_ms']:.3f} ms (runs {', '.join(f'{x:.3f}' for x in feat_ms)}), "
        f"_step {out['step_ms']:.3f} ms (runs {', '.join(f'{x:.3f}' for x in step_ms)}), "
        f"{out['fps']:.1f} frames a second; max_memory_allocated over steps 2-6 "
        f"{peak / 2**30:.3f} GiB")

    # checkpoints: bit-equal round trip, resume_latest picks the highest step
    snap = {k: v.detach().clone() for k, v in flatten(trainer.state.params).items()}
    t0 = time.time()
    path6 = trainer.save_checkpoint(keep_last=0)
    trainer.train_step(next(batches))
    path7 = trainer.save_checkpoint(keep_last=2)
    fresh = ARVCTrainer(cfg, TrainerConfig(log_dir=log_dir), **trees, device=device)
    fresh.load_checkpoint(path6)
    same6 = all(torch.equal(snap[k], v) for k, v in flatten(fresh.state.params).items())
    latest = fresh.resume_latest()
    same7 = all(torch.equal(flatten(trainer.state.params)[k], v)
                for k, v in flatten(fresh.state.params).items())
    log(f"[7] checkpoints: {os.path.basename(path6)} into a fresh trainer bit-equal "
        f"{same6}; resume_latest -> {os.path.basename(latest)} (step {fresh.state.step}) "
        f"bit-equal {same7}; {time.time() - t0:.1f} s")
    if not (same6 and same7 and latest == path7 and fresh.state.step == 7):
        raise AssertionError("training checkpoints: round trip or resume_latest failed")
    del fresh, snap

    # overfitting one batch of features
    tx = muon.chain(muon.clip_by_global_norm(1000.0), muon.muon_adamw(lr=3e-3))
    st = step_mod.init_state(step_mod.trainable(trees["arvc_params"]), tx)
    curve = []
    for _ in range(OVERFIT_STEPS):
        st, a = step_mod.train_step(st, feats1, cfg.arvc, tx, 2)
        curve.append(a["loss"])
    curve = [float(x) for x in curve]
    out["overfit"] = (curve[0], curve[-1])
    log(f"[7] overfitting one batch, {OVERFIT_STEPS} steps of muon_adamw(lr=3e-3), delay 2: "
        f"loss {curve[0]:.4f} -> {curve[-1]:.4f} (must end below half); every fifth "
        + ", ".join(f"{x:.3f}" for x in curve[::5]))
    if not (np.all(np.isfinite(curve)) and curve[-1] < 0.5 * curve[0]):
        raise AssertionError(f"overfitting one batch: {curve[0]} -> {curve[-1]}")
    # the LM step on this batch split: forward and backward, the optimizer's
    # update (not applied), Newton-Schulz alone; each beside its operations
    # over the float32 peak
    fwd_bwd = lambda: step_mod.grads_of(step_mod.loss_fn(st.params, cfg.arvc, feats1, 2)[0],
                                        st.params)
    grads = fwd_bwd()
    flat = flatten(st.params)
    muon_leaves = [g for k, g in grads.items() if muon.labels(flat)[k] == "muon"]
    split = {"forward and backward": cuda_ms(fwd_bwd, 5, 1)}
    with torch.no_grad():
        split["optimizer update"] = cuda_ms(lambda: tx.update(grads, st.opt_state, flat), 5, 1)
        split["Newton-Schulz alone"] = cuda_ms(
            lambda: [muon.newton_schulz5(g) for g in muon_leaves], 5, 1)
    fwd, ns = train_flops(cfg.arvc.decoder, feats1["content"].shape, 2), ns_flops(muon_leaves)
    bounds = {"forward and backward": 4 * fwd, "optimizer update": ns, "Newton-Schulz alone": ns}
    out["split"] = split
    log("[7] LM step on that batch (CUDA events, 5 runs each): " + "; ".join(
        f"{k} {v:.3f} ms (bound {1e3 * bounds[k] / FP32_FLOPS:.3f} ms by operations, "
        f"{bounds[k]:.4g} flop)" for k, v in split.items())
        + f"; forward {fwd:.4g} flop, taken as a quarter of forward, recompute and backward")
    del st, grads, muon_leaves

    # the trained weights through the decode kernels
    n = int(feats1["x_lens"][0])
    params = tree_map(lambda t: t.detach(), trainer.state.params)
    args = (feats1["content"][:1, :16], feats1["target"][:1, :, :16], feats1["content"][:1, :n],
            feats1["style"][:1], feats1["timbre"][:1], C.SamplingConfig(greedy=True), 2)
    zero(wrappers)
    codes, gen_ms = {}, {}
    for name, acfg in (("tpu_optimized", C.tpu_optimized(cfg).arvc), ("plain", cfg.arvc)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            codes[name] = arvc.generate(params, acfg, *args)
        torch.cuda.synchronize()
        gen_ms[name] = 1e3 * (time.perf_counter() - t0)
        if name == "tpu_optimized":
            counts = read_counts(wrappers)
    if counts != counts_of(slow=n - 1, fast=n) or read_counts(wrappers) != counts:
        raise AssertionError(f"generate on the trained weights: launches {counts}, then "
                             f"{read_counts(wrappers)}; expected "
                             f"{counts_of(slow=n - 1, fast=n)} ({n} frames)")
    agree = int((codes["tpu_optimized"] == codes["plain"]).sum())
    total = codes["plain"].numel()
    out.update(counts=counts, agree=(agree, total), gen_ms=gen_ms)
    log(f"[7] greedy generate on the trained float32 weights, {n} frames, 16-frame prompt: "
        f"tpu_optimized {gen_ms['tpu_optimized']:.1f} ms, launches {counts}; plain flags "
        f"{gen_ms['plain']:.1f} ms; codes agree {agree}/{total} ({agree / total:.4f}, at "
        "least 0.9 required)")
    if agree < 0.9 * total:
        raise AssertionError(f"generate on the trained weights: {agree} of {total} codes agree")
    tmp.cleanup()
    log(f"[7] done in {time.time() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 8: the published checkpoints' loader, then anonymize a dataset and
# score its privacy and utility through the CLI
# ---------------------------------------------------------------------------

EVAL_SPEAKERS = (("spk0", 110.0, "1"), ("spk1", 150.0, "1"), ("spk2", 210.0, "2"),
                 ("spk3", 290.0, "2"))  # (speaker, f0, SER fold)
EVAL_EMOTIONS = ("neu", "hap", "sad")
EVAL_SECONDS = 3.0
# The random vocoder's waveform stays under one 16-bit step: its wav files
# would hold silence, whose fbank features are all the clamp floor, and the
# AA scores would all be equal.  Phase 8 scales the head's last conv (before
# its tanh, near-linear here) and logs the anonymized wavs' peaks.
VOCODER_GAIN = 1e5


@contextlib.contextmanager
def step_meters(targets):
    """Time each (module, function name) of `targets` while it runs, with
    the card's peak allocation over each call (`max_memory_allocated`,
    reset on entry): {name: {"s", "calls", "peak_gib"}}.  A training
    function that takes `history` gets a list, kept under "history"."""
    import inspect

    import torch

    meters, saved = {}, []
    for mod, name in targets:
        fn = getattr(mod, name)
        m = meters.setdefault(name, {"s": 0.0, "calls": 0, "peak_gib": 0.0, "history": []})
        takes_history = "history" in inspect.signature(fn).parameters

        def wrapped(*a, _fn=fn, _m=m, _h=takes_history, **kw):
            if _h and kw.get("history") is None:
                kw["history"] = hist = []
                _m["history"].append(hist)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            _m["s"] += time.perf_counter() - t0
            _m["calls"] += 1
            _m["peak_gib"] = max(_m["peak_gib"], torch.cuda.max_memory_allocated() / 2**30)
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)
    try:
        yield meters
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def write_eval_dirs(data) -> dict:
    """The synthetic dataset `synth_dev` (EVAL_SPEAKERS x 3 utterances of 3 s
    at 44.1 kHz from `synthetic_voice`, with text, utt2emo and spk2fold);
    returns {utt_id: samples}."""
    from streamvoiceanon_tpu_torch.audio.io import write_wav
    from streamvoiceanon_tpu_torch.evals.kaldi import save_kaldi_format

    d = Path(data) / "synth_dev"
    (d / "wav").mkdir(parents=True)
    scp, u2s, u2e, text, fold, lens = {}, {}, {}, {}, {}, {}
    for si, (spk, f0, fo) in enumerate(EVAL_SPEAKERS):
        fold[spk] = fo
        for j in range(3):
            u = f"{spk}_{j}"
            wav = synthetic_voice(EVAL_SECONDS, f0 * (1.0 + 0.04 * j), 800 + 10 * si + j)
            scp[u] = str(d / "wav" / f"{u}.wav")
            write_wav(scp[u], wav, 44100)
            u2s[u], u2e[u], lens[u] = spk, EVAL_EMOTIONS[(si + j) % 3], len(wav)
            text[u] = f"the {spk} said number {j} twice"
    for name, table in (("wav.scp", scp), ("utt2spk", u2s), ("utt2emo", u2e), ("text", text),
                        ("spk2fold", fold)):
        save_kaldi_format(table, d / name)
    return lens


def split_eval_dirs(data) -> None:
    """Enrollment (each speaker's first utterance) and trial (the other two)
    directories of `synth_dev` and of `synth_dev_anon`, sharing their wavs."""
    from streamvoiceanon_tpu_torch.evals.kaldi import read_kaldi_format, save_kaldi_format

    for src, suffix in (("synth_dev", ""), ("synth_dev_anon", "_anon")):
        scp = read_kaldi_format(Path(data) / src / "wav.scp")
        u2s = read_kaldi_format(Path(data) / src / "utt2spk")
        for name, keep in (("synth_enrolls", lambda u: u.endswith("_0")),
                           ("synth_trials", lambda u: not u.endswith("_0"))):
            d = Path(data) / f"{name}{suffix}"
            save_kaldi_format({u: p for u, p in scp.items() if keep(u)}, d / "wav.scp")
            save_kaldi_format({u: s for u, s in u2s.items() if keep(u)}, d / "utt2spk")


def eval_phase(device, wrappers):
    """Phase 8 at the published geometry, on phase 3's tokenizer, vocoder and
    ARVC trees and phase 5's CAM++ and speaker-encoder trees (the seeds of
    `build_session` and `prompt_side`; the vocoder head's last conv times
    VOCODER_GAIN, so that the anonymized audio is not silence):

    - the five published checkpoint files written from those trees in the
      reference's layout (`state_dicts`, `write_checkpoints`), loaded by
      `cli.build_converter(dir)` with strict coverage: every leaf bit-equal
      to `converter_from_numpy` of the same trees;
    - `cli.main(["anonymize", ...])` over a synthetic Kaldi directory (4
      speakers x 3 utterances of 3 s) with two target references: one
      fast-loop launch a generated frame, one slow-step launch a frame
      after the first, and no other kernel; every wav finite, of its
      source's whole frames and louder than one 16-bit step; wav.scp,
      utt2spk and the side tables complete;
    - `cli.main(["evaluate", ...])` twice: cosine scoring with ASV_eval^anon
      on the CAM++ backbone (`ASVTrainConfig`, 200 steps), the SER fold
      heads and WER from hypotheses cached here; then PLDA scoring with the
      ECAPA attacker (`ECAPAASVConfig`, 300 steps).  The attackers train on
      the anonymized directory and the original one (the VPC recipe trains
      on anonymized speech alone; with random weights the original speakers
      are what makes a falling loss a fair check).  Every EER, min-Cllr,
      linkability, UAR and WER finite and in range; the ASV, ECAPA and SER
      losses falling (the mean of the last ten steps below the first ten's);
    - CAM++ embeddings of four utterances on the card against the same
      function on the CPU, within 1e-4 of the largest (TF32 off).

    Reports the seconds and `max_memory_allocated` of each step.  Returns
    the anonymization's launch counts and the numbers."""
    import tempfile

    import torch

    from streamvoiceanon_tpu_torch import cli
    from streamvoiceanon_tpu_torch import config as C
    from streamvoiceanon_tpu_torch import params as P
    from streamvoiceanon_tpu_torch.audio.io import read_wav, write_wav
    from streamvoiceanon_tpu_torch.evals import anonymize as anon
    from streamvoiceanon_tpu_torch.evals import asv_train, ecapa_asv, ser, wer
    from streamvoiceanon_tpu_torch.evals.kaldi import read_kaldi_format, save_kaldi_format
    from streamvoiceanon_tpu_torch.utils import randparams as rp
    from streamvoiceanon_tpu_torch.utils.tree import flatten

    t_phase = time.time()
    cfg = C.PipelineConfig()
    trees = {"tokenizer": rp.tokenizer_params_np(cfg.tokenizer, 1),
             "vocoder": rp.vocoder_params_np(cfg.vocoder, 2),
             "arvc": rp.arvc_params_np(cfg.arvc, 3),
             "campplus": rp.campplus_params_np(cfg.campplus, 5),
             "speaker": rp.speaker_encoder_params_np(cfg.speaker, 6)}
    post = trees["vocoder"]["head"]["conv_post"]
    post["w"] = post["w"] * np.float32(VOCODER_GAIN)
    out = {}
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        ckpt, data, res = (Path(tmp) / n for n in ("ckpt", "data", "results"))
        ckpt.mkdir()
        t0 = time.perf_counter()
        write_checkpoints(ckpt, state_dicts(trees))
        write_s = time.perf_counter() - t0
        mib = sum(f.stat().st_size for f in ckpt.iterdir()) / 2**20
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cv = cli.build_converter(str(ckpt))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        ref = P.converter_from_numpy(
            cv.cfg, trees["tokenizer"], trees["vocoder"], trees["arvc"], device=device,
            campplus_np=trees["campplus"], speaker_np=trees["speaker"])
        n_leaves = 0
        for name in ("tokenizer_params", "vocoder_params", "arvc_params", "campplus_params",
                     "speaker_params"):
            a, b = flatten(getattr(cv, name)), flatten(getattr(ref, name))
            if a.keys() != b.keys():
                raise AssertionError(f"checkpoint load: {name} keys differ: "
                                     f"{sorted(set(a) ^ set(b))[:6]}")
            for k in a:
                if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k]):
                    raise AssertionError(f"checkpoint load: {name} {k} differs from "
                                         "converter_from_numpy")
            n_leaves += len(a)
        del ref
        out["load"] = {"write_s": write_s, "load_s": load_s, "mib": mib, "leaves": n_leaves}
        log(f"[8] checkpoints: five files of {mib:.1f} MiB written from phase 3's and "
            f"5's trees in the reference layout in {write_s:.2f} s; cli.build_converter "
            f"(torch.load onto the card, strict coverage, the bridge) {load_s:.2f} s; "
            f"{n_leaves} leaves bit-equal to converter_from_numpy")
        del cv
        torch.cuda.empty_cache()

        # ---- anonymize
        lens = write_eval_dirs(data)
        refs = [str(Path(tmp) / f"target{i}.wav") for i in range(2)]
        for path, (f0, seed) in zip(refs, ((130.0, 861), (240.0, 862))):
            write_wav(path, synthetic_voice(8.0, f0, seed), 44100)
        zero(wrappers)
        with step_meters([(anon, "anonymize_dataset")]) as m:
            cli.main(["anonymize", "--data-dir", str(data / "synth_dev"), "--out-dir",
                      str(data / "synth_dev_anon"), "--target-refs", *refs, "--ckpt-dir",
                      str(ckpt)])
        counts = read_counts(wrappers)
        frames = sum(-(-(n // SPF) // 16) * 16 for n in lens.values())
        want = counts_of(slow=frames - len(lens), fast=frames)
        if counts != want:
            raise AssertionError(f"anonymize: launch counts {counts}, expected {want} "
                                 f"({frames} frames over {len(lens)} utterances)")
        anon_dir = data / "synth_dev_anon"
        scp = read_kaldi_format(anon_dir / "wav.scp")
        if sorted(scp) != sorted(lens) or read_kaldi_format(anon_dir / "utt2spk") != \
                read_kaldi_format(data / "synth_dev" / "utt2spk"):
            raise AssertionError("anonymize: wav.scp or utt2spk incomplete")
        for side in ("text", "utt2emo", "spk2fold"):
            if (anon_dir / side).read_text() != (data / "synth_dev" / side).read_text():
                raise AssertionError(f"anonymize: {side} not copied")
        peaks = []
        for u, path in scp.items():
            wav, sr = read_wav(path)
            peaks.append(float(np.abs(wav).max()))
            if sr != 44100 or len(wav) != lens[u] // SPF * SPF or not np.all(np.isfinite(wav)) \
                    or np.abs(wav).max() < 2 / 32768:
                raise AssertionError(f"anonymize: {u} has {len(wav)} samples at {sr} Hz, "
                                     f"peak {np.abs(wav).max():.3g}; expected "
                                     f"{lens[u] // SPF * SPF}, finite, above one 16-bit step")
        an = m["anonymize_dataset"]
        audio_s = sum(lens.values()) / 44100.0
        out["anonymize"] = {"s": an["s"], "rtf": an["s"] / audio_s, "audio_s": audio_s,
                            "peak_gib": an["peak_gib"], "counts": counts}
        log(f"[8] cli anonymize: {len(lens)} utterances, {audio_s:.1f} s of audio, "
            f"{frames} frames generated: {1e3 * an['s']:.1f} ms (the converter's load "
            f"apart), {1e3 * an['s'] / len(lens):.1f} ms an utterance, real-time factor "
            f"{out['anonymize']['rtf']:.4f}, max_memory_allocated {an['peak_gib']:.2f} GiB; "
            f"launches {counts}; wav peaks {min(peaks):.4f} to {max(peaks):.4f} (the vocoder "
            f"head's last conv times {VOCODER_GAIN:g})")

        # ---- evaluate
        split_eval_dirs(data)
        texts = read_kaldi_format(data / "synth_dev" / "text")
        for name in ("synth_dev", "synth_dev_anon"):  # cached hypotheses
            hyp = {u: (t if name == "synth_dev" else t.replace("number", "numbers"))
                   for u, t in texts.items()}
            save_kaldi_format(hyp, res / "asr" / name / "text")
        targets = [(anon, "speaker_embeddings"), (asv_train, "train_asv_eval"),
                   (ecapa_asv, "train_ecapa_asv"), (ser, "train_fold_classifiers"),
                   (ser, "train_head"), (wer, "evaluate_asr")]
        runs = (("cosine", "campplus", True), ("plda", "ecapa", False))
        results, run_s = {}, {}
        with step_meters(targets) as meters:
            for dist, backbone, utility in runs:
                argv = ["evaluate", "--data-dir", str(data), "--results-dir",
                        str(res), "--ckpt-dir", str(ckpt), "--asv-enrolls",
                        "synth_enrolls", "--asv-trials", "synth_trials",
                        "--train-asv-on-anon", "--train-dirs", "synth_dev_anon", "synth_dev",
                        "--asv-distance", dist, "--asv-anon-backbone", backbone]
                if utility:
                    argv += ["--ser-datasets", "synth_dev", "--ser-emotions",
                             *EVAL_EMOTIONS, "--asr-datasets", "synth_dev"]
                t0 = time.perf_counter()
                results[dist] = cli.main(argv)
                run_s[dist] = time.perf_counter() - t0
        for dist, r in results.items():
            for row in r["asv"]:
                if not (0 <= row["EER"] <= 100 and np.isfinite(row["cllr_min"])
                        and row["cllr_min"] >= 0 and 0 <= row["linkability"] <= 1):
                    raise AssertionError(f"evaluate {dist}: ASV row out of range: {row}")
            if [r_["model"] for r_ in r["asv"]] != ["ASV_eval"] * 3 + ["ASV_eval_anon"]:
                raise AssertionError(f"evaluate {dist}: ASV rows {r['asv']}")
        for row in results["cosine"]["ser"]:
            if not 0 <= row["UAR"] <= 100:
                raise AssertionError(f"evaluate: SER row out of range: {row}")
        wers = [row["WER"] for row in results["cosine"]["asr"]]
        if not (wers[0] == 0.0 and 0 < wers[1] <= 100):
            raise AssertionError(f"evaluate: WER {wers}, expected 0 and the cached "
                                 "hypotheses' substitutions")
        for name, what in (("train_asv_eval", "ASV_eval^anon (CAM++)"),
                           ("train_ecapa_asv", "ECAPA"), ("train_head", "SER heads")):
            for h in meters[name]["history"]:
                if not (len(h) >= 20 and np.all(np.isfinite(h))
                        and np.mean(h[-10:]) < np.mean(h[:10])):
                    raise AssertionError(f"{what}: losses not falling: first "
                                         f"{h[:3]}, last {h[-3:]}")
        # CAM++ on the card against the same function on the CPU
        cp = cli.build_converter(str(ckpt)).campplus_params
        cp_cpu = P.campplus_params(trees["campplus"], "cpu")
        utts = anon.load_kaldi_dir(str(data / "synth_enrolls"))
        e_card = anon.speaker_embeddings(cp, cfg.campplus, utts)
        e_cpu = anon.speaker_embeddings(cp_cpu, cfg.campplus, utts)
        emb_err = float(np.abs(e_card - e_cpu).max())
        if emb_err > 1e-4 * np.abs(e_cpu).max():
            raise AssertionError(f"CAM++ on the card against the CPU: max abs err {emb_err:.3e}")
    hist = {n: meters[n]["history"] for n in ("train_asv_eval", "train_ecapa_asv",
                                               "train_head")}
    steps = {n: {k: meters[n][k] for k in ("s", "calls", "peak_gib")} for n in meters}
    out["evaluate"] = {"steps": steps, "rows": results, "run_s": run_s, "emb_err": emb_err}
    fmt = lambda n: (f"{steps[n]['s']:.2f} s over {steps[n]['calls']} calls, "  # noqa: E731
                     f"max_memory_allocated {steps[n]['peak_gib']:.2f} GiB")
    log(f"[8] cli evaluate, cosine + ASV_eval^anon on CAM++ + SER + WER: "
        f"{run_s['cosine']:.1f} s; PLDA + the ECAPA attacker: "
        f"{run_s['plda']:.1f} s (each with building the converter)")
    log(f"[8] steps: CAM++ embeddings {fmt('speaker_embeddings')}; ASV_eval^anon training "
        f"(CAM++ head, 200 steps of 32 x 3 s) {fmt('train_asv_eval')}; ECAPA training "
        f"(300 steps of 32 x 3 s) {fmt('train_ecapa_asv')}; SER fold heads "
        f"{fmt('train_fold_classifiers')}; WER scoring {fmt('evaluate_asr')}")
    first_last = lambda h: f"{np.mean(h[:10]):.3f} -> {np.mean(h[-10:]):.3f}"  # noqa: E731
    log(f"[8] losses, mean of the first ten steps -> the last ten: ASV_eval^anon "
        f"{first_last(hist['train_asv_eval'][0])}, ECAPA {first_last(hist['train_ecapa_asv'][0])}"
        f", SER heads " + ", ".join(first_last(h) for h in hist["train_head"]))
    for dist, r in results.items():
        for row in r["asv"]:
            log(f"[8] {dist} {row['model']} {row['enrollment']}-{row['trial']}: EER "
                f"{row['EER']}, min-Cllr {row['cllr_min']}, linkability {row['linkability']}")
    log(f"[8] SER UAR " + ", ".join(f"{row['ser']} {row['UAR']:.3f}"
                                    for row in results["cosine"]["ser"])
        + f"; WER {wers}; CAM++ card against CPU max abs err {emb_err:.3e}")
    log(f"[8] done in {time.time() - t_phase:.1f} s")
    out["counts"] = out["anonymize"]["counts"]
    return out


def fmt_split(split) -> str:
    return ", ".join(f"{k} {v:.3f} ms ({n} runs)" for k, (v, n) in split.items())


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from streamvoiceanon_tpu_torch import config as C
        from streamvoiceanon_tpu_torch import resolve_device
        from streamvoiceanon_tpu_torch.ops import _build
        wrappers = kernel_wrappers()
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script ({e})",
              file=sys.stderr)
        return 1
    t_start = time.time()
    device = resolve_device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    logs = _build.build_all()
    log(f"[1] build: {time.time() - t0:.1f} s ({', '.join(logs) or 'cached'})")
    for name, text in logs.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", text))
        log(f"[1]   {name}: {len(regs)} kernels, max {max(regs, default=0)} registers, "
            f"{spills} bytes spill stores")

    cfg = C.tpu_optimized(C.PipelineConfig())
    d = cfg.arvc.decoder
    wcfg = cfg.tokenizer.transformer
    hcfg = cfg.vocoder.head
    tcfg = C.all_five(C.PipelineConfig()).tokenizer

    # ---- phase 2
    t0 = time.time()
    st32 = compare_kernels(d, device, torch.float32, torch.float32, 1000, 8, True)
    log(f"[2] f32: slow step tokens {st32['slow']['agree']}/{st32['slow']['n']}, "
        f"max abs err {st32['slow']['err']:.3e}; fast loop codes "
        f"{st32['fast']['agree']}/{st32['fast']['n']}, max abs err "
        f"{st32['fast']['err']:.3e} (bound {TOL})")
    st16 = compare_kernels(d, device, torch.bfloat16, torch.bfloat16, 1000, 8, False)
    log(f"[2] bf16: slow step tokens {st16['slow']['agree']}/{st16['slow']['n']}, "
        f"max abs err {st16['slow']['err']:.3e}; fast loop codes "
        f"{st16['fast']['agree']}/{st16['fast']['n']}, max abs err "
        f"{st16['fast']['err']:.3e} (reported)")
    for name in ("slow", "fast"):
        st = st16[name]
        flips = "; ".join(
            f"{'greedy' if gr else 'sampled'} frame {f} step {k}: top-two gap {gap:.4g}"
            for gr, f, k, gap in st["flips"]) or "none"
        log(f"[2] bf16 {name}: largest logit difference kernel against plain "
            f"{st['logit_diff']:.4g} (over the steps with the same inputs); tokens or codes "
            f"that differ, each with the plain race's lead of its choice over the "
            f"kernel's in logit units: {flips}")
    agree, n, err, aerr = compare_slow_positions(d, device, torch.float32, SLOW_POS, True)
    st32["slow"]["err"] = max(st32["slow"]["err"], err, aerr)
    log(f"[2] f32 slow step at pos {list(SLOW_POS)}: tokens {agree}/{n}, max abs err "
        f"{err:.3e}; its attention alone at pos 0..259, 1000, 1023, 1024, "
        f"{d.max_seq_len - 2}: max abs err {aerr:.3e} (bound {TOL}); NaN cache rows "
        f">= pos never read")
    agree, n, err, aerr = compare_slow_positions(d, device, torch.bfloat16, SLOW_POS, False)
    log(f"[2] bf16 slow step at the same positions: tokens {agree}/{n}, max abs err "
        f"{err:.3e}; attention alone max abs err {aerr:.3e} (reported); NaN cache rows "
        f">= pos never read")
    st32["ring"] = {"err": compare_ring(wcfg, device, torch.float32, RING_COUNTS, True)}
    ring16 = compare_ring(wcfg, device, torch.bfloat16, RING_COUNTS, False)
    log(f"[2] ring step at counts {list(RING_COUNTS)}: f32 max abs err "
        f"{st32['ring']['err']:.3e} (bound {TOL}); bf16 max abs err {ring16:.3e} (reported)")
    st32["head"] = {"err": compare_head(hcfg, device, 8, True)[0]}
    log(f"[2] head over 8 chunks, state carried, the kept scratch NaN before chunk 4: f32 "
        f"max abs err {st32['head']['err']:.3e} (bound {TOL})")
    st32["enc"] = {"err": compare_front(tcfg, device, 8, True)[0]}
    log(f"[2] ConvNeXt front over 8 chunks, state carried, the kept scratch NaN before "
        f"chunk 4: f32 max abs err "
        f"{st32['enc']['err']:.3e} (bound {TOL})")
    b16 = torch.bfloat16
    from streamvoiceanon_tpu_torch.ops.convnext_enc import encoder_front_step_plain
    from streamvoiceanon_tpu_torch.ops.hifigan import head_stream_step_plain

    for name, fn, plain, ulps, flips in (
            ("head", compare_head, head_stream_step_plain, HEAD_BF16_ULPS, HEAD_FLIP_SHARE),
            ("ConvNeXt front", compare_front, encoder_front_step_plain, FRONT_BF16_ULPS,
             FRONT_FLIP_SHARE)):
        cfg_ = hcfg if name == "head" else tcfg
        err, eu, share = fn(cfg_, device, 4, True, b16, b16)
        _, cu, cshare = fn(cfg_, device, 4, False, b16, b16, kern=unrounded(plain))
        log(f"[2] bf16 {name} (bf16 weights and tails) over 4 chunks, the kept scratch NaN "
            f"before chunk 2: max abs err {err:.3e}, {eu:.2f} bf16 ulps of its output "
            f"(bound {ulps} ulps), flip share {share:.4f} (bound {flips}); the control "
            f"without the rounding: {cu:.2f} ulps, flip share {cshare:.4f}")
        if cshare <= flips:
            raise AssertionError(f"bf16 {name}: the control without the rounding reads flip "
                                 f"share {cshare:.4f}, within the bound {flips}: the check "
                                 "cannot see a missing rounding")
    for name, wc in wider_fronts(tcfg).items():
        for dt in (torch.float32, b16):
            err, eu, _ = compare_front(wc, device, 4, True, dt, dt)
            bb = wc.backbone
            log(f"[2] ConvNeXt front at the {name} geometry (dims {bb.dims}, C_q "
                f"{wc.quantizer.input_dim}, downsample {wc.quantizer.downsample_factor}), "
                f"{str(dt)[6:]}: max abs err {err:.3e}, {eu:.2f} bf16 ulps (bound "
                + (f"{FRONT_BF16_ULPS} ulps)" if dt == b16 else f"{TOL})"))
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    st32["attn"] = {"err": 0.0}
    for H in ATTN_HEADS:
        ageo = (H, 2, d.head_dim, d.max_seq_len)
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            at = attn_positions(*ageo, dt, n_sm)
            errs[dt] = compare_attention(*ageo, device, dt, at, True)
        st32["attn"]["err"] = max(st32["attn"]["err"], errs[torch.float32])
        log(f"[2] decode attention {H} heads at pos {at} (bf16's; float32's split edges "
            f"differ): f32 max abs err {errs[torch.float32]:.3e} (bound {ATTN_TOL}), bf16 "
            f"max abs err {errs[torch.bfloat16]:.3e} (bound one bf16 ulp + {ATTN_TOL}); "
            "caches equal; NaN rows >= pos + 2 never read; kept partials NaN before the "
            "middle position")
    # torch.profiler and the CUDA-graph capture run in a child process, so
    # that nothing they leave behind can touch phase 3's timing
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--breakdown"],
                       capture_output=True, text=True, timeout=600)
    sys.stdout.write(r.stdout)
    if r.returncode != 0:
        raise AssertionError(f"decode breakdown failed:\n{r.stderr[-4000:]}")
    tk = time_kernels(d, device, 1000)
    for pos in SLOW_TIME_POS:
        t = tk["slow"] if pos == 1000 else time_kernels(d, device, pos, ("slow",))["slow"]
        log(f"[2] slow bf16 pos {pos}: kernel {t['ms']:.4f} ms (runs "
            f"{', '.join(f'{x:.4f}' for x in t['ms_runs'])}), plain {t['plain_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms by {t['bound_by']} ({t['bytes']} B)")
    tk.update(time_ring_head(wcfg, hcfg, device, 1000))
    tk.update(time_front_attention(tcfg, d, device))
    dsp = time_dsp(hcfg, tcfg, device)
    for key, what in (("head", "head T0 4"), ("enc", "front"), ("enc_wide", "front wide"),
                      ("enc_down8", "front downsample 8")):
        log(f"[2] {what}: " + "; ".join(
            f"{str(dt)[6:]} kernel {t['ms']:.4f} ms (runs "
            f"{', '.join(f'{x:.4f}' for x in t['ms_runs'])}), bound {t['bound_ms']:.4f} ms "
            f"by {t['bound_by']} ({t['bytes']} B)"
            for (k, dt), t in dsp.items() if k == key))
    for name, what in (("slow", "bf16 pos 1000"), ("fast", "bf16"),
                       ("ring", "f32 count 1000"), ("head", "f32 T0 4"),
                       ("enc", "f32 T0 4"), ("attn", "bf16 12 heads pos 1000")):
        t = tk[name]
        peak = f", peak {t['peak'] / 1e12:.0f} TFLOP/s" if "peak" in t else ""
        lib = f", library {t['library_ms']:.4f} ms" if "library_ms" in t else ""
        log(f"[2] {name} {what}: kernel {t['ms']:.4f} ms (runs "
            f"{', '.join(f'{x:.4f}' for x in t['ms_runs'])}), plain {t['plain_ms']:.4f} ms"
            f"{lib}, bound {t['bound_ms']:.4f} ms by {t['bound_by']} ({t['bytes']} B, "
            f"{t['flops']} flop{peak})")
    log("[2] decode attention bf16 by batch x pos, kernel ms (runs) / plain / library / "
        "bound: " + "; ".join(
            f"B {B} ({B * d.n_head} heads) pos {pos} {t['ms']:.4f} ("
            f"{', '.join(f'{x:.4f}' for x in t['ms_runs'])}) / {t['plain_ms']:.4f} / "
            f"{t['library_ms']:.4f} / {t['bound_ms']:.4f} ({t['bytes']} B)"
            for (B, pos), t in tk["attn_grid"].items()))
    log(f"[2] done in {time.time() - t0:.1f} s")

    # ---- phase 3: tpu_optimized, then three shorter sessions on its weights
    scfg = C.StreamConfig(max_prompt_frames=32, max_seq_frames=64, buffer_frames=8,
                          delay=2)
    sess, rng, t_par, t_pre, cv = build_session(cfg, device, scfg, C.SamplingConfig(),
                                                torch.bfloat16, torch.bfloat16)
    log(f"[3] params {t_par:.1f} s, session set-up (prompt prefill) {t_pre:.2f} s")

    launches, refills = drive("tpu_optimized", sess, rng, 40, lambda f, t: counts_of(
        slow=f, fast=f, ring=t, head=f), wrappers)
    if refills < 2:
        raise AssertionError(f"only {refills} prompt refills in 40 chunks")
    for name, pcfg, n, expect in (
            ("fast_slow", C.fast_slow_config(C.PipelineConfig()), 12,
             lambda f, t: counts_of(slow=f, fast=f)),
            ("all_five", C.all_five(C.PipelineConfig()), 16,
             lambda f, t: counts_of(slow=f, fast=f, ring=t, head=f, enc=t)),
            ("per_head", C.per_head_decode(C.PipelineConfig()), 16,
             lambda f, t: counts_of(fast=f, ring=t, head=f, attn=d.n_layer * f))):
        psess, prng, _, _, _ = build_session(pcfg, device, scfg, C.SamplingConfig(),
                                             torch.bfloat16, torch.bfloat16, converter=cv)
        counts, _ = drive(name, psess, prng, n, expect, wrappers)
        own = {"all_five": "enc", "per_head": "attn"}.get(name)
        if own:  # the kernel this session adds: its launches are this run's
            launches[own] = counts[own]

    counts, bst = batched_decode(cv.arvc_params, cfg.arvc, device, wrappers)
    flips = "; ".join(f"frame {f} row {b} {k}: plain lead {gap:.4g}, logit difference "
                      f"{ld:.4g}" for f, b, k, gap, ld in bst["flips"]) or "none"
    log(f"[3] batched decode, batch 4, pos {bst['pos'][0]} to {bst['pos'][1]}, greedy: "
        f"launches {counts}; per_head_decode frame ms p50 {bst['kernel_ms'][0]:.3f} p90 "
        f"{bst['kernel_ms'][1]:.3f}; PipelineConfig() flags (plain) frame ms p50 "
        f"{bst['plain_ms'][0]:.3f} p90 {bst['plain_ms'][1]:.3f}; tokens and codes agree "
        f"{bst['agree']}/{bst['compared']}, largest logit difference "
        f"{bst['logit_diff']:.4g}; flips: {flips}")

    # ---- phase 5: the prompt side on phase 3's weights
    ps = prompt_side(cv, device, scfg, wrappers)

    # ---- phase 6: serving on phase 3's weights
    for key, n in serving(cv, ps["converter"], device, scfg, wrappers).items():
        launches[key] += n

    # ---- phase 7: training
    for key, n in training_phase(device, wrappers)["counts"].items():
        launches[key] += n

    # ---- phase 8: the checkpoints' loader, anonymization and the evals
    for key, n in eval_phase(device, wrappers)["counts"].items():
        launches[key] += n

    # ---- phase 4
    kernels = []
    for key, name, src, rep in (
            ("slow", "slow_decode_step", "slow_decode.cu", "pallas_slow_decode.py:248"),
            ("fast", "fast_decode", "fast_decode.cu", "pallas_fast_decode.py:260"),
            ("ring", "wt_stream_step", "wt_stream.cu", "pallas_wt_stream.py:218"),
            ("head", "head_stream_step", "hifigan_head.cu", "pallas_hifigan.py:353"),
            ("enc", "encoder_front_step", "convnext_enc.cu", "pallas_convnext_enc.py:353"),
            ("attn", "decode_attention", "decode_attention.cu", "pallas_attention.py:78")):
        t = tk[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"streamvoiceanon_tpu_torch/csrc/{src}",
            "replaces": f"streamvoiceanon_tpu/ops/{rep}",
            "launches": launches[key], "max_abs_err": st32[key]["err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms")})
    log(f"[4] total {time.time() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def breakdown_main() -> int:
    """`python3 chip_smoke.py --breakdown`: phase 2's slow-step, fast-loop,
    head, ring-step, front and decode-attention breakdowns alone (main runs
    them in a child process)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from streamvoiceanon_tpu_torch import config as C

    cfg = C.tpu_optimized(C.PipelineConfig())
    d = cfg.arvc.decoder
    slow_breakdown(d, "cuda", SLOW_TIME_POS)
    fast_breakdown(d, "cuda")
    head_breakdown(cfg.vocoder.head, "cuda")
    ring_breakdown(cfg.tokenizer.transformer, "cuda")
    front_breakdown(C.all_five(C.PipelineConfig()).tokenizer, "cuda")
    attn_breakdown(d, "cuda")
    return 0


def kernel_wrappers():
    """The six kernel wrappers by key; each counts its launches."""
    from streamvoiceanon_tpu_torch.ops.attention import decode_attention
    from streamvoiceanon_tpu_torch.ops.convnext_enc import encoder_front_step
    from streamvoiceanon_tpu_torch.ops.fast_decode import fast_decode
    from streamvoiceanon_tpu_torch.ops.hifigan import head_stream_step
    from streamvoiceanon_tpu_torch.ops.slow_decode import slow_decode_step
    from streamvoiceanon_tpu_torch.ops.wt_stream import wt_stream_step

    return {"slow": slow_decode_step, "fast": fast_decode, "ring": wt_stream_step,
            "head": head_stream_step, "enc": encoder_front_step, "attn": decode_attention}


def training_main() -> int:
    """`python3 chip_smoke.py --training`: phase 7 alone, after building the
    kernels."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from streamvoiceanon_tpu_torch import resolve_device
    from streamvoiceanon_tpu_torch.ops import _build

    device = resolve_device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    _build.build_all()
    log(f"[1] build: {time.time() - t0:.1f} s")
    out = training_phase(device, kernel_wrappers())
    log(card)
    print(json.dumps({"training": {k: v for k, v in out.items() if k != "gen_ms"}}),
          flush=True)
    return 0


def eval_main() -> int:
    """`python3 chip_smoke.py --eval`: phase 8 alone, after building the
    kernels."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from streamvoiceanon_tpu_torch import resolve_device
    from streamvoiceanon_tpu_torch.ops import _build

    device = resolve_device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    _build.build_all()
    log(f"[1] build: {time.time() - t0:.1f} s")
    out = eval_phase(device, kernel_wrappers())
    log(card)
    print(json.dumps({"eval": {"load": out["load"], "anonymize": out["anonymize"],
                               "steps": out["evaluate"]["steps"],
                               "run_s": out["evaluate"]["run_s"]}}), flush=True)
    return 0


def session_main(name: str, chunks: int) -> int:
    """`python3 chip_smoke.py --session NAME [--chunks N]`: one phase-3
    session alone (NAME a program set of `config`, e.g. per_head_decode),
    warmed up by 4 chunks, then N chunks (default 40): chunk ms p50, p90
    and mean, and the stage split.  Runs against whatever package sits
    beside the script, so two trees' sessions can be interleaved."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from streamvoiceanon_tpu_torch import config as C

    scfg = C.StreamConfig(max_prompt_frames=32, max_seq_frames=64, buffer_frames=8,
                          delay=2)
    sess, rng, _, _, _ = build_session(getattr(C, name)(C.PipelineConfig()), "cuda", scfg,
                                       C.SamplingConfig(), torch.bfloat16, torch.bfloat16)
    stream(sess, rng, 4)
    times = stream(sess, rng, chunks)
    tree = Path(__file__).resolve().parent.name
    log(f"[3] {name} alone, {tree}: {chunks} chunks, chunk ms "
        f"p50 {np.percentile(times, 50):.3f} p90 {np.percentile(times, 90):.3f} mean "
        f"{np.mean(times):.3f}; stage medians over 10 chunks (synchronized): "
        + fmt_split(stage_split(sess, rng, 10)))
    return 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    if argv == ["--breakdown"]:
        sys.exit(breakdown_main())
    if argv == ["--training"]:
        sys.exit(training_main())
    if argv == ["--eval"]:
        sys.exit(eval_main())
    if argv[:1] == ["--session"]:
        sys.exit(session_main(argv[1], int(argv[3]) if argv[2:3] == ["--chunks"] else 40))
    sys.exit(main())
