"""ARVC wrapper: content-token embedding and speaker conditioning around the
dual-AR LM, with the training forward, the offline `generate` and the
streaming prefill and decode programs, as `streamvoiceanon_tpu.models.arvc`.

The interleaved stream layout:

  [spk_cond (33) | c_0 a_{-d} c_1 a_{-d+1} ... ]   (c = content, a = audio)

where the first d audio slots are learned wait4start embeddings and d is
the delay in frames.  LM activations stay in the LM parameters' dtype.
The KV cache takes the layout the decoder's flags choose (flat rows or per
head, `dual_ar.init_state`); every program here runs on either.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from streamvoiceanon_tpu_torch.config import ARVCConfig, SamplingConfig, replace
from streamvoiceanon_tpu_torch.models import dual_ar
from streamvoiceanon_tpu_torch.parallel.mesh import model_shards
from streamvoiceanon_tpu_torch.utils.profiling import span


def prepare_params(raw: Dict) -> Dict:
    """`runtime/convert.arvc`'s numpy tree (a `decoder` with per-layer lists)
    -> the stacked numpy layout of `utils/randparams.arvc_params_np`: every
    leaf of the slow and fast layers gains a leading (L,) axis.
    `params.arvc_params` carries it over to the device."""

    def stack(layers):
        return {k: stack([lp[k] for lp in layers]) if isinstance(layers[0][k], dict)
                else np.stack([np.asarray(lp[k]) for lp in layers]) for k in layers[0]}

    model = dict(raw["decoder"]["model"])
    model["layers"] = stack(model["layers"])
    model["fast_layers"] = stack(model["fast_layers"])
    p = {"embedding": raw["embedding"], "context_in": raw["context_in"],
         "style_in": raw["style_in"], "model": model}
    if "wait4start" in raw["decoder"]:
        p["wait4start"] = raw["decoder"]["wait4start"]
        p["wait4end"] = raw["decoder"]["wait4end"]
    return p


def spk_condition(params: Dict, style_vec: torch.Tensor, timbre: torch.Tensor) -> torch.Tensor:
    """(B, 192) style + (B, 32, 128) timbre -> (B, 33, dim) condition prefix."""
    t = timbre @ params["context_in"]["w"] + params["context_in"]["b"]
    s = style_vec @ params["style_in"]["w"] + params["style_in"]["b"]
    return torch.cat([t, s[:, None]], dim=1)


def embed_content(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens.long()]


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, T, D), (B, T, D) -> (B, 2T, D) as a_0 b_0 a_1 b_1 ..."""
    B, T, D = a.shape
    return torch.stack([a, b], dim=2).reshape(B, 2 * T, D)


def forward_train(params: Dict, cfg: ARVCConfig, content_tokens: torch.Tensor,
                  base_target: torch.Tensor, target: torch.Tensor, x_lens: torch.Tensor,
                  style_vec: torch.Tensor, timbre: torch.Tensor, delay: int,
                  remat: bool = True, data_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training losses (codebook CE, semantic CE) of content tokens (B, T),
    semantic targets (B, T), codebook targets (B, nq, T), valid frames x_lens
    (B,) and the speaker condition; `delay` is drawn by the trainer per
    batch.  See `dual_ar.forward_train` (`data_group`: the rows are this
    rank's share of a batch split over 'data')."""
    return dual_ar.forward_train(
        params["model"], cfg.decoder, embed_content(params, content_tokens),
        spk_condition(params, style_vec, timbre), base_target, target, x_lens,
        params["wait4start"], params["wait4end"], delay, remat=remat,
        data_group=data_group)


class ARVCState(NamedTuple):
    decode: dual_ar.DecodeState
    audio_emb: torch.Tensor  # (B, 1, dim) — the next frame's audio slot
    ref_tail_emb: torch.Tensor  # (B, delay, dim) — audio not yet interleaved


def prefill_prompt(params: Dict, cfg: ARVCConfig, ref_content: torch.Tensor,
                   ref_audio_codes: torch.Tensor, style_vec: torch.Tensor,
                   timbre: torch.Tensor, delay: int,
                   cache_dtype=torch.float32) -> ARVCState:
    """Fill a fresh KV cache with the reference prompt."""
    dcfg = cfg.decoder
    B, Tp = ref_content.shape
    ref_cond = embed_content(params, ref_content)
    spk = spk_condition(params, style_vec, timbre)
    ref_emb = dual_ar.embed_codes(params["model"], dcfg, ref_audio_codes)
    if delay > 0:
        tail = ref_emb[:, Tp - delay :]
        w4s = params["wait4start"][None, :delay].expand(B, -1, -1)
        audio_stream = torch.cat([w4s, ref_emb[:, : Tp - delay]], dim=1)
        audio_cache = torch.zeros_like(ref_emb[:, :1])
    else:
        tail = ref_emb[:, :0]
        audio_stream = ref_emb
        audio_cache = ref_emb[:, -1:]
    emb_seq = torch.cat([spk, _interleave(ref_cond, audio_stream)], dim=1)
    if delay == 0:
        emb_seq = emb_seq[:, :-1]  # the last audio slot waits in audio_cache
    state = dual_ar.init_state(dcfg, batch=B, cache_dtype=cache_dtype,
                               device=ref_content.device,
                               n_model=model_shards(params["model"]["layers"]))
    state, _ = dual_ar.prefill(params["model"], dcfg, state, emb_seq)
    return ARVCState(state, audio_cache, tail)


def prefill_src_condition4delay(params: Dict, cfg: ARVCConfig, state: ARVCState,
                                src_content: torch.Tensor, delay: int) -> ARVCState:
    """Once `delay` source frames have arrived: interleave them with the
    cached reference audio tail and extend the KV cache."""
    emb = _interleave(embed_content(params, src_content), state.ref_tail_emb)
    d, _ = dual_ar.prefill(params["model"], cfg.decoder, state.decode, emb[:, :-1])
    return ARVCState(d, emb[:, -1:], state.ref_tail_emb)


def prefill_history(params: Dict, cfg: ARVCConfig, state: ARVCState,
                    recent_tokens: torch.Tensor, recent_codes: torch.Tensor,
                    delay: int) -> ARVCState:
    """Append b recent (content, audio) frame pairs to a prompt-prefilled
    state: prefill_prompt(ref ++ recent) == prefill_history(prefill_prompt(ref),
    recent).  Written so that it chains: appending the b pairs group by
    group gives the same state, which the background refill relies on."""
    B, b = recent_tokens.shape
    cond = embed_content(params, recent_tokens)
    emb = dual_ar.embed_codes(params["model"], cfg.decoder, recent_codes)
    if delay > 0:
        cat = torch.cat([state.ref_tail_emb, emb], dim=1)  # (B, d+b, D)
        seq = _interleave(cond, cat[:, :b])
        new_tail = cat[:, b:]
        audio_cache = torch.zeros_like(emb[:, :1])
    else:
        # delay 0 prompts end on a cond slot with the last audio slot cached:
        # the continuation re-inserts it first (audio-first interleave)
        seq = _interleave(torch.cat([state.audio_emb, emb[:, : b - 1]], dim=1), cond)
        new_tail = emb[:, :0]
        audio_cache = emb[:, -1:]
    d, _ = dual_ar.prefill(params["model"], cfg.decoder, state.decode, seq)
    return ARVCState(d, audio_cache, new_tail)


def decode_one(params: Dict, cfg: ARVCConfig, state: ARVCState,
               src_content_1: torch.Tensor, sampling: SamplingConfig,
               gumbel_sem: Optional[torch.Tensor] = None,
               gumbel_fast: Optional[torch.Tensor] = None) -> Tuple[ARVCState, torch.Tensor]:
    """One streaming frame: the [audio_emb, new cond] two-token step.
    Returns (state', codes (B, nq)); updates the caches in place."""
    cond = embed_content(params, src_content_1[:, 0])[:, None]
    emb2 = torch.cat([state.audio_emb, cond], dim=1)
    d, _, codes, audio_emb = dual_ar.decode_frame(
        params["model"], cfg.decoder, state.decode, emb2, sampling,
        gumbel_sem, gumbel_fast)
    return ARVCState(d, audio_emb, state.ref_tail_emb), codes


def generate(params: Dict, cfg: ARVCConfig, ref_content: torch.Tensor,
             ref_audio_codes: torch.Tensor, src_content: torch.Tensor,
             style_vec: torch.Tensor, timbre: torch.Tensor,
             sampling: SamplingConfig = SamplingConfig(), delay: int = 2,
             cache_dtype=torch.float32, auto_cache_rows: bool = False,
             generator: Optional[torch.Generator] = None,
             noise: Optional[Sequence[Tuple[Optional[torch.Tensor],
                                            Optional[torch.Tensor]]]] = None
             ) -> torch.Tensor:
    """Full-utterance conversion: codec codes (B, nq, Ts), as the JAX
    package's `arvc.generate`.  Prefills [spk | interleaved reference | the
    first `delay` source conditions | the first remaining condition], takes
    the first frame's codes from the fast stack on the last hidden (its
    semantic sample is discarded), then one `dual_ar.decode_frame` per
    further frame: the slow-step and fast-loop kernels at batch 1 under
    their flags.

    Sampled runs take their Gumbel noise from `noise`, one (semantic,
    codebooks) pair per frame in `dual_ar.frame_noise_shapes`' shapes (the
    first frame's semantic entry is unused), or else draw it on the device
    from `generator`.  With `auto_cache_rows` the KV cache is sized to the
    utterance as the JAX package sizes it; an utterance that needs more
    rows than `max_seq_len` raises, as without it.  With the recorder on
    (`utils/profiling.tracing`) the prefill with the first frame's codes is
    the span `prefill` and each further frame the span `frame`."""
    dcfg = cfg.decoder
    B, Ts = src_content.shape
    dev = src_content.device
    ref_cond = embed_content(params, ref_content)
    src_cond = embed_content(params, src_content)
    spk = spk_condition(params, style_vec, timbre)
    w4s = params["wait4start"][None, :delay].expand(B, -1, -1)
    w4e = params["wait4end"][None, :delay].expand(B, -1, -1)
    ref_emb = torch.cat([w4s, dual_ar.embed_codes(params["model"], dcfg, ref_audio_codes)],
                        dim=1)
    prefill_cond = torch.cat([ref_cond, src_cond[:, :delay]], dim=1)
    remaining = torch.cat([src_cond[:, delay:], w4e], dim=1)  # (B, Ts, D)
    emb_seq = torch.cat([spk, _interleave(prefill_cond, ref_emb), remaining[:, :1]], dim=1)
    L = emb_seq.shape[1]
    rows = L + 2 * (Ts - 1)  # the prefill's rows, then 2 a frame
    need = rows + 2 if auto_cache_rows else rows  # the JAX package's slack
    if need > dcfg.max_seq_len:
        raise ValueError(f"generate: the utterance needs {need} cache rows (a {L}-row "
                         f"prompt and {Ts} frames), more than max_seq_len "
                         f"{dcfg.max_seq_len}")
    if auto_cache_rows:
        dcfg = replace(dcfg, max_seq_len=min(dcfg.max_seq_len, -(-need // 64) * 64))
    shapes = dual_ar.frame_noise_shapes(params["model"], dcfg, sampling, B)

    def frame_noise(f: int):
        if sampling.greedy:
            return None, None
        if noise is not None:
            return noise[f]
        return tuple(gumbel(s, generator, dev) for s in shapes)

    with span("prefill"):
        state = dual_ar.init_state(dcfg, batch=B, cache_dtype=cache_dtype, device=dev,
                                   n_model=model_shards(params["model"]["layers"]))
        state, last = dual_ar.prefill(params["model"], dcfg, state, emb_seq)
        codes, audio_emb, _ = dual_ar.fast_codes(
            params["model"], dcfg, dual_ar._project_fast(params["model"], last),
            frame_noise(0)[1], sampling)
    frames = [codes]
    for f in range(1, Ts):
        with span("frame"):
            emb2 = torch.cat([audio_emb.to(remaining.dtype), remaining[:, f : f + 1]], dim=1)
            state, _, codes, audio_emb = dual_ar.decode_frame(
                params["model"], dcfg, state, emb2, sampling, *frame_noise(f))
        frames.append(codes)
    return torch.stack(frames, dim=-1)


def gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Gumbel noise -log(-log(U)) of `shape`, drawn on `device`."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
