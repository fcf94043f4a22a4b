"""Streaming voice conversion: the batch-1 incremental `StreamSession`.

As `streamvoiceanon_tpu.runtime.streaming` in incremental mode.  Each chunk
of 2048 samples (one frame) runs three stages:

1. incremental content encode (`tokenizer_stream.encode_stream`): one
   content token;
2. the LM frame decode (`arvc.decode_one` -> `dual_ar.decode_frame`: the
   slow-step kernel, or the layer loop (on the per-head decode-attention
   kernel or plain) and the windowed sampler; then the fast loop, on its
   kernel or plain, as the decoder's flags say), then the
   incremental vocoder
   (`vocoder.decode_stream`): 2048 output samples;
3. host logic: silence while the first `delay` tokens accumulate, a
   one-time delay prefill, and the periodic prompt refill when the LM
   position reaches `max_seq_frames` — the fast refill appends the recent
   history to a stashed post-prompt state, and the background refill builds
   that state one chunk at a time over the window before the boundary, so
   the boundary chunk only swaps it in.

The prompt comes from reference audio (`runtime/pipeline.py`: speaker
embeddings, codes and content tokens) or precomputed.  The position
trajectory is deterministic, so refills are scheduled from host counters
with no device read-back.  Sampling noise (and the anonymisation noise of
the speaker embeddings) is drawn on the device from the session's
`torch.Generator`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from streamvoiceanon_tpu_torch.config import SamplingConfig, StreamConfig
from streamvoiceanon_tpu_torch.models import arvc, dual_ar, tokenizer_stream, vocoder
from streamvoiceanon_tpu_torch.params import Converter
from streamvoiceanon_tpu_torch.runtime.pipeline import VoiceConverter


class FusedState(NamedTuple):
    tok: tokenizer_stream.TokenizerStreamState
    lm: arvc.ARVCState
    voc: Dict
    tok_ring: torch.Tensor  # (B, R) recent content tokens (refill history)
    code_ring: torch.Tensor  # (B, nq, R) recent decoded codes (refill history)


def _own_caches(st: arvc.ARVCState) -> arvc.ARVCState:
    """A copy of `st` whose KV caches the frame decode may update in place."""
    d = st.decode
    return st._replace(decode=d._replace(k_cache=d.k_cache.clone(),
                                         v_cache=d.v_cache.clone()))


class StreamSession:
    """One real-time conversion stream at batch 1.

    Usage:
        sess = StreamSession(converter, stream_cfg, ref_wavs)
        # or StreamSession(converter, stream_cfg, style=..., timbre=...,
        #                  ref_tokens=..., ref_codes=...)
        for chunk in chunks_of_2048_samples:
            out = sess.process_chunk(chunk)   # (2048 * k,) samples
    """

    def __init__(
        self,
        converter: Converter,
        scfg: Optional[StreamConfig] = None,
        ref_wavs=None,
        *,
        style=None,
        timbre=None,
        ref_tokens=None,
        ref_codes=None,
        sampling: Optional[SamplingConfig] = None,
        seed: int = 0,
        state_dtype=torch.float32,
        spk_noise=None,
    ):
        """The prompt comes from `ref_wavs` (one 44.1 kHz reference or a
        list): its speaker embeddings, noise-mixed with `scfg.alpha`
        (`spk_noise`: the two standard normal draws, else drawn from the
        session's generator), and the codes and content tokens of the
        concatenated references; or precomputed, as `style`, `timbre`,
        `ref_tokens` and `ref_codes`.  `state_dtype` is that of the LM KV
        cache and of the tokenizer's and vocoder's stream tails (the
        ConvNeXt front's, the ring's, the head's), as in the JAX package;
        bf16 is its serving point."""
        self.cv = converter
        self.cfg = converter.cfg
        self.scfg = scfg or self.cfg.stream
        self.sampling = sampling or self.cfg.sampling
        self.device = converter.device
        self.spf = self.cfg.samples_per_frame
        self.delay = self.scfg.delay
        self.state_dtype = state_dtype
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        lm_dtype = converter.arvc_params["embedding"].dtype
        dev = self.device
        if ref_wavs is not None:
            vc = VoiceConverter(converter)
            wavs = list(ref_wavs) if isinstance(ref_wavs, (list, tuple)) else [ref_wavs]
            style, timbre = vc.speaker_embeddings(wavs, self.scfg.alpha, self.generator,
                                                  noise=spk_noise)
            cat = torch.cat([vc._tensor(w) for w in wavs])[None]
            ref_codes = vc.audio_codes(cat)
            ref_tokens = vc.content_tokens(cat)
        if any(x is None for x in (style, timbre, ref_tokens, ref_codes)):
            raise ValueError("StreamSession: give ref_wavs, or style, timbre, ref_tokens "
                             "and ref_codes")
        on = lambda x: (x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))).to(dev)
        mp = self.scfg.max_prompt_frames
        self.ref_tokens = on(ref_tokens)[:, :mp]
        self.ref_codes = on(ref_codes)[:, :, :mp]
        self.style = on(style).float().to(lm_dtype)
        self.timbre = on(timbre).float().to(lm_dtype)
        if self.ref_tokens.shape[0] != 1:
            raise NotImplementedError("StreamSession supports batch 1")
        self.Tp = self.ref_tokens.shape[1]

        lm_state = self._prefill_prompt(self.ref_tokens, self.ref_codes)
        self._lm_pos_host = lm_state.decode.pos
        # the post-prompt state, stashed for the fast refill; the live state
        # gets its own caches because the frame decode updates them in place
        self._base_lm = lm_state if self.scfg.fast_refill else None
        self._base_pos_host = self._lm_pos_host
        self._shadow = None
        self._shadow_appended = 0

        k = self.scfg.decode_chunk_frames
        self.tok_ring_len = self.scfg.buffer_frames + max(self.delay, 1) + k + 8
        self.tokens_seen = 0
        self.frames_decoded = 0
        self.refill_count = 0
        self.delay_prefilled = self.delay == 0
        self._mel_consts = tokenizer_stream.mel_consts(self.cfg.tokenizer.mel, dev)
        nq = self.cfg.arvc.decoder.num_codebooks
        self.fstate = FusedState(
            tok=tokenizer_stream.init_stream_state(
                converter.tokenizer_params, self.cfg.tokenizer, 1, state_dtype, dev),
            lm=_own_caches(lm_state),
            voc=vocoder.init_stream_state(
                converter.vocoder_params, self.cfg.vocoder, 1, state_dtype, dev),
            tok_ring=torch.zeros((1, self.tok_ring_len), dtype=torch.int32, device=dev),
            code_ring=torch.zeros((1, nq, self.tok_ring_len), dtype=torch.int32,
                                  device=dev),
        )

    # ------------------------------------------------------------------
    # LM programs
    # ------------------------------------------------------------------

    def _prefill_prompt(self, tokens, codes) -> arvc.ARVCState:
        return arvc.prefill_prompt(self.cv.arvc_params, self.cfg.arvc, tokens, codes,
                                   self.style, self.timbre, self.delay,
                                   self.state_dtype)

    def _prefill_delay(self, lm: arvc.ARVCState) -> arvc.ARVCState:
        return arvc.prefill_src_condition4delay(
            self.cv.arvc_params, self.cfg.arvc, lm,
            self.fstate.tok_ring[:, -self.delay :], self.delay)

    def _prefill_history(self, base: arvc.ARVCState, n: int) -> arvc.ARVCState:
        return arvc.prefill_history(self.cv.arvc_params, self.cfg.arvc, base,
                                    self._recent_tokens(n), self._recent_codes(n),
                                    self.delay)

    def _noise(self):
        """Gumbel rows for one frame, -log(-log(U)) drawn on the device, in
        the shapes `dual_ar.frame_noise_shapes` gives: over the sampling
        window where the windowed sampler runs, over the vocabulary where
        a kernel's exact sampler does."""
        if self.sampling.greedy:
            return None, None
        sem, fast = dual_ar.frame_noise_shapes(self.cv.arvc_params["model"],
                                               self.cfg.arvc.decoder, self.sampling, 1)

        return (arvc.gumbel(sem, self.generator, self.device),
                arvc.gumbel(fast, self.generator, self.device))

    @property
    def truncation_count(self) -> int:
        """Nucleus-truncation events of the windowed semantic sampler (its
        top-k window held less than top_p of the probability) carried by the
        live LM state; as in the JAX package, a prompt refill swaps in a
        state that carries the count of the post-prompt state.  Reading it
        waits for the device."""
        return int(self.fstate.lm.decode.trunc)

    # ------------------------------------------------------------------
    # the chunk step
    # ------------------------------------------------------------------

    def process_chunk(self, chunk) -> np.ndarray:
        """One chunk of decode_chunk_frames * 2048 samples in, as many out
        (zeros while the delay fills)."""
        return self._process_chunk_incremental(chunk).float().cpu().numpy()[0]

    def _process_chunk_incremental(self, chunk) -> torch.Tensor:
        k = self.scfg.decode_chunk_frames
        n = k * self.spf
        chunk = torch.as_tensor(np.asarray(chunk, np.float32), device=self.device)
        tstate, toks = tokenizer_stream.encode_stream(
            self.cv.tokenizer_params, self.cfg.tokenizer, self.fstate.tok,
            chunk.reshape(1, n), self._mel_consts)
        ring = torch.cat([self.fstate.tok_ring[:, toks.shape[1]:], toks], dim=1)
        self.fstate = self.fstate._replace(tok=tstate, tok_ring=ring)
        self.tokens_seen += k

        if self.tokens_seen <= self.delay or not self.delay_prefilled:
            if self.tokens_seen >= self.delay and not self.delay_prefilled:
                self.fstate = self.fstate._replace(lm=self._prefill_delay(self.fstate.lm))
                self._lm_pos_host += 2 * self.delay - 1
                self.delay_prefilled = True
            return torch.zeros((1, n), dtype=torch.float32, device=self.device)

        lm = self.fstate.lm
        frames = []
        for t in range(toks.shape[1]):
            gs, gf = self._noise()
            lm, codes = arvc.decode_one(self.cv.arvc_params, self.cfg.arvc, lm,
                                        toks[:, t : t + 1], self.sampling, gs, gf)
            frames.append(codes)
        codes = torch.stack(frames, dim=-1)  # (1, nq, k)
        code_ring = torch.cat([self.fstate.code_ring[:, :, k:], codes], dim=-1)
        voc, wav = vocoder.decode_stream(self.cv.vocoder_params, self.cfg.vocoder,
                                         self.fstate.voc, codes)
        self.fstate = self.fstate._replace(lm=lm, code_ring=code_ring, voc=voc)
        self.frames_decoded += k
        self._lm_pos_host += 2 * k
        r = self._lm_pos_host // 2
        msf = self.scfg.max_seq_frames
        b = self.scfg.buffer_frames
        if self._base_lm is not None and self.scfg.background_refill and b % k == 0:
            # the chunks whose end position r satisfies r_swap - r < b form
            # the refill window: append this chunk's k pairs to the shadow
            rem = msf - r
            if rem <= 0 or (-(-rem // k)) * k < b:
                if self._shadow is None:
                    self._shadow, self._shadow_appended = self._base_lm, 0
                self._shadow = self._prefill_history(self._shadow, k)
                self._shadow_appended += k
            elif self._shadow is not None:
                self._shadow, self._shadow_appended = None, 0
        if r >= msf:
            self._finish_refill()
        return wav

    def _finish_refill(self):
        """Boundary chunk: swap in the background shadow if it holds exactly
        buffer_frames appended pairs (it then is the refilled state), else
        run the one-shot refill."""
        self.refill_count += 1
        b = self.scfg.buffer_frames
        if self._shadow is not None and self._shadow_appended == b:
            lm = self._shadow
            self._lm_pos_host = self._base_pos_host + 2 * b
            if self.delay > 0:
                lm = self._prefill_delay(lm)
                self._lm_pos_host += 2 * self.delay - 1
            self.fstate = self.fstate._replace(lm=lm)
        else:
            self._refill_incremental()
        self._shadow, self._shadow_appended = None, 0

    def _refill_incremental(self):
        b = self.scfg.buffer_frames
        if self._base_lm is not None:
            lm = self._prefill_history(self._base_lm, b)
        else:
            lm = self._prefill_prompt(
                torch.cat([self.ref_tokens, self._recent_tokens(b)], dim=-1),
                torch.cat([self.ref_codes, self._recent_codes(b)], dim=-1))
        self._lm_pos_host = self._base_pos_host + 2 * b
        if self.delay > 0:
            lm = self._prefill_delay(lm)
            self._lm_pos_host += 2 * self.delay - 1
        self.fstate = self.fstate._replace(lm=lm)

    def _recent_tokens(self, b):
        if self.delay > 0:
            return self.fstate.tok_ring[:, -b - self.delay : -self.delay]
        return self.fstate.tok_ring[:, -b:]

    def _recent_codes(self, b):
        return self.fstate.code_ring[:, :, -b:]
