"""Offline voice conversion and the prompt side, as the JAX package's
runtime/pipeline.py: content tokens and codec codes of 44.1 kHz audio, the
(noise-mixed) speaker embeddings from its 16 kHz resampling (CAM++ style
vector over Kaldi fbank, the speaker encoder's timbre latents), the dual-AR
LM's `generate` and the vocoder's offline decode.

`VoiceConverter` holds a `params.Converter` and gives it these entry
points.  The tokenizer and vocoder encode and decode whole utterances in
float32, on the converter's `float32_trees` (the JAX package's matmuls
promote bf16 weights against float32 activations).  `infer` keeps the
noise-free prompt of each reference it has met (style, timbre, codec
codes, content tokens) in a `PromptCache` keyed on the reference's
samples, and mixes the noise in on every call: a dataset's utterances
share a few targets, and a hit gives the same output as a miss.
Random draws (the anonymisation noise, the LM's Gumbel noise) are inputs,
or come from a `torch.Generator` on the converter's device."""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from streamvoiceanon_tpu_torch.audio import fbank as fbank_mod
from streamvoiceanon_tpu_torch.audio.resample import resample
from streamvoiceanon_tpu_torch.config import SamplingConfig
from streamvoiceanon_tpu_torch.models import (arvc, campplus, speaker_encoder, tokenizer,
                                              vocoder)
from streamvoiceanon_tpu_torch.params import Converter
from streamvoiceanon_tpu_torch.utils.profiling import span


def apply_noise_mixing(x: torch.Tensor, alpha: float,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """alpha * x + (1 - alpha) * N(mean(x), std(x)), the standard normal
    draw `noise` (x's shape) or drawn from `generator`."""
    if alpha >= 1.0:
        return x
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device)
    noise = noise.to(x) * torch.std(x, unbiased=False) + torch.mean(x)
    return alpha * x + (1.0 - alpha) * noise


def _mixed(style: torch.Tensor, timbre: torch.Tensor, alpha: float,
           generator: Optional[torch.Generator],
           noise: Optional[Tuple[torch.Tensor, torch.Tensor]]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Style, then timbre, noise-mixed with `alpha` (`noise`: the two
    standard normal draws, else drawn from `generator` in that order)."""
    ns, nt = noise if noise is not None else (None, None)
    return (apply_noise_mixing(style, alpha, generator, ns),
            apply_noise_mixing(timbre, alpha, generator, nt))


def _prompt_key(ref_wavs: Sequence, collate: str):
    """The prompt cache's key of the references: `collate` and, for each
    in order, its dtype, shape and the SHA-1 of its float32 samples as
    `VoiceConverter._tensor` converts them; None if one is a tensor off
    the host (keying it would copy it there and wait for the card)."""
    key = [collate]
    for w in ref_wavs:
        if torch.is_tensor(w):
            if w.device.type != "cpu":
                return None
            dtype, a = w.dtype, w.detach().to(torch.float32).contiguous().numpy()
        else:
            a = np.asarray(w)
            dtype, a = a.dtype, np.ascontiguousarray(a, np.float32)
        key.append((str(dtype).replace("torch.", ""), a.shape, hashlib.sha1(a).digest()))
    return tuple(key)


PROMPT_CACHE_ENTRIES = 64  # references a converter keeps, about 25 KB each at the published widths


class PromptCache:
    """A least-recently-used map of at most PROMPT_CACHE_ENTRIES from a
    reference's key to its noise-free prompt (style, timbre, codes,
    tokens).  `hits` and `misses` count the lookups of every converter in
    the process, as the kernel wrappers count `.launches`; a lookup
    without a key is a miss."""

    hits = 0
    misses = 0

    def __init__(self):
        self.entries: OrderedDict = OrderedDict()

    def get(self, key) -> Optional[Tuple[torch.Tensor, ...]]:
        entry = self.entries.get(key) if key is not None else None
        if entry is None:
            PromptCache.misses += 1
        else:
            PromptCache.hits += 1
            self.entries.move_to_end(key)
        return entry

    def put(self, key, entry: Tuple[torch.Tensor, ...]) -> None:
        self.entries[key] = entry
        while len(self.entries) > PROMPT_CACHE_ENTRIES:
            self.entries.popitem(last=False)


class VoiceConverter:
    """The offline and prompt-side entry points on a converter's trees."""

    def __init__(self, converter: Converter):
        self.converter = converter
        self.cfg = converter.cfg
        self.device = converter.device
        self.prompt_cache = PromptCache()

    def _tensor(self, wav) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(wav, np.float32) if not torch.is_tensor(wav) else wav)
        return t.to(self.device, torch.float32)

    # ------------------------------------------------------------------
    # features
    # ------------------------------------------------------------------

    def content_tokens(self, wav) -> torch.Tensor:
        """wav (B, T) at 44.1 kHz -> content tokens (B, T // 2048) int32."""
        wav = self._tensor(wav)
        spf = self.cfg.samples_per_frame
        return tokenizer.encode(self.converter.float32_trees["tokenizer_params"],
                                self.cfg.tokenizer, wav[..., : wav.shape[-1] // spf * spf])

    def audio_codes(self, wav) -> torch.Tensor:
        """wav (B, T) at 44.1 kHz -> codec codes (B, 8, T // 2048) int32."""
        wav = self._tensor(wav)
        spf = self.cfg.samples_per_frame
        return vocoder.encode(self.converter.float32_trees["vocoder_params"], self.cfg.vocoder,
                              wav[..., : wav.shape[-1] // spf * spf])[0]

    def style_vector(self, wav16k) -> torch.Tensor:
        """The CAM++ style vector (B, 192) of 16 kHz audio."""
        feat = fbank_mod.fbank(self._tensor(wav16k))
        feat = feat - feat.mean(dim=1, keepdim=True)
        lens = torch.full((feat.shape[0],), feat.shape[1] // 2, device=feat.device)
        return campplus.apply(self.converter.campplus_params, self.cfg.campplus, feat, lens)

    def timbre_latents(self, wav16k) -> torch.Tensor:
        """The speaker encoder's timbre latents (B, 32, 128) of 16 kHz audio."""
        wav16k = self._tensor(wav16k)
        lens = torch.full((wav16k.shape[0],), wav16k.shape[-1], device=wav16k.device)
        return speaker_encoder.tokenize_wav(self.converter.speaker_params, self.cfg.speaker, wav16k,
                                            lens)[0]

    def noise_free_embeddings(self, ref_wavs: Sequence, collate: str = "concat_mel"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(style (1, 192), timbre (1, 32, 128)) of one or more references
        before the noise, fused by concatenating the audio ("concat_mel")
        or by averaging per-reference embeddings ("avg")."""
        sr, rr = self.cfg.sample_rate, self.cfg.resample_rate
        if collate == "avg" and len(ref_wavs) > 1:
            styles, timbres = [], []
            for w in ref_wavs:
                w16 = resample(self._tensor(w)[None], sr, rr)
                styles.append(self.style_vector(w16))
                timbres.append(self.timbre_latents(w16))
            return torch.stack(styles).mean(dim=0), torch.stack(timbres).mean(dim=0)
        w16 = resample(torch.cat([self._tensor(w) for w in ref_wavs])[None], sr, rr)
        return self.style_vector(w16), self.timbre_latents(w16)

    def speaker_embeddings(self, ref_wavs: Sequence, alpha: float,
                           generator: Optional[torch.Generator] = None,
                           collate: str = "concat_mel",
                           noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(style, timbre) of one or more references (`noise_free_embeddings`),
        noise-mixed with `alpha` (`noise`: the two standard normal draws,
        else drawn from `generator`)."""
        return _mixed(*self.noise_free_embeddings(ref_wavs, collate), alpha, generator, noise)

    # ------------------------------------------------------------------
    # conversion
    # ------------------------------------------------------------------

    def infer(self, src_wav, ref_wavs: Union[np.ndarray, Sequence[np.ndarray]], *,
              delay: int = 2, alpha: float = 1.0,
              generator: Optional[torch.Generator] = None,
              sampling: Optional[SamplingConfig] = None, collate: str = "concat_mel",
              ref_crop_lengths=None, spk_noise=None, lm_noise=None) -> np.ndarray:
        """Offline conversion of `src_wav` to the voice of `ref_wavs` (44.1
        kHz): the reference prompt cropped to a multiple of 8 frames, the
        source tokens padded to a multiple of 16, then `arvc.generate` and
        the vocoder.  Returns the waveform at 44.1 kHz (numpy).  `spk_noise`
        and `lm_noise` are the random draws of `speaker_embeddings` and
        `arvc.generate`, else drawn from `generator`.  The references'
        noise-free prompt comes from the converter's `prompt_cache` when
        their samples, crop and `collate` have been met before; the noise
        is drawn on every call, so a hit and a miss give the same output.
        With the recorder on (`utils/profiling.tracing`) the call is the
        span `infer`, its stages the spans `prompt`, `encode`, `generate`,
        `vocode` and `to_host` (the host's one wait on the card)."""
        with span("infer"):
            if isinstance(ref_wavs, np.ndarray) or torch.is_tensor(ref_wavs):
                ref_wavs = [ref_wavs]
            if ref_crop_lengths is not None:
                crops = ([ref_crop_lengths] * len(ref_wavs) if np.isscalar(ref_crop_lengths)
                         else ref_crop_lengths)
                ref_wavs = [w[: int(c * self.cfg.sample_rate)] if c is not None else w
                            for w, c in zip(ref_wavs, crops)]
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            sampling = sampling or self.cfg.sampling
            with span("prompt"):
                key = _prompt_key(ref_wavs, collate)
                prompt = self.prompt_cache.get(key)
                if prompt is None:
                    ref_cat = torch.cat([self._tensor(w) for w in ref_wavs])[None]
                    prompt = (*self.noise_free_embeddings(ref_wavs, collate),
                              self.audio_codes(ref_cat), self.content_tokens(ref_cat))
                    if key is not None:
                        self.prompt_cache.put(key, prompt)
                style, timbre, ref_codes, ref_tokens = prompt
                style, timbre = _mixed(style, timbre, alpha, generator, spk_noise)
            with span("encode"):
                src_tokens = self.content_tokens(self._tensor(src_wav)[None])
            Tr = max(ref_tokens.shape[1] // 8 * 8, min(8, ref_tokens.shape[1]))
            ref_tokens, ref_codes = ref_tokens[:, :Tr], ref_codes[:, :, :Tr]
            Ts = src_tokens.shape[1]
            src_tokens = torch.nn.functional.pad(src_tokens, (0, -(-Ts // 16) * 16 - Ts))
            ap = self.converter.arvc_params
            with span("generate"):
                codes = arvc.generate(ap, self.cfg.arvc, ref_tokens, ref_codes,
                                      src_tokens, style.to(ap["embedding"].dtype),
                                      timbre.to(ap["embedding"].dtype), sampling, delay,
                                      generator=generator, noise=lm_noise)
            with span("vocode"):
                wav = vocoder.decode(self.converter.float32_trees["vocoder_params"],
                                     self.cfg.vocoder, codes)
            with span("to_host"):
                return wav[0, : Ts * self.cfg.samples_per_frame].float().cpu().numpy()
