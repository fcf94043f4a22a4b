"""Batched offline conversion on one card, as the JAX package's
parallel/serving.py: utterances are bucketed by frame length, padded to the
bucket, and the whole [tokenize -> generate -> vocode] pipeline runs on the
batch.  `arvc.generate` sizes the KV cache to the bucket
(`auto_cache_rows`); at batch > 1 the slow-step and fast-loop kernels (batch
1 only) give way to the plain layers, on the decode-attention kernel over
B x H heads under `per_head_decode`.

The JAX package spreads the batch over a device mesh; the port's mesh
(`parallel/mesh.py`, several cards through `torch.distributed`) is still
to come, so `BatchServer` serves on the converter's one device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from streamvoiceanon_tpu_torch.config import SamplingConfig
from streamvoiceanon_tpu_torch.models import arvc, tokenizer, vocoder
from streamvoiceanon_tpu_torch.params import Converter


def bucket_by_frames(lengths: Sequence[int],
                     bucket_sizes: Sequence[int]) -> Dict[int, List[int]]:
    """Groups utterance indices into the smallest bucket >= their frame
    length."""
    out: Dict[int, List[int]] = {b: [] for b in bucket_sizes}
    for i, L in enumerate(lengths):
        for b in bucket_sizes:
            if L <= b:
                out[b].append(i)
                break
        else:
            raise ValueError(f"utterance of {L} frames exceeds largest bucket")
    return {b: idx for b, idx in out.items() if idx}


def _convert_batch(cv: Converter, src_wavs: torch.Tensor, ref_tokens: torch.Tensor,
                   ref_codes: torch.Tensor, style: torch.Tensor, timbre: torch.Tensor,
                   sampling: SamplingConfig, delay: int, cache_dtype,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B, T) source waves -> (B, T) converted waves."""
    f32 = cv.float32_trees
    src_tokens = tokenizer.encode(f32["tokenizer_params"], cv.cfg.tokenizer, src_wavs)
    wd = cv.arvc_params["embedding"].dtype
    codes = arvc.generate(cv.arvc_params, cv.cfg.arvc, ref_tokens, ref_codes, src_tokens,
                          style.to(wd), timbre.to(wd), sampling, delay,
                          cache_dtype=cache_dtype, auto_cache_rows=True,
                          generator=generator)
    return vocoder.decode(f32["vocoder_params"], cv.cfg.vocoder, codes)


class BatchServer:
    """Batched conversion server on the converter's device."""

    def __init__(self, converter: Converter, n_model: int = 1):
        if n_model != 1:
            raise NotImplementedError(
                "BatchServer: sharding the LM over several cards waits for the port of "
                "parallel/mesh.py")
        self.cv = converter

    def convert(self, src_wavs: np.ndarray, ref_tokens, ref_codes, style, timbre, *,
                sampling: SamplingConfig = SamplingConfig(), delay: int = 2,
                cache_dtype=torch.float32, seed: int = 0) -> np.ndarray:
        """src_wavs (B, T), one bucket padded to one length; the prompt of
        each row.  `cache_dtype` is the KV cache's: float32 equals the
        unbatched generate, bf16 halves the cache reads.  Sampled runs draw
        their noise from a generator seeded with `seed`."""
        dev = self.cv.device
        on = lambda x, dt=None: torch.as_tensor(np.asarray(x), dtype=dt).to(dev)
        gen = None if sampling.greedy else torch.Generator(device=dev).manual_seed(seed)
        wav = _convert_batch(self.cv, on(src_wavs, torch.float32), on(ref_tokens),
                             on(ref_codes), on(style, torch.float32),
                             on(timbre, torch.float32), sampling, delay, cache_dtype, gen)
        return wav.float().cpu().numpy()
