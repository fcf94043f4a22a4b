"""Batched offline conversion over a mesh of ranks, as the JAX package's
parallel/serving.py: utterances are bucketed by frame length, padded to the
bucket, and the whole [tokenize -> generate -> vocode] pipeline runs on the
batch.  `arvc.generate` sizes the KV cache to the bucket
(`auto_cache_rows`); at batch > 1, and on a model-sharded LM, the slow-step
and fast-loop kernels (batch 1, whole stacks) give way to the layer loop,
on the decode-attention kernel over the rank's B x H / n_model heads under
`per_head_decode`.

Over the mesh (`parallel/mesh.py`): the batch is split over 'data' when it
divides by n_data and replicated otherwise, the LM is split over 'model',
the tokenizer and vocoder are replicated, and the converted batch is
gathered back to every rank.  With no process group the mesh is this
process's one device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from streamvoiceanon_tpu_torch.config import SamplingConfig
from streamvoiceanon_tpu_torch.models import arvc, tokenizer, vocoder
from streamvoiceanon_tpu_torch.parallel import mesh as meshlib
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
    """Data- and model-parallel conversion server over a mesh (the mesh of
    the initialized process group with `n_model` ranks to a model group
    unless given; one device without a process group).  Every rank calls
    `convert` with the same whole batch and gets the whole result."""

    def __init__(self, converter: Converter, n_model: int = 1,
                 mesh: Optional[meshlib.Mesh] = None):
        self.mesh = mesh if mesh is not None else meshlib.make_mesh(
            n_model=n_model, device=converter.device)
        self.cv = converter
        if self.mesh.n_model > 1:
            arvc_params = converter.arvc_params
            self.cv = dataclasses.replace(converter, arvc_params=meshlib.shard_params(
                arvc_params, self.mesh, meshlib.dual_ar_param_specs(arvc_params),
                converter.cfg.arvc))

    def convert(self, src_wavs: np.ndarray, ref_tokens, ref_codes, style, timbre, *,
                sampling: SamplingConfig = SamplingConfig(), delay: int = 2,
                cache_dtype=torch.float32, seed: int = 0) -> np.ndarray:
        """src_wavs (B, T), one bucket padded to one length; the prompt of
        each row.  `cache_dtype` is the KV cache's: float32 equals the
        unbatched generate, bf16 halves the cache reads.  Sampled runs draw
        their noise from a generator seeded with `seed` (the same on every
        rank, so that the ranks of a model group draw alike)."""
        dev = self.mesh.device
        tree = [torch.as_tensor(np.asarray(x), dtype=dt) for x, dt in (
            (src_wavs, torch.float32), (ref_tokens, None), (ref_codes, None),
            (style, torch.float32), (timbre, torch.float32))]
        split = self.mesh.data_group is not None and len(tree[0]) % self.mesh.n_data == 0
        tree = (meshlib.shard_batch(tree, self.mesh) if split
                else meshlib.replicate(tree, self.mesh))
        gen = None if sampling.greedy else torch.Generator(device=dev).manual_seed(seed)
        wav = _convert_batch(self.cv, *tree, sampling, delay, cache_dtype, gen)
        if split:
            wav = meshlib.all_gather_cat(wav, self.mesh.data_group, 0)
        return wav.float().cpu().numpy()
