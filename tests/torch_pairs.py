"""Shared helpers of the port's serving tests (tests/test_torch_serving.py,
test_torch_realtime.py, test_torch_live.py): the tiny converter's geometry
on both packages with each package's seeded random weights
(`utils/randparams.py`: the same draws), the tiny CAM++ and speaker encoder
of tests/test_eval_harness.py included, and a precomputed prompt."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from streamvoiceanon_tpu import config as JC
from streamvoiceanon_tpu.runtime.pipeline import VoiceConverter as JaxConverter
from streamvoiceanon_tpu.utils.tiny import tiny_config
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.utils import randparams as trp

SPF = 2048
TOL = dict(atol=1e-4, rtol=1e-4)
CP = JC.CAMPPlusConfig(embedding_size=192, growth_rate=8, bn_size=2, init_channels=16,
                       block_layers=(2, 2), block_kernels=(3, 3), block_dilations=(1, 2))
SPK = JC.SpeakerEncoderConfig(ecapa_channels=64)
JCFG = JC.replace(tiny_config(), campplus=CP, speaker=SPK)


def close_wave(got, ref):
    """Within atol = rtol = 1e-4 (XLA on the CPU and ATen sum in other
    orders) and within 1e-4 of the largest sample."""
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    assert np.max(np.abs(got - ref)) <= 1e-4 * max(np.max(np.abs(ref)), 1e-30)


@functools.lru_cache(maxsize=1)
def trees():
    tcfg = C.from_fields(JCFG)
    return {"tokenizer_params": trp.tokenizer_params_np(tcfg.tokenizer, 1),
            "vocoder_params": trp.vocoder_params_np(tcfg.vocoder, 2),
            "arvc_params": trp.arvc_params_np(tcfg.arvc, 3),
            "campplus_params": trp.campplus_params_np(tcfg.campplus, 5),
            "speaker_params": trp.speaker_encoder_params_np(tcfg.speaker, 6)}


def pair(jcfg=JCFG):
    """(JAX converter, port converter on the CPU) under `jcfg`."""
    t = trees()
    jcv = JaxConverter(cfg=jcfg, **jax.tree.map(jnp.asarray, t))
    tcv = P.converter_from_numpy(
        C.from_fields(jcfg), t["tokenizer_params"], t["vocoder_params"], t["arvc_params"],
        device="cpu", campplus_np=t["campplus_params"], speaker_np=t["speaker_params"])
    return jcv, tcv


def per_head(jcfg=JCFG):
    t = JC.tpu_optimized(jcfg)
    return JC.replace(t, arvc=JC.replace(t.arvc, decoder=JC.replace(
        t.arvc.decoder, use_pallas_slow_decode=False, use_pallas_decode=True)))


def prompt(jcv, seed: int = 0, batch: int = 1, frames: int = 4):
    """A precomputed prompt of `batch` rows as numpy arrays: (style, timbre,
    ref_tokens, ref_codes), the tokens and codes of a random reference (the
    same for every row), style and timbre random per row."""
    rng = np.random.default_rng(seed)
    ref = jnp.asarray((rng.standard_normal((1, frames * SPF)) * 0.1).astype(np.float32))
    tokens = np.repeat(np.asarray(jcv.content_tokens(ref)), batch, 0)
    codes = np.repeat(np.asarray(jcv.audio_codes(ref)), batch, 0)
    style = rng.standard_normal((batch, 192)).astype(np.float32)
    timbre = rng.standard_normal((batch, 32, 128)).astype(np.float32)
    return style, timbre, tokens, codes


def source(seed: int, frames: int, batch: int = 0) -> np.ndarray:
    """Seeded noise at 0.1: (frames * 2048,) or (batch, frames * 2048)."""
    shape = (batch, frames * SPF) if batch else (frames * SPF,)
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


def chunk(x: np.ndarray, i: int) -> np.ndarray:
    return x[..., i * SPF : (i + 1) * SPF]


GREEDY = JC.SamplingConfig(greedy=True)
TGREEDY = C.SamplingConfig(greedy=True)
SAMPLED = C.SamplingConfig(temperature=0.9, top_p=0.7, greedy=False, top_k_window=64)
