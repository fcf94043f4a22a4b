"""The port's streaming path against the JAX package on the tiny converter,
on the CPU: the tokenizer stream, the vocoder stream, and the whole
incremental StreamSession across prompt refills.

Each test runs under four program sets: `fast_slow` (use_pallas_slow_decode
and use_pallas_fast_decode on), `tpu_optimized` (also the windowed-
transformer ring kernel with its flat ring, and the fused HiFiGAN head with
its packed state), `all_five` (also the fused ConvNeXt front with its
packed encoder state) and `per_head` (`tpu_optimized` with the per-head
KV cache and the decode-attention kernel in place of the slow step).  JAX
interprets its Pallas kernels on the CPU; the port runs its kernels' plain
versions.
Tokens and codes must be exact.  Waveforms agree to atol = rtol = 1e-4
(XLA on the CPU and ATen sum in different orders) and, because the tiny
random vocoder's output is small, also to 1e-4 of the largest sample.
"""

from dataclasses import replace as drep

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvoiceanon_tpu.config import SamplingConfig, StreamConfig, tpu_optimized
from streamvoiceanon_tpu.models import tokenizer_stream as jts
from streamvoiceanon_tpu.models import vocoder as jvoc
from streamvoiceanon_tpu.runtime.pipeline import VoiceConverter
from streamvoiceanon_tpu.runtime.streaming import StreamSession as JaxSession
from streamvoiceanon_tpu.utils.tiny import tiny_converter
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.models import tokenizer_stream as tts
from streamvoiceanon_tpu_torch.models import vocoder as tvoc
from streamvoiceanon_tpu_torch.ops.convnext_enc import PackedEncState
from streamvoiceanon_tpu_torch.ops.hifigan import PackedHeadState
from streamvoiceanon_tpu_torch.runtime.streaming import StreamSession

TOL = dict(atol=1e-4, rtol=1e-4)
SPF = 2048


def _close_wave(got, ref):
    np.testing.assert_allclose(got, ref, **TOL)
    assert np.max(np.abs(got - ref)) <= 1e-4 * max(np.max(np.abs(ref)), 1e-30)


@pytest.fixture(scope="module")
def tiny():
    return tiny_converter(seed=0)


@pytest.fixture(scope="module", params=["fast_slow", "tpu_optimized", "all_five", "per_head"])
def pair(request, tiny):
    """The JAX tiny converter under one program set, and the port's."""
    cv = tiny
    if request.param != "fast_slow":
        cfg = tpu_optimized(cv.cfg)
        if request.param == "all_five":
            cfg = drep(cfg, tokenizer=drep(cfg.tokenizer, use_pallas_encoder=True))
        elif request.param == "per_head":
            cfg = drep(cfg, arvc=drep(cfg.arvc, decoder=drep(
                cfg.arvc.decoder, use_pallas_slow_decode=False, use_pallas_decode=True)))
    else:
        cfg = drep(cv.cfg, arvc=drep(cv.cfg.arvc, decoder=drep(
            cv.cfg.arvc.decoder, use_pallas_slow_decode=True,
            use_pallas_fast_decode=True)))
    jcv = VoiceConverter(cfg=cfg, tokenizer_params=cv.tokenizer_params,
                         vocoder_params=cv.vocoder_params, arvc_params=cv.arvc_params)
    tonp = lambda t: jax.tree.map(np.asarray, t)
    tcv = P.converter_from_numpy(C.from_fields(cfg), tonp(cv.tokenizer_params),
                                 tonp(cv.vocoder_params), tonp(cv.arvc_params),
                                 device="cpu")
    return jcv, tcv


def test_encode_stream_tokens_exact(pair):
    jcv, tcv = pair
    cfg = jcv.cfg.tokenizer
    wav = (np.random.default_rng(1).standard_normal((1, 6 * SPF)) * 0.1).astype(np.float32)
    js = jts.init_stream_state(jcv.tokenizer_params, cfg)
    ts = tts.init_stream_state(tcv.tokenizer_params, tcv.cfg.tokenizer)
    assert isinstance(ts.backbone, PackedEncState) == cfg.use_pallas_encoder
    jc, tc = jts.mel_consts(cfg.mel), tts.mel_consts(tcv.cfg.tokenizer.mel)
    step = jax.jit(jts.encode_stream, static_argnums=(1,))
    jtok, ttok = [], []
    for i in range(6):
        chunk = wav[:, i * SPF : (i + 1) * SPF]
        js, a = step(jcv.tokenizer_params, cfg, js, jnp.asarray(chunk), jc)
        ts, b = tts.encode_stream(tcv.tokenizer_params, tcv.cfg.tokenizer, ts,
                                  torch.from_numpy(chunk), tc)
        jtok.append(np.asarray(a))
        ttok.append(b.numpy())
    np.testing.assert_array_equal(np.concatenate(ttok, 1), np.concatenate(jtok, 1))
    assert ts.ring.count == int(js.ring.count) == 6
    assert ts.ring.k_ring.ndim == (4 if cfg.transformer.use_pallas_stream else 5)
    np.testing.assert_allclose(ts.ring.k_ring.numpy(), np.asarray(js.ring.k_ring), **TOL)


def test_decode_stream_waveform_matches(pair):
    jcv, tcv = pair
    cfg = jcv.cfg.vocoder
    assert ("head_packed" in tcv.vocoder_params) == cfg.head.use_pallas_stream
    codes = np.random.default_rng(2).integers(0, 1000, (1, 8, 5)).astype(np.int32)
    js = jvoc.init_stream_state(jcv.vocoder_params, cfg)
    ts = tvoc.init_stream_state(tcv.vocoder_params, tcv.cfg.vocoder)
    assert isinstance(ts["head"], PackedHeadState) == cfg.head.use_pallas_stream
    step = jax.jit(jvoc.decode_stream, static_argnums=(1,))
    for i in range(5):
        js, a = step(jcv.vocoder_params, cfg, js, jnp.asarray(codes[:, :, i : i + 1]))
        ts, b = tvoc.decode_stream(tcv.vocoder_params, tcv.cfg.vocoder, ts,
                                   torch.from_numpy(codes[:, :, i : i + 1]))
        assert b.shape == (1, SPF)
        _close_wave(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("delay", [2, 0])
def test_session_matches_jax_across_refills(pair, delay):
    """Both sessions, greedy, same style/timbre/ref tokens/ref codes, stream
    the same chunks across prompt refill boundaries: equal chunks, code and
    token rings, positions and refill counts.  The first boundary is served
    by the background refill (the shadow state swapped in)."""
    jcv, tcv = pair
    rng = np.random.default_rng(3)
    ref = jnp.asarray((rng.standard_normal(4 * SPF) * 0.1).astype(np.float32))[None]
    ref_tokens = np.asarray(jcv.content_tokens(ref))
    ref_codes = np.asarray(jcv.audio_codes(ref))
    style = rng.standard_normal((1, 192)).astype(np.float32)
    timbre = rng.standard_normal((1, 32, 128)).astype(np.float32)
    scfg = StreamConfig(max_prompt_frames=8, max_seq_frames=28, buffer_frames=4,
                        delay=delay)
    js = JaxSession(jcv, scfg, key=jax.random.PRNGKey(1),
                    sampling=SamplingConfig(greedy=True), style=jnp.asarray(style),
                    timbre=jnp.asarray(timbre), ref_tokens=jnp.asarray(ref_tokens),
                    ref_codes=jnp.asarray(ref_codes))
    ts = StreamSession(tcv, C.from_fields(scfg), style=style, timbre=timbre,
                       ref_tokens=ref_tokens, ref_codes=ref_codes,
                       sampling=C.SamplingConfig(greedy=True))
    assert ts._lm_pos_host == js._lm_pos_host
    swaps = []
    finish = ts._finish_refill

    def spy():
        swaps.append(ts._shadow is not None
                     and ts._shadow_appended == scfg.buffer_frames)
        finish()

    ts._finish_refill = spy
    src = (rng.standard_normal(12 * SPF) * 0.1).astype(np.float32)
    for i in range(12):
        chunk = src[i * SPF : (i + 1) * SPF]
        a, b = js.process_chunk(chunk), ts.process_chunk(chunk)
        assert b.shape == (SPF,)
        _close_wave(b, np.asarray(a))
        assert ts._lm_pos_host == js._lm_pos_host
        assert ts.refill_count == js.refill_count
        np.testing.assert_array_equal(ts.fstate.code_ring.numpy(),
                                      np.asarray(js.fstate.code_ring))
        np.testing.assert_array_equal(ts.fstate.tok_ring.numpy(),
                                      np.asarray(js.fstate.tok_ring))
    assert ts.refill_count >= 2 and swaps[0]
    assert ts.frames_decoded == js.frames_decoded
    assert ts.fstate.lm.decode.k_cache.ndim == (4 if tcv.cfg.arvc.decoder.use_pallas_slow_decode
                                                else 5)
    assert ts.truncation_count == js.truncation_count == 0
