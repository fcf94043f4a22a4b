"""The port's offline pipeline and its audio-started stream against the
JAX package on the CPU, on the tiny converter's geometry with each
package's seeded random weights (`utils/randparams.py`: the same draws)
and the tiny CAM++ and speaker encoder of tests/test_eval_harness.py:

* `windowed_transformer.apply` with and without the LConv1d (`dw_conv`)
  branch, and the streaming `dw_conv` ring step against JAX's;
* `tokenizer.encode` tokens and `vocoder.encode` codes equal;
  `vocoder.decode` waveforms within atol 1e-4 and 1e-4 of the largest
  sample;
* `arvc.generate` greedy and sampled, JAX's noise reproduced from its key
  splits: codes equal; the `auto_cache_rows` refusal;
* `VoiceConverter.infer` waveforms close;
* `StreamSession(ref_wavs=...)` under `fast_slow_config` and
  `tpu_optimized` in float32: outputs equal token for token, waveforms
  close; and at the JAX package's serving point (bf16 tokenizer and
  vocoder weights, bf16 state), where both sides round to bf16 at the same
  points but sum in other orders: the prompt exact, the streamed waveform
  within 0.05 of the largest sample.

Float32 tolerances are XLA's and ATen's summation orders (atol = rtol =
1e-4); tokens and codes are exact.
"""

from dataclasses import replace as drep

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvoiceanon_tpu import config as JC
from streamvoiceanon_tpu.models import arvc as jarvc
from streamvoiceanon_tpu.models import tokenizer as jtok
from streamvoiceanon_tpu.models import tokenizer_stream as jts
from streamvoiceanon_tpu.models import vocoder as jvoc
from streamvoiceanon_tpu.models import windowed_transformer as jwt
from streamvoiceanon_tpu.runtime.pipeline import VoiceConverter as JaxConverter
from streamvoiceanon_tpu.runtime.streaming import StreamSession as JaxSession
from streamvoiceanon_tpu.utils.tiny import tiny_config
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.models import arvc as tarvc
from streamvoiceanon_tpu_torch.models import tokenizer as ttok
from streamvoiceanon_tpu_torch.models import tokenizer_stream as tts
from streamvoiceanon_tpu_torch.models import vocoder as tvoc
from streamvoiceanon_tpu_torch.models import windowed_transformer as twt
from streamvoiceanon_tpu_torch.runtime.pipeline import VoiceConverter
from streamvoiceanon_tpu_torch.runtime.streaming import StreamSession
from streamvoiceanon_tpu_torch.utils import randparams as trp

TOL = dict(atol=1e-4, rtol=1e-4)
SPF = 2048
CP = JC.CAMPPlusConfig(embedding_size=192, growth_rate=8, bn_size=2, init_channels=16,
                       block_layers=(2, 2), block_kernels=(3, 3), block_dilations=(1, 2))
SPK = JC.SpeakerEncoderConfig(ecapa_channels=64)
JCFG = JC.replace(tiny_config(), campplus=CP, speaker=SPK)
GREEDY = JC.SamplingConfig(greedy=True)
SAMPLED = JC.SamplingConfig(temperature=0.9, top_p=0.7, greedy=False, top_k_window=64)


def _voice(seed: int, n: int, f0: float) -> np.ndarray:
    """A seeded synthetic voice at 44.1 kHz: harmonics of f0 plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    wav = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.28)) / h for h in range(1, 6))
    return (0.1 * wav + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _trees():
    tcfg = C.from_fields(JCFG)
    return {"tokenizer_params": trp.tokenizer_params_np(tcfg.tokenizer, 1),
            "vocoder_params": trp.vocoder_params_np(tcfg.vocoder, 2),
            "arvc_params": trp.arvc_params_np(tcfg.arvc, 3),
            "campplus_params": trp.campplus_params_np(tcfg.campplus, 5),
            "speaker_params": trp.speaker_encoder_params_np(tcfg.speaker, 6)}


def _pair(jcfg, dsp=None):
    """(JAX converter, port converter) under `jcfg`, the tokenizer and
    vocoder weights in `dsp` (float32 unless given: bf16 is the serving
    point) on both sides."""
    trees = _trees()
    if dsp is not None:
        for k in ("tokenizer_params", "vocoder_params"):
            trees[k] = jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(dsp)), trees[k])
    jcv = JaxConverter(cfg=jcfg, **jax.tree.map(jnp.asarray, trees))
    tcv = P.converter_from_numpy(
        C.from_fields(jcfg), trees["tokenizer_params"], trees["vocoder_params"],
        trees["arvc_params"], device="cpu",
        dsp_dtype=torch.bfloat16 if dsp is not None else torch.float32,
        campplus_np=trees["campplus_params"], speaker_np=trees["speaker_params"])
    return jcv, tcv


@pytest.fixture(scope="module")
def pair():
    return _pair(JCFG)


@pytest.mark.parametrize("dw_conv", [False, True])
def test_windowed_transformer_matches_jax(dw_conv):
    wcfg = drep(JCFG.tokenizer.transformer, n_layer=2, dw_conv=dw_conv, window_size=8)
    jp = jwt.init(jax.random.PRNGKey(4), wcfg)
    jp = jax.tree.map(lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(5), a.shape), jp)
    tp = P.windowed_transformer_params(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(1).standard_normal((2, 20, wcfg.dim)).astype(np.float32)
    a = np.asarray(jwt.apply(jp, wcfg, jnp.asarray(x)))
    b = twt.apply(tp, C.from_fields(wcfg), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(b, a, **TOL)


def test_dw_conv_ring_matches_jax_and_offline():
    """The streaming LConv1d branch: the ring carries its conv tail, token
    by token as JAX's, and equals the offline transformer."""
    wcfg = drep(JCFG.tokenizer.transformer, n_layer=2, dw_conv=True, window_size=8)
    tcfg = C.from_fields(wcfg)
    jp = jwt.init(jax.random.PRNGKey(6), wcfg)
    jp = jax.tree.map(lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(7), a.shape), jp)
    tp = P.windowed_transformer_params(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(2).standard_normal((1, 12, wcfg.dim)).astype(np.float32)
    js, ts = jts.ring_init(wcfg), tts.ring_init(tcfg)
    assert ts.conv_tail.shape == (2, 1, wcfg.conv_kernel_size - 1, wcfg.dim)
    outs = []
    for t in range(x.shape[1]):
        js, a = jts.transformer_stream_step(jp, wcfg, js, jnp.asarray(x[:, t : t + 1]))
        ts, b = tts.transformer_stream_step(tp, tcfg, ts, torch.from_numpy(x[:, t : t + 1]))
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
        np.testing.assert_allclose(ts.conv_tail.numpy(), np.asarray(js.conv_tail), **TOL)
        outs.append(b.numpy())
    offline = twt.apply(tp, tcfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.concatenate(outs, 1), offline, **TOL)


def test_encoders_and_decode_match_jax(pair):
    jcv, tcv = pair
    wav = np.stack([_voice(1, 6 * SPF, 140.0), _voice(2, 6 * SPF, 220.0)])
    np.testing.assert_array_equal(VoiceConverter(tcv).content_tokens(wav).numpy(),
                                  np.asarray(jtok.encode(jcv.tokenizer_params, JCFG.tokenizer,
                                                         jnp.asarray(wav))))
    jcodes, jq = jvoc.encode(jcv.vocoder_params, JCFG.vocoder, jnp.asarray(wav))
    tcodes, tq = tvoc.encode(tcv.vocoder_params, tcv.cfg.vocoder, torch.from_numpy(wav))
    assert tcodes.shape == (2, 8, 6)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    a = np.asarray(jvoc.decode(jcv.vocoder_params, JCFG.vocoder, jcodes))
    b = tvoc.decode(tcv.vocoder_params, tcv.cfg.vocoder, tcodes).numpy()
    assert b.shape == (2, 6 * SPF)
    np.testing.assert_allclose(b, a, **TOL)
    assert np.abs(b - a).max() <= 1e-4 * np.abs(a).max()


def _gumbel(key, n):
    return np.asarray(jax.random.gumbel(key, (n,), jnp.float32))


def _frame_noise(key, sem_shape, fast_shape):
    """The Gumbel rows JAX's decode_frame draws from `key` (its windowed
    samplers), in the port's shapes: semantic row b from split(k_sem, B)[b],
    codebook step s from split(split(k_fast, nq)[s], B)[b]."""
    (b, n_sem), (_, nq, n_fast) = sem_shape, fast_shape
    k_sem, k_fast = jax.random.split(key)
    gs = np.stack([_gumbel(k, n_sem) for k in jax.random.split(k_sem, b)])
    gf = np.stack([np.stack([_gumbel(k, n_fast) for k in jax.random.split(ks, b)])
                   for ks in jax.random.split(k_fast, nq)], axis=1)
    return torch.from_numpy(gs), torch.from_numpy(gf)


def _prompt(seed, Tr=6, Ts=5, B=1):
    d = JCFG.arvc.decoder
    rng = np.random.default_rng(seed)
    return (rng.integers(0, d.vocab_size, (B, Tr)).astype(np.int32),
            rng.integers(0, d.codebook_size, (B, d.num_codebooks, Tr)).astype(np.int32),
            rng.integers(0, d.vocab_size, (B, Ts)).astype(np.int32),
            rng.standard_normal((B, 192)).astype(np.float32),
            rng.standard_normal((B, 32, 128)).astype(np.float32))


@pytest.mark.parametrize("sampling", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_generate_matches_jax(pair, sampling):
    jcv, tcv = pair
    args = _prompt(3)
    key = jax.random.PRNGKey(21)
    want = np.asarray(jarvc.generate(jcv.arvc_params, JCFG.arvc, *map(jnp.asarray, args),
                                     key, sampling, 2))
    noise = None
    tsamp = C.from_fields(sampling)
    if not sampling.greedy:
        # JAX: key -> (key, k0); the first frame's codebooks from k0's
        # k_fast; then key -> (key, sub) a frame
        shapes = tarvc.dual_ar.frame_noise_shapes(tcv.arvc_params["model"],
                                                  tcv.cfg.arvc.decoder, tsamp, 1)
        key, k0 = jax.random.split(key)
        noise = [_frame_noise(k0, *shapes)]
        for _ in range(args[2].shape[1] - 1):
            key, sub = jax.random.split(key)
            noise.append(_frame_noise(sub, *shapes))
    for auto in (False, True):
        got = tarvc.generate(tcv.arvc_params, tcv.cfg.arvc, *map(torch.from_numpy, args),
                             tsamp, 2, auto_cache_rows=auto, noise=noise)
        assert got.shape == (1, 8, args[2].shape[1])
        np.testing.assert_array_equal(got.numpy(), want)


def test_generate_refuses_what_the_cache_cannot_hold(pair):
    """JAX clamps the cache to max_seq_len and writes past it; the port
    raises, with auto_cache_rows and without."""
    _, tcv = pair
    rows = tcv.cfg.arvc.decoder.max_seq_len
    args = _prompt(4, Tr=6, Ts=rows // 2)
    for auto in (False, True):
        with pytest.raises(ValueError, match="cache rows"):
            tarvc.generate(tcv.arvc_params, tcv.cfg.arvc, *map(torch.from_numpy, args),
                           C.from_fields(GREEDY), 2, auto_cache_rows=auto)


def test_infer_matches_jax(pair):
    jcv, tcv = pair
    src = _voice(5, 5 * SPF + 700, 160.0)
    refs = [_voice(6, 6 * SPF, 120.0), _voice(7, 4 * SPF, 240.0)]
    a = jcv.infer(src, refs, delay=2, key=jax.random.PRNGKey(2))
    b = VoiceConverter(tcv).infer(src, refs, delay=2)
    assert b.shape == a.shape == (5 * SPF,)
    np.testing.assert_allclose(b, a, **TOL)
    assert np.abs(b - a).max() <= 1e-4 * np.abs(a).max()


def _sessions(jcfg, dsp=None, state=jnp.float32, chunks=10):
    """Both packages' StreamSession from the same reference audio, greedy,
    streaming the same source: (JAX outputs, port outputs, the sessions)."""
    jcv, tcv = _pair(jcfg, dsp)
    scfg = JC.StreamConfig(max_prompt_frames=8, max_seq_frames=28, buffer_frames=4, delay=2)
    ref = _voice(8, 10 * SPF, 130.0)
    js = JaxSession(jcv, scfg, [ref], key=jax.random.PRNGKey(1), sampling=GREEDY,
                    state_dtype=state)
    ts = StreamSession(tcv, C.from_fields(scfg), [ref], sampling=C.from_fields(GREEDY),
                       state_dtype=torch.bfloat16 if state == jnp.bfloat16 else torch.float32)
    src = _voice(9, chunks * SPF, 180.0)
    outs = [(np.asarray(js.process_chunk(src[i * SPF : (i + 1) * SPF]), np.float32),
             ts.process_chunk(src[i * SPF : (i + 1) * SPF]).astype(np.float32))
            for i in range(chunks)]
    return outs, js, ts


@pytest.mark.parametrize("program", ["fast_slow", "tpu_optimized"])
def test_session_from_ref_wavs_matches_jax(program):
    if program == "tpu_optimized":
        jcfg = JC.tpu_optimized(JCFG)
    else:
        jcfg = drep(JCFG, arvc=drep(JCFG.arvc, decoder=drep(
            JCFG.arvc.decoder, use_pallas_slow_decode=True, use_pallas_fast_decode=True)))
    outs, js, ts = _sessions(jcfg)
    np.testing.assert_array_equal(ts.ref_tokens.numpy(), np.asarray(js.ref_tokens))
    np.testing.assert_array_equal(ts.ref_codes.numpy(), np.asarray(js.ref_codes))
    np.testing.assert_allclose(ts.style.numpy(), np.asarray(js.style), **TOL)
    np.testing.assert_allclose(ts.timbre.numpy(), np.asarray(js.timbre), **TOL)
    np.testing.assert_array_equal(ts.fstate.tok_ring.numpy(), np.asarray(js.fstate.tok_ring))
    np.testing.assert_array_equal(ts.fstate.code_ring.numpy(), np.asarray(js.fstate.code_ring))
    for a, b in outs:
        np.testing.assert_allclose(b, a, **TOL)
        assert np.abs(b - a).max() <= 1e-4 * max(np.abs(a).max(), 1e-30)
    assert ts.refill_count == js.refill_count > 0


def test_session_at_the_bf16_serving_point():
    """tpu_optimized with bf16 tokenizer and vocoder weights and bf16 state
    on both sides (the head and front tails in bf16 through their plain
    versions here): the prompt (float32 encoders over the bf16 weights) is
    exact, the stream's content tokens and codes agree, and the waveform
    stays within 0.05 of its largest sample."""
    jcfg = drep(JC.tpu_optimized(JCFG), tokenizer=drep(JC.tpu_optimized(JCFG).tokenizer,
                                                       use_pallas_encoder=True))
    outs, js, ts = _sessions(jcfg, dsp=jnp.bfloat16, state=jnp.bfloat16)
    np.testing.assert_array_equal(ts.ref_tokens.numpy(), np.asarray(js.ref_tokens))
    np.testing.assert_array_equal(ts.ref_codes.numpy(), np.asarray(js.ref_codes))
    assert ts.fstate.tok.backbone.stem.dtype == torch.bfloat16
    assert ts.fstate.voc["head"].pre.dtype == torch.bfloat16
    np.testing.assert_array_equal(ts.fstate.tok_ring.numpy(), np.asarray(js.fstate.tok_ring))
    np.testing.assert_array_equal(ts.fstate.code_ring.numpy(), np.asarray(js.fstate.code_ring))
    a = np.concatenate([o[0] for o in outs])
    b = np.concatenate([o[1] for o in outs])
    assert np.abs(b - a).max() <= 0.05 * np.abs(a).max()
