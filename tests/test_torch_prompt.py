"""The port's prompt side against the JAX package on the CPU: the 16 kHz
resampler, Kaldi fbank, CAM++, the speaker encoder's timbre path, the
anonymisation noise mixing and `speaker_embeddings` (both collates).

Seeded numpy inputs and tiny configs (the CAM++ and speaker configs of
tests/test_eval_harness.py), the random weights of each package's
`utils/randparams.py` (the same draws from the same seed).  Tolerances:

* resampling: atol 1e-5 (both are one strided conv of float32 taps);
* fbank: the mel energies within 1e-5 of the largest and 1e-4 relative,
  the log-mel within 3e-4: the log of a mel bin whose energy comes from a
  sum of cancelling terms (pre-emphasis and DC removal leave little in
  the lowest bins) magnifies float32 rounding, and JAX's own features lie
  up to 1.5e-4 from a float64 evaluation; the port is also held within
  1e-4 of that float64 evaluation;
* CAM++ and the speaker latents: atol 1e-4, FSQ indices equal;
* noise mixing and `speaker_embeddings` with JAX's normal draws fed in:
  atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvoiceanon_tpu.audio import fbank as jfb
from streamvoiceanon_tpu.audio import resample as jrs
from streamvoiceanon_tpu.config import CAMPPlusConfig, SpeakerEncoderConfig
from streamvoiceanon_tpu.models import campplus as jcp
from streamvoiceanon_tpu.models import speaker_encoder as jspk
from streamvoiceanon_tpu.runtime import pipeline as jpipe
from streamvoiceanon_tpu.utils import randparams as jrp
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.audio import fbank as tfb
from streamvoiceanon_tpu_torch.audio import resample as trs
from streamvoiceanon_tpu_torch.models import campplus as tcp
from streamvoiceanon_tpu_torch.models import speaker_encoder as tspk
from streamvoiceanon_tpu_torch.runtime import pipeline as tpipe
from streamvoiceanon_tpu_torch.utils import randparams as trp

CP = CAMPPlusConfig(embedding_size=192, growth_rate=8, bn_size=2, init_channels=16,
                    block_layers=(2, 2), block_kernels=(3, 3), block_dilations=(1, 2))
SPK = SpeakerEncoderConfig(ecapa_channels=64)
TOL = dict(atol=1e-4, rtol=1e-4)


def _voice(seed: int, n: int, f0: float) -> np.ndarray:
    """A seeded synthetic voice at 44.1 kHz: harmonics of f0 plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    wav = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.28)) / h for h in range(1, 6))
    return (0.1 * wav + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_random_trees_equal_the_jax_package():
    """The port's own copies of the random CAM++ and speaker trees draw the
    same weights from the same seed."""
    for jt, tt in ((jrp.campplus_params_np(CP, 5), trp.campplus_params_np(C.from_fields(CP), 5)),
                   (jrp.speaker_encoder_params_np(SPK, 6),
                    trp.speaker_encoder_params_np(C.from_fields(SPK), 6))):
        ja, jd = jax.tree.flatten(jt)
        ta, td = jax.tree.flatten(tt)
        assert jd == td
        for a, b in zip(ta, ja):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [44100, 30011])
def test_resample_matches_jax(n):
    wav = np.stack([_voice(1, n, 140.0), _voice(2, n, 210.0)])
    a = np.asarray(jrs.resample(jnp.asarray(wav), 44100, 16000))
    b = trs.resample(_t(wav), 44100, 16000).numpy()
    assert a.shape == b.shape == (2, int(np.ceil(n * 160 / 441)))
    np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)


def _fbank_f64(w: np.ndarray) -> np.ndarray:
    """Kaldi fbank in float64 from the same window and filters."""
    win, hop, padded = 400, 160, 512
    x = w.astype(np.float64)
    m = 1 + (x.shape[1] - win) // hop
    fr = x[:, np.arange(m)[:, None] * hop + np.arange(win)[None]]
    fr = fr - fr.mean(-1, keepdims=True)
    fr = fr - 0.97 * np.concatenate([fr[..., :1], fr[..., :-1]], -1)
    fr = np.pad(fr * tfb.povey_window(win), ((0, 0), (0, 0), (0, padded - win)))
    c, s = (m_.astype(np.float64) for m_ in tfb._dft_mats(padded))
    p = (fr @ c) ** 2 + (fr @ s) ** 2
    return np.log(np.maximum(p @ tfb.kaldi_mel_banks(80, padded, 16000.0), 2.2e-16))


def test_fbank_matches_jax():
    w16 = trs.resample(_t(np.stack([_voice(3, 44100, 120.0), _voice(4, 44100, 190.0)])),
                       44100, 16000).numpy()
    a = np.asarray(jfb.fbank(jnp.asarray(w16)))
    b = tfb.fbank(_t(w16)).numpy()
    assert a.shape == b.shape == (2, 98, 80)
    np.testing.assert_allclose(np.exp(b), np.exp(a), atol=1e-5 * np.exp(a).max(), rtol=1e-4)
    np.testing.assert_allclose(b, a, atol=3e-4, rtol=0)
    assert np.abs(b - _fbank_f64(w16)).max() <= 1e-4


@pytest.fixture(scope="module")
def speakers():
    """(JAX trees, port trees) of the tiny CAM++ and speaker encoder."""
    cp, sp = jrp.campplus_params_np(CP, 5), jrp.speaker_encoder_params_np(SPK, 6)
    return (jax.tree.map(jnp.asarray, cp), jax.tree.map(jnp.asarray, sp),
            P.campplus_params(cp, "cpu"), P.speaker_params(sp, "cpu"))


def test_campplus_matches_jax(speakers):
    jc, _, tc, _ = speakers
    rng = np.random.default_rng(7)
    feat = rng.standard_normal((2, 150, 80)).astype(np.float32)
    feat -= feat.mean(axis=1, keepdims=True)
    lens = np.array([75, 60], np.int32)
    a = np.asarray(jcp.apply(jc, CP, jnp.asarray(feat), jnp.asarray(lens)))
    b = tcp.apply(tc, C.from_fields(CP), _t(feat), _t(lens)).numpy()
    assert b.shape == (2, 192)
    np.testing.assert_allclose(b, a, **TOL)


def test_tokenize_wav_matches_jax(speakers):
    _, js, _, ts = speakers
    w16 = trs.resample(_t(np.stack([_voice(5, 30000, 150.0), _voice(6, 30000, 230.0)])),
                       44100, 16000).numpy()
    lens = np.array([w16.shape[1], w16.shape[1] - 3000], np.int32)
    jz, ji = jspk.tokenize_wav(js, SPK, jnp.asarray(w16), jnp.asarray(lens))
    tz, ti = tspk.tokenize_wav(ts, C.from_fields(SPK), _t(w16), _t(lens))
    assert tz.shape == (2, 32, 128) and ti.shape == (2, 32, 1)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_noise_mixing_with_jax_noise():
    x = np.random.default_rng(8).standard_normal((2, 32, 128)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    for alpha in (1.0, 0.5, 0.0):
        a = np.asarray(jpipe.apply_noise_mixing(key, jnp.asarray(x), alpha))
        b = tpipe.apply_noise_mixing(_t(x), alpha, noise=_t(noise)).numpy()
        np.testing.assert_allclose(b, a, **TOL)


@pytest.fixture(scope="module")
def converters(speakers):
    """Converters of both packages holding the tiny speaker models (the
    speaker path reads no other tree)."""
    from streamvoiceanon_tpu.config import replace as jreplace
    from streamvoiceanon_tpu.utils.tiny import tiny_config

    jc, js, tc, ts = speakers
    jcfg = jreplace(tiny_config(), campplus=CP, speaker=SPK)
    jcv = jpipe.VoiceConverter(cfg=jcfg, tokenizer_params={}, vocoder_params={},
                               arvc_params={}, campplus_params=jc, speaker_params=js)
    tcv = tpipe.VoiceConverter(P.Converter(cfg=C.from_fields(jcfg), tokenizer_params={},
                                           vocoder_params={}, arvc_params={},
                                           device=torch.device("cpu"), campplus_params=tc,
                                           speaker_params=ts))
    return jcv, tcv


@pytest.mark.parametrize("collate", ["concat_mel", "avg"])
@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_speaker_embeddings_match_jax(converters, collate, alpha):
    jcv, tcv = converters
    refs = [_voice(9, 30000, 130.0), _voice(10, 26000, 200.0)]
    key = jax.random.PRNGKey(11)
    js, jt = jcv.speaker_embeddings(refs, alpha, key, collate)
    k1, k2 = jax.random.split(key)
    noise = (_t(np.asarray(jax.random.normal(k1, js.shape, jnp.float32))),
             _t(np.asarray(jax.random.normal(k2, jt.shape, jnp.float32))))
    ts, tt = tcv.speaker_embeddings(refs, alpha, collate=collate, noise=noise)
    assert ts.shape == (1, 192) and tt.shape == (1, 32, 128)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)


def test_wav_io_matches_jax(tmp_path):
    """write_wav then read_wav (to 16 kHz, through each package's own
    resampler) as the JAX package's audio/io.py does."""
    from streamvoiceanon_tpu.audio import io as jio
    from streamvoiceanon_tpu_torch.audio import io as tio

    wav = _voice(12, 20000, 170.0)
    path = str(tmp_path / "ref.wav")
    tio.write_wav(path, wav, 44100)
    a, sa = jio.read_wav(path, target_sr=16000)
    b, sb = tio.read_wav(path, target_sr=16000)
    assert sa == sb == 16000 and b.shape == a.shape
    np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
    raw, sr = tio.read_wav(path)
    jraw, jsr = jio.read_wav(path)
    assert sr == jsr == 44100
    np.testing.assert_array_equal(raw, jraw)
    assert np.max(np.abs(raw - wav)) <= 2e-4  # 16-bit: scaled by 32767, read by 32768
