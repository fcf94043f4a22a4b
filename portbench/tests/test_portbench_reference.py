"""The plain reference equals the port's plain path at a tiny size."""


import numpy as np
import pytest
import torch

from portbench import core, voice
from portbench.drivers import common
from portbench.reference import codec, lm, nn as rnn, speaker
from portbench.tests import converter


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    cfg = core.load_json(core.ROOT / "configs" / "sva-convert.json")
    cfg["pipeline"] = converter.tiny_pipeline(cfg["pipeline"])
    cfg["dtypes"] = dict(cfg["dtypes"], lm="float32")
    trees = common.draw_trees(cfg, 2 ** 33 + 1, "cpu")
    cv = common.converter(cfg, trees, "cpu")
    from streamvoiceanon_tpu_torch.runtime.pipeline import VoiceConverter

    return cfg, trees, cv, VoiceConverter(cv), rnn.ns(cfg["pipeline"])


def test_content_tokens_and_codes(setup):
    cfg, trees, cv, vc, c = setup
    wav = torch.from_numpy(voice.voice(1.5, 3, 0))[None]
    with torch.no_grad():
        tok, _ = codec.content_tokens(trees["tokenizer"], c.tokenizer, wav[:, :wav.shape[1] // 2048 * 2048])
        codes = codec.codec_encode(trees["vocoder"], c.vocoder, wav[:, :wav.shape[1] // 2048 * 2048])
        assert torch.equal(tok, vc.content_tokens(wav))
        assert torch.equal(codes, vc.audio_codes(wav))


def test_decode(setup):
    cfg, trees, cv, vc, c = setup
    from streamvoiceanon_tpu_torch.models import vocoder

    codes = torch.randint(0, 1000, (1, 8, 6), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = vocoder.decode(cv.float32_trees["vocoder_params"], cv.cfg.vocoder, codes)
        want = codec.codec_decode(trees["vocoder"], c.vocoder, codes)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-7)


def test_speaker_embeddings(setup):
    cfg, trees, cv, vc, c = setup
    ref = voice.voice(1.5, 4, 0)
    g = torch.Generator().manual_seed(5)
    noise = (torch.randn((1, 192), generator=g), torch.randn((1, 32, 128), generator=g))
    with torch.no_grad():
        s, t = vc.speaker_embeddings([ref], 0.7, noise=noise)
        rs, rt = speaker.speaker_embeddings(trees["campplus"], trees["speaker"], c,
                                            torch.from_numpy(ref), 0.7, noise)
    np.testing.assert_allclose(s.numpy(), rs.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t.numpy(), rt.numpy(), rtol=1e-4, atol=1e-5)


def test_lm_follows_generate(setup):
    """Greedy `generate` of the port; the reference's logits over the same
    prompt and served codes put every served code first."""
    cfg, trees, cv, vc, c = setup
    from streamvoiceanon_tpu_torch.config import SamplingConfig
    from streamvoiceanon_tpu_torch.models import arvc

    d = c.arvc.decoder
    g = torch.Generator().manual_seed(1)
    rt = torch.randint(0, 8192, (1, 8), generator=g, dtype=torch.int32)
    rc = torch.randint(0, 1000, (1, 8, 8), generator=g, dtype=torch.int32)
    st = torch.randint(0, 8192, (1, 16), generator=g, dtype=torch.int32)
    style, tim = torch.randn(1, 192, generator=g), torch.randn(1, 32, 128, generator=g)
    with torch.no_grad():
        codes = arvc.generate(cv.arvc_params, cv.cfg.arvc, rt, rc, st, style, tim,
                              SamplingConfig(greedy=True), delay=2)
        hid = lm.frame_hidden(trees["arvc"], d, style, tim, torch.cat([rt, st], 1),
                              torch.cat([rc, codes], -1), 2, 8, 16, wait4end=2)
        logits = lm.codebook_logits(trees["arvc"], d, hid[0], codes[0].t())
        gap = lm.served_gap(logits, torch.zeros_like(logits), codes[0].t(), 1.0, 1.0, 0.0)
    assert float(gap.max()) < 1e-4
