"""The `anonymize` kind (`drivers/anonymize.py`) as the harness's CPU tests
know it: its tiny cut, and its faults, each a token or an answer altered
where it is produced: a frame's codebook codes, a content token, the
output audio, the timbre latents."""

from portbench.tests import converter

tiny_config = converter.tiny_config
check_config = converter.check_config

TINY = {"ref_seconds": 2.0, "warmup_seconds": [0.5], "profile_s": 0.3, "check_utts": 3,
        "lengths": {"count": 4, "mean_s": 1.5, "sigma": 0.3, "min_s": 0.6, "max_s": 2.5}}


def tiny_traffic(tr: dict) -> dict:
    return dict(tr, **TINY)


def codes(mp, root):
    from streamvoiceanon_tpu_torch.models import dual_ar

    orig = dual_ar.fast_codes
    n = {"calls": 0}

    def broken(params, cfg, hidden, g, sampling):
        codes, emb, tr = orig(params, cfg, hidden, g, sampling)
        n["calls"] += 1
        if n["calls"] % 7 == 3:  # one frame in seven: every codebook shifted by one
            codes = (codes + 1) % cfg.codebook_size
            emb = dual_ar.embed_codes(params, cfg, codes[:, :, None])
        return codes, emb, tr
    mp.setattr(dual_ar, "fast_codes", broken)


def audio(mp, root):
    from streamvoiceanon_tpu_torch.models import vocoder

    orig = vocoder.decode
    mp.setattr(vocoder, "decode", lambda *a, **k: orig(*a, **k) * 1.01)


def timbre(mp, root):
    from streamvoiceanon_tpu_torch.runtime import pipeline

    orig = pipeline.VoiceConverter.timbre_latents
    mp.setattr(pipeline.VoiceConverter, "timbre_latents",
               lambda *a, **k: orig(*a, **k) * 1.01)


FAULTS = [codes, converter.content, audio, timbre]
