"""The timed path broken underneath a whole tiny run on the CPU: `correct`
comes out false.  In the anonymization cell the fault is a token or an
answer altered where it is produced: a frame's codebook codes, a content
token, the output audio, the timbre latents.  In the training cell: a step
that returns its state unchanged (from the first step, or only in the
window), half of the batch left out with the mean taken over the rest, and
a content token altered in the features."""

import json

import pytest
import torch

from portbench.run import run_cell
from portbench.tests import tiny

BENCH = tiny.bench()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_root(tmp_path_factory.mktemp("pb"))


def _codes(mp):
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


def _content(mp):
    from streamvoiceanon_tpu_torch.models import tokenizer

    orig = tokenizer.encode
    mp.setattr(tokenizer, "encode", lambda *a, **k: orig(*a, **k) ^ 1)


def _audio(mp):
    from streamvoiceanon_tpu_torch.models import vocoder

    orig = vocoder.decode
    mp.setattr(vocoder, "decode", lambda *a, **k: orig(*a, **k) * 1.01)


def _timbre(mp):
    from streamvoiceanon_tpu_torch.runtime import pipeline

    orig = pipeline.VoiceConverter.timbre_latents
    mp.setattr(pipeline.VoiceConverter, "timbre_latents",
               lambda *a, **k: orig(*a, **k) * 1.01)


def _unchanged(mp):
    from streamvoiceanon_tpu_torch.train import muon

    mp.setattr(muon, "apply_updates", lambda params, updates: None)


def _unchanged_after_setup(mp):
    """Steps past the set-up's checked ones return their state unchanged, as
    a fault that sets in once the program is warm would."""
    from streamvoiceanon_tpu_torch.train import muon

    orig, n = muon.apply_updates, {"calls": 0}

    def late(params, updates):
        n["calls"] += 1
        if n["calls"] <= 3:
            orig(params, updates)
    mp.setattr(muon, "apply_updates", late)


def _half_batch(mp):
    from streamvoiceanon_tpu_torch.models import arvc

    orig = arvc.forward_train

    def half(params, cfg, content, base, target, x_lens, style, timbre, delay, **k):
        h = max(1, content.shape[0] // 2)
        return orig(params, cfg, content[:h], base[:h], target[:h], x_lens[:h], style[:h],
                    timbre[:h], delay, **k)
    mp.setattr(arvc, "forward_train", half)


FAULTS = {"anonymize": [_codes, _content, _audio, _timbre],
          "train": [_unchanged, _unchanged_after_setup, _half_batch, _content]}
CASES = [(w["name"], f) for w in BENCH["workloads"]
         for f in FAULTS[json.loads((tiny.REPO / "portbench" / "traffic" /
                                     f"{w['traffic']}.json").read_text())["driver"]]]


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{n}-{f.__name__[1:]}" for n, f in CASES])
def test_fault_is_caught(root, name, fault, monkeypatch):
    fault(monkeypatch)
    res = run_cell(BENCH, name, 2 ** 36 + 9, 2.0, False, "cpu", root=root)
    assert not res["correct"], res["checks"]
