"""The port's ASR_eval recognisers against the JAX package's, on the CPU
at tiny sizes: the compact character-CTC recogniser
(`evals/asr_eval_train.py`), the conformer CTC recogniser
(`evals/asr_eval_w2v.py`) and `cli evaluate --asr-train-dirs` with both.

Both sides start from JAX's initial draws (fed to the port's `init_*`
functions by monkeypatching) and train on the same numpy batch draws.
Losses per step within 1e-4 relative; vocabularies, transcripts,
hypotheses and WER rows equal; trained parameters within 1e-4 of
max(each leaf's largest value, 1), as `_close_trained` in
`tests/test_torch_asr_train.py` sets out.
"""

from __future__ import annotations

import functools
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from streamvoiceanon_tpu import cli as jcli
from streamvoiceanon_tpu.audio.io import write_wav
from streamvoiceanon_tpu.evals import asr_eval_train as jaet
from streamvoiceanon_tpu.evals import asr_eval_w2v as jaw
from streamvoiceanon_tpu.evals.anonymize import Utterance as JUtt
from streamvoiceanon_tpu_torch import cli
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.evals import asr_eval_train as taet
from streamvoiceanon_tpu_torch.evals import asr_eval_w2v as taw
from streamvoiceanon_tpu_torch.evals import kaldi as tkaldi
from streamvoiceanon_tpu_torch.evals.anonymize import Utterance as TUtt
from streamvoiceanon_tpu_torch.utils.tree import flatten
from tests.test_torch_asr_train import (REL, _close_trained, _np, grads_by_step,
                                         recorded_jax_grads)

SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the ASR_eval recognisers
# ---------------------------------------------------------------------------


WORDS = ("one two three", "four five", "six seven eight nine", "ten")


def _speech(text: str, seed: int, seconds: float = 1.2) -> np.ndarray:
    """A voiced signal whose pitch and loudness follow the characters of
    `text`, so that the recognisers have something to fit."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    seg = np.minimum((np.arange(n) * len(text)) // n, len(text) - 1)
    f0 = np.array([100.0 + 7.0 * (ord(text[i]) - 96) for i in seg])
    phase = 2 * np.pi * np.cumsum(f0) / SR
    w = sum(np.sin(h * phase) / h for h in range(1, 5)) * (0.2 + 0.1 * np.sin(3 * t))
    return (w + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _utts():
    out, texts = [], {}
    for i, text in enumerate(WORDS * 2):
        u = f"u{i}"
        out.append((u, f"s{i % 3}", _speech(text, i)))
        texts[u] = text
    return out, texts


def _transcripts(transcriber, utts):
    return [transcriber(w, SR) for _, _, w in utts]


def test_compact_recogniser_trains_and_transcribes_as_jax(monkeypatch):
    """Four steps; the key bias of each layer (the middle third of its qkv
    bias) has a gradient that is rounding, which `_close_trained` finds."""
    utts, texts = _utts()
    cfg = jaet.ASREvalConfig(steps=4, batch_size=4)
    jh, th = [], []
    records = recorded_jax_grads(monkeypatch)
    jp, jvocab = jaet.train_asr_eval([JUtt(*u) for u in utts], texts, cfg, history=jh)
    init_j = _np(jaet.init_params(jax.random.PRNGKey(cfg.seed), cfg, len(jvocab)))
    init = P.asr_eval_params(init_j, "cpu")
    monkeypatch.setattr(taet, "init_params", lambda g, c, v: init)
    tcfg = taet.ASREvalConfig(**vars(cfg))
    tp, tvocab = taet.train_asr_eval([TUtt(*u) for u in utts], texts, tcfg, history=th,
                                     device="cpu")
    assert tvocab == jvocab and len(th) == len(jh) == 4
    np.testing.assert_allclose(th, jh, rtol=REL)
    bridge = functools.partial(P.asr_eval_params, device="cpu")
    _close_trained(flatten(tp), flatten(bridge(_np(jp))),
                   grads_by_step(records, init_j, 1, bridge), lambda k: cfg.lr, cfg.steps,
                   "compact")
    assert (_transcripts(taet.make_transcriber(tp, tvocab, tcfg), utts)
            == _transcripts(jaet.make_transcriber(jp, jvocab, cfg), utts))


def test_w2v_recogniser_trains_and_transcribes_as_jax(monkeypatch):
    """The tiny conformer recogniser, its encoder at a tenth of the head's
    learning rate (the two AdamW groups)."""
    utts, texts = _utts()
    cfg = jaw.W2VASRConfig(steps=3, batch_size=4, encoder_lr_scale=0.1)
    jh, th = [], []
    records = recorded_jax_grads(monkeypatch)
    jp, jvocab = jaw.train_asr_eval_w2v([JUtt(*u) for u in utts], texts, cfg, history=jh)
    init_j = _np(jaw.init_asr_params(jax.random.PRNGKey(cfg.seed), cfg, len(jvocab)))
    init = P.asr_eval_w2v_params(init_j, "cpu")
    start = {k: v.clone() for k, v in flatten(init).items()}
    monkeypatch.setattr(taw, "init_asr_params", lambda g, c, v, encoder_params=None: init)
    tcfg = taw.W2VASRConfig(encoder=taw.w2v.W2VBertConfig(**vars(cfg.encoder)),
                            **{k: v for k, v in vars(cfg).items() if k != "encoder"})
    tp, tvocab = taw.train_asr_eval_w2v([TUtt(*u) for u in utts], texts, tcfg, history=th,
                                        device="cpu")
    assert tvocab == jvocab and len(th) == len(jh) == 3
    np.testing.assert_allclose(th, jh, rtol=REL)
    bridge = functools.partial(P.asr_eval_w2v_params, device="cpu")
    key_bias = ("encoder", "layers", "attn", "k", "b")
    _close_trained(flatten(tp), flatten(bridge(_np(jp))),
                   grads_by_step(records, init_j, 2, bridge),
                   lambda k: cfg.lr * (cfg.encoder_lr_scale if k[0] == "encoder" else 1.0),
                   cfg.steps, "w2v", rounding=(key_bias,), init=start)
    assert (_transcripts(taw.make_transcriber_w2v(tp, tvocab, tcfg), utts)
            == _transcripts(jaw.make_transcriber_w2v(jp, jvocab, cfg), utts))


# ---------------------------------------------------------------------------
# cli evaluate --asr-train-dirs
# ---------------------------------------------------------------------------


def _kaldi_dirs(root: Path):
    """`train` (the recognisers' data), `dev` and `dev_anon` (the scored
    sets) with wav.scp, utt2spk and text."""
    utts, texts = _utts()
    for name, keep in (("train", lambda i: True), ("dev", lambda i: i < 4),
                       ("dev_anon", lambda i: i >= 4)):
        d = root / "data" / name
        scp, u2s, text = {}, {}, {}
        for i, (u, spk, w) in enumerate(utts):
            if keep(i):
                p = root / "wavs" / f"{u}.wav"
                p.parent.mkdir(parents=True, exist_ok=True)
                write_wav(str(p), w, SR)
                uid = f"{u}_{name}" if name != "train" else u
                scp[uid], u2s[uid], text[uid] = str(p), spk, texts[u]
        for fname, table in (("wav.scp", scp), ("utt2spk", u2s), ("text", text)):
            tkaldi.save_kaldi_format(table, d / fname)


@pytest.mark.parametrize("model", ["compact", "w2v"])
def test_cli_evaluate_trains_a_recogniser_as_jax(tmp_path, monkeypatch, model):
    """Both CLIs train the `--asr-model` recogniser on `train` (a few steps,
    from JAX's initial draws) and score `dev` and `dev_anon` with it: the
    same WER rows and the same hypotheses."""
    _kaldi_dirs(tmp_path)
    if model == "compact":
        cfg = jaet.ASREvalConfig(steps=3, batch_size=4)
        monkeypatch.setattr(jaet, "train_asr_eval",
                            functools.partial(jaet.train_asr_eval, cfg=cfg))
        monkeypatch.setattr(taet, "train_asr_eval", functools.partial(
            taet.train_asr_eval, cfg=taet.ASREvalConfig(**vars(cfg))))
        monkeypatch.setattr(taet, "init_params", lambda g, c, v: P.asr_eval_params(
            _np(jaet.init_params(jax.random.PRNGKey(0), cfg, v)), "cpu"))
    else:
        cfg = jaw.W2VASRConfig(steps=2, batch_size=4)
        monkeypatch.setattr(jaw, "train_asr_eval_w2v",
                            functools.partial(jaw.train_asr_eval_w2v, cfg=cfg))
        monkeypatch.setattr(taw, "train_asr_eval_w2v", functools.partial(
            taw.train_asr_eval_w2v, cfg=taw.W2VASRConfig(steps=2, batch_size=4)))
        monkeypatch.setattr(taw, "init_asr_params", lambda g, c, v, encoder_params=None:
                            P.asr_eval_w2v_params(_np(jaw.init_asr_params(
                                jax.random.PRNGKey(0), cfg, v)), "cpu"))
    argv = ["evaluate", "--data-dir", str(tmp_path / "data"), "--asr-datasets", "dev",
            "--asr-train-dirs", "train", "--asr-model", model, "--sample-rate", str(SR)]
    jcli.main(argv + ["--results-dir", str(tmp_path / "rj")])
    rows = cli.main(argv + ["--results-dir", str(tmp_path / "rt"), "--device", "cpu"])["asr"]
    want = pd.read_csv(tmp_path / "rj" / "asr" / "results_anon.csv", index_col=0)
    assert [r["WER"] for r in rows] == list(want["WER"])
    assert [(r["dataset"], r["split"], r["asr"]) for r in rows] == list(
        zip(want["dataset"], want["split"], want["asr"]))
    for s in ("dev", "dev_anon"):
        assert (tkaldi.read_kaldi_format(tmp_path / "rt" / "asr" / s / "text")
                == tkaldi.read_kaldi_format(tmp_path / "rj" / "asr" / s / "text")), s
