"""The port's evals (streamvoiceanon_tpu_torch/evals/) against the JAX
package's, on the CPU at tiny sizes.

Tolerances:
* the numpy metrics (privacy_metrics, plda, kaldi, wer) are the same code
  on the same inputs: within 1e-9;
* CAM++ embeddings (`speaker_embeddings`): within 1e-4 of the largest;
* three training steps (`asv_train` with the backbone frozen and trained,
  `ecapa_asv` with its BatchNorm statistics, `ser.train_head`) from JAX's
  initial draws (fed in through the weight bridge) and JAX's numpy
  batches: each loss within 1e-4 relative, every parameter after them
  within 1e-4 of its leaf's largest value (the port's step is eager
  autograd, JAX's one jitted `value_and_grad`: they agree to float32
  rounding, not bit for bit);
* tables: the same columns in the same order, strings equal, numbers
  within 1e-9 where they come from numpy on equal inputs, and within one
  unit of their rounding (EER 1e-3, min-Cllr and linkability 1e-4) where
  they come from embeddings; the CSVs parse back to the same rows;
* anonymized waveforms: within atol = rtol = 1e-4 (the offline converter's
  tolerance), with JAX's per-speaker noise fed in.
"""

from __future__ import annotations

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from streamvoiceanon_tpu.audio.io import write_wav
from streamvoiceanon_tpu.evals import anonymize as janon
from streamvoiceanon_tpu.evals import asv_train as jat
from streamvoiceanon_tpu.evals import ecapa_asv as jea
from streamvoiceanon_tpu.evals import harness as jh
from streamvoiceanon_tpu.evals import kaldi as jkaldi
from streamvoiceanon_tpu.evals import plda as jplda
from streamvoiceanon_tpu.evals import privacy_metrics as jpm
from streamvoiceanon_tpu.evals import ser as jser
from streamvoiceanon_tpu.evals import wer as jwer
from streamvoiceanon_tpu_torch import cli
from streamvoiceanon_tpu_torch import config as C
from streamvoiceanon_tpu_torch import params as P
from streamvoiceanon_tpu_torch.evals import anonymize as tanon
from streamvoiceanon_tpu_torch.evals import asv_train as tat
from streamvoiceanon_tpu_torch.evals import ecapa_asv as tea
from streamvoiceanon_tpu_torch.evals import harness as th
from streamvoiceanon_tpu_torch.evals import kaldi as tkaldi
from streamvoiceanon_tpu_torch.evals import plda as tplda
from streamvoiceanon_tpu_torch.evals import privacy_metrics as tpm
from streamvoiceanon_tpu_torch.evals import ser as tser
from streamvoiceanon_tpu_torch.evals import tables
from streamvoiceanon_tpu_torch.evals import wer as twer
from streamvoiceanon_tpu_torch.runtime.pipeline import VoiceConverter
from tests.torch_pairs import CP, JCFG, pair, trees

SR = 16000
REL = 1e-4
ROUNDING = {"EER": 1e-3, "cllr_min": 1e-4, "linkability": 1e-4}
TINY_ECAPA = dict(channels=16, latent_dim=48, attn_dim=8, se_dim=8, emb_dim=16,
                  batch_size=4, chunk_seconds=0.5, steps=3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch and for numpy's BLAS: with several test
    workers on the machine, eight threads a worker oversubscribe the cores
    and every small op (and each small linear solve of the PLDA) waits for
    threads that are not running."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _cp():
    """The tiny CAM++ (tests/torch_pairs.py) as numpy and as the port's."""
    cp_np = trees()["campplus_params"]
    return cp_np, P.campplus_params(cp_np, "cpu")


def _scores(seed, n_tar=200, n_non=900):
    rng = np.random.default_rng(seed)
    return rng.normal(1.0, 0.8, n_tar), rng.normal(-0.5, 1.0, n_non)


# ---------------------------------------------------------------------------
# numpy evals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_privacy_metrics_match_jax(seed):
    tar, non = _scores(seed)
    assert tpm.eer(tar, non) == pytest.approx(jpm.eer(tar, non), abs=1e-9)
    for a, b in zip(tpm.pav(np.r_[non, tar]), jpm.pav(np.r_[non, tar])):
        np.testing.assert_allclose(a, b, atol=1e-9)
    for a, b in zip(tpm.optimal_llr(tar, non, compute_eer=True),
                    jpm.optimal_llr(tar, non, compute_eer=True)):
        np.testing.assert_allclose(a, b, atol=1e-9)
    tl, nl = jpm.optimal_llr(tar, non)
    assert tpm.cllr(tl, nl) == pytest.approx(jpm.cllr(tl, nl), abs=1e-9)
    assert tpm.min_cllr(tar, non) == pytest.approx(jpm.min_cllr(tar, non), abs=1e-9)
    assert tpm.linkability(tar, non) == pytest.approx(jpm.linkability(tar, non), abs=1e-9)
    zt, zj = tpm.zebra(tar, non), jpm.zebra(tar, non)
    assert zt[2] == zj[2] and np.allclose(zt[:2], zj[:2], atol=1e-9, rtol=0)
    rng = np.random.default_rng(seed + 10)
    e, t = rng.standard_normal((6, 8)), rng.standard_normal((9, 8))
    np.testing.assert_allclose(tpm.cosine_scores(e, t), jpm.cosine_scores(e, t), atol=1e-9)
    le, lt = rng.integers(0, 3, 6), rng.integers(0, 3, 9)
    assert tpm.asv_eer_from_embeddings(e, t, le, lt) == pytest.approx(
        jpm.asv_eer_from_embeddings(e, t, le, lt), abs=1e-9)


def test_plda_matches_jax():
    rng = np.random.default_rng(5)
    spk = rng.standard_normal((5, 12))
    labels = np.repeat(np.arange(5), 6)
    x = spk[labels] + 0.3 * rng.standard_normal((30, 12))
    a, b = tplda.train_plda(x, labels), jplda.train_plda(x, labels)
    for f in ("mean", "B", "W"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), atol=1e-9)
    np.testing.assert_allclose(a.score(x[:7], x[7:]), b.score(x[:7], x[7:]), atol=1e-9)


def test_kaldi_io_matches_jax(tmp_path):
    for mod, d in ((tkaldi, tmp_path / "t"), (jkaldi, tmp_path / "j")):
        mod.save_kaldi_format({"u2": "spk b", "u1": ["a", "b"]}, d / "d1" / "text")
        mod.save_kaldi_format({"u1": "x", "u2": "x"}, d / "d1" / "utt2spk")
        mod.save_kaldi_format({"u3": "c d"}, d / "d2" / "text")
        mod.save_kaldi_format({"u3": "y"}, d / "d2" / "utt2spk")
        mod.combine_asr_data([d / "d1", d / "d2"], d / "both")
    for f in ("d1/text", "both/text", "both/utt2spk", "both/spk2utt"):
        assert (tmp_path / "t" / f).read_text() == (tmp_path / "j" / f).read_text()
    for vs in (True, False):
        assert (tkaldi.read_kaldi_format(tmp_path / "t" / "both" / "text", vs)
                == jkaldi.read_kaldi_format(tmp_path / "j" / "both" / "text", vs))


def test_wer_matches_jax(tmp_path):
    refs = {"u1": "the cat sat on the mat", "u2": "hello world", "u3": "a b c"}
    hyps = {"u1": "the cat sat mat", "u2": "hello word there", "u3": ""}
    for ref, hyp in zip(refs.values(), hyps.values()):
        assert twer.align_tokens(ref.split(), hyp.split()) == jwer.align_tokens(
            ref.split(), hyp.split())
    a = twer.compute_wer(refs, hyps, tmp_path / "t" / "wer")
    b = jwer.compute_wer(refs, hyps, tmp_path / "j" / "wer")
    assert a.summarize("all") == b.summarize("all")
    assert (tmp_path / "t" / "wer").read_text() == (tmp_path / "j" / "wer").read_text()


def test_evaluate_asr_from_cached_hypotheses_matches_jax(tmp_path):
    for name, hyp in (("libri_dev", "one two three"), ("libri_dev_anon", "one too")):
        save = tkaldi.save_kaldi_format
        save({"u1": "one two three", "u2": "four five"}, tmp_path / "data" / name / "text")
        for res in ("rt", "rj"):
            save({"u1": hyp, "u2": "four five six"}, tmp_path / res / name / "text")
    got = twer.evaluate_asr(["libri_dev"], tmp_path / "data", None, tmp_path / "rt")
    want = jwer.evaluate_asr(["libri_dev"], tmp_path / "data", None, tmp_path / "rj")
    assert got == want.to_dict("records")
    assert ((tmp_path / "rt" / "results_anon.csv").read_text()
            == (tmp_path / "rj" / "results_anon.csv").read_text())
    assert ((tmp_path / "rt" / "libri_dev_anon" / "wer").read_text()
            == (tmp_path / "rj" / "libri_dev_anon" / "wer").read_text())


def test_tables_write_as_pandas(tmp_path):
    rows = [{"dataset": "libri", "EER": 12.5, "c": 0.1 + 0.2},
            {"dataset": "iemocap, s1", "EER": 1e-5, "backbone": "ecapa"}]
    tables.write_csv(rows, tmp_path / "t.csv")
    pd.DataFrame(rows).to_csv(tmp_path / "p.csv")
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "p.csv").read_text()
    done = tables.complete(rows)
    assert list(done[0]) == ["dataset", "EER", "c", "backbone"]
    assert math.isnan(done[0]["backbone"]) and math.isnan(done[1]["c"])
    folds = [{"d": "x", "UAR": 50.0, "ACC_a": 1.0}, {"d": "x", "UAR": 70.0},
             {"d": "w", "UAR": 10.0, "ACC_a": 3.0}]
    want = pd.DataFrame(folds).groupby(["d"]).agg({"UAR": "mean", "ACC_a": "mean"})
    assert tables.mean_by(folds, ["d"], ["UAR", "ACC_a"]) == want.reset_index().to_dict(
        "records")


# ---------------------------------------------------------------------------
# neural evals
# ---------------------------------------------------------------------------


def _voices(n_spk=3, n_utt=3, seconds=1.0, sr=SR, seed=0):
    from streamvoiceanon_tpu.evals.anonymize import Utterance

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    utts = []
    for s in range(n_spk):
        f0 = 180.0 * (1.7 ** s)
        for j in range(n_utt):
            w = (np.sin(2 * np.pi * f0 * t) * 0.3 + 0.05 * np.sin(2 * np.pi * 3 * f0 * t)
                 + 0.02 * rng.standard_normal(len(t)))
            utts.append(Utterance(f"spk{s}_{j}", f"spk{s}", w.astype(np.float32)))
    return utts


def _port_utts(utts):
    return [tanon.Utterance(u.utt_id, u.speaker, u.wav) for u in utts]


def _close_tree(got, want, path="", skip=()):
    """Every leaf within 1e-4 of its largest value, and at least within 1e-4
    (a leaf that starts at zero holds only its few updates of about lr)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _close_tree(got[k], want[k], f"{path}/{k}", skip)
    elif isinstance(want, (list, tuple)):
        for i, (g, w) in enumerate(zip(got, want)):
            _close_tree(g, w, f"{path}/{i}", skip)
    elif path not in skip:
        g = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
        w = np.asarray(want)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=REL * max(np.abs(w).max(), 1.0),
                                   err_msg=path)


def _grad_err(got_flat, want_tree):
    """The largest error of the port's gradients (by path) against JAX's
    (a tree in the port's layout), as a fraction of each leaf's largest
    JAX gradient, over the leaves whose gradient is not all zero."""
    from streamvoiceanon_tpu_torch.utils.tree import flatten

    worst = 0.0
    for k, w in flatten(want_tree).items():
        w = np.asarray(w)
        g = got_flat.get(k)
        g = np.zeros_like(w) if g is None else g.detach().numpy()
        if np.abs(w).max() > 0:
            worst = max(worst, float(np.abs(g - w).max() / np.abs(w).max()))
        else:
            assert np.abs(g).max() == 0, k
    return worst


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_speaker_embeddings_match_jax():
    cp_np, cp_t = _cp()
    utts = _voices(2, 1, seconds=1.3, sr=44100)
    a = janon.speaker_embeddings(cp_np, CP, utts)
    b = tanon.speaker_embeddings(cp_t, C.from_fields(CP), _port_utts(utts))
    assert a.shape == b.shape == (2, 192)
    np.testing.assert_allclose(b, a, rtol=0, atol=REL * np.abs(a).max())


def test_asv_train_three_steps_match_jax(monkeypatch):
    cp_np, cp_t = _cp()
    utts = _voices()
    jcfg = jat.ASVTrainConfig(chunk_seconds=0.5, batch_size=4, steps=3)
    tcfg = tat.ASVTrainConfig(**vars(jcfg))
    jh_, th_ = [], []
    want = jat.train_asv_eval(cp_np, CP, utts, jcfg, utt_sample_rate=SR, history=jh_)
    init = _torch(jat.init_head(jax.random.PRNGKey(jcfg.seed), jcfg, 3))
    monkeypatch.setattr(tat, "init_head", lambda g, cfg, n: init)
    got = tat.train_asv_eval(cp_t, C.from_fields(CP), _port_utts(utts), tcfg,
                             utt_sample_rate=SR, history=th_)
    np.testing.assert_allclose(th_, jh_, rtol=REL)
    _close_tree(got["head"], _np_tree(want["head"]))
    assert got["backbone"] is cp_t
    feats = tanon.fbank_features(torch.from_numpy(utts[0].wav)[None])
    e_t = tat.embed(got, C.from_fields(CP), *feats)
    e_j = jat.embed(want, CP, jnp.asarray(feats[0].numpy()), jnp.asarray(feats[1].numpy()))
    np.testing.assert_allclose(e_t.detach().numpy(), np.asarray(e_j), rtol=0,
                               atol=REL * np.abs(np.asarray(e_j)).max())


def _jax_features(wav_b):
    """JAX's fbank features of a batch (less their mean) and CAM++ lengths."""
    from streamvoiceanon_tpu.audio import fbank as jfbank

    f = jfbank.fbank(jnp.asarray(wav_b))
    f = f - jnp.mean(f, axis=1, keepdims=True)
    return f, jnp.full((f.shape[0],), f.shape[1] // 2, jnp.int32)


def _port_features_from_jax(monkeypatch, module):
    """Make `module`'s trainer read JAX's fbank features: the trainer is
    under test here, and the two packages' float32 log-mel differs in
    near-silent bins (audio/fbank.py is held against JAX in
    tests/test_torch_prompt.py), which the first layers' weight gradients
    amplify past the trainers' tolerance."""
    def feats(wav):
        f, lens = _jax_features(wav.numpy())
        return torch.from_numpy(np.asarray(f)), torch.from_numpy(np.asarray(lens))

    monkeypatch.setattr(module, "fbank_features", feats)


def test_asv_train_backbone_gradients_match_jax():
    """With `finetune_backbone` every CAM++ leaf trains.  AdamW's first step
    moves each element by about lr times the sign of its gradient, so an
    element whose gradient is float32 noise may move either way in either
    package; the step's gradients are what the two must share: on the same
    features, every leaf's within 1e-4 of its largest, the loss within
    1e-4 relative."""
    from streamvoiceanon_tpu.models import campplus as jcampplus
    from streamvoiceanon_tpu_torch.utils.tree import flatten

    cp_np, cp_t = _cp()
    cfg = jat.ASVTrainConfig(chunk_seconds=0.5, batch_size=4, finetune_backbone=True)
    labels = np.repeat(np.arange(3), 3).astype(np.int32)
    wav_b, lab_b = tat._chunk_batch(np.random.default_rng(0), [u.wav for u in _voices()],
                                    labels, cfg)
    head = jat.init_head(jax.random.PRNGKey(0), cfg, 3)
    head.pop("emb_mean")
    f, lens = _jax_features(wav_b)

    def jloss(p):
        e = jcampplus.apply(p["backbone"], CP, f, lens)
        e = e @ p["head"]["proj_w"] + p["head"]["proj_b"]
        e = e - jax.lax.stop_gradient(jnp.mean(e, axis=0))
        return jat.aam_softmax_loss(p["head"], e, jnp.asarray(lab_b), cfg.margin, cfg.scale)

    jl, jg = jax.jit(jax.value_and_grad(jloss))({"backbone": jax.tree.map(jnp.asarray, cp_np),
                                        "head": head})
    tp = tat.leaves({"backbone": cp_t, "head": _torch(head)})
    tl, _ = tat.batch_loss(tp["backbone"], tp["head"], C.from_fields(CP),
                           tat.ASVTrainConfig(**vars(cfg)), torch.from_numpy(np.asarray(f)),
                           torch.from_numpy(np.asarray(lens)), torch.from_numpy(lab_b))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=REL)
    flat = flatten(tp)
    grads = dict(zip(flat, torch.autograd.grad(tl, list(flat.values()), allow_unused=True)))
    err = _grad_err(grads, {"backbone": P.campplus_params(_np_tree(jg["backbone"]), "cpu"),
                            "head": _np_tree(jg["head"])})
    assert err <= REL, err


def test_ecapa_asv_three_steps_match_jax(monkeypatch):
    utts = _voices()
    jcfg = jea.ECAPAASVConfig(**TINY_ECAPA)
    tcfg = tea.ECAPAASVConfig(**TINY_ECAPA)
    jh_, th_ = [], []
    want = jea.train_ecapa_asv(utts, jcfg, utt_sample_rate=SR, history=jh_)
    k0, k1 = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    init = P.ecapa_params(_np_tree({"backbone": jea.init_backbone(k0, jcfg),
                                    "head": jea.init_head(k1, jcfg, 3)}), "cpu")
    monkeypatch.setattr(tea, "init_backbone", lambda g, cfg: init["backbone"])
    monkeypatch.setattr(tea, "init_head", lambda g, cfg, n: init["head"])
    _port_features_from_jax(monkeypatch, tea)
    got = tea.train_ecapa_asv(_port_utts(utts), tcfg, utt_sample_rate=SR, history=th_,
                              device="cpu")
    np.testing.assert_allclose(th_, jh_, rtol=REL)
    # ASTP's softmax over time ignores a per-channel shift, so the gradient of
    # attn2_b is zero but for rounding, whose sign AdamW turns into +-lr steps
    want_p = P.ecapa_params(_np_tree(want), "cpu")
    _close_tree(got, want_p, skip=("/head/attn2_b",))
    for t in (got["head"]["attn2_b"], want_p["head"]["attn2_b"]):
        assert float(t.abs().max()) <= 3 * tcfg.lr * 1.01
    bn = got["backbone"]["layer2"]["res2"][3]["bn"]
    assert not torch.equal(bn["mean"], torch.zeros_like(bn["mean"]))  # the stats moved
    f, _ = _jax_features(np.stack([u.wav for u in utts[:2]]))
    a = np.asarray(jax.jit(lambda p, x: jea.embed(p, jcfg, x))(want, f))
    b = tea.embed(got, tcfg, torch.from_numpy(np.asarray(f))).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=REL * np.abs(a).max())


def test_ser_head_three_steps_match_jax(monkeypatch):
    import optax

    rng = np.random.default_rng(7)
    embs = rng.standard_normal((20, 12)).astype(np.float32)
    labels = rng.integers(0, 4, 20)
    key = jax.random.PRNGKey(3)
    jcfg = jser.SERHeadConfig(emb_dim=12, hidden=8, steps=3)
    want = jser.train_head(key, jcfg, embs, labels)
    jlosses = []
    for k in range(3):  # the loss before each step, from JAX's params after k steps
        p = jser.train_head(key, jser.SERHeadConfig(emb_dim=12, hidden=8, steps=k), embs,
                            labels)
        jlosses.append(float(jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            jser.head_logits(p, jnp.asarray(embs)), jnp.asarray(labels)))))
    init = _torch(jser.init_head(key, jcfg))
    monkeypatch.setattr(tser, "init_head", lambda g, cfg: init)
    hist = []
    got = tser.train_head(torch.Generator(), tser.SERHeadConfig(**vars(jcfg)), embs, labels,
                          history=hist)
    np.testing.assert_allclose(hist, jlosses, rtol=REL)
    _close_tree(got, _np_tree(want))
    np.testing.assert_array_equal(tser.classify(got, embs), jser.classify(want, embs))
    y, p = rng.integers(0, 4, 50), rng.integers(0, 4, 50)
    assert tser.uar(y, p) == jser.uar(y, p) and tser.accuracy(y, p) == jser.accuracy(y, p)
    assert tser.accuracy([], []) == jser.accuracy([], []) == 0.0


# ---------------------------------------------------------------------------
# anonymization and the harness
# ---------------------------------------------------------------------------


class _JaxNoise(VoiceConverter):
    """The port's converter with JAX's anonymisation noise fed in: the
    speaker a conversion's generator belongs to (by its seed,
    `speaker_seed`) gives JAX's draws for it, fold_in(PRNGKey(seed), index)
    -> infer's k_spk -> the style and timbre normals."""

    def __init__(self, converter, seed, n_speakers):
        super().__init__(converter)
        self.noise = {}
        for i in range(n_speakers):
            k_spk, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), i))
            k1, k2 = jax.random.split(k_spk)
            self.noise[tanon.speaker_seed(seed, i)] = tuple(
                torch.from_numpy(np.array(jax.random.normal(k, shape)))
                for k, shape in ((k1, (1, 192)), (k2, (1, 32, 128))))

    def infer(self, *a, generator=None, **kw):
        return super().infer(*a, generator=generator,
                             spk_noise=self.noise[generator.initial_seed()], **kw)


def test_anonymize_kaldi_dir_matches_jax(tmp_path):
    jcv, tcv = pair()
    rng = np.random.default_rng(11)
    d = tmp_path / "libri_dev"
    scp, u2s = {}, {}
    for i, spk in enumerate(("s2", "s0", "s1", "s0")):
        p = tmp_path / f"u{i}.wav"
        write_wav(str(p), (rng.standard_normal(5 * 2048) * 0.1).astype(np.float32), 44100)
        scp[f"u{i}"], u2s[f"u{i}"] = str(p), spk
    tkaldi.save_kaldi_format(scp, d / "wav.scp")
    tkaldi.save_kaldi_format(u2s, d / "utt2spk")
    tkaldi.save_kaldi_format({u: "some words" for u in scp}, d / "text")
    tkaldi.save_kaldi_format({"s0": "f0", "s1": "f1", "s2": "f0"}, d / "spk2fold")
    targets = [(rng.standard_normal(8 * 2048) * 0.1).astype(np.float32) for _ in range(2)]
    janon.anonymize_kaldi_dir(jcv, str(d), str(tmp_path / "j"), targets, alpha=0.5, delay=2,
                              seed=4)
    tanon.anonymize_kaldi_dir(_JaxNoise(tcv, 4, 3), str(d), str(tmp_path / "t"), targets,
                              alpha=0.5, delay=2, seed=4)
    jd, td = tmp_path / "j", tmp_path / "t"
    for f in ("utt2spk", "text", "spk2fold"):
        assert (td / f).read_text() == (jd / f).read_text()
    assert sorted(p.name for p in (td / "wav").iterdir()) == sorted(
        p.name for p in (jd / "wav").iterdir())
    tscp, jscp = tkaldi.read_kaldi_format(td / "wav.scp"), jkaldi.read_kaldi_format(
        jd / "wav.scp")
    assert tscp.keys() == jscp.keys() and all(Path(tscp[u]).parent == td / "wav" for u in tscp)
    from scipy.io import wavfile

    for u in tscp:
        a, b = wavfile.read(jscp[u])[1], wavfile.read(tscp[u])[1]
        assert a.shape == b.shape == (5 * 2048,)
        # int16 files: within the float tolerance plus one quantization step
        assert np.abs(a.astype(np.int32) - b).max() <= 1 + 1e-4 * 32767 * max(
            1.0, np.abs(a).max() / 32767)
    # the same speaker -> target draw, and one generator seed a speaker
    utts = janon.load_kaldi_dir(str(d))
    got = tanon.anonymize_dataset(VoiceConverter(tcv), _port_utts(utts[:1]), targets,
                                  alpha=0.5, seed=4)
    assert got[0].wav.shape == (5 * 2048,)
    seeds = {tanon.speaker_seed(4, i) for i in range(3)}
    assert len(seeds) == 3 and tanon.speaker_seed(4, 1) == tanon.speaker_seed(4, 1)


def _eval_dirs(root: Path):
    """Enrollment and trial dirs of three speakers (and their 'anonymized'
    copies, mixed toward a shared carrier), an IEMOCAP-like SER set with
    emotions and two folds, and cached ASR hypotheses."""
    rng = np.random.default_rng(0)
    t = np.arange(SR) / SR
    f0s = {"spkA": 300.0, "spkB": 900.0, "spkC": 2500.0}
    emos = ("neu", "hap", "sad", "ang")

    def wav(spk, j, anon):
        w = np.sin(2 * np.pi * f0s[spk] * (1 + 0.03 * j) * t) + 0.05 * rng.standard_normal(SR)
        if anon:
            w = 0.3 * w + 0.7 * np.sin(2 * np.pi * 1200.0 * t)
        return (0.5 * w).astype(np.float32)

    for name in ("libri_dev_enrolls", "libri_dev_trials", "libri_train", "iemocap_dev"):
        for anon in (False, True):
            d = root / "data" / (name + ("_anon" if anon else ""))
            scp, u2s, u2e, text = {}, {}, {}, {}
            for spk in f0s:
                for j in range(3):
                    u = f"{spk}_{name}_{j}"
                    p = root / "wavs" / f"{u}{'_anon' if anon else ''}.wav"
                    p.parent.mkdir(parents=True, exist_ok=True)
                    write_wav(str(p), wav(spk, j, anon), SR)
                    scp[u], u2s[u], u2e[u] = str(p), spk, emos[(j + len(spk)) % 4]
                    text[u] = "one two three four"
            tkaldi.save_kaldi_format(scp, d / "wav.scp")
            tkaldi.save_kaldi_format(u2s, d / "utt2spk")
            tkaldi.save_kaldi_format(u2e, d / "utt2emo")
            tkaldi.save_kaldi_format({"spkA": "1", "spkB": "2", "spkC": "1"}, d / "spk2fold")
            tkaldi.save_kaldi_format(text, d / "text")
            for res in ("rt", "rj"):
                hyp = {u: "one two three" if anon else "one two three four" for u in scp}
                tkaldi.save_kaldi_format(hyp, root / res / "asr" / d.name / "text")


def _same_rows(got, want_df, exact=()):
    want = want_df.to_dict("records")
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        for k, wv in w.items():
            gv = g[k]
            if isinstance(wv, str):
                assert gv == wv, (k, gv, wv)
            elif isinstance(wv, float) and math.isnan(wv):
                assert isinstance(gv, float) and math.isnan(gv), (k, gv)
            else:
                tol = 1e-9 if k in exact else ROUNDING.get(k, 1e-9) * 1.0001
                assert abs(gv - wv) <= tol, (k, gv, wv)


@pytest.mark.parametrize("distance,backbone", [("cosine", "campplus"), ("plda", "ecapa")])
def test_run_evaluation_matches_jax(tmp_path, monkeypatch, distance, backbone):
    _eval_dirs(tmp_path)
    cp_np, cp_t = _cp()
    tcp = C.from_fields(CP)
    # JAX's initial draws fed to the port's trainers
    at_j = jat.ASVTrainConfig(chunk_seconds=0.5, batch_size=4, steps=3)
    head = _torch(jat.init_head(jax.random.PRNGKey(0), at_j, 3))
    monkeypatch.setattr(tat, "init_head", lambda g, cfg, n: head)
    ea_j = jea.ECAPAASVConfig(**TINY_ECAPA)
    k0, k1 = jax.random.split(jax.random.PRNGKey(0))
    eparams = P.ecapa_params(_np_tree({"backbone": jea.init_backbone(k0, ea_j),
                                       "head": jea.init_head(k1, ea_j, 3)}), "cpu")
    monkeypatch.setattr(tea, "init_backbone", lambda g, cfg: eparams["backbone"])
    monkeypatch.setattr(tea, "init_head", lambda g, cfg, n: eparams["head"])
    _port_features_from_jax(monkeypatch, tea)
    folds = iter(range(100))
    ser_cfg = jser.SERHeadConfig(emb_dim=192, n_classes=4)
    monkeypatch.setattr(tser, "init_head", lambda g, cfg: _torch(jser.init_head(
        jax.random.fold_in(jax.random.PRNGKey(0), next(folds) % 2), ser_cfg)))

    def cfgs(mod, res, at_cfg, ea_cfg):
        return mod.EvalConfig(
            data_dir=tmp_path / "data", results_dir=tmp_path / res, sample_rate=SR,
            asv=mod.ASVStep(enrolls=["libri_dev_enrolls"], trials=["libri_dev_trials"],
                            train_asv_on_anon=True, train_dirs=["libri_train_anon"],
                            distance=distance, anon_backbone=backbone,
                            campplus_cfg=at_cfg, ecapa_cfg=ea_cfg),
            # the utility steps once, beside the cosine run
            ser=mod.SERStep(datasets=["iemocap_dev"]) if distance == "cosine" else None,
            asr=mod.ASRStep(datasets=["libri_dev_trials"]) if distance == "cosine" else None)

    want = jh.run_evaluation(cfgs(jh, "rj", at_j, ea_j), campplus_params=cp_np, cp_cfg=CP)
    got = th.run_evaluation(cfgs(th, "rt", tat.ASVTrainConfig(**vars(at_j)),
                                 tea.ECAPAASVConfig(**TINY_ECAPA)),
                            campplus_params=cp_t, cp_cfg=tcp)
    steps = {"asv", "ser", "asr"} if distance == "cosine" else {"asv"}
    assert set(got) == set(want) == steps
    _same_rows(got["asv"], want["asv"])
    assert [r["model"] for r in got["asv"]] == ["ASV_eval"] * 3 + ["ASV_eval_anon"]
    csvs = ["asv_results_anon.csv"]
    if distance == "cosine":
        _same_rows(got["ser"], want["ser"], exact=("UAR",))
        _same_rows(got["asr"], want["asr"], exact=("WER",))
        csvs += ["ser/iemocap_dev/results_anon.csv", "ser/iemocap_dev/results_folds_anon.csv",
                 "asr/results_anon.csv"]
    for csv in csvs:
        a = pd.read_csv(tmp_path / "rt" / csv, index_col=0)
        b = pd.read_csv(tmp_path / "rj" / csv, index_col=0)
        assert list(a.columns) == list(b.columns) and len(a) == len(b), csv
        _same_rows(a.to_dict("records"), b, exact=("UAR", "WER"))
    summary = (tmp_path / "rt" / "results_summary.txt").read_text()
    sections = ("SER results", "ASV_eval results", "ASV_eval^anon results", "ASR results")
    for section in sections if distance == "cosine" else sections[1:3]:
        assert f"---- {section} ----" in summary


def test_cli_evaluate_refuses_to_train_an_asr_model(tmp_path, capsys):
    _eval_dirs(tmp_path)
    base = ["evaluate", "--data-dir", str(tmp_path / "data"), "--results-dir",
            str(tmp_path / "fresh"), "--asr-datasets", "libri_dev_trials", "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="asr_eval_train.py.*slice 16"):
        cli.main(base + ["--asr-train-dirs", "libri_train"])
    with pytest.raises(SystemExit, match="not cached"):
        cli.main(base)
    rows = cli.main(["evaluate", "--data-dir", str(tmp_path / "data"), "--results-dir",
                     str(tmp_path / "rt"), "--asr-datasets", "libri_dev_trials",
                     "--sample-rate", str(SR), "--device", "cpu"])
    assert [r["WER"] for r in rows["asr"]] == [0.0, 25.0]
    assert "== asr ==" in capsys.readouterr().out


def test_cli_anonymize_from_checkpoints(tmp_path, monkeypatch):
    """`cli anonymize --ckpt-dir` on the tiny geometry's checkpoints writes a
    complete anonymized directory (every wav of its source's length)."""
    import chip_smoke

    t = trees()
    chip_smoke.write_checkpoints(tmp_path, chip_smoke.state_dicts(
        {"tokenizer": t["tokenizer_params"], "vocoder": t["vocoder_params"],
         "arvc": t["arvc_params"], "campplus": t["campplus_params"],
         "speaker": t["speaker_params"]}))
    tiny = C.from_fields(JCFG)
    monkeypatch.setattr(C, "PipelineConfig", lambda: tiny)
    rng = np.random.default_rng(2)
    d = tmp_path / "src"
    scp = {}
    for i in range(2):
        p = tmp_path / f"s{i}.wav"
        write_wav(str(p), (rng.standard_normal(3 * 2048 + 100) * 0.1).astype(np.float32),
                  44100)
        scp[f"u{i}"] = str(p)
    tkaldi.save_kaldi_format(scp, d / "wav.scp")
    tkaldi.save_kaldi_format({"u0": "a", "u1": "b"}, d / "utt2spk")
    ref = tmp_path / "ref.wav"
    write_wav(str(ref), (rng.standard_normal(8 * 2048) * 0.1).astype(np.float32), 44100)
    cli.main(["anonymize", "--data-dir", str(d), "--out-dir", str(tmp_path / "out"),
              "--target-refs", str(ref), "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    out = tkaldi.read_kaldi_format(tmp_path / "out" / "wav.scp")
    assert sorted(out) == ["u0", "u1"]
    from scipy.io import wavfile

    for u in out:
        assert wavfile.read(out[u])[1].shape == (3 * 2048,)
