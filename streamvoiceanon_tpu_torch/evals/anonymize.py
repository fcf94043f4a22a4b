"""Dataset anonymization and the ASV attack scenarios, as the JAX package's
evals/anonymize.py: convert every utterance of a dataset against
target-speaker references with noise-mixed embeddings, then score speaker
verification (OO / OA / AA) with CAM++ embeddings on the device: EER,
min-Cllr, linkability and ZEBRA.

A dataset is a list of `Utterance` records; `load_kaldi_dir` reads a Kaldi
directory (wav.scp + utt2spk).  The random draws of a conversion come from
one `torch.Generator` on the converter's device a speaker, seeded from the
seed and the speaker's index, and made anew for each of its utterances:
every utterance of a speaker gets the same anonymisation noise, in every
process (the JAX package folds the speaker's index into its key).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from streamvoiceanon_tpu_torch.audio import fbank as fbank_mod
from streamvoiceanon_tpu_torch.audio.io import read_wav
from streamvoiceanon_tpu_torch.audio.resample import resample
from streamvoiceanon_tpu_torch.evals import privacy_metrics as pm
from streamvoiceanon_tpu_torch.models import campplus


@dataclasses.dataclass
class Utterance:
    utt_id: str
    speaker: str
    wav: np.ndarray  # at the pipeline's sample rate


def load_kaldi_dir(path: str, sample_rate: int = 44100) -> List[Utterance]:
    """The utterances of a Kaldi directory (wav.scp + utt2spk), in utt2spk's
    order, each read at `sample_rate`."""
    from streamvoiceanon_tpu_torch.evals.kaldi import read_kaldi_format

    scp = read_kaldi_format(os.path.join(path, "wav.scp"))
    out = []
    for utt, spk in read_kaldi_format(os.path.join(path, "utt2spk")).items():
        wav, _ = read_wav(scp[utt], target_sr=sample_rate)
        out.append(Utterance(utt, spk, wav))
    return out


def speaker_seed(seed: int, index: int) -> int:
    """The seed of speaker `index`'s generator: distinct for each (seed,
    index) and the same in every process."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0] >> 1)


def anonymize_dataset(
    converter,
    utterances: Sequence[Utterance],
    target_refs: Sequence[np.ndarray],
    *,
    alpha: float = 0.7,
    delay: int = 2,
    seed: int = 0,
    per_speaker_targets: bool = True,
) -> List[Utterance]:
    """Convert each utterance (`converter` a `runtime.pipeline.VoiceConverter`)
    to a target reference with noise mixing.

    With `per_speaker_targets` each source speaker is assigned one target
    reference, drawn from numpy's `default_rng(seed)` in sorted speaker
    order (a consistent pseudo-speaker a speaker)."""
    rng = np.random.default_rng(seed)
    speakers = sorted({u.speaker for u in utterances})
    spk_target = {
        s: target_refs[rng.integers(len(target_refs))] if per_speaker_targets else None
        for s in speakers
    }
    spk_index = {s: i for i, s in enumerate(speakers)}
    out = []
    for u in utterances:
        ref = spk_target[u.speaker] if per_speaker_targets else target_refs[
            rng.integers(len(target_refs))]
        gen = torch.Generator(device=converter.device).manual_seed(
            speaker_seed(seed, spk_index[u.speaker]))
        wav = converter.infer(u.wav, [ref], delay=delay, alpha=alpha, generator=gen)
        out.append(Utterance(u.utt_id, u.speaker, np.asarray(wav)))
    return out


def anonymize_kaldi_dir(
    converter,
    data_dir: str,
    out_dir: str,
    target_refs: Sequence[np.ndarray],
    *,
    alpha: float = 0.7,
    delay: int = 2,
    seed: int = 0,
    sample_rate: int = 44100,
) -> None:
    """Anonymize a Kaldi directory into `out_dir`: every wav converted and
    written as `wav/<utt_id>.wav`, wav.scp and utt2spk for them, and the side
    tables (text, utt2emo, spk2fold, spk2gender) copied as they are."""
    import shutil

    from streamvoiceanon_tpu_torch.audio.io import write_wav
    from streamvoiceanon_tpu_torch.evals.kaldi import save_kaldi_format

    utts = load_kaldi_dir(data_dir, sample_rate=sample_rate)
    anon = anonymize_dataset(converter, utts, target_refs, alpha=alpha, delay=delay,
                             seed=seed)
    wav_dir = os.path.join(out_dir, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    scp, u2s = {}, {}
    for u in anon:
        path = os.path.join(wav_dir, f"{u.utt_id}.wav")
        write_wav(path, u.wav, sample_rate)
        scp[u.utt_id] = path
        u2s[u.utt_id] = u.speaker
    save_kaldi_format(scp, os.path.join(out_dir, "wav.scp"))
    save_kaldi_format(u2s, os.path.join(out_dir, "utt2spk"))
    for side in ("text", "utt2emo", "spk2fold", "spk2gender"):
        src = os.path.join(data_dir, side)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(out_dir, side))


def tree_device(tree) -> torch.device:
    """The device of the first tensor of a nested dict/list tree."""
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.device


def fbank_features(wav: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """16 kHz audio (B, T) -> (Kaldi fbank less its per-utterance mean (B,
    frames, 80), CAM++'s valid lengths at the pooled rate (B,))."""
    f = fbank_mod.fbank(wav)
    f = f - f.mean(dim=1, keepdim=True)
    return f, torch.full((f.shape[0],), f.shape[1] // 2, device=f.device)


def to_16k(wav: np.ndarray, sample_rate: int, device) -> torch.Tensor:
    """A wav at `sample_rate` -> (1, T') float32 at 16 kHz on `device`."""
    return resample(torch.as_tensor(np.asarray(wav, np.float32), device=device)[None],
                    sample_rate, 16000)


@torch.no_grad()
def speaker_embeddings(campplus_params, cfg, utterances: Sequence[Utterance],
                       sample_rate: int = 44100) -> np.ndarray:
    """CAM++ embeddings (N, 192) float32 for scoring, one utterance at a time
    on the device of `campplus_params` (the port's layout,
    `params.campplus_params`)."""
    dev = tree_device(campplus_params)
    embs = []
    for u in utterances:
        feat, lens = fbank_features(to_16k(u.wav, sample_rate, dev))
        embs.append(campplus.apply(campplus_params, cfg, feat, lens)[0].cpu().numpy())
    return np.stack(embs)


def asv_scenarios(
    enroll_orig: Sequence[Utterance],
    trial_orig: Sequence[Utterance],
    trial_anon: Sequence[Utterance],
    campplus_params,
    cfg,
    enroll_anon: Optional[Sequence[Utterance]] = None,
    distance: str = "cosine",
    emb_cache: Optional[Dict[int, Tuple[np.ndarray, np.ndarray]]] = None,
    sample_rate: int = 44100,
) -> Dict[str, Dict[str, float]]:
    """EER, min-Cllr, linkability and ZEBRA for the VPC attack scenarios:
      OO: original enrollment against original trials (the baseline);
      OA: original enrollment against anonymized trials (ignorant attacker);
      AA: anonymized enrollment against anonymized trials (informed).
    `distance` is the scoring backend: 'cosine', or 'plda' (a two-covariance
    PLDA trained on each scenario's enrollment cohort).  `emb_cache`, keyed
    by a cohort's identity, embeds each cohort once across calls."""

    def emb_and_labels(utts):
        if emb_cache is not None and id(utts) in emb_cache:
            return emb_cache[id(utts)]
        out = (speaker_embeddings(campplus_params, cfg, utts, sample_rate=sample_rate),
               np.asarray([u.speaker for u in utts]))
        if emb_cache is not None:
            emb_cache[id(utts)] = out
        return out

    e_o = emb_and_labels(enroll_orig)
    t_o = emb_and_labels(trial_orig)
    t_a = emb_and_labels(trial_anon)

    pairs = {"OO": (e_o, t_o), "OA": (e_o, t_a)}
    if enroll_anon is not None:
        pairs["AA"] = (emb_and_labels(enroll_anon), t_a)
    out = {}
    for name, ((e_emb, e_lab), (t_emb, t_lab)) in pairs.items():
        tar, non = trial_scores(e_emb, e_lab, t_emb, t_lab, distance)
        dece, max_llr, _ = pm.zebra(tar, non)
        out[name] = {
            "eer": pm.eer(tar, non)[0],
            "cllr_min": pm.min_cllr(tar, non),
            "linkability": pm.linkability(tar, non),
            "zebra_dece": dece,
            "zebra_max_llr": max_llr,
        }
    return out


def trial_scores(e_emb: np.ndarray, e_lab: np.ndarray, t_emb: np.ndarray,
                 t_lab: np.ndarray, distance: str) -> Tuple[np.ndarray, np.ndarray]:
    """(mated, non-mated) scores of every enrollment x trial pair, cosine or
    PLDA trained on the enrollment embeddings."""
    if distance == "plda":
        from streamvoiceanon_tpu_torch.evals.plda import train_plda

        s = train_plda(e_emb, e_lab).score(e_emb, t_emb)
    else:
        s = pm.cosine_scores(e_emb, t_emb)
    same = e_lab[:, None] == t_lab[None, :]
    return s[same], s[~same]
