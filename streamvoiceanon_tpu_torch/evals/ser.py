"""Speech-emotion-recognition utility evaluation (IEMOCAP style), as the JAX
package's evals/ser.py: each speaker's utterances are classified by the
head of the complementary folds, scored as UAR (unweighted average recall,
macro recall x 100) and per-emotion accuracy, over the original and the
anonymized copy of each dataset.

The classifier is a small head over a pluggable utterance embedding (by
default the CAM++ speaker embedding), trained full batch with AdamW in
optax's numerics (`train/muon.adamw`) on the device of its generator.  Its
tables are lists of row dicts written as `DataFrame.to_csv` writes them
(`evals/tables.py`).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from streamvoiceanon_tpu_torch.evals import tables
from streamvoiceanon_tpu_torch.evals.anonymize import speaker_seed
from streamvoiceanon_tpu_torch.evals.asv_train import adamw_step, leaves
from streamvoiceanon_tpu_torch.train import muon
from streamvoiceanon_tpu_torch.utils.tree import flatten, tree_map

# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def uar(y_true: Sequence[int], y_pred: Sequence[int]) -> float:
    """Unweighted average recall in percent (macro recall * 100)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    recalls = []
    for c in np.unique(y_true):
        mask = y_true == c
        recalls.append(float(np.mean(y_pred[mask] == c)))
    return round(100.0 * float(np.mean(recalls)), 3)


def accuracy(y_true: Sequence[int], y_pred: Sequence[int]) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    return round(100.0 * float(np.mean(y_true == y_pred)), 3) if len(y_true) else 0.0


# ---------------------------------------------------------------------------
# The emotion-classifier head
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SERHeadConfig:
    emb_dim: int = 192
    hidden: int = 128
    n_classes: int = 4
    lr: float = 1e-3
    steps: int = 300
    weight_decay: float = 1e-4


def init_head(generator: torch.Generator, cfg: SERHeadConfig) -> Dict:
    g, dev = generator, generator.device
    return {
        "w1": torch.randn((cfg.emb_dim, cfg.hidden), generator=g, device=dev)
        * float(1.0 / np.sqrt(cfg.emb_dim)),
        "b1": torch.zeros((cfg.hidden,), device=dev),
        "w2": torch.randn((cfg.hidden, cfg.n_classes), generator=g, device=dev)
        * float(1.0 / np.sqrt(cfg.hidden)),
        "b2": torch.zeros((cfg.n_classes,), device=dev),
    }


def head_logits(params: Dict, emb: torch.Tensor) -> torch.Tensor:
    h = torch.tanh(emb @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def train_head(generator: torch.Generator, cfg: SERHeadConfig, embs: np.ndarray,
               labels: np.ndarray, history: Optional[list] = None) -> Dict:
    """Full-batch AdamW training of a head initialised from `generator`, on
    the generator's device; each step's loss is appended to `history` when
    given."""
    dev = generator.device
    params = leaves(init_head(generator, cfg))
    tx = muon.adamw(cfg.lr, weight_decay=cfg.weight_decay)
    opt_state = tx.init(flatten(params))
    x = torch.as_tensor(np.asarray(embs, np.float32), device=dev)
    y = torch.as_tensor(np.asarray(labels), device=dev).long()
    losses = []
    for _ in range(cfg.steps):
        loss = F.cross_entropy(head_logits(params, x), y)
        opt_state = adamw_step(tx, opt_state, params, loss)
        losses.append(loss.detach())
    if history is not None:
        history.extend(float(v) for v in losses)
    return tree_map(lambda t: t.detach(), params)


@torch.no_grad()
def classify(params: Dict, embs: np.ndarray) -> np.ndarray:
    dev = params["w1"].device
    logits = head_logits(params, torch.as_tensor(np.asarray(embs, np.float32), device=dev))
    return logits.argmax(dim=-1).cpu().numpy()


def campplus_embed_fn(campplus_params, cp_cfg) -> Callable[[np.ndarray, int], np.ndarray]:
    """The default SER embedding: the CAM++ utterance vector of a wav at
    `sr`, on the device of `campplus_params`."""
    from streamvoiceanon_tpu_torch.evals.anonymize import speaker_embeddings, Utterance

    def embed(wav: np.ndarray, sr: int) -> np.ndarray:
        return speaker_embeddings(campplus_params, cp_cfg, [Utterance("", "", wav)],
                                  sample_rate=sr)[0]

    return embed


# ---------------------------------------------------------------------------
# Fold-wise dataset evaluation
# ---------------------------------------------------------------------------


def train_fold_classifiers(
    seed: int,
    cfg: SERHeadConfig,
    embs: Mapping[str, np.ndarray],
    utt2emo: Mapping[str, str],
    utt2spk: Mapping[str, str],
    spk2fold: Mapping[str, str],
    emotions: Sequence[str],
    device=None,
) -> Dict[str, Dict]:
    """Leave-fold-out heads: fold f's head trains on every utterance whose
    speaker is not in fold f, with a generator on `device` (the card unless
    given) seeded from `seed` and the fold's index."""
    from streamvoiceanon_tpu_torch import resolve_device

    dev = resolve_device(device)
    emo_index = {e: i for i, e in enumerate(emotions)}
    out = {}
    for i, fold in enumerate(sorted(set(spk2fold.values()))):
        ids = [u for u in embs if spk2fold[utt2spk[u]] != fold and utt2emo[u] in emo_index]
        x = np.stack([embs[u] for u in ids])
        y = np.asarray([emo_index[utt2emo[u]] for u in ids])
        g = torch.Generator(device=dev).manual_seed(speaker_seed(seed, i))
        out[fold] = train_head(g, cfg, x, y)
    return out


def evaluate_ser(
    eval_datasets: Sequence[str],
    eval_data_dir: Path,
    classifiers: Mapping[str, Dict],
    embed_fn: Callable[[np.ndarray, int], np.ndarray],
    emotions: Sequence[str],
    results_dir: Path,
    anon_data_suffix: str = "_anon",
    sample_rate: int = 16000,
) -> tables.Rows:
    """UAR per (test set, fold) and per-emotion accuracy: each speaker's
    utterances are scored by the head of that speaker's fold.  Writes the
    per-fold rows (dataset / split / fold / ser original-vs-anon / UAR /
    ACC_<emotion>) and their means over folds, and returns the means."""
    from streamvoiceanon_tpu_torch.audio.io import read_wav
    from streamvoiceanon_tpu_torch.evals.kaldi import read_kaldi_format

    eval_data_dir = Path(eval_data_dir)
    results_dir = Path(results_dir)
    emo_index = {e: i for i, e in enumerate(emotions)}
    test_sets = list(eval_datasets) + [f"{d}{anon_data_suffix}" for d in eval_datasets]
    rows = []
    for test_set in test_sets:
        data_path = eval_data_dir / test_set
        scp = read_kaldi_format(data_path / "wav.scp")
        utt2spk = read_kaldi_format(data_path / "utt2spk")
        utt2emo = read_kaldi_format(data_path / "utt2emo")
        spk2fold = read_kaldi_format(data_path / "spk2fold")
        embs = {}
        for utt_id, wav_path in scp.items():
            wav, _sr = read_wav(wav_path, target_sr=sample_rate)
            embs[utt_id] = np.asarray(embed_fn(np.asarray(wav), sample_rate))
        for spk, fold in sorted(spk2fold.items()):
            ids = [u for u in scp if utt2spk[u] == spk and utt2emo[u] in emo_index]
            if not ids:
                continue
            pred = classify(classifiers[fold], np.stack([embs[u] for u in ids]))
            ref = np.asarray([emo_index[utt2emo[u]] for u in ids])
            per_emo = {
                f"ACC_{e}": accuracy(ref[ref == emo_index[e]], pred[ref == emo_index[e]])
                for e in emotions
                if np.any(ref == emo_index[e])
            }
            info = test_set.split("_")
            rows.append({
                "dataset": info[0],
                "split": info[1] if len(info) > 1 else "_",
                "fold": fold,
                "ser": "anon" if anon_data_suffix in test_set else "original",
                "UAR": uar(ref, pred),
                **per_emo,
            })
    rows = tables.complete(rows)
    acc_cols = [c for c in tables.columns(rows) if c.startswith("ACC_")]
    mean = tables.mean_by(rows, ["dataset", "split", "ser"], ["UAR"] + acc_cols)
    results_dir.mkdir(parents=True, exist_ok=True)
    tables.write_csv(rows, results_dir / f"results_folds{anon_data_suffix}.csv")
    tables.write_csv(mean, results_dir / f"results{anon_data_suffix}.csv")
    return mean
