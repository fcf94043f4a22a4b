"""Evaluation orchestration and the results summary, as the JAX package's
evals/harness.py: a typed config selects the privacy step (ASV, with the
optional ASV_eval^anon retraining) and the utility steps (SER, ASR), which
run over Kaldi directories laid out as `<name>` and `<name><anon suffix>`
and write `results_summary.txt` with the reference's sections.

The steps return lists of row dicts (`evals/tables.py`) with the columns of
the JAX package's DataFrames, and write the same CSV files.  CAM++, the
attackers' training and the SER heads run on the device of the CAM++
parameters (`params.campplus_params`).
"""

from __future__ import annotations

import dataclasses
from datetime import datetime
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from streamvoiceanon_tpu_torch.evals import tables


@dataclasses.dataclass
class ASVStep:
    """The privacy step."""

    enrolls: Sequence[str]          # Kaldi directory names (original); _anon suffixed
    trials: Sequence[str]
    train_asv_on_anon: bool = False  # eval_post: retrain ASV on anonymized data
    train_dirs: Sequence[str] = ()   # directories to retrain on (e.g. libri-360_anon)
    distance: str = "cosine"         # 'cosine' | 'plda'
    # the ASV_eval^anon attacker: 'campplus' fine-tunes a head on the CAM++
    # backbone, 'ecapa' trains an ECAPA-TDNN from random init (the VPC protocol)
    anon_backbone: str = "campplus"  # 'campplus' | 'ecapa'
    ecapa_cfg: Optional[object] = None  # evals.ecapa_asv.ECAPAASVConfig override
    campplus_cfg: Optional[object] = None  # evals.asv_train.ASVTrainConfig override


@dataclasses.dataclass
class SERStep:
    datasets: Sequence[str]
    emotions: Sequence[str] = ("neu", "hap", "sad", "ang")


@dataclasses.dataclass
class ASRStep:
    datasets: Sequence[str]


@dataclasses.dataclass
class EvalConfig:
    data_dir: Path
    results_dir: Path
    anon_data_suffix: str = "_anon"
    asv: Optional[ASVStep] = None
    ser: Optional[SERStep] = None
    asr: Optional[ASRStep] = None
    sample_rate: int = 44100


def _load(data_dir: Path, name: str, sample_rate: int):
    from streamvoiceanon_tpu_torch.evals.anonymize import load_kaldi_dir

    return load_kaldi_dir(str(Path(data_dir) / name), sample_rate=sample_rate)


def _split(trial_name: str) -> Dict[str, str]:
    return {"dataset": trial_name.split("_")[0],
            "split": "_".join(trial_name.split("_")[1:]) or "_"}


def run_asv_step(cfg: EvalConfig, step: ASVStep, campplus_params, cp_cfg) -> tables.Rows:
    """The OO / OA / AA rows of each (enrollment, trial) pair; with
    `train_asv_on_anon` also an AA row scored by the model retrained on the
    anonymized `train_dirs` (ASV_eval^anon)."""
    from streamvoiceanon_tpu_torch.evals import asv_train as at
    from streamvoiceanon_tpu_torch.evals import ecapa_asv as ea
    from streamvoiceanon_tpu_torch.evals import privacy_metrics as pm
    from streamvoiceanon_tpu_torch.evals.anonymize import (asv_scenarios, trial_scores,
                                                           tree_device)

    rows: List[Dict] = []
    trained = ecapa_model = ecapa_cfg = None
    if step.train_asv_on_anon and step.train_dirs:
        train_utts = []
        for d in step.train_dirs:
            train_utts.extend(_load(cfg.data_dir, d, cfg.sample_rate))
        if step.anon_backbone == "ecapa":
            ecapa_cfg = step.ecapa_cfg or ea.ECAPAASVConfig()
            ecapa_model = ea.train_ecapa_asv(train_utts, ecapa_cfg,
                                             utt_sample_rate=cfg.sample_rate,
                                             device=tree_device(campplus_params))
        else:
            trained = at.train_asv_eval(campplus_params, cp_cfg, train_utts,
                                        step.campplus_cfg or at.ASVTrainConfig(),
                                        utt_sample_rate=cfg.sample_rate)

    dir_cache: Dict[str, list] = {}
    emb_cache: Dict = {}

    def load_cached(name: str):
        if name not in dir_cache:
            dir_cache[name] = _load(cfg.data_dir, name, cfg.sample_rate)
        return dir_cache[name]

    cond_names = {"OO": ("original", "original"), "OA": ("original", "anon"),
                  "AA": ("anon", "anon")}
    for enroll_name in step.enrolls:
        for trial_name in step.trials:
            enroll = load_cached(enroll_name)
            trial = load_cached(trial_name)
            enroll_anon = load_cached(enroll_name + cfg.anon_data_suffix)
            trial_anon = load_cached(trial_name + cfg.anon_data_suffix)
            res = asv_scenarios(enroll, trial, trial_anon, campplus_params, cp_cfg,
                                enroll_anon=enroll_anon, distance=step.distance,
                                emb_cache=emb_cache, sample_rate=cfg.sample_rate)
            for cond, metrics in res.items():
                e_kind, t_kind = cond_names[cond]
                rows.append({
                    **_split(trial_name),
                    "enrollment": e_kind, "trial": t_kind,
                    "EER": round(100.0 * metrics["eer"], 3),
                    "cllr_min": round(metrics["cllr_min"], 4),
                    "linkability": round(metrics["linkability"], 4),
                    "model": "ASV_eval",
                })
            if trained is None and ecapa_model is None:
                continue
            if ecapa_model is not None:
                embs = [ea.extract_embeddings(ecapa_model, ecapa_cfg, u,
                                              sample_rate=cfg.sample_rate)
                        for u in (enroll_anon, trial_anon)]
            else:
                embs = [at.extract_embeddings(trained, cp_cfg, u, sample_rate=cfg.sample_rate)
                        for u in (enroll_anon, trial_anon)]
            tar, non = trial_scores(embs[0], np.asarray([u.speaker for u in enroll_anon]),
                                    embs[1], np.asarray([u.speaker for u in trial_anon]),
                                    step.distance)
            rows.append({
                **_split(trial_name),
                "enrollment": "anon", "trial": "anon",
                "EER": round(100.0 * pm.eer(tar, non)[0], 3),
                "cllr_min": round(pm.min_cllr(tar, non), 4),
                "linkability": round(pm.linkability(tar, non), 4),
                "model": "ASV_eval_anon",
                "backbone": step.anon_backbone,
            })
    rows = tables.complete(rows)
    out = Path(cfg.results_dir)
    out.mkdir(parents=True, exist_ok=True)
    tables.write_csv(rows, out / f"asv_results{cfg.anon_data_suffix}.csv")
    return rows


def run_evaluation(
    cfg: EvalConfig,
    campplus_params=None,
    cp_cfg=None,
    transcriber: Optional[Callable] = None,
    ser_classifiers=None,
    ser_embed_fn=None,
) -> Dict[str, tables.Rows]:
    """Run the selected steps and write the results summary.  Returns
    {'asv': rows, 'ser': rows, 'asr': rows} for the steps configured; a step
    that fails is raised after the summary of the others is written."""
    results: Dict[str, tables.Rows] = {}
    errors: List[BaseException] = []

    def step(name, fn):
        try:
            results[name] = fn()
        except Exception as e:  # noqa: BLE001 (raised after the summary)
            errors.append(e)

    if cfg.asv is not None:
        step("asv", lambda: run_asv_step(cfg, cfg.asv, campplus_params, cp_cfg))
    if cfg.ser is not None:
        from streamvoiceanon_tpu_torch.evals.anonymize import tree_device
        from streamvoiceanon_tpu_torch.evals.ser import (SERHeadConfig, campplus_embed_fn,
                                                         evaluate_ser,
                                                         train_fold_classifiers)

        if ser_embed_fn is None:
            ser_embed_fn = campplus_embed_fn(campplus_params, cp_cfg)

        def fit_fold_heads(dataset: str):
            # leave-fold-out heads fit on the dataset's original data
            from streamvoiceanon_tpu_torch.audio.io import read_wav
            from streamvoiceanon_tpu_torch.evals.kaldi import read_kaldi_format

            d = Path(cfg.data_dir) / dataset
            scp = read_kaldi_format(d / "wav.scp")
            embs = {}
            for u, p in scp.items():
                wav, sr = read_wav(p)
                embs[u] = ser_embed_fn(np.asarray(wav), sr)
            head_cfg = SERHeadConfig(emb_dim=next(iter(embs.values())).shape[-1],
                                     n_classes=len(cfg.ser.emotions))
            return train_fold_classifiers(
                0, head_cfg, embs, read_kaldi_format(d / "utt2emo"),
                read_kaldi_format(d / "utt2spk"), read_kaldi_format(d / "spk2fold"),
                list(cfg.ser.emotions), device=tree_device(campplus_params))

        def run_ser():
            # heads given by the caller apply to every set; else each dataset
            # gets its own fit
            rows = []
            for ds in cfg.ser.datasets:
                clfs = ser_classifiers if ser_classifiers is not None else fit_fold_heads(ds)
                rows += evaluate_ser([ds], Path(cfg.data_dir), clfs, embed_fn=ser_embed_fn,
                                     emotions=list(cfg.ser.emotions),
                                     results_dir=Path(cfg.results_dir) / "ser" / ds,
                                     anon_data_suffix=cfg.anon_data_suffix)
            return tables.complete(rows)

        step("ser", run_ser)
    if cfg.asr is not None:
        from streamvoiceanon_tpu_torch.evals.wer import evaluate_asr

        step("asr", lambda: evaluate_asr(
            list(cfg.asr.datasets), Path(cfg.data_dir), transcriber,
            results_dir=Path(cfg.results_dir) / "asr",
            anon_data_suffix=cfg.anon_data_suffix))
    if results:
        save_result_summary(Path(cfg.results_dir) / "results_summary.txt", results)
    if errors:
        raise errors[0]
    return results


def make_submission(summary_paths: Sequence[Path], results_dir: Path, out_zip: Path,
                    anon_data_suffix: str = "_anon") -> Path:
    """Merge result summaries and zip the per-metric artifacts: a
    `result_for_rank` file of the concatenated summaries, and every results
    file under `results_dir` that carries the anon suffix or is a summary."""
    import zipfile

    out_zip = Path(out_zip)
    out_zip.parent.mkdir(parents=True, exist_ok=True)
    rank_file = out_zip.parent / f"result_for_rank{anon_data_suffix}"
    with open(rank_file, "w") as f:
        for i, p in enumerate(summary_paths):
            if i:
                f.write("\n")
            f.write(Path(p).read_text())
    results_dir = Path(results_dir)
    with zipfile.ZipFile(out_zip, "w", zipfile.ZIP_DEFLATED) as z:
        z.write(rank_file, rank_file.name)
        for p in sorted(results_dir.rglob("*")):
            if p.is_file() and (anon_data_suffix in p.name or p.name == "results_summary.txt"):
                z.write(p, p.relative_to(results_dir.parent))
    return out_zip


def save_result_summary(out_path: Path, results: Dict[str, tables.Rows]) -> None:
    """The text summary in the reference's section layout, each table
    sorted by dataset and split."""
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)

    def section(title, rows):
        f.write(f"\n---- {title} ----\n")
        f.write(tables.to_string(tables.sort_rows(rows, ["dataset", "split"])))
        f.write("\n")

    with open(out_path, "w") as f:
        f.write(f"---- Time: {datetime.today().strftime('%d-%m-%y_%H:%M')} ----\n")
        f.write(
            "NOTE: metrics are comparable across systems evaluated under this\n"
            "harness.  They are only comparable to published VPC2024 numbers\n"
            "when the evaluation models (ASV_eval / ASR_eval) are loaded from\n"
            "the published checkpoints rather than trained in-framework.\n"
        )
        if "ser" in results:
            section("SER results", results["ser"])
        if "asv" in results:
            rows = results["asv"]
            section("ASV_eval results", [r for r in rows if r["model"] == "ASV_eval"])
            anon = [r for r in rows if r["model"] == "ASV_eval_anon"]
            if anon:
                section("ASV_eval^anon results", anon)
        if "asr" in results:
            section("ASR results", results["asr"])
