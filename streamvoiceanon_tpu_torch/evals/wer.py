"""Word-error-rate scoring and the ASR utility evaluation, as the JAX
package's evals/wer.py (the port's own copy; its table is a list of row
dicts, `evals/tables.py`).

Framework equivalent of the reference ASR utility eval
(`anon/evaluation/utility/asr/evaluate_asr.py:16-68` +
`speechbrain_asr/inference.py:86-104`, which defers to speechbrain's
`ErrorRateStats`): Levenshtein alignment per utterance, corpus WER =
100 * (substitutions + deletions + insertions) / reference tokens, a
per-utterance details file, and a results table over original/anonymized
dataset pairs.

The transcriber is pluggable (`wav -> text` callable) so the framework's
own ASR decoder head (`models/asr_decoder.greedy_decode`) or any external
model can back it; the reference hard-wires speechbrain EncoderASR.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from streamvoiceanon_tpu_torch.evals import tables
from streamvoiceanon_tpu_torch.evals.kaldi import read_kaldi_format, save_kaldi_format

# ---------------------------------------------------------------------------
# Edit-distance alignment
# ---------------------------------------------------------------------------


def align_tokens(ref: Sequence[str], hyp: Sequence[str]) -> List[Tuple[str, Optional[str], Optional[str]]]:
    """Minimum-edit alignment of two token sequences.

    Returns a list of (op, ref_token, hyp_token) with op in
    {'=', 'S', 'D', 'I'} — the same alignment speechbrain's
    ErrorRateStats derives for its details output.  Ties are broken
    preferring match/substitution over insertion over deletion, matching
    the conventional WER backtrace order.
    """
    n, m = len(ref), len(hyp)
    # DP over cost; int32 table is fine at utterance scale.
    cost = np.zeros((n + 1, m + 1), np.int32)
    cost[:, 0] = np.arange(n + 1)
    cost[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        ri = ref[i - 1]
        row = cost[i]
        prev = cost[i - 1]
        for j in range(1, m + 1):
            sub = prev[j - 1] + (ri != hyp[j - 1])
            ins = row[j - 1] + 1
            dele = prev[j] + 1
            row[j] = min(sub, ins, dele)
    # Backtrace.
    out: List[Tuple[str, Optional[str], Optional[str]]] = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and cost[i, j] == cost[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            op = "=" if ref[i - 1] == hyp[j - 1] else "S"
            out.append((op, ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif j > 0 and cost[i, j] == cost[i, j - 1] + 1:
            out.append(("I", None, hyp[j - 1]))
            j -= 1
        else:
            out.append(("D", ref[i - 1], None))
            i -= 1
    out.reverse()
    return out


@dataclasses.dataclass
class UttScore:
    utt_id: str
    num_ref: int
    substitutions: int
    deletions: int
    insertions: int
    alignment: List[Tuple[str, Optional[str], Optional[str]]]

    @property
    def errors(self) -> int:
        return self.substitutions + self.deletions + self.insertions

    @property
    def wer(self) -> float:
        return 100.0 * self.errors / max(self.num_ref, 1)


class ErrorRateStats:
    """Accumulating WER scorer (speechbrain ErrorRateStats semantics:
    inference.py:87-104 uses append + summarize('error_rate') +
    write_stats)."""

    def __init__(self):
        self.scores: List[UttScore] = []

    def append(self, ids: Sequence[str], predict: Sequence[Sequence[str]],
               target: Sequence[Sequence[str]]) -> None:
        for utt_id, hyp, ref in zip(ids, predict, target):
            ali = align_tokens(list(ref), list(hyp))
            self.scores.append(
                UttScore(
                    utt_id=utt_id,
                    num_ref=len(ref),
                    substitutions=sum(op == "S" for op, _, _ in ali),
                    deletions=sum(op == "D" for op, _, _ in ali),
                    insertions=sum(op == "I" for op, _, _ in ali),
                    alignment=ali,
                )
            )

    def summarize(self, field: str = "error_rate") -> float:
        num_ref = sum(s.num_ref for s in self.scores)
        totals = {
            "substitutions": sum(s.substitutions for s in self.scores),
            "deletions": sum(s.deletions for s in self.scores),
            "insertions": sum(s.insertions for s in self.scores),
            "num_ref_tokens": num_ref,
            "num_utts": len(self.scores),
        }
        totals["errors"] = (
            totals["substitutions"] + totals["deletions"] + totals["insertions"]
        )
        totals["error_rate"] = 100.0 * totals["errors"] / max(num_ref, 1)
        if field == "all":
            return totals  # type: ignore[return-value]
        return totals[field]

    def write_stats(self, f) -> None:
        """Per-utterance details file (the `wer` artifact of
        evaluate_asr.py:51-58)."""
        t = self.summarize("all")
        f.write(
            "%WER {:.2f} [ {} / {}, {} ins, {} del, {} sub ] over {} utts\n".format(
                t["error_rate"], t["errors"], t["num_ref_tokens"],
                t["insertions"], t["deletions"], t["substitutions"], t["num_utts"],
            )
        )
        for s in self.scores:
            f.write(
                "{} %WER {:.2f} [ {} / {}, {} ins, {} del, {} sub ]\n".format(
                    s.utt_id, s.wer, s.errors, s.num_ref,
                    s.insertions, s.deletions, s.substitutions,
                )
            )
            ref_row = " ".join((r if r is not None else "***") for _, r, _ in s.alignment)
            hyp_row = " ".join((h if h is not None else "***") for _, _, h in s.alignment)
            ops_row = " ".join(op for op, _, _ in s.alignment)
            f.write(f"  ref: {ref_row}\n  hyp: {hyp_row}\n  ops: {ops_row}\n")


def _tokenize(texts: Sequence[str]) -> List[List[str]]:
    """Whitespace tokenization (inference.py:54-58 plain_text_key)."""
    return [t.strip().split() for t in texts]


def compute_wer(ref_texts: Dict[str, str], hyp_texts: Dict[str, str],
                out_file: Optional[Path] = None) -> ErrorRateStats:
    stats = ErrorRateStats()
    ids = sorted(ref_texts.keys())
    stats.append(
        ids=ids,
        predict=_tokenize([hyp_texts.get(i, "") for i in ids]),
        target=_tokenize([ref_texts[i] for i in ids]),
    )
    if out_file is not None:
        out_file = Path(out_file)
        out_file.parent.mkdir(parents=True, exist_ok=True)
        with open(out_file, "w") as f:
            stats.write_stats(f)
    return stats


# ---------------------------------------------------------------------------
# Dataset-level evaluation (evaluate_asr.py:25-68)
# ---------------------------------------------------------------------------


def evaluate_asr(
    eval_datasets: Sequence[str],
    eval_data_dir: Path,
    transcriber: Callable[[np.ndarray, int], str],
    results_dir: Path,
    anon_data_suffix: str = "_anon",
    sample_rate: int = 16000,
):
    """WER over each dataset and its anonymized counterpart.

    `transcriber(wav, sr) -> text` supplies hypotheses; they are cached to
    `<results_dir>/<test_set>/text` so re-runs skip transcription, exactly
    like the reference's existing-results short-circuit
    (evaluate_asr.py:47-51).  Returns the rows of the reference's results
    CSV (dataset / split / asr original-vs-anon / WER).
    """
    from streamvoiceanon_tpu_torch.audio.io import read_wav

    eval_data_dir = Path(eval_data_dir)
    results_dir = Path(results_dir)
    test_sets = list(eval_datasets) + [f"{d}{anon_data_suffix}" for d in eval_datasets]
    rows = []
    for test_set in test_sets:
        data_path = eval_data_dir / test_set
        references = read_kaldi_format(data_path / "text")
        hyp_file = results_dir / test_set / "text"
        if hyp_file.exists():
            hypotheses = read_kaldi_format(hyp_file)
        else:
            if transcriber is None:
                raise FileNotFoundError(
                    f"no cached hypotheses at {hyp_file} and no transcriber given"
                )
            scp = read_kaldi_format(data_path / "wav.scp")
            hypotheses = {}
            for utt_id, wav_path in scp.items():
                wav, _sr = read_wav(wav_path, target_sr=sample_rate)
                hypotheses[utt_id] = transcriber(np.asarray(wav), sample_rate)
            save_kaldi_format(hypotheses, hyp_file)
        stats = compute_wer(references, hypotheses, results_dir / test_set / "wer")
        wer = stats.summarize("error_rate")
        info = test_set.split("_")
        rows.append(
            {
                "dataset": info[0],
                "split": info[1] if len(info) > 1 else "_",
                "asr": "anon" if anon_data_suffix in test_set else "original",
                "WER": round(wer, 3),
            }
        )
    rows = tables.complete(rows)
    results_dir.mkdir(parents=True, exist_ok=True)
    tables.write_csv(rows, results_dir / f"results{anon_data_suffix}.csv")
    return rows
