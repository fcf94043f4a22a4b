"""Kaldi-format data I/O, as the JAX package's evals/kaldi.py (the port's own
copy): read and save two-column Kaldi files (wav.scp, utt2spk, text,
utt2emo, spk2fold, ...) and merge data directories (`combine_asr_data`).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Iterable, Union

PathLike = Union[str, os.PathLike]


def read_kaldi_format(path: PathLike, values_as_string: bool = True) -> Dict[str, str]:
    """Reads a `key value...` file into a dict (data_io.py:14-30).

    With `values_as_string` the remainder of each line is kept as one
    string (needed for `text` transcripts); otherwise single-token values
    are returned as-is and multi-token ones as lists.
    """
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(None, 1)
            key = parts[0]
            rest = parts[1] if len(parts) > 1 else ""
            if values_as_string:
                out[key] = rest
            else:
                toks = rest.split()
                out[key] = toks[0] if len(toks) == 1 else toks
    return out


def save_kaldi_format(data: Dict[str, object], path: PathLike) -> None:
    """Writes a dict to a sorted two-column kaldi file (data_io.py:32-43)."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        for key in sorted(data.keys()):
            value = data[key]
            if isinstance(value, (list, tuple)):
                value = " ".join(str(v) for v in value)
            f.write(f"{key} {value}\n")


def combine_asr_data(in_dirs: Iterable[PathLike], out_dir: PathLike) -> None:
    """Merges multiple kaldi data dirs into one (run_evaluation.py:195,
    reference prepare_results_in_kaldi_format.combine_asr_data): concatenates
    wav.scp / utt2spk / text / spk2gender de-duplicated by key, and rebuilds
    spk2utt from the merged utt2spk."""
    in_dirs = list(in_dirs)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    utt2spk: Dict[str, str] = {}
    for fname in ("wav.scp", "utt2spk", "text", "spk2gender"):
        merged: Dict[str, str] = {}
        for d in in_dirs:
            src = Path(d) / fname
            if src.exists():
                merged.update(read_kaldi_format(src))
        if merged:
            save_kaldi_format(merged, out / fname)
            if fname == "utt2spk":
                utt2spk = merged
    if utt2spk:
        spk2utt: Dict[str, list] = {}
        for utt, spk in utt2spk.items():
            spk2utt.setdefault(spk, []).append(utt)
        save_kaldi_format({s: sorted(u) for s, u in spk2utt.items()},
                          out / "spk2utt")
