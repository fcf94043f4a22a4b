"""Result tables without pandas: a table is a list of row dicts.

The JAX package's evals return pandas DataFrames; the port's return
`complete` rows instead (every row holds every column, in the order the
columns first appear, NaN where a row lacks one: what a DataFrame's
`to_dict("records")` gives), written with the `csv` module in the layout
of `DataFrame.to_csv` (a leading index column, NaN as an empty field,
floats by their shortest repr), so the file parses back to the same rows.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path
from typing import Dict, List, Sequence

Rows = List[Dict[str, object]]


def columns(rows: Rows) -> List[str]:
    """Every key of `rows`, in the order keys first appear."""
    out: Dict[str, None] = {}
    for r in rows:
        out.update(dict.fromkeys(r))
    return list(out)


def complete(rows: Rows) -> Rows:
    """Each row with every column of the table, NaN where it had none."""
    cols = columns(rows)
    return [{c: r.get(c, math.nan) for c in cols} for r in rows]


def _is_nan(v) -> bool:
    return isinstance(v, float) and math.isnan(v)


def _field(v) -> str:
    if v is None or _is_nan(v):
        return ""
    if isinstance(v, float):
        return repr(float(v))
    return str(v)


def write_csv(rows: Rows, path) -> None:
    """`rows` as `pandas.DataFrame(rows).to_csv(path)` writes them."""
    rows = complete(rows)
    cols = columns(rows)
    with open(Path(path), "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + cols)
        for i, r in enumerate(rows):
            w.writerow([str(i)] + [_field(r[c]) for c in cols])


def mean_by(rows: Rows, keys: Sequence[str], values: Sequence[str]) -> Rows:
    """Rows grouped by `keys` (groups in sorted key order), each with the mean
    of every column of `values` over the group's non-NaN entries (NaN when
    there are none): `df.groupby(keys).agg(mean).reset_index()`."""
    groups: Dict[tuple, Rows] = {}
    for r in rows:
        groups.setdefault(tuple(r[k] for k in keys), []).append(r)
    out = []
    for key in sorted(groups):
        row = dict(zip(keys, key))
        for v in values:
            xs = [float(r[v]) for r in groups[key] if v in r and not _is_nan(r[v])]
            row[v] = sum(xs) / len(xs) if xs else math.nan
        out.append(row)
    return out


def sort_rows(rows: Rows, keys: Sequence[str]) -> Rows:
    """A stable sort by `keys`."""
    return sorted(rows, key=lambda r: tuple(r[k] for k in keys))


def to_string(rows: Rows) -> str:
    """A plain text table: a header of the columns, then one aligned line a
    row, floats as their shortest repr and NaN as "NaN"."""
    rows = complete(rows)
    cols = columns(rows)
    cells = [[""] + cols] + [[str(i)] + [("NaN" if _is_nan(r[c]) else _field(r[c]))
                                         for c in cols] for i, r in enumerate(rows)]
    widths = [max(len(row[j]) for row in cells) for j in range(len(cells[0]))]
    return "\n".join("  ".join(cell.rjust(w) for cell, w in zip(row, widths))
                     for row in cells)
