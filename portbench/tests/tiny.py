"""A tiny copy of the benchmark for CPU tests: `portbench/` copied into a
temporary root, each configuration and traffic mix cut by the kind of the
cells that use it (`tests/kinds/<driver>.py`, found by the traffic's
`driver`), and cells resolved from a BENCHMARK object."""

from __future__ import annotations

import json
import shutil
import types
from pathlib import Path

from portbench import core

REPO = Path(__file__).resolve().parents[2]


def bench() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def kind_file(bench: dict, name: str, root: Path = core.ROOT) -> Path:
    """Where the tests' knowledge of the cell `name`'s kind lies:
    `tests/kinds/<driver>.py` under root, for the driver its traffic names."""
    return root / "tests" / "kinds" / f"{core.cell(bench, name, root).traffic['driver']}.py"


def kinded(bench: dict, root: Path = core.ROOT) -> list:
    """The cells whose kind file is there.  A cell without one has no tiny
    run, fault case or configuration check: `test_cell_resolves` fails for
    it, naming the file."""
    return [w["name"] for w in bench["workloads"] if kind_file(bench, w["name"], root).is_file()]


def kind(bench: dict, name: str, root: Path = core.ROOT) -> types.ModuleType:
    """The kind of the cell `name` (`kind_file`), loaded as the drivers are."""
    path = kind_file(bench, name, root)
    if not path.is_file():
        raise FileNotFoundError(f"cell {name!r} needs the kind file {path}")
    return core.load_module(path)


def make_root(tmp: Path, benchmark: dict = None, src: Path = REPO / "portbench") -> Path:
    """A tiny benchmark root under tmp, copied from `src` (the repo's
    `portbench/` unless given); returns its `portbench` directory.  Only
    the cells of `kinded` are cut."""
    benchmark = benchmark or bench()
    root = tmp / "portbench"
    shutil.copytree(src, root, ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    shutil.copytree(src / "tests" / "kinds", root / "tests" / "kinds",
                    ignore=shutil.ignore_patterns("__pycache__"))
    files = {c["name"]: root.parent / c["file"] for c in benchmark["configs"]}
    wl = {w["name"]: w for w in benchmark["workloads"]}
    cut = set()
    for name in kinded(benchmark, root):
        k = kind(benchmark, name, root)
        for f, fn in ((files[wl[name]["config"]], k.tiny_config),
                      (root / "traffic" / f"{wl[name]['traffic']}.json", k.tiny_traffic)):
            if f not in cut:
                f.write_text(json.dumps(fn(json.loads(f.read_text()))))
                cut.add(f)
    return root
