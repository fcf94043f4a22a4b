"""The checks the harness's CPU tests make of a cell, each given the
BENCHMARK object and the benchmark root: the parametrised tests run them on
every cell of `BENCHMARK.json`, and the throwaway-kind test on a kind added
as new files only."""

from __future__ import annotations

import json
from pathlib import Path

from portbench import core
from portbench.run import run_cell
from portbench.tests import tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def resolves(bench: dict, name: str, root: Path) -> None:
    """The cell finds its configuration, traffic, driver, limits, kind and readers by name."""
    cell = core.cell(bench, name, root)
    assert cell.config["name"] == cell.workload["config"]
    assert core.driver(cell.traffic, root).run
    assert (root / "limits" / f"{name}.json").exists()
    kind = tiny.kind(bench, name, root)
    assert kind.tiny_config and kind.tiny_traffic and kind.FAULTS and kind.check_config
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(core.reader(m["name"], root))


def tiny_line(bench: dict, name: str, root: Path, trace: int, seed: int) -> dict:
    """A tiny run on the CPU gives the contract's result line, `correct` true."""
    res = run_cell(bench, name, seed, 2.0, bool(trace), "cpu", root=root)
    line = json.loads(json.dumps(res))
    want = KEYS | ({"breakdown"} if trace else set())
    assert set(line) == want
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    cell = [w for w in bench["workloads"] if w["name"] == name][0]
    if not trace:
        names = {m["name"] for m in bench["end_to_end"]
                 if "workloads" not in m or name in m["workloads"]}
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    assert cell["chips"] == 1
    return line


def fault_caught(bench: dict, name: str, root: Path, fault, monkeypatch) -> None:
    """With the timed path broken underneath, `correct` comes out false."""
    fault(monkeypatch, root)
    res = run_cell(bench, name, 2 ** 36 + 9, 2.0, False, "cpu", root=root)
    assert not res["correct"], res["checks"]


def config_matches(bench: dict, config: str, root: Path) -> None:
    """The configuration file holds what the program builds from it, by the
    check of each kind of cell that uses it (the cells of `tiny.kinded`)."""
    entry = {c["name"]: c for c in bench["configs"]}[config]
    d = core.load_json(root.parent / entry["file"])
    users = [w["name"] for w in bench["workloads"] if w["config"] == config]
    assert users, f"no cell uses {config}"
    for name in set(users) & set(tiny.kinded(bench, root)):
        tiny.kind(bench, name, root).check_config(d, root)
