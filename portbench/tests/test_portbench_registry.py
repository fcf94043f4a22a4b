"""Every cell resolves to its files by name; a new cell, and a new kind of
cell, needs only new files."""

import json
import shutil

import pytest
import torch

from portbench import core
from portbench.run import run_cell
from portbench.tests import steps, tiny

BENCH = tiny.bench()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(name):
    steps.resolves(BENCH, name, core.ROOT)


def test_every_metric_names_a_reported_end_to_end_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(target.get("workloads", m["workloads"]))


def test_config_files_match_the_port_config():
    """Each configuration file holds what the program builds from it, by
    its kind's check (the converter's kinds: the port's PipelineConfig
    field for field)."""
    for c in BENCH["configs"]:
        steps.config_matches(BENCH, c["name"], core.ROOT)


def test_a_throwaway_cell_needs_only_new_files(tmp_path):
    """A cell, a traffic mix, a limits file and a per-layer metric added as
    files and entries only, then run at tiny size on the CPU."""
    root = tiny.make_root(tmp_path)
    tr = json.loads((root / "traffic" / "vpc-testclean.json").read_text())
    tr["ref_seconds"] = 1.5
    (root / "traffic" / "throwaway-mix.json").write_text(json.dumps(tr))
    (root / "limits" / "throwaway-cell.json").write_text(
        (root / "limits" / "anon-vpc.json").read_text())
    (root / "metrics" / "throwaway_ms.py").write_text(
        "from portbench import readers\n\n\ndef read(r):\n"
        "    return readers.span_median(r, 'generate')\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "throwaway-cell", "config": "sva-convert",
                               "traffic": "throwaway-mix", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "audio_s_per_s":
            m["workloads"].append("throwaway-cell")
    bench["per_layer"].append({"name": "throwaway_ms", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "LM generate",
                               "moves": "audio_s_per_s", "workloads": ["throwaway-cell"]})
    res = run_cell(bench, "throwaway-cell", 2 ** 40 + 3, 1.5, True, "cpu", root=root)
    assert "throwaway_ms" in res["metrics"]
    assert res["correct"], res["checks"]


def test_a_throwaway_kind_needs_only_new_files(tmp_path):
    """A cell of a kind the benchmark has no driver for (`tests/throwaway/`:
    a plain forward in float16 checked against float64, its configuration
    with no `pipeline`), added to a copy of `portbench/` as new files and
    entries only, passes the checks each cell of BENCHMARK.json gets:
    it resolves, runs tiny at --trace 0 and 1 with `correct` true, has each
    of its faults caught, and its configuration check holds."""
    extra = tiny.REPO / "portbench" / "tests" / "throwaway"
    src = tmp_path / "src" / "portbench"
    shutil.copytree(tiny.REPO / "portbench", src, ignore=shutil.ignore_patterns(
        ".cache", "__pycache__", "throwaway"))
    for f in extra.rglob("*"):
        if f.is_file() and f.name != "entries.json" and "__pycache__" not in f.parts:
            dst = src / f.relative_to(extra)
            assert not dst.exists(), dst
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(f, dst)
    bench = json.loads(json.dumps(BENCH))
    entries = json.loads((extra / "entries.json").read_text())
    for key, added in entries.items():
        assert not {e["name"] for e in added} & {e["name"] for e in bench[key]}
        bench[key] += added
    root = tiny.make_root(tmp_path / "t", bench, src=src)
    name = "throwaway-mlp-rows"
    cfg = core.cell(bench, name, root).config
    assert "pipeline" not in cfg and core.DTYPES[cfg["dtype"]] == torch.float16
    steps.resolves(bench, name, root)
    for trace in (0, 1):
        line = steps.tiny_line(bench, name, root, trace, 2 ** 40 + 5)
        assert ("throwaway_forward_ms" if trace else "rows_per_s") in line["metrics"]
    for fault in tiny.kind(bench, name, root).FAULTS:
        with pytest.MonkeyPatch.context() as mp:
            steps.fault_caught(bench, name, root, fault, mp)
    steps.config_matches(bench, "throwaway-mlp", root)
