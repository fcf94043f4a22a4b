"""Every cell resolves to its files by name; a new cell needs only new files."""

import json

import pytest
import torch

from portbench import core
from portbench.run import run_cell
from portbench.tests import tiny

BENCH = tiny.bench()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(name):
    cell = core.cell(BENCH, name)
    assert cell.config["name"] == cell.workload["config"]
    assert core.driver(cell.traffic).run
    assert (core.ROOT / "limits" / f"{name}.json").exists()
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(core.reader(m["name"]))


def test_every_metric_names_a_reported_end_to_end_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(target.get("workloads", m["workloads"]))


def test_config_files_match_the_port_config():
    """Each configuration file builds the port's PipelineConfig field for field."""
    import dataclasses

    for c in BENCH["configs"]:
        d = core.load_json(core.ROOT.parent / c["file"])
        cfg = core.port_config(d["pipeline"])
        assert json.loads(json.dumps(dataclasses.asdict(cfg))) == d["pipeline"]


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
