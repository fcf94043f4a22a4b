"""A tiny run on the CPU gives the contract's result line; without a card
the command refuses and prints no result."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.run import run_cell
from portbench.tests import tiny

BENCH = tiny.bench()
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_root(tmp_path_factory.mktemp("pb"))


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_line(root, name, trace):
    res = run_cell(BENCH, name, 2 ** 35 + 17, 2.0, bool(trace), "cpu", root=root)
    line = json.loads(json.dumps(res))
    want = KEYS | ({"breakdown"} if trace else set())
    assert set(line) == want
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    cell = [w for w in BENCH["workloads"] if w["name"] == name][0]
    if not trace:
        names = {m["name"] for m in BENCH["end_to_end"]
                 if "workloads" not in m or name in m["workloads"]}
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    assert cell["chips"] == 1


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(tiny.REPO / "portbench" / "run.py"), "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_loads_no_jax(tmp_path):
    """A tiny run in a fresh process loads neither JAX nor the JAX package
    (top-level module names compared whole)."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(tiny.REPO)!r})\n"
        "import torch; torch.set_num_threads(2)\n"
        "from pathlib import Path\n"
        "from portbench.tests import tiny\n"
        "from portbench.run import run_cell\n"
        "from portbench import core\n"
        f"root = tiny.make_root(Path({str(tmp_path)!r}))\n"
        "for w in tiny.bench()['workloads']:\n"
        "    run_cell(tiny.bench(), w['name'], 5, 1.0, False, 'cpu', root=root)\n"
        "print(json.dumps(core.forbidden_modules()))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []
