"""A tiny run on the CPU gives the contract's result line; without a card
the command refuses and prints no result."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.tests import steps, tiny

BENCH = tiny.bench()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_root(tmp_path_factory.mktemp("pb"))


@pytest.mark.parametrize("name", tiny.kinded(BENCH))
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_line(root, name, trace):
    steps.tiny_line(BENCH, name, root, trace, 2 ** 35 + 17)


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
        "for name in tiny.kinded(tiny.bench(), root):\n"
        "    run_cell(tiny.bench(), name, 5, 1.0, False, 'cpu', root=root)\n"
        "print(json.dumps(core.forbidden_modules()))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []
