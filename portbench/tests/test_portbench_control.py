"""On the card: each cell's control (the reference in the next lower
precision than the configuration states, put in the program's place) fails
the cell's limits on three seeds, while the program on the same seeds
passes them.  Run it with `python -m pytest portbench/tests -m gpu` on a
machine with a CUDA card; it skips without one."""

import pytest
import torch

from portbench import core
from portbench.run import run_cell

BENCH = core.load_json(core.ROOT.parent / "BENCHMARK.json")


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    core.cache_dirs(core.ROOT.parent)
    limits = core.load_json(core.ROOT / "limits" / f"{name}.json")
    for seed in (2 ** 32 + 101, 2 ** 32 + 202, 2 ** 32 + 303):
        res = run_cell(BENCH, name, seed, 4.0, False, "cuda", control=True)
        assert res["correct"], res["checks"]
        nums = res["control_numbers"]
        failed = [k for k, lim in limits.items() if nums.get("control_" + k, 0.0) > lim]
        assert failed, {k: nums.get("control_" + k) for k in limits}
