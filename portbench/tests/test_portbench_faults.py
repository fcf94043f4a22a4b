"""The timed path broken underneath a whole tiny run on the CPU: `correct`
comes out false.  Each cell's faults are its kind's (`tests/kinds/<driver>.py`,
`FAULTS`); a cell whose kind file is missing has none, and fails
`test_cell_resolves`."""

import pytest
import torch

from portbench.tests import steps, tiny

BENCH = tiny.bench()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_root(tmp_path_factory.mktemp("pb"))


CASES = [pytest.param(n, f, id=f"{n}-{f.__name__}")
         for n in tiny.kinded(BENCH) for f in tiny.kind(BENCH, n).FAULTS]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_caught(root, name, fault, monkeypatch):
    steps.fault_caught(BENCH, name, root, fault, monkeypatch)
