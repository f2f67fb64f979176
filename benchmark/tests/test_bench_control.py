"""Each cell's control, the reference with one guarantee broken put in the
program's place, fails the cell's checks, while the program passes them;
at a size a test run holds (``python3 -m benchmark.control`` reads the same
on the card at the cells' own sizes)."""

import pytest
import torch

from benchmark import control
from conftest import SEED, tiny_bench, tiny_layout, workloads


@pytest.mark.parametrize("seed", [SEED, 7, 2**33 + 5])
@pytest.mark.parametrize("workload", workloads())
def test_control_fails_and_program_passes(workload, seed):
    r = control.readings(tiny_bench(), workload, seed, 0.1,
                         torch.device("cpu"), tiny_layout())
    assert r["failed"] == 0
    assert all(r["program"][k] <= lim for k, lim in r["limits"].items()), r
    assert any(r["control"][k] > lim for k, lim in r["limits"].items()), r
