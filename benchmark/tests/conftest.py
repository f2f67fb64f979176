"""Settings of the benchmark's own tests: the ``cuda`` marker, one torch
thread, and the cells of BENCHMARK.json on tiny configurations."""

import copy
import json

import pytest
import torch

from benchmark import run

TINY = {"upstream_10Mx200M_zipf105": "tiny_zipf",
        "kimb_128Mx128M_uniform": "tiny_uniform"}
#: Any whole number is a seed; a large one tests the seeding.
SEED = 2**31 + 977


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def card():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def tiny_bench() -> dict:
    """BENCHMARK.json with every cell on its tiny configuration."""
    bench = copy.deepcopy(json.loads(run.BENCHMARK_JSON.read_text()))
    for w in bench["workloads"]:
        w["config"] = TINY[w["config"]]
    return bench


def tiny_layout(**kw) -> run.Layout:
    return run.Layout(configs=run.HERE / "tests" / "configs", **kw)


def workloads() -> list:
    return [w["name"] for w in json.loads(run.BENCHMARK_JSON.read_text())["workloads"]]
