"""The harness on the card, at the tiny sizes: the traced stretch reads the
device (kernels, busy time) and every per-layer metric of each cell."""

import pytest

from benchmark import run
from conftest import SEED, tiny_bench, tiny_layout, workloads


@pytest.mark.cuda
@pytest.mark.parametrize("workload", workloads())
def test_traced_run_reads_the_device(workload, card):
    bench = tiny_bench()
    result, lines = run.execute(bench, workload, SEED, 2.0, True, card,
                                tiny_layout())
    assert result["correct"], lines
    assert run.forbidden_modules() == []
    dev = result["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    want = {m["name"] for m in run.cell_metrics(bench, workload)[1]}
    assert set(result["metrics"]) == want, result
    for name, m in result["metrics"].items():
        if name.endswith("_roofline"):
            assert 0 < m["value"] <= 105, (name, m)
    assert result["breakdown"]["device_ops"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", workloads())
def test_untraced_run_on_the_card(workload, card):
    result, lines = run.execute(tiny_bench(), workload, SEED, 1.0, False,
                                card, tiny_layout())
    assert result["correct"], lines
    assert result["metrics"]["peak_mem_gb"]["value"] > 0
