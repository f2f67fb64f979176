"""The cell ``upstream_nopart_chained`` (the chained no-partitioning join on the
upstream int64 tuple) and its two per-layer metrics: the bytes behind
``k7_i64_roofline``, both readers silent where their span or kernel is
absent, and a run whose chained count leaves out half the probe rows comes
out not correct."""

import json

import pytest
import torch

from benchmark import bytes as model
from benchmark import run
from benchmark.metrics import chained_build_ms, k7_i64_roofline
from conftest import SEED, tiny_bench, tiny_layout
from partitionedhashjoin_tpu_torch.ops import hash_table as ht

CELL = "upstream_nopart_chained"
CONFIG = "upstream_nopart_10Mx200M_zipf105"


def test_k7_i64_bytes_at_the_upstream_shape():
    n_a, n_b = 10_000_000, 200_000_000
    assert k7_i64_roofline.k7_i64_bytes(n_a, n_b) == 12 * (n_a + n_b) == 2_520_000_000
    ms = model.seconds_at_peak(k7_i64_roofline.k7_i64_bytes(n_a, n_b)) * 1e3
    assert ms == pytest.approx(0.752, abs=1e-3)


class _Stretch:
    def __init__(self, device_seconds):
        self.device_seconds = device_seconds


def _ctx(phases, device_seconds, traced=True):
    ops = [run.OpRecord(0, 0.01, 1, p, traced) for p in phases]
    return run.Context(10, 200, 8, 0, 0.0, 1.0, 0, ops,
                       None if device_seconds is None else _Stretch(device_seconds))


def test_readers_return_none_without_their_span_or_kernel():
    # no traced stretch, operations without phases, a phase of 0
    for ctx in (_ctx([{"build": 0.002}], None, traced=False),
                _ctx([None, {}], {}), _ctx([{"build": 0.0}], {})):
        assert chained_build_ms.read(ctx) is None
    # no kernel in the stretch, or only K7's int32 kernel
    for seconds in (None, {}, {"hash_vec_kernel": 1e-3, "hash_kernel": 1e-6}):
        assert k7_i64_roofline.read(_ctx([{"build": 0.002}], seconds)) is None
    ctx = _ctx([{"build": 0.002}, {"build": 0.004}],
               {"hash64_vec_kernel": 2 * 1e-3, "hash64_kernel": 2 * 1e-6,
                "hash_vec_kernel": 1.0})
    assert chained_build_ms.read(ctx) == pytest.approx(3.0)
    want = 100 * 12 * 210 / 3.35e12 / (1e-3 + 1e-6)
    assert k7_i64_roofline.read(ctx) == pytest.approx(want)


def test_cell_is_the_upstream_tuple_through_the_chained_joiner():
    bench = json.loads(run.BENCHMARK_JSON.read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "nopart_chained_count", 1)
    per_layer = {m["name"] for m in run.cell_metrics(bench, CELL)[1]}
    assert per_layer == {"chained_build_ms", "k7_i64_roofline"}


def test_config_is_the_upstream_data_uncut():
    """The no-partitioning run's own source, on the upstream's default data
    at its published widths."""
    bench = json.loads(run.BENCHMARK_JSON.read_text())
    configs = {c["name"]: c for c in bench["configs"]}
    ours, data = configs[CONFIG], configs["upstream_10Mx200M_zipf105"]
    assert ours["reduced"] == [] and ours["source"] != data["source"]
    ours, data = (json.loads((run.HERE.parent / c["file"]).read_text())
                  for c in (ours, data))
    assert (ours["build"], ours["probe"]) == (data["build"], data["probe"])
    assert ours["build"]["dtype"] == ours["probe"]["dtype"] == "int64"
    assert ours["join"]["algorithm"] == "no_partitioning"


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_int64_keys_correct_on_cpu(trace):
    result, lines = run.execute(tiny_bench(), CELL, SEED, 0.3, bool(trace),
                                torch.device("cpu"), tiny_layout())
    assert result["correct"] and result["failed"] == 0, lines
    if trace:
        assert result["metrics"]["chained_build_ms"]["value"] > 0
        assert "k7_i64_roofline" not in result["metrics"]  # no device trace


def test_half_the_probe_rows_is_not_correct(monkeypatch):
    orig = ht.probe_chained_count
    seen = []

    def half(table, keys, *a, **kw):
        seen.append(table.entry_keys.dtype)
        return orig(table, keys[: keys.shape[0] // 2], *a, **kw)

    monkeypatch.setattr(ht, "probe_chained_count", half)
    result, lines = run.execute(tiny_bench(), CELL, SEED, 0.2, False,
                                torch.device("cpu"), tiny_layout())
    assert seen and set(seen) == {torch.int64}
    assert result["failed"] == 0
    assert not result["correct"], lines
    assert result["checks"]["count_gap"]["value"] > result["checks"]["count_gap"]["limit"]
