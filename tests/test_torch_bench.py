"""The port's bench entry against the repository's ``bench.py``, on the CPU.

``bench.py`` imports jax and points its compilation cache into the
repository when imported, so it is read, not imported: its JSON keys are
the string keys of its dict literals, and its ``phase_rooflines`` and
``_emit`` are compiled from its source and run beside the port's.
"""

import ast
import json
from pathlib import Path

import pytest

from partitionedhashjoin_tpu_torch import bench
from partitionedhashjoin_tpu_torch.utils.results import HashJoinTimingResult, Parameters

BENCH_PY = Path(__file__).resolve().parents[1] / "bench.py"
#: The keys of bench.py's JSON line: its _emit payload and main's "extra"
#: dict less n_a, n_b and skew (bench.py:84-92, 294-301).
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "generation_path",
              "sort_impl", "roofline_fraction_single_touch"}


def _bench_py():
    return ast.parse(BENCH_PY.read_text())


def _bench_py_functions(*names):
    """bench.py's functions ``names``, compiled from its source alone."""
    tree = _bench_py()
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert {n.name for n in body} == set(names)
    namespace = {"json": json, "BASELINE_ROWS_PER_S": 200e6 / 1.196}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(BENCH_PY), "exec"),
         namespace)
    return namespace


def test_bench_py_keys_are_the_listed_ones():
    keys = {k.value for node in ast.walk(_bench_py()) if isinstance(node, ast.Dict)
            for k in node.keys if isinstance(k, ast.Constant)}
    assert BENCH_KEYS <= keys
    assert keys - BENCH_KEYS == {"n_a", "n_b", "skew", "best", "done", "stage"}


def test_main_prints_one_json_line(monkeypatch, capsys):
    monkeypatch.setenv("PHJ_BENCH_PRIMARY", "5000")
    monkeypatch.setenv("PHJ_BENCH_SECONDARY", "70000")
    monkeypatch.delenv("PHJ_BENCH_SKEW", raising=False)
    monkeypatch.delenv("PHJ_BENCH_ALGOS", raising=False)
    assert bench.main(["--platform", "cpu"]) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1, out
    doc = json.loads(lines[0])
    assert set(doc) == BENCH_KEYS | {"device"}
    assert doc["device"] == "cpu" and doc["unit"] == "rows/s"
    assert doc["generation_path"] == "rejection" and doc["sort_impl"] == "pallas"
    algo = doc["metric"].split("_")[4]
    assert algo in ("sort-merge", "radix")
    assert doc["metric"] == f"join_rows_per_s_{algo}_5000x70000_skew1.05"
    assert doc["value"] > 0
    assert doc["vs_baseline"] == round(doc["value"] / bench.BASELINE_ROWS_PER_S, 3)
    assert set(doc["roofline_fraction_single_touch"]) == {
        "sort-merge.total(sorts+kernel)", "radix.partition(sorts)", "radix.probe(kernel)"}
    # phase times in µs, and each measured run's kernel launches (none on the CPU)
    assert "sort-merge: total " in err and " us (partition " in err
    assert "launches radix: {}" in err


def test_radix_chained_raises_not_ported():
    """radix-chained is ported now: the bench builds the JAX bench's joiner
    (256 partitions, chained mode); only an unknown algo raises."""
    joiner = bench.make_joiner("radix-chained", seed=7)
    assert joiner.num_partitions == 256 and joiner._config.mode == "chained"
    with pytest.raises(ValueError, match="unknown algo"):
        bench.make_joiner("bogus", seed=7)
    assert bench.make_joiner("radix", seed=7).num_partitions == 256


@pytest.mark.parametrize("algo,phases", [
    ("radix", (0.5, 0.0, 0.25)),
    ("sort-merge", (0.0, 0.0, 0.125)),
    ("no-partitioning", (0.0, 0.03125, 0.25)),
    ("planned", (0.5, 0.03125, 0.25)),
    ("radix", (0.0, 0.0, 0.0)),
])
def test_phase_rooflines_match_bench_py(algo, phases):
    r = HashJoinTimingResult(Parameters())
    r.set_partitioning_phase_duration(phases[0])
    r.set_build_phase_duration(phases[1])
    r.set_probe_phase_duration(phases[2])
    ref = _bench_py_functions("phase_rooflines")["phase_rooflines"]
    want = ref(algo, 10_000_000, 200_000_000, r)
    assert bench.phase_rooflines(algo, 10_000_000, 200_000_000, r) == want


def test_emit_matches_bench_py(capsys):
    extra = {"n_a": 10, "n_b": 20, "skew": 1.05, "generation_path": "rejection",
             "sort_impl": "pallas", "roofline_fraction_single_touch": {"x": 0.5}}
    _bench_py_functions("_emit")["_emit"](("radix", 1.5e9), extra)
    want = json.loads(capsys.readouterr().out)
    bench._emit(("radix", 1.5e9), {**extra, "device": "cpu"})
    got = json.loads(capsys.readouterr().out)
    assert got == {**want, "device": "cpu"}


def test_watchdog_emits_best_once(monkeypatch, capsys):
    exits = []
    monkeypatch.setattr(bench.os, "_exit", exits.append)
    progress = bench.Progress()
    progress.best = ("radix", 2e9)
    progress.extra = {"n_a": 1, "n_b": 2, "skew": 1.05, "device": "cpu"}
    bench._watchdog(progress, 0.0)
    bench._watchdog(progress, 0.0)  # already claimed: silent
    assert not progress.claim_emit()  # main would not emit either
    lines = capsys.readouterr().out.splitlines()
    assert exits == [0] and len(lines) == 1
    assert json.loads(lines[0])["metric"] == "join_rows_per_s_radix_1x2_skew1.05"


def test_watchdog_exits_3_with_nothing_measured(monkeypatch, capsys):
    exits = []
    monkeypatch.setattr(bench.os, "_exit", exits.append)
    bench._watchdog(bench.Progress(), 0.0)
    assert exits == [3] and capsys.readouterr().out == ""
    progress = bench.Progress()
    assert progress.claim_emit()  # main emitted: the watchdog stays quiet
    bench._watchdog(progress, 0.05, poll_s=0.01)
    assert exits == [3]


def test_kernel_launches_reads_every_counter():
    counts = bench.kernel_launches()
    assert {"merge_probe.LAUNCHES", "merge_probe.LAUNCHES_I64",
            "bitonic_sort.LAUNCHES_SORT", "generate.LAUNCHES_ZIPF"} <= set(counts)
    assert all(isinstance(v, int) for v in counts.values())
