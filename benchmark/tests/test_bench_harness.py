"""The harness on the CPU: every cell of BENCHMARK.json on its tiny
configuration, the metrics found by name, and the rules a run keeps."""

import ast
import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import run
from conftest import SEED, tiny_bench, tiny_layout, workloads

CPU = torch.device("cpu")
#: Per-layer metrics a CPU run can read (no device trace there).
HOST_METRICS = {"sql_plan_ms", "op_hbm_roofline", "sort_phase_roofline",
                "probe_phase_ms"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", workloads())
def test_cell_runs_correct_on_cpu(workload, trace):
    bench = tiny_bench()
    result, lines = run.execute(bench, workload, SEED, 0.3, bool(trace), CPU,
                                tiny_layout())
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= 2
    assert run.forbidden_modules() == []
    e2e, per_layer = run.cell_metrics(bench, workload)
    if trace:
        want = {m["name"] for m in per_layer} & HOST_METRICS
        assert "busy_s" in result["device"] and "breakdown" in result
    else:
        want = {m["name"] for m in e2e}
    assert set(result["metrics"]) == want
    # no allocator on the CPU: the peak reads 0 there
    assert all(v["value"] > 0 for k, v in result["metrics"].items()
               if k != "peak_mem_gb")
    assert list(result)[-1] == "checks"
    assert [ln for ln in lines if ln.startswith("check ")] == [
        f"check {k}: {v['value']} (limit {v['limit']})"
        for k, v in result["checks"].items()]


def test_jax_loaded_after_the_window_prints_no_result(tmp_path, monkeypatch,
                                                      capsys):
    """A metric reader that imports a module named ``jax``, after the window
    and after the run's other checks: the run exits 3 and prints nothing on
    standard output."""
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "jax.py").write_text("")
    metrics = tmp_path / "metrics"
    shutil.copytree(run.HERE / "metrics", metrics)
    (metrics / "setup_s.py").write_text(
        "import jax\n\n\ndef read(ctx):\n    return ctx.setup_s\n")
    monkeypatch.syspath_prepend(str(stub))
    real = run.execute
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "execute", lambda bench, w, seed, s, t, dev: real(
        tiny_bench(), w, seed, s, t, CPU, tiny_layout(metrics=metrics)))
    assert "jax" not in sys.modules
    try:
        rc = run.main(["--workload", "kimb_radix", "--seed", "3",
                       "--seconds", "0.1", "--trace", "0"])
    finally:
        sys.modules.pop("jax", None)
    out = capsys.readouterr()
    assert rc == 3 and out.out == ""
    assert "['jax']" in out.err


def test_same_seed_same_answers():
    bench = tiny_bench()
    runs = [run.execute(bench, "upstream_sql_top10", seed, 0.1, False, CPU,
                        tiny_layout())[0] for seed in (SEED, SEED, SEED + 1)]
    assert all(r["correct"] for r in runs)


def test_new_metric_file_is_found_by_name(tmp_path):
    metrics = tmp_path / "metrics"
    shutil.copytree(run.HERE / "metrics", metrics)
    (metrics / "ops_in_stretch.py").write_text(
        "def read(ctx):\n    return len(ctx.stretch_ops())\n")
    bench = tiny_bench()
    bench["per_layer"].append({
        "name": "ops_in_stretch", "unit": "ops", "better": "higher",
        "source": "host_clock", "layer": "operators", "moves":
        "probe_rows_per_s", "workloads": ["upstream_radix"]})
    result, _ = run.execute(bench, "upstream_radix", SEED, 0.3, True, CPU,
                            tiny_layout(metrics=metrics))
    assert result["metrics"]["ops_in_stretch"]["value"] >= 2
    other, _ = run.execute(bench, "kimb_radix", SEED, 0.3, True, CPU,
                           tiny_layout(metrics=metrics))
    assert "ops_in_stretch" not in other["metrics"]


def test_metric_without_workloads_follows_the_metric_it_moves():
    bench = tiny_bench()
    bench["per_layer"].append({"name": "x", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "device",
                               "moves": "probe_rows_per_s"})
    for w in workloads():
        assert "x" in {m["name"] for m in run.cell_metrics(bench, w)[1]}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("partitionedhashjoin_tpu_torch", "partitionedhashjoin_tpu_torch.ops",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    for name in ("partitionedhashjoin_tpu", "partitionedhashjoin_tpu.ops", "jax",
                 "jaxlib.xla_client", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == sorted(
        ["partitionedhashjoin_tpu", "partitionedhashjoin_tpu.ops", "jax",
         "jaxlib.xla_client", "flax"])


def test_a_run_loads_no_jax_module():
    code = ("import sys, torch; from benchmark import run; "
            "from conftest import tiny_bench, tiny_layout; "
            "r, _ = run.execute(tiny_bench(), 'upstream_sql_top10', 5, 0.1, "
            "True, torch.device('cpu'), tiny_layout()); "
            "assert r['correct']; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'partitionedhashjoin_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   cwd=run.HERE.parent,
                   env={"PYTHONPATH": f"{run.HERE.parent}:{run.HERE / 'tests'}",
                        "PATH": "/usr/bin:/bin"})


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in (run.HERE / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in {"__future__", "torch", "numpy"}, (path, name)


def test_harness_sets_no_environment_knob():
    for path in run.HERE.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "PHJ_" not in text, path
        assert not re.search(r"os\.environ\s*\[[^\]]*\]\s*=|environ\.(setdefault|update)|putenv",
                             text), path


def test_no_main_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "upstream_radix", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keeps_its_schema():
    bench = json.loads(run.BENCHMARK_JSON.read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        data = json.loads((run.HERE.parent / c["file"]).read_text())
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert data["reduced"] == c["reduced"] and data["name"] == c["name"]
        assert data["source"] == c["source"]
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert (run.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert len(w["why"]) <= 200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert (run.HERE / "metrics" / f"{m['name']}.py").is_file()
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert (run.HERE / "metrics" / f"{m['name']}.py").is_file()
        assert all(w in {x["name"] for x in bench["workloads"]}
                   for w in m.get("workloads", []))
    assert len(run.BENCHMARK_JSON.read_bytes()) <= 64 * 1024


def test_test_files_take_no_name_of_the_repositorys_tests():
    ours = {p.name for p in (run.HERE / "tests").glob("*.py")}
    theirs = {p.name for p in (run.HERE.parent / "tests").glob("*.py")}
    assert not (ours - {"conftest.py"}) & theirs


def test_traced_window_shorter_than_an_operation_still_traces():
    result, lines = run.execute(tiny_bench(), "upstream_sql_top10", SEED,
                                1e-6, True, CPU, tiny_layout())
    assert result["correct"], lines
    assert result["attempted"] >= 2 and "busy_s" in result["device"]
