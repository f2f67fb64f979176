"""The port's script entries (``partitionedhashjoin_tpu_torch/scripts/``)
against the repository's ``scripts/*.py``, on the CPU at 5,000 ⋈ 70,000.

The JAX scripts import jax and point its compilation cache into the
repository, so they are read, not run: their flags, environment variables,
seeds and JSON keys come from their syntax trees, and each metric name is
their own f-string evaluated at the test's sizes.  The result files are held
byte for byte to the JAX package's ``utils.results.JSONResultsFormatter``
(pure Python) fed the same parameters and phase durations, and
``figure.dat`` is parsed by ``scripts/figure.py``'s own lines.  Every other
oracle is numpy.
"""

import ast
import importlib
import io
import json
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu import config as jax_config
from partitionedhashjoin_tpu.utils import results as jax_results
from partitionedhashjoin_tpu_torch.ops import generators, merge_join
from partitionedhashjoin_tpu_torch.ops.sort_merge import SortMergeJoiner
from partitionedhashjoin_tpu_torch.data.table import make_table
from partitionedhashjoin_tpu_torch.scripts import (
    bench_filtered_pipeline,
    bench_int64,
    bench_materialize,
    bench_operators,
    bench_overlap,
    bench_scaling,
    bench_sorter_ab,
    record_results,
    sweep,
)
from partitionedhashjoin_tpu_torch.scripts._common import generator
from partitionedhashjoin_tpu_torch.utils.results import JSONResultsFormatter

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
N_A, N_B = 5000, 70000
CPU = ["--platform", "cpu"]
ENTRIES = ("record_results", "sweep", "bench_int64", "bench_materialize",
           "bench_operators", "bench_filtered_pipeline", "bench_sorter_ab",
           "bench_scaling", "bench_overlap")
#: the partition counts of the grid tests
PARTS = ["32", "64"]
ALL_ALGOS = ["sort-merge", "no-partitioning", "radix", "shuffle",
             "nopart-chained", "radix-2pass", "radix-chained"]
GRID_COLUMNS = ["SortMerge", "NoPartitioning", "Shuffle_1", "ShufflePiped_1",
                "Radix_32", "Radix_64", "NoPartChained", "Radix2Pass_32",
                "RadixChained_32"]
UNIT_S = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1.0}


def _tree(name):
    return ast.parse((SCRIPTS / f"{name}.py").read_text())


def _dumped_dict(name) -> ast.Dict:
    """The dict literal the JAX script passes to ``json.dumps``."""
    found = [n.args[0] for n in ast.walk(_tree(name))
             if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "dumps"
             and n.args and isinstance(n.args[0], ast.Dict)]
    assert len(found) == 1, name
    return found[0]


def _keys(d: ast.Dict):
    return {k.value for k in d.keys}


def _jax_metric(name, **names) -> str:
    """The JAX script's metric f-string, evaluated with ``names``."""
    d = _dumped_dict(name)
    node = d.values[[k.value for k in d.keys].index("metric")]
    return eval(compile(ast.Expression(node), name, "eval"), {}, names)


def _jax_flags(name):
    """{flag: default} of the JAX script's ``add_argument`` calls."""
    flags = {}
    for n in ast.walk(_tree(name)):
        if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in n.keywords}
            default = ast.literal_eval(kw["default"]) if "default" in kw else None
            flags[n.args[0].value] = default
    return flags


def _env_defaults(tree):
    """{variable: default} of every ``os.environ.get("PHJ_…", default)``."""
    out = {}
    for n in ast.walk(tree):
        if (isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "get"
                and len(n.args) == 2 and isinstance(n.args[0], ast.Constant)
                and str(n.args[0].value).startswith("PHJ_")):
            out[n.args[0].value] = ast.literal_eval(n.args[1])
    return out


def _json_line(capsys) -> dict:
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1, out
    return json.loads(lines[0]), err


@pytest.fixture
def small(monkeypatch):
    """The env entries' workload at 5,000 ⋈ 70,000, every other knob unset."""
    for var in ("PHJ_BENCH_SKEW", "PHJ_BENCH_FUSED_ONLY", "PHJ_AB_SKEW",
                "PHJ_AB_IMPLS"):
        monkeypatch.delenv(var, raising=False)
    for var, n in (("PHJ_BENCH_PRIMARY", N_A), ("PHJ_BENCH_SECONDARY", N_B),
                   ("PHJ_AB_PRIMARY", N_A), ("PHJ_AB_SECONDARY", N_B)):
        monkeypatch.setenv(var, str(n))


def _zipf(n, card, seed):
    return generators.zipf_keys(n, 1.05, card, generator=generator(seed, "cpu"),
                                device="cpu")


def _payloads(n, seed):
    return torch.randint(0, 1 << 20, (n,), generator=generator(seed, "cpu"),
                         dtype=torch.int32)


# --------------------------------------------------------------- the surface


@pytest.mark.parametrize("name", ENTRIES)
def test_flags_and_env_are_the_jax_scripts(name):
    """Every flag of the JAX script, with its default; every PHJ_* variable
    but the interpret switches, with its default; and ``--platform``."""
    module = importlib.import_module(f"partitionedhashjoin_tpu_torch.scripts.{name}")
    parser = (module.build_parser() if hasattr(module, "build_parser")
              else None)
    port = ({a.option_strings[0]: a.default for a in parser._actions
             if a.option_strings} if parser else {})
    for flag, default in _jax_flags(name).items():
        assert port[flag] == default, (flag, port.get(flag), default)
    jax_env = {k: v for k, v in _env_defaults(_tree(name)).items()
               if not k.endswith("_INTERPRET")}
    assert _env_defaults(ast.parse(Path(module.__file__).read_text())) == jax_env
    if parser:
        assert port["--platform"] == "cuda"
        extra = set(port) - set(_jax_flags(name)) - {"-h", "--platform"}
        assert extra <= {"--unit"}, extra


@pytest.mark.parametrize("name,seeds", [
    ("bench_int64", {bench_int64.SEED}),
    ("bench_materialize", {bench_materialize.SEED, bench_materialize.PAYLOAD_SEED}),
    ("bench_operators", {bench_operators.SEED}),
    ("bench_filtered_pipeline", {bench_filtered_pipeline.SEED,
                                 bench_filtered_pipeline.PAYLOAD_SEED}),
    ("bench_sorter_ab", {bench_sorter_ab.SEED}),
])
def test_seeds_are_the_jax_scripts(name, seeds):
    literal = {n.args[0].value for n in ast.walk(_tree(name))
               if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "PRNGKey"
               and isinstance(n.args[0], ast.Constant)}
    assert literal == seeds


@pytest.mark.parametrize("name", ENTRIES)
def test_cuda_without_a_card_raises(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"partitionedhashjoin_tpu_torch.scripts.{name}")
    argv = ["--platform", "cuda"]
    if name in ("record_results", "sweep"):
        argv += ["--outdir", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="is_available"):
        module.main(argv)
    assert not (tmp_path / "out").exists()


# ------------------------------------------------------------------ benches


def test_bench_int64_line(small, capsys):
    assert bench_int64.main(CPU) == 0
    doc, err = _json_line(capsys)
    assert set(doc) == _keys(_dumped_dict("bench_int64")) | {"device"}
    assert doc["metric"] == _jax_metric("bench_int64", n_a=N_A, n_b=N_B, skew=1.05)
    assert doc["device"] == "cpu" and doc["unit"] == "rows/s" and doc["value"] > 0
    assert doc["vs_baseline"] == round(doc["value"] / bench_int64.BASELINE_ROWS_PER_S, 3)
    assert "int64 flagship" in err


def test_int64_keys_formula_and_count():
    """Keys differ only above bit 31 (their low words are all equal); the
    count join on them equals ``np.isin`` with half the probe ids missing."""
    ids = np.concatenate([np.arange(1, 11), np.array([2**20, 10_000_000])])
    got = bench_int64.int64_keys(torch.from_numpy(ids.astype(np.int32))).numpy()
    want = ids.astype(np.int64) * 2**33 + 12345 - 2**62
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert len(np.unique(got)) == len(ids) and len(np.unique(got & 0xFFFFFFFF)) == 1
    a = bench_int64.int64_keys(torch.arange(1, N_A + 1))
    b = bench_int64.int64_keys(_zipf(N_B, 2 * N_A, bench_int64.SEED))
    count = SortMergeJoiner().run(make_table(a, torch.zeros(N_A, dtype=torch.int32)),
                                  make_table(b, torch.zeros(N_B, dtype=torch.int32)))
    assert count == np.isin(b.numpy(), a.numpy()).sum()
    assert 0 < count < N_B


def test_bench_materialize_line(small, capsys):
    assert bench_materialize.main(CPU) == 0
    doc, _ = _json_line(capsys)
    assert set(doc) == _keys(_dumped_dict("bench_materialize")) | {"device"}
    assert doc["metric"] == _jax_metric("bench_materialize", N_A=N_A, N_B=N_B, SKEW=1.05)
    assert doc["oracle_ok"] is True and doc["device"] == "cpu"


def test_bench_materialize_oracles_against_numpy():
    """The output holds every probe row in key order (numpy's sort), and
    each oracle fails on an output broken its way."""
    a = torch.arange(1, N_A + 1, dtype=torch.int32)
    b = _zipf(N_B, N_A, bench_materialize.SEED)
    b_pay = _payloads(N_B, bench_materialize.PAYLOAD_SEED)
    keys, pa, pb, count = merge_join.two_run_materialize(
        a, a ^ bench_materialize.SALT, b, b_pay)
    assert int(count) == np.isin(b.numpy(), a.numpy()).sum() == N_B
    assert np.array_equal(keys.numpy(), np.sort(b.numpy()))
    assert bench_materialize.oracles(keys, pa, pb, b_pay) == (True, True, True)
    assert bench_materialize.oracles(keys.flip(0), pa.flip(0), pb, b_pay)[0] is False
    assert bench_materialize.oracles(keys, pa + 1, pb, b_pay)[1] is False
    assert bench_materialize.oracles(keys, pa, pb + 1, b_pay)[2] is False


def test_bench_materialize_exits_1_when_an_oracle_fails(small, capsys, monkeypatch):
    monkeypatch.setattr(bench_materialize, "oracles", lambda *a: (True, False, True))
    assert bench_materialize.main(CPU) == 1
    doc, _ = _json_line(capsys)
    assert doc["oracle_ok"] is False


@pytest.mark.parametrize("fused_only", [False, True])
def test_bench_operators_line(small, capsys, monkeypatch, fused_only):
    if fused_only:
        monkeypatch.setenv("PHJ_BENCH_FUSED_ONLY", "1")
    assert bench_operators.main(CPU) == 0
    doc, err = _json_line(capsys)
    assert set(doc) == _keys(_dumped_dict("bench_operators")) | {"device"}
    assert doc["metric"] == _jax_metric("bench_operators", n=N_B, skew=1.05)
    assert doc["pipeline"] in (("fused",) if fused_only else ("fused", "staged"))
    assert ("[staged]" in err) is not fused_only


def test_bench_operators_pipelines_agree_with_numpy():
    keys = _zipf(N_B, N_A, bench_operators.SEED)
    table = make_table(keys, torch.arange(N_B, dtype=torch.int32))
    k = keys.numpy()[np.arange(N_B) % 2 == 0]
    want_keys, want_counts = np.unique(k, return_counts=True)
    for fn in (bench_operators.filter_sort_aggregate,
               bench_operators.filter_sort_aggregate_staged):
        g, sel = fn(table, bench_operators.predicate,
                    group_capacity=bench_operators.GROUP_CAPACITY)
        n = int(g.num_groups)
        assert int(sel) == N_B // 2 and n == len(want_keys)
        assert np.array_equal(g.keys[:n].numpy(), want_keys)
        assert np.array_equal(g.count[:n].numpy(), want_counts)


def test_bench_filtered_pipeline_line_and_oracle(small, capsys):
    assert bench_filtered_pipeline.main(CPU) == 0
    doc, err = _json_line(capsys)
    assert set(doc) == _keys(_dumped_dict("bench_filtered_pipeline")) | {"device"}
    assert doc["metric"] == _jax_metric("bench_filtered_pipeline", N_A=N_A, N_B=N_B,
                                        SKEW=1.05)
    assert "(R7 = R5∘R3" in err and "oracle: group-count total" in err
    b = _zipf(N_B, N_A, bench_filtered_pipeline.SEED).numpy()
    keep = (_payloads(N_B, bench_filtered_pipeline.PAYLOAD_SEED).numpy() % 2 == 0) & (
        np.isin(b, np.arange(1, N_A + 1)))
    assert doc["survivors"] == keep.sum()
    assert doc["top1_count"] == np.unique(b[keep], return_counts=True)[1].max()
    # round(t_f - t_u) against round(t_f) - round(t_u)
    assert abs(doc["filter_overhead_ms"]
               - (doc["filtered_R7_ms"] - doc["unfiltered_ms"])) <= 1


def test_bench_sorter_ab_stderr_only(small, capsys):
    assert bench_sorter_ab.main(CPU) == 0
    out, err = capsys.readouterr()
    assert out == ""
    want = np.isin(_zipf(N_B, N_A, bench_sorter_ab.SEED).numpy(),
                   np.arange(1, N_A + 1)).sum()
    for impl in ("xla", "pallas"):
        line = [x for x in err.splitlines() if x.startswith(f"{impl:7s}:")]
        assert len(line) == 1 and f"count={want}  [first call" in line[0]
    assert "speedup pallas vs xla: " in err


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bench_sorter_ab_one_side(small, monkeypatch, capsys, impl):
    """``PHJ_AB_IMPLS`` names one side: its one line, exact, and no
    speedup."""
    monkeypatch.setenv("PHJ_AB_IMPLS", impl)
    assert bench_sorter_ab.main(CPU) == 0
    out, err = capsys.readouterr()
    want = np.isin(_zipf(N_B, N_A, bench_sorter_ab.SEED).numpy(),
                   np.arange(1, N_A + 1)).sum()
    lines = [x for x in err.splitlines() if x.startswith(("xla ", "pallas "))]
    assert out == "" and len(lines) == 1 and lines[0].startswith(f"{impl:7s}:")
    assert f"count={want}  [first call" in lines[0] and "speedup" not in err


def test_bench_scaling_line(capsys):
    assert bench_scaling.main(CPU + ["--build", "1000", "--probe", "8000",
                                     "--reps", "1"]) == 0
    doc, err = _json_line(capsys)
    tail = _dumped_dict("bench_scaling")
    assert set(doc) == _keys(tail) | {"device"}
    point_keys = [_keys(n.args[0]) for n in ast.walk(_tree("bench_scaling"))
                  if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "append"]
    assert [set(p) for p in doc["points"]] == point_keys * 4
    assert [p["shards"] for p in doc["points"]] == [1, 2, 4, 8]
    assert doc["backend"] == "cpu" and doc["device"] == "cpu"
    assert doc["workload"] == "1000x8000 per shard, zipf 1.05"
    assert "share one device" in doc["note"]
    assert doc["points"][0]["weak_efficiency"] == doc["points"][0]["strong_speedup"] == 1.0


def test_bench_overlap_line(capsys):
    assert bench_overlap.main(CPU + ["--build", str(N_A), "--probe", str(N_B),
                                     "--reps", "1"]) == 0
    doc, err = _json_line(capsys)
    assert set(doc) == _keys(_dumped_dict("bench_overlap")) | {"device"}
    assert doc["metric"] == _jax_metric("bench_overlap", ndev=8)
    assert [r["chunks"] for r in doc["rows"]] == [1, 2, 4, 8]
    assert doc["best_chunks"] == min(doc["rows"], key=lambda r: r["seconds"])["chunks"]
    assert "one-shot" in err and "pipelined K=8" in err


# ------------------------------------------------------------- result grids


def _jax_bytes(params, durations, unit) -> str:
    """What the JAX package's formatter writes for these parameters and
    phase durations (seconds)."""
    p = jax_results.Parameters()
    for k, v in params:
        p.set_parameter(k, v)
    r = jax_results.HashJoinTimingResult(p)
    r.set_partitioning_phase_duration(durations[0])
    r.set_build_phase_duration(durations[1])
    r.set_probe_phase_duration(durations[2])
    out = io.StringIO()
    jax_results.JSONResultsFormatter(
        jax_config.ResultsFormatConfiguration(time_unit=unit)).format(out, r)
    return out.getvalue()


def _figure_py_parse(dat: Path):
    """``scripts/figure.py``'s own parsing lines, run on ``dat``."""
    src = (SCRIPTS / "figure.py").read_text().splitlines()
    i = src.index("    with open(dat) as f:")
    namespace = {"dat": str(dat)}
    exec(textwrap.dedent("\n".join(src[i:i + 4])), namespace)
    return namespace["configs"], namespace["phases"]


def _record(tmp_path, monkeypatch, unit):
    """record_results over every algo; returns {path: formatted result}."""
    formatted = {}

    class Recording(JSONResultsFormatter):
        def format(self, stream, results):
            formatted[Path(stream.name)] = results
            super().format(stream, results)

    monkeypatch.setattr(record_results, "JSONResultsFormatter", Recording)
    out = tmp_path / unit
    argv = CPU + ["--outdir", str(out), "--primary", str(N_A), "--secondary",
                  str(N_B), "--partitions", *PARTS, "--algos", *ALL_ALGOS]
    if unit != "ms":
        argv += ["--unit", unit]
    assert record_results.main(argv) == 0
    return out, formatted


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("grids")
    try:
        return {unit: _record(tmp, mp, unit) for unit in ("ms", "us")}
    finally:
        mp.undo()


@pytest.mark.parametrize("unit", ["ms", "us"])
def test_record_results_files_are_the_jax_formatters(grids, unit):
    out, formatted = grids[unit]
    files = sorted(p.name for p in out.glob("*.txt"))
    assert files == sorted(
        ["sortmerge.txt", "partitions_1.txt", "shuffle.txt", "shuffle_pipelined.txt",
         "partitions_32.txt", "partitions_64.txt", "partitions_1_chained.txt",
         "partitions_32_2pass.txt", "partitions_32_chained.txt"])
    assert set(formatted) == set(out.glob("*.txt"))
    for path, r in formatted.items():
        durations = (r.get_partitioning_phase_duration(), r.get_build_phase_duration(),
                     r.get_probe_phase_duration())
        assert path.read_text() == _jax_bytes(list(r.get_parameters()), durations, unit)
    doc = json.loads((out / "shuffle_pipelined.txt").read_text())
    assert doc["parameters"]["NumberOfShards"] == "1"
    assert doc["parameters"]["PipelineChunks"] == "4"
    assert doc["parameters"]["Type"] == "DistributedShufflePipelined"
    assert json.loads((out / "partitions_32_2pass.txt").read_text())["parameters"][
        "PartitionPasses"] == "2"


@pytest.mark.parametrize("unit", ["ms", "us"])
def test_record_results_figure_dat(grids, unit):
    out, _ = grids[unit]
    configs, phases = _figure_py_parse(out / "figure.dat")
    assert configs == GRID_COLUMNS
    assert list(phases) == ["partition", "build", "probe"]
    by_column = {
        "SortMerge": "sortmerge.txt", "NoPartitioning": "partitions_1.txt",
        "Shuffle_1": "shuffle.txt", "ShufflePiped_1": "shuffle_pipelined.txt",
        "Radix_32": "partitions_32.txt", "Radix_64": "partitions_64.txt",
        "NoPartChained": "partitions_1_chained.txt",
        "Radix2Pass_32": "partitions_32_2pass.txt",
        "RadixChained_32": "partitions_32_chained.txt",
    }
    for i, name in enumerate(configs):
        doc = json.loads((out / by_column[name]).read_text())
        for phase, values in phases.items():
            assert values[i] == float(doc["results"][phase])


def test_record_results_unit_changes_only_the_numbers(grids):
    (ms, _), (us, _) = grids["ms"], grids["us"]
    for path in ms.glob("*.txt"):
        a, b = json.loads(path.read_text()), json.loads((us / path.name).read_text())
        assert a["id"] == b["id"] and a["parameters"] == b["parameters"]
        assert set(a["results"]) == set(b["results"])
        assert all(v.isdigit() for v in (*a["results"].values(), *b["results"].values()))
    dat_ms = (ms / "figure.dat").read_text().splitlines()
    dat_us = (us / "figure.dat").read_text().splitlines()
    assert dat_ms[0] == dat_us[0]
    assert [x.split()[0] for x in dat_ms] == [x.split()[0] for x in dat_us]


@pytest.mark.parametrize("skew", [1.05, 0.0])
def test_record_results_relations_count_like_isin(skew):
    args = record_results.build_parser().parse_args(
        ["--outdir", "unused", "--primary", str(N_A), "--secondary", str(N_B),
         "--skew", str(skew)])
    a, b = record_results.generate(args, torch.device("cpu"))
    assert np.array_equal(a.keys.numpy(), np.arange(1, N_A + 1))
    assert not b.payloads.any() and b.keys.dtype == torch.int32
    assert np.isin(b.keys.numpy(), a.keys.numpy()).sum() == N_B
    if skew == 0.0:  # uniform: no key holds a Zipf head's share
        assert np.bincount(b.keys.numpy()).max() < N_B / 100


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """The sweep with the default unit and with ``--unit us``, each the base
    join and two radix partition counts, each a CLI process."""
    out = {}
    for unit in ("ms", "us"):
        d = tmp_path_factory.mktemp(f"sweep_{unit}")
        argv = CPU + ["--outdir", str(d), "--primary", str(N_A), "--secondary",
                      str(N_B), "--partitions", *PARTS]
        if unit != "ms":
            argv += ["--unit", unit]
        assert sweep.main(argv) == 0
        out[unit] = d
    return out


@pytest.mark.parametrize("unit", ["ms", "us"])
def test_sweep_files_are_the_jax_formatters(sweeps, unit):
    d = sweeps[unit]
    assert sorted(p.name for p in d.glob("*.txt")) == [
        "partitions_1.txt", "partitions_32.txt", "partitions_64.txt"]
    for path in d.glob("*.txt"):
        doc = json.loads(path.read_text())
        durations = [int(doc["results"][k]) * UNIT_S[unit]
                     for k in ("partition", "build", "probe")]
        assert path.read_text() == _jax_bytes(doc["parameters"].items(), durations, unit)
        assert doc["parameters"]["SecondaryRelationSize"] == str(N_B)
    assert json.loads((d / "partitions_64.txt").read_text())["parameters"] == {
        "NumberOfPartitions": "64", "PrimaryRelationSize": str(N_A),
        "SecondaryRelationSize": str(N_B), "Skew": "1.050000",
        "Type": "RadixPartitioning"}
    configs, phases = _figure_py_parse(d / "figure.dat")
    assert configs == ["NoPartitioning", "Radix_32", "Radix_64"]
    assert list(phases) == ["partition", "build", "probe"]


def test_sweep_unit_changes_only_the_numbers(sweeps):
    for path in sweeps["ms"].glob("*.txt"):
        a = json.loads(path.read_text())
        b = json.loads((sweeps["us"] / path.name).read_text())
        assert a["parameters"] == b["parameters"] and set(a["results"]) == set(b["results"])
    assert ((sweeps["ms"] / "figure.dat").read_text().splitlines()[0]
            == (sweeps["us"] / "figure.dat").read_text().splitlines()[0])
