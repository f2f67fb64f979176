"""The port's slice as a whole — SortMergeJoiner and the CLI — against the
JAX package, on the CPU."""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from partitionedhashjoin_tpu import cli as jax_cli
from partitionedhashjoin_tpu.data.table import make_table as jax_make_table
from partitionedhashjoin_tpu.ops import generators as jax_gen
from partitionedhashjoin_tpu.ops.sort_merge import SortMergeJoiner as JaxJoiner
from partitionedhashjoin_tpu_torch import cli
from partitionedhashjoin_tpu_torch.data.table import table_from_numpy
from partitionedhashjoin_tpu_torch.ops.sort_merge import SortMergeJoiner
from partitionedhashjoin_tpu_torch.utils.results import HashJoinTimer, Parameters

CLI_ARGV = ["--primary", "5000", "--secondary", "70000", "--join", "sort-merge",
            "--output", "stdout", "--platform", "cpu", "--seed", "4"]


def _across(jax_table):
    return table_from_numpy(np.asarray(jax_table.keys),
                            np.asarray(jax_table.payloads), "cpu")


def test_joiner_on_jax_generated_relations():
    """The reference workload at small scale: sequential ⋈ Zipf, generated
    by the JAX package and carried across as numpy — every probe matches."""
    a = jax_gen.sequential_table(5000)
    b = jax_gen.zipf_table(70000, 1.05, (1, 5000), seed=8, method="rejection")
    want = JaxJoiner().run(a, b)
    timer = HashJoinTimer(Parameters())
    assert SortMergeJoiner().run(_across(a), _across(b), timer) == want == 70000
    result = timer.get_result()
    assert result.get_build_phase_duration() < result.get_probe_phase_duration()


def test_joiner_partial_matches_equal_jax():
    rng = np.random.default_rng(4)
    ak = rng.integers(0, 20_000, 6000).astype(np.int32)
    bk = rng.integers(-500, 20_500, 50_000).astype(np.int32)
    ak[:7] = np.iinfo(np.int32).max
    bk[:11] = np.iinfo(np.int32).max
    a = jax_make_table(jnp.asarray(ak), jnp.arange(6000, dtype=jnp.int32))
    b = jax_make_table(jnp.asarray(bk), jnp.arange(50_000, dtype=jnp.int32))
    want = JaxJoiner().run(a, b)
    assert SortMergeJoiner().run(_across(a), _across(b)) == want
    assert want == int(np.isin(bk, ak).sum())


def test_count_rejects_other_key_types():
    """int32 and int64 keys count (a side in int64 widens the other); other
    key types are never cast."""
    k32 = torch.arange(4, dtype=torch.int32)
    assert int(SortMergeJoiner.count(k32.to(torch.int64), k32)) == 4
    with pytest.raises(TypeError):
        SortMergeJoiner.count(k32.to(torch.uint64), k32)
    with pytest.raises(TypeError):
        SortMergeJoiner.count(k32, k32.to(torch.float32))


def test_cli_output_schema_matches_jax(capsys):
    assert jax_cli.main(CLI_ARGV) == 0
    jax_doc = json.loads(capsys.readouterr().out)
    assert cli.main(CLI_ARGV + ["--log", "info"]) == 0
    captured = capsys.readouterr()
    doc = json.loads(captured.out)
    assert "Join produced 70000 matches" in captured.err
    assert set(doc) == set(jax_doc) == {"id", "parameters", "results"}
    assert doc["id"] == jax_doc["id"]
    assert doc["parameters"] == jax_doc["parameters"]
    assert doc["parameters"]["Type"] == "SortMerge"
    assert set(doc["results"]) == set(jax_doc["results"])
    assert doc["results"]["partition"] == doc["results"]["build"] == "0"


# The multi-process flags, with any join: ``--coordinator`` needs the shuffle
# join; with it the join runs over a one-process group on a free port;
# without it ``--num-processes`` and ``--process-id`` are ignored, as the JAX
# CLI ignores them.  The two-process runs are tests/test_torch_multiprocess.py's.
@pytest.mark.parametrize("extra", [
    ["--join", "no-partitioning", "--coordinator", "localhost:1234"],
    ["--join", "radix-partitioning", "--num-processes", "2"],
    ["--join", "shuffle", "--coordinator", "localhost:1234"],
    ["--join", "planned", "--coordinator", "localhost:1234"],
    ["--join", "shuffle", "--shards", "2", "--num-processes", "2"],
    ["--join", "shuffle", "--local-join", "hash", "--process-id", "1"],
    ["--join", "shuffle", "--pipeline-chunks", "2", "--coordinator", "localhost:1234"],
    ["--join", "sort-merge", "--coordinator", "localhost:1234"],
    ["--join", "sort-merge", "--num-processes", "2"],
    ["--join", "sort-merge", "--process-id", "1"],
    ["--join", "sort-merge", "--key-dtype", "int64", "--process-id", "1"],
])
def test_cli_rejects_unported_paths(extra, capsys):
    from partitionedhashjoin_tpu_torch.dryrun import free_coordinator

    coordinated = "--coordinator" in extra
    join = extra[extra.index("--join") + 1]
    argv = [free_coordinator() if a == "localhost:1234" else a for a in extra] + [
        "--platform", "cpu", "--primary", "64", "--secondary", "256", "--seed", "4",
        "--output", "stdout", "--log", "info"]
    if coordinated and join != "shuffle":
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code == "--coordinator requires --join shuffle"
        return
    if coordinated:
        argv += ["--num-processes", "1"]
    assert cli.main(argv) == 0
    captured = capsys.readouterr()
    doc = json.loads(captured.out)
    assert "Join produced 256 matches" in captured.err
    if coordinated:
        assert doc["parameters"]["Type"] == "DistributedShuffle"
        assert doc["parameters"]["NumberOfProcesses"] == "1"
        assert "backend gloo" in captured.err
    else:
        assert "NumberOfProcesses" not in doc["parameters"]


def test_cli_cuda_platform_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--join", "sort-merge", "--primary", "10", "--secondary",
                  "20", "--output", "stdout"])


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_counts_and_match_over_one_run_spanning_the_input(dtype):
    """Every key equal, so one run spans the merged stream, and the build
    side's last valid row lies far before most probe positions: the run's
    start prefix and the last build key / valid position are spread over
    the whole input.  Every mask combination, against a numpy oracle."""
    from partitionedhashjoin_tpu_torch.ops import sort_merge as sm

    rng = np.random.default_rng(11)
    n_a, n_b = 300, 900
    a = torch.full((n_a,), 5, dtype=dtype)
    b = torch.full((n_b,), 5, dtype=dtype)
    b[::7] = 6  # a second run at the end, with no build row
    av = torch.from_numpy(rng.random(n_a) < 0.02)
    av[-5:] = False  # the last valid build row sits well before the end
    bv = torch.from_numpy(rng.random(n_b) < 0.5)
    a_pay = torch.arange(n_a, dtype=torch.int32) * 3
    for build_valid in (None, av, torch.zeros(n_a, dtype=torch.bool)):
        ok_a = np.ones(n_a, bool) if build_valid is None else build_valid.numpy()
        for probe_valid in (None, bv):
            ok_b = np.ones(n_b, bool) if probe_valid is None else probe_valid.numpy()
            hit = (b.numpy() == 5) & ok_a.any() & ok_b
            assert int(sm.sort_merge_count(a, b, build_valid, probe_valid)) == hit.sum()
            assert int(sm.anti_count(a, b, build_valid, probe_valid)) == ok_b.sum() - hit.sum()
            assert int(sm.sort_merge_count_all(a, b, build_valid, probe_valid)) == (
                hit.sum() * ok_a.sum())
        got_hit, row, pay = sm._match_probe_rows(a, b, a_pay, build_valid=build_valid)
        last = int(np.flatnonzero(ok_a)[-1]) if ok_a.any() else -1
        want_hit = (b.numpy() == 5) & (last >= 0)
        assert torch.equal(got_hit, torch.from_numpy(want_hit))
        assert torch.equal(row, torch.from_numpy(np.where(want_hit, max(last, 0), 0)
                                                 .astype(np.int32)))
        assert torch.equal(pay, torch.from_numpy(np.where(want_hit, 3 * max(last, 0), 0)
                                                 .astype(np.int32)))
