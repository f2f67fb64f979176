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


# The four joins other than shuffle are ported, with int64 keys for
# sort-merge (tests/test_torch_cli.py); what stays unported is the shuffle
# join and the shuffle / multi-host flags, with any join.
@pytest.mark.parametrize("extra", [
    ["--join", "no-partitioning", "--shards", "2"],
    ["--join", "radix-partitioning", "--pipeline-chunks", "2"],
    ["--join", "shuffle"],
    ["--join", "planned", "--coordinator", "localhost:1234"],
    ["--join", "sort-merge", "--shards", "2"],
    ["--join", "sort-merge", "--local-join", "hash"],
    ["--join", "sort-merge", "--pipeline-chunks", "2"],
    ["--join", "sort-merge", "--coordinator", "localhost:1234"],
    ["--join", "sort-merge", "--num-processes", "2"],
    ["--join", "sort-merge", "--process-id", "1"],
    ["--join", "sort-merge", "--key-dtype", "int64", "--local-join", "hash"],
])
def test_cli_rejects_unported_paths(extra, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(extra + ["--platform", "cpu"])
    assert exc.value.code == 2
    assert "not yet ported (ROADMAP)" in capsys.readouterr().err


def test_cli_cuda_platform_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--join", "sort-merge", "--primary", "10", "--secondary",
                  "20", "--output", "stdout"])
