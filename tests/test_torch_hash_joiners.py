"""The paths on the port's hash tables against the JAX package's, on the
CPU: the chained no-partitioning and radix joins, ``build``,
``run_materialize``, the hash GROUP BY (``hash_aggregate``,
``filter_aggregate``), the bench's ``radix-chained`` algo and the package's
lazy exports.

The same numpy inputs go through both packages (JAX on its CPU paths; no
Pallas is involved).  Counts, the chained table, the ``JoinedTable`` and
every integer field of ``GroupByResult``, the padding past ``num_groups``
included, are held bit for bit.  Float SUM/MIN/MAX are held to
``rtol = atol = 1e-5``: the scatter-adds sum in another order.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu import config as jax_config
from partitionedhashjoin_tpu.data.table import make_table as jax_table
from partitionedhashjoin_tpu.ops import aggregate as jax_agg
from partitionedhashjoin_tpu.ops.no_partitioning import (
    NoPartitioningHashJoiner as JaxNoPartitioning,
)
from partitionedhashjoin_tpu.ops.radix_cluster import RadixHashJoiner as JaxRadix
import partitionedhashjoin_tpu_torch as port
from partitionedhashjoin_tpu_torch import bench
from partitionedhashjoin_tpu_torch.config import (
    NoPartitioningConfiguration,
    RadixClusteringConfiguration,
)
from partitionedhashjoin_tpu_torch.data.table import make_table, table_from_numpy
from partitionedhashjoin_tpu_torch.ops import aggregate as agg
from partitionedhashjoin_tpu_torch.ops import generators
from partitionedhashjoin_tpu_torch.ops.no_partitioning import (
    NoPartitioningHashJoiner,
)
from partitionedhashjoin_tpu_torch.ops.radix_cluster import RadixHashJoiner
from partitionedhashjoin_tpu_torch.utils.results import HashJoinTimer, Parameters

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min
INT_FIELDS = ("keys", "count", "num_groups", "group_of_row")
FLOAT_FIELDS = ("sum", "min", "max")


def _relations(case):
    rng = np.random.default_rng(21)
    if case == "extremes":
        a = rng.integers(-3000, 3000, 2500).astype(np.int32)
        b = rng.integers(-3500, 3500, 4000).astype(np.int32)
        a[:3], b[:5] = I32_MAX, I32_MAX
        a[3], b[5:7] = I32_MIN, I32_MIN
    elif case == "zipf_head":  # probe key 1 ~2,000 times, duplicate build keys
        a = np.concatenate([np.arange(1, 1001), [1, 1, 7]]).astype(np.int32)
        b = np.minimum(rng.zipf(1.3, 4096), 1200).astype(np.int32)
    else:  # empty probe
        a, b = np.arange(1, 50, dtype=np.int32), np.zeros(0, np.int32)
    pa = rng.integers(I32_MIN, I32_MAX, a.size, dtype=np.int64).astype(np.int32)
    pb = rng.integers(I32_MIN, I32_MAX, b.size, dtype=np.int64).astype(np.int32)
    return (a, pa), (b, pb)


CASES = ("extremes", "zipf_head", "empty_probe")


def _both(rel):
    (a, pa), (b, pb) = rel
    jax_t = (jax_table(jnp.asarray(a), jnp.asarray(pa)),
             jax_table(jnp.asarray(b), jnp.asarray(pb)))
    port_t = (table_from_numpy(a, pa, "cpu"), table_from_numpy(b, pb, "cpu"))
    return jax_t, port_t


@pytest.mark.parametrize("case", CASES)
def test_chained_no_partitioning_matches_jax(case):
    (ja, jb), (ta, tb) = _both(_relations(case))
    seed = 2**32 + 5  # both joiners keep seed & 0xFFFFFFFF
    want = JaxNoPartitioning(
        jax_config.NoPartitioningConfiguration(mode="chained"), seed=seed).run(ja, jb)
    got = NoPartitioningHashJoiner(
        NoPartitioningConfiguration(mode="chained"), seed=seed).run(ta, tb)
    assert got == want
    assert want == int(np.isin(np.asarray(jb.keys), np.asarray(ja.keys)).sum())
    # the chained table itself, field by field (seed & 0xFFFFFFFF == 5)
    jt = JaxNoPartitioning(seed=5).build(ja)
    tt = NoPartitioningHashJoiner(seed=5).build(ta)
    for f in ("entry_keys", "entry_rows", "offsets", "max_chain"):
        assert np.array_equal(np.asarray(getattr(jt, f)), getattr(tt, f).numpy()), f
    assert tt.seed == 5


@pytest.mark.parametrize("partitions,passes", [(8, 1), (256, 1), (64, 2)])
@pytest.mark.parametrize("case", CASES[:2])
def test_chained_radix_matches_jax(case, partitions, passes):
    (ja, jb), (ta, tb) = _both(_relations(case))
    cfg = dict(number_of_partitions=partitions, mode="chained", partition_passes=passes)
    want = JaxRadix(jax_config.RadixClusteringConfiguration(**cfg), seed=11).run(ja, jb)
    got = RadixHashJoiner(RadixClusteringConfiguration(**cfg), seed=11).run(ta, tb)
    assert got == want == int(np.isin(np.asarray(jb.keys), np.asarray(ja.keys)).sum())


def test_chained_joins_of_an_empty_build():
    """JAX's chained probe cannot gather from an empty table (it raises);
    the port counts 0 and materializes nothing."""
    ta = table_from_numpy(np.zeros(0, np.int32), np.zeros(0, np.int32), "cpu")
    tb = table_from_numpy(np.arange(5, dtype=np.int32), np.arange(5, dtype=np.int32), "cpu")
    assert NoPartitioningHashJoiner(NoPartitioningConfiguration(mode="chained")).run(ta, tb) == 0
    assert RadixHashJoiner(RadixClusteringConfiguration(mode="chained")).run(ta, tb) == 0
    joined = NoPartitioningHashJoiner(seed=1).run_materialize(ta, tb)
    assert int(joined.count) == 0 and not joined.keys.any() and not joined.payloads_a.any()


@pytest.mark.parametrize("case", CASES)
def test_run_materialize_matches_jax(case):
    (ja, jb), (ta, tb) = _both(_relations(case))
    want = JaxNoPartitioning(seed=3).run_materialize(ja, jb)
    got = NoPartitioningHashJoiner(seed=3).run_materialize(ta, tb)
    for f in ("keys", "payloads_a", "payloads_b"):
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert w.dtype == g.dtype and np.array_equal(w, g), f
    assert int(got.count) == int(want.count)
    # matched probe rows in probe order, each with its first build row's payload
    (a, pa), (b, pb) = _relations(case)
    hit = np.isin(b, a)
    first = {k: p for k, p in zip(a[::-1], pa[::-1])}
    c = int(got.count)
    assert np.array_equal(got.keys[:c].numpy(), b[hit])
    assert np.array_equal(got.payloads_b[:c].numpy(), pb[hit])
    assert np.array_equal(got.payloads_a[:c].numpy(), [first[k] for k in b[hit]])


def test_run_materialize_float_payloads():
    a = np.arange(1, 300, dtype=np.int32)
    b = np.random.default_rng(1).integers(0, 400, 1000).astype(np.int32)
    pa, pb = (np.random.default_rng(2).random(k.size).astype(np.float32) for k in (a, b))
    want = JaxNoPartitioning(seed=4).run_materialize(
        jax_table(jnp.asarray(a), jnp.asarray(pa)), jax_table(jnp.asarray(b), jnp.asarray(pb)))
    got = NoPartitioningHashJoiner(seed=4).run_materialize(
        table_from_numpy(a, pa, "cpu"), table_from_numpy(b, pb, "cpu"))
    for f in ("keys", "payloads_a", "payloads_b"):
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert w.dtype == g.dtype and np.array_equal(w, g), f
    # a 64-bit payload keeps its dtype (JAX has no x64 here: against numpy)
    wide = NoPartitioningHashJoiner(seed=4).run_materialize(
        table_from_numpy(a, pa.astype(np.float64), "cpu"),
        table_from_numpy(b, pb, "cpu"))
    c = int(wide.count)
    assert wide.payloads_a.dtype == torch.float64 and not wide.payloads_a[c:].any()
    assert np.array_equal(wide.payloads_a[:c].numpy(),
                          pa.astype(np.float64)[b[np.isin(b, a)] - 1])


def _timed(joiner, method, a, b):
    timer = HashJoinTimer(Parameters())
    out = getattr(joiner, method)(a, b, timer)
    return out, timer.get_result()


def test_chained_phase_attribution():
    a = generators.sequential_table(4_000, device="cpu")
    b = generators.zipf_table(4_096, 1.05, (1, 4_000), seed=3, device="cpu")
    chained = NoPartitioningConfiguration(mode="chained")
    for joiner, method, partitioned in (
        (NoPartitioningHashJoiner(chained, seed=1), "run", False),
        (NoPartitioningHashJoiner(seed=1), "run_materialize", False),
        (RadixHashJoiner(RadixClusteringConfiguration(mode="chained"), seed=1), "run", True),
    ):
        out, res = _timed(joiner, method, a, b)
        count = out if method == "run" else int(out.count)
        assert count == 4_096
        assert (res.get_partitioning_phase_duration() > 0) == partitioned
        assert res.get_build_phase_duration() > 0 and res.get_probe_phase_duration() > 0


def test_readme_chained_smoke():
    a = generators.sequential_table(5_000, device="cpu")
    b = generators.zipf_table(70_000, 1.05, (1, 5_000), seed=12, device="cpu")
    assert NoPartitioningHashJoiner(
        NoPartitioningConfiguration(mode="chained"), seed=1).run(a, b) == 70_000


# ---------------------------------------------------------------- GROUP BY


def _group_columns(case):
    rng = np.random.default_rng(31)
    if case == "zipf_head":
        keys = np.minimum(rng.zipf(1.2, 4096), 3000).astype(np.int32)
    elif case == "extremes":
        keys = rng.integers(-300, 300, 4096).astype(np.int32)
        keys[::97], keys[::89] = I32_MIN, I32_MAX
    else:
        keys = np.zeros(0, np.int32)
    pay = rng.integers(-1000, 1000, keys.size).astype(np.int32)
    pay[::5] = I32_MAX  # heavy groups' int32 sums wrap mod 2^32
    pay[1::7] = I32_MIN
    return keys, pay


def _assert_groups(want, got, float_payload=False):
    for f in INT_FIELDS + (() if float_payload else FLOAT_FIELDS):
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert w.dtype == g.dtype and np.array_equal(w, g), f
    for f in FLOAT_FIELDS if float_payload else ():
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert w.dtype == g.dtype
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("case", ["zipf_head", "extremes", "empty"])
def test_hash_aggregate_matches_jax(case):
    keys, pay = _group_columns(case)
    want = jax_agg.hash_aggregate(jax_table(jnp.asarray(keys), jnp.asarray(pay)), seed=2**33 + 9)
    got = agg.hash_aggregate(make_table(torch.from_numpy(keys), torch.from_numpy(pay)),
                             seed=2**33 + 9)
    _assert_groups(want, got)
    fpay = (pay % 1000).astype(np.float32) / 7  # float sums: another order
    want = jax_agg.hash_aggregate(jax_table(jnp.asarray(keys), jnp.asarray(fpay)), seed=3)
    got = agg.hash_aggregate(make_table(torch.from_numpy(keys), torch.from_numpy(fpay)), seed=3)
    _assert_groups(want, got, float_payload=True)


@pytest.mark.parametrize("predicate", ["positive", "none", "even_key"])
def test_filter_aggregate_matches_jax(predicate):
    keys, pay = _group_columns("extremes")
    pred = {"positive": lambda k, p: p > 0, "none": lambda k, p: k < I32_MIN + 1,
            "even_key": lambda k, p: k % 2 == 0}[predicate]
    want, wn = jax_agg.filter_aggregate(jax_table(jnp.asarray(keys), jnp.asarray(pay)), pred,
                                        seed=5)
    got, gn = agg.filter_aggregate(make_table(torch.from_numpy(keys), torch.from_numpy(pay)),
                                   pred, seed=5)
    _assert_groups(want, got)
    assert int(gn) == int(wn)


def test_filtered_rows_do_not_claim_groups():
    """A key whose rows are all filtered out makes no group, even when it
    collides with kept keys (JAX's test_filter_key_collision shape)."""
    keys = np.asarray([5, 5, 9, 9, 5, 13], np.int32)
    pay = np.asarray([-1, -2, 3, 4, 6, -7], np.int32)
    want, _ = jax_agg.filter_aggregate(jax_table(jnp.asarray(keys), jnp.asarray(pay)),
                                       lambda k, p: p > 0, seed=1)
    got, _ = agg.filter_aggregate(make_table(torch.from_numpy(keys), torch.from_numpy(pay)),
                                  lambda k, p: p > 0, seed=1)
    _assert_groups(want, got)
    assert got.keys[:2].tolist() == [9, 5] and got.group_of_row.tolist() == [-1, -1, 0, 0, 1, -1]


@pytest.mark.parametrize("seed", [0, 12345])
def test_hash_groups_are_the_sort_groups_in_first_row_order(seed):
    keys, pay = _group_columns("zipf_head")
    table = make_table(torch.from_numpy(keys), torch.from_numpy(pay))
    h = agg.hash_aggregate(table, seed=seed)
    s = agg.sort_aggregate(table)
    g = int(h.num_groups)
    assert g == int(s.num_groups)
    order = torch.argsort(h.keys[:g])
    for f in ("keys", "count", "sum", "min", "max"):
        assert torch.equal(getattr(h, f)[:g][order], getattr(s, f)[:g]), f
    first = torch.full((g,), keys.size, dtype=torch.int64).scatter_reduce_(
        0, h.group_of_row.to(torch.int64), torch.arange(keys.size), "amin")
    assert bool((first[1:] > first[:-1]).all())
    assert first.tolist() == sorted(np.unique(keys, return_index=True)[1].tolist())


# ---------------------------------------------------------------- surface


def test_bench_radix_chained_prints_one_json_line(monkeypatch, capsys):
    monkeypatch.setenv("PHJ_BENCH_PRIMARY", "5000")
    monkeypatch.setenv("PHJ_BENCH_SECONDARY", "70000")
    monkeypatch.setenv("PHJ_BENCH_ALGOS", "radix-chained")
    monkeypatch.delenv("PHJ_BENCH_SKEW", raising=False)
    assert bench.main(["--platform", "cpu"]) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1, out
    doc = json.loads(lines[0])
    assert doc["metric"] == "join_rows_per_s_radix-chained_5000x70000_skew1.05"
    assert set(doc["roofline_fraction_single_touch"]) == {
        "radix-chained.partition", "radix-chained.build", "radix-chained.probe"}
    assert "radix-chained: total " in err


LAZY = {
    "Table": "data.table", "SortMergeJoiner": "ops.sort_merge",
    "NoPartitioningHashJoiner": "ops.no_partitioning",
    "RadixHashJoiner": "ops.radix_cluster", "sequential_table": "ops.generators",
    "zipf_table": "ops.generators", "hash_aggregate": "ops.aggregate",
    "filter_table": "ops.filter", "sort_table": "ops.sort",
    "radix_sort_table": "ops.sort", "scan": "query", "Query": "query",
    "execute_sql": "sql", "explain_sql": "sql",
    "DistributedShuffleJoiner": "parallel.shuffle", "make_mesh": "parallel.mesh",
    "shard_table": "parallel.mesh",
}


@pytest.mark.parametrize("name", sorted(LAZY))
def test_lazy_exports_resolve_to_the_port(name):
    obj = getattr(port, name)
    assert obj.__module__ == f"partitionedhashjoin_tpu_torch.{LAZY[name]}"


def test_lazy_exports_import_nothing_until_asked():
    code = ("import sys, partitionedhashjoin_tpu_torch as p\n"
            "assert not any(m.startswith('partitionedhashjoin_tpu_torch.ops') for m in sys.modules)\n"
            "p.NoPartitioningHashJoiner\n"
            "assert 'partitionedhashjoin_tpu_torch.ops.no_partitioning' in sys.modules\n"
            "assert 'partitionedhashjoin_tpu_torch.parallel.shuffle' not in sys.modules\n"
            "print(p.DistributedShuffleJoiner.__module__)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env={"PYTHONPATH": str(REPO), "PATH": ""})
    assert proc.returncode == 0, proc.stderr
    assert "partitionedhashjoin_tpu_torch.parallel.shuffle" in proc.stdout
    with pytest.raises(AttributeError):
        port.no_such_name
