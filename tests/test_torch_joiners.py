"""The port's no-partitioning, radix and planned joiners against the JAX
package's joiners, on the CPU.

JAX runs ``NoPartitioningHashJoiner(interpret=True)`` (its vmem mode with
the Pallas kernel in interpret mode), ``RadixHashJoiner`` in its CPU mode
("auto" → chained) and the planner in its CPU plans (interval /
sort-merge).  The port runs its vmem modes with the kernels' plain versions.
Counts must be equal exactly; phase attribution, the power-of-two check,
the modes and the plan names are checked beside them (the chained modes
against JAX in test_torch_hash_joiners.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu import config as jax_config
from partitionedhashjoin_tpu.data.table import make_table as jax_make_table
from partitionedhashjoin_tpu.ops import generators as jax_gen
from partitionedhashjoin_tpu.ops import merge_join as jax_mj
from partitionedhashjoin_tpu.ops import planner as jax_planner
from partitionedhashjoin_tpu.ops.no_partitioning import (
    NoPartitioningHashJoiner as JaxNoPartitioning,
)
from partitionedhashjoin_tpu.ops.radix_cluster import RadixHashJoiner as JaxRadix
from partitionedhashjoin_tpu_torch.config import (
    NoPartitioningConfiguration,
    RadixClusteringConfiguration,
)
from partitionedhashjoin_tpu_torch.data.table import table_from_numpy
from partitionedhashjoin_tpu_torch.ops import planner
from partitionedhashjoin_tpu_torch.ops.kernels import merge_probe as mp
from partitionedhashjoin_tpu_torch.ops.no_partitioning import (
    NoPartitioningHashJoiner,
)
from partitionedhashjoin_tpu_torch.ops.planner import PlannedJoiner
from partitionedhashjoin_tpu_torch.ops.radix_cluster import RadixHashJoiner
from partitionedhashjoin_tpu_torch.utils.results import HashJoinTimer, Parameters

I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min
I64_MAX = np.iinfo(np.int64).max
I64_MIN = np.iinfo(np.int64).min


def _tables(ak, bk):
    """(JAX tables, port tables) over the same numpy keys."""
    jax_t = [jax_make_table(jnp.asarray(k), jnp.arange(k.size, dtype=jnp.int32))
             for k in (ak, bk)]
    port_t = [table_from_numpy(k, np.arange(k.size, dtype=np.int32), "cpu")
              for k in (ak, bk)]
    return jax_t, port_t


def _keys(seed, dtype=np.int32):
    rng = np.random.default_rng(seed)
    ak = rng.integers(-3000, 3000, 2500).astype(dtype)
    bk = rng.integers(-3500, 3500, 9000).astype(dtype)
    if dtype == np.int32:
        ak[:3], bk[:5] = I32_MAX, I32_MAX
        ak[3], bk[5:7] = I32_MIN, I32_MIN
    else:
        ak, bk = ak << 33, bk << 33
        ak[:3], bk[:5] = I64_MAX, I64_MAX
        ak[3], bk[5:7] = I64_MIN, I64_MIN
    return ak, bk


def test_all_joiners_on_jax_generated_relations():
    """The reference workload at small scale, generated by the JAX package:
    every probe row matches, in every joiner of both packages."""
    a = jax_gen.sequential_table(5000)
    b = jax_gen.zipf_table(30000, 1.05, (1, 5000), seed=12, method="rejection")
    ta, tb = (table_from_numpy(np.asarray(t.keys), np.asarray(t.payloads), "cpu")
              for t in (a, b))
    want = JaxNoPartitioning(seed=1, interpret=True).run(a, b)
    assert want == JaxRadix(seed=1).run(a, b) == 30000
    assert jax_planner.PlannedJoiner().run(a, b) == want
    for joiner in (NoPartitioningHashJoiner(), RadixHashJoiner(), PlannedJoiner()):
        assert joiner.run(ta, tb) == want, type(joiner).__name__


def test_no_partitioning_matches_jax_int32():
    (ja, jb), (ta, tb) = _tables(*_keys(1))
    want = JaxNoPartitioning(seed=2, interpret=True).run(ja, jb)
    assert NoPartitioningHashJoiner(seed=2).run(ta, tb) == want
    assert want == int(np.isin(np.asarray(jb.keys), np.asarray(ja.keys)).sum())


def test_no_partitioning_matches_jax_int64():
    ak, bk = _keys(2, np.int64)
    with jax.enable_x64(True):
        ja, jb = (jax_make_table(jnp.asarray(k), jnp.arange(k.size))
                  for k in (ak, bk))
        want = JaxNoPartitioning(seed=2, interpret=True).run(ja, jb)
    ta, tb = (table_from_numpy(k, np.arange(k.size), "cpu") for k in (ak, bk))
    assert NoPartitioningHashJoiner().run(ta, tb) == want == int(np.isin(bk, ak).sum())


@pytest.mark.parametrize("partitions", [8, 32])
def test_radix_matches_jax_int32(partitions):
    (ja, jb), (ta, tb) = _tables(*_keys(3))
    cfg = dict(number_of_partitions=partitions)
    want = JaxRadix(jax_config.RadixClusteringConfiguration(**cfg), seed=3).run(ja, jb)
    got = RadixHashJoiner(RadixClusteringConfiguration(**cfg), seed=3).run(ta, tb)
    assert got == want


def test_radix_int64_matches_jax_kernel_count():
    """JAX's radix joiner runs int64 only in its kernel mode, which needs
    the TPU; its interpret-mode int64 count is the reference here."""
    ak, bk = _keys(4, np.int64)
    with jax.enable_x64(True):
        want = int(jax_mj.two_run_count_i64(
            jnp.asarray(ak), jnp.asarray(bk), interpret=True
        ))
    ta, tb = (table_from_numpy(k, np.arange(k.size), "cpu") for k in (ak, bk))
    assert RadixHashJoiner().run(ta, tb) == want == int(np.isin(bk, ak).sum())
    # one int64 side makes the join int64; keys are never cast down
    tb32 = table_from_numpy(np.arange(-5, 5, dtype=np.int32), np.arange(10), "cpu")
    ta64 = table_from_numpy(np.asarray([0, 2**40, 3], np.int64), np.arange(3), "cpu")
    assert RadixHashJoiner().run(ta64, tb32) == 2


def _timed(joiner, a, b):
    timer = HashJoinTimer(Parameters())
    count = joiner.run(a, b, timer)
    return count, timer.get_result()


def test_phase_attribution():
    ak = np.arange(1, 200_001, dtype=np.int32)
    bk = np.random.default_rng(5).integers(1, 200_001, 400_000).astype(np.int32)
    ta, tb = (table_from_numpy(k, np.arange(k.size, dtype=np.int32), "cpu")
              for k in (ak, bk))
    count, res = _timed(NoPartitioningHashJoiner(), ta, tb)
    assert count == bk.size
    assert res.get_partitioning_phase_duration() == 0
    assert res.get_build_phase_duration() > 0 and res.get_probe_phase_duration() > 0
    count, res = _timed(RadixHashJoiner(), ta, tb)
    assert count == bk.size
    assert res.get_partitioning_phase_duration() > 0
    assert res.get_probe_phase_duration() > 0
    count, res = _timed(PlannedJoiner(), ta, tb)
    assert count == bk.size
    assert res.get_partitioning_phase_duration() == 0
    assert res.get_build_phase_duration() > 0


@pytest.mark.parametrize("partitions", [0, 1, 2, 64])
def test_radix_accepts_powers_of_two_like_jax(partitions):
    JaxRadix(jax_config.RadixClusteringConfiguration(number_of_partitions=partitions))
    joiner = RadixHashJoiner(
        RadixClusteringConfiguration(number_of_partitions=partitions)
    )
    assert joiner.num_partitions == partitions


@pytest.mark.parametrize("partitions", [3, 12, 100])
def test_radix_rejects_other_counts_like_jax(partitions):
    with pytest.raises(ValueError, match="power of 2"):
        JaxRadix(jax_config.RadixClusteringConfiguration(number_of_partitions=partitions))
    with pytest.raises(ValueError, match="power of 2"):
        RadixHashJoiner(RadixClusteringConfiguration(number_of_partitions=partitions))


def test_chained_modes_raise():
    """Only an unknown mode raises: the chained modes run (since they were
    ported) and count what "vmem" and "auto" count."""
    ta = tb = table_from_numpy(np.arange(4, dtype=np.int32), np.arange(4), "cpu")
    for mode in ("auto", "vmem", "chained"):
        assert NoPartitioningHashJoiner(NoPartitioningConfiguration(mode=mode)).run(ta, tb) == 4
        assert RadixHashJoiner(RadixClusteringConfiguration(mode=mode)).run(ta, tb) == 4
    assert int(NoPartitioningHashJoiner().build(ta).max_chain) >= 1
    with pytest.raises(ValueError):
        RadixHashJoiner(RadixClusteringConfiguration(mode="other")).run(ta, tb)
    with pytest.raises(ValueError):
        NoPartitioningHashJoiner(NoPartitioningConfiguration(mode="other")).run(ta, tb)


PLAN_CASES = {
    # (build, probe, dtype, port plan); JAX on the CPU plans "sort-merge"
    # where the port plans "kernel"
    "dense_sequential": (np.arange(1, 1001), np.arange(-50, 1200, 3), np.int32, "interval"),
    "duplicates_covered": ([3, 1, 2, 2, 3, 1], [0, 1, 2, 3, 4, 2], np.int32, "interval"),
    "gap": (np.delete(np.arange(1, 1001), 499), np.arange(1, 1001), np.int32, "kernel"),
    "negative_dense": (np.arange(-500, -100), [-501, -500, -101, -100, 0], np.int32, "interval"),
    "int32_top": (np.arange(I32_MAX - 9, I32_MAX), [I32_MAX, I32_MAX - 1, I32_MAX - 10],
                  np.int32, "interval"),
    "wrap_int32": ([I32_MIN, I32_MAX], [5, I32_MIN, I32_MAX], np.int32, "kernel"),
    "int64_dense": ((1 << 40) + np.arange(100), (1 << 40) + np.asarray([-1, 0, 50, 99, 100]),
                    np.int64, "interval"),
    "int64_sparse": ((1 << 40) + np.asarray([0, 2, 4, 6]), (1 << 40) + np.arange(-1, 8),
                     np.int64, "kernel"),
    "wrap_int64": ([I64_MIN, I64_MAX], [5, I64_MIN, I64_MAX - 1], np.int64, "kernel"),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_planned_count_and_plan_match_jax(case):
    build, probe, dtype, plan = PLAN_CASES[case]
    build, probe = np.asarray(build, dtype), np.asarray(probe, dtype)
    with jax.enable_x64(dtype == np.int64):
        want, jax_plan = jax_planner.planned_count(jnp.asarray(build), jnp.asarray(probe))
        want = int(want)
    got, got_plan = planner.planned_count(torch.from_numpy(build), torch.from_numpy(probe))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want == int(np.isin(probe, build).sum())
    assert got_plan == plan
    assert jax_plan == ("interval" if plan == "interval" else "sort-merge")


def test_kernel_plan_reuses_the_sorted_build(monkeypatch):
    """The kernel plan counts through K1 against the build run the stats
    pass sorted, without sorting the build again."""
    seen = []
    real = mp.ranged_merge_count_prepared
    monkeypatch.setattr(
        mp, "ranged_merge_count_prepared",
        lambda a, b, *f: seen.append(a.clone()) or real(a, b, *f),
    )
    build = torch.tensor([9, 1, 5, 3], dtype=torch.int32)
    stats, a_sorted = planner.build_stats(build)
    assert (stats.n, stats.key_min, stats.key_max, stats.covered) == (4, 1, 9, False)
    count, plan = planner.planned_count(build, torch.arange(10, dtype=torch.int32))
    assert (int(count), plan) == (4, "kernel")
    assert len(seen) == 1 and torch.equal(seen[0], a_sorted)


def test_planned_joiner_last_plan_and_empty():
    ak = np.arange(1, 501, dtype=np.int32)
    bk = np.random.default_rng(3).integers(1, 501, 2000).astype(np.int32)
    (ja, jb), (ta, tb) = _tables(ak, bk)
    jax_joiner, joiner = jax_planner.PlannedJoiner(), PlannedJoiner()
    assert joiner.run(ta, tb) == jax_joiner.run(ja, jb) == 2000
    assert joiner.last_plan == jax_joiner.last_plan == "interval"
    (_, _), (tg, _) = _tables(np.asarray([1, 5, 9], np.int32), bk)
    assert joiner.run(tg, tb) == int(np.isin(bk, [1, 5, 9]).sum())
    assert joiner.last_plan == "kernel"
    empty = table_from_numpy(np.zeros(0, np.int32), np.zeros(0, np.int32), "cpu")
    assert joiner.run(empty, tb) == 0 and joiner.last_plan == "interval"
    assert int(planner.planned_count(ta.keys, empty.keys)[0]) == 0
