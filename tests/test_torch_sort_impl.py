"""The sorter switch (``merge_join.set_sort_impl`` / ``PHJ_SORT_IMPL``) at
every call site, on the CPU, where "pallas" runs K6's plain version.

Each call site's result under "pallas" is held exactly to the JAX package.
Counts and GROUP BY results do not depend on the sorter, so JAX runs its
default sort there (its interpret-mode Pallas tuple sort takes 40 s to 126 s
to compile on a CPU).  ``two_run_materialize`` with duplicate build keys
does depend on it (the smallest payload wins under "pallas"), so it is held
row for row to JAX's own "pallas" branch in interpret mode, with JAX's tuple
sorter standing in as its unique full-lex order.  A spy on
``bitonic_sort.sort_i32_tuple`` shows which sites went through K6, and with
how many operands.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from partitionedhashjoin_tpu.data.table import make_table as jax_table
from partitionedhashjoin_tpu.ops import aggregate as jax_agg
from partitionedhashjoin_tpu.ops import merge_join as jax_mj
from partitionedhashjoin_tpu.ops.pallas import bitonic_sort as jax_bs
from partitionedhashjoin_tpu_torch import bench_pipeline
from partitionedhashjoin_tpu_torch.data.table import make_table, table_from_numpy
from partitionedhashjoin_tpu_torch.ops import aggregate as agg
from partitionedhashjoin_tpu_torch.ops import merge_join as mj
from partitionedhashjoin_tpu_torch.ops.kernels import bitonic_sort
from partitionedhashjoin_tpu_torch.ops.no_partitioning import NoPartitioningHashJoiner
from partitionedhashjoin_tpu_torch.ops.radix_cluster import RadixHashJoiner
from partitionedhashjoin_tpu_torch.ops.sort_merge import SortMergeJoiner

I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min
FIELDS = ("keys", "count", "sum", "min", "max")


def test_sort_impl_switch_plumbing(monkeypatch):
    """The counterpart of tests/test_merge_probe.py's plumbing test: env
    knob, "auto" resolution, rejection of unknown impls."""
    assert mj.get_sort_impl() == "xla"
    monkeypatch.setenv("PHJ_SORT_IMPL", "pallas")
    try:
        assert mj.set_sort_impl_from_env() == "pallas"
        assert mj.get_sort_impl() == "pallas"
    finally:
        mj.set_sort_impl("xla")
    monkeypatch.setenv("PHJ_SORT_IMPL", "xla")
    assert mj.set_sort_impl_from_env() == "xla"
    monkeypatch.delenv("PHJ_SORT_IMPL")
    assert mj.set_sort_impl_from_env() == "xla"
    # auto: K6 on a CUDA tensor, the library sort on a CPU tensor
    assert mj.resolve_sort_impl("auto", torch.device("cpu")) == "xla"
    assert mj.resolve_sort_impl("auto", torch.device("cuda", 0)) == "pallas"
    assert mj.resolve_sort_impl("pallas", "cpu") == "pallas"
    assert mj.resolve_sort_impl("xla", "cuda") == "xla"
    with pytest.raises(ValueError):
        mj.set_sort_impl("typo")
    monkeypatch.setenv("PHJ_SORT_IMPL", "typo")
    with pytest.raises(ValueError):
        mj.set_sort_impl_from_env()
    assert mj.get_sort_impl() == "xla"


class _Spy:
    """Records the operand count of each ``sort_i32_tuple`` call."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = bitonic_sort.sort_i32_tuple

        def spy(*operands):
            self.calls.append(len(operands))
            return real(*operands)

        monkeypatch.setattr(bitonic_sort, "sort_i32_tuple", spy)

    def take(self):
        calls, self.calls = self.calls, []
        return calls


@pytest.fixture
def spy(monkeypatch):
    return _Spy(monkeypatch)


@pytest.fixture
def pallas(spy):
    mj.set_sort_impl("pallas")
    try:
        yield spy
    finally:
        mj.set_sort_impl("xla")


def _keys(seed, dtype=np.int32):
    rng = np.random.default_rng(seed)
    a = rng.integers(-3000, 3000, 2500).astype(dtype)
    b = rng.integers(-3500, 3500, 9000).astype(dtype)
    if dtype == np.int32:
        a[:3], b[:5] = I32_MAX, I32_MAX
        a[3], b[5:7] = I32_MIN, I32_MIN
    else:
        a, b = a << 33, b << 33
        a[:3], b[:5] = np.iinfo(np.int64).max, np.iinfo(np.int64).max
    return a, b


def test_two_run_count_and_prepared_build_under_pallas(pallas):
    a, b = _keys(1)
    rng = np.random.default_rng(2)
    av, bv = rng.random(a.size) < 0.8, rng.random(b.size) < 0.7
    for masks in ((), (av, bv)):
        want = int(jax_mj.two_run_count(*map(jnp.asarray, (a, b) + masks),
                                        interpret=True))
        got = mj.two_run_count(*map(torch.from_numpy, (a, b) + masks))
        assert int(got) == want
        assert pallas.take() == [1, 1]  # the build and the probe sort
    jax_pb = jax_mj.PreparedBuild(jnp.asarray(a), interpret=True)
    pb = mj.PreparedBuild(torch.from_numpy(a))
    assert pallas.take() == [1]
    for probe in (b, b[::-1].copy()):
        assert int(pb.count(torch.from_numpy(probe))) == int(jax_pb.count(jnp.asarray(probe)))
    assert pallas.take() == [1, 1]
    assert torch.equal(pb.a_sorted, torch.sort(torch.from_numpy(a)).values)


def test_int64_keys_under_pallas(pallas):
    """Sort-merge int64 sorts (hi, lo) planes with K6; an int64
    PreparedBuild keeps the library sort, as in the JAX package."""
    a, b = _keys(3, np.int64)
    with jax.enable_x64(True):
        want = int(jax_mj.two_run_count_i64(jnp.asarray(a), jnp.asarray(b),
                                            interpret=True))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert int(SortMergeJoiner.count(ta, tb)) == want == int(np.isin(b, a).sum())
    assert pallas.take() == [2, 2]
    assert int(mj.PreparedBuild(ta).count(tb)) == want
    assert pallas.take() == []
    # the plane sort is the int64 order over the whole domain
    edges = np.asarray([0, -1, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, -(2**31),
                        -(2**31) - 1, np.iinfo(np.int64).max,
                        np.iinfo(np.int64).min], np.int64)
    keys = np.concatenate([edges, np.random.default_rng(4).integers(
        np.iinfo(np.int64).min, np.iinfo(np.int64).max, 5000, dtype=np.int64)])
    np.testing.assert_array_equal(mj._plane_sort(torch.from_numpy(keys)).numpy(),
                                  np.sort(keys))


def test_joiners_under_pallas(pallas):
    a, b = _keys(5)
    ta, tb = (table_from_numpy(k, np.arange(k.size, dtype=np.int32), "cpu")
              for k in (a, b))
    want = int(jax_mj.two_run_count(jnp.asarray(a), jnp.asarray(b), interpret=True))
    assert want == int(np.isin(b, a).sum())
    for joiner in (RadixHashJoiner(), NoPartitioningHashJoiner(), SortMergeJoiner()):
        assert joiner.run(ta, tb) == want, type(joiner).__name__
        assert pallas.take() == [1, 1], type(joiner).__name__


def test_auto_and_xla_keep_the_library_sort_on_cpu(spy):
    a, b = _keys(6)
    want = int(np.isin(b, a).sum())
    for impl in ("xla", "auto"):
        mj.set_sort_impl(impl)
        try:
            assert int(mj.two_run_count(torch.from_numpy(a), torch.from_numpy(b))) == want
        finally:
            mj.set_sort_impl("xla")
    assert spy.take() == []


def test_two_run_materialize_duplicate_build_keys_matches_jax_pallas(pallas, monkeypatch):
    """Row for row against JAX's "pallas" materialize: both sort (key,
    payload) tuples, so among duplicate build keys the SMALLEST payload
    wins, and probe rows come out in (key, payload) order.

    JAX runs its "pallas" branch and its interpret-mode K4; its tuple sorter
    is replaced by the same full-lex order through ``lax.sort`` (its two
    interpret-mode 2-operand sorts take ~90 s to compile on a CPU).  The
    order is unique, and tests/test_bitonic_sort.py holds the JAX sorter to
    it, as tests/test_torch_bitonic_sort.py holds the port's."""
    rng = np.random.default_rng(7)
    a = rng.integers(0, 1000, 3000).astype(np.int32)  # ~3 rows per key
    a_pay = rng.integers(-10**6, 10**6, a.size).astype(np.int32)
    b = rng.integers(-100, 1100, 5000).astype(np.int32)  # some probe rows miss
    b_pay = rng.integers(-50, 50, b.size).astype(np.int32)
    sorted_tuples = []

    def full_lex_sort(*operands, interpret=False):
        # JAX's sort_i32_tuple contract: the full-lex order of the tuples
        sorted_tuples.append(len(operands))
        return list(jax.lax.sort(tuple(operands), num_keys=len(operands)))

    monkeypatch.setattr(jax_bs, "sort_i32_tuple", full_lex_sort)
    jax_mj._materialize_i32.clear_cache()  # trace anew, through the stand-in
    jax_mj.set_sort_impl("pallas")
    try:
        want = jax_mj.two_run_materialize(*map(jnp.asarray, (a, a_pay, b, b_pay)),
                                          interpret=True)
    finally:
        jax_mj.set_sort_impl("xla")
        jax_mj._materialize_i32.clear_cache()  # drop the trace with the stand-in
    assert sorted_tuples == [2, 2]  # JAX took its "pallas" branch on both sides
    want = [np.asarray(w) for w in want]
    args = [torch.from_numpy(x) for x in (a, a_pay, b, b_pay)]
    for payload_sorted in (False, True):
        got = mj.two_run_materialize(*args, probe_payload_sorted=payload_sorted)
        assert pallas.take() == [2, 2]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    keys, pay_a, pay_b, count = (g.numpy() for g in got)
    c = int(count)
    smallest = {}
    for k, p in zip(a.tolist(), a_pay.tolist()):
        smallest[k] = min(p, smallest.get(k, p))
    hit = np.isin(b, a)
    assert c == int(hit.sum()) < b.size
    order = np.lexsort((b_pay[hit], b[hit]))
    np.testing.assert_array_equal(keys[:c], b[hit][order])
    np.testing.assert_array_equal(pay_b[:c], b_pay[hit][order])
    assert pay_a[:c].tolist() == [smallest[k] for k in keys[:c].tolist()]
    assert not keys[c:].any() and not pay_a[c:].any() and not pay_b[c:].any()


def _assert_groups(got, want, fields=FIELDS):
    assert int(got.num_groups) == int(want.num_groups)
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


def _columns(n=20000, seed=8):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-500, 500, n).astype(np.int32)
    keys[::101] = I32_MIN
    keys[::103] = I32_MAX
    pay = rng.integers(-1000, 1000, n).astype(np.int32)
    pay[::7] = I32_MAX
    pay[::11] = 3  # bit-identical (key, payload) rows
    return keys, pay


def test_sort_aggregate_pass1_under_pallas(pallas):
    keys, pay = _columns()
    jt = jax_table(jnp.asarray(keys), jnp.asarray(pay))
    tt = make_table(torch.from_numpy(keys), torch.from_numpy(pay))
    assert agg._pass1_sort_choice(tt) == "pallas"
    want = jax_agg.sort_aggregate(jt, with_group_of_row=True, with_distinct=True,
                                  compaction="sort")
    for with_row, operands in ((True, 3), (False, 2)):
        got = agg.sort_aggregate(tt, with_group_of_row=with_row, with_distinct=True)
        assert pallas.take() == [operands]  # (key, payload[, row]): no mask
        _assert_groups(got, want, FIELDS + ("distinct",))
        if with_row:
            np.testing.assert_array_equal(got.group_of_row.numpy(),
                                          np.asarray(want.group_of_row))
        else:
            assert (got.group_of_row == -1).all()
    wide = make_table(torch.from_numpy(keys), torch.from_numpy(pay.astype(np.int64)))
    assert agg._pass1_sort_choice(wide) == "xla"
    # int64 payloads keep the library sort (their sums do not wrap)
    _assert_groups(agg.sort_aggregate(wide), want, ("keys", "count", "min", "max"))
    assert pallas.take() == []


def test_filter_aggregates_pass1_under_pallas(pallas):
    keys, pay = _columns(n=12000, seed=9)
    jt = jax_table(jnp.asarray(keys), jnp.asarray(pay))
    tt = make_table(torch.from_numpy(keys), torch.from_numpy(pay))

    def even(k, p):
        return (p & 1) == 0

    want, want_n = jax_agg.filter_sort_aggregate(
        jt, even, group_capacity=900, with_group_of_row=True,
        with_distinct=True, compaction="sort")
    for with_row, operands in ((True, 4), (False, 3)):
        got, got_n = agg.filter_sort_aggregate(
            tt, even, group_capacity=900, with_group_of_row=with_row,
            with_distinct=True)
        assert pallas.take() == [operands]
        assert int(got_n) == int(want_n)
        _assert_groups(got, want, FIELDS + ("distinct",))
        if with_row:
            np.testing.assert_array_equal(got.group_of_row.numpy(),
                                          np.asarray(want.group_of_row))
    staged, staged_n = agg.filter_sort_aggregate_staged(
        tt, even, group_capacity=900, with_distinct=True)
    assert pallas.take() == [2]  # the survivors, compacted: no mask
    assert int(staged_n) == int(want_n)
    _assert_groups(staged, want, FIELDS + ("distinct",))


def test_query_plans_under_pallas_match_xla(spy):
    """bench_pipeline's two plans give the same groups and top-10 under
    both sorters (the naive plan's GROUP BY sorts through K6 too)."""
    rel = bench_pipeline.make_relations(3000, 40000, "cpu")
    want = [bench_pipeline.run_query(*rel, 4096, ordered) for ordered in (True, False)]
    assert spy.take() == []
    mj.set_sort_impl("pallas")
    try:
        got = [bench_pipeline.run_query(*rel, 4096, ordered) for ordered in (True, False)]
    finally:
        mj.set_sort_impl("xla")
    assert spy.take() == [2, 2, 2, 2, 2]
    for (g, hot, count), (wg, whot, wcount) in zip(got, want):
        assert int(count) == int(wcount) == 40000
        assert bench_pipeline.plans_agree(g, wg)
        assert torch.equal(hot.keys, whot.keys)
