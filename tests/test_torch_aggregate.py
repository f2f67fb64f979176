"""The port's sort-based GROUP BY and the whole join → GROUP BY → top-10
slice against the JAX package, on the CPU.

JAX runs its ``compaction="sort"`` pass 2; the port runs both of its pass-2
paths: the plain stable partition (``"sort"``) and K5's ``compact_columns``
(``"kernel"``, its plain version on CPU tensors).  Every ``GroupByResult``
field is compared exactly over the whole capacity (rows past
``num_groups`` are zeros in both), int32 SUMs wrapping mod 2^32 as in JAX.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from partitionedhashjoin_tpu.data.table import make_table as jax_table
from partitionedhashjoin_tpu.ops import aggregate as jax_agg
from partitionedhashjoin_tpu.ops.merge_join import two_run_materialize
from partitionedhashjoin_tpu.ops.order_by import top_k
from partitionedhashjoin_tpu_torch import bench_pipeline
from partitionedhashjoin_tpu_torch.data.table import make_table
from partitionedhashjoin_tpu_torch.ops import aggregate as agg

I32_MIN = np.iinfo(np.int32).min
I32_MAX = np.iinfo(np.int32).max
FIELDS = ("keys", "count", "sum", "min", "max")


def EVEN(k, p):
    return (p & 1) == 0


def _tables(keys, pay):
    return (jax_table(jnp.asarray(keys), jnp.asarray(pay)),
            make_table(torch.from_numpy(keys), torch.from_numpy(pay)))


def _assert_same(got, want, fields=FIELDS, n_rows=None):
    assert got.num_groups.dtype == torch.int32
    assert int(got.num_groups) == int(want.num_groups)
    assert got.count.dtype == torch.int32
    for f in fields:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.shape == w.shape, f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
    if n_rows is not None:
        np.testing.assert_array_equal(got.group_of_row.numpy(),
                                      np.asarray(want.group_of_row))


def _columns(n=20000, seed=0, key_range=500):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-key_range, key_range, n).astype(np.int32)
    keys[::101] = I32_MIN
    keys[::103] = I32_MAX
    pay = rng.integers(-1000, 1000, n).astype(np.int32)
    pay[::7] = I32_MAX  # heavy groups' int32 sums overflow and wrap
    return keys, pay


@pytest.mark.parametrize("compaction", ["sort", "kernel"])
def test_sort_aggregate_matches_jax(compaction):
    keys, pay = _columns()
    jt, tt = _tables(keys, pay)
    want = jax_agg.sort_aggregate(jt, with_group_of_row=True,
                                  with_distinct=True, compaction="sort")
    got = agg.sort_aggregate(tt, with_group_of_row=True, with_distinct=True,
                             compaction=compaction)
    _assert_same(got, want, FIELDS + ("distinct",), n_rows=keys.size)
    sums = {}
    for k, p in zip(keys.tolist(), pay.tolist()):
        sums[k] = sums.get(k, 0) + p
    wrapped = [(s + 2**31) % 2**32 - 2**31 for _, s in sorted(sums.items())]
    assert got.sum[: len(sums)].tolist() == wrapped


def test_sort_aggregate_100k_rows_auto_is_the_sort_path_on_cpu():
    keys, pay = _columns(n=100_000, seed=1, key_range=30_000)
    jt, tt = _tables(keys, pay)
    want = jax_agg.sort_aggregate(jt, group_capacity=50_000, compaction="sort")
    assert agg._kernel_compaction_choice(tt, "auto") is False
    _assert_same(agg.sort_aggregate(tt, group_capacity=50_000), want)


@pytest.mark.parametrize("cap", [0, 10])
@pytest.mark.parametrize("compaction", ["sort", "kernel"])
def test_group_capacity_truncates_num_groups_exact(cap, compaction):
    keys, pay = _columns(n=5000, seed=2)
    jt, tt = _tables(keys, pay)
    want = jax_agg.sort_aggregate(jt, group_capacity=cap, compaction="sort")
    got = agg.sort_aggregate(tt, group_capacity=cap, compaction=compaction)
    _assert_same(got, want)
    assert int(got.num_groups) == np.unique(keys).size > cap


def test_int64_payloads_sort_path_and_kernel_refused():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 300, 6000).astype(np.int32)
    pay = rng.integers(-(2**40), 2**40, 6000, dtype=np.int64)
    pay[::5] = np.iinfo(np.int64).max // 4
    with jax.enable_x64(True):
        want = jax_agg.sort_aggregate(jax_table(jnp.asarray(keys), jnp.asarray(pay)),
                                      compaction="sort", with_distinct=True)
        want = jax.tree_util.tree_map(np.asarray, want)
    tt = make_table(torch.from_numpy(keys), torch.from_numpy(pay))
    got = agg.sort_aggregate(tt, compaction="sort", with_distinct=True)
    assert got.sum.dtype == torch.int64
    _assert_same(got, want, FIELDS + ("distinct",))
    assert agg._kernel_compaction_choice(tt, "auto") is False
    with pytest.raises(TypeError):
        agg.sort_aggregate(tt, compaction="kernel")
    with pytest.raises(TypeError):
        agg.filter_sort_aggregate_staged(tt, EVEN)
    with pytest.raises(ValueError):
        agg.sort_aggregate(tt, compaction="nope")


def _presorted(n=8000, seed=4):
    keys, pay = _columns(n=n, seed=seed)
    order = np.lexsort((pay, keys))
    return keys[order], pay[order]


@pytest.mark.parametrize("payload_sorted", [True, False])
@pytest.mark.parametrize("compaction", ["sort", "kernel"])
def test_aggregate_sorted_matches_jax(payload_sorted, compaction):
    keys, pay = _presorted()
    if not payload_sorted:
        # payloads in any order within a key run
        rng = np.random.default_rng(5)
        pay = rng.integers(-(2**31), 2**31, pay.size, dtype=np.int64).astype(np.int32)
    jt, tt = _tables(keys, pay)
    for n_valid in (None, 5000):
        want = jax_agg.aggregate_sorted(
            jt, group_capacity=700, n_valid=n_valid, compaction="sort",
            payload_sorted=payload_sorted)
        got = agg.aggregate_sorted(
            tt, group_capacity=700, n_valid=n_valid, compaction=compaction,
            payload_sorted=payload_sorted, check=True)
        _assert_same(got, want)


def test_aggregate_sorted_check_raises_and_distinct_needs_order():
    keys, pay = _presorted(n=200)
    tt = make_table(torch.from_numpy(keys[::-1].copy()), torch.from_numpy(pay))
    with pytest.raises(ValueError):
        agg.aggregate_sorted(tt, check=True)
    # unordered payload runs under payload_sorted
    k = torch.tensor([1, 1, 2], dtype=torch.int32)
    p = torch.tensor([5, 4, 0], dtype=torch.int32)
    with pytest.raises(ValueError):
        agg.aggregate_sorted(make_table(k, p), check=True, payload_sorted=True)
    # ... but rows past n_valid are not checked
    agg.aggregate_sorted(make_table(k, p), n_valid=1, check=True,
                         payload_sorted=True)
    with pytest.raises(ValueError):
        agg.aggregate_sorted(make_table(k, p), with_distinct=True)


@pytest.mark.parametrize("pred", [
    lambda k, p: (p & 1) == 0, lambda k, p: p > 10**9, lambda k, p: p > -(10**9),
])
def test_filter_aggregates_match_jax(pred):
    keys, pay = _columns(n=12000, seed=6)
    pay[::3] = 0
    jt, tt = _tables(keys, pay)
    want, want_n = jax_agg.filter_sort_aggregate(
        jt, pred, group_capacity=900, with_distinct=True, compaction="sort")
    for compaction in ("sort", "kernel"):
        got, got_n = agg.filter_sort_aggregate(
            tt, pred, group_capacity=900, with_group_of_row=True,
            with_distinct=True, compaction=compaction)
        assert int(got_n) == int(want_n)
        _assert_same(got, want, FIELDS + ("distinct",))
        staged, staged_n = agg.filter_sort_aggregate_staged(
            tt, pred, group_capacity=900, with_distinct=True,
            compaction=compaction)
        assert int(staged_n) == int(want_n)
        _assert_same(staged, want, FIELDS + ("distinct",))
        assert (staged.group_of_row == -1).all()
        assert staged.group_of_row.shape == (keys.size,)
    # group_of_row of the fused path: each kept row's dense group id
    mask = np.asarray(pred(keys, pay))
    gids = got.group_of_row.numpy()
    assert (gids[~mask] == -1).all() and (gids[mask] >= 0).all()
    held = mask & (gids < 900)  # groups within the capacity
    np.testing.assert_array_equal(got.keys.numpy()[gids[held]], keys[held])


def test_empty_table_and_mean():
    z = torch.zeros((0,), dtype=torch.int32)
    g = agg.sort_aggregate(make_table(z, z), group_capacity=0)
    assert int(g.num_groups) == 0 and g.keys.shape == (0,)
    keys, pay = _columns(n=3000, seed=7)
    jt, tt = _tables(keys, pay.astype(np.int32) % 100)
    want = jax_agg.sort_aggregate(jt, compaction="sort")
    got = agg.sort_aggregate(tt)
    np.testing.assert_allclose(got.mean().numpy(), np.asarray(want.mean()),
                               rtol=1e-6)
    # the hash family (ported since) gives the same groups in first-row order
    h = agg.hash_aggregate(tt)
    g = int(h.num_groups)
    assert g == int(got.num_groups)
    order = np.argsort(h.keys[:g].numpy(), kind="stable")
    np.testing.assert_array_equal(h.keys[:g].numpy()[order], got.keys[:g].numpy())
    np.testing.assert_array_equal(h.mean()[:g].numpy()[order], got.mean()[:g].numpy())
    hf, nf = agg.filter_aggregate(tt, EVEN)
    gf, ng = agg.filter_sort_aggregate(tt, EVEN)
    assert int(nf) == int(ng) and int(hf.num_groups) == int(gf.num_groups)


def test_pipeline_slice_matches_jax():
    """bench_pipeline.run_query, both plans, against JAX's
    two_run_materialize → aggregate_sorted → top_k at 20K ⋈ 200K."""
    n_a, n_b, cap = 20_000, 200_000, 1 << 15
    rng = np.random.default_rng(8)
    a = np.arange(1, n_a + 1, dtype=np.int32)
    a_pay = a ^ 0x5A17
    b = np.minimum(rng.zipf(1.05, n_b), n_a).astype(np.int32)
    b_pay = rng.integers(0, 1 << 20, n_b).astype(np.int32)
    keys, _, pb, count = two_run_materialize(
        *map(jnp.asarray, (a, a_pay, b, b_pay)), interpret=True,
        probe_payload_sorted=True)
    want = jax_agg.aggregate_sorted(jax_table(keys, pb), group_capacity=cap,
                                    n_valid=count, payload_sorted=True,
                                    compaction="sort")
    want_hot = top_k(jax_table(want.count, want.keys), 10, by="key",
                     descending=True)
    args = [torch.from_numpy(x) for x in (a, a_pay, b, b_pay)]
    for ordered in (True, False):
        g, hot, got_count = bench_pipeline.run_query(*args, cap, ordered)
        assert int(got_count) == int(count) == n_b
        _assert_same(g, want)
        np.testing.assert_array_equal(hot.keys.numpy(), np.asarray(want_hot.keys))
        np.testing.assert_array_equal(hot.payloads.numpy(),
                                      np.asarray(want_hot.payloads))


def test_bench_pipeline_cli_smoke(capsys):
    assert bench_pipeline.main(["--platform", "cpu", "--primary", "2000",
                                "--secondary", "20000"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"metric": "query_join_groupby_rows_per_s_2000x20000_skew1.05"' in line
    assert '"device": "cpu"' in line
