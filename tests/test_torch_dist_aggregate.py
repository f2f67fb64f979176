"""The port's distributed GROUP BY, top-k and join → GROUP BY, on the CPU.

One tiny shape per operator goes through both packages, JAX on its 8
virtual CPU devices (tests/conftest.py), the port on 8 shards of the CPU:
the key → aggregates maps (and COUNT DISTINCT), the top-k rows with ties,
and the join → GROUP BY map must be equal.  Every other case of
``tests/test_distributed_aggregate.py`` (random and Zipf data, padding, a
genuine zero key, capacity retries, int32 wrap, empty and wide inputs,
masks, validation) is held to numpy oracles and the port's single-device
operators, so the file compiles few JAX programs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu.data.table import make_table as jax_table
from partitionedhashjoin_tpu.parallel import mesh as jax_mesh
from partitionedhashjoin_tpu.parallel.aggregate_shuffle import (
    DistributedAggregateOperator as JaxAggregate,
)
from partitionedhashjoin_tpu.parallel.join_aggregate import (
    DistributedJoinAggregateOperator as JaxJoinAggregate,
)
from partitionedhashjoin_tpu.parallel.top_k import distributed_top_k as jax_top_k
from partitionedhashjoin_tpu_torch.data.table import make_table, table_from_numpy
from partitionedhashjoin_tpu_torch.ops import order_by
from partitionedhashjoin_tpu_torch.ops.aggregate import (
    filter_sort_aggregate,
    sort_aggregate,
)
from partitionedhashjoin_tpu_torch.ops.generators import zipf_table
from partitionedhashjoin_tpu_torch.parallel import aggregate_shuffle as pa
from partitionedhashjoin_tpu_torch.parallel import mesh as pm
from partitionedhashjoin_tpu_torch.parallel.aggregate_shuffle import (
    DistributedAggregateOperator,
)
from partitionedhashjoin_tpu_torch.parallel.join_aggregate import (
    DistributedJoinAggregateOperator,
)
from partitionedhashjoin_tpu_torch.parallel.top_k import distributed_top_k

torch.set_num_threads(1)

I32 = np.iinfo(np.int32)
N_A, N_B = 4096, 16384


@pytest.fixture(scope="module")
def mesh8():
    return pm.make_mesh(8, devices=["cpu"])


@pytest.fixture(scope="module")
def jax_mesh8():
    return jax_mesh.make_mesh(8)


def _t(keys, pays):
    return table_from_numpy(np.asarray(keys, np.int32), np.asarray(pays, np.int32), "cpu")


def _as_map(g, distinct=False):
    """key -> (count, sum, min, max[, distinct]) over the valid groups."""
    n = int(g.num_groups)
    cols = [np.asarray(c)[:n].tolist() for c in (g.keys, g.count, g.sum, g.min, g.max)]
    if distinct:
        cols.append(np.asarray(g.distinct)[:n].tolist())
    return {row[0]: tuple(row[1:]) for row in zip(*cols)}


def _np_group(keys, pays, distinct=False):
    """The numpy oracle: key -> (count, sum mod 2^32, min, max[, distinct])."""
    out = {}
    for k in np.unique(keys).tolist():
        p = pays[keys == k].astype(np.int64)
        s = int(((p.sum() + 2**31) % 2**32) - 2**31)
        row = (int(p.size), s, int(p.min()), int(p.max()))
        out[k] = row + ((int(np.unique(p).size),) if distinct else ())
    return out


def _np_join_group(build_keys, probe_keys, probe_pays):
    sel = np.isin(probe_keys, build_keys)
    return _np_group(probe_keys[sel], probe_pays[sel])


def _zipf(n, alpha, hi, seed):
    return zipf_table(n, alpha, (1, hi), seed=seed, device="cpu").keys.numpy()


# ---------------------------------------------------------------- against JAX


def test_aggregate_matches_jax(mesh8, jax_mesh8):
    rng = np.random.default_rng(61)
    keys = rng.integers(0, 200, N_A).astype(np.int32)
    pays = rng.integers(-1000, 1000, N_A).astype(np.int32)
    pays[:40] = 7  # repeated payloads: COUNT DISTINCT below one per row
    jt, t = jax_table(jnp.asarray(keys), jnp.asarray(pays)), _t(keys, pays)
    for distinct in (False, True):
        want = JaxAggregate(jax_mesh8, seed=3).run(jt, with_distinct=distinct)
        got = DistributedAggregateOperator(mesh8, seed=3).run(t, with_distinct=distinct)
        assert int(got.num_groups) == int(want.num_groups) == len(np.unique(keys))
        assert _as_map(got, distinct) == _as_map(want, distinct)
        assert got.keys.shape == want.keys.shape  # JAX's capacities, S * cap
        assert got.count.dtype == got.num_groups.dtype == torch.int32


def test_top_k_matches_jax_with_ties(mesh8, jax_mesh8):
    """Payloads in [0, 9): each value is held by ~455 rows, so every top-k
    is decided by ties, which both packages break by row (the carried key
    follows its row)."""
    rng = np.random.default_rng(71)
    keys = rng.permutation(N_A).astype(np.int32) - 2048
    pays = rng.integers(0, 9, N_A).astype(np.int32)
    jt, t = jax_table(jnp.asarray(keys), jnp.asarray(pays)), _t(keys, pays)
    mask = pays % 4 != 1
    for by, desc, m in (("payload", True, None), ("payload", False, mask),
                        ("key", True, None)):
        want, want_live = jax_top_k(jax_mesh8, jt, 12, by=by, descending=desc,
                                    mask=None if m is None else jnp.asarray(m))
        got, live = distributed_top_k(mesh8, t, 12, by=by, descending=desc,
                                      mask=None if m is None else torch.tensor(m))
        assert int(live) == int(want_live) == 12
        np.testing.assert_array_equal(got.keys.numpy(), np.asarray(want.keys))
        np.testing.assert_array_equal(got.payloads.numpy(), np.asarray(want.payloads))
        if m is None:
            local = order_by.top_k(t, 12, by=by, descending=desc)
            assert torch.equal(got.keys, local.keys)


def test_join_aggregate_matches_jax(mesh8, jax_mesh8):
    """A Zipf(1.25) probe over a 1..N_A build: hot keys planned, replicated
    and merged as partials in both packages."""
    a = np.arange(1, N_A + 1, dtype=np.int32)
    b = _zipf(N_B, 1.25, 2 * N_A, 21)
    bp = np.random.default_rng(82).integers(-1000, 1000, N_B).astype(np.int32)
    ja, jb = jax_table(jnp.asarray(a), jnp.asarray(a ^ 0x5A17)), jax_table(
        jnp.asarray(b), jnp.asarray(bp))
    want = JaxJoinAggregate(jax_mesh8, seed=5).run(ja, jb)
    op = DistributedJoinAggregateOperator(mesh8, seed=5)
    got = op.run(_t(a, a ^ 0x5A17), _t(b, bp))
    assert _as_map(got) == _as_map(want) == _np_join_group(a, b, bp)
    assert got.keys.shape == want.keys.shape
    attempts = op.last_run.attempts
    assert attempts[0] == {"dropped_a": 0, "dropped_b": 0, "dropped_hot": 0}
    assert len(attempts) == 2 and op.last_run.retries == 0  # exchange, aggregate
    assert op.last_run.exchange_bytes > 0


# ---------------------------------------------------------------- aggregate


def _check_aggregate(mesh, keys, pays, seed=3, distinct=False, mask=None):
    t = _t(keys, pays)
    g = DistributedAggregateOperator(mesh, seed=seed).run(
        t, mask=None if mask is None else torch.tensor(mask), with_distinct=distinct)
    sel = slice(None) if mask is None else mask
    assert _as_map(g, distinct) == _np_group(keys[sel], pays[sel], distinct)
    if mask is None:
        local = sort_aggregate(t, with_distinct=distinct)
    else:
        local, _ = filter_sort_aggregate(t, lambda k, p: torch.tensor(mask),
                                         with_distinct=distinct)
    assert int(g.num_groups) == int(local.num_groups)
    assert _as_map(g, distinct) == _as_map(local, distinct)
    return g


@pytest.mark.parametrize("distinct", [False, True])
@pytest.mark.parametrize("case", ["random", "zipf", "non_divisible", "zero_key"])
def test_aggregate_matches_numpy(mesh8, case, distinct):
    rng = np.random.default_rng(62)
    if case == "random":
        keys = rng.integers(0, 200, N_A)
    elif case == "zipf":
        keys = _zipf(N_B, 1.25, 300, 9)
    elif case == "non_divisible":
        keys = rng.integers(0, 50, 1003)  # padded rows must form no group
    else:
        keys = np.zeros(777, np.int64)  # padding writes key 0 too
        keys[:388] = rng.integers(1, 20, 388)
    keys = np.asarray(keys, np.int32)
    pays = rng.integers(-100, 100, keys.size).astype(np.int32)
    _check_aggregate(mesh8, keys, pays, distinct=distinct)


def test_aggregate_capacity_overflow_retries_to_exact(mesh8):
    """700 keys, 4 rows each, capacity hint 2 at slack 1: the combiner and
    the exchange overflow, and the retries land exact."""
    rng = np.random.default_rng(64)
    keys = rng.permutation(np.repeat(np.arange(700, dtype=np.int32), 4))
    pays = rng.integers(-100, 100, keys.size).astype(np.int32)
    op = DistributedAggregateOperator(mesh8, seed=13, slack=1.0)
    g = op.run(_t(keys, pays), group_capacity=2)
    assert _as_map(g) == _np_group(keys, pays)
    first, last = op.last_run.attempts[0], op.last_run.attempts[-1]
    assert first["local_need"] > first["cap_local"] == 16
    assert op.last_run.retries >= 1
    assert last["local_need"] <= last["cap_local"] and last["dropped"] == 0


def test_distinct_skew_retries_to_exact(mesh8):
    """The Zipf head's rows all travel to one owner: at slack 1 its bucket
    overflows and the doubled slack absorbs it."""
    keys = _zipf(8192, 1.25, 100, 93)
    pays = (np.arange(8192) % 13).astype(np.int32)
    op = DistributedAggregateOperator(mesh8, seed=29, slack=1.0)
    g = op.run(_t(keys, pays), with_distinct=True)
    assert _as_map(g, True) == _np_group(keys, pays, True)
    assert op.last_run.attempts[0]["dropped"] > 0 and op.last_run.retries >= 1


def test_aggregate_sums_wrap_mod_2_32(mesh8):
    keys = np.repeat(np.arange(4, dtype=np.int32), 512)
    pays = np.full(keys.size, 2**30, np.int32)
    g = _check_aggregate(mesh8, keys, pays, seed=17)
    assert set(np.asarray(g.sum)[:4].tolist()) == {0}  # 512 * 2^30 wraps to 0


@pytest.mark.parametrize("distinct", [False, True])
def test_aggregate_with_mask(mesh8, distinct):
    rng = np.random.default_rng(95)
    keys = rng.integers(0, 30, 2051).astype(np.int32)
    pays = rng.integers(0, 6, 2051).astype(np.int32)
    _check_aggregate(mesh8, keys, pays, seed=29, distinct=distinct,
                     mask=np.arange(2051) % 3 != 0)


def test_aggregate_empty_wide_and_validation(mesh8):
    op = DistributedAggregateOperator(mesh8, seed=19)
    g = op.run(_t([], []))
    assert int(g.num_groups) == 0 and g.keys.shape == (0,)
    wide = make_table(torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int64))
    with pytest.raises(TypeError, match="int32-only"):
        op.run(wide)
    with pytest.raises(ValueError, match="mask shape"):
        op.run(_t(range(8), range(8)), mask=torch.ones(9, dtype=torch.bool))
    with pytest.raises(ValueError, match="power of 2"):
        DistributedAggregateOperator(pm.make_mesh(3, devices=["cpu"]))


def test_merge_partials_folds_runs():
    """Partials of one key from several shards fold: counts and sums add
    (sums wrap), mins and maxes fold; invalid slots and groups past the
    capacity are left out, ``num_groups`` stays exact."""
    key = torch.tensor([5, 3, 5, 9, 3, 5, 0, 7], dtype=torch.int32)
    cnt = torch.tensor([1, 2, 3, 4, 5, 6, 99, 1], dtype=torch.int32)
    sm = torch.tensor([2**31 - 1, 1, 1, 4, 2, 0, 99, 3], dtype=torch.int32)
    mn = torch.tensor([-4, 0, 2, 4, -1, 7, -99, 3], dtype=torch.int32)
    mx = torch.tensor([9, 8, 2, 4, 3, 7, 99, 3], dtype=torch.int32)
    valid = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1], dtype=torch.bool)
    k, c, s, lo, hi, num = pa._merge_partials(key, cnt, sm, mn, mx, valid, 6)
    assert num == 4
    assert k.tolist() == [3, 5, 7, 9, 0, 0]
    assert c.tolist() == [7, 10, 1, 4, 0, 0]
    assert s.tolist() == [3, -(2**31), 3, 4, 0, 0]
    assert lo.tolist() == [-1, -4, 3, 4, 0, 0] and hi.tolist() == [8, 9, 3, 4, 0, 0]
    k, *_, num = pa._merge_partials(key, cnt, sm, mn, mx, valid, 2)
    assert num == 4 and k.tolist() == [3, 5]


# ---------------------------------------------------------------- top-k


def test_top_k_matches_local_for_every_order(mesh8):
    rng = np.random.default_rng(73)
    keys = rng.permutation(N_A).astype(np.int32) - 2048
    pays = rng.integers(-999, 999, N_A).astype(np.int32)
    t = _t(keys, pays)
    mask = pays % 3 == 0
    for by in ("key", "payload"):
        for desc in (True, False):
            got, live = distributed_top_k(mesh8, t, 12, by=by, descending=desc)
            want = order_by.top_k(t, 12, by=by, descending=desc)
            assert int(live) == 12 and live.dtype == torch.int64
            assert torch.equal(got.keys, want.keys) and torch.equal(got.payloads, want.payloads)
            got, live = distributed_top_k(mesh8, t, 12, by=by, descending=desc,
                                          mask=torch.tensor(mask))
            col = (keys if by == "key" else pays)[mask]
            ref = np.sort(col)[::-1][:12] if desc else np.sort(col)[:12]
            assert int(live) == 12
            np.testing.assert_array_equal(
                (got.keys if by == "key" else got.payloads).numpy(), ref)


def test_top_k_padding_rows_never_surface(mesh8):
    keys = np.arange(10, 19, dtype=np.int32)  # 9 rows: 7 pad rows of key 0
    got, _ = distributed_top_k(mesh8, _t(keys, keys), 1, by="key", descending=False)
    assert got.keys.tolist() == [10]


def test_top_k_fewer_survivors_than_k(mesh8):
    """n_live < k: the live prefix is the survivor count and no invalid row
    is selected, also when valid rows sit at the int32 extremes."""
    keys = np.arange(64, dtype=np.int32)
    keys[3], keys[40] = I32.min, I32.max
    mask = np.zeros(64, bool)
    mask[[3, 17, 40]] = True
    got, live = distributed_top_k(mesh8, _t(keys, keys), 8, by="key",
                                  descending=False, mask=torch.tensor(mask))
    assert int(live) == 3
    assert got.keys.tolist() == [I32.min, 17, I32.max, 0, 0, 0, 0, 0]


def test_top_k_validation(mesh8):
    t = _t(np.arange(64), np.arange(64))
    with pytest.raises(ValueError, match="per-shard"):
        distributed_top_k(mesh8, t, 20)
    with pytest.raises(ValueError, match="positive"):
        distributed_top_k(mesh8, t, 0)
    with pytest.raises(ValueError, match="exceeds table size"):
        distributed_top_k(mesh8, t, 65)
    with pytest.raises(ValueError, match="by must be"):
        distributed_top_k(mesh8, t, 2, by="count")


# ---------------------------------------------------------------- join → GROUP BY


def _check_join_aggregate(mesh, a, ap, b, bp, **kw):
    op = DistributedJoinAggregateOperator(mesh, **kw)
    g = op.run(_t(a, ap), _t(b, bp))
    want = _np_join_group(a, b, bp)
    assert int(g.num_groups) == len(want) and _as_map(g) == want
    return op


def test_join_aggregate_partial_match(mesh8):
    """The build covers half the probe's key range: unmatched keys form no
    group."""
    rng = np.random.default_rng(81)
    _check_join_aggregate(
        mesh8, rng.integers(0, 50, 256).astype(np.int32), rng.integers(0, 9, 256),
        rng.integers(0, 100, N_A).astype(np.int32), rng.integers(-1000, 1000, N_A),
        seed=3)


def test_join_aggregate_without_skew_handling(mesh8):
    b = _zipf(8192, 1.05, 200, 23)
    op = _check_join_aggregate(mesh8, np.arange(1, 129, dtype=np.int32), np.zeros(128),
                               b, np.arange(8192) % 1000, seed=7, handle_skew=False)
    assert all(a.get("dropped_hot", 0) == 0 for a in op.last_run.attempts)


def test_join_aggregate_capacity_overflow_retries(mesh8):
    rng = np.random.default_rng(83)
    keys = rng.permutation(np.repeat(np.arange(600, dtype=np.int32), 4))
    a = np.concatenate([np.arange(600, dtype=np.int32), np.zeros(8, np.int32)])
    op = DistributedJoinAggregateOperator(mesh8, seed=9, slack=1.0)
    bp = rng.integers(-100, 100, keys.size).astype(np.int32)
    g = op.run(_t(a, np.zeros(608)), _t(keys, bp), group_capacity=2)
    assert _as_map(g) == _np_join_group(a, keys, bp)
    assert op.last_run.retries >= 1


def test_join_aggregate_duplicate_build_keys_count_once(mesh8):
    _check_join_aggregate(
        mesh8, np.repeat(np.arange(8, dtype=np.int32), 8), np.arange(64),
        np.tile(np.arange(16, dtype=np.int32), 8), np.ones(128), seed=11)


def test_join_aggregate_int32_max_key(mesh8):
    """INT32_MAX is the received build set's padding value; a genuine
    INT32_MAX key still joins."""
    m = I32.max
    _check_join_aggregate(
        mesh8, np.asarray([m, 1, 2, 3, 4, 5, 6, 7]), np.zeros(8),
        np.asarray([m, m, 1, 9, m, 2, 9, 9] * 2), np.arange(16), seed=13)


def test_join_aggregate_masks_and_validation(mesh8):
    rng = np.random.default_rng(61)
    a, ap = rng.integers(0, 40, 64).astype(np.int32), rng.integers(1, 9, 64)
    b, bp = rng.integers(0, 60, 512).astype(np.int32), rng.integers(-99, 99, 512)
    va, vb = ap != 4, bp % 3 != 0
    g = DistributedJoinAggregateOperator(mesh8, seed=15).run(
        _t(a, ap), _t(b, bp), build_valid=torch.tensor(va), probe_valid=torch.tensor(vb))
    assert _as_map(g) == _np_join_group(a[va], b[vb], bp[vb])
    op = DistributedJoinAggregateOperator(mesh8, seed=15)
    with pytest.raises(ValueError, match="divide"):
        op.run(_t(range(8), range(8)), _t(range(9), range(9)))
    wide = make_table(torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int64))
    with pytest.raises(TypeError, match="int32-only"):
        op.run(wide, _t(range(8), range(8)))
