"""The port's distributed materializing and composite-key joins, and the
query layer's and SQL's mesh execution (R6), on the CPU.

JAX runs on its 8 virtual CPU devices (tests/conftest.py), the port on 8
shards of the CPU.  Against JAX, on one tiny shape each: the materialized
rows of inner/semi/anti/left (with filters) as multisets, the composite-key
counts for k = 2 and 3, EXPLAIN text for three plans, the ``PlanError``
words for the plan shapes R6 refuses, and the SQL shell with ``--mesh 2``.
Everything else is held to numpy oracles, and every R6 plan shape of
``tests/test_query.py``'s mesh tests to the port's own single-device plan.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu import query as jq
from partitionedhashjoin_tpu import sql as jsql
from partitionedhashjoin_tpu.data.table import Table as JaxTable
from partitionedhashjoin_tpu.data.table import make_table as jax_table
from partitionedhashjoin_tpu.parallel import mesh as jax_mesh
from partitionedhashjoin_tpu.parallel.materialize_shuffle import (
    DistributedMaterializeJoiner as JaxMaterialize,
)
from partitionedhashjoin_tpu.parallel.multi_key_shuffle import (
    MultiKeyShuffleJoiner as JaxMultiKey,
)
from partitionedhashjoin_tpu_torch import query as tq
from partitionedhashjoin_tpu_torch import sql as tsql
from partitionedhashjoin_tpu_torch.data.table import JoinedTable, Table, table_from_numpy
from partitionedhashjoin_tpu_torch.ops import multi_key
from partitionedhashjoin_tpu_torch.ops.generators import zipf_table
from partitionedhashjoin_tpu_torch.ops.sort_merge import sort_merge_materialize_typed
from partitionedhashjoin_tpu_torch.parallel import mesh as pm
from partitionedhashjoin_tpu_torch.parallel import multi_key_shuffle as pmk
from partitionedhashjoin_tpu_torch.parallel.materialize_shuffle import (
    DistributedMaterializeJoiner,
)
from partitionedhashjoin_tpu_torch.parallel.multi_key_shuffle import MultiKeyShuffleJoiner

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


def _zipf(n, alpha, hi, seed):
    return zipf_table(n, alpha, (1, hi), seed=seed, device="cpu").keys.numpy()


def _rows(joined, n, with_pay_a=True):
    """The multiset of the first ``n`` (key[, pay_a], pay_b, matched) rows."""
    cols = [joined[0], joined[2], joined[3]]
    if with_pay_a:
        cols.insert(1, joined[1])
    return Counter(zip(*(np.asarray(c)[:n].tolist() for c in cols)))


def _joined(j):
    return j.keys, j.payloads_a, j.payloads_b, j.matched, j.count


# ---------------------------------------------------------------- materialize


@pytest.fixture(scope="module")
def zipf_join():
    """A unique 1..N_A build (payload key ^ 0x5A17) and a Zipf(1.25) probe
    over [1, 2 N_A] (a hot head, and misses for anti and left)."""
    a = np.arange(1, N_A + 1, dtype=np.int32)
    b = _zipf(N_B, 1.25, 2 * N_A, 79)
    return (a, a ^ 0x5A17), (b, np.arange(N_B, dtype=np.int32))


@pytest.mark.parametrize("jt", ["inner", "semi", "anti", "left"])
def test_materialize_matches_jax(mesh8, jax_mesh8, zipf_join, jt):
    (a, ap), (b, bp) = zipf_join
    va, vb = a % 5 != 0, bp % 3 != 0
    want = JaxMaterialize(jax_mesh8, seed=71).run(
        jax_table(jnp.asarray(a), jnp.asarray(ap)), jax_table(jnp.asarray(b), jnp.asarray(bp)),
        jt, build_valid=jnp.asarray(va), probe_valid=jnp.asarray(vb))
    op = DistributedMaterializeJoiner(mesh8, seed=71)
    got = op.run(_t(a, ap), _t(b, bp), jt, build_valid=torch.tensor(va),
                 probe_valid=torch.tensor(vb))
    n = int(want.count)
    assert int(got.count) == n and got.keys.shape == want.keys.shape
    assert _rows(_joined(got), n) == _rows(_joined(want), n)
    assert not got.matched[n:].any() and not got.keys[n:].any()
    ref = sort_merge_materialize_typed(*(torch.tensor(x) for x in (a, ap, b, bp)), jt,
                                       build_valid=torch.tensor(va),
                                       probe_valid=torch.tensor(vb))
    assert _rows(_joined(got), n) == _rows(ref, int(ref[4]))
    assert op.last_run.retries == 0 and op.last_run.exchange_bytes > 0


def _check_materialize(mesh, a, ap, b, bp, jt, **knobs):
    op = DistributedMaterializeJoiner(mesh, seed=knobs.pop("seed", 7), **knobs)
    got = op.run(_t(a, ap), _t(b, bp), jt)
    ref = sort_merge_materialize_typed(*(torch.tensor(np.asarray(x, np.int32))
                                         for x in (a, ap, b, bp)), jt)
    n = int(ref[4])
    assert int(got.count) == n
    assert _rows(_joined(got), n) == _rows(ref, n)
    return op


def test_materialize_hot_overflow_grows_and_retries(mesh8):
    """hot_capacity=1 and the hottest key held by 8 build rows of shard 0:
    its replication overflows, the retry grows hot_cap and the rows stay
    exact."""
    a = np.concatenate([np.ones(8, np.int32), np.arange(2, 506, dtype=np.int32)])
    b = _zipf(4096, 1.25, 512, 83)
    op = _check_materialize(mesh8, a, a, b, np.arange(4096), "inner",
                            hot_capacity=1, hot_min_frac=0.0)
    assert op.last_run.attempts[0]["dropped_hot"] > 0 and op.last_run.retries >= 1


def test_materialize_duplicate_build_payloads(mesh8):
    """Duplicate build keys: the distributed join picks the same build row
    (the latest of its key) as the single-device materializer, so the rows
    are equal with ``payloads_a``."""
    rng = np.random.default_rng(89)
    a = rng.integers(0, 300, 512).astype(np.int32)
    b = rng.integers(0, 400, 4096).astype(np.int32)
    for jt in ("inner", "left"):
        _check_materialize(mesh8, a, np.arange(512), b, np.arange(4096), jt, seed=97)


def test_materialize_without_skew_and_retry(mesh8):
    a = np.arange(1, 1025, dtype=np.int32)
    b = _zipf(8192, 1.25, 1024, 5)
    op = _check_materialize(mesh8, a, a, b, np.arange(8192), "semi", slack=1.0,
                            handle_skew=False)
    assert op.last_run.attempts[0]["dropped_b"] > 0 and op.last_run.retries >= 1


def test_materialize_rejects_full_and_wrong_inputs(mesh8):
    t = _t(np.arange(64), np.arange(64))
    op = DistributedMaterializeJoiner(mesh8, seed=1)
    with pytest.raises(ValueError, match="stays single-device"):
        op.run(t, t, "full")
    with pytest.raises(ValueError, match="divide"):
        op.run(t, _t(np.arange(9), np.arange(9)))
    wide = Table(keys=torch.arange(8, dtype=torch.int32), payloads=torch.zeros(8, dtype=torch.int64))
    with pytest.raises(TypeError, match="int32-only"):
        op.run(wide, t)


# ---------------------------------------------------------------- composite keys


def _oracle(build_cols, probe_cols):
    build = set(zip(*[np.asarray(c).tolist() for c in build_cols]))
    return sum(1 for t in zip(*[np.asarray(c).tolist() for c in probe_cols]) if t in build)


def _cols(rng, k, n, lo=-40, hi=40):
    return [rng.integers(lo, hi, size=n).astype(np.int32) for _ in range(k)]


@pytest.mark.parametrize("k", [2, 3])
def test_multi_key_matches_jax(mesh8, jax_mesh8, k):
    rng = np.random.default_rng(500 + k)
    a, b = _cols(rng, k, N_A), _cols(rng, k, N_B)
    want = JaxMultiKey(jax_mesh8, seed=11).run([jnp.asarray(c) for c in a],
                                               [jnp.asarray(c) for c in b])
    got = MultiKeyShuffleJoiner(mesh8, seed=11).run([torch.tensor(c) for c in a],
                                                    [torch.tensor(c) for c in b])
    assert got == want == _oracle(a, b)
    assert got == int(multi_key.multi_key_count([torch.tensor(c) for c in a],
                                                [torch.tensor(c) for c in b]))


def test_hash_tuple_matches_jax():
    from partitionedhashjoin_tpu.parallel.multi_key_shuffle import _hash_tuple

    rng = np.random.default_rng(3)
    cols = _cols(rng, 3, 512, I32.min, I32.max)
    for seed in (0, 11, 0xFFFFFFFF):
        want = np.asarray(_hash_tuple(tuple(jnp.asarray(c) for c in cols), jnp.uint32(seed)))
        got = pmk._hash_tuple([torch.tensor(c) for c in cols], seed)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("case", ["one_shard", "non_divisible", "boundary", "k1"])
def test_multi_key_matches_oracle(mesh8, case):
    rng = np.random.default_rng(9)
    mesh = pm.make_mesh(1, devices=["cpu"]) if case == "one_shard" else mesh8
    if case == "boundary":
        # live rows keep tag 0 whatever their values: INT32_MAX/MIN tuples
        m, M = I32.min, I32.max
        a = [np.array([M, M, m, 0] * 4, np.int32), np.array([M, 5, m, 0] * 4, np.int32)]
        b = [np.array([M, M, m, 1, M] * 3, np.int32), np.array([M, M, m, 1, 5] * 3, np.int32)]
    else:
        k = 1 if case == "k1" else 2
        a, b = _cols(rng, k, 1001), _cols(rng, k, 2030)
    assert MultiKeyShuffleJoiner(mesh, seed=3).run(a, b) == _oracle(a, b)


def test_multi_key_skewed_tuple_retries_to_exact(mesh8):
    """One tuple is ~60% of the probe side: its owner's bucket overflows at
    slack 1.01 and the doubled slack absorbs it."""
    rng = np.random.default_rng(13)
    a = [np.arange(512, dtype=np.int32), np.arange(512, dtype=np.int32) % 7]
    b1 = np.concatenate([np.full(3000, 17, np.int32),
                         rng.integers(0, 512, 2000).astype(np.int32)])
    b = [b1, b1 % 7]
    j = MultiKeyShuffleJoiner(mesh8, seed=5, slack=1.01, max_retries=6)
    assert j.run(a, b) == _oracle(a, b)
    assert j.last_run.attempts[0]["dropped_b"] > 0 and j.last_run.retries >= 1


def test_multi_key_run_i64_and_validation(mesh8):
    rng = np.random.default_rng(31)
    a64 = rng.integers(-(2**40), 2**40, 1000)
    a64[:2] = (np.iinfo(np.int64).min, np.iinfo(np.int64).max)
    b64 = np.concatenate([a64[:300], rng.integers(-(2**40), 2**40, 700)])
    want = int(np.isin(b64, a64).sum())
    assert MultiKeyShuffleJoiner(mesh8, seed=4).run_i64(torch.tensor(a64),
                                                        torch.tensor(b64)) == want
    from partitionedhashjoin_tpu.ops.pallas.merge_probe import split_i64

    import jax

    with jax.enable_x64(True):
        want_planes = [np.asarray(p) for p in split_i64(jnp.asarray(a64))]
    for got, plane in zip(pmk._split_i64(torch.tensor(a64)), want_planes):
        np.testing.assert_array_equal(got.numpy(), plane)
    j = MultiKeyShuffleJoiner(mesh8)
    e, one = [np.array([], np.int32)] * 2, np.array([1, 2], np.int32)
    assert j.run(e, [one, one]) == 0 and j.run([one, one], e) == 0
    with pytest.raises(ValueError, match="mismatch"):
        j.run([one], [one, one])
    with pytest.raises(TypeError, match="64-bit"):
        j.run([np.arange(4)], [np.arange(4)])


# ---------------------------------------------------------------- R6: the query layer


def _q_tables(seed, n_a=64, n_b=512, a_hi=40, b_hi=60, a_pay=(1, 9), b_pay=(-99, 99)):
    rng = np.random.default_rng(seed)
    a = _t(rng.integers(0, a_hi, n_a), rng.integers(*a_pay, n_a))
    b = _t(rng.integers(0, b_hi, n_b), rng.integers(*b_pay, n_b))
    return a, b


def _group_map(g):
    n = int(g.num_groups)
    cols = [g.keys, g.count, g.sum, g.min, g.max] + ([g.distinct] if g.distinct is not None
                                                    else [])
    return {r[0]: tuple(r[1:]) for r in zip(*(c[:n].tolist() for c in cols))}


def _even(k, p):
    return p % 2 == 0


def _gt3(k, p):
    return p > 3


#: name -> plan builder over (scan, a, b); each runs on the mesh and on one
#: device and the two results must be equal (the plan shapes of
#: tests/test_query.py's TestMesh)
R6_GROUP_PLANS = {
    "filter_group_by": lambda S, a, b: S(b).filter(_even).group_by(),
    "group_by_having": lambda S, a, b: S(b).group_by().having(lambda g: g.count > 9),
    "group_by_distinct": lambda S, a, b: S(b).group_by(with_distinct=True),
    "join_group_by": lambda S, a, b: S(b).join(S(a)).group_by(),
    "join_group_by_filtered": lambda S, a, b: S(b).filter(lambda k, p: p % 3 != 0)
    .join(S(a).filter(lambda k, p: p != 4)).group_by(),
}


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("name", sorted(R6_GROUP_PLANS))
def test_r6_group_plans_equal_one_device(mesh8, name, tail):
    a, b = _q_tables(53)
    q = R6_GROUP_PLANS[name](tq.scan, a, b)
    if tail:  # the group-stage tail runs on the gathered result
        q = q.order_by("count", descending=True).limit(3)
    got, want = q.execute(mesh=mesh8), q.execute()
    if tail:
        assert got.count.tolist() == want.count.tolist()
    else:
        assert _group_map(got) == _group_map(want) and len(_group_map(got)) > 0
    assert q.count(mesh=mesh8) == q.count()
    assert "R6" in q.explain(mesh=mesh8)


@pytest.mark.parametrize("filtered", [False, True])
def test_r6_join_counts(mesh8, filtered):
    a, b = _q_tables(59, b_pay=(-9, 9))
    q = (tq.scan(b).filter(_even).join(tq.scan(a).filter(_gt3)) if filtered
         else tq.scan(b).join(tq.scan(a)))
    bk, bp, ak, ap = b.keys.numpy(), b.payloads.numpy(), a.keys.numpy(), a.payloads.numpy()
    sel_a = ap > 3 if filtered else np.ones(64, bool)
    sel_b = bp % 2 == 0 if filtered else np.ones(512, bool)
    want = int(np.isin(bk[sel_b], ak[sel_a]).sum())
    assert q.count(mesh=mesh8) == want == q.count()
    assert tq.scan(b).join(tq.scan(a), "semi").limit(5).count(mesh=mesh8) == 5
    assert "distributed shuffle join" in tsql.explain_sql(
        "SELECT COUNT(*) FROM b JOIN a USING (key)", {"a": a, "b": b}, mesh=mesh8)


def test_r6_top_k(mesh8):
    rng = np.random.default_rng(47)
    b = _t(rng.integers(0, 10**6, 512), rng.integers(0, 99, 512))
    bk, bp = b.keys.numpy(), b.payloads.numpy()
    r = tq.scan(b).order_by("key", descending=True).limit(5).execute(mesh=mesh8)
    np.testing.assert_array_equal(r.table.keys.numpy(), np.sort(bk)[::-1][:5])
    q = tq.scan(b).filter(lambda k, p: p < 50).order_by("key", descending=True).limit(5)
    assert "validity mask" in q.explain(mesh=mesh8)
    r, r1 = q.execute(mesh=mesh8), q.execute()
    assert int(r.count) == int(r1.count) == 5
    assert torch.equal(r.table.keys, r1.table.keys)
    # fewer survivors than k: the live prefix shrinks
    q2 = tq.scan(b).filter(lambda k, p: p == 7).order_by("key", descending=True).limit(5)
    n2 = min(5, int((bp == 7).sum()))
    r2 = q2.execute(mesh=mesh8)
    assert int(r2.count) == n2
    np.testing.assert_array_equal(r2.table.keys.numpy()[:n2], np.sort(bk[bp == 7])[::-1][:n2])


@pytest.mark.parametrize("jt", ["inner", "semi", "anti", "left"])
def test_r6_join_materialize(mesh8, jt):
    a, b = _q_tables(67)
    q = tq.scan(b).filter(lambda k, p: p > -50).join(tq.scan(a).filter(_even), join_type=jt)
    out, one = q.execute(mesh=mesh8), q.execute()
    assert isinstance(out, JoinedTable)
    n = int(one.count)
    assert int(out.count) == n and _rows(_joined(out), n) == _rows(_joined(one), n)
    agg, agg1 = q.aggregate(mesh=mesh8), q.aggregate()
    assert [int(x) for x in (agg.count, agg.sum, agg.min, agg.max)] == [
        int(x) for x in (agg1.count, agg1.sum, agg1.min, agg1.max)]


def test_r6_join_order_by_limit(mesh8):
    a, b = _q_tables(69)
    q = tq.scan(b).join(tq.scan(a)).order_by("payload", descending=True).limit(4)
    r, r1 = q.execute(mesh=mesh8), q.execute()
    assert int(r.count) == int(r1.count)
    assert torch.equal(r.table.payloads, r1.table.payloads)
    # limit without order: the live count caps at the joined rows' prefix
    one = _t(np.arange(1, 9), np.arange(1, 9))
    tiny = _t([1, 0, 0, 0, 0, 0, 0, 0], [5, 0, 0, 0, 0, 0, 0, 0])
    qh = tq.scan(tiny).join(tq.scan(one)).limit(5)
    assert int(qh.execute().count) == int(qh.execute(mesh=mesh8).count) == 1


def _jax_twin(t: Table) -> JaxTable:
    """The JAX table of the same rows and uuid (so EXPLAIN's scan lines
    match)."""
    return JaxTable(keys=jnp.asarray(t.keys.numpy()), payloads=jnp.asarray(t.payloads.numpy()),
                    uuid=t.uuid)


def test_r6_refusals_raise_jax_words(mesh8, jax_mesh8):
    t = _t(np.arange(1, 9), np.arange(1, 9))
    jt = _jax_twin(t)
    shapes = [
        lambda S, x: S(x).join(S(x), carry="build").group_by(),
        lambda S, x: S(x).join(S(x).join(S(x), carry="probe")).group_by(),
        lambda S, x: S(x).join(S(x), join_type="left").group_by(),
        lambda S, x: S(x).join(S(x), join_type="full"),
        lambda S, x: S(x).join(S(x)).group_by(with_distinct=True),
        lambda S, x: S(x).order_by("key"),
        lambda S, x: S(x).filter(_even).limit(3),
    ]
    for build in shapes:
        with pytest.raises(jq.PlanError) as want:
            build(jq.scan, jt).execute(mesh=jax_mesh8)
        with pytest.raises(tq.PlanError) as got:
            build(tq.scan, t).execute(mesh=mesh8)
        assert str(got.value) == str(want.value)
    for jtype in ("anti", "left"):
        with pytest.raises(jq.PlanError) as want:
            jq.scan(jt).join(jq.scan(jt), jtype).count(mesh=jax_mesh8)
        with pytest.raises(tq.PlanError) as got:
            tq.scan(t).join(tq.scan(t), jtype).count(mesh=mesh8)
        assert str(got.value) == str(want.value)


def test_r6_explain_equals_jax(mesh8, jax_mesh8):
    a, b = _q_tables(53)
    ja, jb = _jax_twin(a), _jax_twin(b)
    plans = [
        lambda S, a, b: S(b).filter(_even).group_by(),
        lambda S, a, b: S(b).join(S(a)),
        lambda S, a, b: S(b).filter(_even).order_by("key", True).limit(5),
    ]
    for build in plans:
        want = build(jq.scan, ja, jb).explain(mesh=jax_mesh8)
        got = build(tq.scan, a, b).explain(mesh=mesh8)
        assert got == want and got.startswith("physical plan [mesh S=8]")


# ---------------------------------------------------------------- R6: SQL


def _assert_same_top_rows(got, want):
    """Equal columns, except that rows tied on the last ORDER BY value may
    be other rows: the mesh's group table is in shard-hash order, one
    device's in key order, and ties go to the lower group row in both."""
    assert got.row_count == want.row_count and list(got.columns) == list(want.columns)
    names = list(got.columns)
    order = "count" if "count" in names else names[-1]
    np.testing.assert_array_equal(got.columns[order], want.columns[order])
    if got.row_count == 0:
        return
    last = got.columns[order][-1]

    def rows(r):
        keep = r.columns[order] != last
        return sorted(zip(*(r.columns[c][keep].tolist() for c in names)))

    assert rows(got) == rows(want)


def test_sql_with_mesh(mesh8):
    a, b = _q_tables(43, n_b=640, b_hi=25)
    db = {"a": a, "b": b}
    for sql in ("SELECT key, COUNT(*) FROM b GROUP BY key HAVING COUNT(*) > 30 "
                "ORDER BY count DESC LIMIT 3",
                "SELECT key, COUNT(*), SUM(b.payload), MIN(b.payload), MAX(b.payload) "
                "FROM b JOIN a USING (key) GROUP BY key ORDER BY count DESC LIMIT 10",
                "SELECT COUNT(*) FROM b JOIN a USING (key)",
                "SELECT key, payload FROM b WHERE payload > 0 ORDER BY payload DESC LIMIT 4"):
        got, want = tsql.execute_sql(sql, db, mesh=mesh8), tsql.execute_sql(sql, db)
        _assert_same_top_rows(got, want)
        plan = tsql.explain_sql(sql, db, mesh=mesh8)
        assert plan.startswith("physical plan [mesh S=8]") and "R6" in plan
        e = tsql.execute_sql("EXPLAIN " + sql, db, mesh=mesh8)
        assert "\n".join(e.columns["plan"]) == plan
    with pytest.raises(tsql.SqlError, match="mesh table-stage plans"):
        tsql.execute_sql("SELECT key FROM b ORDER BY key", db, mesh=mesh8)


def test_sql_shell_with_mesh_prints_what_jax_prints(capsys):
    argv = ["--mesh", "2", "--table", "a=sequential:60", "--table", "b=sequential:90:20",
            "SELECT key, payload FROM b WHERE key % 7 = 0 ORDER BY key DESC LIMIT 3"]
    assert jsql.main(argv) == 0
    want = capsys.readouterr().out
    assert tsql.main(["--platform", "cpu"] + argv) == 0
    assert capsys.readouterr().out == want
    assert want.startswith("key\tpayload\n") and "(3 rows)" in want
    count = ["--platform", "cpu", "--mesh", "2", "--table", "a=sequential:1000",
             "--table", "b=zipf:5000:1.05:1:1000", "SELECT COUNT(*) FROM b JOIN a USING (key)"]
    assert tsql.main(count) == 0
    assert capsys.readouterr().out == "count\n5000\n(1 rows)\n"
    assert tsql.main(count[:-1] + ["--explain", count[-1]]) == 0
    assert capsys.readouterr().out.startswith("physical plan [mesh S=2]")
