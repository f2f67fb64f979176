"""The port's query layer against the JAX package's, on the CPU.

The same numpy relations go through ``partitionedhashjoin_tpu.query`` and
``partitionedhashjoin_tpu_torch.query``; the plans' results must be equal
(groups field by field, rows, counts), and their EXPLAIN must carry the same
rule tags (R1-R7) on the same number of operator lines.  JAX runs without
``interpret``, so no Pallas program compiles: on the CPU its query layer
takes its typed and XLA paths, the port its kernel paths' plain versions.
EXPLAIN is compared with JAX's ``explain(interpret=True)``, which plans the
kernel paths and executes nothing.  Every JAX plan runs on relations of one
shape (40 build rows, 400 probe rows), so its programs compile once.
"""

import re

import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu import query as jq
from partitionedhashjoin_tpu.data.table import make_table as jax_make_table
from partitionedhashjoin_tpu.ops.aggregate import GroupByResult as JaxGroupByResult
from partitionedhashjoin_tpu_torch import query as tq
from partitionedhashjoin_tpu_torch.data.table import JoinedTable, table_from_numpy
from partitionedhashjoin_tpu_torch.ops.aggregate import GroupByResult
from partitionedhashjoin_tpu_torch.ops.sort_merge import sort_merge_materialize_typed

# one torch thread per worker: the suite runs 6 workers on shared cores
torch.set_num_threads(1)

I32_MAX = np.iinfo(np.int32).max
N_A, N_B = 40, 400


def _relations(seed, unique_build=False, extremes=False):
    """(a_keys, a_pays, b_keys, b_pays) numpy int32, N_A ⋈ N_B rows."""
    rng = np.random.default_rng(seed)
    if unique_build:
        ak = rng.permutation(45)[:N_A]
    else:
        ak = rng.integers(0, 40, N_A)
    ap = rng.integers(1, 1000, N_A)
    bk = rng.integers(0, 50, N_B)
    bp = rng.integers(-500, 500, N_B)
    if extremes:
        ak[0] = I32_MAX
        bk[:6] = I32_MAX
    return tuple(np.asarray(x, np.int32) for x in (ak, ap, bk, bp))


def _tables(rel):
    ak, ap, bk, bp = rel
    jax_t = (jax_make_table(ak, ap), jax_make_table(bk, bp))
    port_t = (table_from_numpy(ak, ap, "cpu"), table_from_numpy(bk, bp, "cpu"))
    return jax_t, port_t


def _even(k, p):
    return p % 2 == 0


def _key_not_3(k, p):
    return k % 3 != 0


def _big_key(k, p):
    return k >= 10


#: name -> (relations, plan builder over a ``scan`` and the (a, b) tables,
#: terminal).  Predicates are written once and run on jnp and torch alike.
PLANS = {
    "scan": ("dup", lambda S, a, b: S(b), "execute"),
    "filter": ("dup", lambda S, a, b: S(b).filter(_even).filter(_big_key), "execute"),
    "filter_count": ("dup", lambda S, a, b: S(b).filter(_even), "count"),
    "topk_payload_desc": ("dup", lambda S, a, b: S(b).order_by("payload", True).limit(7),
                          "execute"),
    "topk_key_asc": ("dup", lambda S, a, b: S(b).order_by("key").limit(9), "execute"),
    "topk_masked": ("dup", lambda S, a, b: S(b).filter(_key_not_3)
                    .order_by("payload").limit(5), "execute"),
    "order_full": ("dup", lambda S, a, b: S(b).order_by("key", True), "execute"),
    "order_full_masked": ("dup", lambda S, a, b: S(b).filter(_even).order_by("payload"),
                          "execute"),
    "head_limit_masked": ("dup", lambda S, a, b: S(b).filter(_even).limit(4), "execute"),
    "head_limit": ("dup", lambda S, a, b: S(b).limit(6), "execute"),
    "group": ("dup", lambda S, a, b: S(b).group_by(with_distinct=True), "execute"),
    "group_filter_r5": ("dup", lambda S, a, b: S(b).filter(_even).group_by(), "execute"),
    "group_count_desc_top": ("dup", lambda S, a, b: S(b).group_by()
                             .order_by("count", True).limit(6), "execute"),
    "group_sum_asc": ("dup", lambda S, a, b: S(b).group_by().order_by("sum"), "execute"),
    "group_min_desc_top": ("dup", lambda S, a, b: S(b).group_by()
                           .order_by("min", True).limit(60), "execute"),
    "group_distinct_desc": ("dup", lambda S, a, b: S(b).group_by(True)
                            .order_by("distinct", True).limit(8), "execute"),
    "group_head": ("dup", lambda S, a, b: S(b).group_by().limit(3), "execute"),
    "having": ("dup", lambda S, a, b: S(b).group_by().having(lambda g: g.count > 8)
               .having(lambda g: g.max > 300).order_by("count", True).limit(4),
               "execute"),
    "having_head": ("dup", lambda S, a, b: S(b).group_by().having(lambda g: g.sum < 400),
                    "execute"),
    "group_count": ("dup", lambda S, a, b: S(b).group_by(), "count"),
    "group_limit_count": ("dup", lambda S, a, b: S(b).group_by().limit(3), "count"),
    "join_group_r3": ("dup", lambda S, a, b: S(b).join(S(a)).group_by(True), "execute"),
    "join_group_r3_build": ("uniq", lambda S, a, b: S(b).join(S(a), carry="build")
                            .group_by(), "execute"),
    "join_group_r7": ("dup", lambda S, a, b: S(b).filter(_even).join(S(a).filter(_big_key))
                      .group_by(), "execute"),
    "join_group_r7_build_only": ("uniq", lambda S, a, b: S(b).join(S(a).filter(_even),
                                 carry="build").group_by(), "execute"),
    "join_group_r7_fallback": ("extremes", lambda S, a, b: S(b).filter(_even).join(S(a))
                               .group_by(), "execute"),
    "join_group_typed_left": ("uniq", lambda S, a, b: S(b).join(S(a), "left", "build")
                              .group_by(), "execute"),
    "join_group_typed_semi": ("dup", lambda S, a, b: S(b).filter(_even).join(S(a), "semi")
                              .group_by(), "execute"),
    "join_group_top": ("dup", lambda S, a, b: S(b).join(S(a)).group_by()
                       .order_by("count", True).limit(10), "execute"),
    "join_then_filter_group": ("dup", lambda S, a, b: S(b).join(S(a)).filter(_even)
                               .group_by(), "execute"),
    "join_order_limit": ("uniq", lambda S, a, b: S(b).join(S(a), carry="build")
                         .order_by("payload", True).limit(5), "execute"),
    "join_head_limit": ("dup", lambda S, a, b: S(b).join(S(a)).limit(7), "execute"),
    "join_into_join": ("dup", lambda S, a, b: S(b).join(S(a)).filter(_even)
                       .join(S(a).filter(_big_key)), "count"),
    "join_as_build": ("dup", lambda S, a, b: S(b).join(S(b).join(S(a))), "count"),
    "join_table_order": ("dup", lambda S, a, b: S(b).join(S(a)).order_by("key"), "execute"),
    **{
        f"join_{jt}": ("dup", lambda S, a, b, jt=jt: S(b).filter(_key_not_3)
                       .join(S(a).filter(_even), jt), "execute")
        for jt in ("inner", "semi", "anti", "left", "full")
    },
    **{
        f"join_{jt}_count": ("dup", lambda S, a, b, jt=jt: S(b).filter(_key_not_3)
                             .join(S(a).filter(_even), jt), "count")
        for jt in ("inner", "semi", "anti", "left", "full")
    },
    "join_full_count_plain": ("dup", lambda S, a, b: S(b).join(S(a), "full"), "count"),
    "join_count_limit": ("dup", lambda S, a, b: S(b).join(S(a)).limit(50), "count"),
}

_REL = {"dup": 7, "uniq": 8, "extremes": 9}
_RELATIONS = {}
_JAX_RESULTS = {}


def _tables_for(kind):
    if kind not in _RELATIONS:
        rel = _relations(_REL[kind], unique_build=kind == "uniq",
                         extremes=kind == "extremes")
        _RELATIONS[kind] = _tables(rel)
    return _RELATIONS[kind]


def _run(pkg, name):
    kind, build, terminal = PLANS[name]
    (ja, jb), (ta, tb) = _tables_for(kind)
    q = build(jq.scan, ja, jb) if pkg == "jax" else build(tq.scan, ta, tb)
    return q.count() if terminal == "count" else q.execute()


def _jax(name):
    """JAX's result, computed once per module."""
    if name not in _JAX_RESULTS:
        _JAX_RESULTS[name] = _run("jax", name)
    return _JAX_RESULTS[name]


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _assert_groups_equal(got, want):
    n = int(want.num_groups)
    assert int(got.num_groups) == n
    for field in ("keys", "count", "sum", "min", "max"):
        np.testing.assert_array_equal(_np(getattr(got, field))[:n],
                                      _np(getattr(want, field))[:n], err_msg=field)
    assert (got.distinct is None) == (want.distinct is None)
    if want.distinct is not None:
        np.testing.assert_array_equal(_np(got.distinct)[:n], _np(want.distinct)[:n])
    np.testing.assert_allclose(_np(got.mean())[:n], _np(want.mean())[:n], rtol=1e-6)


def _assert_results_equal(got, want):
    if isinstance(want, int):
        assert isinstance(got, int) and got == want
    elif isinstance(want, JaxGroupByResult):
        assert isinstance(got, GroupByResult)
        _assert_groups_equal(got, want)
    elif isinstance(want, jq.TableResult):
        assert isinstance(got, tq.TableResult)
        n = int(want.count)
        assert int(got.count) == n
        np.testing.assert_array_equal(_np(got.table.keys)[:n], _np(want.table.keys)[:n])
        np.testing.assert_array_equal(_np(got.table.payloads)[:n],
                                      _np(want.table.payloads)[:n])
    else:  # a bare join's JoinedTable
        assert isinstance(got, JoinedTable)
        n = int(want.count)
        assert int(got.count) == n
        for field in ("keys", "payloads_a", "payloads_b", "matched"):
            np.testing.assert_array_equal(_np(getattr(got, field))[:n],
                                          _np(getattr(want, field))[:n], err_msg=field)


#: The plans whose results are held to JAX's: the planner's paths that
#: tests/test_torch_sql.py's statements do not already take (JAX compiles a
#: program per operator and shape, ~1 s a plan on the CPU); EXPLAIN holds
#: every plan.
EXECUTED = (
    "filter", "topk_payload_desc", "group_filter_r5", "having",
    "join_group_r3", "join_group_r7_fallback", "join_inner", "join_into_join",
)


@pytest.mark.parametrize("name", EXECUTED)
def test_plan_result_matches_jax(name):
    _assert_results_equal(_run("port", name), _jax(name))


def _rule_lines(text):
    """Per operator line, the rule tags it carries, in order."""
    lines = text.splitlines()
    return [tuple(re.findall(r"\bR[1-7]\b", line)) for line in lines]


@pytest.mark.parametrize("name", sorted(PLANS))
def test_explain_rule_tags_match_jax(name):
    kind, build, _ = PLANS[name]
    (ja, jb), (ta, tb) = _tables_for(kind)
    want = build(jq.scan, ja, jb).explain(interpret=True)
    got = build(tq.scan, ta, tb).explain()
    assert got.splitlines()[0] == "physical plan [single device]"
    assert _rule_lines(got) == _rule_lines(want), (got, want)


def test_explain_shows_the_rewrites_and_runs_nothing():
    (_, _), (ta, tb) = _tables_for("dup")
    boom = lambda k, p: (_ for _ in ()).throw(RuntimeError("no"))  # noqa: E731
    text = tq.scan(tb).filter(boom).join(tq.scan(ta)).group_by().explain()
    assert "R7" in text and "K5" in text and "K4" in text
    assert "R3" in tq.scan(tb).join(tq.scan(ta)).group_by().explain()
    assert "R5" in tq.scan(tb).filter(boom).group_by().explain()


@pytest.mark.parametrize("with_distinct", [False, True])
@pytest.mark.parametrize("filtered", [False, True])
def test_scalar_aggregate_matches_jax(with_distinct, filtered):
    (ja, jb), (ta, tb) = _tables_for("dup")

    def plan(S, a, b):
        q = S(b).join(S(a), "left", "build")
        return q.filter(_even) if filtered else q

    want = plan(jq.scan, ja, jb).aggregate(with_distinct=with_distinct)
    got = plan(tq.scan, ta, tb).aggregate(with_distinct=with_distinct)
    for field in ("count", "sum", "min", "max", "distinct"):
        w, g = getattr(want, field), getattr(got, field)
        assert (g is None) == (w is None)
        if w is not None:
            assert _np(g).dtype == _np(w).dtype and int(g) == int(w), field
    np.testing.assert_allclose(_np(got.mean()), _np(want.mean()), rtol=1e-6)


def test_scalar_aggregate_of_no_rows():
    (_, _), (_, tb) = _tables_for("dup")
    r = tq.scan(tb).filter(lambda k, p: k < -1).aggregate(with_distinct=True)
    assert [int(x) for x in (r.count, r.sum, r.min, r.max, r.distinct)] == [0] * 5
    assert float(r.mean()) == 0.0


def _group_pair(keys, count, num_groups):
    cols = dict(keys=keys, count=count, sum=[3 * c for c in count],
                min=[-c for c in count], max=[c * c for c in count])
    jax_g = JaxGroupByResult(
        **{k: np.asarray(v, np.int32) for k, v in cols.items()},
        num_groups=np.int32(num_groups), group_of_row=np.zeros(0, np.int32))
    port_g = GroupByResult(
        **{k: torch.tensor(v, dtype=torch.int32) for k, v in cols.items()},
        num_groups=torch.tensor(num_groups, dtype=torch.int32),
        group_of_row=torch.zeros(0, dtype=torch.int32))
    return jax_g, port_g


@pytest.mark.parametrize("by,descending", [
    ("count", True), ("count", False), ("sum", True), ("min", False), ("key", True),
])
@pytest.mark.parametrize("k", [1, 4, 9, 12])
def test_group_top_k_ties_and_truncation_match_jax(by, descending, k):
    """Ties broken by the lower row, as ``lax.top_k`` and JAX's 3-key sort
    break them; rows past ``num_groups`` (here a huge count) never picked."""
    jax_g, port_g = _group_pair(
        keys=[5, 9, 2, 7, 1, 3, 8, 4, 6, 11, 12], count=[2, 3, 3, 1, 3, 2, 1, 3, 2, 999, 999],
        num_groups=9)
    mask = [True, True, False, True, True, True, True, True, True, True, True]
    for m in (None, mask):
        want = jq.group_top_k(jax_g, k, by=by, descending=descending,
                              mask=None if m is None else np.asarray(m))
        got = tq.group_top_k(port_g, k, by=by, descending=descending,
                             mask=None if m is None else torch.tensor(m))
        n = int(want.num_groups)
        assert int(got.num_groups) == n
        for field in ("keys", "count", "sum", "min", "max"):
            np.testing.assert_array_equal(_np(getattr(got, field)),
                                          _np(getattr(want, field)), err_msg=field)


def test_top_k_indices_order_is_a_stable_descending_sort():
    gen = torch.Generator().manual_seed(3)
    for n, hi in ((1, 1), (50, 3), (400, 20), (1000, 2)):
        x = torch.randint(-hi, hi, (n,), generator=gen, dtype=torch.int32)
        x[:2] = torch.iinfo(torch.int32).min
        for k in (1, min(5, n), n):
            want = torch.sort(x, descending=True, stable=True).indices[:k]
            assert torch.equal(tq._top_k_indices(x, k), want)
    assert tq._top_k_indices(x, 0).numel() == 0


def test_plan_errors_and_mesh_not_yet_ported():
    """Bad plans raise ``PlanError``.  The mesh (R6) is ported: a bare scan
    on a mesh of 8 CPU shards runs no distributed operator (as in JAX) and
    gives the single-device results under EXPLAIN's mesh header, and a mesh
    that is not a ``parallel.mesh.Mesh`` raises ``PlanError``."""
    from partitionedhashjoin_tpu_torch.parallel.mesh import make_mesh

    (_, _), (ta, tb) = _tables_for("dup")
    q = tq.scan(tb)
    for bad in (lambda: tq.scan("nope"), lambda: q.join("nope"),
                lambda: q.join(q, join_type="cross"), lambda: q.join(q, carry="both"),
                lambda: q.limit(0), lambda: q.order_by("count"),
                lambda: q.group_by().order_by("count").group_by(),
                lambda: q.having(lambda g: g.count > 1),
                lambda: q.order_by("key").aggregate()):
        with pytest.raises(tq.PlanError):
            bad()
    mesh = make_mesh(8, devices=["cpu"])
    got, want = q.execute(mesh=mesh), q.execute()
    assert torch.equal(got.table.keys, want.table.keys) and int(got.count) == int(want.count)
    assert q.count(mesh=mesh) == q.count() == N_B
    assert int(q.aggregate(mesh=mesh).sum) == int(q.aggregate().sum)
    lines = q.explain(mesh=mesh).splitlines()
    assert lines[0] == "physical plan [mesh S=8]" and lines[1:] == q.explain().splitlines()[1:]
    for run in (q.execute, q.count, q.aggregate, q.explain):
        with pytest.raises(tq.PlanError, match="parallel.mesh.Mesh"):
            run(mesh=object())


def test_bare_join_returns_joined_table_with_port_counts():
    (_, _), (ta, tb) = _tables_for("dup")
    out = tq.scan(tb).join(tq.scan(ta), "left").execute()
    keys, pa, pb, matched, count = sort_merge_materialize_typed(
        ta.keys, ta.payloads, tb.keys, tb.payloads, "left")
    assert isinstance(out, JoinedTable) and out.count.dtype == torch.int64
    assert int(out.count) == int(count) == N_B
    assert torch.equal(out.payloads_a, pa) and torch.equal(out.matched, matched)
