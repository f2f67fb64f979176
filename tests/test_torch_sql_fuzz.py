"""SQL fuzz of the port: random statements against a numpy interpreter.

The statement grid of ``tests/test_sql_fuzz.py`` (join type × side filters
× group_by × order/limit × carry side, plus two-join chains), run through
``partitionedhashjoin_tpu_torch.sql.execute_sql`` on the CPU and checked
against a copy of that file's numpy oracle, which interprets the same
statement with the engine's documented semantics (inner join = first-match,
build keys unique in the generator; int32 wraparound sums).  The port's grid
adds zero divisors to the predicates (``x // 0``, ``x % 0``, a column minus
itself as divisor), whose values the oracle computes as JAX does on the CPU.
A handful of seeds also run through the JAX package's ``execute_sql`` and
must give the same result, column for column.
"""

import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu import sql as jsql
from partitionedhashjoin_tpu.data.table import make_table as jax_make_table
from partitionedhashjoin_tpu_torch.data.table import table_from_numpy
from partitionedhashjoin_tpu_torch.sql import execute_sql

# one torch thread per worker: the suite runs 6 workers on shared cores
torch.set_num_threads(1)

N_CASES = 80


def _make(keys, pays):
    return table_from_numpy(keys, pays, "cpu")


def _columns(rng, n_a=None, n_b=None):
    n_a = int(rng.integers(3, 40)) if n_a is None else n_a
    n_b = int(rng.integers(5, 200)) if n_b is None else n_b
    a_keys = rng.permutation(60)[:n_a].astype(np.int32)  # unique
    a_pays = rng.integers(-50, 50, n_a).astype(np.int32)
    b_keys = rng.integers(0, 70, n_b).astype(np.int32)
    b_pays = rng.integers(-50, 50, n_b).astype(np.int32)
    return a_keys, a_pays, b_keys, b_pays


def _tables(rng):
    cols = _columns(rng)
    a_keys, a_pays, b_keys, b_pays = cols
    return {"a": _make(a_keys, a_pays), "b": _make(b_keys, b_pays)}, cols


def _np_div(x, d, op):
    """``x // d`` or ``x % d`` with JAX's CPU results for a zero divisor:
    x // 0 = -2 (x != 0), 0 // 0 = -1, x % 0 = 0."""
    x = np.asarray(x, np.int64)
    d = np.broadcast_to(np.asarray(d, np.int64), x.shape)
    safe = np.where(d == 0, 1, d)
    if op == "%":
        return np.where(d == 0, 0, x % safe)
    return np.where(d == 0, np.where(x == 0, -1, -2), x // safe)


def _rand_pred(rng, alias):
    """(sql_text, numpy_fn(keys, pays) -> mask)"""
    col = rng.choice(["key", "payload"])
    q = f"{alias}.{col}" if alias else col
    kind = rng.integers(0, 7)
    if kind == 0:
        m = int(rng.integers(2, 5))
        r = int(rng.integers(0, m))
        return (
            f"{q} % {m} = {r}",
            lambda k, p: (k if col == "key" else p) % m == r,
        )
    if kind == 1:
        t = int(rng.integers(-30, 30))
        return (
            f"{q} >= {t}",
            lambda k, p: (k if col == "key" else p) >= t,
        )
    if kind == 2:
        vals = sorted(rng.integers(0, 40, 3).tolist())
        txt = ", ".join(str(v) for v in vals)
        return (
            f"{q} IN ({txt})",
            lambda k, p: np.isin(k if col == "key" else p, vals),
        )
    if kind == 3:
        t = int(rng.integers(-20, 20))
        return (
            f"NOT {q} < {t}",
            lambda k, p: ~((k if col == "key" else p) < t),
        )
    if kind in (5, 6):
        # zero divisors: a literal 0 or a column minus itself, beside
        # nonzero divisors of either sign
        op = "//" if kind == 5 else "%"
        other = "payload" if col == "key" else "key"
        oq = f"{alias}.{other}" if alias else other
        d = int(rng.choice([0, 0, 3, -4]))
        by_col = bool(rng.integers(0, 2)) and d == 0
        d_txt = f"({oq} - {oq})" if by_col else str(d)
        r = int(rng.integers(-2, 2))
        return (
            f"{q} {op} {d_txt} = {r}",
            lambda k, p: _np_div(k if col == "key" else p, d, op) == r,
        )
    lo = int(rng.integers(-30, 20))
    hi = lo + int(rng.integers(0, 30))
    return (
        f"{q} BETWEEN {lo} AND {hi}",
        lambda k, p: ((k if col == "key" else p) >= lo)
        & ((k if col == "key" else p) <= hi),
    )


def _oracle_rows(case, cols):
    """(key, carried payload) rows after FROM/JOIN/WHERE, engine
    semantics: probe rows kept per join type, first-match build payload."""
    a_keys, a_pays, b_keys, b_pays = cols
    bmask = (
        case["pred_a"][1](a_keys, a_pays)
        if case["pred_a"] else np.ones(len(a_keys), bool)
    )
    pmask = (
        case["pred_b"][1](b_keys, b_pays)
        if case["pred_b"] else np.ones(len(b_keys), bool)
    )
    if not case["join"]:
        return [
            (int(k), int(p))
            for k, p in zip(b_keys[pmask], b_pays[pmask])
        ]
    amap = {int(k): int(p) for k, p in zip(a_keys[bmask], a_pays[bmask])}
    jt = case["join"]
    rows = []
    for k, p in zip(b_keys[pmask], b_pays[pmask]):
        k = int(k)
        hit = k in amap
        if jt in ("inner", "semi") and hit:
            rows.append((k, amap[k] if case["carry"] == "build" else int(p)))
        elif jt == "anti" and not hit:
            rows.append((k, 0 if case["carry"] == "build" else int(p)))
        elif jt == "left":
            if case["carry"] == "build":
                rows.append((k, amap[k] if hit else 0))
            else:
                rows.append((k, int(p)))
    return rows


def _oracle_groups(rows):
    out = {}
    for k, p in rows:
        c, s, mn, mx = out.get(k, (0, 0, None, None))
        out[k] = (
            c + 1,
            int(np.int32(np.int64(s) + p)),
            p if mn is None else min(mn, p),
            p if mx is None else max(mx, p),
        )
    return out


def _rand_having(rng):
    """(sql_text, keep(count, sum, mn, mx) -> bool) over group columns."""
    col = int(rng.integers(0, 4))  # count, sum, min, max
    name = ["count", "sum", "min", "max"][col]
    spell = rng.integers(0, 2)  # column name vs aggregate-call spelling
    q = name if spell == 0 else {
        "count": "COUNT(*)", "sum": "SUM(payload)",
        "min": "MIN(payload)", "max": "MAX(payload)",
    }[name]
    if name == "count":
        t = int(rng.integers(1, 6))
    else:
        t = int(rng.integers(-60, 60))
    if rng.integers(0, 2):
        return f"{q} > {t}", lambda row, c=col, t=t: row[c] > t
    return f"{q} <= {t}", lambda row, c=col, t=t: row[c] <= t


def _gen_case(rng):
    case = {
        "mode": rng.choice(
            ["rows", "group", "group", "scalar", "distinct"]
        ),
        "join": rng.choice([None, "inner", "semi", "anti", "left"]),
        "pred_a": None,
        "pred_b": None,
        "carry": "probe",
        "having": None,
        "order": None,
        "limit": None,
    }
    case["group"] = case["mode"] == "group"
    qualify = case["join"] is not None
    if rng.integers(0, 2):
        case["pred_b"] = _rand_pred(rng, "b" if qualify else None)
    if qualify and rng.integers(0, 2):
        case["pred_a"] = _rand_pred(rng, "a")
    if (
        case["mode"] in ("group", "scalar")
        and case["join"] in ("inner", "semi", "left")
        and rng.integers(0, 2)
    ):
        case["carry"] = "build"
    if case["mode"] == "group":
        if rng.integers(0, 2):
            case["having"] = _rand_having(rng)
        case["order"] = rng.choice(["key", "count", "sum"])
        if rng.integers(0, 2):
            case["limit"] = int(rng.integers(1, 6))
    elif case["mode"] == "distinct":
        case["order"] = "key"
        if rng.integers(0, 2):
            case["limit"] = int(rng.integers(1, 8))
    elif case["mode"] == "rows" and case["join"] is None and rng.integers(0, 2):
        # join row cases compare via COUNT(*), which takes no ORDER BY
        case["order"] = "key"
    return case


def _to_sql(case):
    pay = "a.payload" if case["carry"] == "build" else (
        "b.payload" if case["join"] else "payload"
    )
    parts = []
    if case["mode"] == "group":
        parts.append(
            f"SELECT key, COUNT(*), SUM({pay}), MIN({pay}), MAX({pay})"
        )
    elif case["mode"] == "scalar":
        parts.append(
            f"SELECT COUNT(*), SUM({pay}), MIN({pay}), MAX({pay}), "
            f"COUNT(DISTINCT {pay})"
        )
    elif case["mode"] == "distinct":
        parts.append("SELECT DISTINCT key")
    elif case["join"]:
        parts.append("SELECT COUNT(*)")  # rows compared via count + groups
    else:
        parts.append("SELECT key, payload")
    parts.append("FROM b")
    if case["join"]:
        jt = {"inner": ""}.get(case["join"], case["join"].upper() + " ")
        parts.append(f"{jt}JOIN a USING (key)")
    conds = [c[0] for c in (case["pred_b"], case["pred_a"]) if c]
    if conds:
        parts.append("WHERE " + " AND ".join(conds))
    if case["mode"] == "group":
        parts.append("GROUP BY key")
        if case["having"] is not None:
            parts.append(f"HAVING {case['having'][0]}")
    if case["order"]:
        parts.append(f"ORDER BY {case['order']} ASC")
    if case["limit"] is not None:
        parts.append(f"LIMIT {case['limit']}")
    return " ".join(parts)


@pytest.mark.parametrize("seed", range(15))
def test_fuzz_join_chain(seed):
    """Left-deep two-join chains: a join OUTPUT feeds the next join under
    random filters and second-join types."""
    rng = np.random.default_rng(5000 + seed)
    db, (a_keys, a_pays, b_keys, b_pays) = _tables(rng)
    c_keys = rng.permutation(60)[: int(rng.integers(2, 30))].astype(
        np.int32
    )
    db["c"] = _make(c_keys, c_keys * 7)
    jt2 = rng.choice(["inner", "semi", "anti", "left"])
    pred_b = _rand_pred(rng, "b") if rng.integers(0, 2) else None
    # oracle: join1 (inner, first-match) keeps probe rows with key in a
    bmask = (
        pred_b[1](b_keys, b_pays)
        if pred_b else np.ones(len(b_keys), bool)
    )
    mid = [
        (int(k), int(p))
        for k, p in zip(b_keys[bmask], b_pays[bmask])
        if int(k) in set(a_keys.tolist())
    ]
    cset = set(c_keys.tolist())
    if jt2 in ("inner", "semi"):
        want = sum(1 for k, _ in mid if k in cset)
    elif jt2 == "anti":
        want = sum(1 for k, _ in mid if k not in cset)
    else:  # left
        want = len(mid)
    jt_txt = {"inner": ""}.get(jt2, jt2.upper() + " ")
    where = f" WHERE {pred_b[0]}" if pred_b else ""
    sql = (
        f"SELECT COUNT(*) FROM b JOIN a USING (key) "
        f"{jt_txt}JOIN c USING (key){where}"
    )
    r = execute_sql(sql, db)
    assert r.columns["count"][0] == want, sql
    # and the grouped form over the chain (inner only: grouped rows)
    if jt2 == "inner":
        gsql = (
            f"SELECT key, COUNT(*) FROM b JOIN a USING (key) "
            f"JOIN c USING (key){where} GROUP BY key ORDER BY key"
        )
        g = execute_sql(gsql, db)
        counts = {}
        for k, _ in mid:
            if k in cset:
                counts[k] = counts.get(k, 0) + 1
        got = dict(zip(
            g.columns["key"].tolist(), g.columns["count"].tolist()
        ))
        assert got == counts, gsql


def _check_against_oracle(case, sql, rows, r):
    if case["mode"] == "scalar":
        pays = [p for _, p in rows]
        assert r.row_count == 1
        assert r.columns["count"][0] == len(pays)
        assert r.columns["sum"][0] == np.int32(
            np.sum(pays, dtype=np.int64)
        ), sql
        assert r.columns["min"][0] == (min(pays) if pays else 0), sql
        assert r.columns["max"][0] == (max(pays) if pays else 0), sql
        assert r.columns["distinct"][0] == len(set(pays)), sql
        return
    if case["mode"] == "distinct":
        want_keys = sorted({k for k, _ in rows})
        if case["limit"] is not None:
            want_keys = want_keys[: case["limit"]]
        assert r.columns["key"].tolist() == want_keys, sql
        return

    if case["group"]:
        want = _oracle_groups(rows)
        if case["having"] is not None:
            keep = case["having"][1]
            want = {k: v for k, v in want.items() if keep(v)}
        # groups come ordered by case["order"] ascending with a
        # deterministic tiebreak; compare as dict (+ the ordered column)
        got = {}
        for i in range(r.row_count):
            got[int(r.columns["key"][i])] = (
                int(r.columns["count"][i]),
                int(r.columns["sum"][i]),
                int(r.columns["min"][i]),
                int(r.columns["max"][i]),
            )
        if case["limit"] is None:
            assert got == want, sql
        else:
            # the limited prefix must be the k smallest by the order col
            assert len(got) == min(case["limit"], len(want)), sql
            colidx = {"key": None, "count": 0, "sum": 1}[case["order"]]
            if colidx is None:
                want_order = sorted(want)[: case["limit"]]
                assert sorted(got) == want_order, sql
            else:
                ordered = sorted(v[colidx] for v in want.values())
                got_col = sorted(v[colidx] for v in got.values())
                assert got_col == ordered[: case["limit"]], sql
            for k, v in got.items():
                assert want[k] == v, sql
    elif case["join"]:
        assert r.columns["count"][0] == len(rows), sql
    else:
        got = sorted(zip(
            r.columns["key"].tolist(), r.columns["payload"].tolist()
        ))
        if case["order"]:
            # key-ascending prefix; values must match as multisets and
            # the key column must be sorted
            keys_seq = r.columns["key"].tolist()
            assert keys_seq == sorted(keys_seq), sql
        assert got == sorted(rows), sql


@pytest.mark.parametrize("seed", range(N_CASES))
def test_fuzz_statement(seed):
    rng = np.random.default_rng(1000 + seed)
    db, cols = _tables(rng)
    case = _gen_case(rng)
    sql = _to_sql(case)
    _check_against_oracle(case, sql, _oracle_rows(case, cols), execute_sql(sql, db))


def test_grid_reaches_zero_divisors():
    """The grid's predicates divide by zero, literally and by a column."""
    texts = []
    for seed in range(N_CASES):
        rng = np.random.default_rng(1000 + seed)
        _tables(rng)
        texts.append(_to_sql(_gen_case(rng)))
    assert sum("// 0 " in t or "% 0 " in t for t in texts) >= 3
    assert any(" - " in t for t in texts)


#: Seeds whose statement also runs through the JAX package.  Their tables
#: have one shape (40 build rows, 400 probe rows), so JAX compiles once.
JAX_SEEDS = (16, 59, 60)


@pytest.mark.parametrize("seed", JAX_SEEDS)
def test_fuzz_statement_matches_jax(seed):
    rng = np.random.default_rng(1000 + seed)
    cols = _columns(rng, n_a=40, n_b=400)
    case = _gen_case(rng)
    sql = _to_sql(case)
    a_keys, a_pays, b_keys, b_pays = cols
    got = execute_sql(sql, {"a": _make(a_keys, a_pays), "b": _make(b_keys, b_pays)})
    want = jsql.execute_sql(sql, {"a": jax_make_table(a_keys, a_pays),
                                  "b": jax_make_table(b_keys, b_pays)})
    assert got.row_count == want.row_count, sql
    assert list(got.columns) == list(want.columns), sql
    for name, w in want.columns.items():
        assert got.columns[name].dtype == w.dtype, (sql, name)
        np.testing.assert_array_equal(got.columns[name], w, err_msg=sql)
    _check_against_oracle(case, sql, _oracle_rows(case, cols), got)
