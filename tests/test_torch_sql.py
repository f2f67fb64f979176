"""The port's SQL front end against the JAX package's, on the CPU.

Each statement runs through ``partitionedhashjoin_tpu.sql.execute_sql`` and
``partitionedhashjoin_tpu_torch.sql.execute_sql`` over the same numpy
relations; the results must be equal column for column (names, dtypes,
values; AVG to 1e-6 relative), EXPLAIN must carry the same rule tags on the
same number of lines (JAX's ``interpret=True`` plan, which executes
nothing), and bad statements must raise ``SqlError`` with the same message.
JAX runs without ``interpret`` (no Pallas program compiles), each statement
once per module, on relations of one shape.
"""

import re

import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu import sql as jsql
from partitionedhashjoin_tpu.data.table import make_table as jax_make_table
from partitionedhashjoin_tpu_torch import sql as tsql
from partitionedhashjoin_tpu_torch.data.table import table_from_numpy

# one torch thread per worker: the suite runs 6 workers on shared cores
torch.set_num_threads(1)

I32_MIN, I32_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


def _relations():
    rng = np.random.default_rng(2026)
    a_keys = rng.permutation(40).astype(np.int32)  # unique build keys
    b_keys = rng.integers(0, 50, 400).astype(np.int32)
    b_pays = rng.integers(-100, 100, 400).astype(np.int32)
    b_pays[::37] = 0  # zero divisors
    return {"a": (a_keys, a_keys * 10), "b": (b_keys, b_pays)}


RELATIONS = _relations()
JAX_DB = {n: jax_make_table(k, p) for n, (k, p) in RELATIONS.items()}
PORT_DB = {n: table_from_numpy(k, p, "cpu") for n, (k, p) in RELATIONS.items()}

PIPELINE = ("SELECT key, COUNT(*), SUM(b.payload), MIN(b.payload), MAX(b.payload) "
            "FROM b JOIN a USING (key) GROUP BY key ORDER BY count DESC LIMIT 10")

#: name -> statement, executed by both packages and compared.
STATEMENTS = {
    "pipeline": PIPELINE,
    "pipeline_filtered_r7": PIPELINE.replace("GROUP BY", "WHERE b.payload % 2 = 0 GROUP BY"),
    "inner_carry_build_between": (
        "SELECT key, SUM(a.payload), COUNT(DISTINCT a.payload), AVG(a.payload) "
        "FROM b JOIN a USING (key) WHERE b.payload BETWEEN -50 AND 60 "
        "GROUP BY key ORDER BY key"),
    "left_carry_build_having": (
        "SELECT key, COUNT(*), SUM(a.payload) FROM b LEFT JOIN a USING (key) "
        "GROUP BY key HAVING count > 8 ORDER BY sum DESC LIMIT 6"),
    "semi_in_rows": (
        "SELECT key, b.payload FROM b SEMI JOIN a USING (key) "
        "WHERE b.key IN (1, 3, 5, 7, 44) ORDER BY payload DESC LIMIT 8"),
    "anti_rows": ("SELECT * FROM b ANTI JOIN a USING (key) "
                  "WHERE b.payload NOT BETWEEN -20 AND 20"),
    "anti_count_masked": "SELECT COUNT(*) FROM b ANTI JOIN a USING (key) WHERE a.key % 2 = 0",
    "scalar_left_build": (
        "SELECT COUNT(*), SUM(a.payload), MIN(a.payload), MAX(a.payload), "
        "AVG(a.payload), COUNT(DISTINCT a.payload) FROM b LEFT JOIN a USING (key)"),
    "distinct_not_in": ("SELECT DISTINCT key FROM b WHERE key NOT IN (2, 4, 6) "
                        "ORDER BY key DESC LIMIT 7"),
    "group_having_calls": (
        "SELECT key, AVG(payload), COUNT(DISTINCT payload), MIN(payload) FROM b "
        "GROUP BY key HAVING COUNT(*) > 7 AND NOT avg < -10 ORDER BY distinct DESC"),
    # the three behaviours the port reproduces from the JAX module
    "quirk_full_build_where_below_join": (
        "SELECT * FROM b FULL JOIN a USING (key) WHERE a.key % 4 = 1"),
    "quirk_duplicate_names": "SELECT key, payload, key FROM b LIMIT 5",
    "quirk_limit_zero": "SELECT key, AVG(payload) FROM b GROUP BY key LIMIT 0",
    # division and modulo by zero
    "zero_div_rows": ("SELECT key, payload FROM b WHERE payload // 0 = -1 OR "
                      "key % 0 <> 0 OR key / (payload - payload) = -2 ORDER BY key"),
    "zero_div_having": (
        "SELECT key, COUNT(*), SUM(payload) FROM b GROUP BY key "
        "HAVING sum // 0 = -1 OR count % 0 = 0 AND NOT avg / 0 = avg ORDER BY key"),
}

#: Statements planned (EXPLAIN) beside every statement above; each costs
#: JAX nothing to compile.
EXPLAINED = {
    "int32_min_div": ("SELECT COUNT(*) FROM b WHERE (0 - 2147483647 - 1) // -1 + key = "
                      "key - 2147483647 - 1 AND (0 - 2147483647 - 1) % -1 = 0"),
    "full_count": "SELECT COUNT(*) FROM b FULL JOIN a USING (key) WHERE b.payload > 0",
    "inner_count": "SELECT COUNT(*) FROM b JOIN a USING (key) WHERE a.payload >= 100",
    "rows_arith": ("SELECT key, payload FROM b WHERE (key + payload) * 2 > 50 "
                   "AND NOT payload < -80 ORDER BY key LIMIT 12"),
    "quirk_left_build_where_below_join": (
        "SELECT * FROM b LEFT JOIN a USING (key) WHERE a.payload > 200"),
    "zero_div_count": "SELECT COUNT(*) FROM b WHERE payload / 0 = -2 AND payload % 0 = 0",
    "scan_count": "SELECT COUNT(*) FROM b WHERE key < 10",
    "count_limit": "SELECT COUNT(*) FROM b LIMIT 2",
    "filter_group_r5": "SELECT key, COUNT(*) FROM b WHERE payload > 0 GROUP BY key",
    "join_rows": "SELECT * FROM b JOIN a USING (key) WHERE b.payload % 2 = 0",
    "join_tail": "SELECT key, a.payload FROM b JOIN a USING (key) ORDER BY key LIMIT 3",
    "join_chain": ("SELECT key, COUNT(*) FROM b JOIN a USING (key) SEMI JOIN a AS c "
                   "USING (key) GROUP BY key ORDER BY key"),
    "scalar_filtered": "SELECT SUM(payload), MIN(payload) FROM b WHERE payload % 3 = 0",
    "group_head": "SELECT key FROM b GROUP BY key LIMIT 3",
    "having_only": "SELECT key FROM b GROUP BY key HAVING count > 10",
    "distinct_join": "SELECT DISTINCT key FROM b JOIN a USING (key) ORDER BY key",
    "order_rows": "SELECT * FROM b ORDER BY payload DESC LIMIT 3",
    "head_rows": "SELECT key FROM b WHERE key > 3 LIMIT 5",
}

_JAX_RESULTS = {}


def _jax(name):
    """JAX's result, computed once per module."""
    if name not in _JAX_RESULTS:
        _JAX_RESULTS[name] = jsql.execute_sql(STATEMENTS[name], JAX_DB)
    return _JAX_RESULTS[name]


def _assert_sql_equal(got, want):
    assert got.row_count == want.row_count
    assert list(got.columns) == list(want.columns)
    for name, w in want.columns.items():
        g = got.columns[name]
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype, (name, g.dtype, w.dtype)
        if name == "avg":
            np.testing.assert_allclose(g, w, rtol=1e-6)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_statement_matches_jax(name):
    _assert_sql_equal(tsql.execute_sql(STATEMENTS[name], PORT_DB), _jax(name))


def _rule_lines(lines):
    return [tuple(re.findall(r"\bR[1-7]\b", line)) for line in lines]


@pytest.mark.parametrize("name", sorted({**STATEMENTS, **EXPLAINED}))
def test_explain_rule_tags_match_jax(name):
    """EXPLAIN SELECT returns the plan as rows (a bare COUNT(*): the R1
    count plan); the port's ``explain_sql`` shows that same plan, where the
    JAX module's shows the statement's row plan."""
    sql = {**STATEMENTS, **EXPLAINED}[name]
    want = list(jsql.execute_sql("EXPLAIN " + sql, JAX_DB, interpret=True).columns["plan"])
    rows = tsql.execute_sql("EXPLAIN " + sql, PORT_DB)
    assert rows.row_count == len(want)
    assert _rule_lines(rows.columns["plan"]) == _rule_lines(want), (rows, want)
    assert tsql.explain_sql(sql, PORT_DB).splitlines() == list(rows.columns["plan"])


def test_pipeline_lowers_to_r3_and_r4():
    text = tsql.explain_sql(PIPELINE, PORT_DB)
    assert "R3" in text and "R4" in text and "K4" in text
    filtered = STATEMENTS["pipeline_filtered_r7"]
    assert "R7" in tsql.explain_sql(filtered, PORT_DB)
    count = tsql.execute_sql("EXPLAIN SELECT COUNT(*) FROM b JOIN a USING (key)", PORT_DB)
    assert any("R1" in line for line in count.columns["plan"])


def test_quirks_pinned():
    """The three behaviours of the JAX module that the port keeps."""
    n_b = RELATIONS["b"][0].shape[0]
    # a WHERE on the build side of LEFT/FULL filters that side before the
    # join: every probe row stays
    for sql in (EXPLAINED["quirk_left_build_where_below_join"],
                STATEMENTS["quirk_full_build_where_below_join"]):
        assert tsql.execute_sql(sql, PORT_DB).row_count >= n_b
    # a name selected twice is one column
    r = tsql.execute_sql(STATEMENTS["quirk_duplicate_names"], PORT_DB)
    assert list(r.columns) == ["key", "payload"]
    r = tsql.execute_sql("SELECT key, SUM(payload), SUM(payload) FROM b GROUP BY key", PORT_DB)
    assert list(r.columns) == ["key", "sum"]
    # LIMIT 0 columns are int32 (avg float32) even over int64 relations
    wide = {n: table_from_numpy(k.astype(np.int64), p.astype(np.int64), "cpu")
            for n, (k, p) in RELATIONS.items()}
    for sql, names in (("SELECT key, payload FROM b LIMIT 0", ["key", "payload"]),
                       ("SELECT key, AVG(payload) FROM b GROUP BY key LIMIT 0",
                        ["key", "avg"])):
        got = tsql.execute_sql(sql, wide)
        want = jsql._empty_result(names)
        assert got.row_count == 0
        assert {n: c.dtype for n, c in got.columns.items()} == {
            n: c.dtype for n, c in want.columns.items()}
    # ... while a non-empty page keeps the relation's width
    assert tsql.execute_sql("SELECT key FROM b LIMIT 1", wide).columns["key"].dtype == np.int64


EXPRESSIONS = (
    "key // payload", "key % payload", "-key / payload", "key // 0", "key % 0",
    "key // -1", "key % -1", "(key * payload) / (key - payload)",
)


def _expr_inputs():
    k = np.array([I32_MIN, I32_MIN, I32_MIN, I32_MAX, 0, 0, 7, -7, 7, -7, 5, -1, 1,
                  I32_MAX, 3], np.int32)
    p = np.array([-1, 0, 1, -1, 0, 3, 0, 0, -2, 2, 5, -1, I32_MIN, 0, -3], np.int32)
    return k, p


@pytest.mark.parametrize("text", EXPRESSIONS)
def test_expression_arithmetic_matches_jax(text):
    """Zero divisors, INT32_MIN // -1 and wrapping arithmetic: the port's
    WHERE lowering gives JAX's CPU answers bit for bit (and raises
    nothing)."""
    import jax.numpy as jnp

    sql = f"SELECT key FROM b WHERE {text} = 0"
    k, p = _expr_inputs()
    fn = jsql._compile_expr(jsql.parse_sql(sql).where.left)
    want = np.asarray(fn(jnp.asarray(k), jnp.asarray(p)))
    fn = tsql._compile_expr(tsql.parse_sql(sql).where.left)
    got = fn(torch.from_numpy(k), torch.from_numpy(p))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_division_by_zero_is_defined_for_int64_and_floats():
    div = tsql._div
    i64 = torch.tensor([torch.iinfo(torch.int64).min, 5, 0, -9], dtype=torch.int64)
    assert div(i64, torch.tensor([-1, 0, 0, 2]), "//").tolist() == [
        torch.iinfo(torch.int64).min, -2, -1, -5]
    assert div(i64, torch.tensor([-1, 0, 0, 2]), "%").tolist() == [0, 0, 0, 1]
    f = torch.tensor([1.5, -1.5, 0.0, 7.0])
    assert div(f, torch.tensor(0.0), "//").isnan().all()
    assert div(f, torch.tensor(0.0), "%").isnan().all()
    assert div(f, torch.tensor(2), "//").tolist() == [0.0, -1.0, 0.0, 3.0]


BAD = [
    "SELECT",
    "SELECT * FROM",
    "SELECT * FROM b JOIN a USING (payload)",
    "SELECT * FROM b GROUP BY payload",
    "SELECT * FROM b LIMIT x",
    "SELECT * FROM b WHERE value > 1",
    "SELECT nope FROM b",
    "SELECT * FROM b extra junk",
    "SELECT COUNT(payload) FROM b",
    "SELECT * FROM b WHERE key $ 2",
    "SELECT * FROM zz",
    "SELECT * FROM b JOIN b USING (key)",
    "SELECT COUNT(*) FROM b JOIN a USING (key) WHERE payload > 0",
    "SELECT COUNT(*) FROM b JOIN a USING (key) WHERE a.payload > b.payload",
    "SELECT COUNT(*) FROM b JOIN a USING (key) WHERE c.key > 1",
    "SELECT key, SUM(payload) FROM b",
    "SELECT key, SUM(payload) FROM b JOIN a USING (key) GROUP BY key",
    "SELECT SUM(a.payload), SUM(b.payload) FROM b JOIN a USING (key)",
    "SELECT * FROM b JOIN a USING (key) ORDER BY key LIMIT 2",
    "SELECT a.payload, b.payload FROM b JOIN a USING (key) ORDER BY key LIMIT 2",
    "SELECT DISTINCT payload FROM b",
    "SELECT DISTINCT key FROM b ORDER BY payload",
    "SELECT SUM(key) FROM b",
    "SELECT COUNT(DISTINCT key) FROM b",
    "SELECT key FROM b GROUP BY key HAVING SUM(key) > 15",
    "SELECT key FROM b GROUP BY key HAVING payload > 1",
    "SELECT key FROM b HAVING count > 1",
    "SELECT key FROM b GROUP BY key ORDER BY payload",
    "SELECT key FROM b ORDER BY count",
    "SELECT COUNT(*) FROM b ORDER BY key",
    "SELECT key, payload FROM b GROUP BY key",
    "SELECT MIN(key) FROM b",
]


@pytest.mark.parametrize("sql", BAD)
def test_bad_statements_raise_the_same_sql_error(sql):
    with pytest.raises(jsql.SqlError) as want:
        jsql.execute_sql(sql, JAX_DB)
    with pytest.raises(tsql.SqlError) as got:
        tsql.execute_sql(sql, PORT_DB)
    assert str(got.value) == str(want.value)


def test_mesh_is_not_yet_ported():
    """The mesh (R6) is ported: on 8 CPU shards a statement gives the
    single-device result, its plan carries the mesh header, a plan shape R6
    does not take raises JAX's ``SqlError``, and a mesh that is not a
    ``parallel.mesh.Mesh`` raises ``SqlError``."""
    from partitionedhashjoin_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from partitionedhashjoin_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(8, devices=["cpu"])
    sql = "SELECT COUNT(*) FROM b"
    got = tsql.execute_sql(sql, PORT_DB, mesh=mesh)
    assert got.columns["count"].tolist() == tsql.execute_sql(sql, PORT_DB).columns[
        "count"].tolist() == [400]
    assert tsql.explain_sql(sql, PORT_DB, mesh=mesh).startswith("physical plan [mesh S=8]")
    unsupported = "SELECT key, payload FROM b ORDER BY key"
    with pytest.raises(jsql.SqlError) as want:
        jsql.execute_sql(unsupported, JAX_DB, mesh=jax_make_mesh(8))
    with pytest.raises(tsql.SqlError) as got:
        tsql.execute_sql(unsupported, PORT_DB, mesh=mesh)
    assert str(got.value) == str(want.value)
    for fn in (tsql.execute_sql, tsql.explain_sql):
        with pytest.raises(tsql.SqlError, match="parallel.mesh.Mesh"):
            fn(sql, PORT_DB, mesh=object())


SHELL = ["--table", "a=sequential:60", "--table", "b=sequential:90:20",
         "--max-rows", "3", "SELECT key, payload FROM b WHERE key % 7 = 0 ORDER BY key"]


def test_shell_prints_what_jax_prints(capsys):
    assert jsql.main(SHELL) == 0
    want = capsys.readouterr().out
    assert tsql.main(["--platform", "cpu"] + SHELL) == 0
    got = capsys.readouterr().out
    assert got == want
    assert got.splitlines()[0] == "key\tpayload" and "rows total" in got


def test_shell_reference_workload_counts_every_probe_row(capsys):
    argv = ["--platform", "cpu", "--table", "a=sequential:1000",
            "--table", "b=zipf:5000:1.05:1:1000",
            "SELECT COUNT(*) FROM b JOIN a USING (key)"]
    assert tsql.main(argv) == 0
    assert capsys.readouterr().out == "count\n5000\n(1 rows)\n"
    assert tsql.main(argv[:-1] + ["--explain", argv[-1]]) == 0
    text = capsys.readouterr().out
    assert text.startswith("physical plan [single device]") and "R1" in text
    argv = ["--platform", "cpu", "--table", "b=uniform:3000:1:50:5",
            "SELECT COUNT(*) FROM b WHERE key BETWEEN 1 AND 50"]
    assert tsql.main(argv) == 0
    assert capsys.readouterr().out == "count\n3000\n(1 rows)\n"


def test_shell_refuses_unported_and_bad_arguments(capsys):
    # --mesh is ported: with no table b, both shells raise the same SqlError
    with pytest.raises(jsql.SqlError) as want:
        jsql.main(["--mesh", "2", "SELECT COUNT(*) FROM b"])
    with pytest.raises(tsql.SqlError) as got:
        tsql.main(["--platform", "cpu", "--mesh", "2", "SELECT COUNT(*) FROM b"])
    assert str(got.value) == str(want.value)
    with pytest.raises(SystemExit):
        tsql.main(["--platform", "cpu", "--table", "b", "SELECT COUNT(*) FROM b"])
    with pytest.raises(tsql.SqlError, match="unknown table spec"):
        tsql.main(["--platform", "cpu", "--table", "b=poisson:3", "SELECT COUNT(*) FROM b"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tsql.main(["--table", "b=sequential:3", "SELECT COUNT(*) FROM b"])
