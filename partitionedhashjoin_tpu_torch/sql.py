"""SQL front end: a text query surface over the declarative query layer.

Counterpart of ``partitionedhashjoin_tpu/sql.py``.  Its lexer, parser and
statement AST are copies (the JAX module imports jax, so it cannot be
imported here); predicates lower onto torch and plans onto the port's query
layer (``partitionedhashjoin_tpu_torch/query.py``):

    from partitionedhashjoin_tpu_torch.sql import execute_sql

    r = execute_sql(
        "SELECT key, COUNT(*), SUM(b.payload) "
        "FROM b JOIN a USING (key) "
        "WHERE b.payload % 2 = 0 AND a.payload > 10 "
        "GROUP BY key ORDER BY count DESC LIMIT 10",
        tables={"a": customers, "b": orders},
    )
    r.columns["key"], r.columns["count"]   # numpy arrays, row_count rows

Dialect (deliberately small, everything lowered onto query.py so every
physical rewrite rule fires exactly as it does for fluent plans):

    [EXPLAIN]                              -- plan as rows, no execution
    SELECT  * | key | payload | COUNT(*) | COUNT(DISTINCT payload)
            | SUM(payload) | MIN(payload) | MAX(payload) | AVG(payload)
            | DISTINCT key                 -- lowers to GROUP BY key
    FROM    t [alias]
            [ [INNER|LEFT|SEMI|ANTI|FULL] JOIN t2 [alias] USING (key) ]*
    [WHERE  <int expressions over key/payload: + - * % // comparisons,
             AND OR NOT, IN (list), BETWEEN lo AND hi, parentheses>]
    [GROUP BY key]
    [HAVING <expressions over key/count/sum/min/max/avg/distinct or the
             aggregate-call spellings COUNT(*), SUM(payload), ...>]
    [ORDER BY key|payload|count|sum|min|max|distinct [ASC|DESC]]
    [LIMIT n]

Semantics notes:
- The FROM table is the PROBE side; each JOIN's table is a BUILD side
  (left-deep chain, query.py join()).  ``USING (key)`` is the only join
  predicate — the engine is a key-join engine like the reference.
- WHERE is split at top-level ANDs; each conjunct must reference columns
  of a single table (by alias when the query has joins) and is pushed
  down to that side (the R2 mask push-down).  Cross-table conjuncts are
  rejected.  As in the JAX module, a conjunct on the build side of a
  LEFT/FULL join filters that side BEFORE the join, so probe rows it
  would have matched stay in the result unmatched (standard SQL's WHERE
  applies after the join).
- Aggregate arguments choose the carried payload column: qualified to
  the FROM alias (default) → carry='probe'; to the LAST join's alias →
  carry='build'.  All aggregates must agree (one carried column flows).
- Everything is integer arithmetic (int32/int64 relations, wrapping in
  their width); AVG is the one float output (GroupByResult.mean).
- Division and modulo are floor division and its remainder, and they are
  defined for every operand, on every device, as JAX computes them on the
  CPU: ``x / 0`` and ``x // 0`` give -2 for x != 0 and -1 for ``0 // 0``,
  ``x % 0`` gives 0, ``MIN // -1`` gives MIN and ``MIN % -1`` gives 0 (MIN
  the dtype's least value); a float zero divisor (HAVING on avg) gives
  NaN.  Nothing raises: a ``torch.where`` on the divisor replaces what
  torch would do there (raise on the CPU, the hardware's answer on CUDA).
- Aggregates WITHOUT GROUP BY return one row: bare COUNT(*) rides the
  R1 count kernels; SUM/MIN/MAX/AVG/COUNT(DISTINCT) ride
  ``Query.aggregate()``'s streaming reductions.
- Result columns are named by the select list in a dict, so a name
  selected twice (``SELECT key, key``) yields one column, as in the JAX
  module; a LIMIT 0 result's columns are int32 (avg float32) whatever the
  relations' dtypes, as in the JAX module.

``mesh=`` executes over a mesh of shards (``parallel.mesh.make_mesh``,
query.py R6); plan shapes R6 does not take raise ``SqlError`` with the JAX
package's words.  Run ``python -m partitionedhashjoin_tpu_torch.sql`` for the
shell (``main``); its ``--mesh S`` puts S shards on the ``--platform``
device, where the JAX shell asks for S devices.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional

import numpy as np
import torch

from partitionedhashjoin_tpu_torch.data.table import JoinedTable, Table
from partitionedhashjoin_tpu_torch.query import (
    PlanError,
    Query,
    TableResult,
    _compile_count,
    _Ctx,
    _group_columns,
    scan,
)


class SqlError(ValueError):
    """Lex/parse/analysis failure, with position context."""


# ---------------------------------------------------------------------------
# lexer

_TOKEN_RE = re.compile(
    r"\s*(?:"
    r"(?P<num>\d+)"
    r"|(?P<name>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op><=|>=|!=|<>|//|[-+*/%<>=(),.\*])"
    r")"
)

_KEYWORDS = {
    "select", "from", "where", "group", "by", "order", "limit",
    "explain",
    "join", "inner", "left", "semi", "anti", "full", "using",
    "and", "or", "not", "in", "between", "asc", "desc", "count", "sum",
    "min", "max", "avg", "distinct", "as", "having",
}


@dataclasses.dataclass
class _Tok:
    kind: str  # "num" | "name" | "kw" | "op" | "end"
    text: str
    pos: int


def _lex(sql: str) -> list:
    toks, i = [], 0
    while i < len(sql):
        m = _TOKEN_RE.match(sql, i)
        if m is None or m.end() == m.start():
            if sql[i:].strip() == "":
                break
            raise SqlError(f"unexpected character {sql[i]!r} at {i}")
        i = m.end()
        if m.lastgroup == "num":
            toks.append(_Tok("num", m.group("num"), m.start()))
        elif m.lastgroup == "name":
            word = m.group("name")
            kind = "kw" if word.lower() in _KEYWORDS else "name"
            toks.append(_Tok(kind, word, m.start()))
        else:
            toks.append(_Tok("op", m.group("op"), m.start()))
    toks.append(_Tok("end", "", len(sql)))
    return toks


# ---------------------------------------------------------------------------
# expression AST (WHERE clauses)


@dataclasses.dataclass(frozen=True)
class _Num:
    value: int


@dataclasses.dataclass(frozen=True)
class _Col:
    alias: Optional[str]  # None = unqualified
    name: str  # "key" | "payload"


@dataclasses.dataclass(frozen=True)
class _Bin:
    op: str
    left: object
    right: object


@dataclasses.dataclass(frozen=True)
class _Not:
    child: object


@dataclasses.dataclass(frozen=True)
class _Neg:
    child: object


@dataclasses.dataclass(frozen=True)
class _In:
    child: object
    values: tuple
    negated: bool


def _expr_aliases(node, out: set) -> set:
    if isinstance(node, _Col):
        out.add(node.alias)
    elif isinstance(node, _Bin):
        _expr_aliases(node.left, out)
        _expr_aliases(node.right, out)
    elif isinstance(node, (_Not, _Neg)):
        _expr_aliases(node.child, out)
    elif isinstance(node, _In):
        _expr_aliases(node.child, out)
    return out


def _div(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """``a // b`` (``op`` "//") or ``a % b`` (``op`` "%"): floor division and
    its remainder, with JAX's CPU results where torch would raise or the
    hardware differs (the module note): x // 0 = -2 (x != 0), 0 // 0 = -1,
    x % 0 = 0, MIN // -1 = MIN, MIN % -1 = 0; NaN for a float zero
    divisor."""
    zero = b == 0
    dtype = torch.result_type(a, b)
    if dtype.is_floating_point:
        out = torch.floor_divide(a, b) if op == "//" else torch.remainder(a, b)
        return torch.where(zero, float("nan"), out)
    bad = zero | ((a == torch.iinfo(dtype).min) & (b == -1))
    safe = torch.where(bad, 1, b)  # MIN // 1 is MIN, JAX's MIN // -1
    if op == "%":
        return torch.where(bad, 0, torch.remainder(a, safe))
    out = torch.floor_divide(a, safe)
    out = torch.where(zero & (a == 0), -1, out)
    return torch.where(zero & (a != 0), -2, out)


def _eval_expr(n, col: Callable, num: Callable):
    """Shared operator dispatch for WHERE (row) and HAVING (group)
    expressions — only column/literal resolution differs between the
    two, so it is injected (``col`` resolves a _Col, ``num`` makes an int
    literal a tensor).  Arithmetic follows torch's integer semantics (mod
    2^32 wraparound on int32 — as the engine's SUM aggregates); '/' and
    '//' are both floor division (the only float column is avg), by zero
    as ``_div`` says."""

    def ev(m):
        return _eval_expr(m, col, num)

    if isinstance(n, _Num):
        return num(n.value)
    if isinstance(n, _Col):
        return col(n)
    if isinstance(n, _Neg):
        return -ev(n.child)
    if isinstance(n, _Not):
        return ~torch.as_tensor(ev(n.child)).to(torch.bool)
    if isinstance(n, _In):
        x = ev(n.child)
        hit = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        for v in n.values:
            hit = hit | (x == torch.tensor(v, dtype=x.dtype, device=x.device))
        return ~hit if n.negated else hit
    assert isinstance(n, _Bin)
    a, b = ev(n.left), ev(n.right)
    if n.op in ("and", "or"):
        a = torch.as_tensor(a).to(torch.bool)
        b = torch.as_tensor(b).to(torch.bool)
        return (a & b) if n.op == "and" else (a | b)
    if n.op == "=":
        return a == b
    if n.op in ("!=", "<>"):
        return a != b
    if n.op == "<":
        return a < b
    if n.op == "<=":
        return a <= b
    if n.op == ">":
        return a > b
    if n.op == ">=":
        return a >= b
    if n.op == "+":
        return a + b
    if n.op == "-":
        return a - b
    if n.op == "*":
        return a * b
    if n.op == "%":
        return _div(a, b, "%")
    if n.op in ("/", "//"):
        return _div(a, b, "//")
    raise AssertionError(n.op)


def _compile_expr(node) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Lower a WHERE expression to a (keys, payloads) -> tensor closure."""

    def fn(k, p):
        return _eval_expr(
            node,
            col=lambda c: k if c.name == "key" else p,
            num=lambda v: torch.tensor(v, dtype=k.dtype, device=k.device),
        )

    return fn


def _split_conjuncts(node) -> list:
    if isinstance(node, _Bin) and node.op == "and":
        return _split_conjuncts(node.left) + _split_conjuncts(node.right)
    return [node]


def _expr_group_cols(node, out: set) -> set:
    """Group-column names a HAVING expression references."""
    if isinstance(node, _Col):
        out.add(node.name)
    elif isinstance(node, _Bin):
        _expr_group_cols(node.left, out)
        _expr_group_cols(node.right, out)
    elif isinstance(node, (_Not, _Neg)):
        _expr_group_cols(node.child, out)
    elif isinstance(node, _In):
        _expr_group_cols(node.child, out)
    return out



def _compile_group_expr(node) -> Callable:
    """Lower a HAVING expression to a GroupByResult -> bool-mask closure
    (columns resolve against the group table; avg is float, the rest are
    the integer aggregate columns).  Same operator dispatch as WHERE
    (``_eval_expr``)."""

    def fn(g):
        cols = dict(_group_columns(g))
        cols["avg"] = g.mean()
        return torch.as_tensor(
            _eval_expr(
                node, col=lambda c: cols[c.name],
                num=lambda v: torch.tensor(v, device=g.keys.device),
            )
        ).to(torch.bool)

    return fn


# ---------------------------------------------------------------------------
# statement AST


@dataclasses.dataclass(frozen=True)
class _SelectItem:
    # func: None = plain column; else COUNT/SUM/MIN/MAX/AVG/COUNT_DISTINCT
    func: Optional[str]
    col: Optional[_Col]  # None for COUNT(*)
    star: bool = False


@dataclasses.dataclass(frozen=True)
class _JoinClause:
    join_type: str
    table: str
    alias: str


@dataclasses.dataclass(frozen=True)
class _Stmt:
    items: tuple
    select_distinct: bool
    from_table: str
    from_alias: str
    joins: tuple
    where: object
    group_by: bool
    having: object
    order_by: Optional[str]
    descending: bool
    limit: Optional[int]
    explain: bool = False  # EXPLAIN SELECT ...: return the plan as rows


#: columns a HAVING expression (and group-stage ORDER BY) may reference
_GROUP_COL_NAMES = (
    "key", "count", "sum", "min", "max", "avg", "distinct",
)


class _Parser:
    def __init__(self, sql: str) -> None:
        self.sql = sql
        self.toks = _lex(sql)
        self.i = 0
        # expression column mode: "row" resolves key/payload; "group"
        # (inside HAVING) resolves aggregate columns and COUNT(*)-style
        # calls to their group-table column names
        self._col_mode = "row"

    # -- token helpers ------------------------------------------------------

    def peek(self) -> _Tok:
        return self.toks[self.i]

    def next(self) -> _Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *words: str) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.text.lower() in words

    def take_kw(self, word: str) -> bool:
        if self.at_kw(word):
            self.next()
            return True
        return False

    def expect_kw(self, word: str) -> None:
        if not self.take_kw(word):
            t = self.peek()
            raise SqlError(
                f"expected {word.upper()} at position {t.pos}, "
                f"got {t.text!r}"
            )

    def expect_op(self, op: str) -> None:
        t = self.next()
        if t.kind != "op" or t.text != op:
            raise SqlError(
                f"expected {op!r} at position {t.pos}, got {t.text!r}"
            )

    def take_op(self, op: str) -> bool:
        t = self.peek()
        if t.kind == "op" and t.text == op:
            self.next()
            return True
        return False

    # -- grammar ------------------------------------------------------------

    def parse(self) -> _Stmt:
        self.explain = self.take_kw("explain")
        self.expect_kw("select")
        select_distinct = self.take_kw("distinct")
        items = self.select_list()
        self.expect_kw("from")
        from_table, from_alias = self.table_ref()
        joins = []
        while True:
            jt = self.join_type()
            if jt is None:
                break
            table, alias = self.table_ref()
            self.expect_kw("using")
            self.expect_op("(")
            keytok = self.next()
            if keytok.text.lower() != "key":
                raise SqlError(
                    "USING supports the engine's join column 'key' "
                    f"(got {keytok.text!r})"
                )
            self.expect_op(")")
            joins.append(_JoinClause(jt, table, alias))
        where = None
        if self.take_kw("where"):
            where = self.expr()
        group_by = False
        if self.take_kw("group"):
            self.expect_kw("by")
            t = self.next()
            if t.text.lower() != "key":
                raise SqlError(
                    "GROUP BY supports the engine's group column 'key' "
                    f"(got {t.text!r})"
                )
            group_by = True
        having = None
        if self.at_kw("having"):
            t = self.next()
            if not group_by:
                raise SqlError(
                    f"HAVING requires GROUP BY (position {t.pos})"
                )
            self._col_mode = "group"
            having = self.expr()
            self._col_mode = "row"
        order_by, desc = None, False
        if self.take_kw("order"):
            self.expect_kw("by")
            t = self.next()
            if t.kind not in ("name", "kw"):
                raise SqlError(f"expected a column after ORDER BY, got {t.text!r}")
            order_by = t.text.lower()
            if self.take_kw("desc"):
                desc = True
            else:
                self.take_kw("asc")
        limit = None
        if self.take_kw("limit"):
            t = self.next()
            if t.kind != "num":
                raise SqlError(f"LIMIT takes an integer, got {t.text!r}")
            limit = int(t.text)
        t = self.peek()
        if t.kind != "end":
            raise SqlError(
                f"unexpected trailing input at position {t.pos}: {t.text!r}"
            )
        return _Stmt(
            tuple(items), select_distinct, from_table, from_alias,
            tuple(joins), where, group_by, having, order_by, desc, limit,
            explain=self.explain,
        )

    def join_type(self) -> Optional[str]:
        for jt in ("inner", "left", "semi", "anti", "full"):
            if self.at_kw(jt):
                self.next()
                self.expect_kw("join")
                return jt
        if self.take_kw("join"):
            return "inner"
        return None

    def table_ref(self):
        t = self.next()
        if t.kind != "name":
            raise SqlError(
                f"expected a table name at position {t.pos}, got {t.text!r}"
            )
        alias = t.text
        if self.take_kw("as"):
            a = self.next()
            if a.kind != "name":
                raise SqlError(f"expected an alias after AS, got {a.text!r}")
            alias = a.text
        elif self.peek().kind == "name":
            alias = self.next().text
        return t.text, alias

    def select_list(self) -> list:
        items = [self.select_item()]
        while self.take_op(","):
            items.append(self.select_item())
        return items

    def select_item(self) -> _SelectItem:
        if self.take_op("*"):
            return _SelectItem(None, None, star=True)
        t = self.peek()
        word = t.text.lower()
        if t.kind == "kw" and word in ("count", "sum", "min", "max", "avg"):
            self.next()
            self.expect_op("(")
            if word == "count":
                if self.take_op("*"):
                    self.expect_op(")")
                    return _SelectItem("count", None)
                if self.take_kw("distinct"):
                    col = self.column()
                    self.expect_op(")")
                    return _SelectItem("count_distinct", col)
                raise SqlError(
                    "COUNT takes * or DISTINCT payload "
                    f"(position {t.pos})"
                )
            col = self.column()
            self.expect_op(")")
            return _SelectItem(word, col)
        return _SelectItem(None, self.column())

    def column(self) -> _Col:
        t = self.next()
        if t.kind not in ("name", "kw"):
            raise SqlError(
                f"expected a column at position {t.pos}, got {t.text!r}"
            )
        alias = None
        name = t.text
        if self.take_op("."):
            alias = name
            t2 = self.next()
            name = t2.text
        if self._col_mode == "group":
            if alias is not None or name.lower() not in _GROUP_COL_NAMES:
                raise SqlError(
                    f"HAVING references group columns "
                    f"{_GROUP_COL_NAMES} (got "
                    f"{alias + '.' if alias else ''}{name!r})"
                )
            return _Col(None, name.lower())
        if name.lower() not in ("key", "payload"):
            raise SqlError(
                f"unknown column {name!r} (relations have 'key' and "
                "'payload', data/table.py)"
            )
        return _Col(alias, name.lower())

    # -- expressions (precedence: OR < AND < NOT < cmp/IN < add < mul) ------

    def expr(self):
        node = self.and_expr()
        while self.take_kw("or"):
            node = _Bin("or", node, self.and_expr())
        return node

    def and_expr(self):
        node = self.not_expr()
        while self.take_kw("and"):
            node = _Bin("and", node, self.not_expr())
        return node

    def not_expr(self):
        if self.take_kw("not"):
            return _Not(self.not_expr())
        return self.cmp_expr()

    def cmp_expr(self):
        node = self.add_expr()
        t = self.peek()
        if t.kind == "op" and t.text in ("=", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            return _Bin(t.text, node, self.add_expr())
        if self.at_kw("not"):
            # x NOT IN (...) | x NOT BETWEEN lo AND hi
            save = self.i
            self.next()
            if self.take_kw("in"):
                return self.in_list(node, negated=True)
            if self.take_kw("between"):
                return _Not(self.between_tail(node))
            self.i = save
        if self.take_kw("in"):
            return self.in_list(node, negated=False)
        if self.take_kw("between"):
            return self.between_tail(node)
        return node

    def between_tail(self, node):
        # BETWEEN binds tighter than AND: the bounds are add-exprs, the
        # separating AND belongs to the BETWEEN, not the conjunction
        lo = self.add_expr()
        self.expect_kw("and")
        hi = self.add_expr()
        return _Bin("and", _Bin(">=", node, lo), _Bin("<=", node, hi))

    def in_list(self, node, negated: bool):
        self.expect_op("(")
        vals = [self.int_literal()]
        while self.take_op(","):
            vals.append(self.int_literal())
        self.expect_op(")")
        return _In(node, tuple(vals), negated)

    def int_literal(self) -> int:
        neg = self.take_op("-")
        t = self.next()
        if t.kind != "num":
            raise SqlError(
                f"expected an integer at position {t.pos}, got {t.text!r}"
            )
        return -int(t.text) if neg else int(t.text)

    def add_expr(self):
        node = self.mul_expr()
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in ("+", "-"):
                self.next()
                node = _Bin(t.text, node, self.mul_expr())
            else:
                return node

    def mul_expr(self):
        node = self.unary_expr()
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in ("*", "/", "//", "%"):
                self.next()
                node = _Bin(t.text, node, self.unary_expr())
            else:
                return node

    def unary_expr(self):
        if self.take_op("-"):
            return _Neg(self.unary_expr())
        if self.take_op("("):
            node = self.expr()
            self.expect_op(")")
            return node
        t = self.peek()
        if t.kind == "num":
            self.next()
            return _Num(int(t.text))
        if self._col_mode == "group" and self.at_kw(
            "count", "sum", "min", "max", "avg"
        ):
            # aggregate-call spelling in HAVING (COUNT(*) > 5 etc.) maps
            # to the group-table column the select list would name
            nxt = self.toks[self.i + 1]
            if nxt.kind == "op" and nxt.text == "(":
                self._col_mode = "row"  # the argument is a row column
                try:
                    item = self.select_item()
                finally:
                    self._col_mode = "group"
                if item.col is not None and item.col.alias is not None:
                    raise SqlError(
                        "HAVING aggregate arguments are unqualified "
                        "(the carried column is chosen by the SELECT "
                        f"list): {item.col.alias!r}"
                    )
                if item.col is not None and item.col.name != "payload":
                    raise SqlError(
                        "HAVING aggregates take payload, not key "
                        "(the group key itself is the 'key' column)"
                    )
                name = {
                    "count": "count", "count_distinct": "distinct",
                    "sum": "sum", "min": "min", "max": "max", "avg": "avg",
                }[item.func]
                return _Col(None, name)
        return self.column()


def parse_sql(sql: str) -> _Stmt:
    """Parse to the statement AST (exposed for tests and tooling)."""
    return _Parser(sql).parse()



# ---------------------------------------------------------------------------
# analysis + lowering onto query.py


@dataclasses.dataclass
class SqlResult:
    """Named result columns, each a numpy array of ``row_count`` rows."""

    columns: "dict[str, np.ndarray]"
    row_count: int

    def rows(self) -> list:
        names = list(self.columns)
        return [
            tuple(self.columns[c][i] for c in names)
            for i in range(self.row_count)
        ]


def _build_plan(
    stmt: _Stmt, tables: "dict[str, Table]", group_capacity=None
):
    """Lower the statement onto the fluent query layer; returns
    (Query, project, is_empty) where project(raw_result) -> SqlResult;
    is_empty marks a LIMIT 0 statement whose project() takes no result
    and must not execute the plan."""
    aliases: "dict[str, str]" = {}

    def add_alias(alias, table):
        if table not in tables:
            raise SqlError(
                f"unknown table {table!r}; registered: {sorted(tables)}"
            )
        if alias in aliases:
            raise SqlError(f"duplicate table alias {alias!r}")
        aliases[alias] = table

    add_alias(stmt.from_alias, stmt.from_table)
    for j in stmt.joins:
        add_alias(j.alias, j.table)
    last_join_alias = stmt.joins[-1].alias if stmt.joins else None

    # WHERE: split conjuncts, push each to its single referenced side
    side_preds: "dict[str, list]" = {a: [] for a in aliases}
    if stmt.where is not None:
        for conj in _split_conjuncts(stmt.where):
            refs = _expr_aliases(conj, set())
            if None in refs:
                if stmt.joins:
                    raise SqlError(
                        "qualify WHERE columns with a table alias in a "
                        "join query (e.g. b.payload)"
                    )
                refs = {stmt.from_alias}
            unknown = refs - set(aliases)
            if unknown:
                raise SqlError(f"unknown alias in WHERE: {sorted(unknown)}")
            if len(refs) > 1:
                raise SqlError(
                    "each WHERE conjunct must reference a single table "
                    "(cross-table predicates beyond the USING(key) "
                    f"equi-join are not supported): {sorted(refs)}"
                )
            if not refs:
                # column-free (constant) conjunct — valid SQL meaning
                # the same thing on every row; evaluate it on the FROM
                # side (side_query broadcasts scalar masks)
                refs = {stmt.from_alias}
            side_preds[next(iter(refs))].append(conj)

    def side_query(alias: str) -> Query:
        q = scan(tables[aliases[alias]])
        preds = side_preds[alias]
        if preds:
            node = preds[0]
            for p in preds[1:]:
                node = _Bin("and", node, p)
            expr = _compile_expr(node)
            # broadcast covers constant (column-free) conjuncts whose
            # evaluation is a scalar
            q = q.filter(
                lambda k, p, _e=expr: torch.as_tensor(_e(k, p))
                .to(torch.bool).expand(k.shape).contiguous()
            )
        return q

    # carried-column side: one payload column flows through joins into
    # aggregates and order/limit tails — derive it from the statement's
    # payload references and reject mixtures (mirrors the WHERE rules)
    def alias_to_carry(a: str, what: str) -> str:
        if a == stmt.from_alias:
            return "probe"
        if a == last_join_alias:
            return "build"
        raise SqlError(
            f"{what} alias {a!r} must be the FROM table "
            f"({stmt.from_alias!r}) or the last JOIN table "
            f"({last_join_alias!r})"
        )

    carry = "probe"
    agg_aliases = {
        it.col.alias
        for it in stmt.items
        if it.func in ("sum", "min", "max", "avg", "count_distinct")
        and it.col is not None
    }
    if stmt.joins and None in agg_aliases:
        raise SqlError(
            "qualify aggregate arguments with a table alias in a join "
            "query (e.g. SUM(b.payload))"
        )
    agg_aliases.discard(None)
    if agg_aliases:
        if len(agg_aliases) > 1:
            raise SqlError(
                "all aggregate arguments must come from one table "
                f"(one carried column flows): {sorted(agg_aliases)}"
            )
        carry = alias_to_carry(next(iter(agg_aliases)), "aggregate column")
    has_tail = stmt.order_by is not None or stmt.limit is not None
    if stmt.joins and not stmt.group_by and has_tail:
        # an order/limit tail collapses the join to ONE carried column
        # (TableResult), unlike a bare join's 3-column JoinedTable
        if any(it.star for it in stmt.items):
            raise SqlError(
                "SELECT * with ORDER BY/LIMIT on a join carries a single "
                "payload column; select key and one qualified payload "
                "explicitly"
            )
        row_aliases = {
            it.col.alias
            for it in stmt.items
            if it.func is None and it.col is not None
            and it.col.name == "payload"
        }
        if None in row_aliases:
            raise SqlError(
                "qualify selected payload with a table alias in a join "
                "query"
            )
        if len(row_aliases) > 1:
            raise SqlError(
                "ORDER BY/LIMIT join queries carry one payload column; "
                f"selected payloads span {sorted(row_aliases)}"
            )
        if row_aliases:
            side = alias_to_carry(next(iter(row_aliases)), "payload")
            if agg_aliases and side != carry:
                raise SqlError(
                    "selected payload and aggregate arguments disagree "
                    "on the carried column"
                )
            carry = side

    q = side_query(stmt.from_alias)
    for j in stmt.joins:
        q = q.join(side_query(j.alias), join_type=j.join_type, carry=carry)

    has_aggs = any(it.func for it in stmt.items)
    plain_cols = [it for it in stmt.items if it.func is None and not it.star]
    stars = any(it.star for it in stmt.items)
    wd = any(it.func == "count_distinct" for it in stmt.items)
    if stmt.having is not None and "distinct" in _expr_group_cols(
        stmt.having, set()
    ):
        wd = True  # HAVING COUNT(DISTINCT payload) without selecting it
    if stmt.order_by == "distinct":
        wd = True  # ORDER BY distinct without selecting it

    # LIMIT 0 is valid SQL (an empty result); the fluent layer's limit()
    # wants a positive k, so resolve it here without executing anything
    empty = stmt.limit == 0

    if stmt.select_distinct:
        # SELECT DISTINCT key = GROUP BY key projecting only the key
        # (the engine groups by key; DISTINCT payload has no group axis)
        if stmt.group_by or has_aggs or stars or [
            c for c in plain_cols if c.col.name != "key"
        ]:
            raise SqlError(
                "SELECT DISTINCT supports exactly 'key' (it lowers to "
                "GROUP BY key); use GROUP BY for aggregates"
            )
        if stmt.order_by is not None and stmt.order_by != "key":
            raise SqlError("SELECT DISTINCT key orders by key only")
        q = q.group_by(group_capacity=group_capacity)
        names = ["key"]
        if empty:
            return q, lambda: _empty_result(names), True
        if stmt.order_by is not None:
            q = q.order_by("key", descending=stmt.descending)
        if stmt.limit is not None:
            q = q.limit(stmt.limit)
        return q, (lambda g: _project_groups(g, names)), False

    if stmt.group_by:
        q = q.group_by(with_distinct=wd, group_capacity=group_capacity)
        if stmt.having is not None:
            q = q.having(_compile_group_expr(stmt.having))
        names = _group_item_names(stmt.items)
        if empty:
            return q, lambda: _empty_result(names), True
        if stmt.order_by is not None:
            q = q.order_by(stmt.order_by, descending=stmt.descending)
        if stmt.limit is not None:
            q = q.limit(stmt.limit)
        return q, (lambda g: _project_groups(g, names)), False

    if has_aggs:
        # scalar aggregates without GROUP BY: one result row.  Bare
        # COUNT(*) keeps the R1 count-kernel path (nothing materializes);
        # any other aggregate flows through Query.aggregate()'s streaming
        # reductions over the plan's valid rows.
        if plain_cols or stars:
            raise SqlError(
                "selecting columns alongside aggregates needs GROUP BY"
            )
        if stmt.order_by is not None:
            raise SqlError("ORDER BY needs rows or GROUP BY")
        names = []
        for it in stmt.items:
            if it.col is not None and it.col.name != "payload":
                # same rule as the GROUP BY path (_group_item_names):
                # aggregates take the payload column
                raise SqlError(
                    f"{it.func.upper().replace('_', ' ')} takes "
                    "payload, not key"
                )
            names.append(
                {"count_distinct": "distinct"}.get(it.func, it.func)
            )
        if empty:
            return q, lambda: _empty_result(names), True
        # LIMIT >= 1 is a no-op on the single aggregate row (it limits
        # RESULT rows, not the rows counted)
        if names == ["count"] * len(names):
            return q, "count", False
        return q, ("scalar", tuple(names), wd), False

    # row query
    names = _row_item_names(stmt.items, stmt)
    if empty:
        return q, lambda: _empty_result(names), True
    if stmt.order_by is not None:
        if stmt.order_by not in ("key", "payload"):
            raise SqlError(
                "table-stage ORDER BY supports key|payload "
                f"(got {stmt.order_by!r})"
            )
        q = q.order_by(stmt.order_by, descending=stmt.descending)
    if stmt.limit is not None:
        q = q.limit(stmt.limit)
    return q, (lambda r: _project_rows(r, names)), False


def _empty_result(names) -> SqlResult:
    # dtypes match the non-empty result paths (int32 relations; avg is
    # the one float column) so LIMIT 0 pages concatenate cleanly
    return SqlResult(
        {
            n: np.empty(
                (0,), np.float32 if n == "avg" else np.int32
            )
            for n in names
        },
        0,
    )


def _group_item_names(items) -> list:
    names = []
    for it in items:
        if it.star:
            names.extend(["key", "count", "sum", "min", "max"])
        elif it.func is None:
            if it.col.name != "key":
                raise SqlError(
                    "GROUP BY key queries can select 'key' and "
                    "aggregates (payload is aggregated away)"
                )
            names.append("key")
        elif it.func == "count":
            names.append("count")
        elif it.func == "count_distinct":
            names.append("distinct")
            if it.col.name != "payload":
                raise SqlError("COUNT(DISTINCT ...) takes payload")
        else:
            if it.col.name != "payload":
                raise SqlError(f"{it.func.upper()} takes payload, not key")
            names.append(it.func)
    return names


def _project_groups(g, names) -> SqlResult:
    n = int(g.num_groups)
    src = _group_columns(g)  # {key,count,sum,min,max[,distinct]}
    cols = {}
    for name in names:
        col = g.mean() if name == "avg" else src[name]
        cols[name] = col[:n].cpu().numpy()
    return SqlResult(cols, n)


def _row_item_names(items, stmt: _Stmt) -> list:
    joined = bool(stmt.joins)
    names = []
    for it in items:
        if it.star:
            names.extend(
                ["key", "payload_build", "payload_probe"]
                if joined else ["key", "payload"]
            )
            continue
        col = it.col
        if col.name == "key":
            names.append("key")
        elif not joined:
            names.append("payload")
        else:
            if col.alias is None:
                raise SqlError(
                    "qualify selected payload with a table alias in a "
                    "join query"
                )
            if col.alias == stmt.from_alias:
                names.append("payload_probe")
            elif col.alias == stmt.joins[-1].alias:
                names.append("payload_build")
            else:
                raise SqlError(
                    f"selectable payloads in a join query come from the "
                    f"FROM table or the last JOIN table, not "
                    f"{col.alias!r}"
                )
    return names


def _project_rows(r, names) -> SqlResult:
    if isinstance(r, JoinedTable):
        n = int(r.count)
        src = {
            "key": r.keys,
            "payload_build": r.payloads_a,
            "payload_probe": r.payloads_b,
        }
    else:
        assert isinstance(r, TableResult), type(r)
        n = int(r.count)
        src = {"key": r.table.keys, "payload": r.table.payloads}
        # order_by/limit tails and joins collapse to a carried column;
        # both joined payload names resolve to it
        src.setdefault("payload_build", r.table.payloads)
        src.setdefault("payload_probe", r.table.payloads)
    cols = {}
    for name in names:
        if name not in src:
            raise SqlError(
                f"column {name} is not available on this result shape"
            )
        cols[name] = src[name][:n].cpu().numpy()
    return SqlResult(cols, n)


def plan_sql(
    sql: str, tables: "dict[str, Table]", group_capacity=None
) -> Query:
    """The fluent-layer Query a statement lowers to (for EXPLAIN).
    For a LIMIT 0 statement this is the plan without the limit (the
    execute path short-circuits to an empty result)."""
    try:
        q, _, _ = _build_plan(parse_sql(sql), tables, group_capacity)
    except PlanError as e:
        raise SqlError(str(e)) from e
    return q


def _plan_lines(stmt: _Stmt, tables, mesh, group_capacity) -> list:
    """The physical plan that ``execute_sql`` runs for ``stmt``, one line
    per operator."""
    try:
        q, project, _ = _build_plan(stmt, tables, group_capacity)
        if project == "count":
            # show the COUNT plan (R1 kernels), not the row plan the same
            # Query would materialize
            ctx = _Ctx.make(mesh)
            plan = _compile_count(q._node, ctx)
            return [ctx.header()] + [f"  {s}" for s in plan.steps]
        lines = q.explain(mesh=mesh).splitlines()
        if isinstance(project, tuple) and project[0] == "scalar":
            lines.append(
                "  aggregate -> streaming scalar reductions "
                "(Query.aggregate)"
            )
        return lines
    except PlanError as e:  # unsupported plan shapes, a mesh
        raise SqlError(str(e)) from e


def explain_sql(
    sql: str,
    tables: "dict[str, Table]",
    mesh=None,
    group_capacity=None,
) -> str:
    """Physical plan of the statement (query.py EXPLAIN, rules R1-R7): the
    plan ``execute_sql`` runs, as ``EXPLAIN SELECT`` shows it, so a bare
    COUNT(*) shows the R1 count plan.  (The JAX module's ``explain_sql``
    shows the row plan of the statement's Query there.)"""
    return "\n".join(_plan_lines(parse_sql(sql), tables, mesh, group_capacity))


def execute_sql(
    sql: str,
    tables: "dict[str, Table]",
    mesh=None,
    group_capacity=None,
) -> SqlResult:
    """Parse, plan, and run a statement on the tables' device.  ``tables``
    maps FROM/JOIN names to relations; ``mesh`` executes on a mesh of
    shards (query.py R6); ``group_capacity`` bounds the GROUP BY table (a physical knob SQL has
    no syntax for — defaults to the aggregate's own sizing).
    ``EXPLAIN SELECT ...`` returns the physical plan as a one-column
    ``plan`` result (one line per operator) without executing anything.
    Raises SqlError on any lex/parse/analysis/plan failure (fluent-layer
    PlanErrors are wrapped, per the module's one-error contract)."""
    stmt = parse_sql(sql)
    if stmt.explain:
        lines = _plan_lines(stmt, tables, mesh, group_capacity)
        return SqlResult(
            {"plan": np.array(lines, dtype=object)}, len(lines)
        )
    try:
        q, project, is_empty = _build_plan(stmt, tables, group_capacity)
        if is_empty:
            return project()
        if project == "count":
            c = q.count(mesh=mesh)
            return SqlResult({"count": np.asarray([c])}, 1)
        if isinstance(project, tuple) and project[0] == "scalar":
            _, names, wd = project
            r = q.aggregate(with_distinct=wd, mesh=mesh)
            src = {
                "count": r.count, "sum": r.sum, "min": r.min,
                "max": r.max, "avg": r.mean(),
            }
            if r.distinct is not None:
                src["distinct"] = r.distinct
            cols = {nm: src[nm].reshape(1).cpu().numpy() for nm in names}
            return SqlResult(cols, 1)
        raw = q.execute(mesh=mesh)
    except PlanError as e:
        raise SqlError(str(e)) from e
    return project(raw)


# ---------------------------------------------------------------------------
# shell entry: python -m partitionedhashjoin_tpu_torch.sql


def _parse_table_spec(spec: str, device) -> Table:
    """``sequential:N[:start]`` | ``zipf:N:alpha:lo:hi[:seed]`` |
    ``uniform:N:lo:hi[:seed]`` (generators mirror DataGenerator/), made on
    ``device``."""
    from partitionedhashjoin_tpu_torch.ops.generators import (
        sequential_table,
        uniform_table,
        zipf_table,
    )

    kind, *args = spec.split(":")
    if kind == "sequential":
        n = int(args[0])
        start = int(args[1]) if len(args) > 1 else 1
        return sequential_table(n, start, device=device)
    if kind == "zipf":
        n, alpha, lo, hi = int(args[0]), float(args[1]), int(args[2]), int(args[3])
        seed = int(args[4]) if len(args) > 4 else 42
        return zipf_table(n, alpha, (lo, hi), seed=seed, device=device)
    if kind == "uniform":
        n, lo, hi = int(args[0]), int(args[1]), int(args[2])
        seed = int(args[3]) if len(args) > 3 else 42
        return uniform_table(n, (lo, hi), seed=seed, device=device)
    raise SqlError(f"unknown table spec kind {kind!r} in {spec!r}")


def main(argv=None) -> int:
    """Run a SQL statement over generated relations.

    Example (the reference workload as SQL, on the card):

        python -m partitionedhashjoin_tpu_torch.sql \\
            --table a=sequential:10000000 \\
            --table b=zipf:200000000:1.05:1:10000000 \\
            "SELECT COUNT(*) FROM b JOIN a USING (key)"
    """
    import argparse

    from partitionedhashjoin_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="phjoin-torch-sql", description=main.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "--table", action="append", default=[], metavar="NAME=SPEC",
        help="register NAME as sequential:N[:start], "
        "zipf:N:alpha:lo:hi[:seed], or uniform:N:lo:hi[:seed]",
    )
    ap.add_argument(
        "--platform", default="cuda",
        help="torch device: 'cuda' (default) or 'cpu'",
    )
    ap.add_argument(
        "--mesh", type=int, default=0, metavar="S",
        help="execute over a mesh of S shards, all on the --platform device",
    )
    ap.add_argument(
        "--explain", action="store_true",
        help="print the physical plan instead of executing",
    )
    ap.add_argument(
        "--max-rows", type=int, default=20,
        help="print at most this many result rows (default 20)",
    )
    ap.add_argument("sql", help="the statement")
    ns = ap.parse_args(argv)
    device = resolve_device(ns.platform)

    tables = {}
    for item in ns.table:
        name, _, spec = item.partition("=")
        if not spec:
            ap.error(f"--table takes NAME=SPEC, got {item!r}")
        tables[name] = _parse_table_spec(spec, device)

    mesh = None
    if ns.mesh:
        from partitionedhashjoin_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(ns.mesh, devices=[device])

    if ns.explain:
        print(explain_sql(ns.sql, tables, mesh=mesh))
        return 0

    r = execute_sql(ns.sql, tables, mesh=mesh)
    names = list(r.columns)
    print("\t".join(names))
    shown = min(r.row_count, ns.max_rows)
    for i in range(shown):
        print("\t".join(str(r.columns[c][i]) for c in names))
    if shown < r.row_count:
        print(f"... ({r.row_count} rows total)")
    else:
        print(f"({r.row_count} rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
