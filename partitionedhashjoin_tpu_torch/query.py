"""Declarative query plans over the port's operators.

Counterpart of ``partitionedhashjoin_tpu/query.py``: logical plans built with
a fluent API, a rule-based physical planner, EXPLAIN output, and execution
on one device (the tables' device: the card, or the CPU where the caller put
its tables there) or on a mesh of shards (``parallel/mesh.py``, R6).

    from partitionedhashjoin_tpu_torch.query import scan

    q = (scan(orders)                       # Table (probe side)
         .filter(lambda k, p: p % 2 == 0)
         .join(scan(customers))             # build side subplan
         .group_by()                        # COUNT/SUM/MIN/MAX per key
         .order_by("count", descending=True)
         .limit(10))
    print(q.explain())
    top = q.execute()                       # GroupByResult, 10 rows

Physical rewrite rules, with the JAX package's tags:

  R1  count-only queries never materialize: ``.count()`` on a join plan
      routes to the count kernels (K1 for int32 keys) with filters as
      validity masks.
  R2  filters never materialize an intermediate: predicates become
      validity masks that ride the downstream sorts (typed-materializer
      ``build_valid``/``probe_valid``, count masks, aggregate validity).
      Only a standalone trailing filter pays a compaction.
  R3  interesting-order propagation: JOIN → GROUP BY asks the kernel
      materializer (K4) for (key, payload)-ordered runs and aggregates with
      the relation sort skipped (``aggregate_sorted``).
  R4  GROUP BY → ORDER BY … LIMIT k selects k rows over the group columns
      with no relation-sized sort: a ``torch.topk`` threshold, then the
      rows at it in row order, so ties go to the lower row as with JAX's
      ``lax.top_k``.
  R5  filter → GROUP BY compacts the survivors first (K5), so the
      aggregate's sort touches only them (``filter_sort_aggregate_staged``).
  R6  the same logical plan executes on a mesh of shards
      (``parallel.mesh.make_mesh``): GROUP BY maps to the combiner-plan
      distributed aggregate (with_distinct to the row-exchange plan), count
      joins to the shuffle join (K1, owners on K7), materializing joins
      (inner/semi/anti/left) to the distributed materializer, ORDER BY …
      LIMIT to the (mask-aware) distributed top-k, and JOIN → GROUP BY to
      the one-shuffle join-aggregate (the join exchange co-partitions the
      groups).  Filters push into the exchange bucketizer everywhere, so
      invalid rows never travel.  Other shapes raise ``PlanError`` with the
      JAX package's words.  On a mesh over several processes
      (``parallel.distributed.global_mesh``) each relation a process scans
      is its own rows, and every process gets the global result: the
      operators return it replicated, a count of scanned rows is
      ``psum``'d, a scanned relation that is returned or aggregated whole
      is gathered, and a replicated join output that feeds a distributed
      GROUP BY is cut to the process's slice.
  R7  filtered JOIN → GROUP BY composes R5 with R3: K5 compacts the
      filtered probe, invalid build rows re-key to INT32_MIN (no surviving
      probe row holds it), and the kernel pipeline runs on the survivors;
      int32-extreme keys fall back to the typed path at run time.

Predicates are callables ``(keys, payloads) -> bool tensor``, as in
``ops/aggregate.filter_sort_aggregate``.  The JAX package's ``interpret``
flag and Mosaic gate have no counterpart: the port's kernels run on every
device (their plain versions on a CPU tensor), so the kernel paths need only
int32 keys.  Everything here is host-side planning; all device work happens
inside the operator modules this planner dispatches to.  Counts are 0-dim
int64 tensors (``GroupByResult.count`` / ``num_groups`` and a scalar
aggregate's count stay int32, as in JAX).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from partitionedhashjoin_tpu_torch.data.table import JoinedTable, Table, make_table
from partitionedhashjoin_tpu_torch.ops.order_by import _top_k_indices, _valid_first_order

Predicate = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_JOIN_TYPES = ("inner", "semi", "anti", "left", "full")
_I32_MAX = 2**31 - 1
_I32_MIN = -(2**31)
#: the seed of every distributed operator R6 runs, as in the JAX package
_MESH_SEED = 0x5EED


class PlanError(ValueError):
    """Unsupported logical-plan shape (raised at build or plan time)."""


# ---------------------------------------------------------------------------
# logical nodes


@dataclasses.dataclass(frozen=True)
class _Scan:
    table: Table


@dataclasses.dataclass(frozen=True)
class _Filter:
    child: object
    predicate: Predicate


@dataclasses.dataclass(frozen=True)
class _Join:
    probe: object
    build: object
    join_type: str
    carry: str  # which payload column downstream table ops keep


@dataclasses.dataclass(frozen=True)
class _GroupBy:
    child: object
    with_distinct: bool
    group_capacity: Optional[int]


@dataclasses.dataclass(frozen=True)
class _Having:
    child: object  # a group-stage node
    predicate: Callable  # GroupByResult -> bool mask over its rows


@dataclasses.dataclass(frozen=True)
class _OrderBy:
    child: object
    by: str
    descending: bool


@dataclasses.dataclass(frozen=True)
class _Limit:
    child: object
    k: int


def _stage(node) -> str:
    """"table" (rows flow) or "group" (aggregates flow)."""
    if isinstance(node, (_Scan, _Filter, _Join)):
        return "table"
    if isinstance(node, _GroupBy):
        return "group"
    return _stage(node.child)


# ---------------------------------------------------------------------------
# runtime intermediates

_GROUP_ORDER_COLS = ("key", "count", "sum", "min", "max", "distinct")


@dataclasses.dataclass
class _T:
    """Table-stage value: parallel columns + an optional validity mask.

    ``mask is None`` means every row is valid.  ``prefix_count`` is set
    when the valid rows are a compacted prefix (mask == arange < count)."""

    keys: torch.Tensor
    pays: torch.Tensor
    mask: Optional[torch.Tensor] = None
    prefix_count: Optional[torch.Tensor] = None
    joined: Optional[JoinedTable] = None  # set by a materializing join
    #: this process's rows of a relation scanned on a mesh over several
    #: processes (R6); False for a value every process holds whole
    local: bool = False

    def count(self) -> torch.Tensor:
        if self.prefix_count is not None:
            return self.prefix_count
        if self.mask is None:
            return torch.tensor(self.keys.shape[0], dtype=torch.int64,
                                device=self.keys.device)
        return self.mask.sum()

    def effective_mask(self) -> Optional[torch.Tensor]:
        """Validity as one mask, folding ``prefix_count`` in (None = all
        rows valid).  Every consumer of a side's validity (filters, join
        build/probe masks, aggregates) must use THIS, not ``.mask``: a
        materialized join's output carries its validity only as
        ``prefix_count``, and reading ``.mask`` alone would turn its
        zero-padding tail into real rows."""
        m = self.mask
        if self.prefix_count is not None:
            pm = _arange(self.keys) < self.prefix_count
            m = pm if m is None else (m & pm)
        return m


def _arange(like: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    n = like.shape[0] if n is None else n
    return torch.arange(n, dtype=torch.int64, device=like.device)


@dataclasses.dataclass
class TableResult:
    """A table-stage query result: rows ``[0, count)`` of ``table`` are
    valid (the static-capacity compaction idiom used across the engine)."""

    table: Table
    count: torch.Tensor


@dataclasses.dataclass
class ScalarAggResult:
    """Whole-relation aggregates (no GROUP BY), one result row.
    ``min``/``max`` are 0 when ``count`` is 0 (the engine's masked-row
    convention); ``distinct`` is None unless requested."""

    count: torch.Tensor
    sum: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor
    distinct: "torch.Tensor | None" = None

    def mean(self, dtype=torch.float32) -> torch.Tensor:
        from partitionedhashjoin_tpu_torch.ops.aggregate import masked_mean

        return masked_mean(self.count, self.sum, dtype)


# ---------------------------------------------------------------------------
# fluent builder


class Query:
    """Immutable logical plan; every method returns a new Query."""

    def __init__(self, node) -> None:
        self._node = node

    # -- builders ----------------------------------------------------------

    def filter(self, predicate: Predicate) -> "Query":
        """Keep rows where ``predicate(keys, payloads)`` holds (stage R2:
        becomes a validity mask, not a materialized intermediate)."""
        if _stage(self._node) != "table" or isinstance(
            self._node, (_OrderBy, _Limit)
        ):
            raise PlanError(
                "filter applies to a table stage before order_by/limit"
            )
        return Query(_Filter(self._node, predicate))

    def join(
        self, build: "Query", join_type: str = "inner", carry: str = "probe"
    ) -> "Query":
        """Join this plan (the PROBE/large side) against ``build`` on key.

        ``join_type`` ∈ {inner, semi, anti, left, full} — the typed
        materializer's semantics (ops/sort_merge.py); inner is first-match
        (Get semantics, the reference's probe, HashJoin.hpp:144-157).
        ``carry`` picks which payload column ("probe" or "build")
        downstream table-stage operators and GROUP BY aggregate over;
        a bare ``.join().execute()`` returns all three columns.
        """
        if join_type not in _JOIN_TYPES:
            raise PlanError(f"unknown join_type {join_type!r}")
        if carry not in ("probe", "build"):
            raise PlanError(f"carry must be 'probe' or 'build', not {carry!r}")
        if not isinstance(build, Query):
            raise PlanError("build side must be a Query (wrap with scan())")
        for side, node in (("probe", self._node), ("build", build._node)):
            if _stage(node) != "table" or isinstance(node, (_OrderBy, _Limit)):
                raise PlanError(f"join {side} side must be a table stage")
        return Query(_Join(self._node, build._node, join_type, carry))

    def group_by(
        self,
        with_distinct: bool = False,
        group_capacity: Optional[int] = None,
    ) -> "Query":
        """GROUP BY key, aggregating COUNT(*), SUM, MIN, MAX (and
        COUNT(DISTINCT payload) with ``with_distinct``) over the payload
        column.  Result rows ``[0, num_groups)`` are valid."""
        if _stage(self._node) != "table" or isinstance(
            self._node, (_OrderBy, _Limit)
        ):
            raise PlanError("group_by applies to a table stage")
        return Query(_GroupBy(self._node, with_distinct, group_capacity))

    def having(self, predicate) -> "Query":
        """Keep groups where ``predicate(g)`` holds — ``g`` is the
        GroupByResult, so conditions read like SQL HAVING:
        ``.having(lambda g: g.count > 5)``.  Surviving groups are
        compacted (k-sized gathers via the validity-dominant selection,
        never a re-aggregation); chains AND together."""
        if _stage(self._node) != "group" or isinstance(
            self._node, (_OrderBy, _Limit)
        ):
            raise PlanError(
                "having applies to a group stage before order_by/limit"
            )
        return Query(_Having(self._node, predicate))

    def order_by(self, by: str = "key", descending: bool = False) -> "Query":
        """Sort by a column: table stage ``by`` ∈ {key, payload}; group
        stage ``by`` ∈ {key, count, sum, min, max}."""
        valid = (
            ("key", "payload")
            if _stage(self._node) == "table"
            else _GROUP_ORDER_COLS
        )
        if by not in valid:
            raise PlanError(f"order_by column must be one of {valid}")
        if isinstance(self._node, (_OrderBy, _Limit)):
            raise PlanError("only one order_by/limit suffix is supported")
        return Query(_OrderBy(self._node, by, descending))

    def limit(self, k: int) -> "Query":
        """Keep the first ``k`` rows (after order_by: the top k)."""
        if not isinstance(k, int) or k <= 0:
            raise PlanError(f"limit must be a positive int, got {k!r}")
        if isinstance(self._node, _Limit):
            raise PlanError("limit already applied")
        return Query(_Limit(self._node, k))

    # -- terminals ----------------------------------------------------------

    def execute(self, mesh=None):
        """Run the plan.  Returns a ``GroupByResult`` for group-stage
        plans, a ``JoinedTable`` for a bare join, else a ``TableResult``.
        ``mesh``: execute on a ``parallel.mesh.Mesh`` through the
        distributed operators (R6)."""
        plan = _compile(self._node, _Ctx.make(mesh))
        return plan.run()

    def count(self, mesh=None) -> int:
        """Row count of the plan's result, without materializing when a
        count kernel exists (R1)."""
        plan = _compile_count(self._node, _Ctx.make(mesh))
        return int(plan.run())

    def aggregate(self, with_distinct: bool = False, mesh=None) -> ScalarAggResult:
        """Whole-relation aggregates (SQL's SELECT SUM(...) without
        GROUP BY): COUNT/SUM/MIN/MAX of the payload over the plan's valid
        rows in one streaming pass, plus one sort of the valid payloads
        when ``with_distinct``.  SUM follows the engine-wide mod-2^32 int32
        law (as every GROUP BY path), so relation-scale sums WRAP and
        ``mean()`` is the wrapped sum over count.  Join plans flow through
        their materializer first."""
        if _stage(self._node) != "table" or isinstance(
            self._node, (_OrderBy, _Limit)
        ):
            raise PlanError(
                "aggregate() applies to a table stage (ordering cannot "
                "change a scalar aggregate; drop the order_by/limit)"
            )
        ctx = _Ctx.make(mesh)
        inner = _exec_table(self._node, ctx, [])
        t = _global_rows(inner(), ctx.mesh)
        return _scalar_aggregate(t.pays, t.effective_mask(), with_distinct)

    def explain(self, mesh=None) -> str:
        """The physical plan as text, one operator per line, with the
        rewrite rule each line rides (R1-R7 in the module docstring)."""
        ctx = _Ctx.make(mesh)
        plan = _compile(self._node, ctx)
        return "\n".join([ctx.header()] + [f"  {s}" for s in plan.steps])


def scan(table: Table) -> Query:
    """Start a plan from a relation."""
    if not isinstance(table, Table):
        raise PlanError("scan() takes a data.table.Table")
    return Query(_Scan(table))


# ---------------------------------------------------------------------------
# physical planning


@dataclasses.dataclass
class _Ctx:
    """Planning context: the mesh of R6, or None for one device.  The JAX
    package's also carries the interpret flag, which the port has no use
    for."""

    mesh: object = None

    @classmethod
    def make(cls, mesh=None) -> "_Ctx":
        from partitionedhashjoin_tpu_torch.parallel.mesh import Mesh

        if mesh is not None and not isinstance(mesh, Mesh):
            raise PlanError(
                "mesh must be a parallel.mesh.Mesh (make_mesh), not "
                f"{type(mesh).__name__}"
            )
        return cls(mesh=mesh)

    def header(self) -> str:
        """EXPLAIN's first line."""
        if self.mesh is None:
            return "physical plan [single device]"
        return f"physical plan [mesh S={self.mesh.size}]"


@dataclasses.dataclass
class _Plan:
    steps: list
    run: Callable[[], object]


def _kernel_ok(keys_dtype) -> bool:
    """The kernel paths (K1, K4, K5) take int32 keys; the port's kernels run
    on every device, their plain versions on a CPU tensor."""
    return keys_dtype == torch.int32


def _exec_table(node, ctx: _Ctx, steps: list) -> Callable[[], _T]:
    """Compile a table-stage subtree to a thunk returning _T (R2: filters
    accumulate as masks; joins materialize only when rows must flow)."""
    if isinstance(node, _Scan):
        n = node.table.size
        steps.append(
            f"scan {node.table.uuid[:8]} ({n} rows, "
            f"{str(node.table.keys.dtype).removeprefix('torch.')})"
        )
        t = node.table
        local = ctx.mesh is not None and ctx.mesh.process_count > 1
        return lambda: _T(t.keys, t.payloads, local=local)
    if isinstance(node, _Filter):
        inner = _exec_table(node.child, ctx, steps)
        steps.append("filter -> validity mask, no materialization (R2)")
        pred = node.predicate

        def run():
            t = inner()
            m = torch.as_tensor(pred(t.keys, t.pays)).to(torch.bool)
            em = t.effective_mask()  # folds a join output's prefix_count
            if em is not None:
                m = m & em
            return _T(t.keys, t.pays, m, local=t.local)

        return run
    if isinstance(node, _Join):
        return _exec_join_rows(node, ctx, steps)
    raise PlanError(f"not a table-stage node: {type(node).__name__}")


def _exec_join_sides(node: _Join, ctx: _Ctx, steps: list):
    bsteps: list = []
    build = _exec_table(node.build, ctx, bsteps)
    psteps: list = []
    probe = _exec_table(node.probe, ctx, psteps)
    steps.extend(psteps)
    steps.extend("  [build] " + s for s in bsteps)
    return build, probe


def _global_rows(t: _T, mesh) -> _T:
    """R6 across processes: a value of this process's rows as the global
    relation, gathered from every process in process order (the processes'
    row counts checked equal first, in every process); any other value as
    it is."""
    if not t.local:
        return t
    from partitionedhashjoin_tpu_torch.parallel.mesh import all_gather, check_local_rows

    check_local_rows([t.keys.shape[0]], mesh)
    mask = None if t.mask is None else all_gather(t.mask, mesh)
    return _T(all_gather(t.keys, mesh), all_gather(t.pays, mesh), mask)


def _process_rows(t: _T, mesh) -> _T:
    """R6 across processes: the rows this process hands a distributed
    operator: its own rows of a scanned relation as they are, and its
    ``host_slice`` of a value that every process holds whole (a
    materialized join's output), with the validity folded into one
    mask."""
    if t.local or mesh.process_count == 1:
        return t
    rows = t.keys.shape[0] // mesh.process_count
    cut = slice(mesh.process_index * rows, (mesh.process_index + 1) * rows)
    m = t.effective_mask()
    return _T(t.keys[cut], t.pays[cut], None if m is None else m[cut], local=True)


def _join_is_plain(node: _Join) -> bool:
    """True when neither side carries a filter (masks absent statically)."""
    return isinstance(node.probe, _Scan) and isinstance(node.build, _Scan)


def _mesh_side_ok(node) -> bool:
    """True when a join side is a scan or a filter chain over a scan: its
    shapes unchanged, so it compiles to columns and a validity mask, and on
    a mesh the mask pushes down into the distributed exchange (R6)."""
    while isinstance(node, _Filter):
        node = node.child
    return isinstance(node, _Scan)


def _exec_join_rows(node: _Join, ctx: _Ctx, steps: list):
    """Join whose output rows flow onward (or are the result)."""
    if ctx.mesh is not None:
        return _exec_join_rows_mesh(node, ctx, steps)
    build, probe = _exec_join_sides(node, ctx, steps)
    jt, carry = node.join_type, node.carry
    steps.append(
        f"join[{jt}] -> typed sort-merge materializer, filters as "
        "validity masks (R2); carry=" + carry
    )

    def run():
        from partitionedhashjoin_tpu_torch.ops.sort_merge import (
            sort_merge_materialize_typed,
        )

        b, p = build(), probe()
        keys, pa, pb, matched, count = sort_merge_materialize_typed(
            b.keys, b.pays, p.keys, p.pays, jt,
            build_valid=b.effective_mask(),
            probe_valid=p.effective_mask(),
        )
        pays = pb if carry == "probe" else pa
        t = _T(keys, pays, prefix_count=count)
        t.joined = JoinedTable(  # kept for a bare-join execute()
            keys=keys, payloads_a=pa, payloads_b=pb, count=count,
            matched=matched,
        )
        return t

    return run


def _exec_join_rows_mesh(node: _Join, ctx: _Ctx, steps: list):
    """R6: the distributed materializer, filters pushed into its exchange."""
    jt = node.join_type
    if jt not in ("inner", "semi", "anti", "left") or not (
        _mesh_side_ok(node.build) and _mesh_side_ok(node.probe)
    ):
        raise PlanError(
            "mesh materializing joins support inner/semi/anti/left "
            "over scan/filter sides (full needs a per-build-row "
            "cross-shard reduction); compose others single-device"
        )
    build, probe = _exec_join_sides(node, ctx, steps)
    carry = node.carry
    steps.append(
        f"join[{jt}] -> distributed materialize (exchange + per-shard "
        "typed union join, gathered + compacted); filters pushed into "
        "the bucketizer (R2, R6); carry=" + carry
    )
    mesh = ctx.mesh

    def run_mesh():
        from partitionedhashjoin_tpu_torch.parallel.materialize_shuffle import (
            DistributedMaterializeJoiner,
        )

        b, p = build(), probe()
        joined = DistributedMaterializeJoiner(mesh, seed=_MESH_SEED).run(
            make_table(b.keys, b.pays),
            make_table(p.keys, p.pays),
            jt,
            build_valid=b.effective_mask(),
            probe_valid=p.effective_mask(),
        )
        pays = joined.payloads_b if carry == "probe" else joined.payloads_a
        t = _T(joined.keys, pays, prefix_count=joined.count)
        t.joined = joined
        return t

    return run_mesh


def _compile(node, ctx: _Ctx) -> _Plan:
    steps: list = []
    if _stage(node) == "table":
        # peel the optional order_by/limit suffix
        limit_k = None
        order = None
        core = node
        if isinstance(core, _Limit):
            limit_k = core.k
            core = core.child
        if isinstance(core, _OrderBy):
            order = core
            core = core.child
        inner = _exec_table(core, ctx, steps)
        if order is None and limit_k is None:
            if isinstance(core, _Join):
                steps.append("emit JoinedTable (3 columns + count)")

                def run_join():
                    return inner().joined

                return _Plan(steps, run_join)
            steps.append("emit TableResult (compact if filtered)")

            def run_table():
                t = _global_rows(inner(), ctx.mesh)
                if t.mask is None:
                    return TableResult(make_table(t.keys, t.pays), t.count())
                from partitionedhashjoin_tpu_torch.ops.filter import compact_sort

                cnt, k, p = compact_sort(t.mask, t.keys, t.pays)
                return TableResult(make_table(k, p), cnt)

            return _Plan(steps, run_table)
        return _compile_table_tail(inner, core, order, limit_k, ctx, steps)

    # group stage
    limit_k = None
    order = None
    core = node
    if isinstance(core, _Limit):
        limit_k = core.k
        core = core.child
    if isinstance(core, _OrderBy):
        order = core
        core = core.child
    having_preds = []
    while isinstance(core, _Having):
        having_preds.append(core.predicate)
        core = core.child
    assert isinstance(core, _GroupBy)
    run_group = _exec_group(core, ctx, steps)
    mask_fn = None
    if having_preds:
        steps.append(
            f"having ({len(having_preds)} predicate"
            f"{'s' if len(having_preds) > 1 else ''}) -> group validity "
            "mask, folded into the k-sized selection (no re-aggregation)"
        )

        def mask_fn(g):
            m = None
            for pred in having_preds:
                pm = torch.as_tensor(pred(g)).to(torch.bool)
                m = pm if m is None else (m & pm)
            return m

    if order is None and limit_k is None:
        if mask_fn is None:
            return _Plan(steps, run_group)

        def run_having():
            g = run_group()
            # compact surviving groups to the front, key order
            return group_top_k(
                g, g.keys.shape[0], by="key", descending=False,
                mask=mask_fn(g),
            )

        return _Plan(steps, run_having)
    return _compile_group_tail(
        run_group, order, limit_k, ctx, steps, mask_fn=mask_fn
    )


# -- table-stage order_by / limit -------------------------------------------


def _order_col_key(col, descending):
    """Monotone reorder key: ascending wants smallest first, and top-k /
    sorts pick largest/smallest consistently via bitwise complement (the
    INT_MIN-safe trick from ops/order_by.py)."""
    return ~col if descending else col


def _compile_table_tail(inner, core, order, limit_k, ctx, steps) -> _Plan:
    if ctx.mesh is not None and isinstance(core, _Join):
        # join tail: the distributed materializer already returns one
        # prefix-compacted relation, so the local order/limit tail below
        # applies to it unchanged (it reads t.prefix_count)
        steps.append(
            "join tail on mesh -> local order/limit over the gathered "
            "replicated join output"
        )
    elif ctx.mesh is not None:
        return _compile_table_tail_mesh(inner, core, order, limit_k, ctx, steps)
    if order is None:
        # LIMIT without ORDER BY: head of the (valid) rows
        steps.append(f"limit {limit_k} -> head slice (compact if filtered)")

        def run_head():
            from partitionedhashjoin_tpu_torch.ops.filter import compact_sort

            t = inner()
            k = min(limit_k, t.keys.shape[0])
            if t.mask is None and t.prefix_count is not None:
                # already prefix-compacted (a materialized join): the head
                # is the slice, but the live count caps at the prefix
                cnt = torch.clamp(t.prefix_count, max=k)
                keys, pays = t.keys[:k], t.pays[:k]
            elif t.mask is None:
                cnt = torch.tensor(k, dtype=torch.int64, device=t.keys.device)
                keys, pays = t.keys[:k], t.pays[:k]
            else:
                cnt, keys, pays = compact_sort(t.mask, t.keys, t.pays)
                cnt = torch.clamp(cnt, max=k)
                keys, pays = keys[:k], pays[:k]
                live = _arange(keys) < cnt
                keys = torch.where(live, keys, 0)
                pays = torch.where(live, pays, 0)
            return TableResult(make_table(keys, pays), cnt)

        return _Plan(steps, run_head)

    by, desc = order.by, order.descending
    if limit_k is not None:
        steps.append(
            f"order_by {by} {'desc' if desc else 'asc'} + limit {limit_k} "
            "-> top-k (torch.topk threshold, ties by row), no relation "
            "sort (R4)"
        )

        def run_topk():
            t = inner()
            n = t.keys.shape[0]
            k = min(limit_k, n)
            if t.mask is None and t.prefix_count is None:
                col = t.keys if by == "key" else t.pays
                # the k largest of ~col are the k smallest of col (the
                # INT_MIN-safe complement trick, ops/order_by.py)
                idx = _top_k_indices(col if desc else ~col, k)
                return TableResult(
                    make_table(t.keys[idx], t.pays[idx]),
                    torch.tensor(k, dtype=torch.int64, device=t.keys.device),
                )
            # exact under validity: one validity-dominant ordering + head-k
            # (a top-k sentinel value could collide with a real key)
            cnt, keys_s, pays_s = _masked_order(t, by, desc)
            kcnt = torch.clamp(cnt, max=k)
            live = _arange(t.keys, k) < kcnt
            return TableResult(
                make_table(
                    torch.where(live, keys_s[:k], 0),
                    torch.where(live, pays_s[:k], 0),
                ),
                kcnt,
            )

        return _Plan(steps, run_topk)

    steps.append(
        f"order_by {by} {'desc' if desc else 'asc'} -> one value-carrying "
        "sort (validity as leading sort key when filtered)"
    )

    def run_order():
        t = inner()
        cnt, keys_s, pays_s = _masked_order(t, by, desc)
        return TableResult(make_table(keys_s, pays_s), cnt)

    return _Plan(steps, run_order)


def _compile_table_tail_mesh(inner, core, order, limit_k, ctx, steps) -> _Plan:
    """R6 for scan()[.filter()].order_by().limit(): the distributed top-k."""
    if order is None or limit_k is None or not _mesh_side_ok(core):
        raise PlanError(
            "mesh table-stage plans support "
            "scan()[.filter()].order_by().limit() (distributed "
            "top-k); compose others single-device"
        )
    filtered = not isinstance(core, _Scan)
    steps.append(
        f"order_by {order.by} {'desc' if order.descending else 'asc'} "
        f"+ limit {limit_k} -> distributed top-k "
        + (
            "(filter as validity mask, validity-dominant sort; "
            if filtered else "(local top-k, "
        )
        + "all_gather S*k, replicated final) (R2, R4, R6)"
    )
    mesh = ctx.mesh

    def run_mesh():
        from partitionedhashjoin_tpu_torch.parallel.top_k import distributed_top_k

        t = inner()
        out, n_live = distributed_top_k(
            mesh, make_table(t.keys, t.pays), limit_k,
            by=order.by, descending=order.descending,
            mask=t.effective_mask(),
        )
        return TableResult(out, n_live)

    return _Plan(steps, run_mesh)


def _scalar_aggregate(pays, mask, with_distinct) -> ScalarAggResult:
    """COUNT/SUM/MIN/MAX (and COUNT DISTINCT) of ``pays`` over ``mask``
    (None: every row).  SUM wraps in the payload dtype, as JAX's."""
    from partitionedhashjoin_tpu_torch.ops.aggregate import _wrap

    n = pays.shape[0]
    device = pays.device
    zero = torch.zeros((), dtype=pays.dtype, device=device)
    zi = torch.zeros((), dtype=torch.int32, device=device)
    if n == 0:
        return ScalarAggResult(zi, zero, zero, zero, zi if with_distinct else None)
    info = torch.iinfo(pays.dtype)
    if mask is None:
        cnt = torch.tensor(n, dtype=torch.int32, device=device)
        s = _wrap(pays.sum(dtype=torch.int64), pays.dtype)
        mn, mx = pays.min(), pays.max()
    else:
        cnt = mask.sum().to(torch.int32)
        s = _wrap(torch.where(mask, pays, zero).sum(dtype=torch.int64), pays.dtype)
        mn = torch.where(mask, pays, info.max).min()
        mx = torch.where(mask, pays, info.min).max()
        mn = torch.where(cnt > 0, mn, zero)
        mx = torch.where(cnt > 0, mx, zero)
    d = None
    if with_distinct:
        # distinct values are the run starts of the sorted valid payloads
        v = torch.sort(pays if mask is None else pays[mask]).values
        d = ((v[1:] != v[:-1]).sum() + (v.shape[0] > 0)).to(torch.int32)
    return ScalarAggResult(cnt, s, mn, mx, d)


def _masked_order(t: _T, by: str, desc: bool):
    """Order valid rows to the front: the invalid flag is the leading sort
    key, so filtered rows can never interleave (exact over the full int
    domain — no sentinel keys).  Rows past the count are zeros."""
    n = t.keys.shape[0]
    if t.mask is not None:
        invalid = ~t.mask
    elif t.prefix_count is not None:
        invalid = _arange(t.keys) >= t.prefix_count
    else:
        invalid = torch.zeros((n,), dtype=torch.bool, device=t.keys.device)
    ordcol = _order_col_key(t.keys if by == "key" else t.pays, desc)
    order = _valid_first_order(invalid, ordcol)
    cnt = (~invalid).sum()
    live = _arange(t.keys) < cnt
    return (
        cnt,
        torch.where(live, t.keys[order], 0),
        torch.where(live, t.pays[order], 0),
    )


# -- group stage -------------------------------------------------------------


def _exec_group(node: _GroupBy, ctx: _Ctx, steps: list):
    child = node.child
    cap = node.group_capacity
    wd = node.with_distinct

    if ctx.mesh is not None:
        return _exec_group_mesh(node, ctx, steps)

    if isinstance(child, _Join):
        return _exec_join_group(child, node, ctx, steps)

    if isinstance(child, _Filter):
        inner = _exec_table(child.child, ctx, steps)
        steps.append(
            "filter + group_by -> staged K5 stream compaction filter, "
            "aggregate sorts only survivors (R5)"
        )
        pred = child.predicate

        def run_staged():
            from partitionedhashjoin_tpu_torch.ops.aggregate import (
                filter_sort_aggregate,
                filter_sort_aggregate_staged,
            )

            t = inner()
            mask = torch.as_tensor(pred(t.keys, t.pays)).to(torch.bool)
            em = t.effective_mask()
            if em is not None:
                mask = mask & em
            staged = t.keys.dtype == torch.int32 and t.pays.dtype == torch.int32
            fn = (
                filter_sort_aggregate_staged if staged
                else filter_sort_aggregate  # staged path is int32-only
            )
            g, _ = fn(
                make_table(t.keys, t.pays),
                lambda k, p: mask,
                group_capacity=cap,
                with_distinct=wd,
            )
            return g

        return run_staged

    inner = _exec_table(child, ctx, steps)
    steps.append("group_by -> sort_aggregate (one multi-key sort)")

    def run_sort():
        from partitionedhashjoin_tpu_torch.ops.aggregate import (
            filter_sort_aggregate,
            sort_aggregate,
        )

        t = inner()
        mask = t.effective_mask()
        if mask is not None:
            g, _ = filter_sort_aggregate(
                make_table(t.keys, t.pays),
                lambda k, p: mask,
                group_capacity=cap,
                with_distinct=wd,
            )
            return g
        return sort_aggregate(
            make_table(t.keys, t.pays),
            group_capacity=cap,
            with_distinct=wd,
        )

    return run_sort


def _exec_group_mesh(node: _GroupBy, ctx: _Ctx, steps: list):
    """R6: the one-shuffle join-aggregate under a join, else the distributed
    aggregate (the combiner plan, or the row-exchange plan for COUNT
    DISTINCT)."""
    child = node.child
    cap = node.group_capacity
    wd = node.with_distinct
    mesh = ctx.mesh
    if wd and isinstance(child, _Join):
        raise PlanError(
            "mesh join->group_by(with_distinct) is not supported "
            "(hot-key probe rows stay sharded, so their payload sets "
            "never meet); compose it single-device"
        )
    if isinstance(child, _Join):
        join = child
        if (
            join.join_type != "inner"
            or not (_mesh_side_ok(join.build) and _mesh_side_ok(join.probe))
            or join.carry != "probe"
        ):
            raise PlanError(
                "mesh join->group_by supports an inner join over "
                "scan/filter sides with carry='probe' (the join "
                "exchange co-partitions the groups); compose others "
                "single-device"
            )
        build, probe = _exec_join_sides(join, ctx, steps)
        steps.append(
            "join[inner] + group_by -> one shuffle: the join exchange "
            "co-partitions the groups (filters pushed into the "
            "bucketizer); partials matched per key, combiner merge "
            "(R2, R3, R6)"
        )

        def run_mesh_join():
            from partitionedhashjoin_tpu_torch.parallel.join_aggregate import (
                DistributedJoinAggregateOperator,
            )

            b, p = build(), probe()
            return DistributedJoinAggregateOperator(mesh, seed=_MESH_SEED).run(
                make_table(b.keys, b.pays),
                make_table(p.keys, p.pays),
                group_capacity=cap,
                build_valid=b.mask,
                probe_valid=p.mask,
            )

        return run_mesh_join
    inner = _exec_table(child, ctx, steps)
    steps.append(
        "group_by -> distributed row-exchange aggregate with exact "
        "COUNT DISTINCT (payload sets meet at the owner shard) (R6)"
        if wd else
        "group_by -> distributed combiner-plan aggregate (local "
        "sort-aggregate, hash-routed partials, psum-exact) (R6)"
    )

    def run_mesh():
        from partitionedhashjoin_tpu_torch.parallel.aggregate_shuffle import (
            DistributedAggregateOperator,
        )

        t = _process_rows(inner(), mesh)
        return DistributedAggregateOperator(mesh, seed=_MESH_SEED).run(
            make_table(t.keys, t.pays), group_capacity=cap,
            mask=t.mask, with_distinct=wd,
        )

    return run_mesh


def _exec_join_group(join: _Join, gb: _GroupBy, ctx: _Ctx, steps: list):
    """R3: join → group_by without a second relation sort.

    The kernel materializer (K4) emits key-ordered, payload-ascending runs,
    so the aggregate skips its pass-1 sort entirely.  Conditions for the
    kernel path: inner join, int32 keys, no filters on either side (the
    kernel has no validity protocol); a filtered inner join over scans
    takes R7, everything else the typed materializer (probe-row order),
    whose output feeds the sorting aggregate with its validity mask."""
    build, probe = _exec_join_sides(join, ctx, steps)
    carry = join.carry
    cap = gb.group_capacity
    wd = gb.with_distinct
    kernel = (
        join.join_type == "inner"
        and _join_is_plain(join)
        and _kernel_ok(_scan_dtype(join.probe))
        and _kernel_ok(_scan_dtype(join.build))
    )

    def aggregate_runs(keys, pays, count):
        from partitionedhashjoin_tpu_torch.ops.aggregate import aggregate_sorted

        return aggregate_sorted(
            make_table(keys, pays),
            group_capacity=cap,
            n_valid=count,
            payload_sorted=True,
            with_distinct=wd,
        )

    if kernel:
        steps.append(
            "join[inner] + group_by -> kernel materializer (K4) emits "
            "(key, payload)-ordered runs; aggregate_sorted skips the "
            "relation sort (R3)"
        )

        def run_kernel():
            from partitionedhashjoin_tpu_torch.ops.merge_join import (
                two_run_materialize,
            )

            b, p = build(), probe()
            keys, pa, pb, count = two_run_materialize(
                b.keys, b.pays, p.keys, p.pays,
                # carry=="build": pay_a is constant within a key run
                # (first-match), so runs are trivially payload-ordered
                probe_payload_sorted=(carry == "probe"),
            )
            return aggregate_runs(keys, pb if carry == "probe" else pa, count)

        return run_kernel

    jt = join.join_type

    def _typed_body(b, p):
        from partitionedhashjoin_tpu_torch.ops.aggregate import (
            filter_sort_aggregate,
        )
        from partitionedhashjoin_tpu_torch.ops.sort_merge import (
            sort_merge_materialize_typed,
        )

        keys, pa, pb, matched, count = sort_merge_materialize_typed(
            b.keys, b.pays, p.keys, p.pays, jt,
            build_valid=b.effective_mask(),
            probe_valid=p.effective_mask(),
        )
        pays = pb if carry == "probe" else pa
        live = _arange(keys) < count
        g, _ = filter_sort_aggregate(
            make_table(keys, pays),
            lambda k, v: live,
            group_capacity=cap,
            with_distinct=wd,
        )
        return g

    staged = (
        jt == "inner"
        and _mesh_side_ok(join.build)
        and _mesh_side_ok(join.probe)
        and _kernel_ok(_scan_dtype(join.probe))
        and _kernel_ok(_scan_dtype(join.build))
    )
    if staged:
        # R7 = R5 ∘ R3: stage the filters OUT of the join instead of
        # masking the typed materializer.  The probe filter pays one K5
        # compaction (no relation sort), and the kernel pipeline runs on
        # the survivors: its sorts scale with selectivity and the GROUP BY
        # stays sort-free (aggregate_sorted).  K5 leaves no gaps, so the
        # probe side is exactly its survivors; invalid build rows re-key
        # to INT32_MIN, which no probe row may hold: either extreme in
        # either key column takes the typed path (one readback to check;
        # the JAX package also re-keys its gap rows to INT32_MAX).
        steps.append(
            "join[inner] + group_by -> staged: K5 stream compaction of the "
            "filtered probe, invalid build rows re-keyed to a sentinel, "
            "kernel materializer (K4) + aggregate_sorted on the survivors "
            "(R7 = R5∘R3; int32-extreme keys fall back to the typed path)"
        )

        def run_staged():
            from partitionedhashjoin_tpu_torch.ops.aggregate import _staged_filter
            from partitionedhashjoin_tpu_torch.ops.merge_join import (
                two_run_materialize,
            )

            b, p = build(), probe()

            def _has_extreme(k):
                return ((k == _I32_MAX) | (k == _I32_MIN)).any()

            if (
                b.pays.dtype != torch.int32
                or p.pays.dtype != torch.int32
                or bool(_has_extreme(b.keys) | _has_extreme(p.keys))
            ):
                return _typed_body(b, p)
            b_em, p_em = b.effective_mask(), p.effective_mask()
            bk = b.keys if b_em is None else torch.where(b_em, b.keys, _I32_MIN)
            if p_em is not None:
                total, _, keys_c, pay_c = _staged_filter(p.keys, p.pays, p_em)
                total = int(total)
                keys_s, pay_s = keys_c[:total], pay_c[:total]
            else:
                keys_s, pay_s = p.keys, p.pays
            keys, pa, pb, count = two_run_materialize(
                bk, b.pays, keys_s, pay_s,
                probe_payload_sorted=(carry == "probe"),
            )
            return aggregate_runs(keys, pb if carry == "probe" else pa, count)

        return run_staged

    steps.append(
        f"join[{jt}] + group_by -> typed materializer (masks, R2), then "
        "sorting aggregate over the compacted join output"
    )

    def run_typed():
        b, p = build(), probe()
        return _typed_body(b, p)

    return run_typed


def _scan_dtype(node):
    while isinstance(node, _Filter):
        node = node.child
    assert isinstance(node, _Scan)
    return node.table.keys.dtype


# -- group-stage order_by / limit --------------------------------------------


def _group_columns(g):
    cols = {
        "key": g.keys, "count": g.count, "sum": g.sum,
        "min": g.min, "max": g.max,
    }
    if g.distinct is not None:
        cols["distinct"] = g.distinct
    return cols


def group_top_k(
    g, k: int, by: str = "count", descending: bool = True, mask=None
):
    """Top-k groups of a GroupByResult by one aggregate column, all columns
    carried (k-sized gathers).  Exact under capacity truncation: rows past
    ``num_groups`` are force-masked before selection.  ``mask``: optional
    extra per-row validity (a HAVING predicate) ANDed in — filtered groups
    can never be selected and ``num_groups`` reflects the survivors.
    Returns a GroupByResult with ``num_groups = min(k, #valid)`` whose
    rows are in the requested order.

    COUNT-descending (the hot "top groups" shape) takes ``_top_k_indices``
    over the counts with masked rows at 0 (a valid group counts >= 1, so no
    sentinel collision exists): the JAX package's ``lax.top_k`` order, the
    lower row first among ties, with no group-table sort.  Every other
    column/direction uses the validity-dominant ordering: invalid rows lose
    the leading comparison, so no sentinel VALUE is needed at all (exact
    over the full int domain)."""
    from partitionedhashjoin_tpu_torch.ops.aggregate import GroupByResult

    cols = _group_columns(g)
    if by not in cols:
        raise PlanError(f"order_by column must be one of {tuple(cols)}")
    n = g.keys.shape[0]
    if k > n:
        k = n
    pos = _arange(g.keys)
    valid = pos < g.num_groups
    n_valid = g.num_groups
    if mask is not None:
        valid = valid & torch.as_tensor(mask).to(torch.bool)
        n_valid = valid.sum().to(torch.int32)
    if by == "count" and descending:
        idx_k = _top_k_indices(torch.where(valid, g.count, 0), k)
    else:
        ordcol = _order_col_key(cols[by], descending)  # ascending-native
        idx_k = _valid_first_order(~valid, ordcol)[:k]
    kept = torch.clamp(n_valid, max=k).to(torch.int32)
    live = pos[:k] < kept

    def take(col):
        return torch.where(live, col[idx_k], 0).to(col.dtype)

    return GroupByResult(
        keys=take(g.keys),
        count=take(g.count),
        sum=take(g.sum),
        min=take(g.min),
        max=take(g.max),
        num_groups=kept,
        # a selection result tracks no row membership (an [n_rows] column
        # here would pin relation-sized memory per result)
        group_of_row=torch.zeros((0,), dtype=torch.int32, device=g.keys.device),
        distinct=None if g.distinct is None else take(g.distinct),
    )


def _compile_group_tail(
    run_group, order, limit_k, ctx, steps, mask_fn=None
) -> _Plan:
    def tail_top_k(g, k, by, descending):
        return group_top_k(
            g, k, by=by, descending=descending,
            mask=None if mask_fn is None else mask_fn(g),
        )

    if order is None:
        # LIMIT over groups without an order: first k valid groups
        steps.append(f"limit {limit_k} -> head of the group table")

        def run_head():
            g = run_group()
            return tail_top_k(  # key order of the group layout
                g, limit_k, by="key", descending=False
            )

        return _Plan(steps, run_head)
    by, desc = order.by, order.descending
    if limit_k is None:
        steps.append(
            f"order_by {by} {'desc' if desc else 'asc'} -> full group sort "
            "(validity-dominant ordering, all columns carried)"
        )

        def run_order():
            g = run_group()
            return tail_top_k(g, g.keys.shape[0], by=by, descending=desc)

        return _Plan(steps, run_order)
    steps.append(
        f"order_by {by} {'desc' if desc else 'asc'} + limit {limit_k} -> "
        "top-k over group columns, no relation sort (R4)"
    )

    def run_topk():
        g = run_group()
        return tail_top_k(g, limit_k, by=by, descending=desc)

    return _Plan(steps, run_topk)


# ---------------------------------------------------------------------------
# count-only compilation (R1)


def _compile_count(node, ctx: _Ctx) -> _Plan:
    steps: list = []
    if _stage(node) == "group":
        plan = _compile(node, ctx)

        def run_groups():
            return plan.run().num_groups

        return _Plan(plan.steps + ["count -> num_groups"], run_groups)

    core = node
    k_limit = None
    if isinstance(core, _Limit):
        k_limit = core.k
        core = core.child
    if isinstance(core, _OrderBy):
        core = core.child  # ordering does not change the count

    if isinstance(core, _Join):
        run = _count_join(core, ctx, steps)
    else:
        inner = _exec_table(core, ctx, steps)
        steps.append("count -> mask popcount (no materialization, R1)")

        def run():
            t = inner()
            if not t.local:
                return t.count()
            from partitionedhashjoin_tpu_torch.parallel.mesh import check_local_rows, psum

            check_local_rows([t.keys.shape[0]], ctx.mesh)
            return psum(t.count()[None], ctx.mesh)

    if k_limit is None:
        return _Plan(steps, run)
    steps.append(f"count -> min(count, limit {k_limit})")
    return _Plan(steps, lambda: torch.clamp(run(), max=k_limit))


def _count_join_mesh(node: _Join, ctx: _Ctx, steps: list):
    """R6: the shuffle join's count, filters pushed into its exchange."""
    if node.join_type not in ("inner", "semi") or not (
        _mesh_side_ok(node.build) and _mesh_side_ok(node.probe)
    ):
        raise PlanError(
            "mesh join counts support inner/semi joins over "
            "scan/filter sides (the shuffle join); compose others "
            "single-device"
        )
    build, probe = _exec_join_sides(node, ctx, steps)
    steps.append(
        "count join[inner] -> distributed shuffle join "
        "(all_to_all exchange, hot-key replication, filters pushed "
        "into the bucketizer, psum count) (R1, R2, R6)"
    )
    mesh = ctx.mesh

    def run_mesh():
        from partitionedhashjoin_tpu_torch.parallel.shuffle import (
            DistributedShuffleJoiner,
        )

        b, p = build(), probe()
        count = DistributedShuffleJoiner(mesh, seed=_MESH_SEED).run(
            make_table(b.keys, b.pays),
            make_table(p.keys, p.pays),
            valid_a=b.effective_mask(),
            valid_b=p.effective_mask(),
        )
        return torch.tensor(count, dtype=torch.int64, device=mesh.device)

    return run_mesh


def _count_join(node: _Join, ctx: _Ctx, steps: list):
    jt = node.join_type
    if ctx.mesh is not None:
        return _count_join_mesh(node, ctx, steps)
    build, probe = _exec_join_sides(node, ctx, steps)
    steps.append(
        f"count join[{jt}] -> count kernel with validity masks, "
        "nothing materialized (R1)"
    )

    def run():
        from partitionedhashjoin_tpu_torch.ops.merge_join import two_run_count
        from partitionedhashjoin_tpu_torch.ops.sort_merge import (
            anti_count,
            sort_merge_count,
        )

        b, p = build(), probe()
        b_em, p_em = b.effective_mask(), p.effective_mask()

        def match_count():
            if _kernel_ok(b.keys.dtype) and _kernel_ok(p.keys.dtype):
                return two_run_count(
                    b.keys, p.keys, build_valid=b_em, probe_valid=p_em
                )
            return sort_merge_count(
                b.keys, p.keys, build_valid=b_em, probe_valid=p_em
            )

        if jt in ("inner", "semi"):
            return match_count()
        if jt == "anti":
            return anti_count(
                b.keys, p.keys, build_valid=b_em, probe_valid=p_em
            )
        if jt == "left":
            return p.count()
        # full: valid probe rows + unmatched valid build rows
        return p.count() + anti_count(
            p.keys, b.keys, build_valid=p_em, probe_valid=b_em
        )

    return run
