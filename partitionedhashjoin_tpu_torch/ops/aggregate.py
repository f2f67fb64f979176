"""GROUP BY key with COUNT / SUM / MIN / MAX: the hash and the sort family.

Counterpart of ``partitionedhashjoin_tpu/ops/aggregate.py``.

**Hash family** (``hash_aggregate``, ``filter_aggregate``): the dedup claim
loop (``ops/hash_table.build_dedup_hash_table``) maps every row to its key's
representative, the key's smallest valid row id, in rounds set by
distinct-key collisions, not by duplication.  Representatives are numbered
in row order, so groups come in the order of their keys' first valid rows;
COUNT and SUM are ``index_add_`` and MIN/MAX ``scatter_reduce`` with
``include_self`` over the dtype's max/min onto the group vector.  Outputs
are ``n`` long with JAX's fill values past ``num_groups`` (0 for keys,
counts and sums, the dtype's max for MIN, its min for MAX).  A filter's
rejected rows are never inserted and join no group.

**Sort family**: one sort puts every group in a contiguous run ordered by
(valid, key, payload), so the run starts give the groups and everything
else falls out of prefix sums:

  pass 1   one sort on (key, payload), valid rows first (skipped by
           ``aggregate_sorted``, whose input is already in key order):
           for int32 keys and payloads K6 on the JAX package's tuple
           (invalid flag, key, payload[, row]), the flag left out when
           there is no validity mask; for wider columns the packed (key,
           payload) library sort
  pass 2   the run-start rows compacted to the front, carrying key, MIN
           (the payload at the start), the exclusive payload cumsum and the
           previous row's payload (the MAX of the group before) — through
           the stream-compaction kernel K5 (``ops/kernels/compact.py``) or
           its plain version
  count    S_{g+1} - S_g from the compacted start positions
  sum      csx[S_{g+1}] - csx[S_g], in the payload dtype

Group order is key-ascending.  Outputs are ``group_capacity`` long; the
valid prefix is ``[0, num_groups)``, and ``num_groups`` is exact even when
it exceeds the capacity (retry with a larger one).

Integer SUMs wrap like the JAX package's (mod 2^32 for int32 payloads) in
both families: they accumulate in int64 and are cast back to the payload
dtype with ``_wrap``, so sums, and the GROUP BY results built from them,
are bit-identical to JAX's even for groups whose sum overflows.  Float sums
are taken in another order than JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from partitionedhashjoin_tpu_torch.data.table import Table
from partitionedhashjoin_tpu_torch.ops import filter as filter_ops
from partitionedhashjoin_tpu_torch.ops import hash_table as ht
from partitionedhashjoin_tpu_torch.ops.sort import sort_by_key_payload
from partitionedhashjoin_tpu_torch.ops.kernels import bitonic_sort
from partitionedhashjoin_tpu_torch.ops.kernels import compact as kcompact


def masked_mean(count, total, dtype=torch.float32) -> torch.Tensor:
    """The engine's AVG convention: sum/count where count > 0, else 0."""
    c = torch.clamp(count, min=1).to(dtype)
    zero = torch.zeros((), dtype=dtype, device=count.device)
    return torch.where(count > 0, total.to(dtype) / c, zero)


@dataclasses.dataclass
class GroupByResult:
    """GROUP BY output: per-group key and aggregates, valid in
    ``[0, num_groups)``.  ``count`` and ``num_groups`` are int32, as in the
    JAX package; ``sum``/``min``/``max`` have the payload dtype."""

    keys: torch.Tensor
    count: torch.Tensor
    sum: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor
    num_groups: torch.Tensor
    #: int32[n] dense group id per input row (-1: invalid row, or a path that
    #: does not track membership)
    group_of_row: torch.Tensor
    #: COUNT(DISTINCT payload) per group, only with ``with_distinct=True``
    distinct: Optional[torch.Tensor] = None

    def mean(self, dtype=torch.float32) -> torch.Tensor:
        """AVG(payload) per group: sum/count where count > 0, else 0."""
        return masked_mean(self.count, self.sum, dtype)


def _group_and_aggregate(keys, payloads, seed, size, valid=None,
                         has_valid=False) -> GroupByResult:
    """The hash GROUP BY over a dedup table of ``size`` slots: outputs of
    ``n`` rows, groups in the order of their keys' first valid rows."""
    n = keys.shape[0]
    device = keys.device
    _, rep_row = ht.build_dedup_hash_table(keys, seed, size, valid=valid,
                                           has_valid=has_valid)
    # every rep_row value is a row that owns its slot, and an owner is its
    # own representative, so the rows JAX flags by scattering 1 at each
    # row's rep_row are exactly the rows with rep_row[i] == i
    is_rep = rep_row == torch.arange(n, dtype=torch.int32, device=device)
    dense = torch.cumsum(is_rep, 0, dtype=torch.int32) - is_rep.to(torch.int32)
    valid_row = rep_row >= 0
    group_of_row = torch.where(
        valid_row, dense.index_select(0, torch.clamp(rep_row, min=0)), -1)
    # only rows of a group scatter (JAX drops the others into a dump slot,
    # which on the card would serialize every rejected row on one address)
    rows = torch.nonzero(valid_row).squeeze(1)
    gid = group_of_row[rows].to(torch.int64)
    pay = payloads[rows]

    def scatter(fill, dtype, values, reduce):
        out = torch.full((n,), fill, dtype=dtype, device=device)
        if reduce == "sum":
            return out.index_add_(0, gid, values)
        return out.scatter_reduce_(0, gid, values, reduce)

    count = scatter(0, torch.int32, torch.ones_like(gid, dtype=torch.int32), "sum")
    pdt = payloads.dtype
    if pdt.is_floating_point:
        sum_ = scatter(0, pdt, pay, "sum")
        info = torch.finfo(pdt)
    else:
        # int64 accumulation, wrapped back: int32 sums wrap mod 2^32 as
        # JAX's scatter-add does
        sum_ = _wrap(scatter(0, torch.int64, pay.to(torch.int64), "sum"), pdt)
        info = torch.iinfo(pdt)
    group_keys = torch.zeros((n,), dtype=keys.dtype, device=device)
    reps = torch.nonzero(is_rep).squeeze(1)
    group_keys[: reps.shape[0]] = keys[reps]
    return GroupByResult(
        keys=group_keys,
        count=count,
        sum=sum_,
        min=scatter(info.max, pdt, pay, "amin"),
        max=scatter(info.min, pdt, pay, "amax"),
        num_groups=is_rep.sum(dtype=torch.int32),
        group_of_row=group_of_row,
    )


def hash_aggregate(table: Table, seed: int = 0) -> GroupByResult:
    """GROUP BY ``table.keys``, aggregating ``table.payloads``, through the
    dedup hash table."""
    return _group_and_aggregate(table.keys, table.payloads, seed & 0xFFFFFFFF,
                                ht.table_size_for(table.size))


def filter_aggregate(table: Table, predicate, seed: int = 0):
    """Filter → hash-aggregate pipeline (BASELINE.json configs[3]): rows
    failing ``predicate(keys, payloads)`` are never inserted into the dedup
    table and join no group, so no filtered table is
    materialized.  Returns ``(GroupByResult of the selected rows,
    selected_row_count)``; ``group_of_row`` is -1 for filtered-out rows."""
    mask = predicate(table.keys, table.payloads).to(torch.bool)
    g = _group_and_aggregate(
        table.keys, table.payloads, seed & 0xFFFFFFFF,
        ht.table_size_for(table.size), valid=mask, has_valid=True,
    )
    return g, mask.sum()


def _wrap(values: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 ``values`` as ``dtype``, wrapping like two's-complement
    arithmetic in that width (exact for int64 and floats)."""
    if dtype in (torch.int8, torch.int16, torch.int32, torch.uint8):
        bits = torch.iinfo(dtype).bits
        half = 2 ** (bits - 1) if dtype.is_signed else 0
        values = ((values + half) & (2**bits - 1)) - half
    return values.to(dtype)


def _cumsum(values: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum in int64 (floats: in their own dtype)."""
    if values.dtype.is_floating_point:
        return torch.cumsum(values, 0)
    return torch.cumsum(values, 0, dtype=torch.int64)


def _empty(group_capacity, payloads, n, num_groups, with_distinct):
    device = payloads.device
    gz = torch.zeros((group_capacity,), dtype=torch.int32, device=device)
    pz = torch.zeros((group_capacity,), dtype=payloads.dtype, device=device)
    return GroupByResult(
        keys=gz, count=gz, sum=pz, min=pz, max=pz,
        num_groups=num_groups.to(torch.int32),
        group_of_row=torch.full((n,), -1, dtype=torch.int32, device=device),
        distinct=gz if with_distinct else None,
    )


def _compact_starts(is_start, columns, group_capacity, kernel_compaction):
    """Pass 2: ``(s_full, *compacted)``, the start rows' positions and
    columns at the front of ``group_capacity + 1``-long arrays (the slot past
    the capacity serves ``_shift``); slots past ``num_groups`` hold no
    group and are masked by every reader.  The kernel path runs K5 with no
    zero fill; the other its plain version, which takes any dtype."""
    out_len = group_capacity + 1
    if kernel_compaction:
        _, s_full, *outs = kcompact.compact_rows(
            is_start, columns, out_len, zero_tail=False
        )
    else:
        _, s_full, *outs = kcompact.compact_plain(is_start, columns, out_len)
    return (s_full, *outs)


def _shift(col: torch.Tensor, cap: int) -> torch.Tensor:
    """``col[g + 1]`` for each group slot g < cap (read where a next group
    exists)."""
    return torch.cat([col[1 : cap + 1], col[:1]])[:cap]


def _counts_and_sums(cap, num_groups, n_valid, valid_s, pay_s, s_full, gcsx):
    """``(g_ok, has_next, count, sum)`` per group slot from the compacted
    start positions ``s_full`` and exclusive payload cumsums ``gcsx``: a
    group ends where the next one starts (the last at ``n_valid``)."""
    g = torch.arange(cap, device=s_full.device)
    g_ok = g < num_groups
    has_next = g + 1 < num_groups
    e_excl = torch.where(has_next, _shift(s_full, cap).to(torch.int64), n_valid)
    count = torch.where(g_ok, e_excl - s_full[:cap].to(torch.int64), 0)
    acc = _cumsum(pay_s[:0]).dtype  # int64, or the float payload dtype
    total_valid = _wrap(torch.where(valid_s, pay_s, 0).sum(dtype=acc), pay_s.dtype)
    sum_hi = torch.where(has_next, _shift(gcsx, cap), total_valid)
    sum_ = _wrap(sum_hi.to(acc) - gcsx[:cap].to(acc), pay_s.dtype)
    return g_ok, has_next, count.to(torch.int32), _live(sum_, g_ok)


def _live(col: torch.Tensor, g_ok: torch.Tensor) -> torch.Tensor:
    """``col`` with the slots past the last group zeroed."""
    return torch.where(g_ok, col, 0).to(col.dtype)


def _sort_group_and_aggregate(
    keys: torch.Tensor,
    payloads: torch.Tensor,
    group_capacity: int,
    valid: Optional[torch.Tensor] = None,
    with_group_of_row: bool = False,
    kernel_compaction: bool = False,
    with_distinct: bool = False,
    presorted: bool = False,
) -> GroupByResult:
    """GROUP BY over one (valid, key, payload) order; see the module note.

    ``presorted``: the caller asserts the rows are already in that order
    (valid rows a prefix, keys ascending in it, payloads ascending within
    each key run), so pass 1 is skipped.  Otherwise pass 1 runs through K6
    when keys and payloads are int32, through the library sort when not."""
    n = keys.shape[0]
    device = keys.device
    pdt = payloads.dtype
    if n == 0:
        return _empty(group_capacity, payloads, n,
                      torch.zeros((), device=device), with_distinct)
    rank = torch.arange(n, device=device)
    if presorted:
        key_s, pay_s, row_s = keys, payloads, rank
        valid_s = valid
    elif keys.dtype == torch.int32 and pdt == torch.int32:
        # full-lex tuple order == (invalid, key, payload) order; the row
        # operand only orders bit-identical (key, payload) rows, which
        # share a group.  With no mask the invalid flag is left out: each
        # operand costs a full read and write per merge pass
        ops = [keys.contiguous(), payloads.contiguous()]
        if valid is not None:
            ops.insert(0, (~valid.to(torch.bool)).to(torch.int32))
        if with_group_of_row:
            ops.append(rank.to(torch.int32))
        out = bitonic_sort.sort_i32_tuple(*ops)
        valid_s = None if valid is None else out.pop(0) == 0
        key_s, pay_s, *row = out
        row_s = row[0].to(torch.int64) if row else None
    else:
        row_s, key_s, pay_s = sort_by_key_payload(keys, payloads)
        valid_s = None
        if valid is not None:
            # valid rows to the front, each part keeping its sorted order
            n_valid, to = filter_ops.partition_positions(valid.to(torch.bool)[row_s])
            row_s, key_s, pay_s = (
                torch.empty_like(c).scatter_(0, to, c) for c in (row_s, key_s, pay_s)
            )
            valid_s = rank < n_valid
    if valid_s is None:
        valid_s = torch.ones((n,), dtype=torch.bool, device=device)
    n_valid = valid_s.sum()

    prev_key = torch.cat([key_s[:1], key_s[:-1]])
    is_start = valid_s & ((rank == 0) | (key_s != prev_key))
    num_groups = is_start.sum()
    if group_capacity == 0:
        # num_groups stays exact: the capacity-overflow retry contract
        return _empty(0, payloads, n, num_groups, with_distinct)

    cs = _cumsum(pay_s)
    csx = _wrap(cs - pay_s.to(cs.dtype), pdt)
    maxprev = torch.cat([pay_s[:1], pay_s[:-1]])
    carried = [key_s, pay_s, csx, maxprev]
    if with_distinct:
        # payloads ascend within each group, so COUNT(DISTINCT payload) is
        # the number of (group, payload) run starts
        pair_start = (valid_s & (is_start | (pay_s != maxprev))).to(torch.int32)
        cpx_d = (torch.cumsum(pair_start, 0) - pair_start).to(torch.int32)
        total_pairs = pair_start.sum()
        carried.append(cpx_d)
    s_full, gkey, gmin, gcsx, gmaxp, *rest = _compact_starts(
        is_start, carried, group_capacity, kernel_compaction
    )

    cap = group_capacity
    g_ok, has_next, count, sum_ = _counts_and_sums(
        cap, num_groups, n_valid, valid_s, pay_s, s_full, gcsx
    )
    # the group's MAX is the payload just before the next group's start
    last_valid_pay = pay_s[(n_valid - 1).clamp(min=0)]
    max_ = torch.where(has_next, _shift(gmaxp, cap), last_valid_pay)
    distinct = None
    if with_distinct:
        d_hi = torch.where(has_next, _shift(rest[0], cap).to(torch.int64),
                           total_pairs)
        distinct = _live((d_hi - rest[0][:cap]).to(torch.int32), g_ok)

    group_of_row = torch.full((n,), -1, dtype=torch.int32, device=device)
    if with_group_of_row:
        # dense id of each sorted row, scattered back to its input position
        gid_s = torch.cumsum(is_start, 0, dtype=torch.int64) - 1
        gid_s = torch.where(valid_s, gid_s, -1).to(torch.int32)
        group_of_row = group_of_row.scatter_(0, row_s, gid_s)
    return GroupByResult(
        keys=_live(gkey[:cap], g_ok),
        count=count,
        sum=sum_,
        min=_live(gmin[:cap], g_ok),
        max=_live(max_, g_ok),
        num_groups=num_groups.to(torch.int32),
        group_of_row=group_of_row,
        distinct=distinct,
    )


def _aggregate_sorted_impl(
    keys: torch.Tensor,
    payloads: torch.Tensor,
    group_capacity: int,
    n_valid=None,
    kernel_compaction: bool = False,
) -> GroupByResult:
    """GROUP BY over key-ascending rows whose payloads are in no order within
    a key run: COUNT and SUM as in ``_sort_group_and_aggregate``, MIN and
    MAX by ``scatter_reduce`` over the dense group ids (the JAX package uses
    two-level segmented suffix scans, a TPU compile workaround)."""
    n = keys.shape[0]
    device = keys.device
    pdt = payloads.dtype
    if n == 0:
        return _empty(group_capacity, payloads, n,
                      torch.zeros((), device=device), False)
    rank = torch.arange(n, device=device)
    if n_valid is None:
        n_valid = torch.tensor(n, device=device)
    n_valid = torch.as_tensor(n_valid, device=device).to(torch.int64)
    valid_s = rank < n_valid
    prev_key = torch.cat([keys[:1], keys[:-1]])
    is_start = valid_s & ((rank == 0) | (keys != prev_key))
    num_groups = is_start.sum()
    if group_capacity == 0:
        return _empty(0, payloads, n, num_groups, False)

    cs = _cumsum(payloads)
    csx = _wrap(cs - payloads.to(cs.dtype), pdt)
    # group id per valid row; invalid rows go to the dump slot n
    gid = torch.where(valid_s, torch.cumsum(is_start, 0) - 1, n)
    info = torch.finfo(pdt) if pdt.is_floating_point else torch.iinfo(pdt)
    gmin = torch.full((n + 1,), info.max, dtype=pdt, device=device)
    gmin = gmin.scatter_reduce_(0, gid, payloads, "amin")
    gmax = torch.full((n + 1,), info.min, dtype=pdt, device=device)
    gmax = gmax.scatter_reduce_(0, gid, payloads, "amax")
    s_full, gkey, gcsx = _compact_starts(
        is_start, [keys, csx], group_capacity, kernel_compaction
    )

    cap = group_capacity
    g_ok, _, count, sum_ = _counts_and_sums(
        cap, num_groups, n_valid, valid_s, payloads, s_full, gcsx
    )
    return GroupByResult(
        keys=_live(gkey[:cap], g_ok),
        count=count,
        sum=sum_,
        min=_live(gmin[:cap], g_ok),
        max=_live(gmax[:cap], g_ok),
        num_groups=num_groups.to(torch.int32),
        group_of_row=torch.full((n,), -1, dtype=torch.int32, device=device),
    )


def _kernel_compaction_choice(table: Table, compaction: str) -> bool:
    """Resolve the pass-2 compaction: "auto" takes K5 for int32 keys and
    payloads on a CUDA tensor and K5's plain version otherwise; "sort"
    forces the plain version, "kernel" forces K5 (its plain version on a
    CPU tensor) and raises ``TypeError`` for wider columns, which the 32-bit
    kernel would truncate."""
    if compaction not in ("auto", "sort", "kernel"):
        raise ValueError(f"unknown compaction {compaction!r}")
    if compaction == "sort":
        return False
    int32 = table.keys.dtype == torch.int32 and table.payloads.dtype == torch.int32
    if compaction == "kernel":
        if not int32:
            raise TypeError(
                "compaction='kernel' is int32-only (keys "
                f"{table.keys.dtype}, payloads {table.payloads.dtype}); "
                "use compaction='sort' for wider columns"
            )
        return True
    return int32 and table.keys.device.type == "cuda"


def _capacity(table: Table, group_capacity: Optional[int]) -> int:
    return table.size if group_capacity is None else min(group_capacity, table.size)


def aggregate_sorted(
    table: Table,
    group_capacity: Optional[int] = None,
    n_valid=None,
    compaction: str = "auto",
    check: bool = False,
    payload_sorted: bool = False,
    with_distinct: bool = False,
) -> GroupByResult:
    """Order-propagating GROUP BY: aggregate a table whose keys ALREADY
    ascend, with no pass-1 sort (the materialized join emits sorted-key
    order, so join → GROUP BY never sorts the relation twice).

    - ``payload_sorted=True``: payloads also ascend within each key run
      (``two_run_materialize(probe_payload_sorted=True)``); MIN/MAX/COUNT
      DISTINCT come from the run boundaries, as in ``sort_aggregate``.
    - default: payloads within a run are in any order; COUNT DISTINCT is
      refused.

    ``n_valid``: the number of leading valid rows (an int or a 0-dim
    tensor; rows past it are ignored, e.g. the materializer's zero tail).
    ``check=True`` verifies the order over the valid prefix with one
    readback and raises ``ValueError`` on a violation.
    """
    n = table.size
    device = table.keys.device
    if check and n:
        k = table.keys
        asc = k[1:] >= k[:-1]
        if payload_sorted:
            p = table.payloads
            asc = (k[1:] > k[:-1]) | ((k[1:] == k[:-1]) & (p[1:] >= p[:-1]))
        if n_valid is not None:
            limit = torch.as_tensor(n_valid, device=device)
            asc = asc | (torch.arange(1, n, device=device) >= limit)
        if not bool(asc.all()):
            raise ValueError(
                "aggregate_sorted: keys (or payload runs, with "
                "payload_sorted) are not ascending over the valid prefix"
            )
    cap = _capacity(table, group_capacity)
    kernel = _kernel_compaction_choice(table, compaction)
    if payload_sorted:
        valid = None
        if n_valid is not None:
            valid = torch.arange(n, device=device) < torch.as_tensor(
                n_valid, device=device
            )
        return _sort_group_and_aggregate(
            table.keys, table.payloads, cap, valid=valid,
            kernel_compaction=kernel, with_distinct=with_distinct,
            presorted=True,
        )
    if with_distinct:
        raise ValueError(
            "with_distinct needs payload-ordered runs: pass "
            "payload_sorted=True (or use sort_aggregate)"
        )
    return _aggregate_sorted_impl(
        table.keys, table.payloads, cap, n_valid=n_valid,
        kernel_compaction=kernel,
    )


def sort_aggregate(
    table: Table,
    group_capacity: Optional[int] = None,
    with_group_of_row: bool = False,
    compaction: str = "auto",
    with_distinct: bool = False,
) -> GroupByResult:
    """GROUP BY via one sort — the at-scale aggregate path.

    ``group_capacity`` bounds the group-indexed outputs (default: the table
    size); ``num_groups`` is always exact, and when it exceeds the capacity
    the per-group arrays are truncated and the caller retries with a larger
    one.  ``compaction`` selects pass 2 (``_kernel_compaction_choice``).
    """
    return _sort_group_and_aggregate(
        table.keys, table.payloads, _capacity(table, group_capacity),
        with_group_of_row=with_group_of_row,
        kernel_compaction=_kernel_compaction_choice(table, compaction),
        with_distinct=with_distinct,
    )


def filter_sort_aggregate(
    table: Table,
    predicate,
    group_capacity: Optional[int] = None,
    with_group_of_row: bool = False,
    compaction: str = "auto",
    with_distinct: bool = False,
):
    """Filter → sort-aggregate: the predicate's mask becomes the validity of
    the GROUP BY (valid rows sort first), so no filtered table is
    materialized.  Returns ``(GroupByResult, selected_row_count)``."""
    mask = predicate(table.keys, table.payloads).to(torch.bool)
    g = _sort_group_and_aggregate(
        table.keys, table.payloads, _capacity(table, group_capacity),
        valid=mask, with_group_of_row=with_group_of_row,
        kernel_compaction=_kernel_compaction_choice(table, compaction),
        with_distinct=with_distinct,
    )
    return g, mask.sum()


def _staged_filter(keys, payloads, mask):
    """Dispatch 1 of the staged pipeline: ``(count, pos, keys_c, pay_c)``,
    (keys, payloads) compacted by the mask through K5 (its plain version on
    a CPU tensor); rows past ``count`` are undefined."""
    return kcompact.compact_rows(
        mask, [keys, payloads], keys.shape[0], zero_tail=False
    )


def _staged_pass2(total, keys_c, pay_c, n_orig, group_capacity,
                  kernel_compaction, with_distinct=False):
    """Dispatch 2: aggregate exactly the ``total`` compacted rows."""
    g = _sort_group_and_aggregate(
        keys_c[:total], pay_c[:total], group_capacity,
        kernel_compaction=kernel_compaction, with_distinct=with_distinct,
    )
    # group_of_row keeps its [n_orig] shape, all -1 (not tracked here)
    g.group_of_row = torch.full((n_orig,), -1, dtype=torch.int32,
                                device=keys_c.device)
    return g


def filter_sort_aggregate_staged(
    table: Table,
    predicate,
    group_capacity: Optional[int] = None,
    compaction: str = "auto",
    slice_granularity: int = 16,
    with_distinct: bool = False,
):
    """Filter → GROUP BY in two dispatches, so the relation sort only touches
    the rows that survive the filter: K5 shrinks the data first, the
    survivor count is read back, and the aggregate runs over exactly those
    rows.  Same aggregates as ``filter_sort_aggregate``.  int32 columns
    only; ``group_of_row`` is all -1.  ``slice_granularity`` is accepted for
    the JAX signature and unused: JAX buckets the slice only to bound its
    compiled shapes.  Returns ``(GroupByResult, selected_row_count)``."""
    if table.keys.dtype != torch.int32 or table.payloads.dtype != torch.int32:
        raise TypeError(
            "staged filter aggregate is int32-only (keys "
            f"{table.keys.dtype}, payloads {table.payloads.dtype}); "
            "use filter_sort_aggregate for wider columns"
        )
    mask = predicate(table.keys, table.payloads).to(torch.bool)
    count, _, keys_c, pay_c = _staged_filter(table.keys, table.payloads, mask)
    g = _staged_pass2(
        int(count), keys_c, pay_c, table.size,
        _capacity(table, group_capacity),
        kernel_compaction=_kernel_compaction_choice(table, compaction),
        with_distinct=with_distinct,
    )
    return g, count
