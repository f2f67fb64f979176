"""Distributed GROUP BY over a mesh of shards: the combiner plan.

Counterpart of ``partitionedhashjoin_tpu/parallel/aggregate_shuffle.py``,
with the same names, seeds, capacities and retries.  Hash-routing every ROW
to its key's owner shard would move the whole relation and send a Zipf
head's rows to one shard, so the plan has two levels:

  1. **local combiner**: each shard aggregates its own valid rows with the
     sort GROUP BY (``ops/aggregate._sort_group_and_aggregate``): one partial
     (key, count, sum, min, max) per distinct key per shard, in
     ``cap_local`` slots, ``num_groups`` exact when it overflows them;
  2. **partial exchange**: the partials (never rows) go to their key's owner
     shard ``hash32(key, seed) & (S - 1)`` (K7 on the card) through the
     shuffle join's ``_bucketize`` and the mesh's ``all_to_all``, so a hot
     key is ONE partial per shard whatever its row count;
  3. **local merge**: each owner merges what it received: counts and sums
     add, mins and maxes fold.  Owners hold disjoint keys, so the gathered
     groups are the global result.

Three counters guard the three capacities (local groups, exchange buckets,
merged groups); any overflow grows the capacity that overflowed and the
run retries, so results are exact.  Keys and payloads are int32; sums wrap
mod 2^32 as on one device.  ``with_distinct=True`` takes the row-exchange
plan instead (``_row_exchange_aggregate``): per-shard distinct counts cannot
be merged, so rows travel to their key's owner and one distinct aggregate
runs there.

Where the port departs from the JAX module (the results are the same):

- The merge folds MIN/MAX with ``scatter_reduce`` over each key's run of
  received partials (at most S per key), where JAX runs two segmented
  suffix scans; no ``torch.cummax`` runs (on CUDA it scans one long row in
  one thread block).
- The combiner (``_combine``) compacts a shard's valid rows with K5 first
  and aggregates only those, where JAX sorts every slot with a validity
  flag.  Its pass-2 compaction runs K5 on the card and its sort is K6, as
  ``sort_aggregate``'s is; JAX pins its plain compaction and XLA's sort
  inside ``shard_map``.
  ``mesh.gather_prefixes`` compacts with K5 on the card (JAX: ``compact_sort``).
- The shards share one device (``parallel/mesh.py``): the combiners and
  merges run in a loop over a process's shards, the routing once over its
  ``(local_size, cap_local)`` partials.
- ``last_run`` records each attempt's counters and the exchange bytes.

On a mesh over several processes (``parallel/distributed.py``) every
process passes its own rows (``host_slice``'s layout, the same count in
every process, else ``ValueError`` in every process) and gets the global
result, equal bit for bit to one process's run on the concatenated rows:
the owner hash takes the global S, the three overflow counters are
``pmax`` / ``psum``'d so that every process retries or none does, and the
merged groups are gathered (``mesh.gather_prefixes``), so that the result is
replicated as JAX's ``out_specs=P()`` says.  ``seed=None`` raises there:
each process would draw its own.
"""

from __future__ import annotations

from typing import Optional

import torch

from partitionedhashjoin_tpu_torch.data.table import Table
from partitionedhashjoin_tpu_torch.ops.aggregate import (
    GroupByResult,
    _sort_group_and_aggregate,
    _wrap,
)
from partitionedhashjoin_tpu_torch.ops.kernels import compact as kcompact
from partitionedhashjoin_tpu_torch.parallel.mesh import (
    Mesh,
    all_to_all,
    gather_prefixes,
    local_rows,
    pmax,
    psum,
)
from partitionedhashjoin_tpu_torch.parallel.shuffle import (
    ROW_SLOT_BYTES,
    ExchangeRun,
    _bucketize,
    _owner_shard,
    _random_seed,
)
from partitionedhashjoin_tpu_torch.utils.logger import get_new_logger

_MASK = 0xFFFFFFFF
_I32 = torch.iinfo(torch.int32)
_FIELDS = ("keys", "count", "sum", "min", "max")
#: bytes of one exchange slot: a partial's five int32 columns and its valid
#: flag (the distinct plan's row slots: key, payload, valid)
PARTIAL_SLOT_BYTES = 21


def _combiner_options(device: torch.device) -> dict:
    """The local aggregate's pass-2 compaction, as ``sort_aggregate`` picks
    it for int32 columns: K5 on the card.  Pass 1 sorts the int32 columns
    through K6."""
    return {"kernel_compaction": device.type == "cuda"}


def _combine(keys, pays, valid, cap: int, opts: dict, with_distinct: bool = False):
    """One shard's combiner: the sort GROUP BY of its valid rows in ``cap``
    group slots.  K5 (its plain version on a CPU tensor) first moves the
    valid rows to the front (their count is read back), so the sort skips
    the invalid slots: the exchange leaves about half of every shard's
    received slots empty at slack 2."""
    count, _, k, p = kcompact.compact_rows(valid, [keys, pays], keys.shape[0],
                                           zero_tail=False)
    n = int(count)
    return _sort_group_and_aggregate(k[:n], p[:n], cap, with_distinct=with_distinct,
                                     **opts)


def _a2a(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Per-shard send buffers ``(local_size, S * C)`` swapped: local shard
    j's row holds its bucket of every source shard, in global source
    order."""
    lsz = mesh.local_size
    return all_to_all(x.reshape(lsz, mesh.size, -1), mesh).reshape(lsz, -1)


def _merge_partials(key, cnt, sm, mn, mx, valid, cap: int):
    """Merge received partials that share a key: counts and sums ADD,
    mins and maxes FOLD.  The valid slots (``nonzero``, one readback) are
    sorted by key, so each key's partials form one run; each run start
    numbers a group, and ``index_add_`` / ``scatter_reduce_`` fold each run
    into its group's slot.

    Returns ``(gkey, gcnt, gsum, gmin, gmax, num_groups)``: ``cap``-long
    int32 columns, key-ascending, zero past ``num_groups`` (an int, exact
    when it exceeds ``cap``)."""
    device = key.device

    def zeros(dtype=torch.int32):
        return torch.zeros((cap,), dtype=dtype, device=device)

    live = torch.nonzero(valid.to(torch.bool)).squeeze(1)
    if live.numel() == 0:
        return (*(zeros() for _ in _FIELDS), 0)
    order = live[torch.sort(key[live]).indices]
    key_s = key[order]
    is_start = torch.ones_like(key_s, dtype=torch.bool)
    is_start[1:] = key_s[1:] != key_s[:-1]
    gid = torch.cumsum(is_start, 0) - 1
    num_groups = int(gid[-1]) + 1
    rows = order
    if num_groups > cap:  # truncated: the groups past cap are not kept
        keep = gid < cap
        rows, gid = order[keep], gid[keep]
    kept = min(num_groups, cap)
    gkey = zeros()
    gkey[:kept] = key_s[is_start][:kept]
    gcnt = zeros(torch.int64).index_add_(0, gid, cnt[rows].to(torch.int64))
    gsum = zeros(torch.int64).index_add_(0, gid, sm[rows].to(torch.int64))
    g_ok = torch.arange(cap, device=device) < kept

    def fold(values, fill, reduce):
        folded = torch.full((cap,), fill, dtype=torch.int32, device=device)
        folded.scatter_reduce_(0, gid, values[rows], reduce)
        return torch.where(g_ok, folded, 0).to(torch.int32)

    return (gkey, gcnt.to(torch.int32), _wrap(gsum, torch.int32),
            fold(mn, _I32.max, "amin"), fold(mx, _I32.min, "amax"), num_groups)


def _route_and_merge_partials(mesh: Mesh, cols, p_valid, seed, cap_x: int,
                              cap_merge: int):
    """Route every local shard's partials (``cols``: key, count, sum, min,
    max, each ``(local_size, cap_local)``; ``p_valid`` marks the live ones)
    to their key's owner shard among all S, then merge what each owner
    received.  Returns the merged columns, each ``(local_size,
    cap_merge)``, the merged group counts ``m_nums`` (local_size,) int64,
    ``m_need`` (the largest over every shard, an int) and the dropped
    partials (summed over every shard, an int).  Shared by the distributed
    GROUP BY and the join → GROUP BY (``parallel/join_aggregate.py``)."""
    s = mesh.size
    dest = _owner_shard(cols[0], seed, s)
    *bucketed, bv, dropped = _bucketize(dest, p_valid, cap_x, s, *cols)
    rk, rc, rs, rmn, rmx, rv = (_a2a(x, mesh) for x in (*bucketed, bv))
    del bucketed, bv
    merged = [_merge_partials(rk[i], rc[i], rs[i], rmn[i], rmx[i], rv[i], cap_merge)
              for i in range(mesh.local_size)]
    columns = [torch.stack([m[f] for m in merged]) for f in range(5)]
    m_nums = torch.tensor([m[5] for m in merged], dtype=torch.int64,
                          device=p_valid.device)
    return (*columns, m_nums, int(pmax(m_nums, mesh)), int(psum(dropped[None], mesh)))


def _stack_groups(groups, mesh: Mesh):
    """``(columns (local_size, cap) each, num_groups (local_size,) int64,
    need)`` of per-shard GroupByResults; ``need`` is the largest
    ``num_groups`` over every shard of the mesh (an int)."""
    nums = torch.stack([g.num_groups for g in groups]).to(torch.int64)
    columns = [torch.stack([getattr(g, f) for g in groups]) for f in _FIELDS]
    return columns, nums, int(pmax(nums, mesh))


def _aggregate_exchange(mesh: Mesh, keys, pays, valid, shard_seed,
                        cap_local: int, cap_x: int, cap_merge: int):
    """Per-shard combiner aggregate, partial exchange, per-shard merge.
    Returns the merged columns (each ``(local_size, cap_merge)``), the
    merged group counts per local shard, and the exactness telemetry, each
    over every shard of the mesh: the largest combiner group count (the
    exact capacity a retry needs), the dropped partials and the largest
    merged group count."""
    lsz = mesh.local_size
    opts = _combiner_options(keys.device)
    k2, p2, v2 = (x.reshape(lsz, -1) for x in (keys, pays, valid))
    partials = [_combine(k2[i], p2[i], v2[i], cap_local, opts) for i in range(lsz)]
    cols, nums, local_need = _stack_groups(partials, mesh)
    del partials
    p_valid = torch.arange(cap_local, device=keys.device) < nums[:, None]
    *merged, m_nums, m_need, dropped = _route_and_merge_partials(
        mesh, cols, p_valid, shard_seed, cap_x, cap_merge)
    return (*merged, m_nums, local_need, dropped, m_need)


def _result(cols, count, n: int, distinct=None) -> GroupByResult:
    k, c, sm, mn, mx = cols
    return GroupByResult(
        keys=k, count=c, sum=sm, min=mn, max=mx,
        num_groups=count.to(torch.int32),
        group_of_row=torch.full((n,), -1, dtype=torch.int32, device=k.device),
        distinct=distinct,
    )


class DistributedAggregateOperator:
    """Mesh-parallel GROUP BY operator.

    ``run(table, group_capacity)`` returns a ``GroupByResult`` equal (as a
    key → aggregates map; group order is shard-hash order) to
    ``ops.aggregate.sort_aggregate`` on the unsharded table, on the mesh's
    device.  The table may be row-sharded already
    (``parallel.mesh.shard_table``) or anywhere else; it is placed on the
    mesh's device.  On a mesh over several processes it is this process's
    rows and the result is the global one (module docstring); its
    ``group_of_row`` has this process's rows.

    Exactness: three counters guard the three capacities (local combiner
    groups, exchange buckets, merged groups); any overflow doubles the
    corresponding slack and retries.  int32 keys/payloads (sums mod 2^32,
    matching the single-device paths bit-exactly).  ``last_run`` records
    each attempt's counters and the exchange bytes (``ExchangeRun``).
    """

    def __init__(
        self,
        mesh: Mesh,
        seed: Optional[int] = None,
        slack: float = 2.0,
        max_retries: int = 5,
    ) -> None:
        self._mesh = mesh
        self._num_shards = int(mesh.size)
        if self._num_shards & (self._num_shards - 1):
            raise ValueError("mesh size must be a power of 2")
        if seed is None:
            seed = _random_seed(mesh)
        self._shard_seed = seed & _MASK
        self._slack = slack
        self._max_retries = max_retries
        self._logger = get_new_logger("DistributedAggregate")
        self.last_run: Optional[ExchangeRun] = None

    def run(
        self,
        table: Table,
        group_capacity: Optional[int] = None,
        mask=None,
        with_distinct: bool = False,
    ) -> GroupByResult:
        """``mask``: optional per-row validity (a pushed-down FILTER, the
        query layer's R2 rule); masked-out rows are excluded exactly, via the
        same validity column that already absorbs the shard padding.

        ``with_distinct``: exact COUNT(DISTINCT payload) per group via the
        row-exchange plan (``_row_exchange_aggregate``): per-shard distinct
        counts cannot be merged, so rows (not partials) travel to their
        key's owner shard; the capacity retries absorb skew."""
        if table.keys.dtype != torch.int32 or table.payloads.dtype != torch.int32:
            raise TypeError(
                "distributed aggregate is int32-only (keys "
                f"{table.keys.dtype}, payloads {table.payloads.dtype})"
            )
        mesh = self._mesh
        s = self._num_shards
        n_rows = table.size
        n, valid, (keys, pays) = local_rows(mesh, [table.keys, table.payloads], mask)
        self.last_run = ExchangeRun(num_shards=s)
        if n == 0:
            z = torch.zeros((0,), dtype=torch.int32, device=mesh.device)
            return GroupByResult(
                keys=z, count=z, sum=z, min=z, max=z,
                num_groups=torch.zeros((), dtype=torch.int32, device=mesh.device),
                group_of_row=z,
            )
        per_shard = keys.shape[0] // mesh.local_size
        if with_distinct:
            return self._run_distinct(keys, pays, valid, n_rows, per_shard,
                                      group_capacity)
        hint = per_shard if group_capacity is None else min(group_capacity, per_shard)

        cap_local = max(16, min(hint, per_shard))
        cap_merge_floor = 16
        slack = self._slack
        for _ in range(self._max_retries):
            # exchange capacity: cap_local partials spread over s buckets
            cap_x = max(16, min(int(cap_local / s * slack + 1), cap_local))
            # merged capacity: this shard owns ~1/s of global keys; it can
            # receive at most s partials per owned key
            cap_merge = max(cap_merge_floor, min(int(cap_local * slack + 1), s * cap_x))
            mk, mc, ms, mmn, mmx, m_nums, l_need, dropped, m_need = _aggregate_exchange(
                self._mesh, keys, pays, valid, self._shard_seed,
                cap_local, cap_x, cap_merge,
            )
            self.last_run.attempts.append({
                "local_need": l_need, "cap_local": cap_local, "dropped": dropped,
                "merge_need": m_need, "cap_merge": cap_merge})
            if l_need <= cap_local and dropped == 0 and m_need <= cap_merge:
                self.last_run.exchange_bytes = s * s * cap_x * PARTIAL_SLOT_BYTES
                *cols, count = gather_prefixes(mesh, m_nums, cap_merge,
                                              mk, mc, ms, mmn, mmx)
                self._logger.info("Number of groups: %d", int(count))
                return _result(cols, count, n_rows)
            self.last_run.retries += 1
            self._logger.info(
                "capacity overflow (local need=%d/%d, dropped=%d, merge "
                "need=%d/%d) at slack %.1f; retrying",
                l_need, cap_local, dropped, m_need, cap_merge, slack,
            )
            if l_need > cap_local:
                cap_local = min(per_shard, max(l_need, cap_local * 2))
            if m_need > cap_merge:
                cap_merge_floor = max(m_need, cap_merge * 2)
            if dropped:
                slack *= 2
        raise RuntimeError(
            f"aggregate capacity overflow persisted after "
            f"{self._max_retries} retries (final slack {slack:.1f})"
        )

    def _run_distinct(self, keys, pays, valid, n: int, per_shard: int,
                      group_capacity: Optional[int]) -> GroupByResult:
        """Exact COUNT DISTINCT: row exchange + local distinct aggregate
        (see ``_row_exchange_aggregate`` for why rows must travel)."""
        s = self._num_shards
        hint = per_shard if group_capacity is None else min(group_capacity, s * per_shard)
        cap_groups = max(16, hint)
        slack = self._slack
        for _ in range(self._max_retries):
            # per-destination bucket capacity; a shard cannot send more
            # than its own rows to one destination
            cap_rows = max(16, min(int(per_shard / s * slack + 1), per_shard))
            cap_groups = min(cap_groups, s * cap_rows)
            gk, gc, gs, gmn, gmx, gd, g_nums, dropped, g_need = _row_exchange_aggregate(
                self._mesh, keys, pays, valid, self._shard_seed, cap_rows, cap_groups)
            self.last_run.attempts.append({
                "dropped": dropped, "group_need": g_need, "cap_groups": cap_groups})
            if dropped == 0 and g_need <= cap_groups:
                self.last_run.exchange_bytes = s * s * cap_rows * ROW_SLOT_BYTES
                *cols, d, count = gather_prefixes(
                    self._mesh, g_nums, cap_groups, gk, gc, gs, gmn, gmx, gd)
                self._logger.info("Number of groups: %d", int(count))
                return _result(cols, count, n, distinct=d)
            self.last_run.retries += 1
            self._logger.info(
                "distinct-plan overflow (dropped=%d, group need=%d/%d) at "
                "slack %.1f; retrying",
                dropped, g_need, cap_groups, slack,
            )
            if dropped:
                slack *= 2
            if g_need > cap_groups:
                cap_groups = max(g_need, cap_groups * 2)
        raise RuntimeError(
            f"distinct-plan capacity overflow persisted after "
            f"{self._max_retries} retries"
        )


def _row_exchange_aggregate(mesh: Mesh, keys, pays, valid, shard_seed,
                            cap_rows: int, cap_groups: int):
    """Row-exchange plan (the distinct path): hash-route ROWS to their
    key's owner shard, then one local sort-aggregate with
    ``with_distinct=True`` per shard: every group's rows (and payload
    values) meet at one shard, so distinct counts are exact by
    construction.  It moves the whole relation and a Zipf head's owner
    receives every one of its rows; the capacity retries absorb that.
    Returns the per-shard group columns (each ``(S, cap_groups)``, distinct
    last), their group counts, the dropped rows and the largest group
    count."""
    s, lsz = mesh.size, mesh.local_size
    k2, p2, v2 = (x.reshape(lsz, -1) for x in (keys, pays, valid))
    bk, bp, bv, dropped = _bucketize(_owner_shard(k2, shard_seed, s), v2,
                                     cap_rows, s, k2, p2)
    rk, rp, rv = (_a2a(x, mesh) for x in (bk, bp, bv))
    del bk, bp, bv
    opts = _combiner_options(keys.device)
    groups = [_combine(rk[i], rp[i], rv[i], cap_groups, opts, with_distinct=True)
              for i in range(lsz)]
    cols, nums, need = _stack_groups(groups, mesh)
    distinct = torch.stack([g.distinct for g in groups])
    return (*cols, distinct, nums, int(psum(dropped[None], mesh)), need)
