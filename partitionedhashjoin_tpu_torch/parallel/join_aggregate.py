"""Distributed join → GROUP BY over a mesh of shards (one shuffle, no
re-shuffle).

Counterpart of ``partitionedhashjoin_tpu/parallel/join_aggregate.py``, with
the same names, seeds, capacities and retries.  Grouping is by the join key,
and the shuffle join routes both relations by that key, so after its
exchange every cold group lives wholly on one shard.  The plan:

  1. **Exchange**: the shuffle join's ``_exchange`` as it is: cold rows to
     their owner shard, hot build rows replicated, hot probe rows local.
  2. **Local partial aggregate**: each shard aggregates ALL its probe rows
     (received cold slots and local hot rows) with the combiner's sort
     GROUP BY (``aggregate_shuffle._combine``: K5 compacts the valid rows,
     then one sort).  Matching is decided per PARTIAL, not per row: a partial
     survives when its key is in the received cold build set (one sorted
     ``searchsorted``, ``shuffle._searchsorted_member``) or in the
     replicated hot set (``shuffle._member_of_small``), the inner join's
     first-match filter at group granularity.
  3. **Partial exchange and merge**: the distributed GROUP BY's
     ``_route_and_merge_partials`` (``parallel/aggregate_shuffle.py``).

The exchange's three counters (cold buckets a and b, hot replication) and
the aggregate's three (local partial groups, partial-exchange buckets,
merged groups) guard their capacities; any overflow grows that capacity
and retries, so results are exact.

Semantics: inner join, aggregates over the PROBE payload (the query
layer's ``carry="probe"``): each probe row whose key is among the build
keys counts once, which is the single-device first-match materialize →
GROUP BY.  The combiner runs K5 and K6 as in
``parallel/aggregate_shuffle.py``; ``last_run`` records each attempt.

On a mesh over several processes every process passes its own rows of both
relations (``host_slice``'s layout, the same counts in every process) and
gets the global groups, as the distributed GROUP BY does: the exchange's
hot plan and drops are global already (``parallel/shuffle.py``), the
aggregate's counters are ``pmax`` / ``psum``'d and the merged groups
gathered (``mesh.gather_prefixes``).
"""

from __future__ import annotations

from typing import Optional

import torch

from partitionedhashjoin_tpu_torch.data.table import Table, make_table
from partitionedhashjoin_tpu_torch.ops.aggregate import GroupByResult
from partitionedhashjoin_tpu_torch.parallel.aggregate_shuffle import (
    PARTIAL_SLOT_BYTES,
    _combine,
    _combiner_options,
    _result,
    _route_and_merge_partials,
    _stack_groups,
)
from partitionedhashjoin_tpu_torch.parallel.mesh import Mesh, gather_prefixes
from partitionedhashjoin_tpu_torch.parallel.shuffle import (
    ExchangeRun,
    _effective_hot_valid,
    _ExchangeOperator,
    _member_of_small,
    _searchsorted_member,
)

_MASK = 0xFFFFFFFF


def _join_aggregate_local(
    mesh: Mesh,
    rk_a,
    rv_a,
    rk_b,
    rp_b,
    rv_b,
    keys_b,
    pays_b,
    is_hot_b,
    hot_plan_keys,
    eff_hot_valid,
    agg_seed,
    use_hot: bool,
    cap_local: int,
    cap_x: int,
    cap_merge: int,
):
    """Local join-aggregate, partial exchange and merge.

    Per shard: one sort GROUP BY over the concatenated (received cold probe
    slots, local probe rows) with row validity (the slot's, and for local
    rows membership in the effective hot set), then the partials whose key
    has no build row are invalidated: cold presence from the received build
    set, hot presence from the hot plan.  Returns the merged columns (each
    ``(local_size, cap_merge)``), the merged group counts and the exactness
    telemetry over every shard (local need, dropped partials, merge
    need)."""
    lsz = mesh.local_size
    device = rk_a.device
    opts = _combiner_options(device)
    rka, rva, rkb, rpb, rvb, kb, pb, ihb = (
        x.reshape(lsz, -1) for x in (rk_a, rv_a, rk_b, rp_b, rv_b, keys_b, pays_b, is_hot_b))
    slot = torch.arange(cap_local, device=device)
    groups, present = [], []
    for i in range(lsz):
        # hot probe rows count only when their key has a replicated hot
        # build row (eff_hot_valid masks the plan keys that have none)
        if use_hot:
            hot_match = ihb[i] & _member_of_small(kb[i], hot_plan_keys, eff_hot_valid)
        else:
            hot_match = torch.zeros_like(ihb[i])
        g = _combine(torch.cat([rkb[i], kb[i]]), torch.cat([rpb[i], pb[i]]),
                     torch.cat([rvb[i], hot_match]), cap_local, opts)
        # the inner join at group granularity: hot plan keys never travel
        # cold on either side, so the two presence sets are disjoint and
        # one OR is exact
        hit = _searchsorted_member(rka[i], rva[i])(g.keys)
        if use_hot:
            hit = hit | _member_of_small(g.keys, hot_plan_keys, eff_hot_valid)
        groups.append(g)
        present.append(hit)
    cols, nums, local_need = _stack_groups(groups, mesh)
    del groups
    p_valid = (slot[None, :] < nums[:, None]) & torch.stack(present)
    *merged, m_nums, m_need, dropped = _route_and_merge_partials(
        mesh, cols, p_valid, agg_seed, cap_x, cap_merge)
    return (*merged, m_nums, local_need, dropped, m_need)


class DistributedJoinAggregateOperator(_ExchangeOperator):
    """Mesh-parallel inner-join → GROUP BY operator.

    ``run(build, probe)`` returns a ``GroupByResult`` equal (as a key →
    aggregates map) to the single-device plan
    ``scan(probe).join(scan(build)).group_by()`` with ``carry="probe"``:
    COUNT/SUM/MIN/MAX of the probe payload over probe rows whose key exists
    in the build relation, on the mesh's device (across processes: this
    process's rows in, the global groups out).

    Shares the shuffle join's exchange knobs (slack, skew plan) and the
    distributed aggregate's capacity contract; every capacity has an
    overflow counter and a growing retry, so results are exact.
    """

    def __init__(
        self,
        mesh: Mesh,
        seed: Optional[int] = None,
        slack: float = 2.0,
        handle_skew: bool = True,
        hot_capacity: int = 64,
        hot_sample: int = 16_384,
        hot_min_frac: float = 0.005,
        max_retries: int = 5,
    ) -> None:
        super().__init__(mesh, seed, slack, handle_skew, hot_capacity, hot_sample,
                         hot_min_frac, max_retries, "DistributedJoinAggregate")
        self._agg_seed = (self._seed ^ 0x85EBCA6B) & _MASK
        self.last_run: Optional[ExchangeRun] = None

    def run(
        self,
        build: Table,
        probe: Table,
        group_capacity: Optional[int] = None,
        build_valid=None,
        probe_valid=None,
    ) -> GroupByResult:
        """``build_valid``/``probe_valid``: optional per-row validity (a
        pushed-down FILTER, the query layer's R2 and R6).  Invalid rows are
        dropped at the exchange bucketizer (cold rows never travel, hot rows
        are left out of ``is_hot_b``), so groups aggregate valid rows only."""
        for name, t in (("build", build), ("probe", probe)):
            if t.keys.dtype != torch.int32 or t.payloads.dtype != torch.int32:
                raise TypeError(
                    f"distributed join-aggregate is int32-only ({name} keys "
                    f"{t.keys.dtype}, payloads {t.payloads.dtype})"
                )
        s = self._num_shards
        device = self._mesh.device
        ka, pa, kb, pb = (x.to(device) for x in (build.keys, build.payloads,
                                                 probe.keys, probe.payloads))
        va, vb = (None if v is None else torch.as_tensor(v).to(device)
                  for v in (build_valid, probe_valid))
        self._check_inputs(make_table(ka, pa), make_table(kb, pb), va, vb)
        hot_keys, hot_valid = self._hot_plan(kb)
        self.last_run = run = ExchangeRun(num_shards=s)
        use_hot = self._handle_skew
        # local hot rows join the pool
        per_shard_rows = probe.size // self._mesh.local_size

        def aggregate_exchanged(exchanged, cap_a, cap_b):
            rk_a, _, rv_a, rk_b, rp_b, rv_b, is_hot_b, hk, _, hv, _ = exchanged
            exchanged.clear()
            if use_hot:
                eff_valid = _effective_hot_valid(hot_keys, hot_valid, hk, hv)
            else:
                eff_valid = torch.zeros_like(hot_valid)
            return self._aggregate_received(
                rk_a, rv_a, rk_b, rp_b, rv_b, kb, pb, is_hot_b, hot_keys,
                eff_valid, use_hot, group_capacity,
                pool_rows=s * cap_b + per_shard_rows, n_probe=probe.size,
            )

        return self._exchange_with_retries(
            ka, pa, kb, pb, hot_keys, hot_valid, va, vb, run,
            aggregate_exchanged, "join-aggregate capacities")

    def _aggregate_received(
        self,
        rk_a, rv_a, rk_b, rp_b, rv_b, keys_b, pays_b,
        is_hot_b, hot_keys, eff_valid,
        use_hot: bool,
        group_capacity: Optional[int],
        pool_rows: int,
        n_probe: int,
    ) -> Optional[GroupByResult]:
        """Inner retry loop over the aggregate capacities (the exchange's
        results are reused across retries).  Returns None when the aggregate
        keeps overflowing (the caller's outer loop gives up)."""
        s = self._num_shards
        mesh = self._mesh
        hint = pool_rows if group_capacity is None else min(group_capacity, pool_rows)
        cap_local = max(16, hint)
        cap_merge_floor = 16
        slack = self._slack
        exchange_bytes = self.last_run.exchange_bytes
        for _ in range(self._max_retries):
            cap_x = max(16, min(int(cap_local / s * slack + 1), cap_local))
            cap_merge = max(cap_merge_floor, min(int(cap_local * slack + 1), s * cap_x))
            mk, mc, ms, mmn, mmx, m_nums, l_need, dropped, m_need = _join_aggregate_local(
                self._mesh, rk_a, rv_a, rk_b, rp_b, rv_b, keys_b, pays_b, is_hot_b,
                hot_keys, eff_valid, self._agg_seed, use_hot, cap_local, cap_x,
                cap_merge,
            )
            self.last_run.attempts.append({
                "local_need": l_need, "cap_local": cap_local, "dropped": dropped,
                "merge_need": m_need, "cap_merge": cap_merge})
            if l_need <= cap_local and dropped == 0 and m_need <= cap_merge:
                self.last_run.exchange_bytes = (
                    exchange_bytes + s * s * cap_x * PARTIAL_SLOT_BYTES)
                *cols, count = gather_prefixes(mesh, m_nums, cap_merge,
                                              mk, mc, ms, mmn, mmx)
                self._logger.info("Number of groups: %d", int(count))
                return _result(cols, count, n_probe)
            self.last_run.retries += 1
            self._logger.info(
                "aggregate overflow (local need=%d/%d, dropped=%d, merge "
                "need=%d/%d) at slack %.1f; retrying",
                l_need, cap_local, dropped, m_need, cap_merge, slack,
            )
            if l_need > cap_local:
                cap_local = min(pool_rows, max(l_need, cap_local * 2))
            if m_need > cap_merge:
                cap_merge_floor = max(m_need, cap_merge * 2)
            if dropped:
                slack *= 2
        return None
