"""Sort-merge count joins and the flagship joiner.

Counterpart of ``partitionedhashjoin_tpu/ops/sort_merge.py``:

- ``sort_merge_count``: the Get-semantics count over ONE sort of the
  concatenated ``[build; probe]`` keys.  Unmasked int32 keys go through the
  fused merge-count kernel K2 (``ops/kernels/merge_count.py``); unmasked
  int64 keys through ``cummax``; masked keys through the multiplicity scan
  of ``_merged_multiplicity`` (no kernel in the JAX package either).
- ``sort_merge_count_all``: the full inner-join cardinality (``GetAll``
  semantics).  A 0-dim int64 tensor, where the JAX package returns a
  ``uint32[2]`` (hi, lo) pair because it runs without x64.
- ``anti_count``: valid probe rows with no match.
- ``SortMergeJoiner``: ``count`` is the two-run kernel join of
  ``ops/merge_join.py`` (int32 → K1, int64 → K3) on every device.

The JAX package orders build rows before equal-keyed probe rows with an
unstable 2-key sort on (key, probe tag).  ``torch.sort`` has no 2-key
comparator, so the port STABLE-sorts the concatenation, in which every build
row comes before every probe row: equal keys keep that order, and a row is a
build row iff its source index is below ``n_build`` — no tag is sorted or
gathered.

Every count is a 0-dim int64 tensor on the keys' device.  Key dtypes: int32
and int64 (narrower integers widen to int32); a side in int64 makes the
join int64; other dtypes raise ``TypeError``.

The materializing joins (``sort_merge_materialize[_typed]``,
``SortMergeJoiner.run_materialize``) match each probe row with the LATEST
valid build row of its key, as the JAX package does.  JAX finds it with a
3-key sort of ``[build; probe]``, a forward fill and a placement sort back
to probe order; the port sorts only the build side, stably, and searches
each probe key in it (``_match_probe_rows``), so the result is in probe
order from the start.  ``run_materialize(order="key")`` is the kernel path
of ``ops/merge_join.two_run_materialize`` (K4) on every device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from partitionedhashjoin_tpu_torch.data.table import JoinedTable, Table
from partitionedhashjoin_tpu_torch.ops import merge_join
from partitionedhashjoin_tpu_torch.ops.filter import compact
from partitionedhashjoin_tpu_torch.ops.kernels import merge_count
from partitionedhashjoin_tpu_torch.utils.logger import get_new_logger
from partitionedhashjoin_tpu_torch.utils.results import (
    IHashJoinTimer,
    NoOpHashJoinTimer,
)

_NARROW = (torch.int8, torch.int16, torch.int32, torch.uint8)


def _key_dtype(build_keys: torch.Tensor, probe_keys: torch.Tensor) -> torch.dtype:
    """Common key dtype: int64 when either side is int64, else int32.
    Chosen explicitly so 64-bit keys are never truncated; other dtypes
    (floats, bool, unsigned 32/64-bit) raise."""
    for name, keys in (("build_keys", build_keys), ("probe_keys", probe_keys)):
        if keys.dtype not in _NARROW and keys.dtype != torch.int64:
            raise TypeError(
                f"{name} is {keys.dtype}; the joins take int32 or int64 keys"
            )
    if torch.int64 in (build_keys.dtype, probe_keys.dtype):
        return torch.int64
    return torch.int32


def _merged_sort(
    build_keys: torch.Tensor, probe_keys: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(keys_s, is_build_s, order): the concatenated keys stable-sorted, so
    each equal-key run is [builds..., probes...]; ``order`` holds each
    sorted row's index in the concatenation."""
    dtype = _key_dtype(build_keys, probe_keys)
    keys = torch.cat([build_keys.to(dtype), probe_keys.to(dtype)])
    keys_s, order = torch.sort(keys, stable=True)
    return keys_s, order < build_keys.shape[0], order


def _merged_multiplicity(build_keys, probe_keys, build_valid, probe_valid):
    """Shared sort+scan: (is_probe_row, probe_row_valid, mult) in sorted
    order, where mult = number of valid build rows with this key."""
    n_a, n_b = build_keys.shape[0], probe_keys.shape[0]
    device = build_keys.device
    keys_s, is_build_s, order = _merged_sort(build_keys, probe_keys)
    valid = torch.cat([
        torch.ones((n_a,), dtype=torch.bool, device=device)
        if build_valid is None else build_valid.to(torch.bool),
        torch.ones((n_b,), dtype=torch.bool, device=device)
        if probe_valid is None else probe_valid.to(torch.bool),
    ])
    valid_s = valid[order]
    counted = (is_build_s & valid_s).to(torch.int64)
    build_prefix = torch.cumsum(counted, dim=0)
    new_key = torch.ones_like(is_build_s)
    new_key[1:] = keys_s[1:] != keys_s[:-1]
    # exclusive prefix at each run start, -1 elsewhere; cummax carries the
    # current run's snapshot (snapshots never decrease)
    snapshot = torch.where(new_key, build_prefix - counted, -1)
    run_start_prefix = torch.cummax(snapshot, dim=0).values
    return ~is_build_s, valid_s, build_prefix - run_start_prefix


def sort_merge_count(
    build_keys: torch.Tensor,
    probe_keys: torch.Tensor,
    build_valid: Optional[torch.Tensor] = None,
    probe_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Number of (valid) probe rows whose key appears among valid build keys."""
    if build_valid is not None or probe_valid is not None:
        is_probe, valid, mult = _merged_multiplicity(
            build_keys, probe_keys, build_valid, probe_valid
        )
        return (is_probe & valid & (mult > 0)).sum()
    # Fast path: ``last_build = running max of build keys`` is the most
    # recent build key because keys ascend; the dtype minimum doubles as "no
    # build key yet", so probe rows with that key are added back below.
    keys_s, is_build_s, _ = _merged_sort(build_keys, probe_keys)
    kmin = torch.iinfo(keys_s.dtype).min
    if keys_s.dtype == torch.int32:
        count = merge_count.merge_count_sorted(keys_s, is_build_s)
    else:
        last_build = torch.cummax(
            torch.where(is_build_s, keys_s, kmin), dim=0
        ).values
        count = (~is_build_s & (last_build == keys_s) & (keys_s != kmin)).sum()
    # correction: probe keys equal to the dtype minimum match iff any build
    # key does
    min_in_build = (build_keys == kmin).any()
    n_min_probe = (probe_keys == kmin).sum()
    return count + torch.where(min_in_build, n_min_probe, 0)


def sort_merge_count_all(
    build_keys: torch.Tensor,
    probe_keys: torch.Tensor,
    build_valid: Optional[torch.Tensor] = None,
    probe_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full inner-join cardinality (duplicates multiply, ``GetAll``
    semantics): the sum over valid probe rows of their key's valid build
    multiplicity, as a 0-dim int64 tensor."""
    is_probe, valid, mult = _merged_multiplicity(
        build_keys, probe_keys, build_valid, probe_valid
    )
    return torch.where(is_probe & valid, mult, 0).sum()


def anti_count(
    build_keys: torch.Tensor,
    probe_keys: torch.Tensor,
    build_valid: Optional[torch.Tensor] = None,
    probe_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Anti-join count: valid probe rows whose key does NOT appear among
    valid build keys (complement of the Get-semantics count)."""
    if probe_valid is not None:
        n_valid = probe_valid.to(torch.bool).sum()
    else:
        n_valid = probe_keys.shape[0]
    return n_valid - sort_merge_count(build_keys, probe_keys, build_valid, probe_valid)


def _match_probe_rows(build_keys, probe_keys, build_payloads=None,
                      build_valid=None):
    """``(hit, build_row[, pay_a])`` per probe row, in probe-row order:
    whether its key is among the valid build keys and, if so, the LATEST
    valid build row with that key (int32) and its payload; both are 0 on a
    miss.

    The build side is sorted stably, so each key's build rows ascend by row,
    and a right ``searchsorted`` of a probe key lands just past its key's
    last build row.  With ``build_valid``, a ``cummax`` over the sorted build
    carries the last valid position forward, so an invalid build row never
    matches (exact over the full int32/int64 key domain, no sentinel)."""
    n_a, n_b = build_keys.shape[0], probe_keys.shape[0]
    device = probe_keys.device
    if n_a == 0 or n_b == 0:
        hit = torch.zeros((n_b,), dtype=torch.bool, device=device)
        row = torch.zeros((n_b,), dtype=torch.int32, device=device)
        if build_payloads is None:
            return hit, row
        # the dtype does not flip on emptiness
        return hit, row, torch.zeros((n_b,), dtype=build_payloads.dtype,
                                      device=device)
    dtype = _key_dtype(build_keys, probe_keys)
    a_sorted, a_row = torch.sort(build_keys.to(dtype), stable=True)
    q = probe_keys.to(dtype).contiguous()
    last = torch.searchsorted(a_sorted, q, right=True) - 1
    if build_valid is not None:
        valid_s = build_valid.to(torch.bool)[a_row]
        rank = torch.arange(n_a, device=device)
        last_valid = torch.cummax(torch.where(valid_s, rank, -1), 0).values
        last = torch.where(last >= 0, last_valid[last.clamp(min=0)], -1)
    at = last.clamp(min=0)
    hit = (last >= 0) & (a_sorted[at] == q)
    build_row = torch.where(hit, a_row[at], 0).to(torch.int32)
    if build_payloads is None:
        return hit, build_row
    pay_a = torch.where(hit, build_payloads[build_row], 0).to(build_payloads.dtype)
    return hit, build_row, pay_a


def _materialize_typed(
    build_keys, build_payloads, probe_keys, probe_payloads, join_type: str,
    build_valid=None, probe_valid=None,
):
    """Materialized join, every probe-side variant of the reference's
    Get-semantics probe (HashJoin.hpp:144-180) plus the relational
    extensions it lacks:

    - ``inner``/``semi``: probe rows whose key matches, compacted to the
      front (with the matched build payload; a semi join per probe row is
      the first-match inner join here)
    - ``anti``: probe rows with NO match, compacted to the front (pay_a 0)
    - ``left``: every probe row in place; ``matched`` marks the rows whose
      pay_a is a real build payload
    - ``full``: the ``left`` block followed by the compacted UNMATCHED
      build rows (keys and pay_a from the build side, pay_b 0, matched
      False); ``n_probe + n_build`` rows, ``count`` live.

    Returns ``(keys, pay_a, pay_b, matched, count)``; rows at ``>= count``
    are zeros and ``count`` is a 0-dim int64 tensor.

    ``build_valid`` / ``probe_valid`` are filters folded in as masks: an
    invalid build row is never matched, and an invalid probe row is in no
    variant's output (for ``left``/``full`` the probe block is compacted to
    the valid rows).
    """
    if join_type not in ("inner", "semi", "anti", "left", "full"):
        raise ValueError(f"unknown join_type {join_type!r}")
    n_b = probe_keys.shape[0]
    device = probe_keys.device
    hit, _, pay_matched = _match_probe_rows(
        build_keys, probe_keys, build_payloads, build_valid=build_valid
    )
    pv = None if probe_valid is None else probe_valid.to(torch.bool)
    if pv is not None:
        hit = hit & pv
    if join_type == "left":
        if pv is None:
            n = torch.tensor(n_b, dtype=torch.int64, device=device)
            return probe_keys, pay_matched, probe_payloads, hit, n
        count, *cols = compact(pv, probe_keys, pay_matched, probe_payloads, hit)
        return (*cols, count)
    if join_type == "full":
        n_a = build_keys.shape[0]
        # the reversed match: which build rows found no (valid) probe
        # partner; every unmatched duplicate appears (full-outer
        # multiplicity); probe_valid masks the reversed build side
        hit_b, _ = _match_probe_rows(probe_keys, build_keys, build_valid=pv)
        keep_b = ~hit_b
        if build_valid is not None:
            keep_b = keep_b & build_valid.to(torch.bool)
        zero_pb = torch.zeros((n_a,), dtype=probe_payloads.dtype, device=device)
        no_match = torch.zeros((n_a,), dtype=torch.bool, device=device)
        if pv is None:
            count_b, k_b, p_b = compact(keep_b, build_keys, build_payloads)
            return (
                torch.cat([probe_keys, k_b]),
                torch.cat([pay_matched, p_b]),
                torch.cat([probe_payloads, zero_pb]),
                torch.cat([hit, no_match]),
                n_b + count_b,
            )
        # filtered probe side: one stable compaction keeps the [valid probe
        # block, unmatched build block] contract with no gap
        count, *cols = compact(
            torch.cat([pv, keep_b]),
            torch.cat([probe_keys, build_keys]),
            torch.cat([pay_matched, build_payloads]),
            torch.cat([probe_payloads, zero_pb]),
            torch.cat([hit, no_match]),
        )
        return (*cols, count)
    if join_type == "anti":
        keep = ~hit if pv is None else (~hit & pv)
    else:
        keep = hit
    count, *cols = compact(keep, probe_keys, pay_matched, probe_payloads, hit)
    return (*cols, count)


def sort_merge_materialize(build_keys, build_payloads, probe_keys, probe_payloads):
    """Materialized first-match inner join: ``(keys, payload_a, payload_b,
    count)``, compacted to the front in probe-row order, each probe row with
    the latest build row of its key."""
    keys_out, pay_a, pay_b, _, count = _materialize_typed(
        build_keys, build_payloads, probe_keys, probe_payloads, "inner"
    )
    return keys_out, pay_a, pay_b, count


def sort_merge_materialize_typed(
    build_keys, build_payloads, probe_keys, probe_payloads,
    join_type: str = "inner", build_valid=None, probe_valid=None,
):
    """Public typed materializer — see ``_materialize_typed``."""
    return _materialize_typed(
        build_keys, build_payloads, probe_keys, probe_payloads, join_type,
        build_valid=build_valid, probe_valid=probe_valid,
    )


class SortMergeJoiner:
    """Joiner with the reference's ``run(table_a, table_b, timer)`` shape.

    The sort subsumes build+probe; it is attributed to the probe phase
    (build is a no-op), mirroring how the no-partitioning join reports no
    partition phase.
    """

    def __init__(self, seed: Optional[int] = None) -> None:
        # seed is unused (the sort is hash-free); kept for API symmetry
        self._logger = get_new_logger("SortMergeJoiner")

    def run(
        self,
        table_a: Table,
        table_b: Table,
        timer: Optional[IHashJoinTimer] = None,
    ) -> int:
        timer = timer or NoOpHashJoinTimer()
        timer.set_build_phase_begin()
        timer.set_build_phase_end()
        timer.set_probe_phase_begin()
        # .item() waits for the device: it is the barrier closing the phase
        count = int(self.count(table_a.keys, table_b.keys).item())
        timer.set_probe_phase_end()
        self._logger.info("Number of joined tuples: %d", count)
        return count

    @staticmethod
    def count(build_keys: torch.Tensor, probe_keys: torch.Tensor) -> torch.Tensor:
        """The two-run kernel join: int32 keys → ``two_run_count`` (K1),
        int64 keys (either side) → ``two_run_count_i64`` (K3)."""
        if _key_dtype(build_keys, probe_keys) == torch.int64:
            return merge_join.two_run_count_i64(build_keys, probe_keys)
        return merge_join.two_run_count(build_keys, probe_keys)

    def run_materialize(
        self,
        table_a: Table,
        table_b: Table,
        timer: Optional[IHashJoinTimer] = None,
        join_type: str = "inner",
        order: str = "probe",
    ) -> JoinedTable:
        """Materialized join output (an engine extension).

        ``join_type`` selects the probe-side variant (see
        ``sort_merge_materialize_typed``).  ``order`` selects the row order:
        "probe" (default) is probe-row order with the latest build row of
        each key; "key" is sorted-key order with the first build row of each
        key, through ``merge_join.two_run_materialize`` (K4; inner joins on
        int32 keys).  The JAX package runs "key" only on a Mosaic backend;
        the port runs it on every device.
        """
        if order not in ("probe", "key"):
            raise ValueError(f"unknown order {order!r}")
        timer = timer or NoOpHashJoinTimer()
        timer.set_build_phase_begin()
        timer.set_build_phase_end()
        timer.set_probe_phase_begin()
        if order == "key":
            if join_type != "inner":
                raise ValueError(
                    "order='key' (the kernel path) supports inner joins; "
                    "use order='probe' for semi/anti/left/full"
                )
            if _key_dtype(table_a.keys, table_b.keys) != torch.int32:
                raise ValueError("order='key' needs int32 keys")
            keys, pay_a, pay_b, count = merge_join.two_run_materialize(
                table_a.keys, table_a.payloads, table_b.keys, table_b.payloads,
            )
            matched = None
        else:
            keys, pay_a, pay_b, matched, count = _materialize_typed(
                table_a.keys, table_a.payloads,
                table_b.keys, table_b.payloads, join_type,
            )
        # .item() waits for the device: it is the barrier closing the phase
        count_host = int(count.item())
        timer.set_probe_phase_end()
        self._logger.info("Number of joined tuples: %d", count_host)
        return JoinedTable(
            keys=keys, payloads_a=pay_a, payloads_b=pay_b, count=count,
            matched=matched,
        )
