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
join int64; other dtypes raise ``TypeError``.  The materializing joins (K4)
are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from partitionedhashjoin_tpu_torch.data.table import Table
from partitionedhashjoin_tpu_torch.ops import merge_join
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
