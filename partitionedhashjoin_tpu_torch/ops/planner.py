"""Stats-driven join planner: pick the cheapest exact strategy from the
build side's statistics before the probe runs.

Counterpart of ``partitionedhashjoin_tpu/ops/planner.py``.

1. Sort the build side (one unstable sort; the general join needs exactly
   this sorted run).
2. Read back three scalars in one transfer: min, max and ``covered`` —
   whether every integer in [min, max] occurs at least once (exact: the
   sorted run's adjacent differences are all 0 or 1).
3. Branch on the host:

   - ``"interval"`` (covered; every benchmark primary relation is, since
     the reference generates 1..N, DataGenerator/Sequential.cpp):
     membership(q) == (min <= q <= max), so the probe is one streaming
     compare and sum.
   - ``"kernel"`` (otherwise): sort the probe side and count with the
     merge-probe kernel against the REUSED sorted build run — K1 for int32
     keys (full domain), K3 for int64.

The JAX planner has a third plan, ``"sort-merge"``, for backends without
the Mosaic kernel; the port has its kernels (or their plain versions on the
CPU) everywhere, so it never plans that (ROADMAP Queue 3).  Counts are 0-dim
int64 tensors.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from partitionedhashjoin_tpu_torch.data.table import Table
from partitionedhashjoin_tpu_torch.ops import merge_join
from partitionedhashjoin_tpu_torch.ops.kernels import merge_probe
from partitionedhashjoin_tpu_torch.ops.sort_merge import _key_dtype
from partitionedhashjoin_tpu_torch.utils.logger import get_new_logger
from partitionedhashjoin_tpu_torch.utils.results import (
    IHashJoinTimer,
    NoOpHashJoinTimer,
)


class BuildStats(NamedTuple):
    """Host-side build statistics driving the plan choice."""

    n: int
    key_min: int
    key_max: int
    #: True iff every integer in [key_min, key_max] occurs among the keys
    #: (duplicates permitted) — proven from the sorted run, never sampled.
    covered: bool


def _sorted_stats(a_sorted: torch.Tensor) -> Tuple[int, int, bool]:
    """(min, max, covered) of a non-empty sorted key run, in one readback.

    Wrap-safe gap test: true adjacent gaps are >= 0 (sorted) and < 2^w; a
    gap >= 2^(w-1) wraps NEGATIVE in the key dtype (build [INT32_MIN,
    INT32_MAX]: gap 2^32-1 → -1), so "covered" needs the difference, taken
    in the key dtype, to be non-negative as well as <= 1.
    """
    d = a_sorted[1:] - a_sorted[:-1]
    covered = ((d >= 0) & (d <= 1)).all()
    lo, hi, cov = torch.stack(
        [a_sorted[0].to(torch.int64), a_sorted[-1].to(torch.int64),
         covered.to(torch.int64)]
    ).tolist()
    return lo, hi, bool(cov)


def _interval_count(
    probe_keys: torch.Tensor, lo: int, hi: int
) -> torch.Tensor:
    """Number of probe rows with lo <= key <= hi — the dense-build probe."""
    return ((probe_keys >= lo) & (probe_keys <= hi)).sum()


def build_stats(build_keys: torch.Tensor) -> Tuple[BuildStats, torch.Tensor]:
    """Sort the build keys and derive plan statistics.

    Returns (stats, sorted_keys); the sorted run is handed to the kernel
    plan when the interval plan does not apply, so the stats pass is free.
    """
    n = int(build_keys.shape[0])
    a_sorted = torch.sort(build_keys, stable=False).values
    if n == 0:
        return BuildStats(0, 0, 0, False), a_sorted
    return BuildStats(n, *_sorted_stats(a_sorted)), a_sorted


def _plan(
    build_keys: torch.Tensor, probe_keys: torch.Tensor
) -> Tuple[str, Callable[[], torch.Tensor]]:
    """Stage 1: widen the keys to their common dtype, sort the build side,
    choose the plan.  Returns (plan_name, execute) where execute() gives the
    count."""
    dtype = _key_dtype(build_keys, probe_keys)
    build_keys = build_keys.to(dtype)
    probe_keys = probe_keys.to(dtype)

    stats, a_sorted = build_stats(build_keys)
    if stats.covered:
        return "interval", lambda: _interval_count(
            probe_keys, stats.key_min, stats.key_max
        )

    def kernel_probe() -> torch.Tensor:
        b_sorted = torch.sort(probe_keys, stable=False).values
        if dtype == torch.int64:
            return merge_probe.ranged_merge_count_i64(a_sorted, b_sorted)
        return merge_join.sorted_runs_count(a_sorted, b_sorted)

    return "kernel", kernel_probe


def planned_count(
    build_keys: torch.Tensor, probe_keys: torch.Tensor
) -> Tuple[torch.Tensor, str]:
    """Get-semantics match count via the cheapest applicable plan.

    Returns (count, plan_name), plan_name in {"interval", "kernel"}.
    """
    if build_keys.shape[0] == 0 or probe_keys.shape[0] == 0:
        return torch.zeros((), dtype=torch.int64, device=build_keys.device), "interval"
    plan, execute = _plan(build_keys, probe_keys)
    return execute(), plan


class PlannedJoiner:
    """Planner-routed joiner with the reference's ``run(a, b, timer)``
    shape (src/NoPartitioning/HashJoin.hpp:60-103 for the phase protocol).
    The build sort and the stats readback are the build phase (they make
    the "index" the plan consults); the chosen probe is the probe phase."""

    def __init__(self, seed: Optional[int] = None) -> None:
        # seed unused (no hashing in any planned path); API symmetry
        self._logger = get_new_logger("PlannedJoiner")
        #: plan chosen by the most recent run (observability/tests)
        self.last_plan: Optional[str] = None

    def run(
        self,
        table_a: Table,
        table_b: Table,
        timer: Optional[IHashJoinTimer] = None,
    ) -> int:
        timer = timer or NoOpHashJoinTimer()
        if table_a.size == 0 or table_b.size == 0:
            timer.set_build_phase_begin()
            timer.set_build_phase_end()
            timer.set_probe_phase_begin()
            timer.set_probe_phase_end()
            self.last_plan = "interval"
            return 0
        timer.set_build_phase_begin()
        # the stats readback waits for the sort: it closes the build phase
        plan, execute = _plan(table_a.keys, table_b.keys)
        timer.set_build_phase_end()
        timer.set_probe_phase_begin()
        count = int(execute().item())
        timer.set_probe_phase_end()
        self.last_plan = plan
        self._logger.info("Plan %s: number of joined tuples: %d", plan, count)
        return count
