"""Radix-partitioning join (Blanas SIGMOD'11, algorithm 2).

Counterpart of ``partitionedhashjoin_tpu/ops/radix_cluster.py::
RadixHashJoiner`` in its "vmem" mode, and of the reference's
src/RadixCluster/HashJoin.hpp:91-440.

- Partition phase: one sort per relation (``merge_join.key_sort``: int32
  keys through the sorter switch, the library sort or K6; int64 keys
  through the library sort).  Sorting by key IS range-radix
  clustering: every partition is a contiguous key range, laid out
  contiguously, which is what the reference's scatter produces per hash
  partition (:394-412).  ``number_of_partitions`` is advisory, as in the
  JAX package: the kernel ranges every probe tile on its own, a finer
  fan-out than any practical P.
- Build phase: nothing to build; the sorted build run is the lookup
  structure.
- Probe phase: the merge-probe kernel over the two sorted runs — K1
  (``merge_join.sorted_runs_count``, full int32 domain) or, when either
  side is int64, K3 (``ranged_merge_count_i64``).  Keys are never cast
  down.

Ported: mode "vmem", and "auto", which is "vmem" on every device.  The
"chained" mode (hash fan-out and per-partition chained tables) raises
``NotImplementedError`` (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from typing import Optional

import torch

from partitionedhashjoin_tpu_torch.config import RadixClusteringConfiguration
from partitionedhashjoin_tpu_torch.data.table import Table
from partitionedhashjoin_tpu_torch.ops import merge_join
from partitionedhashjoin_tpu_torch.ops.kernels import merge_probe
from partitionedhashjoin_tpu_torch.ops.no_partitioning import resolve_mode
from partitionedhashjoin_tpu_torch.ops.sort_merge import _key_dtype
from partitionedhashjoin_tpu_torch.utils.device import sync
from partitionedhashjoin_tpu_torch.utils.logger import get_new_logger
from partitionedhashjoin_tpu_torch.utils.results import (
    IHashJoinTimer,
    NoOpHashJoinTimer,
)


class RadixHashJoiner:
    """Joiner mirroring RadixCluster::HashJoiner (HashJoin.hpp:91-135):
    ``run`` = partition A and B → build → probe → count, each phase closed
    by a device barrier."""

    def __init__(
        self,
        configuration: Optional[RadixClusteringConfiguration] = None,
        seed: Optional[int] = None,
    ) -> None:
        self._config = configuration or RadixClusteringConfiguration()
        p = self._config.number_of_partitions
        if p & (p - 1):
            raise ValueError(f"number_of_partitions must be a power of 2, got {p}")
        # seed is unused (range-radix clustering is hash-free); kept for API
        # symmetry with the JAX joiner
        self._logger = get_new_logger("RadixClusterHashJoiner")

    @property
    def num_partitions(self) -> int:
        return self._config.number_of_partitions

    def run(
        self,
        table_a: Table,
        table_b: Table,
        timer: Optional[IHashJoinTimer] = None,
    ) -> int:
        """Partition both, build, probe, return the count."""
        resolve_mode(self._config.mode)
        timer = timer or NoOpHashJoinTimer()
        dtype = _key_dtype(table_a.keys, table_b.keys)

        timer.set_partitioning_phase_begin()
        # int32 keys through the sorter switch; int64 keys keep the library
        # sort, as in the JAX package
        a_sorted = merge_join.key_sort(table_a.keys.to(dtype))
        b_sorted = merge_join.key_sort(table_b.keys.to(dtype))
        sync(a_sorted.device)
        timer.set_partitioning_phase_end()

        timer.set_build_phase_begin()
        timer.set_build_phase_end()

        timer.set_probe_phase_begin()
        if dtype == torch.int64:
            count = merge_probe.ranged_merge_count_i64(a_sorted, b_sorted)
        else:
            count = merge_join.sorted_runs_count(a_sorted, b_sorted)
        count = int(count.item())
        timer.set_probe_phase_end()
        self._logger.info("Number of joined tuples: %d", count)
        return count
