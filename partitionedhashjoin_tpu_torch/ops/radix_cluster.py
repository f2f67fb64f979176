"""Radix-partitioning join (Blanas SIGMOD'11, algorithm 2).

Counterpart of ``partitionedhashjoin_tpu/ops/radix_cluster.py::
RadixHashJoiner`` and of the reference's src/RadixCluster/HashJoin.hpp:
91-440, in two modes (``RadixClusteringConfiguration.mode``):

- ``"vmem"`` (and ``"auto"``, which is "vmem" on every device): range-radix
  clustering.  Partition phase: one sort per relation
  (``merge_join.key_sort``: K6 for int32 and int64 keys).  Sorting by key
  IS range-radix clustering: every partition is a contiguous key range,
  laid out contiguously, which is what the reference's scatter produces per
  hash partition (:394-412).  ``number_of_partitions`` is advisory, as in
  the JAX package: the kernel ranges every probe tile on its own.  Build
  phase: nothing to build.  Probe phase: the merge-probe kernel over the
  two sorted runs, K1 (``merge_join.sorted_runs_count``) or, when either
  side is int64, K3 (``ranged_merge_count_i64``).  Keys are never cast
  down.
- ``"chained"``: the reference's own structure.  Partition phase: both
  relations fanned out by ``hash(key) & (P - 1)`` (``ops/radix.py``: K7 and
  one stable sort each).  Build phase: every partition's chained table in
  one flat bucket space (partition p owns buckets ``[boff[p], boff[p] +
  bcnt[p])``, ``bcnt[p]`` ~ |A_p|), built by one stable sort.  Probe phase:
  one launch of ``chained_count_kernel`` (``ops/kernels/chained_probe.py``),
  one thread per probe row walking its chain, over the partition-segmented
  bucket ids.  The partition
  and bucket hashes are decorrelated by seed (src/main.cpp:215-217, 267):
  both derive from one base seed through distinct mix constants.  int32
  keys only.

A probe row counts once if its key is among the build keys (``Get`` !=
null, :295-301).  Each phase is closed by a device barrier.
"""

from __future__ import annotations

from typing import Optional

import torch

from partitionedhashjoin_tpu_torch.config import RadixClusteringConfiguration
from partitionedhashjoin_tpu_torch.data.table import Table
from partitionedhashjoin_tpu_torch.ops import hash_table as ht
from partitionedhashjoin_tpu_torch.ops import merge_join, radix
from partitionedhashjoin_tpu_torch.ops.kernels import merge_probe
from partitionedhashjoin_tpu_torch.ops.no_partitioning import hash_seed, resolve_mode
from partitionedhashjoin_tpu_torch.ops.sort_merge import _key_dtype
from partitionedhashjoin_tpu_torch.utils.device import sync
from partitionedhashjoin_tpu_torch.utils.logger import get_new_logger
from partitionedhashjoin_tpu_torch.utils.results import (
    IHashJoinTimer,
    NoOpHashJoinTimer,
)

#: Seed decorrelation constants: the partition hash and the bucket hash must
#: be independent, or every sub-table sees only keys whose low hash bits are
#: equal (main.cpp:215-217, 267 uses two randomly seeded XXHashers).
_PARTITION_SEED_MIX = 0x9E3779B9
_BUCKET_SEED_MIX = 0x85EBCA6B


def _partition_both(keys_a, keys_b, part_seed, num_partitions: int,
                    passes: int = 1):
    """Key-only fan-out of both relations (HashJoin.hpp:210-213):
    ``(keys_a_part, hist_a, keys_b_part)``.  Payloads are not carried: the
    join only counts."""
    keys_a_part, hist_a, _ = radix.radix_partition_keys(
        keys_a, part_seed, num_partitions, passes=passes)
    keys_b_part, _, _ = radix.radix_partition_keys(
        keys_b, part_seed, num_partitions, passes=passes)
    return keys_a_part, hist_a, keys_b_part


def _segment_bucket_ids(keys, part_seed, bucket_seed, boff, bcnt,
                        num_partitions):
    """Global bucket id: the partition's bucket-range offset plus the
    in-partition bucket ``hash % bcnt[pid]`` (the per-partition
    ``factory.New(|A_p|)`` geometry, HashJoin.hpp:278, flattened).  The
    modulo runs in int64 on the hash's unsigned value: torch has no uint32
    modulo on the CPU."""
    keys = ht._as_i32_keys(keys)
    pid = radix.partition_ids(keys, part_seed, num_partitions).to(torch.int64)
    h = ht.hash_bits(keys, bucket_seed).to(torch.int64) & 0xFFFFFFFF
    local = h % bcnt.index_select(0, pid)
    return boff.index_select(0, pid) + local.to(torch.int32)


def _build_phase(keys_a_part, hist_a, part_seed, bucket_seed,
                 num_buckets: int, num_partitions: int):
    """Per-partition chained tables in one flat bucket space, built by one
    stable sort (the per-partition insert loops of HashJoin.hpp:283-286);
    ~|A_p| buckets per partition (load <= 1).  ``(table, boff, bcnt)``."""
    boff, bcnt = ht.segment_geometry(hist_a, ratio=1.0)
    bucket = _segment_bucket_ids(keys_a_part, part_seed, bucket_seed, boff,
                                 bcnt, num_partitions)
    table = ht.build_chained_from_buckets(bucket, keys_a_part, bucket_seed,
                                          num_buckets)
    return table, boff, bcnt


def _probe_phase(table: ht.ChainedHashTable, keys_b_part, part_seed, boff,
                 bcnt, num_partitions: int) -> torch.Tensor:
    """The count (0-dim int64) of ``keys_b_part`` against the table, in one
    call (JAX's ``_probe_chunk`` calls, dispatched in windows for the TPU's
    watchdog, are not ported)."""
    bucket = _segment_bucket_ids(keys_b_part, part_seed, table.seed, boff,
                                 bcnt, num_partitions)
    return ht._probe_chained_count_chunk(table, keys_b_part, bucket)


class RadixHashJoiner:
    """Joiner mirroring RadixCluster::HashJoiner (HashJoin.hpp:91-135):
    ``run`` = partition A and B → build → probe → count, each phase closed
    by a device barrier.  ``seed`` seeds the chained mode's two hashes (OS
    entropy when None)."""

    def __init__(
        self,
        configuration: Optional[RadixClusteringConfiguration] = None,
        seed: Optional[int] = None,
    ) -> None:
        self._config = configuration or RadixClusteringConfiguration()
        p = self._config.number_of_partitions
        if p & (p - 1):
            raise ValueError(f"number_of_partitions must be a power of 2, got {p}")
        seed = hash_seed(seed)
        self._part_seed = (seed ^ _PARTITION_SEED_MIX) & 0xFFFFFFFF
        self._bucket_seed = (seed ^ _BUCKET_SEED_MIX) & 0xFFFFFFFF
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
        timer = timer or NoOpHashJoinTimer()
        if resolve_mode(self._config.mode) == "chained":
            count = self._run_chained(table_a, table_b, timer)
        else:
            count = self._run_vmem(table_a, table_b, timer)
        self._logger.info("Number of joined tuples: %d", count)
        return count

    def _run_chained(self, table_a: Table, table_b: Table,
                     timer: IHashJoinTimer) -> int:
        p = self.num_partitions
        device = table_a.keys.device
        timer.set_partitioning_phase_begin()
        keys_a_part, hist_a, keys_b_part = _partition_both(
            table_a.keys, table_b.keys, self._part_seed, p,
            passes=self._config.partition_passes)
        sync(device)
        timer.set_partitioning_phase_end()

        num_buckets = ht.segmented_capacity(table_a.size, p, ratio=1.0)
        timer.set_build_phase_begin()
        chained, boff, bcnt = _build_phase(
            keys_a_part, hist_a, self._part_seed, self._bucket_seed,
            num_buckets, p)
        sync(device)
        timer.set_build_phase_end()

        timer.set_probe_phase_begin()
        count = _probe_phase(chained, keys_b_part, self._part_seed, boff,
                             bcnt, p)
        count = int(count.item())
        timer.set_probe_phase_end()
        return count

    def _run_vmem(self, table_a: Table, table_b: Table,
                  timer: IHashJoinTimer) -> int:
        dtype = _key_dtype(table_a.keys, table_b.keys)

        timer.set_partitioning_phase_begin()
        # int32 and int64 keys through K6
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
        return count
