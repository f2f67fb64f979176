"""Radix partitioning: histogram, prefix sum and a stable fan-out.

Counterpart of ``partitionedhashjoin_tpu/ops/radix.py`` and of the
reference's three-stage partition pipeline (src/RadixCluster/HashJoin.hpp:
333-440): per-partition histograms of ``hash(key) % P`` (:343-357), their
exclusive prefix sums (:360-390), and the scatter of each tuple into its
partition in arrival order (:394-412).  The scatter is a stable sort by
partition id: every row moves to its partition's region and keeps its order
there, as in the JAX package.

    pid       = hash32(key) & (P - 1)     (K7 on a CUDA tensor)
    histogram = bincount(pid)
    offsets   = exclusive cumsum(histogram)
    order     = stable argsort(pid)        (torch.sort(stable=True))

``radix_partition_padded`` rounds each partition up to a multiple of
``block_rows`` so that fixed-size tiles never straddle a partition.  Keys are
32-bit (``hash_table._as_i32_keys``); histograms and offsets are int32 as in
JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from partitionedhashjoin_tpu_torch.ops import hash_table as ht


def partition_ids(keys: torch.Tensor, seed, num_partitions: int) -> torch.Tensor:
    """int32 ``hash32(key) & (P - 1)`` (HashJoin.hpp:349-350, 401-402).  P
    must be a power of two, so the reduction is a mask."""
    if num_partitions & (num_partitions - 1):
        raise ValueError(f"num_partitions must be a power of 2, got {num_partitions}")
    return ht.hash_bits(ht._as_i32_keys(keys), int(seed)) & (num_partitions - 1)


def _histogram(pid: torch.Tensor, num_partitions: int):
    """(histogram, exclusive offsets), both int32[P]."""
    histogram = torch.bincount(pid, minlength=num_partitions).to(torch.int32)
    return histogram, torch.cumsum(histogram, 0, dtype=torch.int32) - histogram


@dataclasses.dataclass
class PartitionedRelation:
    """A relation scattered into contiguous partitions (the partitioned
    table and ``PartitionsInfo`` boundaries, HashJoin.hpp:16-33).

    Partition p occupies rows ``offsets[p] : offsets[p] + histogram[p]``;
    in the padded layout the rows up to the next offset hold key 0 and
    ``row_ids == -1``.
    """

    keys: torch.Tensor
    payloads: torch.Tensor
    row_ids: torch.Tensor
    histogram: torch.Tensor
    offsets: torch.Tensor

    @property
    def num_partitions(self) -> int:
        return self.histogram.shape[0]

    @classmethod
    def from_numpy(cls, keys, payloads, row_ids, histogram, offsets,
                   device="cpu") -> "PartitionedRelation":
        """A relation from a JAX ``PartitionedRelation``'s fields as numpy
        arrays, on ``device``."""
        def col(a):
            return torch.tensor(np.asarray(a), device=device)

        return cls(keys=col(keys), payloads=col(payloads), row_ids=col(row_ids),
                   histogram=col(histogram), offsets=col(offsets))


def radix_partition(keys: torch.Tensor, payloads: torch.Tensor, seed,
                    num_partitions: int) -> PartitionedRelation:
    """Single-pass fan-out into P contiguous partitions (dense, no padding)."""
    pid = partition_ids(keys, seed, num_partitions)
    histogram, offsets = _histogram(pid, num_partitions)
    _, order = torch.sort(pid, stable=True)
    return PartitionedRelation(
        keys=keys[order], payloads=payloads[order],
        row_ids=order.to(torch.int32), histogram=histogram, offsets=offsets,
    )


def radix_partition_keys(keys: torch.Tensor, seed, num_partitions: int,
                         passes: int = 1):
    """Key-only fan-out: ``(partitioned_keys, histogram, offsets)``.

    ``passes > 1`` runs the multi-pass radix cluster (Manegold 2002 /
    Balkesen ICDE'13): LSD passes over ``ceil(log2(P) / passes)``-bit digits
    of the partition id, each a stable digit sort, which gives the layout of
    the single-pass fan-out.
    """
    pid = partition_ids(keys, seed, num_partitions)
    histogram, offsets = _histogram(pid, num_partitions)
    bits = max(1, num_partitions.bit_length() - 1)
    if passes <= 1 or bits <= 1:
        _, order = torch.sort(pid, stable=True)
        return keys[order], histogram, offsets
    passes = min(passes, bits)
    bits_per_pass = -(-bits // passes)
    digit_mask = (1 << bits_per_pass) - 1
    keys_s, pid_s = keys, pid
    for p in range(passes):  # LSD: low digits first; stability composes
        digit = (pid_s >> (p * bits_per_pass)) & digit_mask
        _, order = torch.sort(digit, stable=True)
        keys_s, pid_s = keys_s[order], pid_s[order]
    return keys_s, histogram, offsets


def radix_partition_padded(keys: torch.Tensor, payloads: torch.Tensor, seed,
                           num_partitions: int, block_rows: int) -> PartitionedRelation:
    """Fan-out with every partition padded to a multiple of ``block_rows``,
    in arrays of ``n + P * block_rows`` rows; padding rows hold key 0,
    payload 0 and ``row_ids == -1``."""
    n = keys.shape[0]
    device = keys.device
    pid = partition_ids(keys, seed, num_partitions)
    histogram, dense_offsets = _histogram(pid, num_partitions)
    padded_sizes = (histogram + (block_rows - 1)) // block_rows * block_rows
    padded_offsets = torch.cumsum(padded_sizes, 0, dtype=torch.int32) - padded_sizes
    total = n + num_partitions * block_rows
    pid_s, order = torch.sort(pid, stable=True)
    rank = torch.arange(n, dtype=torch.int32, device=device) - dense_offsets[pid_s]
    dst = (padded_offsets[pid_s] + rank).to(torch.int64)

    def place(values, fill):
        out = torch.full((total,), fill, dtype=values.dtype, device=device)
        return out.index_copy_(0, dst, values)

    return PartitionedRelation(
        keys=place(keys[order], 0),
        payloads=place(payloads[order], 0),
        row_ids=place(order.to(torch.int32), -1),
        histogram=histogram,
        offsets=padded_offsets,
    )
