"""No-partitioning join (Blanas SIGMOD'11, algorithm 1), the CLI's default.

Counterpart of ``partitionedhashjoin_tpu/ops/no_partitioning.py::
NoPartitioningHashJoiner`` and of the reference's
src/NoPartitioning/HashJoin.hpp:14-187: one global structure built over the
whole build relation, then the probe relation streamed against it, counting
probe rows that find a match (``Get`` != null, HashJoin.hpp:144-157).  No
partitioning phase, so the timer's partition phase stays 0, as in the
reference.  Two layouts of the global structure
(``NoPartitioningConfiguration.mode``):

- ``"vmem"`` (and ``"auto"``, which is "vmem" on every device): the SORTED
  build run (``merge_join.PreparedBuild``).  Build = one sort of A; probe =
  one sort of B and the merge-probe kernel (K1 for int32 keys, K3 for
  int64).  The JAX joiner's dispatch windows (``vmem_probe_chunk_rows``)
  exist for the TPU's watchdog and are not ported: the port probes in one
  call.
- ``"chained"``: the literal hash table, ``ops/hash_table.py``'s chained
  table.  Build = the hash (K7) and one stable sort by bucket; probe = one
  launch of ``chained_count_kernel`` (``ops/kernels/chained_probe.py``), one
  thread per probe row walking its chain (no ``probe_chunk_rows``
  windows).  int32 and int64 keys: an int64 key keeps
  its 8 bytes in the table and in every compare, and K7's int64 kernel
  hashes it (the JAX joiner's chained mode is 32-bit); a build and a probe
  of different widths compare at int64.

``run_materialize`` (an engine extension) builds the chained table and
returns the matching probe rows, first build match each, compacted to the
front in probe order by the stream-compaction kernel K5.  Payloads of any
width keep their dtype: K5 carries int32 lanes, so a 64-bit column rides as
its two 32-bit halves and an 8- or 16-bit one widened from its bits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from partitionedhashjoin_tpu_torch.config import NoPartitioningConfiguration
from partitionedhashjoin_tpu_torch.data.table import JoinedTable, Table
from partitionedhashjoin_tpu_torch.ops import hash_table as ht
from partitionedhashjoin_tpu_torch.ops import merge_join
from partitionedhashjoin_tpu_torch.ops.kernels import compact as kcompact
from partitionedhashjoin_tpu_torch.utils.device import sync
from partitionedhashjoin_tpu_torch.utils.logger import get_new_logger
from partitionedhashjoin_tpu_torch.utils.results import (
    IHashJoinTimer,
    NoOpHashJoinTimer,
)


def resolve_mode(mode: str) -> str:
    """"auto" → "vmem"; "vmem" and "chained" as they are; anything else is
    an error."""
    if mode == "auto":
        return "vmem"
    if mode not in ("vmem", "chained"):
        raise ValueError(f"unknown mode {mode!r}")
    return mode


def hash_seed(seed: Optional[int]) -> int:
    """A joiner's 32-bit hash seed: ``seed & 0xFFFFFFFF``, or OS entropy
    when it is None (the per-instance random hasher, XXHasher.hpp:12-17)."""
    if seed is None:
        seed = int(np.random.SeedSequence().entropy & 0xFFFFFFFF)
    return seed & 0xFFFFFFFF


def _probe_gather(table: ht.ChainedHashTable, probe_keys, build_payloads,
                  probe_payloads):
    """``(keys, pay_a, pay_b, count)``: the probe rows that match, each with
    its first build match's payload, compacted to the front in probe order
    with a zero tail (K5 on the card), each in its column's dtype."""
    found, build_row = ht.probe_chained_get(table, probe_keys)
    n = probe_keys.shape[0]
    if build_payloads.numel():
        pay_a = build_payloads.index_select(0, torch.clamp(build_row, min=0))
    else:  # no build row: nothing matches
        pay_a = build_payloads.new_zeros((n,))
    count, _, *outs = kcompact.compact_any(
        found, (probe_keys, pay_a, probe_payloads), n)
    return (*outs, count)


class NoPartitioningHashJoiner:
    """Joiner mirroring HashJoiner<Factory> (HashJoin.hpp:14-41).

    ``run(table_a, table_b, timer)`` builds over ``table_a`` and probes with
    ``table_b`` (HashJoin.hpp:54-74).  Each phase ends with a device barrier
    before its timer stops, so build/probe attribution is exact.  ``seed``
    seeds the chained table's hash (OS entropy when None).
    """

    def __init__(
        self,
        configuration: Optional[NoPartitioningConfiguration] = None,
        seed: Optional[int] = None,
    ) -> None:
        self._config = configuration or NoPartitioningConfiguration()
        self._seed = hash_seed(seed)
        self._logger = get_new_logger("NoPartitioningHashJoiner")

    def build(self, table_a: Table) -> ht.ChainedHashTable:
        """The chained table over A: one hash and one stable sort (the
        reference's parallel latched insert loop, HashJoin.hpp:76-126)."""
        num_buckets = ht.chained_num_buckets(table_a.size)
        table = ht.build_chained(table_a.keys, self._seed, num_buckets)
        sync(table.entry_rows.device)
        return table

    def run(
        self,
        table_a: Table,
        table_b: Table,
        timer: Optional[IHashJoinTimer] = None,
    ) -> int:
        """Build over A, probe with B, return the match count; each phase
        is closed by a barrier (the probe's by ``.item()``)."""
        timer = timer or NoOpHashJoinTimer()
        chained = resolve_mode(self._config.mode) == "chained"
        timer.set_build_phase_begin()
        if chained:
            structure = self.build(table_a)
        else:
            structure = merge_join.PreparedBuild(table_a.keys)
            sync(structure.a_sorted.device)
        timer.set_build_phase_end()

        timer.set_probe_phase_begin()
        if chained:
            count = ht.probe_chained_count(structure, table_b.keys)
        else:
            count = structure.count(table_b.keys)
        count = int(count.item())
        timer.set_probe_phase_end()
        self._logger.info("Number of joined tuples: %d", count)
        return count

    def run_materialize(
        self,
        table_a: Table,
        table_b: Table,
        timer: Optional[IHashJoinTimer] = None,
    ) -> JoinedTable:
        """The first-match join rows: a ``JoinedTable`` whose first
        ``count`` rows are the matching probe rows in probe order (probe
        key, the first build row's payload, probe payload), zeros after
        them.  Builds the chained table whatever the mode."""
        timer = timer or NoOpHashJoinTimer()
        timer.set_build_phase_begin()
        hash_tbl = self.build(table_a)
        timer.set_build_phase_end()

        timer.set_probe_phase_begin()
        keys, pay_a, pay_b, count = _probe_gather(
            hash_tbl, table_b.keys, table_a.payloads, table_b.payloads
        )
        sync(count.device)
        timer.set_probe_phase_end()
        return JoinedTable(
            keys=keys, payloads_a=pay_a, payloads_b=pay_b, count=count
        )
