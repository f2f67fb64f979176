"""No-partitioning join (Blanas SIGMOD'11, algorithm 1), the CLI's default.

Counterpart of ``partitionedhashjoin_tpu/ops/no_partitioning.py::
NoPartitioningHashJoiner`` in its "vmem" mode, and of the reference's
src/NoPartitioning/HashJoin.hpp:14-187: one global structure built over the
whole build relation, then the probe relation streamed against it, counting
probe rows that find a match (``Get`` != null, HashJoin.hpp:144-157).

The global structure is the SORTED build run (``merge_join.PreparedBuild``):
build = one sort of A; probe = one sort of B and the merge-probe kernel (K1
for int32 keys, K3 for int64).  No partitioning phase, so the timer's
partition phase stays 0, as in the reference.

Ported: mode "vmem", and "auto", which is "vmem" on every device.  The
"chained" mode (the literal hash table probed by gathers) and ``build()``
raise ``NotImplementedError`` (ROADMAP Queue 1 item 7).  The JAX joiner's
dispatch windows (``vmem_probe_chunk_rows``) exist for the TPU's watchdog
and are not ported: the port probes in one call.
"""

from __future__ import annotations

from typing import Optional

from partitionedhashjoin_tpu_torch.config import NoPartitioningConfiguration
from partitionedhashjoin_tpu_torch.data.table import Table
from partitionedhashjoin_tpu_torch.ops import merge_join
from partitionedhashjoin_tpu_torch.utils.device import sync
from partitionedhashjoin_tpu_torch.utils.logger import get_new_logger
from partitionedhashjoin_tpu_torch.utils.results import (
    IHashJoinTimer,
    NoOpHashJoinTimer,
)

_CHAINED = (
    "the chained hash-table mode is not ported yet (ROADMAP.md, Queue 1 "
    "item 7); use mode 'vmem' or 'auto'"
)


def resolve_mode(mode: str) -> str:
    """"auto" → "vmem"; "chained" raises; anything else is an error."""
    if mode in ("auto", "vmem"):
        return "vmem"
    if mode == "chained":
        raise NotImplementedError(_CHAINED)
    raise ValueError(f"unknown mode {mode!r}")


class NoPartitioningHashJoiner:
    """Joiner mirroring HashJoiner<Factory> (HashJoin.hpp:14-41).

    ``run(table_a, table_b, timer)`` builds over ``table_a`` and probes with
    ``table_b`` (HashJoin.hpp:54-74).  Each phase ends with a device barrier
    before its timer stops, so build/probe attribution is exact.
    """

    def __init__(
        self,
        configuration: Optional[NoPartitioningConfiguration] = None,
        seed: Optional[int] = None,
    ) -> None:
        self._config = configuration or NoPartitioningConfiguration()
        # seed is unused (the sorted structure is hash-free); kept for API
        # symmetry with the JAX joiner
        self._logger = get_new_logger("NoPartitioningHashJoiner")

    def build(self, table_a: Table):
        """The chained hash table's build; not ported yet."""
        raise NotImplementedError(_CHAINED)

    def run(
        self,
        table_a: Table,
        table_b: Table,
        timer: Optional[IHashJoinTimer] = None,
    ) -> int:
        """Build over A, probe with B, return the match count.

        Build = ``PreparedBuild(table_a.keys)`` (the sort of A); probe =
        ``prepared.count(table_b.keys)`` (the sort of B and the kernel),
        closed by ``.item()``.
        """
        resolve_mode(self._config.mode)
        timer = timer or NoOpHashJoinTimer()
        timer.set_build_phase_begin()
        prepared = merge_join.PreparedBuild(table_a.keys)
        sync(prepared.a_sorted.device)
        timer.set_build_phase_end()

        timer.set_probe_phase_begin()
        count = int(prepared.count(table_b.keys).item())
        timer.set_probe_phase_end()
        self._logger.info("Number of joined tuples: %d", count)
        return count
