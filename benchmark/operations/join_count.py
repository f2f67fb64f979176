"""A count join through one of the program's joiners: ``Joiner(Config(**
configuration), seed=--seed).run(a, b, timer)``, the count read back."""

from __future__ import annotations

from benchmark import bytes as model
from benchmark.reference import joins

#: The count is exact: no gap is allowed.
LIMITS = {"count_gap": 0}


class Operation:
    LIMITS = LIMITS

    def __init__(self, traffic: dict, seed: int) -> None:
        from partitionedhashjoin_tpu_torch import config
        from partitionedhashjoin_tpu_torch.ops.no_partitioning import (
            NoPartitioningHashJoiner,
        )
        from partitionedhashjoin_tpu_torch.ops.radix_cluster import RadixHashJoiner
        from partitionedhashjoin_tpu_torch.utils import results

        kinds = {
            "radix": (RadixHashJoiner, config.RadixClusteringConfiguration),
            "no_partitioning": (NoPartitioningHashJoiner,
                                config.NoPartitioningConfiguration),
        }
        joiner, conf = kinds[traffic["joiner"]]
        self._joiner = joiner(conf(**traffic["configuration"]), seed=seed)
        self._results = results

    def inputs(self, build, probe):
        from partitionedhashjoin_tpu_torch.data.table import make_table

        return (make_table(build.keys, build.payloads),
                make_table(probe.keys, probe.payloads))

    def run(self, inputs):
        timer = self._results.HashJoinTimer(self._results.Parameters())
        count = self._joiner.run(*inputs, timer)
        r = timer.get_result()
        return count, {"partition": r.get_partitioning_phase_duration(),
                       "build": r.get_build_phase_duration(),
                       "probe": r.get_probe_phase_duration()}

    def reference(self, build, probe) -> int:
        return joins.semi_join_count(build.keys, probe.keys)

    def control(self, build, probe, seed: int) -> int:
        return joins.control_sampled_count(build.keys, probe.keys, seed)

    def compare(self, answer, want) -> dict:
        return {"count_gap": abs(int(answer) - int(want))}

    def compulsory_bytes(self, build, probe) -> int:
        return model.count_join_bytes(build.rows, probe.rows,
                                      build.keys.element_size())

    def trace_extras(self, inputs) -> dict:
        return {}
