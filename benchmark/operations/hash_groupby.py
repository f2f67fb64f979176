"""A hash GROUP BY key with COUNT, SUM, MIN and MAX over the probe relation,
through the program's exported entry: ``hash_aggregate(make_table(keys,
payloads), timer=timer)``, at the program's default hash seed, as a
deployment runs it: ``--seed`` makes the data and not the table's layout.
The build relation is made and not read.

The answer is worked out on the device from the program's ``GroupByResult``
by the reference's own summary (``reference/groupby.answer``): the number of
groups, a digest of every group, and the 10 heaviest groups in full; it
reaches the host as Python ints.  The phases are the timer's build (the
dedup claim loop) and probe (the grouping and the scatters) and the claim
loop's rounds (``hash_table.CLAIM_ROUNDS``)."""

from __future__ import annotations

import torch

from benchmark.reference import groupby

#: Exact answers: the group count, the digest (1 if it differs) and the
#: fields of the top groups (and 5 for each missing or extra group).
LIMITS = {"groups_gap": 0, "digest_wrong": 0, "fields_wrong": 0}
#: Bytes of one probe row read: an int64 key and an int64 payload.
ROW_BYTES = 16
#: Bytes of one group written: key, SUM, MIN and MAX int64, COUNT int32.
GROUP_BYTES = 36


def groupby_bytes(rows: int, groups: int) -> int:
    """Every row read once, every group written once."""
    return ROW_BYTES * rows + GROUP_BYTES * groups


class Operation:
    LIMITS = LIMITS

    def __init__(self, traffic: dict, seed: int) -> None:
        import partitionedhashjoin_tpu_torch as program
        from partitionedhashjoin_tpu_torch.ops import hash_table
        from partitionedhashjoin_tpu_torch.utils import results

        self._program = program
        self._hash_table = hash_table
        self._results = results

    def inputs(self, build, probe):
        from partitionedhashjoin_tpu_torch.data.table import make_table

        return make_table(probe.keys, probe.payloads)

    def run(self, table):
        timer = self._results.HashJoinTimer(self._results.Parameters())
        rounds = self._hash_table.CLAIM_ROUNDS
        g = self._program.hash_aggregate(table, timer=timer)
        rounds = self._hash_table.CLAIM_ROUNDS - rounds
        n = int(g.num_groups)
        answer = groupby.answer(g.keys[:n], g.count[:n], g.sum[:n],
                                g.min[:n], g.max[:n])
        r = timer.get_result()
        return answer, {"build": r.get_build_phase_duration(),
                        "probe": r.get_probe_phase_duration(),
                        "claim_rounds": rounds}

    def reference(self, build, probe) -> dict:
        return groupby.groupby_answer(probe.keys, probe.payloads)

    def control(self, build, probe, seed: int) -> dict:
        return groupby.groupby_answer(probe.keys, probe.payloads,
                                      sum_dtype=torch.float32)

    def compare(self, answer, want) -> dict:
        wrong = 0
        for c in groupby.COLUMNS:
            got, ref = answer["top"][c], want["top"][c]
            wrong += sum(g != r for g, r in zip(got, ref))
            wrong += abs(len(got) - len(ref))
        return {"groups_gap": abs(answer["num_groups"] - want["num_groups"]),
                "digest_wrong": int(answer["digest"] != want["digest"]),
                "fields_wrong": wrong}

    def compulsory_bytes(self, build, probe) -> int:
        return groupby_bytes(probe.rows, torch.unique(probe.keys).numel())

    def trace_extras(self, inputs) -> dict:
        return {}
