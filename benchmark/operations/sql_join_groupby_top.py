"""A JOIN → GROUP BY → ORDER BY count LIMIT k statement through the SQL
front end: ``sql.execute_sql(statement, {name: table})``, whose result
arrives on the host.  The traffic file gives the statement, which relation
each table name holds, and ``limit``, the statement's k."""

from __future__ import annotations

import time

from benchmark import bytes as model
from benchmark.reference import joins

#: Fields of the k result rows (and missing or extra rows, 5 fields each)
#: that differ from the reference; the answer is exact.
LIMITS = {"fields_wrong": 0}
COLUMNS = ("key", "count", "sum", "min", "max")
#: Calls of ``plan_sql`` timed by the traced run.
PLAN_CALLS = 50


class Operation:
    LIMITS = LIMITS

    def __init__(self, traffic: dict, seed: int) -> None:
        from partitionedhashjoin_tpu_torch import sql

        self._sql = sql
        self._statement = traffic["statement"]
        self._tables = traffic["tables"]
        self._k = int(traffic["limit"])

    def inputs(self, build, probe):
        from partitionedhashjoin_tpu_torch.data.table import make_table

        rel = {"build": build, "probe": probe}
        return {name: make_table(rel[side].keys, rel[side].payloads)
                for name, side in self._tables.items()}

    def run(self, inputs):
        res = self._sql.execute_sql(self._statement, inputs)
        return {c: res.columns[c] for c in COLUMNS}, None

    def reference(self, build, probe) -> dict:
        return joins.join_groupby_top(build.keys, probe.keys, probe.payloads,
                                      self._k)

    def control(self, build, probe, seed: int) -> dict:
        import torch

        return joins.join_groupby_top(build.keys, probe.keys, probe.payloads,
                                      self._k, sum_dtype=torch.float32)

    def compare(self, answer, want) -> dict:
        wrong = 0
        for c in COLUMNS:
            got, ref = list(answer[c]), list(want[c])
            wrong += sum(int(g) != int(r) for g, r in zip(got, ref))
            wrong += abs(len(got) - len(ref))
        return {"fields_wrong": wrong}

    def compulsory_bytes(self, build, probe) -> int:
        return model.join_groupby_bytes(build.rows, probe.rows,
                                        build.keys.element_size())

    def trace_extras(self, inputs) -> dict:
        t0 = time.perf_counter()
        for _ in range(PLAN_CALLS):
            self._sql.plan_sql(self._statement, inputs)
        return {"sql_plan_ms": (time.perf_counter() - t0) / PLAN_CALLS * 1e3}
