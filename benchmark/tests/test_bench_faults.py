"""A run with the timed path broken underneath, in the program, comes out not
correct: for each fault a cell can have.  The harness's look for a card is
skipped (the CPU runs the kernels' plain versions); the rest of a run is
driven as on the card.

Not here: a fault of the exchange between chips (every cell takes one) and,
for the count cells, a stale answer or a count of every probe row: on both
configurations every probe key is among the build keys, so every variant's
count is its probe size, which both faults give.  The statement's answer
holds no more than a GROUP BY over the probe relation alone would: with
unique build keys that all match, it does not depend on the join either.
"""

import dataclasses

import pytest
import torch

from benchmark import run
from conftest import SEED, tiny_bench, tiny_layout
from partitionedhashjoin_tpu_torch import sql
from partitionedhashjoin_tpu_torch.ops import aggregate, merge_join, sort_merge
from partitionedhashjoin_tpu_torch.ops import hash_table as ht
from partitionedhashjoin_tpu_torch.ops.kernels import merge_probe


def _half(tensor):
    return tensor[: tensor.shape[0] // 2]


def half_radix(mp):
    orig = merge_join.sorted_runs_count
    mp.setattr(merge_join, "sorted_runs_count", lambda a, b: orig(a, _half(b)))


def altered_radix(mp):
    orig = merge_join.sorted_runs_count
    mp.setattr(merge_join, "sorted_runs_count", lambda a, b: orig(a, b) + 1)


def half_chained(mp):
    orig = ht.probe_chained_count
    mp.setattr(ht, "probe_chained_count", lambda t, k, *a, **kw: orig(t, _half(k), *a, **kw))


def altered_chained(mp):
    orig = ht.probe_chained_count
    mp.setattr(ht, "probe_chained_count", lambda *a, **kw: orig(*a, **kw) + 1)


def half_radix_i64(mp):
    orig = merge_probe.ranged_merge_count_i64
    mp.setattr(merge_probe, "ranged_merge_count_i64", lambda a, b: orig(a, _half(b)))


def altered_radix_i64(mp):
    orig = merge_probe.ranged_merge_count_i64
    mp.setattr(merge_probe, "ranged_merge_count_i64", lambda a, b: orig(a, b) + 1)


def half_sql(mp):
    orig = sort_merge.sort_merge_materialize_typed

    def broken(a_keys, a_pay, b_keys, b_pay, *a, **kw):
        if kw.get("probe_valid") is not None:
            kw["probe_valid"] = _half(kw["probe_valid"])
        return orig(a_keys, a_pay, _half(b_keys), _half(b_pay), *a, **kw)
    mp.setattr(sort_merge, "sort_merge_materialize_typed", broken)


def altered_sql(mp):
    orig = aggregate.filter_sort_aggregate

    def broken(*a, **kw):
        g, n = orig(*a, **kw)
        return dataclasses.replace(g, sum=g.sum + 1), n
    mp.setattr(aggregate, "filter_sort_aggregate", broken)


def stale_sql(mp):
    orig, last = sql.execute_sql, []

    def broken(*a, **kw):
        if not last:
            last.append(orig(*a, **kw))
        return last[0]
    mp.setattr(sql, "execute_sql", broken)


FAULTS = [
    ("upstream_radix", half_radix_i64), ("upstream_radix", altered_radix_i64),
    ("kimb_radix", half_radix), ("kimb_radix", altered_radix),
    ("kimb_nopart_chained", half_chained),
    ("kimb_nopart_chained", altered_chained),
    ("upstream_sql_top10", half_sql), ("upstream_sql_top10", altered_sql),
    ("upstream_sql_top10", stale_sql),
]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result, lines = run.execute(tiny_bench(), workload, SEED, 0.2, False,
                                torch.device("cpu"), tiny_layout())
    assert result["failed"] == 0
    assert not result["correct"], lines
    assert any(v["value"] > v["limit"] for v in result["checks"].values())
