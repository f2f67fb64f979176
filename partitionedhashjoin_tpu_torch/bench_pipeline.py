"""Composed analytics query, JOIN → GROUP BY → ORDER BY count LIMIT 10:

    SELECT b.key, COUNT(*), SUM(b.pay), MIN(b.pay), MAX(b.pay)
    FROM B JOIN A USING (key) GROUP BY key    -- then ORDER BY count LIMIT 10

Counterpart of the hand-built half of ``scripts/bench_pipeline.py``.  The
ordered plan rides the engine's order-propagation rule: the materialized
kernel join (``two_run_materialize(probe_payload_sorted=True)``) emits
key-ordered output with payload-ascending runs, so the GROUP BY
(``aggregate_sorted(payload_sorted=True)``) sorts nothing.  The naive plan
materializes and then re-sorts the relation (``sort_aggregate``).  The two
must agree on every group field, and every probe row must match.  Then the
same query goes through the declarative layers: the fluent plan
(``query.scan(...).join(...).group_by().order_by("count", descending=True)
.limit(10)``), whose EXPLAIN must name R3, and the SQL statement ``SQL``,
which must lower to R3 too; both must return the hand-built ordered plan's
top 10 (keys and counts).

Run from the repository root:

    python -m partitionedhashjoin_tpu_torch.bench_pipeline            # the card
    python -m partitionedhashjoin_tpu_torch.bench_pipeline --platform cpu \\
        --primary 20000 --secondary 200000                            # smoke

It prints one JSON line with the JAX script's metric name and fields
(``query_layer_ms`` and ``sql_ms`` among them, each the best of two runs
after a warmup, closed by a barrier), and the device it ran on.
Relations, as in the JAX script: build keys 1..N_A with payload
``key ^ 0x5A17``, probe keys Zipf(``SKEW``) over [1, N_A] (seed
``SEED``), probe payloads uniform in [0, 2^20) from a generator seeded with
``PAYLOAD_SEED``; the GROUP BY capacity is ``GROUP_CAPACITY``.  The query's
sorts run through K6 (``sort_impl`` is ``merge_join.SORT_IMPL``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import torch

from partitionedhashjoin_tpu_torch.data.table import make_table
from partitionedhashjoin_tpu_torch.ops import generators, merge_join
from partitionedhashjoin_tpu_torch.ops.aggregate import aggregate_sorted, sort_aggregate
from partitionedhashjoin_tpu_torch.ops.merge_join import two_run_materialize
from partitionedhashjoin_tpu_torch.ops.order_by import top_k
from partitionedhashjoin_tpu_torch.query import scan
from partitionedhashjoin_tpu_torch.sql import execute_sql, explain_sql
from partitionedhashjoin_tpu_torch.utils.device import resolve_device, sync

#: The reference's best JOIN throughput (200M rows in 1.196 s, BASELINE.md),
#: as scale context for ``vs_baseline``.
BASELINE_ROWS_PER_S = 200e6 / 1.196
SALT = 0x5A17
SKEW = 1.05
#: seed of the Zipf probe keys
SEED = 20260819
#: seed of the probe payloads
PAYLOAD_SEED = 9
GROUP_CAPACITY = 1 << 24
GROUP_FIELDS = ("keys", "count", "sum", "min", "max")
#: The query as SQL over tables "a" (build) and "b" (probe).
SQL = ("SELECT key, COUNT(*), SUM(b.payload), MIN(b.payload), MAX(b.payload) "
       "FROM b JOIN a USING (key) GROUP BY key ORDER BY count DESC LIMIT 10")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_query(a_keys, a_pay, b_keys, b_pay, cap: int, ordered: bool):
    """materialize → GROUP BY (order-propagating or naive) → top-10 by
    count; returns ``(GroupByResult, top-10 Table (count, key), count)``
    after the device has finished."""
    keys, _, pb, count = two_run_materialize(
        a_keys, a_pay, b_keys, b_pay, probe_payload_sorted=ordered
    )
    t = make_table(keys, pb)
    if ordered:
        g = aggregate_sorted(t, group_capacity=cap, n_valid=count,
                             payload_sorted=True)
    else:
        g = sort_aggregate(t, group_capacity=cap)
    hot = top_k(make_table(g.count, g.keys), 10, by="key", descending=True)
    sync(keys.device)
    return g, hot, count


def make_relations(n_a: int, n_b: int, device):
    """(a_keys, a_pay, b_keys, b_pay) of the pipeline's query."""
    a_keys = torch.arange(1, n_a + 1, dtype=torch.int32, device=device)
    a_pay = a_keys ^ SALT
    b_keys = generators.zipf_table(n_b, SKEW, (1, n_a), seed=SEED,
                                   device=device).keys
    gen = torch.Generator(device=device)
    gen.manual_seed(PAYLOAD_SEED)
    b_pay = torch.randint(0, 1 << 20, (n_b,), generator=gen,
                          dtype=torch.int32, device=device)
    return a_keys, a_pay, b_keys, b_pay


def best_of_two(fn, device) -> float:
    """Seconds of the faster of two runs of ``fn`` after a warmup, each
    closed by a barrier."""
    fn()
    sync(device)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def plans_agree(g1, g2) -> bool:
    """Both GROUP BY results hold the same groups, field for field."""
    n = int(g1.num_groups)
    if n != int(g2.num_groups):
        return False
    return all(
        torch.equal(getattr(g1, f)[:n], getattr(g2, f)[:n]) for f in GROUP_FIELDS
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--primary", type=int, default=10_000_000)
    p.add_argument("--secondary", type=int, default=200_000_000)
    p.add_argument("--platform", default="cuda",
                   help="torch device: 'cuda' (default) or 'cpu'")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.platform)
    n_a, n_b, skew = args.primary, args.secondary, SKEW
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    log(f"device: {kind}; query over {n_a} ⋈ {n_b}, skew {skew}")
    t0 = time.perf_counter()
    rel = make_relations(n_a, n_b, device)
    sync(device)
    log(f"generate: {time.perf_counter() - t0:.3f} s")

    results = {}
    for name, ordered in (("ordered", True), ("naive-resort", False)):
        run_query(*rel, GROUP_CAPACITY, ordered)  # warmup
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            g, hot, count = run_query(*rel, GROUP_CAPACITY, ordered)
            best = min(best, time.perf_counter() - t0)
        results[name] = (best, g, hot, int(count))
        log(f"join+group-by+top10 [{name}]: {best * 1e3:.3f} ms "
            f"-> {n_b / best:.6e} rows/s")

    # oracle: every probe row matches, and the two plans agree on everything
    (best, g1, hot1, c1), (_, g2, hot2, c2) = results.values()
    if not c1 == c2 == n_b:
        raise AssertionError(f"join counts {c1}, {c2}; want {n_b}")
    if not plans_agree(g1, g2) or not torch.equal(hot1.keys, hot2.keys):
        raise AssertionError("the ordered and naive plans disagree")
    log(f"oracle: {int(g1.num_groups)} groups, plans identical, top-1 count "
        f"{int(hot1.keys[0])}")
    # the top 10 of the hand-built ordered plan: group keys and counts
    want_keys, want_counts = hot1.payloads.tolist(), hot1.keys.tolist()
    naive_s = results["naive-resort"][0]
    del results, g1, g2, hot1, hot2, g, hot

    # the declarative layer must pick the ordered plan by itself (R3 + R4)
    db = {"a": make_table(*rel[:2]), "b": make_table(*rel[2:])}
    q = (scan(db["b"]).join(scan(db["a"])).group_by(group_capacity=GROUP_CAPACITY)
         .order_by("count", descending=True).limit(10))
    plan_text = q.explain()
    log("query-layer plan:\n" + plan_text)
    if "R3" not in plan_text:
        raise AssertionError("the query layer must pick the ordered plan (R3)")
    query_s = best_of_two(q.execute, device)
    top = q.execute()
    log(f"join+group-by+top10 [query-layer]: {query_s * 1e3:.3f} ms -> "
        f"{n_b / query_s:.6e} rows/s")
    if (top.keys[:10].tolist(), top.count[:10].tolist()) != (want_keys, want_counts):
        raise AssertionError("the query layer disagrees with the hand-built plan")
    del top

    # the SQL surface must lower to the same plan and agree on the result
    if "R3" not in explain_sql(SQL, db, group_capacity=GROUP_CAPACITY):
        raise AssertionError("SQL must lower to the ordered plan (R3)")
    sql_s = best_of_two(
        lambda: execute_sql(SQL, db, group_capacity=GROUP_CAPACITY), device)
    rs = execute_sql(SQL, db, group_capacity=GROUP_CAPACITY)
    log(f"join+group-by+top10 [sql]: {sql_s * 1e3:.3f} ms -> "
        f"{n_b / sql_s:.6e} rows/s")
    if (rs.columns["key"].tolist(), rs.columns["count"].tolist()) != (
            want_keys, want_counts):
        raise AssertionError("SQL disagrees with the hand-built plan")
    print(json.dumps({
        "metric": f"query_join_groupby_rows_per_s_{n_a}x{n_b}_skew{skew}",
        "value": round(n_b / best),
        "unit": "rows/s",
        "vs_baseline": round(n_b / best / BASELINE_ROWS_PER_S, 3),
        "naive_resort_ms": round(naive_s * 1e3),
        "ordered_ms": round(best * 1e3),
        "query_layer_ms": round(query_s * 1e3),
        "sql_ms": round(sql_s * 1e3),
        "sort_impl": merge_join.SORT_IMPL,
        "device": kind,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
