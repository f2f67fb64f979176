"""Filter + GROUP BY pipeline benchmark (BASELINE.json configs[3]).

Counterpart of ``scripts/bench_operators.py``.  Runs the predicate filter
``(payload & 1) == 0`` into the sort-based GROUP BY over the reference-scale
table (200M Zipf(1.05) keys over a 10M domain, payload = row index, 2^24
group slots) through two pipelines: "fused" (``filter_sort_aggregate``: the
mask becomes the GROUP BY's validity) and "staged"
(``filter_sort_aggregate_staged``: K5 compacts the survivors first, then the
aggregate runs over them).  Each runs once untimed, then best of 2.  The two
group counts must agree and the selection must be n / 2.  Prints one JSON
line (the JAX script's keys, the winning pipeline among them, plus
``"device"``); ``vs_baseline`` is rows/s against the reference's best JOIN
throughput, for scale only (the reference has no aggregate).

Env: PHJ_BENCH_SECONDARY (rows, 200M), PHJ_BENCH_PRIMARY (key domain, 10M),
PHJ_BENCH_SKEW (1.05), PHJ_BENCH_FUSED_ONLY=1 (skip "staged").

    python -m partitionedhashjoin_tpu_torch.scripts.bench_operators
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

import torch

from partitionedhashjoin_tpu_torch.data.table import make_table
from partitionedhashjoin_tpu_torch.ops import generators
from partitionedhashjoin_tpu_torch.ops.aggregate import (
    filter_sort_aggregate,
    filter_sort_aggregate_staged,
)
from partitionedhashjoin_tpu_torch.scripts._common import (
    BASELINE_ROWS_PER_S,
    add_platform,
    best_of,
    generator,
    log,
    open_device,
)
from partitionedhashjoin_tpu_torch.utils.device import sync

SEED = 20260817
#: 16M group slots >= the 10M domain
GROUP_CAPACITY = 1 << 24


def predicate(k, p):
    """Half the rows: the even payloads (row indices)."""
    return (p & 1) == 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = add_platform(argparse.ArgumentParser(
        description=__doc__.splitlines()[0])).parse_args(argv)
    device, kind = open_device(args.platform)
    n = int(os.environ.get("PHJ_BENCH_SECONDARY", 200_000_000))
    domain = int(os.environ.get("PHJ_BENCH_PRIMARY", 10_000_000))
    skew = float(os.environ.get("PHJ_BENCH_SKEW", 1.05))
    log(f"device: {kind}; GROUP BY over {n} rows, {domain} domain")

    t0 = time.perf_counter()
    keys = generators.zipf_keys(n, skew, domain, generator=generator(SEED, device),
                                device=device)
    pay = torch.arange(n, dtype=torch.int32, device=device)
    table = make_table(keys, pay)
    sync(device)
    log(f"generate: {time.perf_counter() - t0:.3f}s")

    cap = GROUP_CAPACITY
    pipelines = {"fused": filter_sort_aggregate}
    if os.environ.get("PHJ_BENCH_FUSED_ONLY", "") != "1":
        pipelines["staged"] = filter_sort_aggregate_staged

    results = {}
    nums = set()
    for name, fn in pipelines.items():
        g, count = fn(table, predicate, group_capacity=cap)  # warmup
        num = int(g.num_groups)
        if num > cap:
            raise AssertionError(f"{name}: group capacity overflow: {num}")
        nums.add(num)
        sel = int(count)
        if sel != n // 2:
            raise AssertionError((name, sel))
        del g, count
        best = best_of(lambda: fn(table, predicate, group_capacity=cap), 2, device)
        results[name] = best
        log(
            f"filter+group-by [{name}]: {best * 1e3:.3f} ms over {n} rows "
            f"({num} groups) -> {n / best:.6e} rows/s"
        )
    if len(nums) != 1:
        raise AssertionError(f"pipeline group counts disagree: {nums}")
    winner = min(results, key=results.get)
    rows_per_s = n / results[winner]
    print(json.dumps({
        "metric": f"filter_groupby_rows_per_s_{n}_skew{skew}",
        "value": round(rows_per_s),
        "unit": "rows/s",
        "vs_baseline": round(rows_per_s / BASELINE_ROWS_PER_S, 3),
        "pipeline": winner,
        "device": kind,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
