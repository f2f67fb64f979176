"""Filtered composed query at reference scale (R7):

    SELECT b.key, COUNT(*), SUM(b.pay), MIN(b.pay), MAX(b.pay)
    FROM B JOIN A USING (key) WHERE b.pay % 2 = 0
    GROUP BY key ORDER BY COUNT(*) DESC LIMIT 10

Counterpart of ``scripts/bench_filtered_pipeline.py``.  The query layer's
R7 rule (R5∘R3) stages the filter: K5 compacts the probe relation first,
then the kernel pipeline (``two_run_materialize`` with K4, then
``aggregate_sorted``) runs on the survivors.  It is measured beside the
unfiltered plan, each best of 2 after a warmup, on the JAX script's
relations: build keys 1..N_A with payload ``key ^ 0x5A17``, probe keys
Zipf(SKEW) over [1, N_A] (seed 20260820), probe payloads uniform in
[0, 2^20) (seed 9), 2^24 group slots.

Oracles: the filtered plan's EXPLAIN must name R7, and its total group
COUNT must equal the survivor count of an independent masked kernel count
(``two_run_count`` with ``probe_valid``, K1).  Prints one JSON line (the
JAX script's five fields plus ``"device"``).  Env: PHJ_BENCH_PRIMARY,
PHJ_BENCH_SECONDARY, PHJ_BENCH_SKEW; ``--platform cpu`` replaces the JAX
script's PHJ_BENCH_INTERPRET.

    python -m partitionedhashjoin_tpu_torch.scripts.bench_filtered_pipeline
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
from partitionedhashjoin_tpu_torch.ops.merge_join import two_run_count
from partitionedhashjoin_tpu_torch.query import scan
from partitionedhashjoin_tpu_torch.scripts._common import (
    add_platform,
    best_of,
    generator,
    log,
    open_device,
)
from partitionedhashjoin_tpu_torch.utils.device import sync

SALT = 0x5A17
SEED = 20260820
PAYLOAD_SEED = 9
GROUP_CAPACITY = 1 << 24


def predicate(k, p):
    return p % 2 == 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = add_platform(argparse.ArgumentParser(
        description=__doc__.splitlines()[0])).parse_args(argv)
    device, kind = open_device(args.platform)
    n_a = int(os.environ.get("PHJ_BENCH_PRIMARY", 10_000_000))
    n_b = int(os.environ.get("PHJ_BENCH_SECONDARY", 200_000_000))
    skew = float(os.environ.get("PHJ_BENCH_SKEW", 1.05))
    log(f"device: {kind}; query over {n_a} ⋈ {n_b}, skew {skew}")
    t0 = time.perf_counter()
    a_keys = torch.arange(1, n_a + 1, dtype=torch.int32, device=device)
    a_pay = a_keys ^ SALT
    b_keys = generators.zipf_keys(n_b, skew, n_a, generator=generator(SEED, device),
                                  device=device)
    b_pay = torch.randint(0, 1 << 20, (n_b,), generator=generator(PAYLOAD_SEED, device),
                          dtype=torch.int32, device=device)
    sync(device)
    log(f"generate: {time.perf_counter() - t0:.3f}s")

    ta = make_table(a_keys, a_pay)
    tb = make_table(b_keys, b_pay)
    cap = GROUP_CAPACITY
    plans = {
        "filtered-R7": (
            scan(tb).filter(predicate).join(scan(ta))
            .group_by(group_capacity=cap)
            .order_by("count", descending=True).limit(10)
        ),
        "unfiltered": (
            scan(tb).join(scan(ta))
            .group_by(group_capacity=cap)
            .order_by("count", descending=True).limit(10)
        ),
    }
    plan_text = plans["filtered-R7"].explain()
    log("filtered plan:\n" + plan_text)
    if "R7" not in plan_text:
        raise AssertionError("planner must pick the staged kernel path")

    results = {}
    for name, q in plans.items():
        q.execute()  # warmup
        best = best_of(q.execute, 2, device)
        results[name] = (best, q.execute())
        log(
            f"join+group-by+top10 [{name}]: {best * 1e3:.3f} ms "
            f"-> {n_b / best:.6e} rows/s (input rows)"
        )

    # oracle: an independent masked kernel count equals the filtered plan's
    # total group COUNT (the group_by alone, no top-10 tail)
    survivors = int(two_run_count(a_keys, b_keys,
                                  probe_valid=predicate(b_keys, b_pay)))
    g_full = (
        scan(tb).filter(predicate).join(scan(ta))
        .group_by(group_capacity=cap).execute()
    )
    total = int(g_full.count.to(torch.int64).sum())
    if total != survivors:
        raise AssertionError((total, survivors))
    log(f"oracle: group-count total {total} == masked kernel count")

    t_f, t_u = results["filtered-R7"][0], results["unfiltered"][0]
    print(json.dumps({
        "metric": f"filtered_pipeline_ms_{n_a}x{n_b}_skew{skew}",
        "filtered_R7_ms": round(t_f * 1e3),
        "unfiltered_ms": round(t_u * 1e3),
        "filter_overhead_ms": round((t_f - t_u) * 1e3),
        "survivors": survivors,
        "top1_count": int(results["filtered-R7"][1].count[0]),
        "device": kind,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
