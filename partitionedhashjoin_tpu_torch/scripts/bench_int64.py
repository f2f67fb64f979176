"""int64-key benchmark row: the reference's Tuple::id width (Table.hpp:20-25).

Counterpart of ``scripts/bench_int64.py``.  Runs the 10M ⋈ 200M workload
with int64 keys through ``SortMergeJoiner`` (``two_run_count_i64``: one
sort per relation, then K3) and prints one JSON line, as the JAX script
does, plus ``"device"``.  The keys spread over the full 64-bit range,
``key = zipf_id · 2^33 + 12345 − 2^62`` (``int64_keys``), so both 32-bit
halves carry entropy and no int32 shortcut could answer.  ``vs_baseline``
is against the C++ reference's best CPU figure, 200M rows in 1.196 s.

Env: PHJ_BENCH_PRIMARY (10M), PHJ_BENCH_SECONDARY (200M), PHJ_BENCH_SKEW
(1.05).  Run from the repository root:

    python -m partitionedhashjoin_tpu_torch.scripts.bench_int64              # the card
    PHJ_BENCH_PRIMARY=5000 PHJ_BENCH_SECONDARY=70000 \\
        python -m partitionedhashjoin_tpu_torch.scripts.bench_int64 --platform cpu
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
from partitionedhashjoin_tpu_torch.ops.sort_merge import SortMergeJoiner
from partitionedhashjoin_tpu_torch.scripts._common import (
    BASELINE_ROWS_PER_S,
    add_platform,
    generator,
    log,
    open_device,
)
from partitionedhashjoin_tpu_torch.utils.device import sync

#: seed of the Zipf ids
SEED = 20260817
SPREAD = 1 << 33
OFFSET = 12345 - (1 << 62)


def int64_keys(ids: torch.Tensor) -> torch.Tensor:
    """``ids · 2^33 + 12345 − 2^62`` as int64."""
    return ids.to(torch.int64) * SPREAD + OFFSET


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = add_platform(argparse.ArgumentParser(
        description=__doc__.splitlines()[0])).parse_args(argv)
    device, kind = open_device(args.platform)
    n_a = int(os.environ.get("PHJ_BENCH_PRIMARY", 10_000_000))
    n_b = int(os.environ.get("PHJ_BENCH_SECONDARY", 200_000_000))
    skew = float(os.environ.get("PHJ_BENCH_SKEW", 1.05))
    log(f"device: {kind}; int64 workload {n_a} ⋈ {n_b}")

    t0 = time.perf_counter()
    ids32 = generators.zipf_keys(n_b, skew, n_a, generator=generator(SEED, device),
                                 device=device)
    keys_b = int64_keys(ids32)
    del ids32
    keys_a = int64_keys(torch.arange(1, n_a + 1, dtype=torch.int64, device=device))
    table_a = make_table(keys_a, torch.zeros((n_a,), dtype=torch.int32, device=device))
    table_b = make_table(keys_b, torch.zeros((n_b,), dtype=torch.int32, device=device))
    sync(device)
    log(f"generate: {time.perf_counter() - t0:.3f}s")

    joiner = SortMergeJoiner()
    count = joiner.run(table_a, table_b)
    if count != n_b:
        raise AssertionError(count)
    t0 = time.perf_counter()
    count = joiner.run(table_a, table_b)  # .item() inside: the barrier
    total_s = time.perf_counter() - t0
    if count != n_b:
        raise AssertionError(count)
    rows_per_s = n_b / total_s
    log(f"int64 flagship: {total_s * 1e3:.3f} ms -> {rows_per_s:.6e} rows/s")
    print(json.dumps({
        "metric": f"join_rows_per_s_int64_{n_a}x{n_b}_skew{skew}",
        "value": round(rows_per_s),
        "unit": "rows/s",
        "vs_baseline": round(rows_per_s / BASELINE_ROWS_PER_S, 3),
        "device": kind,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
