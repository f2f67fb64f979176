"""Materialized join at scale on one device.

Counterpart of ``scripts/bench_materialize.py``.  Measures the kernel
materialize path (``merge_join.two_run_materialize``: two value-carrying
sorts and K4, the compaction skipped when every probe row matches) at the
reference workload 10M ⋈ 200M, best of 3 after a warmup, plus the JAX
script's at-scale output oracles:

  - count == |B| (every Zipf key over [1, n_a] matches the sequential A)
  - keys come back ascending (the key-order contract)
  - pay_a == key ^ SALT on every output row (A's payload is a function of
    its key), an exact check of all rows, not a sample
  - the uint32 sum of pay_b is kept (a multiset invariant)

Prints one JSON line (the JAX script's keys plus ``"device"``); the exit
code is 1 when an oracle fails.  Env: PHJ_BENCH_PRIMARY (10M),
PHJ_BENCH_SECONDARY (200M), PHJ_BENCH_SKEW (1.05).  The JAX script's
PHJ_BENCH_INTERPRET has no counterpart: ``--platform cpu`` runs the
kernels' plain versions.

    python -m partitionedhashjoin_tpu_torch.scripts.bench_materialize
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

import torch

from partitionedhashjoin_tpu_torch.ops import generators
from partitionedhashjoin_tpu_torch.ops.merge_join import two_run_materialize
from partitionedhashjoin_tpu_torch.scripts._common import (
    add_platform,
    best_of,
    generator,
    log,
    open_device,
)
from partitionedhashjoin_tpu_torch.utils.device import sync

SALT = 0x5A17
#: seeds of the Zipf probe keys and of the probe payloads
SEED = 20260817
PAYLOAD_SEED = 7
_U32 = (1 << 32) - 1


def oracles(keys, pa, pb, b_pay):
    """(ascending, pay_a == key ^ SALT, pay_b's uint32 sum kept), over every
    output row, reduced on the device."""
    asc = bool(torch.all(keys[1:] >= keys[:-1]))
    pay_ok = bool(torch.all(pa == (keys ^ SALT)))
    pb_sum_ok = (int(pb.to(torch.int64).sum()) & _U32) == (
        int(b_pay.to(torch.int64).sum()) & _U32)
    return asc, pay_ok, pb_sum_ok


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = add_platform(argparse.ArgumentParser(
        description=__doc__.splitlines()[0])).parse_args(argv)
    device, kind = open_device(args.platform)
    n_a = int(os.environ.get("PHJ_BENCH_PRIMARY", 10_000_000))
    n_b = int(os.environ.get("PHJ_BENCH_SECONDARY", 200_000_000))
    skew = float(os.environ.get("PHJ_BENCH_SKEW", 1.05))

    log(f"device: {kind}; {n_a} ⋈ {n_b} skew {skew}")
    t0 = time.perf_counter()
    a_keys = torch.arange(1, n_a + 1, dtype=torch.int32, device=device)
    a_pay = a_keys ^ SALT  # payload derivable from key -> exact oracle
    b_keys = generators.zipf_keys(n_b, skew, n_a, generator=generator(SEED, device),
                                  device=device)
    b_pay = torch.randint(0, 1 << 20, (n_b,), generator=generator(PAYLOAD_SEED, device),
                          dtype=torch.int32, device=device)
    sync(device)
    log(f"generate: {time.perf_counter() - t0:.3f}s")

    out = two_run_materialize(a_keys, a_pay, b_keys, b_pay)  # warmup
    sync(device)
    del out
    best = best_of(lambda: two_run_materialize(a_keys, a_pay, b_keys, b_pay),
                   3, device)
    log(f"materialize: {best * 1e3:.3f} ms ({n_b / best:.6e} rows/s)")

    keys, pa, pb, count = two_run_materialize(a_keys, a_pay, b_keys, b_pay)
    asc, pay_ok, pb_ok = oracles(keys, pa, pb, b_pay)
    c = int(count)
    log(f"count={c} ascending={asc} pay_a_oracle={pay_ok} pb_sum={pb_ok}")
    ok = (c == n_b) and asc and pay_ok and pb_ok
    print(json.dumps({
        "metric": f"materialize_rows_per_s_{n_a}x{n_b}_skew{skew}",
        "value": round(n_b / best),
        "unit": "rows/s",
        "seconds": round(best, 3),
        "oracle_ok": ok,
        "device": kind,
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
