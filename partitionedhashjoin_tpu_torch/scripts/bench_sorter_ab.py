"""A/B of the two-run count join's sorter: the library sort against K6.

Counterpart of ``scripts/bench_sorter_ab.py``.  Same device data, same
count kernel (K1), one process; the only variable is
``merge_join.set_sort_impl``: "xla" (``torch.sort``) against "pallas" (K6,
the port's radix sort).  For each, ``two_run_count`` runs once (its time
printed as the first call), then best of 3; the counts must agree.  The
sorter is set back to what it was at the end, also on failure.  Output goes to
stderr only, as in the JAX script.

Env: PHJ_AB_PRIMARY (10M), PHJ_AB_SECONDARY (200M), PHJ_AB_SKEW (1.05),
PHJ_AB_IMPLS (csv of xla,pallas; default both).  The JAX script's
PHJ_AB_INTERPRET has no counterpart: ``--platform cpu`` runs the kernels'
plain versions.

    python -m partitionedhashjoin_tpu_torch.scripts.bench_sorter_ab
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional, Sequence

from partitionedhashjoin_tpu_torch.ops import generators, merge_join
from partitionedhashjoin_tpu_torch.scripts._common import (
    add_platform,
    best_of,
    generator,
    log,
    open_device,
)
from partitionedhashjoin_tpu_torch.utils.device import sync

SEED = 20260816


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = add_platform(argparse.ArgumentParser(
        description=__doc__.splitlines()[0])).parse_args(argv)
    device, kind = open_device(args.platform)
    n_a = int(os.environ.get("PHJ_AB_PRIMARY", 10_000_000))
    n_b = int(os.environ.get("PHJ_AB_SECONDARY", 200_000_000))
    skew = float(os.environ.get("PHJ_AB_SKEW", 1.05))
    impls = os.environ.get("PHJ_AB_IMPLS", "xla,pallas").split(",")

    log(f"device: {kind}; {n_a} ⋈ {n_b}, skew {skew}")
    t0 = time.perf_counter()
    a = generators.sequential_table(n_a, device=device).keys
    b = generators.zipf_keys(n_b, skew, n_a, generator=generator(SEED, device),
                             device=device)
    sync(device)
    log(f"generated in {time.perf_counter() - t0:.3f}s")

    results = {}
    prior = merge_join.get_sort_impl()
    try:
        for impl in impls:
            merge_join.set_sort_impl(impl)
            t0 = time.perf_counter()
            c = int(merge_join.two_run_count(a, b))
            first_s = time.perf_counter() - t0
            best = best_of(lambda: merge_join.two_run_count(a, b), 3, device)
            results[impl] = (best, c)
            log(f"{impl:7s}: {best * 1e3:9.3f} ms  ({n_b / best:.6e} rows/s)"
                f"  count={c}  [first call {first_s:.3f}s]")
    finally:
        merge_join.set_sort_impl(prior)
    if len(results) == 2:
        counts = {v[1] for v in results.values()}
        if len(counts) != 1:
            raise AssertionError(f"COUNT MISMATCH: {results}")
        log(f"speedup pallas vs xla: "
            f"{results['xla'][0] / results['pallas'][0]:.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
