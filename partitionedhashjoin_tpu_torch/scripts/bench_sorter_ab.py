"""A/B of the two-run count join's sorter: the library sort against K6.

Counterpart of ``scripts/bench_sorter_ab.py``.  Same device data, same
count kernel (K1), one process; the only variable is the sort of the two
key runs: "xla" sorts them with ``torch.sort`` and counts them with
``merge_join.sorted_runs_count``, "pallas" is ``merge_join.two_run_count``
(K6, the port's radix sort, then K1).  For each, the count runs once (its
time printed as the first call), then best of 3; the counts must agree.
Output goes to stderr only, as in the JAX script.

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

import torch

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


def _library_sort_count(a, b):
    """K1's count over the two runs sorted by the library sort."""
    return merge_join.sorted_runs_count(torch.sort(a).values, torch.sort(b).values)


COUNTS = {"xla": _library_sort_count, "pallas": merge_join.two_run_count}


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
    for impl in impls:
        count = COUNTS[impl]
        t0 = time.perf_counter()
        c = int(count(a, b))
        first_s = time.perf_counter() - t0
        best = best_of(lambda: count(a, b), 3, device)
        results[impl] = (best, c)
        log(f"{impl:7s}: {best * 1e3:9.3f} ms  ({n_b / best:.6e} rows/s)"
            f"  count={c}  [first call {first_s:.3f}s]")
    if len(results) == 2:
        counts = {v[1] for v in results.values()}
        if len(counts) != 1:
            raise AssertionError(f"COUNT MISMATCH: {results}")
        log(f"speedup pallas vs xla: "
            f"{results['xla'][0] / results['pallas'][0]:.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
