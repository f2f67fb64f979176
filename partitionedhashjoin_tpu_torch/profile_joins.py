"""Where the time goes: a device-time breakdown of each count-join path.

Run on a machine with an NVIDIA GPU, from the repository root:

    python -m partitionedhashjoin_tpu_torch.profile_joins

At the reference workload (10M sequential ⋈ 200M Zipf(1.05) keys, seed
20260816) it runs, for each path, two untimed joins and then five joins
under ``torch.profiler`` (CPU and CUDA activities).  Per join it prints the
device time of each kernel (the CUDA events summed by name), the device
total, the host-clock time (every join ends in a readback of its count) and
the idle share, 1 - device time / host time.  A JSON line with the same
numbers follows each path.  Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import collections
import json
import sys
import time

import torch

N_PRIMARY = 10_000_000
N_SECONDARY = 200_000_000
SKEW = 1.05
SEED = 20260816
REPS = 5


def _tables(dtype, device):
    from partitionedhashjoin_tpu_torch.ops import generators

    a = generators.sequential_table(N_PRIMARY, dtype=dtype, device=device)
    b = generators.zipf_table(N_SECONDARY, SKEW, (1, N_PRIMARY), seed=SEED,
                              dtype=dtype, device=device)
    return a, b


def _paths():
    """(name, key dtype, join(a, b) -> int) of every count-join path."""
    from partitionedhashjoin_tpu_torch.ops import sort_merge
    from partitionedhashjoin_tpu_torch.ops.no_partitioning import (
        NoPartitioningHashJoiner,
    )
    from partitionedhashjoin_tpu_torch.ops.planner import PlannedJoiner
    from partitionedhashjoin_tpu_torch.ops.radix_cluster import RadixHashJoiner

    def joiner(cls):
        return lambda a, b: cls().run(a, b)

    return (
        ("no-partitioning", torch.int32, joiner(NoPartitioningHashJoiner)),
        ("radix-partitioning", torch.int32, joiner(RadixHashJoiner)),
        ("planned", torch.int32, joiner(PlannedJoiner)),
        ("sort-merge", torch.int32, joiner(sort_merge.SortMergeJoiner)),
        ("sort-merge int64", torch.int64, joiner(sort_merge.SortMergeJoiner)),
        ("sort_merge_count", torch.int32,
         lambda a, b: int(sort_merge.sort_merge_count(a.keys, b.keys))),
    )


def profile_path(join, a, b, reps):
    """(device µs by kernel name per join, host µs per join)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        join(a, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            join(a, b)
        host_us = (time.perf_counter() - t0) * 1e6 / reps
    by_name = collections.Counter()
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.elapsed_us() / reps
    return by_name, host_us


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_joins needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    from partitionedhashjoin_tpu_torch.utils.logger import initialize_logger

    initialize_logger("error")
    print(torch.cuda.get_device_name(0), flush=True)
    tables = {}
    for name, dtype, join in _paths():
        if dtype not in tables:
            tables.clear()
            torch.cuda.empty_cache()
            tables[dtype] = _tables(dtype, device)
        by_name, host_us = profile_path(join, *tables[dtype], REPS)
        device_us = sum(by_name.values())
        print(f"== {name}: device {device_us / 1e3:.4f} ms, host "
              f"{host_us / 1e3:.4f} ms, idle share "
              f"{1 - device_us / host_us:.4f} (per join, {REPS} joins)")
        for kernel, us in by_name.most_common():
            print(f"   {us / 1e3:9.4f} ms {us / device_us:7.2%}  {kernel[:110]}")
        print(json.dumps({
            "path": name, "reps": REPS, "device_ms": device_us / 1e3,
            "host_ms": host_us / 1e3,
            "kernels_ms": {k: v / 1e3 for k, v in by_name.most_common()},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
