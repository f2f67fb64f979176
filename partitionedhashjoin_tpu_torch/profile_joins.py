"""Where the time goes: a device-time breakdown of each join path.

Run on a machine with an NVIDIA GPU, from the repository root:

    python -m partitionedhashjoin_tpu_torch.profile_joins

At the reference workload (10M sequential ⋈ 200M Zipf(1.05) keys, seed
20260816) it runs, for each count-join path, and for the materializing join
and the ordered JOIN → GROUP BY → top-10 pipeline over the relations of
``bench_pipeline`` (its own Zipf seed; build payload key ^ 0x5A17, probe
payloads uniform in [0, 2^20)), and for the materializing join once more
with probe keys uniform over [1, 2·N] (half miss: the compaction runs),
two untimed joins and then five joins
under ``torch.profiler`` (CPU and CUDA activities).  Per join it prints the
device time of each kernel (the CUDA events summed by name), the device
total, the host-clock time (every join ends in a readback of its count) and
the idle share, 1 - device time / host time.  A JSON line with the same
numbers follows each path.  Without a CUDA device it exits non-zero.

The sorter switch follows ``PHJ_SORT_IMPL`` (``merge_join.set_sort_impl_from_env``),
so ``PHJ_SORT_IMPL=pallas python -m partitionedhashjoin_tpu_torch.profile_joins``
breaks the paths down with K6 in place of the library sort.
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


def _tables(data, device):
    """(build, probe) Tables: the reference workload with int32 or int64
    keys, ("query") the pipeline's relations, or ("half miss") those with
    probe keys uniform over [1, 2·N_PRIMARY]."""
    from partitionedhashjoin_tpu_torch import bench_pipeline
    from partitionedhashjoin_tpu_torch.data.table import make_table
    from partitionedhashjoin_tpu_torch.ops import generators

    if data in ("query", "half miss"):
        a_keys, a_pay, b_keys, b_pay = bench_pipeline.make_relations(
            N_PRIMARY, N_SECONDARY, device)
        if data == "half miss":
            gen = torch.Generator(device=device)
            gen.manual_seed(SEED)
            b_keys = torch.randint(1, 2 * N_PRIMARY + 1, (N_SECONDARY,),
                                   generator=gen, dtype=torch.int32,
                                   device=device)
        return make_table(a_keys, a_pay), make_table(b_keys, b_pay)
    dtype = torch.int64 if data == "int64" else torch.int32
    a = generators.sequential_table(N_PRIMARY, dtype=dtype, device=device)
    b = generators.zipf_table(N_SECONDARY, SKEW, (1, N_PRIMARY), seed=SEED,
                              dtype=dtype, device=device)
    return a, b


def _paths():
    """(name, relations, join(a, b) -> int) of every path."""
    from partitionedhashjoin_tpu_torch import bench_pipeline
    from partitionedhashjoin_tpu_torch.ops import merge_join, sort_merge
    from partitionedhashjoin_tpu_torch.ops.no_partitioning import (
        NoPartitioningHashJoiner,
    )
    from partitionedhashjoin_tpu_torch.ops.planner import PlannedJoiner
    from partitionedhashjoin_tpu_torch.ops.radix_cluster import RadixHashJoiner

    def joiner(cls):
        return lambda a, b: cls().run(a, b)

    def materialize(a, b):
        return int(merge_join.two_run_materialize(
            a.keys, a.payloads, b.keys, b.payloads)[3])

    def pipeline(a, b):
        return int(bench_pipeline.run_query(
            a.keys, a.payloads, b.keys, b.payloads,
            bench_pipeline.GROUP_CAPACITY, ordered=True)[2])

    return (
        ("no-partitioning", "int32", joiner(NoPartitioningHashJoiner)),
        ("radix-partitioning", "int32", joiner(RadixHashJoiner)),
        ("planned", "int32", joiner(PlannedJoiner)),
        ("sort-merge", "int32", joiner(sort_merge.SortMergeJoiner)),
        ("sort-merge int64", "int64", joiner(sort_merge.SortMergeJoiner)),
        ("sort_merge_count", "int32",
         lambda a, b: int(sort_merge.sort_merge_count(a.keys, b.keys))),
        ("two_run_materialize", "query", materialize),
        ("pipeline (ordered)", "query", pipeline),
        ("two_run_materialize (half miss)", "half miss", materialize),
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
    from partitionedhashjoin_tpu_torch.ops import merge_join
    from partitionedhashjoin_tpu_torch.utils.logger import initialize_logger

    initialize_logger("error")
    sort_impl = merge_join.set_sort_impl_from_env()
    print(f"{torch.cuda.get_device_name(0)}; sort impl {sort_impl}", flush=True)
    tables = {}
    for name, data, join in _paths():
        if data not in tables:
            tables.clear()
            torch.cuda.empty_cache()
            tables[data] = _tables(data, device)
        by_name, host_us = profile_path(join, *tables[data], REPS)
        device_us = sum(by_name.values())
        print(f"== {name}: device {device_us / 1e3:.4f} ms, host "
              f"{host_us / 1e3:.4f} ms, idle share "
              f"{1 - device_us / host_us:.4f} (per join, {REPS} joins)")
        for kernel, us in by_name.most_common():
            print(f"   {us / 1e3:9.4f} ms {us / device_us:7.2%}  {kernel[:110]}")
        print(json.dumps({
            "path": name, "sort_impl": sort_impl, "reps": REPS,
            "device_ms": device_us / 1e3,
            "host_ms": host_us / 1e3,
            "kernels_ms": {k: v / 1e3 for k, v in by_name.most_common()},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
