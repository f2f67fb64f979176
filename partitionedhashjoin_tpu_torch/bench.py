"""Benchmark: the reference workload (10M ⋈ 200M, Zipf skew) on one card.

Counterpart of the repository's ``bench.py`` (the JAX package's one-line
bench).  It mirrors the reference program's measurement (src/main.cpp:210-293:
generate → join → emit JSON) and prints ONE machine-readable JSON line:

    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...,
     "generation_path": ..., "sort_impl": ...,
     "roofline_fraction_single_touch": {...}, "device": ...}

The headline metric is end-to-end join throughput (probe rows per second
over all join phases) of the fastest joiner on the reference's default
workload (10M sequential primary ⋈ 200M Zipf(1.05) secondary, Readme.md:58).
``vs_baseline`` compares against the reference's best end-to-end grid point:
radix join at P=2048, 820+17+359 = 1196 ms for 200M rows = 167.2M rows/s on
an 8C/16T Ryzen 3700X (BASELINE.md, results/1.05/).

Each algo runs once untimed (its count must be the probe size), then once
under ``HashJoinTimer``; the joiners end the run with the count's readback,
a device barrier.  Per-phase roofline accounting goes to stderr and the JSON
line: achieved GB/s against the H100's 3,350 GB/s on a SINGLE-TOUCH traffic
basis — bytes every algorithm must move at least once (read+write each
relation per sort phase, read the probe + build runs per probe phase).  A
multi-pass sort therefore shows a low fraction of peak by construction.

Run from the repository root:

    python -m partitionedhashjoin_tpu_torch.bench                    # the card
    PHJ_BENCH_PRIMARY=5000 PHJ_BENCH_SECONDARY=70000 \\
        python -m partitionedhashjoin_tpu_torch.bench --platform cpu  # smoke

Env knobs: PHJ_BENCH_PRIMARY, PHJ_BENCH_SECONDARY, PHJ_BENCH_SKEW,
PHJ_BENCH_ALGOS (comma list of sort-merge, radix, radix-chained,
no-partitioning, planned; default sort-merge,radix), PHJ_BENCH_DEADLINE_S (the watchdog's deadline,
default 2400).  ``sort_impl`` is ``merge_join.SORT_IMPL``: every key sort
is K6's.  The probe keys come from the
rejection sampler ``zipf_keys`` on the device, from a ``torch.Generator``
seeded 20260816.  Phase times and the kernel launches of each measured run
go to stderr; stdout carries only the JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import threading
import time
from typing import Optional, Sequence

import torch

from partitionedhashjoin_tpu_torch.data.table import make_table
from partitionedhashjoin_tpu_torch.ops import generators, merge_join
from partitionedhashjoin_tpu_torch.utils import profiling
from partitionedhashjoin_tpu_torch.utils.device import resolve_device, sync
from partitionedhashjoin_tpu_torch.utils.results import HashJoinTimer, Parameters

#: Reference best end-to-end throughput (rows/s): radix P=2048 at skew 1.05,
#: 1196 ms total for 200M probe rows (BASELINE.md grid).
BASELINE_ROWS_PER_S = 200e6 / 1.196
#: Seed of the probe keys' generator (the JAX bench's PRNG key).
SEED = 20260816
#: Kernel modules whose ``LAUNCHES*`` counters the bench reports.
_COUNTED = ("merge_probe", "merge_count", "merge_payload", "compact",
            "bitonic_sort", "generate")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Progress:
    """The best measurement so far, shared by ``main`` and the deadline
    watchdog.  Exactly one of them emits: the two race near the deadline,
    and two JSON lines (or a print cut by ``os._exit``) would corrupt the
    reader's parse — so each claims before emitting."""

    def __init__(self) -> None:
        self.best = None  # (algo, rows_per_s)
        self.extra: dict = {}
        self.stage = "import"
        self.done = False
        self._lock = threading.Lock()

    def claim_emit(self) -> bool:
        with self._lock:
            if self.done:
                return False
            self.done = True
            return True


def _emit(best, extra) -> None:
    algo, rows_per_s = best
    payload = {
        "metric": f"join_rows_per_s_{algo}_{extra['n_a']}x{extra['n_b']}"
        f"_skew{extra['skew']}",
        "value": round(rows_per_s),
        "unit": "rows/s",
        "vs_baseline": round(rows_per_s / BASELINE_ROWS_PER_S, 3),
        **{k: v for k, v in extra.items() if k not in ("n_a", "n_b", "skew")},
    }
    print(json.dumps(payload), flush=True)


def _watchdog(progress: Progress, deadline_s: float, poll_s: float = 5.0) -> None:
    """Emit the best completed measurement if the run overshoots deadline_s.

    A partial-but-honest JSON line (the algos measured so far) beats a
    killed process with no line at all.  It never fires when ``main``
    finishes in time (the done flag); with nothing measured it exits 3.
    """
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        time.sleep(min(poll_s, max(t_end - time.monotonic(), 0.0)))
        if progress.done:
            return
    if progress.best is not None:
        if not progress.claim_emit():
            return  # main got there first
        log(f"DEADLINE hit at stage {progress.stage}; emitting best-so-far")
        _emit(progress.best, progress.extra)
        os._exit(0)
        return
    if progress.done:
        return
    log(f"DEADLINE hit at stage {progress.stage}; nothing measured yet")
    os._exit(3)


def make_joiner(name: str, seed: int):
    if name == "sort-merge":
        from partitionedhashjoin_tpu_torch.ops.sort_merge import SortMergeJoiner

        return SortMergeJoiner()
    if name == "planned":
        # stats-driven planner (ops/planner.py).  NOT in the default algo
        # list: on this workload its dense-build interval plan collapses the
        # probe to one streaming pass, which measures the planner, not the
        # general join.  Run via PHJ_BENCH_ALGOS=planned.
        from partitionedhashjoin_tpu_torch.ops.planner import PlannedJoiner

        return PlannedJoiner()
    if name == "no-partitioning":
        from partitionedhashjoin_tpu_torch.ops.no_partitioning import (
            NoPartitioningHashJoiner,
        )

        return NoPartitioningHashJoiner(seed=seed)
    if name == "radix":
        from partitionedhashjoin_tpu_torch.config import RadixClusteringConfiguration
        from partitionedhashjoin_tpu_torch.ops.radix_cluster import RadixHashJoiner

        return RadixHashJoiner(
            RadixClusteringConfiguration(number_of_partitions=256),
            seed=seed,
        )
    if name == "radix-chained":
        from partitionedhashjoin_tpu_torch.config import RadixClusteringConfiguration
        from partitionedhashjoin_tpu_torch.ops.radix_cluster import RadixHashJoiner

        return RadixHashJoiner(
            RadixClusteringConfiguration(number_of_partitions=256, mode="chained"),
            seed=seed,
        )
    raise ValueError(f"unknown algo {name}")


def phase_rooflines(algo: str, n_a: int, n_b: int, r):
    """(phase, seconds, single-touch bytes) rows for the measured result.

    Single-touch accounting: bytes the phase must move at least once —
    partition/sort phases read+write each participating relation once;
    probe phases read the probe side once plus the build structure.
    """
    rows = []
    part_s = r.get_partitioning_phase_duration()
    build_s = r.get_build_phase_duration()
    probe_s = r.get_probe_phase_duration()
    if algo == "radix":  # vmem mode: partition = both sorts, probe = kernel
        if part_s:
            rows.append(("partition(sorts)", part_s, 2 * 4 * (n_a + n_b)))
        if probe_s:
            rows.append(("probe(kernel)", probe_s, 4 * (n_b + 2 * n_a)))
    elif algo == "sort-merge":  # one fused phase reported as probe
        if probe_s:
            rows.append(("total(sorts+kernel)", probe_s, 3 * 4 * (n_a + n_b)))
    else:
        if part_s:
            rows.append(("partition", part_s, 2 * 4 * (n_a + n_b)))
        if build_s:
            rows.append(("build", build_s, 2 * 4 * n_a))
        if probe_s:
            rows.append(("probe", probe_s, 4 * (n_b + n_a)))
    return rows


def kernel_launches() -> dict:
    """Every kernel wrapper's launch counter, as {"module.COUNTER": n}."""
    counts = {}
    for name in _COUNTED:
        mod = importlib.import_module(f"partitionedhashjoin_tpu_torch.ops.kernels.{name}")
        for attr in sorted(dir(mod)):
            if attr.startswith("LAUNCHES"):
                counts[f"{name}.{attr}"] = getattr(mod, attr)
    return counts


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--platform", default="cuda",
                   help="torch device: 'cuda' (default) or 'cpu'")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    n_a = int(os.environ.get("PHJ_BENCH_PRIMARY", 10_000_000))
    n_b = int(os.environ.get("PHJ_BENCH_SECONDARY", 200_000_000))
    skew = float(os.environ.get("PHJ_BENCH_SKEW", 1.05))
    algos = os.environ.get("PHJ_BENCH_ALGOS", "sort-merge,radix").split(",")
    deadline_s = float(os.environ.get("PHJ_BENCH_DEADLINE_S", 2400))
    progress = Progress()
    threading.Thread(
        target=_watchdog, args=(progress, deadline_s), daemon=True
    ).start()
    progress.stage = "device-init"
    device = resolve_device(args.platform)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    log(f"device: {kind}; workload {n_a} ⋈ {n_b}, skew {skew}")
    progress.stage = "generate"

    t0 = time.perf_counter()
    table_a = generators.sequential_table(n_a, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    ids = generators.zipf_keys(n_b, skew, n_a, generator=gen, device=device)
    table_b = make_table(ids, torch.zeros((n_b,), dtype=torch.int32, device=device))
    sync(device)
    log(f"generate (rejection sampler): {time.perf_counter() - t0:.3f} s")

    best = None
    roofline_json = {}
    for algo in algos:
        progress.stage = f"{algo}-warmup"
        joiner = make_joiner(algo, seed=7)
        count = joiner.run(table_a, table_b)  # warmup: kernel builds, caches
        if count != n_b:
            raise AssertionError(f"{algo}: count {count} != {n_b}")
        progress.stage = f"{algo}-measure"
        timer = HashJoinTimer(Parameters())
        before = kernel_launches()
        t0 = time.perf_counter()
        count = joiner.run(table_a, table_b, timer)
        total_s = time.perf_counter() - t0
        if count != n_b:
            raise AssertionError(f"{algo}: count {count} != {n_b}")
        launched = {k: v - before[k] for k, v in kernel_launches().items()
                    if v != before[k]}
        r = timer.get_result()
        log(
            f"{algo}: total {total_s * 1e6:.1f} us "
            f"(partition {r.get_partitioning_phase_duration() * 1e6:.1f} / "
            f"build {r.get_build_phase_duration() * 1e6:.1f} / "
            f"probe {r.get_probe_phase_duration() * 1e6:.1f} us) -> "
            f"{n_b / total_s:.6e} rows/s"
        )
        log(f"launches {algo}: {json.dumps(launched, sort_keys=True)}")
        for phase, secs, nbytes in phase_rooflines(algo, n_a, n_b, r):
            rep = profiling.roofline(secs, nbytes)
            log(f"  roofline {phase}: {rep}")
            roofline_json[f"{algo}.{phase}"] = round(rep.fraction_of_peak, 4)
        rows_per_s = n_b / total_s
        if best is None or rows_per_s > best[1]:
            best = (algo, rows_per_s)
        progress.extra = {
            "n_a": n_a,
            "n_b": n_b,
            "skew": skew,
            "generation_path": "rejection",
            "sort_impl": merge_join.SORT_IMPL,
            "roofline_fraction_single_touch": dict(roofline_json),
            "device": kind,
        }
        progress.best = best

    log(f"best: {best[0]}")
    if progress.claim_emit():
        _emit(best, progress.extra)
    return 0


if __name__ == "__main__":
    sys.exit(main())
