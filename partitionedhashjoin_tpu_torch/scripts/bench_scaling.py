"""Measured shuffle-join scaling over a mesh whose shards share one device.

Counterpart of ``scripts/bench_scaling.py``.  Runs
``DistributedShuffleJoiner(single_shard_fast_path=False)`` (the exchange
machinery kept even at S = 1) over S ∈ {1, 2, 4, 8} shards, the JAX
script's list capped at the 8 devices its scripts run with, every S on one
``make_mesh(S, devices=[device])``:

- weak scaling: per-shard rows fixed, S grows, efficiency = t(1) / t(S);
- strong scaling: global rows fixed, speedup = t(1) / t(S).

Each point runs once untimed with its count checked, then best of
``--reps``.  The S shards share one card: the exchange is copies within one
memory, no link is involved, and nothing overlaps (one stream), so what
this measures is the exchange's and the S local joins' own work on one
device, not what more devices would gain.  Build keys are 1..n_a, probe
keys Zipf(1.05) over [1, n_a] (seed ``--seed``), payloads the row index.

Prints one row per S to stderr and the JAX script's JSON tail (``backend``
is the torch device type), plus ``"device"``.

    python -m partitionedhashjoin_tpu_torch.scripts.bench_scaling \\
        [--build 250000] [--probe 1000000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import torch

from partitionedhashjoin_tpu_torch.data.table import make_table
from partitionedhashjoin_tpu_torch.ops import generators
from partitionedhashjoin_tpu_torch.parallel.mesh import make_mesh, shard_table
from partitionedhashjoin_tpu_torch.parallel.shuffle import DistributedShuffleJoiner
from partitionedhashjoin_tpu_torch.scripts._common import (
    add_platform,
    best_of,
    generator,
    log,
    open_device,
)

SHARD_COUNTS = (1, 2, 4, 8)


def _row_ids(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--build", type=int, default=250_000,
                   help="build rows PER SHARD (weak) / total (strong)")
    p.add_argument("--probe", type=int, default=1_000_000,
                   help="probe rows PER SHARD (weak) / total (strong)")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seed", type=int, default=20260817)
    return add_platform(p)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device, kind = open_device(args.platform)
    log(f"device: {kind} ({device.type}); S sweep {list(SHARD_COUNTS)}, "
        "every shard on this one device")

    def run_point(s: int, n_a: int, n_b: int) -> float:
        """Seconds for one full shuffle join (exchange + local joins +
        psum) over an s-shard mesh, best of --reps after a warmup."""
        mesh = make_mesh(s, devices=[device])
        a_keys = torch.arange(1, n_a + 1, dtype=torch.int32, device=device)
        b_keys = generators.zipf_keys(n_b, 1.05, n_a,
                                      generator=generator(args.seed, device),
                                      device=device)
        a = shard_table(make_table(a_keys, _row_ids(n_a, device)), mesh)
        b = shard_table(make_table(b_keys, _row_ids(n_b, device)), mesh)
        joiner = DistributedShuffleJoiner(mesh, seed=7, single_shard_fast_path=False)
        count = joiner.run(a, b)  # warmup + count oracle
        if count != n_b:
            raise AssertionError((s, count, n_b))
        return best_of(lambda: joiner.run(a, b), args.reps, device)

    weak, strong = {}, {}
    for s in SHARD_COUNTS:
        weak[s] = run_point(s, args.build * s, args.probe * s)
        strong[s] = run_point(s, args.build, args.probe)

    t1w, t1s = weak[SHARD_COUNTS[0]], strong[SHARD_COUNTS[0]]
    rows = []
    log(f"{'S':>3} {'weak_s':>10} {'weak_eff':>9} {'strong_s':>10} "
        f"{'speedup':>8}")
    for s in SHARD_COUNTS:
        weak_eff = t1w / weak[s]
        speedup = t1s / strong[s]
        rows.append({
            "shards": s,
            "weak_s": round(weak[s], 4),
            "weak_efficiency": round(weak_eff, 3),
            "weak_rows_per_s": int(args.probe * s / weak[s]),
            "strong_s": round(strong[s], 4),
            "strong_speedup": round(speedup, 3),
        })
        log(f"{s:>3} {weak[s]:>10.6f} {weak_eff:>9.3f} {strong[s]:>10.6f} "
            f"{speedup:>8.3f}")
    print(json.dumps({
        "workload": f"{args.build}x{args.probe} per shard, zipf 1.05",
        "backend": device.type,
        "host_cores": os.cpu_count(),
        "note": "one-device mesh: S shards share one device; the exchange is "
                "copies within one memory, no link is involved",
        "points": rows,
        "device": kind,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
