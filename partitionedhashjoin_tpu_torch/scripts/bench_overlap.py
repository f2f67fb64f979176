"""Pipelined (chunked exchange) vs one-shot shuffle join on an 8-shard mesh.

Counterpart of ``scripts/bench_overlap.py``.  At fixed total rows it runs
``DistributedShuffleJoiner(pipeline_chunks=K, single_shard_fast_path=False)``
for K in ``--chunks`` (1 = the one-shot exchange), each once untimed with
its count checked, then best of ``--reps``.  Build keys are 1..``--build``,
probe keys Zipf(``--skew``) over them (seed ``--seed``).

On one card nothing overlaps: the 8 shards share the device and its one
stream, and the exchange is copies within one memory.  So the number says
what chunking the exchange costs or saves in work, not how much of a link's
transfer a pipeline would hide.

Prints one row per K to stderr and the JAX script's JSON tail
(``overlap_pipelined_vs_oneshot_S8``), plus ``"device"``.

    python -m partitionedhashjoin_tpu_torch.scripts.bench_overlap \\
        [--build 2000000] [--probe 8000000]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from partitionedhashjoin_tpu_torch.ops import generators
from partitionedhashjoin_tpu_torch.parallel.mesh import make_mesh, shard_table
from partitionedhashjoin_tpu_torch.parallel.shuffle import DistributedShuffleJoiner
from partitionedhashjoin_tpu_torch.scripts._common import (
    add_platform,
    best_of,
    log,
    open_device,
)

#: the JAX script's mesh: every device of its 8-device runs
SHARDS = 8


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--build", type=int, default=2_000_000)
    p.add_argument("--probe", type=int, default=8_000_000)
    p.add_argument("--chunks", type=int, nargs="*", default=[1, 2, 4, 8])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--skew", type=float, default=1.05)
    p.add_argument("--seed", type=int, default=20260817)
    return add_platform(p)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device, kind = open_device(args.platform)
    mesh = make_mesh(SHARDS, devices=[device])
    log(f"device: {kind}; {SHARDS} shards on it")

    a = generators.sequential_table(args.build, device=device)
    b = generators.zipf_table(args.probe, alpha=args.skew,
                              key_range=(1, args.build), seed=args.seed,
                              device=device)
    a_sh = shard_table(a, mesh)
    b_sh = shard_table(b, mesh)
    del a, b

    rows = []
    for k in args.chunks:
        joiner = DistributedShuffleJoiner(
            mesh, seed=5, pipeline_chunks=k, single_shard_fast_path=False
        )
        count = joiner.run(a_sh, b_sh)  # warmup + exactness
        if count != args.probe:
            raise AssertionError((k, count))
        t = best_of(lambda: joiner.run(a_sh, b_sh), args.reps, device)
        label = "one-shot" if k == 1 else f"pipelined K={k}"
        log(f"{label:>14}: {t * 1e3:10.3f} ms  ({args.probe / t:.6e} rows/s)")
        rows.append({"chunks": k, "seconds": round(t, 4)})

    base = next(r["seconds"] for r in rows if r["chunks"] == 1)
    best = min(rows, key=lambda r: r["seconds"])
    print(json.dumps({
        "metric": f"overlap_pipelined_vs_oneshot_S{SHARDS}",
        "rows": rows,
        "best_chunks": best["chunks"],
        "best_speedup_vs_oneshot": round(base / best["seconds"], 3),
        "device": kind,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
