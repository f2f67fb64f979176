"""Benchmark sweep — the reference's scripts/generate.sh equivalent.

Counterpart of ``scripts/sweep.py``.  Runs the CLI
(``python -m partitionedhashjoin_tpu_torch``) once for the base join
(no-partitioning, or sort-merge with ``--base-join``) and once per
``--partitions P`` for the radix join (generate.sh:70-79 sweeps P in
32..8192), each as its own process writing its JSON file, then assembles
``figure.dat`` from the files: phase rows x configuration columns, the
layout the reference feeds to gnuplot (scripts/figure.plot).

Unlike generate.sh, the sweep honours the requested skew for every run (the
reference hard-codes ``--skew 1.05`` in its radix loop, generate.sh:78).
``--unit`` (ns, us, ms or s; default ms, the CLI's) is passed to the CLI's
``--unit``; ``--platform`` to its ``--platform``, after a check that the
device is there.

Usage:

    python -m partitionedhashjoin_tpu_torch.scripts.sweep --outdir out/1.05 \\
        --partitions 32 64 128 256 512 1024 2048 4096 8192
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional, Sequence, Tuple

from partitionedhashjoin_tpu_torch.scripts._common import add_platform, log
from partitionedhashjoin_tpu_torch.scripts.record_results import write_figure
from partitionedhashjoin_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_cli(outfile: str, argv: List[str]) -> dict:
    """One CLI process writing ``outfile``; returns its JSON document."""
    cmd = [
        sys.executable, "-m", "partitionedhashjoin_tpu_torch",
        "--output", "file", "--filename", outfile,
    ] + argv
    # prepend the repository to PYTHONPATH, keeping what the caller set
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run(cmd, check=True, cwd=REPO, env=env)
    with open(outfile) as f:
        return json.load(f)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--outdir", required=True)
    p.add_argument("--skew", type=float, default=1.05)
    p.add_argument("--primary", type=int, default=10_000_000)
    p.add_argument("--secondary", type=int, default=200_000_000)
    p.add_argument(
        "--partitions",
        type=int,
        nargs="*",
        default=[32, 64, 128, 256, 512, 1024, 2048, 4096, 8192],
    )
    p.add_argument("--seed", type=int, default=20260816)
    p.add_argument(
        "--base-join",
        default="no-partitioning",
        choices=("no-partitioning", "sort-merge"),
        help="the non-radix comparison column (generate.sh runs one "
        "no-partitioning row, generate.sh:69)",
    )
    p.add_argument("--unit", default="ms", choices=("ns", "us", "ms", "s"),
                   help="duration unit of the written results")
    return add_platform(p)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device(args.platform)  # a missing card raises here, not per run
    os.makedirs(args.outdir, exist_ok=True)
    outdir = os.path.abspath(args.outdir)  # the CLI runs from the repository

    common = [
        "--primary", str(args.primary),
        "--secondary", str(args.secondary),
        "--skew", str(args.skew),
        "--seed", str(args.seed),
        "--unit", args.unit,
        "--platform", args.platform,
        "--log", "info",
    ]

    columns: List[Tuple[str, dict]] = []
    doc = run_cli(
        os.path.join(outdir, "partitions_1.txt"),
        common + ["--join", args.base_join],
    )
    columns.append((doc["parameters"]["Type"], doc))

    for parts in args.partitions:
        doc = run_cli(
            os.path.join(outdir, f"partitions_{parts}.txt"),
            common + ["--join", "radix-partitioning", "--partitions", str(parts)],
        )
        columns.append((f"Radix_{parts}", doc))

    dat = os.path.join(args.outdir, "figure.dat")
    write_figure(dat, columns)
    log(f"wrote {dat}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
