"""Readings of a cell's checks for the program and for its control.

    python3 -m benchmark.control --workload <cell> --seeds <n> ... [--seconds 2]

On the card, in one process: for each seed the cell's set-up and a short
window of the program at the cell's own size, then the reference, then the
control (``Operation.control``: the reference with one guarantee broken) in
the program's place.  Prints one JSON line per seed: the worst reading of
each check for the program and for the control, beside its limit.  The
limits in ``operations/`` were set from these readings; the benchmark's own
runs do not run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import generate, run


def readings(bench: dict, workload: str, seed: int, seconds: float, device,
             layout: run.Layout = run.Layout()) -> dict:
    cell = run.Cell.setup(bench, workload, seed, device, layout)
    records, _ = run.run_window(cell, seconds)
    cell.inputs = None
    op = cell.operation
    wants = [op.reference(*p) for p in cell.pairs]
    program = run.judge(cell, records, wants)
    control = {name: 0 for name in op.LIMITS}
    for i, (pair, want) in enumerate(zip(cell.pairs, wants)):
        got = op.control(*pair, generate.stream_seed(seed, i, 9))
        for name, value in op.compare(got, want).items():
            control[name] = max(control[name], value)
    return {"workload": workload, "seed": seed, "ops": len(records),
            "failed": sum(r.error is not None for r in records),
            "program": program, "control": control, "limits": op.LIMITS}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = json.loads(run.BENCHMARK_JSON.read_text())
    for seed in args.seeds:
        print(json.dumps(readings(bench, args.workload, seed, args.seconds,
                                  torch.device("cuda", 0))), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
