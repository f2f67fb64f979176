"""Run one cell of BENCHMARK.json and print its result as one JSON line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root, on a machine with an NVIDIA card.  One run:

1. Set-up: the cell's configuration (``configs/<config>.json``) gives the
   relations, made on the card from ``--seed`` by ``generate.py``, one pair
   per variant; its traffic mix (``traffic/<traffic>.json``) names the
   operation (``operations/<operation>.py``) that drives the program.  One
   warm operation per pair.  ``setup_s`` runs from the end of ``import
   torch`` (a library's import, not the program's) to the window.
2. Window: one client in a closed loop for ``--seconds``, each operation on
   the next pair in turn, timed from the call to its answer on the host.
   With ``--trace 1`` ``torch.profiler`` records a steady stretch of it.
3. Check: every answer of the window against the plain reference
   (``reference/``), each check printed beside its limit; then the metrics,
   each read by ``metrics/<metric>.py``: the cell's end-to-end metrics with
   ``--trace 0``, its per-layer metrics with ``--trace 1``.

It exits 2 without a result where there is no card, and 3 where a module
of JAX or of the JAX package is loaded when the result would be printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

_T0 = time.perf_counter()

from benchmark import generate  # noqa: E402

HERE = Path(__file__).resolve().parent
BENCHMARK_JSON = HERE.parent / "BENCHMARK.json"
#: Top-level modules that may not be loaded by a run: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "partitionedhashjoin_tpu")
#: Where the traced stretch starts (seconds into the window, at most) and
#: how long it lasts (at most).
STRETCH_START_S = 1.0
STRETCH_S = 3.0


@dataclasses.dataclass
class Layout:
    """Where cells find their files by name."""

    configs: Path = HERE / "configs"
    traffic: Path = HERE / "traffic"
    operations: Path = HERE / "operations"
    metrics: Path = HERE / "metrics"


@dataclasses.dataclass
class OpRecord:
    variant: int
    seconds: float
    answer: object
    phases: Optional[dict]
    traced: bool
    error: Optional[str] = None


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    n_build: int
    n_probe: int
    #: bytes of one key
    key_bytes: int
    op_bytes: int
    setup_s: float
    window_s: float
    peak_bytes: int
    ops: list
    stretch: object = None
    extra: dict = dataclasses.field(default_factory=dict)

    def stretch_ops(self) -> list:
        return [op for op in self.ops if op.traced]

    def kernel_seconds_per_op(self, names) -> Optional[float]:
        """Device seconds of the kernels whose names hold any of ``names``,
        per operation of the traced stretch; None where none ran."""
        if self.stretch is None or not self.stretch_ops():
            return None
        total = sum(s for k, s in self.stretch.device_seconds.items()
                    if any(n in k for n in names))
        return total / len(self.stretch_ops()) if total else None


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"benchmark._found.{path.parent.name}.{path.stem}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, workload: str):
    """(end-to-end entries, per-layer entries) that the cell reports: those
    whose ``workloads`` name it; a per-layer metric without ``workloads``
    wherever the end-to-end metric it moves is reported."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return e2e, per_layer


@dataclasses.dataclass
class Cell:
    """A cell's relations and operation after set-up."""

    name: str
    operation: object
    pairs: list
    inputs: list
    #: seconds from the start of this module to the end of each set-up step
    marks: dict

    @classmethod
    def setup(cls, bench: dict, workload: str, seed: int, device,
              layout: Layout) -> "Cell":
        cell = next(w for w in bench["workloads"] if w["name"] == workload)
        config = json.loads((layout.configs / f"{cell['config']}.json").read_text())
        traffic = json.loads((layout.traffic / f"{cell['traffic']}.json").read_text())
        module = load_module(layout.operations / f"{traffic['operation']}.py")
        operation = module.Operation(traffic, seed)
        marks = {"program imported": time.perf_counter() - _T0}
        torch.empty(1, device=device)  # the card's context
        _sync(device)
        marks["card ready"] = time.perf_counter() - _T0
        pairs = [generate.make_pair(config, seed, v, device)
                 for v in range(int(traffic["variants"]))]
        _sync(device)
        marks["relations made"] = time.perf_counter() - _T0
        inputs = [operation.inputs(*p) for p in pairs]
        for x in inputs:  # the warm operations: every shape of the window
            operation.run(x)
        _sync(device)
        marks["warm operations done"] = time.perf_counter() - _T0
        return cls(workload, operation, pairs, inputs, marks)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(cell: Cell, seconds: float, tracer=None) -> tuple:
    """(records, window seconds): one client, a closed loop, each operation
    on the next pair, until the first answer after ``seconds`` (and, with a
    tracer, after a stretch of at least one operation per pair)."""
    records = []
    start = time.perf_counter()
    deadline = start + seconds
    stretch_from = start + min(STRETCH_START_S, seconds / 4)
    stretch_len = min(STRETCH_S, seconds / 2)
    stretch_t0 = None
    variants = len(cell.inputs)
    i = traced_ops = 0
    while True:
        now = time.perf_counter()
        if tracer is not None and stretch_t0 is None and now >= stretch_from:
            tracer.start()
            stretch_t0 = now
        traced = tracer is not None and tracer.active
        v = i % variants
        mark = (torch.profiler.record_function("benchmark_operation")
                if traced else None)
        t0 = time.perf_counter()
        try:
            if mark is not None:
                with mark:
                    answer, phases = cell.operation.run(cell.inputs[v])
            else:
                answer, phases = cell.operation.run(cell.inputs[v])
            error = None
        except Exception:  # an operation that fails is counted, not fatal
            answer, phases, error = None, None, traceback.format_exc()
        t1 = time.perf_counter()
        records.append(OpRecord(v, t1 - t0, answer, phases, traced, error))
        i += 1
        traced_ops += traced
        if traced and t1 - stretch_t0 >= stretch_len and traced_ops >= variants:
            tracer.stop()
        # a traced run goes on until its stretch is complete
        if t1 >= deadline and (tracer is None or (stretch_t0 is not None
                                                  and not tracer.active)):
            break
    return records, time.perf_counter() - start


def judge(cell: Cell, records: list, wants=None) -> dict:
    """{check: worst value over the window's answers}; each is held to the
    operation's limit.  ``wants``: the reference's answer of each pair,
    worked out here when not given."""
    op = cell.operation
    if wants is None:
        wants = [op.reference(*p) for p in cell.pairs]
    worst = {name: 0 for name in op.LIMITS}
    for r in records:
        if r.error is not None:
            continue
        for name, value in op.compare(r.answer, wants[r.variant]).items():
            worst[name] = max(worst[name], value)
    return worst


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def execute(bench: dict, workload: str, seed: int, seconds: float,
            trace: bool, device, layout: Layout = Layout()) -> tuple:
    """One run of a cell on ``device``: (the result line's object, the lines
    that end standard error).  The caller has checked the device."""
    from benchmark import tracing

    e2e, per_layer = cell_metrics(bench, workload)
    cell = Cell.setup(bench, workload, seed, device, layout)
    tracer = None
    if trace:
        tracer = tracing.Tracer()
        tracer.start()  # the profiler's own set-up, outside the window
        tracer.stop()
        tracer = tracing.Tracer()
    on_card = device.type == "cuda"
    _sync(device)
    setup_s = time.perf_counter() - _T0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    records, window_s = run_window(cell, seconds, tracer)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    stretch = tracer.result() if tracer is not None else None
    extra = cell.operation.trace_extras(cell.inputs[0]) if trace else {}
    build, probe = cell.pairs[0]
    ctx = Context(build.rows, probe.rows, build.keys.element_size(),
                  cell.operation.compulsory_bytes(build, probe), setup_s,
                  window_s, peak, records, stretch, extra)
    metrics = {}
    for m in (per_layer if trace else e2e):
        value = load_module(layout.metrics / f"{m['name']}.py").read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cell.inputs = None  # the program's state goes before the reference runs
    checks = judge(cell, records)
    failed = sum(r.error is not None for r in records)
    limits = cell.operation.LIMITS
    correct = failed == 0 and all(checks[k] <= limits[k] for k in limits)
    result = {"correct": correct, "attempted": len(records), "failed": failed,
              "metrics": metrics,
              "device": device_info(device, peak, stretch)}
    if stretch is not None:
        result["breakdown"] = stretch.breakdown()
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in limits}
    errors = [r.error for r in records if r.error is not None][:1]
    lines = [f"setup: {k} at {v:.3f} s" for k, v in cell.marks.items()]
    lines += errors + [f"check {k}: {checks[k]} (limit {limits[k]})"
                       for k in limits]
    return result, lines


def device_info(device, peak: int, stretch) -> dict:
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": 1, "memory_peak_bytes": peak}
    if stretch is not None:
        info["busy_s"] = stretch.busy_s
        info["window_s"] = stretch.window_s
    return info


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    bench = json.loads(BENCHMARK_JSON.read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        print(f"no workload {args.workload!r} in {BENCHMARK_JSON.name}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = execute(bench, args.workload, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()  # after the metrics' readers and the reference
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
