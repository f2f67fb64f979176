"""The traced stretch of a run: ``torch.profiler`` over a few seconds of the
window, reduced to device intervals, kernel times by name and idle gaps.

The trace goes to a temporary file under ``TMPDIR`` (Chrome trace format),
is read back and deleted.  Device events are kernels, copies and sets; the
stretch is the span of the ``STRETCH`` annotation the harness opens around
its operations.  An idle gap is named by what the host was doing at its
middle: the innermost profiled host event (a torch op, a CUDA runtime call)
that covers it, else ``host: between operations`` or ``host: python inside
the operation``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from collections import defaultdict

import torch

STRETCH = "benchmark_stretch"
OPERATION = "benchmark_operation"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
#: Entries of each breakdown list.
TOP = 10


@dataclasses.dataclass
class Stretch:
    window_s: float
    busy_s: float
    device_events: int
    #: seconds on the device by kernel (or copy) name
    device_seconds: dict
    #: seconds of idle device by what the host was doing
    idle_seconds: dict

    def breakdown(self) -> dict:
        def top(d):
            return [[k, v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.device_seconds),
                "idle_gaps": top(self.idle_seconds)}


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    argument list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:  # cut at the first "(" outside <...> and {...}
        if ch in "<{":
            depth += 1
        elif ch in ">}":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        out.append(ch)
    return "".join(out).strip()[:160]


def _union(intervals):
    total, end = 0.0, None
    merged = []
    for a, b in sorted(intervals):
        if end is None or a > end:
            merged.append([a, b])
            end = b
        elif b > end:
            merged[-1][1] = b
            end = b
    for a, b in merged:
        total += b - a
    return total, merged


def reduce_trace(events) -> Stretch:
    """The stretch of one trace's events (Chrome trace ``traceEvents``)."""
    spans = [e for e in events if e.get("ph") == "X"]
    stretch = [e for e in spans if e.get("name") == STRETCH
               and e.get("cat") == "user_annotation"]
    if not stretch:
        raise RuntimeError(f"the trace has no {STRETCH} annotation")
    t0 = float(stretch[0]["ts"])
    t1 = t0 + float(stretch[0]["dur"])
    device, by_name = [], defaultdict(float)
    for e in spans:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        a = max(float(e["ts"]), t0)
        b = min(float(e["ts"]) + float(e["dur"]), t1)
        if b <= a:
            continue
        device.append((a, b))
        by_name[short_name(e["name"])] += (b - a) * 1e-6
    busy_us, merged = _union(device)
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    mids = [(a + b) / 2 for a, b in gaps]
    host = _innermost(mids, [e for e in spans if e.get("cat") in _HOST_CATS])
    inside = _innermost(mids, [e for e in spans if e.get("name") == OPERATION])
    idle = defaultdict(float)
    for (a, b), name, op in zip(gaps, host, inside):
        if name is None:
            name = ("host: python inside the operation" if op
                    else "host: between operations")
        idle[name] += (b - a) * 1e-6
    return Stretch(window_s=(t1 - t0) * 1e-6, busy_s=busy_us * 1e-6,
                   device_events=len(device), device_seconds=dict(by_name),
                   idle_seconds=dict(idle))


def _innermost(times, events) -> list:
    """For each of the ascending ``times``, the name of the innermost event
    covering it, or None.  Host events of one thread nest, so a stack of
    the open ones, swept in time order, holds the answer on top."""
    rows = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events)
    stack, out, j = [], [], 0
    for t in times:
        while j < len(rows) and rows[j][0] <= t:
            while stack and stack[-1][1] < rows[j][0]:
                stack.pop()
            stack.append(rows[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


class Tracer:
    """Profiles from ``start`` to ``stop``; ``result()`` reads the trace."""

    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._mark = None
        self.active = False

    def start(self) -> None:
        self._prof.start()
        self._mark = torch.profiler.record_function(STRETCH)
        self._mark.__enter__()
        self.active = True

    def stop(self) -> None:
        self._mark.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self.active = False

    def result(self) -> Stretch:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return reduce_trace(events)
