"""Tracing and roofline accounting.

Counterpart of ``partitionedhashjoin_tpu/utils/profiling.py``:

- ``trace(log_dir)``: a ``torch.profiler`` trace of the CPU and, where there
  is one, the CUDA device over [enter, exit), written to ``log_dir`` as a
  Chrome trace (open it in Perfetto or ``chrome://tracing``).
- ``roofline(...)``: memory-bandwidth roofline accounting for a phase — the
  engine's kernels are memory-bound, so achieved GB/s over peak GB/s is the
  speed-of-light fraction.

The JAX module's ``sort_merge_bytes`` is not copied: its "~8 passes" is a
measurement of XLA's sort on a TPU and says nothing about a sort on the GPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Iterator

#: Peak device-memory bandwidth per chip, GB/s.  "h100" is the H100 SXM's
#: 3.35 TB/s (NVIDIA data sheet), the port's default; the TPU entries are
#: kept so that the JAX package's figures can be restated.
HBM_PEAK_GBPS = {
    "h100": 3350.0,
    "v5e": 819.0,
    "v5p": 2765.0,
    "v4": 1228.0,
}
DEFAULT_CHIP = "h100"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a profile of [enter, exit) into ``log_dir/trace.json``.

    Records CPU activity, and CUDA activity when a card is present.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclasses.dataclass
class RooflineReport:
    """Achieved vs peak memory bandwidth for one phase."""

    seconds: float
    bytes_moved: int
    achieved_gbps: float
    peak_gbps: float

    @property
    def fraction_of_peak(self) -> float:
        return self.achieved_gbps / self.peak_gbps

    def __str__(self) -> str:
        return (
            f"{self.bytes_moved / 1e9:.2f} GB in {self.seconds * 1e3:.0f} ms "
            f"-> {self.achieved_gbps:.0f} GB/s "
            f"({self.fraction_of_peak * 100:.0f}% of {self.peak_gbps:.0f} peak)"
        )


def roofline(
    seconds: float, bytes_moved: int, chip: str = DEFAULT_CHIP
) -> RooflineReport:
    """Bandwidth roofline for a measured phase.

    ``bytes_moved`` is the algorithmic device-memory traffic (reads + writes
    of live arrays); callers compute it from shapes, e.g. a 210M-row
    2-operand sort moves ~2 * passes * 210M * 5 bytes.  An unknown ``chip``
    takes the default chip's peak, as in the JAX module.
    """
    peak = HBM_PEAK_GBPS.get(chip, HBM_PEAK_GBPS[DEFAULT_CHIP])
    achieved = bytes_moved / max(seconds, 1e-12) / 1e9
    return RooflineReport(
        seconds=seconds,
        bytes_moved=bytes_moved,
        achieved_gbps=achieved,
        peak_gbps=peak,
    )
