"""Helpers shared by the script entries: the ``--platform`` flag, the device
and its name, seeded generators and best-of timing.  ``log`` and the
reference's baseline are the bench's own."""

from __future__ import annotations

import argparse
import time
from typing import Callable, Tuple

import torch

from partitionedhashjoin_tpu_torch.bench import BASELINE_ROWS_PER_S, log
from partitionedhashjoin_tpu_torch.utils.device import resolve_device, sync

__all__ = ["BASELINE_ROWS_PER_S", "add_platform", "best_of", "generator",
           "log", "open_device"]


def add_platform(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--platform", default="cuda",
                   help="torch device: 'cuda' (default) or 'cpu'")
    return p


def open_device(platform: str) -> Tuple[torch.device, str]:
    """The device ``platform`` names and what the JSON line calls it: the
    card's name, or "cpu".  A missing card raises."""
    device = resolve_device(platform)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return device, kind


def generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def best_of(fn: Callable[[], object], reps: int, device: torch.device) -> float:
    """Seconds of the fastest of ``reps`` runs of ``fn``, each closed by a
    barrier."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best
