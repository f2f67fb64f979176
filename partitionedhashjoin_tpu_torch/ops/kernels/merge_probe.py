"""Ranged merge-probe count: the port of the TPU kernels K1 and K3.

Counterparts of ``partitionedhashjoin_tpu/ops/pallas/merge_probe.py``:

- ``ranged_merge_count_prepared`` (K1, ``ranged_merge_count_prepared``)
  counts the rows of an ascending int32 probe run whose key occurs in an
  ascending int32 build run;
- ``ranged_merge_count_i64`` (K3, ``ranged_merge_count_i64`` /
  ``_count_i64_planes_full``) does the same for int64 runs, over the full
  int64 domain.  The JAX package splits int64 keys into (hi, lo) int32
  planes because Mosaic is 32-bit; the port compares int64 natively.

On a CUDA tensor each launches its hand-written kernel in
``csrc/merge_probe.cu``; on a CPU tensor it runs its plain PyTorch version
(``ranged_merge_count_plain``, ``ranged_merge_count_i64_plain``), which tests
and ``chip_smoke.py`` also hold the kernel against.
"""

from __future__ import annotations

import ctypes

import torch

from partitionedhashjoin_tpu_torch.ops.kernels import _build

INT32_MAX = 2**31 - 1

#: Probe rows per thread block; equals kTile in csrc/merge_probe.cu (checked
#: when the library loads).  Tests use it to place duplicate runs on tile edges.
TILE_ROWS = 4096

#: Build rows per shared-memory chunk of the count kernel, for int32 and
#: for int64 keys: kChunk<Key> in csrc/merge_probe.cu, 16 KB of keys.
#: Tests use them to place duplicate runs on chunk edges.
CHUNK_ROWS = 4096
CHUNK_ROWS_I64 = 2048

#: Kernel launches since the last reset (set to 0 to reset).  Only a launch of
#: the CUDA kernel adds to it: ``LAUNCHES`` for K1 (int32), ``LAUNCHES_I64``
#: for K3 (int64).
LAUNCHES = 0
LAUNCHES_I64 = 0

_SIGNATURES = {
    "phj_merge_probe_tile_rows": ((), ctypes.c_int),
    "phj_merge_probe_count": (
        (
            ctypes.c_void_p,  # a
            ctypes.c_int64,  # n_a
            ctypes.c_void_p,  # b
            ctypes.c_int64,  # n_b
            ctypes.c_int,  # exclude_int32_max
            ctypes.c_void_p,  # ranges (int64 scratch, range_slots(n_b))
            ctypes.c_void_p,  # total (uint64 counter)
            ctypes.c_void_p,  # cudaStream_t
        ),
        ctypes.c_int,
    ),
    "phj_merge_probe_count_i64": (
        (
            ctypes.c_void_p,  # a
            ctypes.c_int64,  # n_a
            ctypes.c_void_p,  # b
            ctypes.c_int64,  # n_b
            ctypes.c_void_p,  # ranges (int64 scratch, range_slots(n_b))
            ctypes.c_void_p,  # total (uint64 counter)
            ctypes.c_void_p,  # cudaStream_t
        ),
        ctypes.c_int,
    ),
    # K4, wrapped by ops/kernels/merge_payload.py
    "phj_merge_probe_payload": (
        (
            ctypes.c_void_p,  # a
            ctypes.c_void_p,  # a_payloads
            ctypes.c_int64,  # n_a
            ctypes.c_void_p,  # b
            ctypes.c_int64,  # n_b
            ctypes.c_int,  # exclude_int32_max
            ctypes.c_void_p,  # pay (int32 out)
            ctypes.c_void_p,  # pos (int32 out)
            ctypes.c_void_p,  # cudaStream_t
        ),
        ctypes.c_int,
    ),
}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = _build.load("merge_probe", _SIGNATURES)
    tile = lib.phj_merge_probe_tile_rows()
    if tile != TILE_ROWS:
        raise RuntimeError(
            f"merge_probe.cu tiles {tile} probe rows, the wrapper expects "
            f"{TILE_ROWS}"
        )
    return lib


def range_slots(n_b: int) -> int:
    """Length of the kernels' int64 scratch for ``n_b`` probe rows: the
    (lo, hi) build range of every probe tile, then the search limit."""
    return 2 * -(-n_b // TILE_ROWS) + 1


def tile_ranges_plain(
    a_sorted: torch.Tensor, b_sorted: torch.Tensor, exclude_int32_max: bool = False
) -> torch.Tensor:
    """The build range [lo, hi) that the count kernel merges for each probe
    tile of ``TILE_ROWS`` rows, as an (n_tiles, 2) int64 tensor: lo =
    lower_bound(first key), hi = lower_bound(last key), plus one where the
    last key is in ``a_sorted``, both clamped to the search limit.  The
    first occurrence of every build key a tile's rows can match lies in its
    range; the range is empty when none can."""
    n_b, n_a = b_sorted.shape[0], a_sorted.shape[0]
    if n_b == 0:
        return torch.zeros((0, 2), dtype=torch.int64, device=a_sorted.device)
    starts = torch.arange(0, n_b, TILE_ROWS, device=b_sorted.device)
    lasts = b_sorted[torch.clamp(starts + TILE_ROWS, max=n_b) - 1]
    lo = torch.searchsorted(a_sorted, b_sorted[starts], side="left")
    hi = torch.searchsorted(a_sorted, lasts, side="left")
    if n_a:
        hi = hi + (a_sorted[torch.clamp(hi, max=n_a - 1)] == lasts)
    limit = _search_limit(a_sorted, exclude_int32_max)
    return torch.clamp(torch.stack([lo, hi], dim=1), max=limit)


def _search_limit(a_sorted: torch.Tensor, exclude_int32_max: bool) -> int:
    if not exclude_int32_max:
        return a_sorted.shape[0]
    sentinel = torch.full((1,), INT32_MAX, dtype=torch.int32, device=a_sorted.device)
    return int(torch.searchsorted(a_sorted, sentinel, side="left")[0])


def ranged_merge_count_plain(
    a_sorted: torch.Tensor, b_sorted: torch.Tensor, exclude_int32_max: bool = False
) -> torch.Tensor:
    """The plain PyTorch version: a probe row counts when its left and right
    insertion points in ``a_sorted[:limit]`` differ.  Works on any device."""
    if a_sorted.shape[0] == 0 or b_sorted.shape[0] == 0:
        return torch.zeros((), dtype=torch.int64, device=a_sorted.device)
    a = a_sorted[: _search_limit(a_sorted, exclude_int32_max)]
    left = torch.searchsorted(a, b_sorted, side="left")
    right = torch.searchsorted(a, b_sorted, side="right")
    return (right > left).sum()


def ranged_merge_count_i64_plain(
    a_sorted: torch.Tensor, b_sorted: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version of the int64 count (the same left/right
    insertion-point test over the whole int64 domain).  Works on any device."""
    return ranged_merge_count_plain(a_sorted, b_sorted)


def _check(
    a_sorted: torch.Tensor, b_sorted: torch.Tensor, dtype=torch.int32
) -> None:
    for name, t in (("a_sorted", a_sorted), ("b_sorted", b_sorted)):
        if t.dtype != dtype or t.dim() != 1:
            raise TypeError(
                f"{name} must be a 1-D {dtype} tensor, got {t.dtype} of "
                f"shape {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a_sorted.device != b_sorted.device:
        raise ValueError(
            f"inputs on different devices: {a_sorted.device} vs {b_sorted.device}"
        )


def ranged_merge_count_prepared(
    a_sorted: torch.Tensor, b_sorted: torch.Tensor, exclude_int32_max: bool = False
) -> torch.Tensor:
    """Number of ``b_sorted`` rows whose key exists in ``a_sorted`` (both
    ascending int32), as a 0-dim int64 tensor on the inputs' device.

    ``exclude_int32_max=True`` searches only below the first INT32_MAX build
    key, so it counts no INT32_MAX probe row — the validity protocol of
    ``ops/merge_join.py``.  A CUDA input launches the kernel or raises.
    """
    global LAUNCHES
    _check(a_sorted, b_sorted)
    if a_sorted.device.type == "cpu":
        return ranged_merge_count_plain(a_sorted, b_sorted, exclude_int32_max)
    total, launched = _launch(
        "phj_merge_probe_count", a_sorted, b_sorted, int(exclude_int32_max)
    )
    LAUNCHES += launched
    return total


def ranged_merge_count_i64(
    a_sorted: torch.Tensor, b_sorted: torch.Tensor
) -> torch.Tensor:
    """Number of ``b_sorted`` rows whose key exists in ``a_sorted`` (both
    ascending int64), over the full int64 domain, as a 0-dim int64 tensor on
    the inputs' device.  A CUDA input launches the K3 kernel or raises."""
    global LAUNCHES_I64
    _check(a_sorted, b_sorted, torch.int64)
    if a_sorted.device.type == "cpu":
        return ranged_merge_count_i64_plain(a_sorted, b_sorted)
    total, launched = _launch("phj_merge_probe_count_i64", a_sorted, b_sorted)
    LAUNCHES_I64 += launched
    return total


def _launch(entry: str, a_sorted, b_sorted, *flags):
    """(total, 1) after launching ``entry`` on the current stream, or
    (zero, 0) when a side is empty; raises on a non-CUDA device or a
    refused launch."""
    device = a_sorted.device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    total = torch.zeros((), dtype=torch.int64, device=device)
    n_a, n_b = a_sorted.shape[0], b_sorted.shape[0]
    if n_a == 0 or n_b == 0:
        return total, 0
    lib = load_library()
    ranges = torch.empty(range_slots(n_b), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(
            a_sorted.data_ptr(), n_a, b_sorted.data_ptr(), n_b, *flags,
            ranges.data_ptr(), total.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return total, 1
