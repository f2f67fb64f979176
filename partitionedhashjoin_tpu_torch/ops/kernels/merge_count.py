"""Fused merge count: the port of the TPU kernel K2.

Counterpart of ``partitionedhashjoin_tpu/ops/pallas/merge_count.py::
merge_count_sorted``.  Over the merged, sorted stream of the sort-merge join
(int32 keys ascending, build rows before equal-keyed probe rows), it counts
the probe rows whose key equals the running maximum of
``where(is_build, key, INT32_MIN)``, INT32_MIN excluded (the caller corrects
for INT32_MIN keys).  The count is defined, and computed, for rows in any
order.  On a CUDA tensor it launches the hand-written one-pass kernel in
``csrc/merge_count.cu`` (a decoupled look-back carries the running maximum
across tiles); on a CPU tensor it runs ``merge_count_sorted_plain``, the
plain PyTorch version of the same contract, which tests and
``chip_smoke.py`` also hold the kernel against.
"""

from __future__ import annotations

import ctypes

import torch

from partitionedhashjoin_tpu_torch.ops.kernels import _build

INT32_MIN = -(2**31)

#: Rows per thread block; equals kTile in csrc/merge_count.cu (checked when
#: the library loads).  Tests use it to place runs on block edges.
TILE_ROWS = 8192

#: Calls that launched the kernel since the last reset (set to 0 to reset).
LAUNCHES = 0

_SIGNATURES = {
    "phj_merge_count_tile_rows": ((), ctypes.c_int),
    "phj_merge_count": (
        (
            ctypes.c_void_p,  # keys
            ctypes.c_void_p,  # is_build (one byte per row)
            ctypes.c_int64,  # n
            ctypes.c_void_p,  # scratch (int64: total, tile counter, status)
            ctypes.c_int64,  # scratch words
            ctypes.c_void_p,  # cudaStream_t
        ),
        ctypes.c_int,
    ),
}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = _build.load("merge_count", _SIGNATURES)
    tile = lib.phj_merge_count_tile_rows()
    if tile != TILE_ROWS:
        raise RuntimeError(
            f"merge_count.cu tiles {tile} rows, the wrapper expects {TILE_ROWS}"
        )
    return lib


def scratch_words(n: int) -> int:
    """int64 words of the kernel's scratch for n rows: the total, the tile
    counter and one look-back status word per tile.  The kernel lays its
    tiles out from the 16-byte boundary at or before ``keys[0]``, up to 3
    rows earlier, so n rows span at most one tile more than ceil(n /
    TILE_ROWS); the C entry refuses a shorter buffer."""
    return 3 + -(-n // TILE_ROWS)


def merge_count_sorted_plain(
    keys_sorted: torch.Tensor, is_build_sorted: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version: ``cummax`` of the masked build keys,
    compared with each probe row's key.  Works on any device."""
    if keys_sorted.shape[0] == 0:
        return torch.zeros((), dtype=torch.int64, device=keys_sorted.device)
    is_build = is_build_sorted.to(torch.bool)
    masked = torch.where(is_build, keys_sorted, INT32_MIN)
    last_build = torch.cummax(masked, dim=0).values
    hit = ~is_build & (last_build == keys_sorted) & (keys_sorted != INT32_MIN)
    return hit.sum()


def _check(keys_sorted: torch.Tensor, is_build_sorted: torch.Tensor) -> None:
    if keys_sorted.dtype != torch.int32 or keys_sorted.dim() != 1:
        raise TypeError(
            "keys_sorted must be a 1-D int32 tensor, got "
            f"{keys_sorted.dtype} of shape {tuple(keys_sorted.shape)}"
        )
    if is_build_sorted.dtype not in (torch.bool, torch.uint8):
        raise TypeError(
            f"is_build_sorted must be bool or uint8, got {is_build_sorted.dtype}"
        )
    if is_build_sorted.shape != keys_sorted.shape:
        raise ValueError(
            f"is_build_sorted {tuple(is_build_sorted.shape)} does not match "
            f"keys_sorted {tuple(keys_sorted.shape)}"
        )
    for name, t in (("keys_sorted", keys_sorted), ("is_build_sorted", is_build_sorted)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if keys_sorted.device != is_build_sorted.device:
        raise ValueError(
            f"inputs on different devices: {keys_sorted.device} vs "
            f"{is_build_sorted.device}"
        )


def merge_count_sorted(
    keys_sorted: torch.Tensor, is_build_sorted: torch.Tensor
) -> torch.Tensor:
    """Probe hits over the merged sorted stream (see the module note), as a
    0-dim int64 tensor on the inputs' device.  ``is_build_sorted`` is bool or
    uint8 (nonzero = build row).  A CUDA input launches the kernel or
    raises."""
    global LAUNCHES
    _check(keys_sorted, is_build_sorted)
    device = keys_sorted.device
    if device.type == "cpu":
        return merge_count_sorted_plain(keys_sorted, is_build_sorted)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n = keys_sorted.shape[0]
    if n == 0:
        return torch.zeros((), dtype=torch.int64, device=device)
    words = scratch_words(n)
    # zeroed by the kernel's entry; word 0 receives the count
    scratch = torch.empty((words,), dtype=torch.int64, device=device)
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.phj_merge_count(
            keys_sorted.data_ptr(), is_build_sorted.data_ptr(), n,
            scratch.data_ptr(), words, stream,
        )
    if err != 0:
        raise RuntimeError(f"merge_count kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return scratch[0]
