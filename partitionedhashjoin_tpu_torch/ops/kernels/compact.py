"""Stable stream compaction: the port of the TPU kernel K5.

Counterpart of ``partitionedhashjoin_tpu/ops/pallas/compact.py``:

- ``block_compact(keep, *cols)``: the kept rows moved to the front in their
  original order, with each kept row's original index in ``pos``.  It keeps
  the JAX contract (``n`` a multiple of ``BLK``, at most ``MAX_COLS`` int32
  columns, outputs of ``n + BLK`` elements), and its output has no sentinel
  gaps: ``aligned_total`` equals the kept count, and elements at
  ``>= aligned_total`` are undefined.
- ``compact_columns(keep, *cols, capacity=None)``: the exact front
  compaction with a zero tail, in arrays of JAX's length ``cap_bound``.
- ``compact_rows(keep, cols, out_len, zero_tail=True)``: the same
  compaction for any ``n`` and any output length, which the port's own
  operators call (the ``BLK`` contract exists only for the JAX API).
- ``compact_any(keep, cols, out_len)``: ``compact_rows`` for columns of any
  dtype and number: each column rides as int32 lanes, bit for bit, and
  more than ``MAX_COLS`` lanes take several launches over one ``keep``.

On a CUDA tensor all four launch the hand-written kernel in
``csrc/compact.cu`` (one pass over ``keep`` with a decoupled look-back, after
a memset of its tile status words); on a CPU tensor they run
``compact_plain``, the plain PyTorch version, which tests and
``chip_smoke.py`` also hold the kernel against.  Counts are 0-dim int64
tensors (JAX's are int32).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from partitionedhashjoin_tpu_torch.ops.kernels import _build

#: Block of the JAX kernel's contract: inputs are a multiple of it long, and
#: outputs are ``n + BLK`` long (``ops/pallas/bitonic_sort.py``).
BLK = 8192
#: Lane width that sets JAX's ``compact_columns`` capacity bound.
LANES = 128
#: Columns a call can carry besides ``pos``; equals kMaxCols in
#: csrc/compact.cu (checked when the library loads).
MAX_COLS = 6
#: Rows per tile; equals kTile in csrc/compact.cu (checked when the library
#: loads).  Tests use it to place kept rows on tile edges.
TILE_ROWS = 4096

#: Calls that launched the kernel since the last reset (set to 0 to reset).
#: One call makes one memset and one launch on one stream and adds one.
LAUNCHES = 0

_SIGNATURES = {
    "phj_compact_tile_rows": ((), ctypes.c_int),
    "phj_compact_max_cols": ((), ctypes.c_int),
    "phj_compact": (
        (
            ctypes.c_void_p,  # keep (one byte per row)
            ctypes.c_int64,  # n
            ctypes.c_int,  # n_cols
            *([ctypes.c_void_p] * MAX_COLS),  # in0..in5
            *([ctypes.c_void_p] * MAX_COLS),  # out0..out5
            ctypes.c_void_p,  # out_pos
            ctypes.c_int64,  # out_len
            ctypes.c_void_p,  # scratch (tiles + 1 int64)
            ctypes.c_void_p,  # total (int64)
            ctypes.c_void_p,  # cudaStream_t
        ),
        ctypes.c_int,
    ),
}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    lib = _build.load("compact", _SIGNATURES)
    tile, cols = lib.phj_compact_tile_rows(), lib.phj_compact_max_cols()
    if (tile, cols) != (TILE_ROWS, MAX_COLS):
        raise RuntimeError(
            f"compact.cu tiles {tile} rows and carries {cols} columns, the "
            f"wrapper expects {TILE_ROWS} and {MAX_COLS}"
        )
    return lib


def compact_plain(
    keep: torch.Tensor, cols: Sequence[torch.Tensor], out_len: int
) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version: ``(count, pos, *outs)`` with the kept rows
    in order at ``[0, min(count, out_len))`` of ``out_len``-long outputs and
    zeros after them; ``pos`` is int32, each output keeps its column's
    dtype.  An exclusive prefix sum gives each kept row its position;
    rejected rows and rows past ``out_len`` scatter into a dump slot.  Works
    on any device."""
    n = keep.shape[0]
    device = keep.device
    kept = keep.to(torch.int64)
    at = torch.cumsum(kept, 0) - kept
    at = torch.where(keep & (at < out_len), at, out_len)

    def place(src):
        out = torch.zeros((out_len + 1,), dtype=src.dtype, device=device)
        return out.scatter_(0, at, src)[:out_len]

    pos = place(torch.arange(n, dtype=torch.int32, device=device))
    return (kept.sum(), pos, *(place(c) for c in cols))


def _check(keep: torch.Tensor, cols: Sequence[torch.Tensor]) -> None:
    if keep.dtype != torch.bool or keep.dim() != 1:
        raise TypeError(
            f"keep must be a 1-D bool tensor, got {keep.dtype} of shape "
            f"{tuple(keep.shape)}"
        )
    if len(cols) > MAX_COLS:
        raise ValueError(f"at most {MAX_COLS} columns, got {len(cols)}")
    if keep.shape[0] >= 2**31:
        raise ValueError("too many rows for int32 positions")
    for i, c in enumerate(cols):
        if c.dtype != torch.int32 or c.shape != keep.shape:
            raise TypeError(
                f"column {i} must be int32 of shape {tuple(keep.shape)}, got "
                f"{c.dtype} of shape {tuple(c.shape)}"
            )
    for i, t in enumerate((keep, *cols)):
        if not t.is_contiguous():
            raise ValueError(f"input {i} must be contiguous")
        if t.device != keep.device:
            raise ValueError(
                f"inputs on different devices: {t.device} vs {keep.device}"
            )


def _check_blocks(keep: torch.Tensor, cols: Sequence[torch.Tensor]) -> None:
    """The JAX kernel's contract: valid inputs of whole ``BLK``-row blocks."""
    _check(keep, cols)
    n = keep.shape[0]
    if n % BLK:
        raise ValueError(f"pad to a multiple of BLK={BLK} first (n={n})")


def compact_rows(
    keep: torch.Tensor, cols: Sequence[torch.Tensor], out_len: int,
    zero_tail: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """``(count, pos, *outs)``: the kept rows of ``keep`` (bool[n], any n)
    moved to the front of ``out_len``-long outputs in their original order,
    ``pos`` their original indices (int32), ``count`` exact even when it
    exceeds ``out_len``.  ``cols`` are at most ``MAX_COLS`` int32[n].  A CPU
    tensor runs the plain version (zero tail); a CUDA tensor launches the
    kernel or raises, and with ``zero_tail`` False leaves the outputs past
    the kept rows unwritten."""
    global LAUNCHES
    _check(keep, cols)
    device = keep.device
    if device.type == "cpu":
        return compact_plain(keep, cols, out_len)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    alloc = torch.zeros if zero_tail else torch.empty
    outs = [alloc((out_len,), dtype=torch.int32, device=device)
            for _ in range(len(cols) + 1)]
    total = torch.zeros((), dtype=torch.int64, device=device)
    n = keep.shape[0]
    if n == 0:
        return (total, *outs)
    tiles = -(-n // TILE_ROWS)
    scratch = torch.empty((tiles + 1,), dtype=torch.int64, device=device)
    pad = [None] * (MAX_COLS - len(cols))
    ins = [c.data_ptr() for c in cols] + pad
    out_ptrs = [o.data_ptr() for o in outs[1:]] + pad
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.phj_compact(
            keep.data_ptr(), n, len(cols), *ins, *out_ptrs,
            outs[0].data_ptr(), out_len, scratch.data_ptr(), total.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"phj_compact launch failed: CUDA error {err}")
    LAUNCHES += 1
    return (total, *outs)


#: The int32 view K5 carries a column of each element size in, bit for bit.
_NARROW_BITS = {1: torch.uint8, 2: torch.int16}


def _i32_lanes(col: torch.Tensor) -> list:
    """A column as int32 lanes that K5 can carry, bit for bit: a 32-bit
    column viewed as int32, a 64-bit one as its two 32-bit halves, and an
    8- or 16-bit one (bool and float16 included) widened from its bits."""
    # an empty tensor may keep stride 0, which a view to int32 refuses
    col = col.contiguous() if col.numel() else torch.empty_like(
        col, memory_format=torch.contiguous_format)
    size = col.element_size()
    if size == 4:
        return [col.view(torch.int32)]
    if size == 8:
        return list(col.view(torch.int32).view(-1, 2).t().contiguous())
    return [col.view(_NARROW_BITS[size]).to(torch.int32)]


def _from_lanes(lanes: list, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of ``_i32_lanes`` for a column of ``dtype``."""
    size = dtype.itemsize
    if size == 4:
        return lanes[0].view(dtype)
    if size == 8:
        return torch.stack(lanes, dim=1).view(dtype).view(-1)
    return lanes[0].to(_NARROW_BITS[size]).view(dtype)


def compact_any(
    keep: torch.Tensor, cols: Sequence[torch.Tensor], out_len: int
) -> Tuple[torch.Tensor, ...]:
    """``(count, pos, *outs)`` as ``compact_rows`` (zero tail), for 1-D
    columns of any dtype, each output in its column's dtype.  Every column
    is split into int32 lanes (``_i32_lanes``) and rebuilt from them
    (``_from_lanes``), bit for bit; more than ``MAX_COLS`` lanes take one
    launch per ``MAX_COLS`` over the same ``keep``."""
    keep = keep.to(torch.bool).contiguous()
    lanes = [_i32_lanes(c) for c in cols]
    flat = [lane for col_lanes in lanes for lane in col_lanes]
    count, pos, *outs = compact_rows(keep, flat[:MAX_COLS], out_len)
    for i in range(MAX_COLS, len(flat), MAX_COLS):
        outs += compact_rows(keep, flat[i:i + MAX_COLS], out_len)[2:]
    results = []
    for col, col_lanes in zip(cols, lanes):
        results.append(_from_lanes(outs[:len(col_lanes)], col.dtype))
        outs = outs[len(col_lanes):]
    return (count, pos, *results)


def block_compact(keep: torch.Tensor, *cols: torch.Tensor):
    """``(aligned_total, pos, *out_cols)``: the kept rows at
    ``[0, aligned_total)`` in original order, ``pos`` their original row
    indices (int32), each output ``n + BLK`` long.  ``keep`` is bool[n] with
    n a multiple of ``BLK``; ``cols`` are at most ``MAX_COLS`` int32[n].
    The output has no sentinel gaps (``aligned_total`` is the kept count);
    elements at ``>= aligned_total`` are undefined.  A CUDA input launches
    the kernel or raises."""
    _check_blocks(keep, cols)
    return compact_rows(keep, cols, keep.shape[0] + BLK, zero_tail=False)


def compact_columns(
    keep: torch.Tensor, *cols: torch.Tensor, capacity: Optional[int] = None
):
    """Exact front compaction: ``(count, ok, pos, *compacted)`` with arrays of
    JAX's length ``cap_bound = min(cap + blocks * (LANES - 1) + LANES,
    n + BLK)`` (``cap = min(capacity, n)``): kept rows at
    ``[0, min(count, cap_bound))`` in original order, zeros after them.
    ``count`` is exact either way; ``ok`` (0-dim bool) is False when the
    kept rows overflow ``cap_bound`` — retry with a larger capacity."""
    _check_blocks(keep, cols)
    n = keep.shape[0]
    cap = n if capacity is None else min(capacity, n)
    cap_bound = min(cap + (n // BLK) * (LANES - 1) + LANES, n + BLK)
    count, pos, *outs = compact_rows(keep, cols, cap_bound)
    return (count, count <= cap_bound, pos, *outs)
