"""Tuple sort of int32 rows, and sort of int64 keys: the port of the TPU
kernel K6.

Counterpart of ``partitionedhashjoin_tpu/ops/pallas/bitonic_sort.py`` (the
module keeps its name so that a reader finds it).  Every function but
``sort_i64`` sorts int32 row TUPLES ascending in full lexicographic order (by
operand 0, ties by operand 1, and so on).  Ties are bit-identical tuples, so
the sort has exactly one correct output:

- ``sort_i32(x)`` / ``sort_i32_tuple(*operands)``: any length.  On the card
  this is NOT the TPU's bitonic block sort and merge passes but a one-sweep
  LSD radix sort (``csrc/radix_sort.cu``): one upsweep builds every 8-bit
  digit's histogram, then one sweep pass per digit that is not the same in
  every row (``radix_plan``).  It computes the same unique answer and moves
  each operand once per pass, where the merge sort moved it once per phase
  (16 times at 200M rows) and lost to ``torch.sort``.
- ``sort_i64(x)``: an int64 key, keys only, any length, on the same radix
  sort: the key biased by ``^ (1 << 63)`` is read as 8 bytes, whose
  histograms come in the rows of a (hi, lo) tuple, so the same plan skips
  every byte that does not vary.  It has no JAX counterpart (the JAX
  package sorts int64 keys as (hi, lo) int32 planes).
- ``sort_blocks_i32(x)`` / ``sort_blocks_tuple`` (phase A, K6a): each
  ``BLK``-row block sorted on its own; length a multiple of ``BLK``.
- ``merge_pass_i32(x, run_len)`` / ``merge_pass_tuple`` (phase B, K6b): one
  pairwise merge pass, sorted runs of ``run_len`` (a positive multiple of
  ``BLK``) become sorted runs of ``2 * run_len``; a lone tail run is copied
  through and a truncated last run merges as it is.  These two launch the
  kernels of ``csrc/bitonic_sort.cu``, the counterparts of JAX's phase
  functions: K6a is a block-local LSD radix sort in shared memory (one pass
  per digit that varies within the block), not JAX's bitonic network, and
  K6b a merge path.  The full sort no longer uses them.

On CUDA tensors they launch the hand-written kernels (at most
``MAX_OPERANDS`` operands; a wider tuple raises ``ValueError``) or raise; on
CPU tensors they run the plain PyTorch versions (``*_plain``: cascades of
stable ``torch.sort`` calls from the last operand to the first; for
``sort_i64``, ``torch.sort(x).values``), which tests and ``chip_smoke.py``
also hold the kernels against.  The JAX package's TPU
tuning arguments (``block_rows``, ``phase_a``, ``interpret``) have no
counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import torch

from partitionedhashjoin_tpu_torch.ops.kernels import _build

INT32_MAX = 2**31 - 1
INT64_MIN = -(2**63)

#: Rows per phase-A block and per merge tile; equals kBlk in
#: csrc/bitonic_sort.cu (checked when the library loads).
BLK = 8192
#: Operands a kernel call takes; equals kMaxOperands in csrc/bitonic_sort.cu.
MAX_OPERANDS = 4

#: Kernel calls since the last reset (set to 0 to reset): ``LAUNCHES_BLOCKS``
#: for phase A (K6a), ``LAUNCHES_MERGE`` for merge passes (K6b; each pass
#: launches a split search and a merge on one stream and adds one);
#: ``LAUNCHES_UPSWEEP`` for the radix sort's histograms (a memset, the
#: upsweep and the offsets scan: one per full sort) and ``LAUNCHES_SORT``
#: for its sweep passes (a memset and a sweep: one per digit that varies),
#: int32 tuples and int64 keys alike.
LAUNCHES_BLOCKS = 0
LAUNCHES_MERGE = 0
LAUNCHES_UPSWEEP = 0
LAUNCHES_SORT = 0
#: Sweep passes that the radix sort's plans skipped since the last reset
#: (set to 0 to reset): digits found the same in every row, of int32 tuples
#: and int64 keys alike.  With ``LAUNCHES_SORT`` it makes up every digit of
#: every sort on the card.
SWEEPS_SKIPPED = 0

#: 8-bit digits per int32 operand and buckets per digit; equal to kDigits
#: and kRadix in csrc/radix_sort.cu.
DIGITS = 4
RADIX = 256
#: Rows per sweep tile; equals kTile in csrc/radix_sort.cu (checked when the
#: library loads).
RADIX_TILE = 8192
#: Rows per sweep tile of an int64 key; equals kTile64 in csrc/radix_sort.cu
#: (checked when the library loads).
RADIX_TILE_I64 = 4096

_PTRS = [ctypes.c_void_p] * MAX_OPERANDS
_SIGNATURES = {
    "phj_bitonic_block_rows": ((), ctypes.c_int),
    "phj_bitonic_max_operands": ((), ctypes.c_int),
    "phj_sort_blocks": (
        (
            ctypes.c_int,  # k
            ctypes.c_int64,  # n
            *_PTRS,  # in0..in3
            *_PTRS,  # out0..out3
            ctypes.c_void_p,  # cudaStream_t
        ),
        ctypes.c_int,
    ),
    "phj_merge_pass": (
        (
            ctypes.c_int,  # k
            ctypes.c_int64,  # n
            ctypes.c_int64,  # run_len
            *_PTRS,  # in0..in3
            ctypes.c_int64,  # n_out
            *_PTRS,  # out0..out3
            ctypes.c_void_p,  # split (n / BLK int64)
            ctypes.c_void_p,  # cudaStream_t
        ),
        ctypes.c_int,
    ),
}


_RADIX_SIGNATURES = {
    "phj_radix_max_operands": ((), ctypes.c_int),
    "phj_radix_tile_rows": ((), ctypes.c_int),
    "phj_radix_histograms": (
        (
            ctypes.c_int,  # k
            ctypes.c_int64,  # n
            *_PTRS,  # in0..in3
            ctypes.c_void_p,  # hist (4 k x 256 uint64)
            ctypes.c_void_p,  # offsets (4 k x 256 uint64)
            ctypes.c_void_p,  # cudaStream_t
        ),
        ctypes.c_int,
    ),
    "phj_radix_pass": (
        (
            ctypes.c_int,  # k
            ctypes.c_int64,  # n
            ctypes.c_int,  # key operand
            ctypes.c_int,  # shift
            *_PTRS,  # in0..in3
            *_PTRS,  # out0..out3
            ctypes.c_void_p,  # digit offsets (256 uint64)
            ctypes.c_void_p,  # status (tiles x 256 + 1 uint64)
            ctypes.c_void_p,  # cudaStream_t
        ),
        ctypes.c_int,
    ),
    "phj_radix_tile_rows_i64": ((), ctypes.c_int),
    "phj_radix_histograms_i64": (
        (
            ctypes.c_int64,  # n
            ctypes.c_void_p,  # keys
            ctypes.c_void_p,  # hist (8 x 256 uint64)
            ctypes.c_void_p,  # offsets (8 x 256 uint64)
            ctypes.c_void_p,  # cudaStream_t
        ),
        ctypes.c_int,
    ),
    "phj_radix_pass_i64": (
        (
            ctypes.c_int64,  # n
            ctypes.c_int,  # shift
            ctypes.c_void_p,  # in
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # digit offsets (256 uint64)
            ctypes.c_void_p,  # status (tiles x 256 + 1 uint64)
            ctypes.c_void_p,  # cudaStream_t
        ),
        ctypes.c_int,
    ),
}


def load_radix_library() -> ctypes.CDLL:
    """Build (at first use) and load the radix sort's library."""
    lib = _build.load("radix_sort", _RADIX_SIGNATURES)
    ops, tile = lib.phj_radix_max_operands(), lib.phj_radix_tile_rows()
    tile64 = lib.phj_radix_tile_rows_i64()
    if (ops, tile, tile64) != (MAX_OPERANDS, RADIX_TILE, RADIX_TILE_I64):
        raise RuntimeError(
            f"radix_sort.cu sorts at most {ops} operands in {tile}-row tiles "
            f"and int64 keys in {tile64}-row tiles, the wrapper expects "
            f"{MAX_OPERANDS}, {RADIX_TILE} and {RADIX_TILE_I64}"
        )
    return lib


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the block sort and merge library."""
    lib = _build.load("bitonic_sort", _SIGNATURES)
    blk, ops = lib.phj_bitonic_block_rows(), lib.phj_bitonic_max_operands()
    if (blk, ops) != (BLK, MAX_OPERANDS):
        raise RuntimeError(
            f"bitonic_sort.cu sorts {blk}-row blocks of at most {ops} "
            f"operands, the wrapper expects {BLK} and {MAX_OPERANDS}"
        )
    return lib


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _lex_sort_rows(rows: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each row of the 2-D operands sorted in full lexicographic tuple order:
    stable sorts from the last operand to the first, every operand gathered
    through the running order."""
    order = torch.arange(rows[0].shape[1], device=rows[0].device)
    order = order.expand(rows[0].shape).contiguous()
    for op in reversed(rows):
        idx = torch.sort(torch.gather(op, 1, order), dim=1, stable=True).indices
        order = torch.gather(order, 1, idx)
    return [torch.gather(op, 1, order) for op in rows]


def _segment_sort_plain(
    operands: Sequence[torch.Tensor], seg: int
) -> List[torch.Tensor]:
    """Each consecutive ``seg``-row segment sorted; a ragged last segment
    is padded with all-INT32_MAX rows, sorted and cut back."""
    n = operands[0].shape[0]
    if n == 0:
        return [o.clone() for o in operands]
    padded = -(-n // seg) * seg
    rows = []
    for o in operands:
        p = torch.full((padded,), INT32_MAX, dtype=torch.int32, device=o.device)
        p[:n] = o
        rows.append(p.view(-1, seg))
    return [r.reshape(-1)[:n] for r in _lex_sort_rows(rows)]


def sort_i32_tuple_plain(*operands: torch.Tensor) -> List[torch.Tensor]:
    """The plain version of ``sort_i32_tuple``.  Works on any device."""
    _check(operands)
    return _segment_sort_plain(operands, max(operands[0].shape[0], 1))


def sort_blocks_plain(*operands: torch.Tensor) -> List[torch.Tensor]:
    """The plain version of phase A: each ``BLK``-row block sorted."""
    _check(operands, blocks=True)
    return _segment_sort_plain(operands, BLK)


def merge_pass_plain(*operands: torch.Tensor, run_len: int) -> List[torch.Tensor]:
    """The plain version of one merge pass: each pair of sorted runs (the
    ``2 * run_len``-row segment) sorted."""
    _check(operands, blocks=True, run_len=run_len)
    return _segment_sort_plain(operands, 2 * run_len)


# ---------------------------------------------------------------------------
# The radix sort's plan (host side)
# ---------------------------------------------------------------------------


class RadixPlan(NamedTuple):
    """The sweep passes of one full sort: ``passes[i] = (operand, byte)``
    sorts by that byte (0 = least significant) of the biased operand, in
    this order; ``targets[i]`` is ``"out"`` or ``"tmp"``, the buffer pass
    ``i`` writes (the first pass reads the inputs, each later one the buffer
    before it, and the last writes ``"out"``)."""

    passes: Tuple[Tuple[int, int], ...]
    targets: Tuple[str, ...]


def digit_order(k: int) -> List[Tuple[int, int]]:
    """Every digit of a k-operand tuple, least significant first: operand
    k-1's byte 0 first, operand 0's byte 3 last."""
    return [(c, b) for c in reversed(range(k)) for b in range(DIGITS)]


def radix_plan(hist) -> RadixPlan:
    """The plan of a full sort from its digit histograms (``4 k x 256``
    counts; row ``4 c + b`` counts byte ``b`` of operand ``c`` biased by
    ``^ 0x80000000``, as the upsweep or ``radix_histograms_plain`` give
    them; an int64 key's 8 rows are those of its (hi, lo) tuple, so pass
    ``(c, b)`` sorts by the digit at ``i64_shift(c, b)``).  A digit with a
    single non-empty bucket is the same in every row, so its pass is
    skipped: a stable sort by it would move nothing.  The buffers alternate
    so that the last pass writes the output."""
    hist = torch.as_tensor(hist)
    if hist.dim() != 2 or hist.shape[1] != RADIX or hist.shape[0] % DIGITS:
        raise ValueError(f"hist must be (4 k, {RADIX}), got {tuple(hist.shape)}")
    k = hist.shape[0] // DIGITS
    buckets = (hist != 0).sum(dim=1).tolist()
    passes = tuple((c, b) for c, b in digit_order(k)
                   if buckets[DIGITS * c + b] > 1)
    last = len(passes) - 1
    targets = tuple("out" if (last - i) % 2 == 0 else "tmp"
                    for i in range(len(passes)))
    return RadixPlan(passes, targets)


def i64_shift(c: int, b: int) -> int:
    """The bit shift of the int64 key's digit in histogram row ``4 c + b``,
    which pass ``(c, b)`` of its plan sorts by: byte ``b`` of the hi word
    (``c = 0``) or of the lo word (``c = 1``)."""
    return 8 * (b + DIGITS * (1 - c))


def digits_plain(x: torch.Tensor, byte: int) -> torch.Tensor:
    """Byte ``byte`` (0 = least significant) of int32 ``x`` biased by
    ``^ 0x80000000``, as int64: the digit the radix sort extracts."""
    return ((x.to(torch.int64) + 2**31) >> (8 * byte)) & (RADIX - 1)


def radix_histograms_plain(*operands: torch.Tensor) -> torch.Tensor:
    """The plain version of the upsweep: ``(4 k, 256)`` int64 counts of each
    byte of each biased int32 operand, or for one int64 key the ``(8, 256)``
    counts of its bytes biased by ``^ (1 << 63)``, row ``4 c + b`` the byte
    at ``i64_shift(c, b)``.  Works on any device."""
    if len(operands) == 1 and operands[0].dtype == torch.int64:
        x = _check_i64(operands[0]) ^ INT64_MIN
        return torch.stack([
            torch.bincount((x >> i64_shift(c, b)) & (RADIX - 1), minlength=RADIX)
            for c in range(2) for b in range(DIGITS)
        ])
    _check(operands)
    return torch.stack([
        torch.bincount(digits_plain(o, b), minlength=RADIX)
        for o in operands for b in range(DIGITS)
    ])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(operands, blocks: bool = False, run_len=None) -> None:
    if not operands:
        raise ValueError("at least one operand is needed")
    n = operands[0].shape[0]
    for i, o in enumerate(operands):
        if o.dtype != torch.int32 or o.dim() != 1:
            raise TypeError(
                f"operand {i} must be a 1-D int32 tensor, got {o.dtype} of "
                f"shape {tuple(o.shape)}"
            )
        if o.shape[0] != n:
            raise ValueError("operands must share a length")
        if not o.is_contiguous():
            raise ValueError(f"operand {i} must be contiguous")
        if o.device != operands[0].device:
            raise ValueError(
                f"operands on different devices: {o.device} vs "
                f"{operands[0].device}"
            )
    if blocks and n % BLK:
        raise ValueError(f"pad to a multiple of BLK={BLK} first (n={n})")
    if run_len is not None and (run_len <= 0 or run_len % BLK):
        raise ValueError(
            f"run_len must be a positive multiple of BLK={BLK}, got {run_len}"
        )


def _check_i64(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.int64 or x.dim() != 1:
        raise TypeError(f"keys must be a 1-D int64 tensor, got {x.dtype} of "
                        f"shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("keys must be contiguous")
    return x


def _cuda_device(operands) -> torch.device:
    device = operands[0].device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if len(operands) > MAX_OPERANDS:
        raise ValueError(
            f"the CUDA tuple sort takes at most {MAX_OPERANDS} operands, "
            f"got {len(operands)}"
        )
    return device


def _ptrs(tensors) -> list:
    return [t.data_ptr() for t in tensors] + [None] * (MAX_OPERANDS - len(tensors))


def _sort_blocks(lib, ins, n, outs, stream) -> None:
    global LAUNCHES_BLOCKS
    err = lib.phj_sort_blocks(len(ins), n, *_ptrs(ins), *_ptrs(outs), stream)
    if err != 0:
        raise RuntimeError(f"phj_sort_blocks launch failed: CUDA error {err}")
    LAUNCHES_BLOCKS += 1


def _merge_pass(lib, ins, n, run_len, outs, n_out, split, stream) -> None:
    global LAUNCHES_MERGE
    err = lib.phj_merge_pass(
        len(ins), n, run_len, *_ptrs(ins), n_out, *_ptrs(outs),
        split.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"phj_merge_pass launch failed: CUDA error {err}")
    LAUNCHES_MERGE += 1


def _empty_like(operands) -> List[torch.Tensor]:
    return [torch.empty_like(o) for o in operands]


def sort_blocks_tuple(*operands: torch.Tensor) -> List[torch.Tensor]:
    """Phase A (K6a): each ``BLK``-row block of the operands sorted; the
    length must be a multiple of ``BLK``.  A CUDA input launches the kernel
    or raises."""
    _check(operands, blocks=True)
    if operands[0].device.type == "cpu":
        return sort_blocks_plain(*operands)
    device = _cuda_device(operands)
    n = operands[0].shape[0]
    outs = _empty_like(operands)
    if n == 0:
        return outs
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _sort_blocks(lib, operands, n, outs, stream)
    return outs


def merge_pass_tuple(*operands: torch.Tensor, run_len: int) -> List[torch.Tensor]:
    """One merge pass (K6b): sorted runs of ``run_len`` rows become sorted
    runs of ``2 * run_len``; the length must be a multiple of ``BLK``.  A
    CUDA input launches the kernels or raises."""
    _check(operands, blocks=True, run_len=run_len)
    if operands[0].device.type == "cpu":
        return merge_pass_plain(*operands, run_len=run_len)
    device = _cuda_device(operands)
    n = operands[0].shape[0]
    outs = _empty_like(operands)
    if n == 0:
        return outs
    split = torch.empty((n // BLK,), dtype=torch.int64, device=device)
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _merge_pass(lib, operands, n, run_len, outs, n, split, stream)
    return outs


def _radix_sort(hist, rows, n, src, dst, launch_pass) -> None:
    """The sweeps of one full sort, after its upsweep: reads the histograms
    back (the one synchronisation), plans, and runs ``launch_pass(c, b,
    src, dst, digit_offsets, status)`` for each pass of the plan,
    ping-ponging between ``dst`` and one scratch set made like it (the last
    pass writes ``dst``; a plan of no passes copies ``src`` there).  Counts
    the sweeps launched and skipped."""
    global LAUNCHES_SORT, SWEEPS_SKIPPED
    plan = radix_plan(hist[0].cpu())
    SWEEPS_SKIPPED += hist.shape[1] - len(plan.passes)
    if not plan.passes:
        for o, x in zip(dst, src):
            o.copy_(x)
        return
    bufs = {"out": dst}
    if len(plan.passes) > 1:
        bufs["tmp"] = _empty_like(dst)
    status = torch.empty((-(-n // rows) * RADIX + 1,), dtype=torch.int64,
                         device=dst[0].device)
    for (c, b), target in zip(plan.passes, plan.targets):
        out = bufs[target]
        launch_pass(c, b, src, out, hist[1, DIGITS * c + b].data_ptr(),
                    status.data_ptr())
        LAUNCHES_SORT += 1
        src = out


def sort_i32_tuple(*operands: torch.Tensor) -> List[torch.Tensor]:
    """Ascending sort of int32 row tuples in full lexicographic order; any
    length.  Returns the reordered operands as a list.  A CUDA input runs
    the radix sort or raises: the upsweep, one read-back of its histograms
    (the one synchronisation), then a sweep pass per digit of
    ``radix_plan``, ping-ponging between the outputs and one scratch set.
    When no digit varies the outputs are copies of the inputs."""
    global LAUNCHES_UPSWEEP
    _check(operands)
    if operands[0].device.type == "cpu":
        return sort_i32_tuple_plain(*operands)
    device = _cuda_device(operands)
    n, k = operands[0].shape[0], len(operands)
    outs = _empty_like(operands)
    if n == 0:
        return outs
    lib = load_radix_library()
    hist = torch.empty((2, DIGITS * k, RADIX), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.phj_radix_histograms(k, n, *_ptrs(operands),
                                       hist[0].data_ptr(), hist[1].data_ptr(),
                                       stream)
        if err != 0:
            raise RuntimeError(f"phj_radix_histograms failed: CUDA error {err}")
        LAUNCHES_UPSWEEP += 1

        def launch_pass(c, b, src, dst, digit_base, status):
            err = lib.phj_radix_pass(k, n, c, 8 * b, *_ptrs(src), *_ptrs(dst),
                                     digit_base, status, stream)
            if err != 0:
                raise RuntimeError(f"phj_radix_pass failed: CUDA error {err}")

        _radix_sort(hist, RADIX_TILE, n, operands, outs, launch_pass)
    return outs


def sort_i64(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of an int64 tensor, keys only; any length.  A CPU
    input takes the plain version, ``torch.sort(x).values``.  A CUDA input
    runs the radix sort or raises, as ``sort_i32_tuple`` does: the key
    biased by ``^ (1 << 63)`` is read as 8 bytes, whose histograms come in
    the rows of a (hi, lo) tuple (``i64_shift``), so ``radix_plan``
    skips every byte that is the same in every row (keys in [1, 10M] sort
    in 3 passes)."""
    global LAUNCHES_UPSWEEP
    _check_i64(x)
    if x.device.type == "cpu":
        return torch.sort(x).values
    device = _cuda_device([x])
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = load_radix_library()
    hist = torch.empty((2, 2 * DIGITS, RADIX), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.phj_radix_histograms_i64(n, x.data_ptr(), hist[0].data_ptr(),
                                           hist[1].data_ptr(), stream)
        if err != 0:
            raise RuntimeError(
                f"phj_radix_histograms_i64 failed: CUDA error {err}")
        LAUNCHES_UPSWEEP += 1

        def launch_pass(c, b, src, dst, digit_base, status):
            err = lib.phj_radix_pass_i64(n, i64_shift(c, b), src[0].data_ptr(),
                                         dst[0].data_ptr(), digit_base, status,
                                         stream)
            if err != 0:
                raise RuntimeError(f"phj_radix_pass_i64 failed: CUDA error {err}")

        _radix_sort(hist, RADIX_TILE_I64, n, [x], [out], launch_pass)
    return out


def sort_i32(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of an int32 tensor (any length); see
    ``sort_i32_tuple``."""
    return sort_i32_tuple(x)[0]


def sort_blocks_i32(x: torch.Tensor) -> torch.Tensor:
    """Phase A on one operand; see ``sort_blocks_tuple``."""
    return sort_blocks_tuple(x)[0]


def merge_pass_i32(x: torch.Tensor, run_len: int) -> torch.Tensor:
    """One merge pass on one operand; see ``merge_pass_tuple``."""
    return merge_pass_tuple(x, run_len=run_len)[0]
