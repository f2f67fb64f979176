"""The chained table's kernels: its build pass and its count probe.

Both are kernels of the port's own, with no TPU counterpart.

``chained_build`` writes the table from the stable sort of its bucket ids
(``sorted_bucket, order = torch.sort(bucket, stable=True)``):
``offsets[b]``, for b in [0, num_buckets], is the first sorted row whose id
is >= b (an id at or past ``num_buckets`` falls in no chain, as the JAX
package's histogram drops it); ``entry_rows`` is the sort's permutation as
int32, and ``max_chain`` the longest chain, a 0-dim int32 left on the
device.  The key gather ``keys[order]`` stays with the caller (the kernel's
note says why).  The JAX package (``partitionedhashjoin_tpu/ops/
hash_table.py``, ``build_chained_from_buckets``) computes the same with a
scatter-add of ones and a ``cumsum``.

``chained_count`` counts the probe rows ``i >= skip`` whose key is among
the entries ``entry_keys[offsets[b], offsets[b + 1])`` of their bucket
``b = hashes[i] & mask`` (the Get semantics of
``hash_table.probe_chained_count``), compared at int64 when the two key
widths differ; a bucket id past the table counts as an empty chain.  The
hashes are K7's of the probe keys with ``mask = num_buckets - 1``, or a
caller's own bucket ids with ``mask = 0xFFFFFFFF``.  The JAX package's
chained probe (``_probe_chained_count_chunk``) is ``jnp`` window gathers.

On a CUDA tensor each launches its kernel of ``csrc/chained_probe.cu``
(``chained_build_kernel``, ``chained_count_kernel``; see its note for the
designs); on a CPU tensor each runs its plain PyTorch version
(``chained_build_plain``, ``chained_count_plain``), which tests and
``chip_smoke.py`` hold the kernels against.  The port's chained build and
count probe (``ops/hash_table.py``) call them on every device.
"""

from __future__ import annotations

import ctypes

import torch

from partitionedhashjoin_tpu_torch.ops.kernels import _build

_MASK = 0xFFFFFFFF
_INT32_MAX = 2**31 - 1

#: Rows a thread of either kernel owns per step; equals kRows in
#: csrc/chained_probe.cu (checked when the library loads).  Tests use it to
#: place rows on a thread's edges.
ROWS_PER_THREAD = 4

#: Calls that launched each kernel since the last reset (set to 0 to reset).
LAUNCHES_CHAINED_COUNT = 0
LAUNCHES_CHAINED_BUILD = 0

_SIGNATURES = {
    "phj_chained_count_rows": ((), ctypes.c_int),
    "phj_chained_count": (
        (
            ctypes.c_void_p,  # keys
            ctypes.c_int,  # key bytes (4 or 8)
            ctypes.c_void_p,  # hashes (uint32)
            ctypes.c_uint32,  # mask
            ctypes.c_void_p,  # offsets (int32[num_buckets + 1])
            ctypes.c_int64,  # num_buckets
            ctypes.c_void_p,  # entry_keys
            ctypes.c_int,  # entry bytes (4 or 8)
            ctypes.c_int64,  # n
            ctypes.c_int64,  # skip
            ctypes.c_void_p,  # total (int64, zeroed)
            ctypes.c_void_p,  # cudaStream_t
        ),
        ctypes.c_int,
    ),
    "phj_chained_build": (
        (
            ctypes.c_void_p,  # sorted ids
            ctypes.c_int,  # id bytes (4 or 8)
            ctypes.c_void_p,  # order (int64)
            ctypes.c_int64,  # n
            ctypes.c_int64,  # num_buckets
            ctypes.c_void_p,  # offsets (int32[num_buckets + 1])
            ctypes.c_void_p,  # entry_rows (int32[n])
            ctypes.c_void_p,  # max_chain (int32, zeroed)
            ctypes.c_void_p,  # cudaStream_t
        ),
        ctypes.c_int,
    ),
}

_KEY_DTYPES = (torch.int32, torch.int64)
_HASH_DTYPES = (torch.int32, torch.uint32)


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = _build.load("chained_probe", _SIGNATURES)
    rows = lib.phj_chained_count_rows()
    if rows != ROWS_PER_THREAD:
        raise RuntimeError(
            f"chained_probe.cu takes {rows} rows a thread, the wrapper "
            f"expects {ROWS_PER_THREAD}"
        )
    return lib


def _check_columns(*columns) -> None:
    """Each ``(name, tensor, dtypes)`` is a contiguous 1-D tensor of one of
    ``dtypes``."""
    for name, t, dtypes in columns:
        if not isinstance(t, torch.Tensor) or t.dtype not in dtypes or t.dim() != 1:
            raise TypeError(
                f"{name} must be a 1-D tensor of "
                f"{' or '.join(str(d) for d in dtypes)}, got "
                f"{getattr(t, 'dtype', type(t))} of shape "
                f"{tuple(getattr(t, 'shape', ()))}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(keys, hashes, mask, offsets, entry_keys, skip) -> None:
    _check_columns(("keys", keys, _KEY_DTYPES), ("hashes", hashes, _HASH_DTYPES),
                   ("offsets", offsets, (torch.int32,)),
                   ("entry_keys", entry_keys, _KEY_DTYPES))
    if hashes.shape != keys.shape:
        raise ValueError(
            f"hashes {tuple(hashes.shape)} do not match keys {tuple(keys.shape)}"
        )
    if offsets.shape[0] < 1:
        raise ValueError("offsets must hold num_buckets + 1 >= 1 words")
    devices = {t.device for t in (keys, hashes, offsets, entry_keys)}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devices))}")
    if not 0 <= int(mask) <= _MASK:
        raise ValueError(f"mask must be in [0, 2^32), got {mask}")
    if int(skip) < 0:
        raise ValueError(f"skip must be >= 0, got {skip}")


def chained_count_plain(keys, hashes, mask, offsets, entry_keys,
                        skip=0) -> torch.Tensor:
    """The plain PyTorch version: every counted row's chain written out
    entry by entry (``repeat_interleave``), compared with the row's key at
    int64, and a row found where any of its entries matches.  Works on any
    device; its temporaries grow with the chain entries of all rows."""
    device = keys.device
    rows = torch.arange(min(int(skip), keys.shape[0]), keys.shape[0], device=device)
    bucket = (hashes.view(torch.int32)[rows].to(torch.int64) & _MASK) & int(mask)
    in_table = bucket < offsets.shape[0] - 1
    rows, bucket = rows[in_table], bucket[in_table]
    start = offsets[bucket].to(torch.int64)
    length = offsets[bucket + 1].to(torch.int64) - start
    owner = torch.repeat_interleave(torch.arange(rows.numel(), device=device), length)
    first = torch.cumsum(length, 0) - length
    pos = start[owner] + torch.arange(owner.numel(), device=device) - first[owner]
    hit = entry_keys[pos].to(torch.int64) == keys[rows[owner]].to(torch.int64)
    hits = torch.zeros((rows.numel(),), dtype=torch.int64, device=device)
    hits.index_add_(0, owner, hit.to(torch.int64))
    return (hits > 0).sum()


def chained_count(keys: torch.Tensor, hashes: torch.Tensor, mask: int,
                  offsets: torch.Tensor, entry_keys: torch.Tensor,
                  skip: int = 0) -> torch.Tensor:
    """Probe rows ``i >= skip`` found in their chain (see the module note),
    as a 0-dim int64 tensor on the inputs' device.  ``keys`` and
    ``entry_keys`` are int32 or int64, ``hashes`` int32 or uint32 (bit
    patterns), ``offsets`` int32[num_buckets + 1], all 1-D and contiguous.
    A CUDA input launches the kernel on the current stream, without a
    synchronisation, or raises; a CPU input runs the plain version."""
    global LAUNCHES_CHAINED_COUNT
    _check(keys, hashes, mask, offsets, entry_keys, skip)
    device = keys.device
    if device.type == "cpu":
        return chained_count_plain(keys, hashes, mask, offsets, entry_keys, skip)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    total = torch.zeros((), dtype=torch.int64, device=device)
    n = keys.shape[0]
    if n <= int(skip):
        return total
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.phj_chained_count(
            keys.data_ptr(), keys.element_size(), hashes.data_ptr(), int(mask),
            offsets.data_ptr(), offsets.shape[0] - 1, entry_keys.data_ptr(),
            entry_keys.element_size(), n, int(skip), total.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"chained_count kernel launch failed: CUDA error {err}")
    LAUNCHES_CHAINED_COUNT += 1
    return total


_ID_DTYPES = (torch.int32, torch.int64)


def _check_build(sorted_bucket, order, num_buckets) -> None:
    _check_columns(("sorted_bucket", sorted_bucket, _ID_DTYPES),
                   ("order", order, (torch.int64,)))
    if sorted_bucket.shape != order.shape:
        raise ValueError(
            f"sorted_bucket {tuple(sorted_bucket.shape)} does not match order "
            f"{tuple(order.shape)}"
        )
    if order.shape[0] > _INT32_MAX:
        raise ValueError(f"{order.shape[0]} rows do not fit int32 offsets")
    if not 1 <= int(num_buckets) < _INT32_MAX:
        raise ValueError(f"num_buckets must be in [1, 2^31 - 1), got {num_buckets}")
    if sorted_bucket.device != order.device:
        raise ValueError(
            f"inputs on different devices: {sorted_bucket.device}, {order.device}")


def chained_build_plain(sorted_bucket, order, num_buckets):
    """The plain PyTorch version: the offsets by ``searchsorted`` of every
    bucket id in [0, num_buckets] in the sorted ids, the longest chain from
    their differences.  Works on any device."""
    bounds = torch.arange(int(num_buckets) + 1, device=sorted_bucket.device)
    offsets = torch.searchsorted(sorted_bucket, bounds, out_int32=True)
    max_chain = (offsets[1:] - offsets[:-1]).max()
    return order.to(torch.int32), offsets, max_chain


def chained_build(sorted_bucket: torch.Tensor, order: torch.Tensor,
                  num_buckets: int):
    """``(entry_rows, offsets, max_chain)`` of the chained table (see the
    module note) from ``torch.sort(bucket, stable=True)``'s sorted ids
    (int32 or int64) and permutation (int64), both 1-D, contiguous and of
    one length.  A CUDA input launches the kernel on the current stream,
    without a synchronisation, or raises; a CPU input runs the plain
    version."""
    global LAUNCHES_CHAINED_BUILD
    _check_build(sorted_bucket, order, num_buckets)
    device = order.device
    if device.type == "cpu":
        return chained_build_plain(sorted_bucket, order, num_buckets)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n = order.shape[0]
    entry_rows = torch.empty((n,), dtype=torch.int32, device=device)
    offsets = torch.empty((int(num_buckets) + 1,), dtype=torch.int32, device=device)
    max_chain = torch.zeros((), dtype=torch.int32, device=device)
    if n == 0:
        return entry_rows, offsets.zero_(), max_chain
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.phj_chained_build(
            sorted_bucket.data_ptr(), sorted_bucket.element_size(), order.data_ptr(),
            n, int(num_buckets), offsets.data_ptr(), entry_rows.data_ptr(),
            max_chain.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"chained_build kernel launch failed: CUDA error {err}")
    LAUNCHES_CHAINED_BUILD += 1
    return entry_rows, offsets, max_chain
