"""Chained-table count probe: one thread per probe row walks its chain.

A kernel of the port's own, with no TPU counterpart: the JAX package's
chained probe (``partitionedhashjoin_tpu/ops/hash_table.py``,
``_probe_chained_count_chunk``) is ``jnp`` window gathers; the port's
count probe (``ops/hash_table.py``) calls ``chained_count`` on every
device.  ``chained_count`` counts the
probe rows ``i >= skip`` whose key is among the entries
``entry_keys[offsets[b], offsets[b + 1])`` of their bucket
``b = hashes[i] & mask`` (the Get semantics of
``hash_table.probe_chained_count``), compared at int64 when the two key
widths differ; a bucket id past the table counts as an empty chain.  The
hashes are K7's of the probe keys with ``mask = num_buckets - 1``, or a
caller's own bucket ids with ``mask = 0xFFFFFFFF``.

On a CUDA tensor it launches ``chained_count_kernel`` of
``csrc/chained_probe.cu`` (see its note for the design); on a CPU tensor it
runs ``chained_count_plain``, a plain PyTorch version that expands every
row's chain, which tests and ``chip_smoke.py`` hold the kernel against.
"""

from __future__ import annotations

import ctypes

import torch

from partitionedhashjoin_tpu_torch.ops.kernels import _build

_MASK = 0xFFFFFFFF

#: Rows a thread of the kernel owns per step; equals kRows in
#: csrc/chained_probe.cu (checked when the library loads).  Tests use it to
#: place probe rows on a thread's edges.
ROWS_PER_THREAD = 4

#: Calls that launched the kernel since the last reset (set to 0 to reset).
LAUNCHES_CHAINED_COUNT = 0

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
}

_KEY_DTYPES = (torch.int32, torch.int64)
_HASH_DTYPES = (torch.int32, torch.uint32)


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = _build.load("chained_probe", _SIGNATURES)
    rows = lib.phj_chained_count_rows()
    if rows != ROWS_PER_THREAD:
        raise RuntimeError(
            f"chained_probe.cu walks {rows} rows a thread, the wrapper "
            f"expects {ROWS_PER_THREAD}"
        )
    return lib


def _check(keys, hashes, mask, offsets, entry_keys, skip) -> None:
    for name, t, dtypes in (("keys", keys, _KEY_DTYPES),
                            ("hashes", hashes, _HASH_DTYPES),
                            ("offsets", offsets, (torch.int32,)),
                            ("entry_keys", entry_keys, _KEY_DTYPES)):
        if not isinstance(t, torch.Tensor) or t.dtype not in dtypes or t.dim() != 1:
            raise TypeError(
                f"{name} must be a 1-D tensor of "
                f"{' or '.join(str(d) for d in dtypes)}, got "
                f"{getattr(t, 'dtype', type(t))} of shape "
                f"{tuple(getattr(t, 'shape', ()))}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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
