"""Composite-key (multi-column) join counts.

Counterpart of ``partitionedhashjoin_tpu/ops/multi_key.py``.  The reference
joins on a single int64 ``Tuple::id`` (src/Common/Table.hpp:20-25); real
query engines join on composite keys (ON a.k1 = b.k1 AND a.k2 = b.k2 ...).
This module generalizes the count joins to k int32 key columns:

* ``k == 1`` is ``merge_join.two_run_count`` (K1).
* ``k == 2`` rides the int64 path, K3: each (c1, c2) maps one-to-one to the
  int64 ``(c1 << 32) | (uint32(c2) ^ 0x80000000)``, whose order is the
  lexicographic order of the pair, and ``merge_join.two_run_count_i64``
  counts it (its sorts are K6's, on the native int64 key).  The JAX
  package feeds the two
  columns to its plane kernel as the (hi, lo) planes; the map is the same
  pairing, spelled as one int64.
* ``k >= 3`` takes the generalized sort-merge path: the concatenated
  relations, build rows first, sorted lexicographically by k stable
  ``torch.sort`` passes (least significant column first; stability keeps
  build rows before equal-tuple probe rows, the JAX sort's tag operand),
  then the build multiplicity of each run, a run being delimited by "any
  column differs from the previous row".  Its passes are library sorts, as
  in the JAX package.

Exactness: no column combination is hashed, and the k = 2 packing is a
bijection, so nothing can collide.  64-bit columns are refused with a
TypeError (never silently truncated) — split them into (hi, lo) int32
planes and pass both planes as columns.  Floating-point columns are refused
too; the JAX package casts them.

Counts are 0-dim int64 tensors on the columns' device; ``multi_key_count_all``
is one too, where the JAX package returns an exact uint32[2] (hi, lo) pair.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from partitionedhashjoin_tpu_torch.ops import merge_join

_I32_MIN = -(2**31)
_WIDE = (torch.int64, torch.uint64)


def _check_columns(name: str, cols: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Validate one side's key columns; returns them as int32 tensors."""
    cols = tuple(torch.as_tensor(c) for c in cols)
    if not cols:
        raise ValueError(f"{name}: at least one key column is required")
    n = cols[0].shape[0] if cols[0].ndim else None
    out = []
    for i, c in enumerate(cols):
        if c.dtype in _WIDE:
            # never silently truncate 64-bit columns (distinct keys would
            # collide) — same contract as merge_join.two_run_count
            raise TypeError(
                f"{name}[{i}] is {c.dtype}: 64-bit columns are refused; "
                "split them into (hi, lo) int32 planes and pass both planes"
            )
        if c.dtype.is_floating_point or c.dtype.is_complex:
            raise TypeError(f"{name}[{i}] is {c.dtype}; key columns are integers")
        if c.ndim != 1 or c.shape[0] != n:
            raise ValueError(
                f"{name}[{i}] shape {tuple(c.shape)} != expected ({n},)"
            )
        out.append(c.to(torch.int32))
    return tuple(out)


def _check_sides(build_cols, probe_cols):
    build_cols = _check_columns("build_cols", build_cols)
    probe_cols = _check_columns("probe_cols", probe_cols)
    if len(build_cols) != len(probe_cols):
        raise ValueError(
            f"column-count mismatch: build has {len(build_cols)}, "
            f"probe has {len(probe_cols)}"
        )
    return build_cols, probe_cols


def pack_pair(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """The int64 ``(c1 << 32) | (uint32(c2) ^ 0x80000000)``: one-to-one on
    int32 pairs, and ascending in the pair's lexicographic order."""
    lo = (c2 ^ _I32_MIN).to(torch.int64) & 0xFFFFFFFF
    return (c1.to(torch.int64) << 32) | lo


def _merged_multiplicity_multi(build_cols, probe_cols):
    """Generalized ``sort_merge._merged_multiplicity`` over k columns:
    returns (is_probe_row, mult) in lexicographically sorted order, where
    mult = number of build rows sharing this row's full key tuple."""
    n_a = build_cols[0].shape[0]
    merged = [torch.cat([a, b]) for a, b in zip(build_cols, probe_cols)]
    del build_cols, probe_cols
    # LSD passes: after sorting stably by column j, rows are in order of
    # (c_j, ..., c_{k-1}, concatenation index); the concatenation puts every
    # build row before every probe row
    order = None
    for col in reversed(merged):
        keys = col if order is None else col[order]
        _, idx = torch.sort(keys, stable=True)
        del keys
        order = idx if order is None else order[idx]
        del idx
    is_build_s = order < n_a
    new_run = torch.zeros_like(is_build_s)
    new_run[0] = True
    for col in merged:
        col_s = col[order]
        new_run[1:] |= col_s[1:] != col_s[:-1]
        del col_s
    del merged, order
    counted = is_build_s.to(torch.int64)
    build_prefix = torch.cumsum(counted, dim=0)
    # the exclusive build prefix at each run's start, spread over its run by
    # the run's index (a prefix count of run starts).  The JAX function
    # carries it with a cummax; torch.cummax of one long row runs in one
    # thread block on CUDA (chip_smoke.py's multi-key phase times both)
    at_start = (build_prefix - counted)[torch.nonzero(new_run).squeeze(1)]
    del counted
    run_index = torch.cumsum(new_run, dim=0).sub_(1)
    del new_run
    return ~is_build_s, build_prefix - at_start[run_index]


def multi_key_count(
    build_cols: Sequence[torch.Tensor],
    probe_cols: Sequence[torch.Tensor],
) -> torch.Tensor:
    """Get-semantics composite-key count: number of probe rows whose FULL
    key tuple (column-wise equality over all k columns) appears among the
    build rows, as a 0-dim int64 tensor.  ``k == 1`` is
    ``merge_join.two_run_count``; ``k == 2`` is K3 on the packed pair; other
    k take the generalized lexicographic sort-merge path."""
    build_cols, probe_cols = _check_sides(build_cols, probe_cols)
    device = build_cols[0].device
    if build_cols[0].shape[0] == 0 or probe_cols[0].shape[0] == 0:
        return torch.zeros((), dtype=torch.int64, device=device)
    k = len(build_cols)
    if k == 1:
        return merge_join.two_run_count(build_cols[0], probe_cols[0])
    if k == 2:
        return merge_join.two_run_count_i64(
            pack_pair(*build_cols), pack_pair(*probe_cols)
        )
    is_probe, mult = _merged_multiplicity_multi(build_cols, probe_cols)
    return (is_probe & (mult > 0)).sum()


def multi_key_count_all(
    build_cols: Sequence[torch.Tensor],
    probe_cols: Sequence[torch.Tensor],
) -> torch.Tensor:
    """Full inner-join cardinality on a composite key (duplicates multiply,
    GetAll semantics), as a 0-dim int64 tensor."""
    build_cols, probe_cols = _check_sides(build_cols, probe_cols)
    device = build_cols[0].device
    if build_cols[0].shape[0] == 0 or probe_cols[0].shape[0] == 0:
        return torch.zeros((), dtype=torch.int64, device=device)
    is_probe, mult = _merged_multiplicity_multi(build_cols, probe_cols)
    return torch.where(is_probe, mult, 0).sum()
