"""Filter + compaction operator.

Counterpart of ``partitionedhashjoin_tpu/ops/filter.py``.  Selection is a
mask, an exclusive prefix sum and a scatter: the output position of a kept
row is the number of kept rows before it.  Plain PyTorch (the JAX module
uses XLA ops, no Pallas kernel); ``compact`` is the plain version of the
stream-compaction kernel, ``ops/kernels/compact.compact_plain``.  Outputs
keep the input's size; ``count`` (a 0-dim int64 tensor; JAX's is int32)
gives the number of kept rows.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from partitionedhashjoin_tpu_torch.data.table import Table, make_table
from partitionedhashjoin_tpu_torch.ops.kernels.compact import compact_plain


def partition_positions(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(count, dest)``: the stable partition of ``mask`` as a permutation.
    Kept rows go to ``[0, count)`` and rejected rows to ``[count, n)``, each
    in original order; ``dest[i]`` is row i's output position (int64)."""
    keep = mask.to(torch.bool)
    kept = keep.to(torch.int64)
    kept_through = torch.cumsum(kept, 0)
    count = kept_through[-1] if keep.shape[0] else kept.sum()
    rank = torch.arange(keep.shape[0], dtype=torch.int64, device=keep.device)
    # a rejected row i has i - kept_through[i] rejected rows before it
    dest = torch.where(keep, kept_through - 1, count + rank - kept_through)
    return count, dest


def compact_sort(mask: torch.Tensor, *columns: torch.Tensor):
    """Stable partition: selected rows first.

    Returns ``(count, *partitioned_columns)``.  Rows past ``count`` are the
    REJECTED rows in original order, not zeros.
    """
    count, dest = partition_positions(mask)
    return (count,) + tuple(torch.empty_like(c).scatter_(0, dest, c) for c in columns)


def compact(mask: torch.Tensor, *columns: torch.Tensor):
    """Selected rows moved to the front of same-size outputs, in order.

    Returns ``(count, *compacted_columns)``; rows past ``count`` are zeros.
    """
    count, _, *outs = compact_plain(mask.to(torch.bool), columns, mask.shape[0])
    return (count, *outs)


def filter_table(
    table: Table,
    predicate: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    zero_tail: bool = True,
) -> Tuple[Table, torch.Tensor]:
    """Select rows where ``predicate(keys, payloads)`` holds.

    Returns ``(compacted_table, count)``; the table keeps the input's size
    with the selected rows in ``[0, count)`` (original order).  Rows past
    ``count`` are zeros by default (``compact``); with ``zero_tail=False``
    they are the rejected rows in original order (``compact_sort``).
    """
    mask = predicate(table.keys, table.payloads)
    op = compact if zero_tail else compact_sort
    count, keys, payloads = op(mask, table.keys, table.payloads)
    return make_table(keys, payloads), count
