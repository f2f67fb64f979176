"""ORDER BY / LIMIT operators over Tables.

Counterpart of ``partitionedhashjoin_tpu/ops/order_by.py``.  Descending
order sorts the bitwise NOT of the column ascending (``~x`` reverses the
order of two's-complement integers over the whole domain, INT_MIN included,
where ``-x`` would overflow).

Ties: ``order_by`` keeps equal sort values in ascending row position, and
``top_k`` takes the lowest row index first, as ``lax.top_k`` does.  Both
come from a stable ``torch.sort`` (``torch.topk`` promises no tie order).
"""

from __future__ import annotations

import torch

from partitionedhashjoin_tpu_torch.data.table import Table, make_table


def _order_key(col: torch.Tensor, descending: bool) -> torch.Tensor:
    if col.dtype.is_floating_point or col.dtype.is_complex or col.dtype == torch.bool:
        raise TypeError(f"order_by supports integer columns, got {col.dtype}")
    return ~col if descending else col


def _columns(table: Table, by: str):
    if by not in ("key", "payload"):
        raise ValueError(f"by must be 'key' or 'payload', got {by!r}")
    if by == "key":
        return table.keys, table.payloads
    return table.payloads, table.keys


def _table(by: str, col: torch.Tensor, other: torch.Tensor) -> Table:
    return make_table(col, other) if by == "key" else make_table(other, col)


def order_by(table: Table, by: str = "key", descending: bool = False) -> Table:
    """Return ``table`` sorted by ``by`` ("key" or "payload"), equal values
    in ascending row position."""
    col, other = _columns(table, by)
    order = torch.sort(_order_key(col, descending), stable=True).indices
    return _table(by, col[order], other[order])


def top_k(table: Table, k: int, by: str = "key", descending: bool = True) -> Table:
    """ORDER BY ... LIMIT k: a k-row Table of the largest (``descending``,
    the default) or smallest rows by the chosen column, in sorted order,
    ties by lowest row index.  ``k`` must not exceed the table size."""
    col, other = _columns(table, by)
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    if k > table.size:
        raise ValueError(f"k={k} exceeds table size {table.size}")
    # the k largest of x = _order_key(col, not descending), as lax.top_k
    x = _order_key(col, not descending)
    order = torch.sort(x, descending=True, stable=True).indices[:k]
    return _table(by, col[order], other[order])


def _top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Row indices of the ``k`` largest values of ``x``, largest first and,
    among equal values, the lower row first (``lax.top_k``'s order, which
    ``torch.topk`` does not promise).  ``torch.topk`` finds the k-th value;
    every row above it and the first rows at it (``nonzero`` keeps row
    order) make exactly k rows, which one stable k-row sort orders."""
    if k <= 0:
        return torch.zeros((0,), dtype=torch.int64, device=x.device)
    kth = torch.topk(x, k, sorted=True).values[k - 1]
    above = x > kth
    at = x == kth
    take = above | (at & (torch.cumsum(at, 0) <= k - above.sum()))
    idx = torch.nonzero(take).squeeze(1)
    return idx[torch.sort(x[idx], descending=True, stable=True).indices]


def _valid_first_order(invalid: torch.Tensor, ordcol: torch.Tensor) -> torch.Tensor:
    """The permutation that puts valid rows first, each part ascending by
    ``ordcol``, equal values in row order: the order of the JAX package's
    3-key sort on (invalid, ordcol, row), as two stable sorts."""
    order = torch.sort(ordcol, stable=True).indices
    flag = invalid.to(torch.int8)[order]
    return order[torch.sort(flag, stable=True).indices]
