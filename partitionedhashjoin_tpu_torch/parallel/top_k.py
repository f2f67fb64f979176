"""Distributed ORDER BY ... LIMIT k over a mesh of shards.

Counterpart of ``partitionedhashjoin_tpu/parallel/top_k.py``.  Every row of
the global top-k is in its own shard's local top-k, so the exact plan is: a
top-k per shard (no relation reorder), ``all_gather`` of the S·k candidates,
and one final top-k over them.

Ties follow ``ops/order_by.top_k``: equal values in ascending row position,
as ``lax.top_k`` takes them.  Each shard selects with ``_top_k_indices``
(``torch.topk`` finds the k-th value, the rows at it are taken in row
order), and the candidates are gathered in shard order, so the final
selection's ties fall in global row order too.  The masked variant orders
by (invalid, value, row) with ``_valid_first_order`` (two stable sorts), so
an invalid row can never displace a tied valid one.

On a mesh over several processes every process passes its own rows
(``host_slice``'s layout, the same count in every process) and its mask per
local row; the candidates are gathered from every process in global shard
order, the valid rows counted by ``psum``, so every process returns the
global top k.
"""

from __future__ import annotations

import torch

from partitionedhashjoin_tpu_torch.data.table import Table, make_table
from partitionedhashjoin_tpu_torch.ops.order_by import (
    _order_key,
    _top_k_indices,
    _valid_first_order,
)
from partitionedhashjoin_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    local_rows,
    psum,
)


def _shard_columns(mesh: Mesh, keys, pays, valid, by: str):
    """(ordered column, carried column, valid), each ``(local_size, rows)``."""
    col, other = (keys, pays) if by == "key" else (pays, keys)
    return tuple(x.reshape(mesh.local_size, -1) for x in (col, other, valid))


def _dist_top_k(mesh: Mesh, keys, pays, valid, k: int, by: str, descending: bool):
    """``(col, other, valid)`` of the k best rows: each shard's top k of
    the ranked column (invalid rows, the host padding, rank at the dtype's
    least value, so they lose every tie to a real row at the end of the
    last shard), gathered, and the top k of the S·k candidates."""
    col, other, valid = _shard_columns(mesh, keys, pays, valid, by)
    least = torch.iinfo(col.dtype).min
    cand = []
    for i in range(mesh.local_size):
        ranked = torch.where(valid[i], _order_key(col[i], not descending), least)
        idx = _top_k_indices(ranked, k)
        cand.append((ranked[idx], other[i][idx], valid[i][idx]))
    gvals, gother, gvalid = (all_gather(torch.stack(c), mesh) for c in zip(*cand))
    gvals = torch.where(gvalid, gvals, least)
    fidx = _top_k_indices(gvals, k)
    fvals = gvals[fidx]
    col_out = ~fvals if not descending else fvals
    return col_out, gother[fidx], gvalid[fidx]


def _dist_top_k_masked(mesh: Mesh, keys, pays, valid, k: int, by: str,
                       descending: bool):
    """Masked variant: each shard orders its rows by (invalid, value, row),
    best first, and sends its first k; the S·k candidates, gathered in
    shard order, are ordered the same way (the gathered position stands
    for (shard, row)).  Returns ``(col, other, live, n_valid)``, where
    ``n_valid`` is the global valid-row count."""
    col, other, valid = _shard_columns(mesh, keys, pays, valid, by)
    cand = []
    for i in range(mesh.local_size):
        nrank = ~_order_key(col[i], not descending)  # ascending = best first
        invalid = ~valid[i]
        order = _valid_first_order(invalid, nrank)[:k]
        cand.append((invalid[order], nrank[order], other[i][order]))
    ginv, gnrank, gother = (all_gather(torch.stack(c), mesh) for c in zip(*cand))
    forder = _valid_first_order(ginv, gnrank)[:k]
    ranked_out = ~gnrank[forder]
    col_out = ~ranked_out if not descending else ranked_out
    return col_out, gother[forder], ~ginv[forder], psum(valid.sum()[None], mesh)


def distributed_top_k(
    mesh: Mesh,
    table: Table,
    k: int,
    by: str = "key",
    descending: bool = True,
    mask=None,
):
    """Exact global ORDER BY ... LIMIT k of a (possibly row-sharded) table,
    placed on the mesh's device.

    Matches ``ops.order_by.top_k`` on the unsharded data (same value order,
    ties by row; the carried column follows its row).  ``k`` must not
    exceed the per-shard row count (each shard must be able to hold k local
    candidates).

    Returns ``(table, n_live)`` where ``n_live`` (0-dim int64) is the live
    prefix of the k-row table (rows past it are zeroed).  Without a mask,
    ``n_live == k``; with one (a pushed-down FILTER, the query layer's R2
    and R6) ``n_live = min(k, #valid rows)``, and an invalid row is never
    selected.  On a mesh over several processes ``table`` and ``mask`` are
    this process's rows, the result the global one (module docstring).
    """
    if by not in ("key", "payload"):
        raise ValueError(f"by must be 'key' or 'payload', got {by!r}")
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    n, valid, (keys, pays) = local_rows(mesh, [table.keys, table.payloads], mask)
    if k > n:
        raise ValueError(f"k={k} exceeds table size {n}")
    per_shard = valid.shape[0] // mesh.local_size
    if k > per_shard:
        raise ValueError(
            f"k={k} exceeds the per-shard row count {per_shard}; "
            "use order_by on gathered data for relation-sized limits"
        )
    if mask is not None:
        col, other, live, n_valid = _dist_top_k_masked(
            mesh, keys, pays, valid, k, by, descending)
        n_live = torch.clamp(n_valid, max=k)
        col = torch.where(live, col, 0).to(col.dtype)
        other = torch.where(live, other, 0).to(other.dtype)
    else:
        col, other, _ = _dist_top_k(mesh, keys, pays, valid, k, by, descending)
        n_live = torch.tensor(k, dtype=torch.int64, device=mesh.device)
    out = make_table(col, other) if by == "key" else make_table(other, col)
    return out, n_live
