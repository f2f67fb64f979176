"""Plain PyTorch reference of the GROUP BY key with COUNT, SUM, MIN and MAX,
and the summary of a GROUP BY's answer that the benchmark compares.

Semantics (the engine's ``hash_aggregate``): one group per distinct key;
COUNT is an int32 column that wraps modulo 2^32; SUM, MIN and MAX keep the
payloads' int64 (SUM wraps modulo 2^64).  Group order is not part of the
answer.

The reference reads the rows in blocks: each block is put in (key, payload)
order by two stable sorts, its runs of equal keys give one partial group
each (COUNT from the run's bounds, SUM from a cumulative sum, MIN and MAX
from the run's first and last payload), and the partial groups of every
block are combined by the same steps.  Nothing here scatters.

A GROUP BY over 200M rows has ~8M groups, more than an answer the harness
keeps for every operation of a window, so an answer is a summary
(``answer``): the number of groups, an order-independent 64-bit digest of
every group, and the ``TOP_K`` heaviest groups in full.
"""

from __future__ import annotations

import torch

#: Rows per block.
BLOCK = 1 << 25
#: Groups of an answer kept in full.
TOP_K = 10
COLUMNS = ("key", "count", "sum", "min", "max")

_I64 = torch.int64


def _signed(x: int) -> int:
    return x - (1 << 64) if x >= 1 << 63 else x


#: splitmix64's constants, as int64 values.
_GOLDEN = _signed(0x9E3779B97F4A7C15)
_M1 = _signed(0xBF58476D1CE4E5B9)
_M2 = _signed(0x94D049BB133111EB)


def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    """A logical right shift of int64 bit patterns."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer, in wrapping int64 arithmetic."""
    z = (z ^ _srl(z, 30)) * _M1
    z = (z ^ _srl(z, 27)) * _M2
    return z ^ _srl(z, 31)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values as an int32 column holds them: modulo 2^32, signed."""
    return torch.remainder(x + (1 << 31), 1 << 32) - (1 << 31)


def _runs(sorted_keys: torch.Tensor):
    """``(first, last)`` row of each run of equal keys (rows > 0)."""
    n = sorted_keys.numel()
    new = torch.ones(n, dtype=torch.bool, device=sorted_keys.device)
    new[1:] = sorted_keys[1:] != sorted_keys[:-1]
    first = torch.nonzero(new).squeeze(1)
    last = torch.empty_like(first)
    last[:-1] = first[1:] - 1
    last[-1] = n - 1
    return first, last


def _lex_order(keys: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Rows in (key, value) order: two stable sorts."""
    order = torch.sort(values, stable=True).indices
    return order[torch.sort(keys[order], stable=True).indices]


def _run_sum(values: torch.Tensor, first, last) -> torch.Tensor:
    cs = torch.cumsum(values, 0)
    return cs[last] - cs[first] + values[first]


def _combine(keys, count, sum_, mn, mx):
    """One row per distinct key of rows that each hold a partial group:
    ``(key, count, sum, min, max)``."""
    order = _lex_order(keys, mn)
    k = keys[order]
    first, last = _runs(k)
    mins = mn[order][first]
    counts = _run_sum(count[order], first, last)
    sums = _run_sum(sum_[order], first, last)
    # the runs of the (key, max) order lie where those of (key, min) do
    maxs = (mn[order][last] if mx is mn
            else mx[_lex_order(keys, mx)][last])
    return k[first], counts, sums, mins, maxs


def group_by(keys: torch.Tensor, payloads: torch.Tensor,
             sum_dtype: torch.dtype = _I64):
    """``(key, count, sum, min, max)`` of every group, in key order, each an
    int64 column.  ``sum_dtype=torch.float32`` is the control: SUM
    accumulated in float32, then rounded to int64."""
    n = keys.numel()
    if n == 0:
        empty = keys.new_zeros(0, dtype=_I64)
        return (empty,) * 5
    parts = []
    for lo in range(0, n, BLOCK):
        k, p = keys[lo:lo + BLOCK].to(_I64), payloads[lo:lo + BLOCK].to(_I64)
        parts.append(_combine(k, torch.ones_like(k), p.to(sum_dtype), p, p))
    key, count, sum_, mn, mx = (torch.cat(c) for c in zip(*parts))
    del parts
    key, count, sum_, mn, mx = _combine(key, count, sum_, mn, mx)
    if sum_dtype.is_floating_point:
        sum_ = sum_.double().round().to(_I64)
    return key, _wrap_i32(count), sum_, mn, mx


def digest(key, count, sum_, mn, mx) -> int:
    """The wrapping int64 sum over the groups of a splitmix64 mix of each
    group's five fields: the same for any order of the groups."""
    h = torch.zeros(key.shape, dtype=_I64, device=key.device)
    for col in (key, count, sum_, mn, mx):
        h = _mix((h + _GOLDEN) ^ col.to(_I64))
    return int(h.sum())


def top(key, count, sum_, mn, mx, k: int = TOP_K) -> dict:
    """The ``k`` groups of the largest COUNT, ties to the lower key, as
    lists of Python ints by column."""
    c = count.to(_I64)
    rows = torch.arange(c.numel(), device=c.device)
    if c.numel() > k:
        rows = torch.nonzero(c >= torch.topk(c, k).values[-1]).squeeze(1)
    rows = rows[torch.sort(key[rows], stable=True).indices]
    rows = rows[torch.sort(-c[rows], stable=True).indices][:k]
    return {name: col[rows].tolist()
            for name, col in zip(COLUMNS, (key, count, sum_, mn, mx))}


def answer(key, count, sum_, mn, mx) -> dict:
    """The summary of one GROUP BY's groups that the benchmark compares."""
    cols = (key, count, sum_, mn, mx)
    return {"num_groups": int(key.numel()), "digest": digest(*cols),
            "top": top(*cols)}


def groupby_answer(keys: torch.Tensor, payloads: torch.Tensor,
                   sum_dtype: torch.dtype = _I64) -> dict:
    """The reference's answer; with ``sum_dtype=torch.float32`` the
    control's."""
    return answer(*group_by(keys, payloads, sum_dtype))
