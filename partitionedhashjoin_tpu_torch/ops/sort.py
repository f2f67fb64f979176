"""Sort operators: key sort and multi-pass LSD radix sort.

Counterpart of ``partitionedhashjoin_tpu/ops/sort.py``:

- ``sort_by_key`` / ``sort_table``: one stable ``torch.sort`` of the keys,
  the payloads reordered alongside.
- ``radix_sort`` / ``radix_sort_table``: LSD radix sort of int32 keys,
  ``32 / bits_per_pass`` stable passes over digits of the biased key
  (two's-complement order equals the unsigned order of ``key ^ 0x80000000``).
  Each pass is a stable sort of the digit, as in the JAX package.
"""

from __future__ import annotations

import torch

from partitionedhashjoin_tpu_torch.data.table import Table, make_table

_SIGN_FLIP = 0x80000000
_LOW32 = 0xFFFFFFFF


def sort_by_key(keys: torch.Tensor, *payloads: torch.Tensor):
    """Ascending stable sort of ``keys``, reordering ``payloads`` alongside."""
    keys_s, order = torch.sort(keys, stable=True)
    if not payloads:
        return keys_s
    return (keys_s,) + tuple(p[order] for p in payloads)


def sort_by_key_payload(keys: torch.Tensor, payloads: torch.Tensor):
    """``(order, keys_s, payloads_s)``: the rows in (key, payload)
    lexicographic order — the port's counterpart of the JAX package's
    2-key ``lax.sort``, which ``torch.sort`` lacks — and the permutation
    that produces it.  int32 columns pack into one int64 sort key (key in
    the high word, payload biased to unsigned in the low word, so signed
    order holds in both) and decode with no gather; other dtypes take two
    stable sorts, payload first."""
    if keys.dtype == torch.int32 and payloads.dtype == torch.int32:
        packed = keys.to(torch.int64) * 2**32 + (payloads.to(torch.int64) + 2**31)
        packed, order = torch.sort(packed)
        low = (packed & _LOW32) - 2**31
        return order, (packed >> 32).to(torch.int32), low.to(torch.int32)
    order = torch.sort(payloads, stable=True).indices
    order = order[torch.sort(keys[order], stable=True).indices]
    return order, keys[order], payloads[order]


def sort_table(table: Table) -> Table:
    """Sort a relation by key (ascending, stable)."""
    keys, payloads = sort_by_key(table.keys, table.payloads)
    return make_table(keys, payloads)


def radix_sort(keys: torch.Tensor, *payloads: torch.Tensor, bits_per_pass: int = 8):
    """LSD radix sort of int32 keys; returns ``(sorted_keys, *payloads)``.

    After pass p, rows are stably ordered by the low ``p * bits_per_pass``
    bits of the biased key.
    """
    if 32 % bits_per_pass:
        raise ValueError(f"bits_per_pass must divide 32, got {bits_per_pass}")
    mask = (1 << bits_per_pass) - 1
    # the key's low 32 bits as unsigned, biased: JAX's astype(uint32) ^ MSB
    biased = (keys.to(torch.int64) & _LOW32) ^ _SIGN_FLIP
    carried = (biased,) + payloads
    for p in range(32 // bits_per_pass):
        digit = (carried[0] >> (p * bits_per_pass)) & mask
        order = torch.sort(digit, stable=True).indices
        carried = tuple(c[order] for c in carried)
    unbiased = carried[0] ^ _SIGN_FLIP
    sorted_keys = torch.where(unbiased > 2**31 - 1, unbiased - 2**32, unbiased)
    return (sorted_keys.to(torch.int32),) + carried[1:]


def radix_sort_table(table: Table, bits_per_pass: int = 8) -> Table:
    """Radix-sort a relation by key."""
    keys, payloads = radix_sort(
        table.keys, table.payloads, bits_per_pass=bits_per_pass
    )
    return make_table(keys, payloads)
