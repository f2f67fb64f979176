"""Two-run merge-count join: sort each relation once, then count with the
merge-probe kernel.

Counterpart of ``partitionedhashjoin_tpu/ops/merge_join.py``:

    order:  one 1-key sort per relation, ``key_sort``: K6, the radix sort
            (``ops/kernels/bitonic_sort.py``), for int32 and int64 keys, the
            library ``torch.sort`` for other dtypes
    probe:  ``ops/kernels/merge_probe.py`` — K1 for int32 keys, K3 for
            int64 keys

Each kernel module launches its CUDA kernel on a CUDA tensor and runs its
plain PyTorch version on a CPU tensor, so the card and the CPU sort the same
way and give the same answers.  K6 reaches three call sites: ``key_sort``
(so ``two_run_count``, ``two_run_count_i64``, ``PreparedBuild`` of either
width and, through them, the no-partitioning, sort-merge and radix
joiners), ``two_run_materialize``'s two (key, payload) sorts and GROUP BY
pass 1 (``ops/aggregate.py``).  K6 sorts an int64 key natively, 8-bit digits
of the biased key, skipping every digit that is the same in every row.  The
JAX package's sorter is a switch whose default is its library sort; the
port has no switch.

Validity masks are supported exactly, by the JAX package's protocol:
invalid rows are rewritten to INT32_MAX before the sort, the probe searches
only below the build side's first INT32_MAX key (``exclude_int32_max``), and
genuine INT32_MAX matches are added back in closed form — sentinel-free over
the full int32 domain.

int64 keys take ``two_run_count_i64`` and an int64 ``PreparedBuild``; they
have no validity masks, as in the JAX package.  ``two_run_count`` never
truncates them: it raises ``TypeError``.

Counts are 0-dim int64 tensors on the keys' device (the JAX package's are
int32; the counts agree as Python ints).

``two_run_materialize`` is the materializing join on the same scheme: two
value-carrying sorts, then the merge-probe payload kernel K4
(``ops/kernels/merge_payload.py``) for each sorted probe row's first
matching build row, and the stream-compaction kernel K5
(``ops/kernels/compact.py``) when some probe rows miss.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from partitionedhashjoin_tpu_torch.ops.kernels import bitonic_sort
from partitionedhashjoin_tpu_torch.ops.kernels import compact as kcompact
from partitionedhashjoin_tpu_torch.ops.kernels import merge_payload, merge_probe

_I32_MAX = merge_probe.INT32_MAX
_WIDE = (torch.int64, torch.uint64)

#: The JAX package's name for the sorter that K6 ports; the benches' JSON
#: lines carry it as their ``sort_impl``, the JAX benches' key.
SORT_IMPL = "pallas"


def _as_i32(name: str, keys: torch.Tensor) -> torch.Tensor:
    if keys.dtype in _WIDE:
        # never silently truncate 64-bit keys (distinct keys would collide)
        raise TypeError(
            f"two_run_count is the int32 path ({name} is {keys.dtype}); "
            "use two_run_count_i64 for 64-bit keys"
        )
    return keys.to(torch.int32)


def _as_i64(name: str, keys: torch.Tensor) -> torch.Tensor:
    if keys.dtype == torch.uint64:
        # uint64 keys past INT64_MAX have no int64 value
        raise TypeError(f"{name} is uint64; int64 keys are supported")
    return keys.to(torch.int64)


def key_sort(keys: torch.Tensor) -> torch.Tensor:
    """Ascending 1-key sort: int32 keys through K6's ``sort_i32``, int64
    keys through its ``sort_i64``, other dtypes through the library sort."""
    if keys.dtype == torch.int32:
        return bitonic_sort.sort_i32(keys.contiguous())
    if keys.dtype == torch.int64:
        return bitonic_sort.sort_i64(keys.contiguous())
    return torch.sort(keys, stable=False).values


def two_run_count(
    build_keys: torch.Tensor,
    probe_keys: torch.Tensor,
    build_valid: Optional[torch.Tensor] = None,
    probe_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Get-semantics match count: number of valid probe rows whose key
    appears among the valid build keys (int32 keys)."""
    build_keys = _as_i32("build_keys", build_keys)
    probe_keys = _as_i32("probe_keys", probe_keys)
    return _two_run_count(build_keys, probe_keys, build_valid, probe_valid)


def _two_run_count(build_keys, probe_keys, build_valid=None, probe_valid=None):
    """Composed as _prepare_build_i32 + _probe_prepared_i32 so the INT32_MAX
    validity protocol lives in one place (PreparedBuild probes through the
    same two functions)."""
    if build_keys.shape[0] == 0 or probe_keys.shape[0] == 0:
        return torch.zeros((), dtype=torch.int64, device=build_keys.device)
    a_sorted, max_in_a = _prepare_build_i32(build_keys, build_valid)
    return _probe_prepared_i32(a_sorted, max_in_a, probe_keys, probe_valid)


def two_run_count_i64(
    build_keys: torch.Tensor, probe_keys: torch.Tensor
) -> torch.Tensor:
    """Get-semantics match count for int64 keys (the reference's Tuple::id
    width, src/Common/Table.hpp:20-25): one unstable sort per relation
    (``key_sort``: K6's native int64 key), then K3 over
    the full int64 domain.  No validity masks."""
    build_keys = _as_i64("build_keys", build_keys)
    probe_keys = _as_i64("probe_keys", probe_keys)
    if build_keys.shape[0] == 0 or probe_keys.shape[0] == 0:
        return torch.zeros((), dtype=torch.int64, device=build_keys.device)
    return merge_probe.ranged_merge_count_i64(key_sort(build_keys),
                                              key_sort(probe_keys))


def sorted_runs_count(a_sorted: torch.Tensor, b_sorted: torch.Tensor) -> torch.Tensor:
    """Count over already-sorted runs, full int32 domain (the pre-sorted
    merge primitive: sort a build side once, count each sorted probe chunk
    against it without sorting again)."""
    return merge_probe.ranged_merge_count_prepared(a_sorted, b_sorted)


def _prepare_build_i32(
    build_keys: torch.Tensor, build_valid: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted effective build keys, 0-dim bool: a valid INT32_MAX key exists)."""
    is_max = build_keys == _I32_MAX
    if build_valid is not None:
        build_valid = build_valid.to(torch.bool)
        a_eff = torch.where(build_valid, build_keys, _I32_MAX)
        max_in_a = (build_valid & is_max).any()
    else:
        a_eff = build_keys
        max_in_a = is_max.any()
    return key_sort(a_eff), max_in_a


def _probe_prepared_i32(
    a_sorted: torch.Tensor,
    max_in_a: torch.Tensor,
    probe_keys: torch.Tensor,
    probe_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    is_max = probe_keys == _I32_MAX
    if probe_valid is not None:
        probe_valid = probe_valid.to(torch.bool)
        b_eff = torch.where(probe_valid, probe_keys, _I32_MAX)
        n_max = (probe_valid & is_max).sum()
    else:
        b_eff = probe_keys
        n_max = is_max.sum()
    del is_max
    b_sorted = key_sort(b_eff)
    del b_eff
    count = merge_probe.ranged_merge_count_prepared(
        a_sorted, b_sorted, exclude_int32_max=True
    )
    return count + torch.where(max_in_a, n_max, 0)


class PreparedBuild:
    """Build once, probe many — the engine analogue of the reference's
    reusable built hash table (src/NoPartitioning/HashJoin.hpp: Build runs
    once at :60-103, Probe is then driven repeatedly).  Holds the sorted
    build run, paid for once.

    int32 keys also hold the INT32_MAX flag ``max_in_a`` and take validity
    masks.  int64 keys keep only the sorted run (``max_in_a`` is None), are
    sorted by ``key_sort`` (K6, where the JAX package keeps the library
    sort), probed by K3 and raise ``TypeError`` on
    validity masks, as in the JAX package.
    """

    def __init__(
        self, build_keys: torch.Tensor, build_valid: Optional[torch.Tensor] = None
    ) -> None:
        self._n = int(build_keys.shape[0])
        self._i64 = build_keys.dtype in _WIDE
        if self._i64:
            if build_valid is not None:
                raise TypeError(
                    "validity masks are int32-path only; rewrite invalid "
                    "int64 keys before preparing the build"
                )
            self.a_sorted = key_sort(_as_i64("build_keys", build_keys))
            self.max_in_a = None
        else:
            keys = _as_i32("build_keys", build_keys)
            self.a_sorted, self.max_in_a = _prepare_build_i32(keys, build_valid)

    @classmethod
    def from_numpy(cls, a_sorted, max_in_a, device) -> "PreparedBuild":
        """A prepared build from the state of a JAX ``PreparedBuild``:
        ``np.asarray(pb.a_sorted)`` (ascending int32 or int64) and
        ``pb.max_in_a`` (None for int64)."""
        a = np.asarray(a_sorted)
        if a.dtype not in (np.int32, np.int64) or a.ndim != 1:
            raise TypeError(
                f"a_sorted must be 1-D int32 or int64, got {a.dtype}{a.shape}"
            )
        self = cls.__new__(cls)
        self._n = int(a.shape[0])
        self._i64 = a.dtype == np.int64
        self.a_sorted = torch.tensor(a, device=device)
        self.max_in_a = (
            None if self._i64
            else torch.tensor(bool(np.asarray(max_in_a)), device=device)
        )
        return self

    def count(
        self, probe_keys: torch.Tensor, probe_valid: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Get-semantics match count of this probe against the prepared
        build — no build-side work happens here."""
        if self._i64:
            if probe_valid is not None:
                raise TypeError("validity masks are int32-path only")
            probe_keys = _as_i64("probe_keys", probe_keys)
        else:
            probe_keys = _as_i32("probe_keys", probe_keys)
        if self._n == 0 or probe_keys.shape[0] == 0:
            return torch.zeros((), dtype=torch.int64, device=self.a_sorted.device)
        if self._i64:
            return merge_probe.ranged_merge_count_i64(
                self.a_sorted, key_sort(probe_keys)
            )
        return _probe_prepared_i32(self.a_sorted, self.max_in_a, probe_keys, probe_valid)


# ---------------------------------------------------------------------------
# Materializing kernel join (an engine extension; the reference materializes
# nothing — src/NoPartitioning/HashJoin.hpp:186 returns an empty table).
# ---------------------------------------------------------------------------


def two_run_materialize(
    build_keys: torch.Tensor,
    build_payloads: torch.Tensor,
    probe_keys: torch.Tensor,
    probe_payloads: torch.Tensor,
    probe_payload_sorted: bool = False,
):
    """Materialized first-match inner join on the kernel path (int32).

    Returns ``(keys, pay_a, pay_b, count)``: the matching probe rows in
    sorted-key order, compacted to the front with a zero tail, and their
    number as a 0-dim int64 tensor.  Both sides are sorted as (key,
    payload) tuples by K6's ``sort_i32_tuple``, as in the JAX package's
    "pallas" branch, so among duplicate build keys the SMALLEST payload wins
    and the probe rows come out in (key, payload) order.  The compaction is
    skipped when every probe row matches (the count's readback decides);
    otherwise K5 compacts the matching rows.

    ``probe_payload_sorted`` is accepted for the JAX package's signature:
    the tuple sort already orders ``pay_b`` within each key run, the order
    ``aggregate_sorted(payload_sorted=True)`` consumes.
    """
    for name, t in (
        ("build_keys", build_keys),
        ("build_payloads", build_payloads),
        ("probe_keys", probe_keys),
        ("probe_payloads", probe_payloads),
    ):
        if t.dtype in _WIDE:
            raise TypeError(
                f"two_run_materialize is the int32 path ({name} is {t.dtype})"
            )
    n_b = probe_keys.shape[0]
    if build_keys.shape[0] == 0 or n_b == 0:
        z = torch.zeros((n_b,), dtype=torch.int32, device=probe_keys.device)
        count = torch.zeros((), dtype=torch.int64, device=probe_keys.device)
        return z, z.clone(), z.clone(), count
    a_keys, a_pay = build_keys.to(torch.int32), build_payloads.to(torch.int32)
    b_keys, b_pay = probe_keys.to(torch.int32), probe_payloads.to(torch.int32)
    a_keys, a_pay = bitonic_sort.sort_i32_tuple(a_keys.contiguous(),
                                                a_pay.contiguous())
    b_keys, b_pay = bitonic_sort.sort_i32_tuple(b_keys.contiguous(),
                                                b_pay.contiguous())
    pay_a, pos = merge_payload.ranged_merge_payload_prepared(a_keys, a_pay, b_keys)
    count = torch.count_nonzero(pos)
    if int(count) == n_b:  # all-match: no compaction needed
        return b_keys, pay_a, b_pay, count
    _, _, keys, pa, pb = kcompact.compact_rows(
        pos > 0, [b_keys, pay_a, b_pay], n_b
    )
    return keys, pa, pb, count
