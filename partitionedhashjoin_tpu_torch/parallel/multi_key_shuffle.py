"""Distributed composite-key count join over a mesh of shards.

Counterpart of ``partitionedhashjoin_tpu/parallel/multi_key_shuffle.py``:
the shuffle join (``parallel/shuffle.py``) over MULTI-COLUMN keys
(``ops/multi_key.py``).  Rows are routed by a hash of their FULL key tuple
(equal tuples land on one shard, so per-shard counts are exact and add up),
both sides' k columns ride the same ``all_to_all`` bucket exchange, and each
shard counts its received rows with ``multi_key_count``; ``psum`` adds the
shards' counts.

Only the hash routes rows; matching is column-wise tuple equality, so hash
collisions cost balance, never correctness.  Overflowing buckets are counted
and the run retries with doubled slack, as the single-key joiner does.  A
received slot's invalidity rides as an extra TAG key column (live rows 0,
dead build slots 1, dead probe slots 2): a dead slot can never equal a live
or opposite-side row, so the multi-key count needs no mask protocol.  The
tag makes a k-column count k + 1 columns, so k >= 2 counts through the
k-stable-sort path of ``multi_key_count`` (k + 1 = 2 through K3 on the
packed pair), never K3 for k = 2 as on one device: the JAX protocol, kept
as it is.  No heavy-hitter replication: a hot TUPLE costs balance, and the
capacity retries absorb it.  ``last_run`` records each attempt's drops and
the exchange bytes.

On a mesh over several processes every process passes its own rows of each
column (``host_slice``'s layout, the same counts in every process): the
tuple hash routes by the global S, the drops are ``psum``'d before the
retry decision and the count is global in every process.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from partitionedhashjoin_tpu_torch.ops import hash_table as ht
from partitionedhashjoin_tpu_torch.ops import hashing
from partitionedhashjoin_tpu_torch.ops import multi_key
from partitionedhashjoin_tpu_torch.parallel.aggregate_shuffle import _a2a
from partitionedhashjoin_tpu_torch.parallel.mesh import Mesh, local_rows, psum
from partitionedhashjoin_tpu_torch.parallel.shuffle import ExchangeRun, _bucketize, _random_seed
from partitionedhashjoin_tpu_torch.utils.logger import get_new_logger

_MASK = 0xFFFFFFFF


def _hash_tuple(cols, seed) -> torch.Tensor:
    """Seeded 32-bit hash of a key TUPLE, as int64 values in [0, 2^32)
    (JAX: uint32): ``hash32`` of the first column (K7 on the card), then
    each further column chained through the pair mixer (two ``fmix32``
    rounds with distinct constants, ``hashing.hash64_pair``'s pattern), so
    every column avalanches into the route."""
    flat = [c.reshape(-1) for c in cols]
    h = ht.hash_bits(flat[0], int(seed) & _MASK).to(torch.int64) & _MASK
    for c in flat[1:]:
        h = hashing._fmix32(hashing._u32(c) ^ h)
        h = hashing._fmix32((h + hashing._GOLDEN) & _MASK)
    return h.view(cols[0].shape)


def _mk_exchange_and_count(mesh: Mesh, a_cols, b_cols, a_valid, b_valid,
                           shard_seed, cap_a: int, cap_b: int):
    """Tuple-hash routing, bucket exchange of every key column, and each
    shard's multi-key count with its tag column, ``psum``'d.  Returns
    ``(count, dropped_a, dropped_b)``, 0-dim int64 tensors, each summed
    over every shard of the mesh."""
    s, lsz = mesh.size, mesh.local_size
    a2 = [c.reshape(lsz, -1) for c in a_cols]
    b2 = [c.reshape(lsz, -1) for c in b_cols]
    dest_a = (_hash_tuple(a2, shard_seed) & (s - 1)).to(torch.int32)
    dest_b = (_hash_tuple(b2, shard_seed) & (s - 1)).to(torch.int32)
    *ba, bv_a, drop_a = _bucketize(dest_a, a_valid.reshape(lsz, -1), cap_a, s, *a2)
    *bb, bv_b, drop_b = _bucketize(dest_b, b_valid.reshape(lsz, -1), cap_b, s, *b2)
    ra = [_a2a(c, mesh) for c in ba]
    rb = [_a2a(c, mesh) for c in bb]
    rv_a, rv_b = _a2a(bv_a, mesh), _a2a(bv_b, mesh)
    del ba, bb, bv_a, bv_b
    counts = []
    for i in range(lsz):
        # tag column: 0 = live row; 1/2 = dead build/probe slot
        tag_a = torch.where(rv_a[i], 0, 1).to(torch.int32)
        tag_b = torch.where(rv_b[i], 0, 2).to(torch.int32)
        counts.append(multi_key.multi_key_count([c[i] for c in ra] + [tag_a],
                                                [c[i] for c in rb] + [tag_b]))
    drops = psum(torch.stack([drop_a, drop_b])[None], mesh)
    return psum(torch.stack(counts), mesh), drops[0], drops[1]


def _split_i64(keys) -> tuple:
    """``(hi, lo_cmp)`` int32 planes of 64-bit keys, JAX's ``split_i64``
    from the port's ``hashing.split64``: ``hi`` the signed high word,
    ``lo_cmp`` the low word biased by 2^31, so the planes' lexicographic
    order is the keys' order and plane equality is key equality."""
    lo, hi = (w.to(torch.int64) for w in hashing.split64(keys))
    return ((hi ^ 2**31) - 2**31).to(torch.int32), (lo - 2**31).to(torch.int32)


class MultiKeyShuffleJoiner:
    """Mesh-parallel composite-key count joiner.

    ``run(build_cols, probe_cols)`` returns the exact Get-semantics count
    (probe rows whose full key tuple appears among build rows), equal to
    ``ops/multi_key.multi_key_count`` on one device.  Bucket capacities
    retry with doubled slack on overflow.  Columns are placed on the mesh's
    device; across processes they are this process's rows and the count is
    the global one.
    """

    def __init__(
        self,
        mesh: Mesh,
        seed: Optional[int] = None,
        slack: float = 2.0,
        max_retries: int = 4,
    ) -> None:
        self._mesh = mesh
        self._num_shards = int(mesh.size)
        if self._num_shards & (self._num_shards - 1):
            raise ValueError("mesh size must be a power of 2")
        if seed is None:
            seed = _random_seed(mesh)
        self._shard_seed = seed & _MASK
        self._slack = slack
        self._max_retries = max_retries
        self._logger = get_new_logger("MultiKeyShuffleJoiner")
        self.last_run: Optional[ExchangeRun] = None

    def _capacity(self, rows_per_shard: int, slack: float) -> int:
        per_dest = rows_per_shard / self._num_shards
        return max(16, min(int(per_dest * slack + 1), rows_per_shard))

    def run_i64(self, build_keys: torch.Tensor, probe_keys: torch.Tensor) -> int:
        """64-bit single-key distributed count via the two-plane recipe:
        exact, because lexicographic plane equality is int64 equality."""
        return self.run(list(_split_i64(build_keys)), list(_split_i64(probe_keys)))

    def run(
        self,
        build_cols: Sequence[torch.Tensor],
        probe_cols: Sequence[torch.Tensor],
    ) -> int:
        build_cols, probe_cols = multi_key._check_sides(build_cols, probe_cols)
        s, lsz = self._num_shards, self._mesh.local_size
        n_a, a_valid, a_cols = local_rows(self._mesh, build_cols, what="build")
        n_b, b_valid, b_cols = local_rows(self._mesh, probe_cols, what="probe")
        self.last_run = run = ExchangeRun(num_shards=s)
        if n_a == 0 or n_b == 0:
            return 0

        slack = self._slack
        for _ in range(self._max_retries):
            cap_a = self._capacity(a_valid.shape[0] // lsz, slack)
            cap_b = self._capacity(b_valid.shape[0] // lsz, slack)
            count, drop_a, drop_b = _mk_exchange_and_count(
                self._mesh, a_cols, b_cols, a_valid, b_valid,
                self._shard_seed, cap_a, cap_b,
            )
            drop_a, drop_b = int(drop_a), int(drop_b)
            run.attempts.append({"dropped_a": drop_a, "dropped_b": drop_b})
            if drop_a == 0 and drop_b == 0:
                count = int(count)
                run.exchange_bytes = s * s * (cap_a + cap_b) * (4 * len(a_cols) + 1)
                self._logger.info("Number of joined tuples: %d", count)
                return count
            self.last_run.retries += 1
            self._logger.info(
                "bucket overflow (a=%d b=%d) at slack %.1f; retrying",
                drop_a, drop_b, slack,
            )
            slack *= 2
        raise RuntimeError(
            f"bucket overflow persisted after {self._max_retries} retries "
            f"(final slack {slack:.1f})"
        )
