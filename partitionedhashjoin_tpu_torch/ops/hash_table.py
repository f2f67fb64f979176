"""Hash tables: the open-addressing table, the bucket-chained table and the
deduplicating table behind the hash GROUP BY.

Counterpart of ``partitionedhashjoin_tpu/ops/hash_table.py`` (the reference's
latched linear-probing and separate-chaining tables,
src/HashTables/LinearProbing.hpp:90-210, SeparateChaining.hpp:143-277), with
the same names and the same results bit for bit:

- **Open addressing** (``build_hash_table``, ``probe_exists`` / ``probe_get``
  / ``probe_count_all``): the build is a claim/resolve loop.  Every pending
  row looks at slot ``(h + d) & mask``; rows facing an occupied slot step on,
  rows facing an empty one claim it with a ``scatter_reduce(amin)`` of their
  row id into an INT32_MAX buffer, so the smallest row id wins each slot,
  whatever order the device applies the updates in.  A probe walks the chain
  in lockstep to a key match, an empty slot or the recorded ``max_probe``.
  Slot occupancy lives in ``slot_rows`` (-1 = empty), so keys may take any
  int32 value.
- **Chained** (``build_chained``, ``probe_chained_*``): one stable sort by
  bucket; rows sorted by bucket are the chains, and ``offsets`` delimit
  them.  One pass over the sorted bucket ids and the sort's permutation
  writes the offsets, the entry rows and the longest chain (JAX scatters a
  histogram and takes its ``cumsum``), and the count probe walks each
  row's chain; both are hand-written kernels (``kernels/chained_probe``,
  their plain versions on a CPU tensor) with no JAX counterpart.  The other
  probes compare a window of ``PROBE_WINDOW`` chain entries per pass.
  It takes int32 and int64 keys (``_chained_keys``); the other tables take
  int32 keys only (``_as_i32_keys``).
- **Dedup** (``build_dedup_hash_table``): the claim loop where a row that
  finds its own key in a slot resolves to that slot's owner, so chains grow
  with distinct-key collisions only.  A key's representative is always its
  smallest (valid) row id, whatever the seed.

Every JAX ``while_loop`` is a Python loop here that reads its condition back
once per round, and each round runs only on the rows still active: rows do
not interact once they leave a loop, so every output is the one the
lockstep loop over all rows gives.  Every hash goes through the hash
kernel K7 (``ops/kernels/generate.hash_keys``) on a CUDA tensor and through
its plain version on a CPU tensor: ``hashing.hash32`` of an int32 key,
``hashing.hash64_pair`` of an int64 key's two words.

int64 keys are the port's own: the JAX package's hash layer is 32-bit, so
an int64 chained table has no JAX counterpart.  An int64 table's entries
keep their 8 bytes and every compare runs at int64; a probe of the other
width compares at int64 too, and takes its bucket from the table's hash
(``_probe_keys``).

Not ported: ``dispatch_chunks`` (the TPU watchdog's probe windows).
``probe_chained_count`` still takes ``num_chunks`` and counts the same.
Counts are 0-dim int64 tensors (JAX's are int32), and a table's ``seed`` is a
Python int (JAX holds a uint32 device scalar).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np
import torch

from partitionedhashjoin_tpu_torch.ops.kernels import chained_probe as kchained
from partitionedhashjoin_tpu_torch.ops.kernels import generate as kgenerate

#: Default slots-per-key ratio: a power-of-two slot count >= 2x keys (load
#: <= 0.5), as in the JAX package.
DEFAULT_SIZE_RATIO = 2.0
#: Chain entries compared per pass of a chained probe.
PROBE_WINDOW = 4
#: Per-partition capacity rounding granularity (slots).
SEGMENT_GRANULE = 8

_INT32_MAX = 2**31 - 1
_MASK = 0xFFFFFFFF


def _as_i32_keys(keys) -> torch.Tensor:
    """int32 keys; 64-bit keys raise ``TypeError`` (a silent cast would make
    distinct keys collide: they take the sort-merge path)."""
    keys = torch.as_tensor(keys)
    if keys.dtype in (torch.int64, torch.uint64):
        raise TypeError(
            "hash-table kernels are 32-bit; use sort_merge for int64 keys"
        )
    return keys.to(torch.int32)


def _chained_keys(keys) -> torch.Tensor:
    """Keys of the chained table: int64 stays int64 (uint64 is viewed as
    int64), other integer keys are int32 as in ``_as_i32_keys``; floats and
    bools raise ``TypeError``."""
    keys = torch.as_tensor(keys)
    if keys.dtype in (torch.int64, torch.uint64):
        return keys.view(torch.int64)
    if keys.is_floating_point() or keys.is_complex() or keys.dtype == torch.bool:
        raise TypeError(f"chained-table keys must be integers, got {keys.dtype}")
    return keys.to(torch.int32)


def hash_bits(keys: torch.Tensor, seed: int) -> torch.Tensor:
    """``hashing.hash32(keys, seed)`` of int32 keys, ``hashing.hash64_pair``
    of int64 keys' words, as int32 bit patterns: K7 on a CUDA tensor (raising
    if it cannot launch), its plain version on a CPU one."""
    return kgenerate.hash_keys(keys.contiguous(), seed).view(torch.int32)


def _bucket_of(keys: torch.Tensor, seed: int, mask: int) -> torch.Tensor:
    """int32 bucket ``hash_bits(key) & mask`` (``mask`` < 2^31)."""
    return hash_bits(keys, seed) & mask


def _seed(seed) -> int:
    return int(seed) & _MASK


def table_size_for(n: int, ratio: float = DEFAULT_SIZE_RATIO) -> int:
    """Power-of-two slot count >= ratio * n (cf. getNumberOfBuckets,
    src/HashTables/LinearProbing.cpp:7-12)."""
    if n <= 0:
        return 1
    want = max(1, int(-(-n * ratio // 1)))
    size = 1
    while size < want:
        size <<= 1
    return size


def _scalar(value, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(value).item(), dtype=dtype, device=device)


@dataclasses.dataclass
class HashTable:
    """A built open-addressing table.

    ``slot_keys[s]`` is meaningful iff ``slot_rows[s] >= 0``; ``slot_rows``
    holds the build row index.  ``max_probe`` (0-dim int32) bounds every
    probe loop.  ``overflowed`` (0-dim bool) is True iff the build hit its
    iteration bound with rows still pending (only possible with a validity
    mask hiding more valid rows than slots); probing such a table
    undercounts.
    """

    slot_keys: torch.Tensor
    slot_rows: torch.Tensor
    max_probe: torch.Tensor
    seed: int
    overflowed: torch.Tensor

    @property
    def size(self) -> int:
        return self.slot_keys.shape[0]

    @classmethod
    def from_numpy(cls, slot_keys, slot_rows, max_probe, seed,
                   overflowed=False, device="cpu") -> "HashTable":
        """A table from a JAX ``HashTable``'s fields as numpy arrays
        (``np.asarray(t.slot_keys)``, ...), on ``device``."""
        return cls(
            slot_keys=torch.tensor(np.asarray(slot_keys, np.int32), device=device),
            slot_rows=torch.tensor(np.asarray(slot_rows, np.int32), device=device),
            max_probe=_scalar(max_probe, torch.int32, device),
            seed=_seed(np.asarray(seed).item()),
            overflowed=_scalar(overflowed, torch.bool, device),
        )


def _claim_loop(keys, seed, size, valid, dedup):
    """The build's claim/resolve loop: ``(table, rep_row)``, ``rep_row``
    only with ``dedup`` (the representative row of each row's key, -1 for
    rows never inserted)."""
    keys = _as_i32_keys(keys)
    n = keys.shape[0]
    device = keys.device
    mask = size - 1
    seed = _seed(seed)
    home = _bucket_of(keys, seed, mask)
    slot_keys = torch.zeros((size,), dtype=torch.int32, device=device)
    slot_rows = torch.full((size,), -1, dtype=torch.int32, device=device)
    # only the rows trying a slot claim it, and the claimed entries are
    # reset after each round (JAX scatters every row, losers into a dump
    # slot, over a fresh buffer)
    claims = torch.full((size,), _INT32_MAX, dtype=torch.int32, device=device)
    rep_row = (torch.full((n,), -1, dtype=torch.int32, device=device)
               if dedup else None)
    max_probe = torch.zeros((), dtype=torch.int32, device=device)
    live = (torch.arange(n, device=device) if valid is None
            else torch.nonzero(torch.as_tensor(valid, device=device).to(torch.bool))
            .squeeze(1))
    rows, l_keys, l_home = live.to(torch.int32), keys[live], home[live]
    dist = torch.zeros_like(rows)
    it = 0
    # each round inserts >= 1 row or moves every pending row one step on, so
    # n + size + 2 rounds bound any build that fits; hitting the bound means
    # more valid rows than slots (``overflowed``)
    while rows.numel() and it < n + size + 2:
        slot = ((l_home + dist) & mask).to(torch.int64)
        occ_rows = slot_rows[slot]
        occupied = occ_rows >= 0
        pending = torch.ones_like(occupied)
        if dedup:
            # a row that sees its own key resolves to the slot's owner
            dup = occupied & (slot_keys[slot] == l_keys)
            rep_row[live[dup]] = occ_rows[dup]
            pending = ~dup
        dist = dist + (pending & occupied).to(torch.int32)
        t = torch.nonzero(pending & ~occupied).squeeze(1)  # rows trying
        t_slot, t_rows = slot[t], rows[t]
        claims.scatter_reduce_(0, t_slot, t_rows, "amin")
        won = t[claims[t_slot] == t_rows]
        claims[t_slot] = _INT32_MAX
        w_slot = slot[won]
        slot_keys[w_slot] = l_keys[won]
        slot_rows[w_slot] = rows[won]
        if dedup:
            rep_row[live[won]] = rows[won]
        if won.numel():
            max_probe = torch.maximum(max_probe, dist[won].max())
        pending[won] = False
        keep = torch.nonzero(pending).squeeze(1)
        live, rows, l_keys, l_home, dist = (
            x[keep] for x in (live, rows, l_keys, l_home, dist))
        it += 1
    table = HashTable(
        slot_keys=slot_keys,
        slot_rows=slot_rows,
        max_probe=max_probe,
        seed=seed,
        overflowed=torch.tensor(rows.numel() > 0, device=device),
    )
    return table, rep_row


def build_hash_table(
    keys: torch.Tensor,
    seed,
    size: int,
    valid: Optional[torch.Tensor] = None,
    has_valid: bool = False,
) -> HashTable:
    """Insert all ``keys`` into a fresh table of ``size`` slots (a power of
    2).  Rows with ``valid == False`` are skipped (pass ``has_valid=True``
    alongside); without a mask, ``size`` < the number of keys raises."""
    n = keys.shape[0]
    if size & (size - 1):
        raise ValueError(f"table size must be a power of two, got {size}")
    if size < n and not has_valid:
        raise ValueError(f"table size {size} < number of keys {n}")
    return _claim_loop(keys, seed, size, valid if has_valid else None,
                       dedup=False)[0]


def _probe_loop(table: HashTable, keys, count_all: bool, valid=None):
    """Lockstep probe: ``(found, first_row, match_count)``.  Rows with
    ``valid == False`` never probe and never match."""
    keys = _as_i32_keys(keys)
    n = keys.shape[0]
    device = keys.device
    mask = table.size - 1
    home = _bucket_of(keys, table.seed, mask)
    first_row = torch.full((n,), -1, dtype=torch.int32, device=device)
    matches = torch.zeros((n,), dtype=torch.int32, device=device)
    live = (torch.arange(n, device=device) if valid is None
            else torch.nonzero(torch.as_tensor(valid, device=device).to(torch.bool))
            .squeeze(1))
    l_keys, l_home = keys[live], home[live]
    seen = torch.zeros(live.shape, dtype=torch.bool, device=device)
    max_probe = int(table.max_probe)
    dist = 0  # every active row is at the same distance
    while live.numel():
        slot = ((l_home + dist) & mask).to(torch.int64)
        rows = table.slot_rows[slot]
        occupied = rows >= 0
        hit = occupied & (table.slot_keys[slot] == l_keys)
        new = hit & ~seen
        first_row[live[new]] = rows[new]
        seen |= hit
        matches.index_add_(0, live, hit.to(torch.int32))
        if dist >= max_probe:
            break
        # GetAll scans past hits to an empty slot; Exists/Get stop at a hit
        active = occupied if count_all else occupied & ~hit
        keep = torch.nonzero(active).squeeze(1)
        live, l_keys, l_home, seen = (x[keep] for x in (live, l_keys, l_home, seen))
        dist += 1
    return first_row >= 0, first_row, matches


def probe_exists(table: HashTable, keys: torch.Tensor, valid=None) -> torch.Tensor:
    """bool[n]: key present?  (``Exists``, LinearProbing.hpp:136-157)."""
    return _probe_loop(table, keys, count_all=False, valid=valid)[0]


def probe_get(table: HashTable, keys: torch.Tensor):
    """``(found, build_row)``: the first match per probe key (``Get``,
    LinearProbing.hpp:159-180; -1 where absent)."""
    found, first_row, _ = _probe_loop(table, keys, count_all=False)
    return found, first_row


def probe_count_all(table: HashTable, keys: torch.Tensor) -> torch.Tensor:
    """int32[n]: matching build entries per probe key (``GetAll``
    cardinality, LinearProbing.hpp:182-200)."""
    return _probe_loop(table, keys, count_all=True)[2]


# ---------------------------------------------------------------------------
# Chained bucket table: one stable sort builds it; chains are contiguous.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ChainedHashTable:
    """Bucket-chained table: entries sorted by bucket, and bucket offsets.

    ``entry_keys`` (int32[n] or int64[n], the build keys' width) and
    ``entry_rows`` (int32[n]) are the build keys and their row indices
    grouped by bucket; bucket b holds entries
    ``[offsets[b], offsets[b + 1])``; ``max_chain`` (0-dim int32) is the
    longest chain.
    """

    entry_keys: torch.Tensor
    entry_rows: torch.Tensor
    offsets: torch.Tensor
    max_chain: torch.Tensor
    seed: int

    @property
    def num_buckets(self) -> int:
        return self.offsets.shape[0] - 1

    @classmethod
    def from_numpy(cls, entry_keys, entry_rows, offsets, max_chain, seed,
                   device="cpu") -> "ChainedHashTable":
        """A table from a JAX ``ChainedHashTable``'s fields as numpy arrays,
        on ``device``."""
        def col(a):
            return torch.tensor(np.asarray(a, np.int32), device=device)

        return cls(
            entry_keys=col(entry_keys), entry_rows=col(entry_rows),
            offsets=col(offsets),
            max_chain=_scalar(max_chain, torch.int32, device),
            seed=_seed(np.asarray(seed).item()),
        )


def chained_num_buckets(n: int) -> int:
    """Power-of-two bucket count >= n (load factor <= 1)."""
    size = 1
    while size < max(1, n):
        size <<= 1
    return size


def build_chained_from_buckets(
    bucket: torch.Tensor, keys: torch.Tensor, seed, num_buckets: int
) -> ChainedHashTable:
    """Chained build from precomputed bucket ids: one stable sort by bucket,
    so each chain keeps build-row order, then one pass over the sorted ids
    and the sort's permutation (``kernels/chained_probe.chained_build``)
    writes the offsets (``offsets[b]`` is the first sorted row whose id is
    >= b, so an id at or past ``num_buckets`` is in no chain), the entry
    rows and the longest chain, which stays on the device; the keys are
    gathered in sorted order.  The radix join computes its
    partition-segmented bucket ids itself; plain tables use
    ``build_chained``."""
    keys = _chained_keys(keys)
    sorted_bucket, order = torch.sort(bucket, stable=True)
    entry_rows, offsets, max_chain = kchained.chained_build(
        sorted_bucket, order, num_buckets)
    return ChainedHashTable(
        entry_keys=keys[order],
        entry_rows=entry_rows,
        offsets=offsets,
        max_chain=max_chain,
        seed=_seed(seed),
    )


def build_chained(keys: torch.Tensor, seed, num_buckets: int) -> ChainedHashTable:
    """One-sort bucket-chained build (``num_buckets`` a power of two)."""
    keys = _chained_keys(keys)
    bucket = _bucket_of(keys, _seed(seed), num_buckets - 1)
    return build_chained_from_buckets(bucket, keys, seed, num_buckets)


def _probe_keys(table: ChainedHashTable, keys):
    """``(keys, hashed)`` of a probe: ``keys`` to compare with the entries
    and ``hashed`` for the table's hash.  Keys of the table's width serve as
    both.  An int32 probe of an int64 table is widened.  An int64 probe of
    an int32 table is compared at int64 (``_window``'s ``==`` promotes the
    int32 entries) and hashed by its low word, as ``hash32`` of an int32
    key: a key outside int32's range shares a bucket with its low word and
    equals no entry there."""
    keys = _chained_keys(keys)
    if keys.dtype == table.entry_keys.dtype:
        return keys, keys
    if keys.dtype == torch.int32:
        keys = keys.to(torch.int64)
        return keys, keys
    return keys, keys.to(torch.int32)


def _padded_entries(table: ChainedHashTable) -> torch.Tensor:
    """``entry_keys`` and ``PROBE_WINDOW`` zeros after them, in their
    dtype, so a window that runs past the last chain reads in range (the
    span masks it)."""
    k = table.entry_keys
    return torch.cat([k, k.new_zeros((PROBE_WINDOW,))])


def _window(padded, keys, pos, span):
    """One window pass: mask w tells whether chain entry ``pos + w`` exists
    (``w < span``, the entries left in the chain) and holds the row's key,
    compared at the wider of the two key widths."""
    return [(padded[w:].index_select(0, pos) == keys) & (span > w)
            for w in range(PROBE_WINDOW)]


def _any(masks):
    out = masks[0]
    for m in masks[1:]:
        out = out | m
    return out


def _scan_chains(table: ChainedHashTable, padded, keys, pos, end, need_rows):
    """Get-semantics window scan of each row's chain from ``pos`` to
    ``end``: ``(found, first_row)``."""
    n = keys.shape[0]
    device = keys.device
    found = torch.zeros((n,), dtype=torch.bool, device=device)
    first_row = torch.full((n,), -1, dtype=torch.int32, device=device)
    live = torch.nonzero(pos < end).squeeze(1)
    keys, pos, end = keys[live], pos[live], end[live]
    while live.numel():
        masks = _window(padded, keys, pos, end - pos)
        hit = _any(masks)
        h = torch.nonzero(hit).squeeze(1)
        found[live[h]] = True
        if need_rows:  # the first matching entry of the window
            first = torch.full_like(pos, PROBE_WINDOW - 1)
            for w in reversed(range(PROBE_WINDOW - 1)):
                first = torch.where(masks[w], w, first)
            first_row[live[h]] = table.entry_rows.index_select(0, (pos + first)[h])
        pos = pos + PROBE_WINDOW
        keep = torch.nonzero(~hit & (pos < end)).squeeze(1)
        live, keys, pos, end = (x[keep] for x in (live, keys, pos, end))
    return found, first_row


def _chain_bounds(table: ChainedHashTable, hashed, bucket):
    if bucket is None:
        bucket = _bucket_of(hashed, table.seed, table.num_buckets - 1)
    start = table.offsets.index_select(0, bucket)
    end = table.offsets.index_select(0, bucket + 1)
    return start, end


def _probe_chained_block(table: ChainedHashTable, keys, bucket=None,
                         need_rows=True):
    """``(found, first_row)`` per probe row by windowed chain scans.
    ``bucket`` overrides the hash-derived bucket (the radix join's
    partition-segmented bucket map); ``need_rows=False`` skips the row
    gathers."""
    keys, hashed = _probe_keys(table, keys)
    start, end = _chain_bounds(table, hashed, bucket)
    return _scan_chains(table, _padded_entries(table), keys, start, end,
                        need_rows)


def _probe_chained_count_chunk(table: ChainedHashTable, keys, bucket=None,
                               skip=None) -> torch.Tensor:
    """Count-only probe (0-dim int64); rows with index < ``skip`` are not
    counted (the overlapping last window of a chunked probe).  ``bucket``
    overrides the hash-derived bucket (the radix join's partition-segmented
    bucket map).  One call of ``kernels/chained_probe.chained_count``: K7's
    hashes under the table's mask, or ``bucket`` under an all-ones mask."""
    keys = _chained_keys(keys)
    if bucket is None:
        hashes = hash_bits(_probe_keys(table, keys)[1], table.seed)
        mask = table.num_buckets - 1
    else:
        hashes, mask = bucket.contiguous(), _MASK
    return kchained.chained_count(keys.contiguous(), hashes, mask,
                                  table.offsets, table.entry_keys,
                                  int(skip or 0))


def probe_chained_count(table: ChainedHashTable, keys: torch.Tensor,
                        num_chunks: int = 1) -> torch.Tensor:
    """Get-semantics match count (0-dim int64).  ``num_chunks`` splits the
    probe into calls of ``ceil(n / num_chunks)`` rows each, which bounds the
    temporaries; the last window ends at n and skips the rows the previous
    one counted, so the count is the same for any ``num_chunks``."""
    keys = _chained_keys(keys)
    n = keys.shape[0]
    num_chunks = min(num_chunks, max(1, n))
    if num_chunks <= 1:
        return _probe_chained_count_chunk(table, keys)
    m = -(-n // num_chunks)
    total = None
    for c in range(num_chunks):
        start = min(c * m, n - m)
        cnt = _probe_chained_count_chunk(table, keys[start:start + m],
                                         skip=c * m - start)
        total = cnt if total is None else total + cnt
    return total


def probe_chained_get(table: ChainedHashTable, keys: torch.Tensor):
    """``(found, build_row)``: the first match per probe key (Get)."""
    return _probe_chained_block(table, keys)


def probe_chained_count_all(table: ChainedHashTable, keys: torch.Tensor) -> torch.Tensor:
    """int32[n]: build multiplicity per probe key (``GetAll`` cardinality,
    SeparateChaining.hpp:256-265): windows scan each chain to its end."""
    keys, hashed = _probe_keys(table, keys)
    counts = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    padded = _padded_entries(table)
    pos, end = _chain_bounds(table, hashed, None)
    live = torch.nonzero(pos < end).squeeze(1)
    keys, pos, end = keys[live], pos[live], end[live]
    while live.numel():
        masks = _window(padded, keys, pos, end - pos)
        counts.index_add_(0, live, torch.stack(masks).sum(0, dtype=torch.int32))
        pos = pos + PROBE_WINDOW
        keep = torch.nonzero(pos < end).squeeze(1)
        live, keys, pos, end = (x[keep] for x in (live, keys, pos, end))
    return counts


def build_dedup_hash_table(
    keys: torch.Tensor,
    seed,
    size: int,
    valid: Optional[torch.Tensor] = None,
    has_valid: bool = False,
) -> Tuple[HashTable, torch.Tensor]:
    """Insert each distinct key once and map every row to its
    representative: ``(table, rep_row)``, ``rep_row[i]`` the build row that
    owns row i's slot (the smallest valid row id with that key).  Rows with
    ``valid == False`` are never inserted and keep ``rep_row == -1``.  The
    hash GROUP BY's backbone (``ops/aggregate.py``)."""
    if size & (size - 1):
        raise ValueError(f"table size must be a power of two, got {size}")
    return _claim_loop(keys, seed, size, valid if has_valid else None,
                       dedup=True)


# ---------------------------------------------------------------------------
# Segment geometry: per-partition bucket ranges in one flat bucket space (the
# radix join's per-partition ``factory.New(|A_p|)``,
# src/RadixCluster/HashJoin.hpp:278-286).
# ---------------------------------------------------------------------------


def segmented_capacity(n: int, num_partitions: int,
                       ratio: float = DEFAULT_SIZE_RATIO) -> int:
    """Upper bound on total slots: ratio * n plus one granule per partition
    of round-up slack."""
    return int(n * ratio) + num_partitions * SEGMENT_GRANULE


def segment_geometry(histogram: torch.Tensor, ratio: float = DEFAULT_SIZE_RATIO):
    """``(offsets, caps)`` (int32[P]) of per-partition bucket ranges sized
    ``ceil(ratio * |A_p|)``, rounded up to ``SEGMENT_GRANULE``.  The ratio
    is rationalized and every step is integer arithmetic, so the ceiling is
    exact at any partition size."""
    frac = Fraction(ratio).limit_denominator(64)
    num, den = frac.numerator, frac.denominator
    want = (histogram.to(torch.int64) * num + (den - 1)) // den
    caps = (want + (SEGMENT_GRANULE - 1)) // SEGMENT_GRANULE * SEGMENT_GRANULE
    caps = torch.clamp(caps, min=SEGMENT_GRANULE)
    offsets = torch.cumsum(caps, 0) - caps
    return offsets.to(torch.int32), caps.to(torch.int32)
