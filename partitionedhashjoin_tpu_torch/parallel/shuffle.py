"""Distributed shuffle join over a mesh of shards, with skew handling.

Counterpart of ``partitionedhashjoin_tpu/parallel/shuffle.py``, with the same
names and, for the same numpy inputs, shard count and seed, the same owner
shards, hot-key plan, received rows (as multisets), drop counts and retries.
The reference is single-process: its "shuffle" is the radix scatter into
shared memory (src/RadixCluster/HashJoin.hpp:394-412).  The join:

1. **Exchange (partition phase).**  Every shard sends each of its rows to
   the owner shard ``hash32(key, seed) & (S - 1)`` (the hash kernel K7 on the
   card): rows are bucketized into an ``(S, C)`` send buffer per shard and
   the buffers are swapped by the mesh's ``all_to_all``.  The bucket
   capacity ``C = ceil(local_rows / S * slack)`` is fixed before the
   exchange; rows past it are dropped and counted, and the joiner retries
   with doubled slack, so every count is exact.
2. **Skew.**  A sample (``plan_hot_keys``) finds the Zipf head.  Build rows
   with a hot key are replicated to every shard (``all_gather``); probe rows
   with a hot key stay where they are and are counted against the
   replicated keys.  Hot and cold probe rows are disjoint by key, so the
   count is unchanged.
3. **Local join and count.**  Each shard joins its received cold rows, by
   the two-run merge count (K1) or a hash table (``ops/hash_table.py``),
   and ``psum`` adds the shards' counts.

A process's shards share its torch device (``parallel/mesh.py``), so each
per-shard step of the JAX ``shard_map`` programs is either one op over the
``(local_size, rows)`` view of its shards at once (the hashes, the sorts by
destination, the masks) or a loop over them (the local joins).  Nothing
here overlaps on one card: ``_pipelined_probe`` issues chunk c+1's exchange
before counting chunk c, as JAX does, but both run on one stream.

On a mesh over several processes (``parallel/distributed.py``) every process
runs ``run`` on its own rows, and four values are made global so that the
processes agree at every step: the hot-key sample (``plan_hot_keys``
gathers the sampled positions from the processes that hold them, so every
process plans on the same sample), the drop counts that decide a retry, and
the local and hot counts (all summed by ``psum``).  A process draws its own
entropy for ``seed=None``, so such a mesh refuses it.

Where the port departs from the JAX module:

- ``_member_of_small`` is a ``searchsorted`` into the sorted hot set and
  one compare, where JAX runs one compare pass per hot key; the masks are
  the same.  ``torch.isin`` gives it too, but on CUDA it builds the whole
  (rows, |set|) comparison and reduces it: 40.7 of the 94.9 device ms of
  an 8-shard join at 10M ⋈ 200M on an H100 (PERF.md).
- ``_bucketize`` sorts by destination stably and copies each bucket's rows
  into place; slots past a bucket's rows hold zeros, where JAX's hold a
  neighbouring bucket's rows.  ``bucket_valid`` masks them either way, and
  on overflow the port keeps a bucket's first rows in row order, where JAX
  keeps whichever its unstable sort puts first.
- The local joins always take the kernel branch (K1, and K3 for the
  one-shard fast path with int64 keys): the port's kernels, or their plain
  versions on the CPU, run on every device, where JAX falls back to
  ``_searchsorted_counter`` without Mosaic.  The counts are the same.
  ``_searchsorted_member`` / ``_searchsorted_counter`` stay as functions.
- With more than one shard, 64-bit keys raise ``TypeError``: the owner
  hash is 32-bit, and JAX's ``hash32`` would cast the keys to uint32 (two
  distinct keys could then collide in a hot set).  The one-shard fast path
  takes them.
- Counts are Python ints, ``ShuffleStats`` fields 0-dim int64 tensors.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from partitionedhashjoin_tpu_torch.data.table import Table
from partitionedhashjoin_tpu_torch.ops import hash_table as ht
from partitionedhashjoin_tpu_torch.ops import merge_join
from partitionedhashjoin_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_to_all,
    check_local_rows,
    psum,
)
from partitionedhashjoin_tpu_torch.utils.device import sync
from partitionedhashjoin_tpu_torch.utils.logger import get_new_logger
from partitionedhashjoin_tpu_torch.utils.results import (
    IHashJoinTimer,
    NoOpHashJoinTimer,
)

_MASK = 0xFFFFFFFF
_I32_MAX = 2**31 - 1
_WIDE = (torch.int64, torch.uint64)


def _owner_shard(keys: torch.Tensor, seed, num_shards: int) -> torch.Tensor:
    """Owner shard of each key: ``hash32(key, seed) & (S - 1)`` as int32,
    in the shape of ``keys``."""
    if num_shards & (num_shards - 1):
        raise ValueError(f"num_shards must be a power of 2, got {num_shards}")
    if keys.dtype in _WIDE:
        raise TypeError(
            f"the shuffle join hashes 32-bit keys, got {keys.dtype}; join "
            "64-bit keys on one shard or with sort_merge"
        )
    flat = keys.reshape(-1).to(torch.int32)
    return (ht.hash_bits(flat, int(seed)) & (num_shards - 1)).view(keys.shape)


def _bucketize(dest, valid, capacity: int, num_shards: int, *columns):
    """Pack rows into ``num_shards * capacity`` send slots by destination.

    ``dest``, ``valid`` and ``columns`` are ``(..., n)``: one shard's rows,
    or every shard's as an ``(S, n)`` view.  Returns ``(bucketed
    columns..., bucket_valid, dropped)``, each bucketed column ``(...,
    num_shards * capacity)`` with bucket ``s`` at ``[s * capacity, (s + 1)
    * capacity)``; ``bucket_valid`` marks each bucket's first ``min(rows
    for s, capacity)`` slots; ``dropped`` (0-dim int64) counts the rows past
    a bucket's capacity, summed over every leading index.  Invalid rows go
    to a dump segment and are never placed.
    """
    lead, n = dest.shape[:-1], dest.shape[-1]
    device = dest.device
    d = torch.where(valid.to(torch.bool), dest.to(torch.int32), num_shards)
    d = d.reshape(-1, n)
    d_s, order = torch.sort(d, dim=-1, stable=True)
    ids = torch.arange(num_shards + 1, dtype=torch.int32, device=device)
    bounds = torch.searchsorted(d_s, ids.expand(d.shape[0], -1).contiguous())
    hist = bounds[:, 1:] - bounds[:, :-1]  # rows per destination
    kept = torch.clamp(hist, max=capacity)
    dropped = (hist - kept).sum()
    rank = torch.arange(capacity, device=device)
    bucket_valid = (rank < kept[..., None]).reshape(*lead, num_shards * capacity)
    starts, lens = bounds[:, :-1].tolist(), kept.tolist()
    outs = []
    for col in columns:
        by_dest = torch.gather(col.reshape(-1, n), 1, order)
        out = col.new_zeros((d.shape[0], num_shards, capacity))
        for r, (row_starts, row_lens) in enumerate(zip(starts, lens)):
            for s, (start, k) in enumerate(zip(row_starts, row_lens)):
                if k:
                    out[r, s, :k] = by_dest[r, start:start + k]
        outs.append(out.reshape(*lead, num_shards * capacity))
    return (*outs, bucket_valid, dropped)


def _member_of_small(keys, small_keys, small_valid) -> torch.Tensor:
    """Per-row membership in a small key set (the valid ``small_keys``):
    each key's insertion point in the sorted set, then one compare with the
    set's key there.  The set's last key is repeated past its end, so a key
    above them all reads a key it differs from and no index needs a clamp."""
    small = torch.sort(small_keys[small_valid.to(torch.bool)]).values
    if small.numel() == 0:
        return torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    flat = keys.reshape(-1)
    at = torch.searchsorted(small, flat, out_int32=True)  # in [0, len(small)]
    padded = torch.cat([small, small[-1:]])
    return (padded.index_select(0, at) == flat).view(keys.shape)


@dataclasses.dataclass
class ShuffleStats:
    """Exactness accounting: any nonzero drop count means a retry is needed."""

    dropped_a: torch.Tensor
    dropped_b: torch.Tensor
    dropped_hot: torch.Tensor


def _compact_hot(mesh: Mesh, is_hot, keys, pays, hot_cap: int):
    """Each shard's hot build rows, in row order, compacted into
    ``hot_cap`` slots and gathered on every shard: ``(keys, pays, valid,
    dropped)``, the first three ``(S * hot_cap,)``, ``dropped`` this
    process's."""
    s = is_hot.shape[0]
    device = keys.device
    n_hot = is_hot.sum(dim=1)
    shard, pos = torch.nonzero(is_hot, as_tuple=True)  # by shard, then row
    rank = torch.arange(shard.numel(), device=device) - (
        torch.cumsum(n_hot, 0) - n_hot)[shard]
    keep = rank < hot_cap
    shard, pos, rank = shard[keep], pos[keep], rank[keep]
    hk = keys.new_zeros((s, hot_cap))
    hp = pays.new_zeros((s, hot_cap))
    hk[shard, rank] = keys[shard, pos]
    hp[shard, rank] = pays[shard, pos]
    hv = torch.arange(hot_cap, device=device) < n_hot[:, None]
    dropped = torch.clamp(n_hot - hot_cap, min=0).sum()
    return (all_gather(hk, mesh), all_gather(hp, mesh), all_gather(hv, mesh),
            dropped)


def _row_valid(valid, shape, device) -> torch.Tensor:
    if valid is None:
        return torch.ones(shape, dtype=torch.bool, device=device)
    return valid.reshape(shape).to(torch.bool)


def _exchange(
    mesh: Mesh,
    keys_a,
    pays_a,
    keys_b,
    pays_b,
    shard_seed,
    hot_keys,
    hot_valid,
    cap_a: int,
    cap_b: int,
    hot_cap: int,
    use_hot: bool,
    exchange_b: bool = True,
    valid_a=None,
    valid_b=None,
):
    """Partition phase: bucketize + all_to_all both relations; replicate hot
    build rows.  Takes and returns row-sharded tensors in JAX's global
    layout, this process's rows: the received rows ``(rk, rp, rv)`` of A
    and B (shard ``j``'s block holds bucket ``j`` of every source shard, in
    global source order), the local hot probe mask ``is_hot_b``, the
    replicated hot build rows ``(hk, hp, hv)`` and this process's drop
    counts.

    With ``exchange_b=False`` B is bucketized but NOT exchanged (its slots
    hold the local send buckets): ``_pipelined_probe`` exchanges it chunk by
    chunk.  ``valid_a``/``valid_b``: optional per-row validity (a pushed-down
    FILTER); invalid rows go to the dump segment, so they never travel,
    never replicate and are never hot."""
    s, lsz = mesh.size, mesh.local_size
    device = keys_a.device
    ka, pa = keys_a.reshape(lsz, -1), pays_a.reshape(lsz, -1)
    kb, pb = keys_b.reshape(lsz, -1), pays_b.reshape(lsz, -1)
    row_a = _row_valid(valid_a, ka.shape, device)
    row_b = _row_valid(valid_b, kb.shape, device)
    if use_hot:
        is_hot_a = row_a & _member_of_small(ka, hot_keys, hot_valid)
        is_hot_b = row_b & _member_of_small(kb, hot_keys, hot_valid)
    else:
        is_hot_a = torch.zeros_like(row_a)
        is_hot_b = torch.zeros_like(row_b)

    # cold rows travel to their owner shard
    bk_a, bp_a, bv_a, drop_a = _bucketize(
        _owner_shard(ka, shard_seed, s), row_a & ~is_hot_a, cap_a, s, ka, pa)
    bk_b, bp_b, bv_b, drop_b = _bucketize(
        _owner_shard(kb, shard_seed, s), row_b & ~is_hot_b, cap_b, s, kb, pb)

    def a2a(x):
        return all_to_all(x.reshape(lsz, s, -1), mesh).reshape(-1)

    received_a = (a2a(bk_a), a2a(bp_a), a2a(bv_a))
    if exchange_b:
        received_b = (a2a(bk_b), a2a(bp_b), a2a(bv_b))
    else:
        received_b = (bk_b.reshape(-1), bp_b.reshape(-1), bv_b.reshape(-1))

    # hot build rows are replicated everywhere (all_gather; all zeros
    # without a hot plan); hot probe rows stay local (is_hot_b is read again
    # in the probe phase)
    hk, hp, hv, drop_hot = _compact_hot(mesh, is_hot_a, ka, pa, hot_cap)
    stats = ShuffleStats(dropped_a=drop_a, dropped_b=drop_b, dropped_hot=drop_hot)
    return (*received_a, *received_b, is_hot_b.reshape(-1), hk, hp, hv, stats)


def _build_local_tables(mesh: Mesh, recv_keys_a, recv_valid_a, bucket_seed,
                        table_size: int):
    """Build phase: one open-addressing table per shard over its received
    cold rows: ``(slot_keys, slot_rows, max_probes)``, the first two
    row-sharded (``table_size`` slots per shard), ``max_probes``
    ``(local_size,)``."""
    s = mesh.local_size
    ka, va = recv_keys_a.reshape(s, -1), recv_valid_a.reshape(s, -1)
    tables = [
        ht.build_hash_table(ka[i], bucket_seed, table_size, valid=va[i],
                            has_valid=True)
        for i in range(s)
    ]
    return (
        torch.cat([t.slot_keys for t in tables]),
        torch.cat([t.slot_rows for t in tables]),
        torch.stack([t.max_probe for t in tables]),
    )


def _hot_count(keys_b, is_hot_b, hot_plan_keys, hot_plan_valid, hot_repl_keys,
               hot_repl_valid) -> torch.Tensor:
    """This process's hot probe rows whose key has a replicated hot build
    row."""
    eff_valid = _effective_hot_valid(
        hot_plan_keys, hot_plan_valid, hot_repl_keys, hot_repl_valid)
    return (is_hot_b & _member_of_small(keys_b, hot_plan_keys, eff_valid)).sum()


def _probe_and_count(
    mesh: Mesh,
    slot_keys,
    slot_rows,
    max_probes,
    bucket_seed,
    recv_keys_b,
    recv_valid_b,
    keys_b,
    is_hot_b,
    hot_plan_keys,
    hot_plan_valid,
    hot_repl_keys,
    hot_repl_valid,
    use_hot: bool,
) -> torch.Tensor:
    """Probe phase: cold rows against each shard's table, hot rows against
    the effective hot plan set; ``psum`` for the global count (the
    reference's atomic counter, NoPartitioning/HashJoin.hpp:156)."""
    s = mesh.local_size
    sk, sr = slot_keys.reshape(s, -1), slot_rows.reshape(s, -1)
    kb, vb = recv_keys_b.reshape(s, -1), recv_valid_b.reshape(s, -1)
    no_overflow = torch.zeros((), dtype=torch.bool, device=sk.device)
    counts = []
    for i in range(s):
        table = ht.HashTable(slot_keys=sk[i], slot_rows=sr[i],
                             max_probe=max_probes[i], seed=int(bucket_seed),
                             overflowed=no_overflow)
        counts.append(ht.probe_exists(table, kb[i], valid=vb[i]).sum())
    if use_hot:
        counts.append(_hot_count(keys_b, is_hot_b, hot_plan_keys, hot_plan_valid,
                                 hot_repl_keys, hot_repl_valid))
    return psum(torch.stack(counts), mesh)


def _effective_hot_valid(
    hot_plan_keys, hot_plan_valid, hot_repl_keys, hot_repl_valid
) -> torch.Tensor:
    """Validity of the hot PLAN keys that actually have a replicated hot
    build row.  Probe membership in this masked plan set equals membership
    in the replicated hot build rows (each of their keys is a plan key), so
    the hot probe needs no hash table."""
    return hot_plan_valid.to(torch.bool) & torch.isin(
        hot_plan_keys, hot_repl_keys[hot_repl_valid.to(torch.bool)])


def _pipelined_probe(
    mesh: Mesh,
    recv_keys_a,
    recv_valid_a,
    bucket_keys_b,
    bucket_valid_b,
    keys_b,
    is_hot_b,
    hot_plan_keys,
    hot_plan_valid,
    hot_repl_keys,
    hot_repl_valid,
    cap_b: int,
    use_hot: bool,
    num_chunks: int,
) -> torch.Tensor:
    """Probe with the B exchange split into ``num_chunks`` chunks: chunk c
    is the c-th contiguous block of every bucket, so each moves exactly
    ``cap_b / num_chunks`` slots per shard pair.  Each shard's received
    build side is sorted once (``merge_join.PreparedBuild``: the INT32_MAX
    validity protocol); each chunk is then sorted and counted against it
    by K1.  Chunk c+1's exchange is issued before chunk c is counted, as in
    the JAX scan; on one card both run on one stream."""
    s, lsz = mesh.size, mesh.local_size
    ka, va = recv_keys_a.reshape(lsz, -1), recv_valid_a.reshape(lsz, -1)
    builds = [merge_join.PreparedBuild(ka[i], va[i]) for i in range(lsz)]
    bkb = bucket_keys_b.reshape(lsz, s, num_chunks, cap_b // num_chunks)
    bvb = bucket_valid_b.reshape(lsz, s, num_chunks, cap_b // num_chunks)

    def exchange(c):
        return all_to_all(bkb[:, :, c], mesh), all_to_all(bvb[:, :, c], mesh)

    counts = []
    received = exchange(0)
    for c in range(num_chunks):
        rk, rv = received
        if c + 1 < num_chunks:
            received = exchange(c + 1)  # prefetch: independent of this count
        counts += [builds[i].count(rk[i].reshape(-1), rv[i].reshape(-1))
                   for i in range(lsz)]
    if use_hot:
        counts.append(_hot_count(keys_b, is_hot_b, hot_plan_keys, hot_plan_valid,
                                 hot_repl_keys, hot_repl_valid))
    return psum(torch.stack(counts), mesh)


def _searchsorted_member(rka, rva):
    """Sorted-set membership for a valid-masked key array: the set sorted
    once (invalid rows as INT32_MAX, searched only below the first
    INT32_MAX), then any key batch answered by one ``searchsorted``.  A
    query equal to INT32_MAX is answered by the separate ``max_in_a`` flag.
    Callers mask the result by their own row validity."""
    rva = rva.to(torch.bool)
    a_sorted = torch.sort(torch.where(rva, rka, _I32_MAX)).values
    max_in_a = (rva & (rka == _I32_MAX)).any()
    limit = torch.searchsorted(
        a_sorted, torch.full((1,), _I32_MAX, dtype=a_sorted.dtype,
                             device=a_sorted.device))[0]

    def member(q):
        idx = torch.searchsorted(a_sorted, q.contiguous())
        hit = (a_sorted[torch.clamp(idx, max=a_sorted.shape[0] - 1)] == q) & (
            idx < limit)
        return hit | (max_in_a & (q == _I32_MAX))

    return member


def _searchsorted_counter(rka, rva):
    """Count a valid-masked probe batch against the build set (JAX's local
    join where Mosaic is missing; here only tests call it)."""
    member = _searchsorted_member(rka, rva)

    def count(rk, rv):
        return (rv.to(torch.bool) & member(rk)).sum()

    return count


def _sort_merge_local_count(
    mesh: Mesh,
    recv_keys_a,
    recv_valid_a,
    recv_keys_b,
    recv_valid_b,
    keys_b,
    is_hot_b,
    hot_plan_keys,
    hot_plan_valid,
    hot_repl_keys,
    hot_repl_valid,
    use_hot: bool,
) -> torch.Tensor:
    """Local join: each shard's two-run merge count (K1) over its received
    cold rows, plus the hot probe, ``psum``'d.  The sort subsumes the build,
    so the join's post-exchange cost is one sort of each shard's rows."""
    s = mesh.local_size
    ka, va = recv_keys_a.reshape(s, -1), recv_valid_a.reshape(s, -1)
    kb, vb = recv_keys_b.reshape(s, -1), recv_valid_b.reshape(s, -1)
    counts = [merge_join.two_run_count(ka[i], kb[i], va[i], vb[i]) for i in range(s)]
    if use_hot:
        counts.append(_hot_count(keys_b, is_hot_b, hot_plan_keys, hot_plan_valid,
                                 hot_repl_keys, hot_repl_valid))
    return psum(torch.stack(counts), mesh)


def plan_hot_keys(
    keys: torch.Tensor,
    sample_size: int,
    capacity: int,
    min_frac: float,
    seed: int = 0,
    mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample-based heavy-hitter detection: ``(hot_keys int32[capacity],
    hot_valid bool[capacity])``, deterministic given ``seed``.

    One sample position per stride window, at a hashed phase (position
    ``i * stride + hash(i) % stride``, the hash on K7), so neither a
    key-sorted relation nor a first-rows-special layout hides its hot keys
    between stride points; the sample is grouped by the hash GROUP BY
    (``aggregate._group_and_aggregate``), and the ``capacity`` largest
    counts, ties to the lower group as ``lax.top_k`` takes them, are hot
    when their sample frequency reaches ``min_frac``.

    The positions index the global relation, as JAX's run on the global
    array: on a mesh over several processes ``keys`` is this process's
    slice of it (``distributed.host_slice``), each process reads the
    sampled positions that fall in its rows, and ``psum`` (each position
    filled by one process, zeros elsewhere) gives every process the whole
    sample in sample order, so every process computes the same plan.
    """
    from partitionedhashjoin_tpu_torch.ops.aggregate import _group_and_aggregate

    n_local = keys.shape[0]
    nproc = 1 if mesh is None else mesh.process_count
    n = n_local * nproc
    device = keys.device
    stride = max(1, n // sample_size)
    m = min(n, sample_size)
    win = torch.arange(m, dtype=torch.int32, device=device)
    h = ht.hash_bits(win, (seed ^ 0x5EED) & _MASK).to(torch.int64) & _MASK
    pos = torch.clamp(win.to(torch.int64) * stride + h % stride, max=n - 1)
    if nproc == 1:
        sample = keys[pos]
    else:
        local = pos - mesh.process_index * n_local
        mine = (local >= 0) & (local < n_local)
        read = keys[torch.clamp(local, 0, n_local - 1)]
        sample = psum(torch.where(mine, read, 0)[None], mesh).to(keys.dtype)
    g = _group_and_aggregate(
        sample, torch.zeros((m,), dtype=torch.int32, device=device),
        seed & _MASK, ht.table_size_for(m))
    gid_valid = torch.arange(m, device=device) < g.num_groups
    counts = torch.where(gid_valid, g.count, -1)
    k = min(capacity, m)
    top_counts, top_idx = torch.sort(counts, descending=True, stable=True)
    min_count = max(1, int(min_frac * m))
    hot_keys = torch.zeros((capacity,), dtype=torch.int32, device=device)
    hot_valid = torch.zeros((capacity,), dtype=torch.bool, device=device)
    hot_keys[:k] = g.keys[top_idx[:k]].to(torch.int32)
    hot_valid[:k] = top_counts[:k] >= min_count
    return hot_keys, hot_valid


#: Bytes of one row slot of the exchange: key, payload and valid.
ROW_SLOT_BYTES = 9
#: Bytes of one B slot that ``_pipelined_probe`` exchanges: key and valid.
KEY_SLOT_BYTES = 5
#: The exchange's overflow counters, in ``ShuffleStats`` order.
DROP_NAMES = ("dropped_a", "dropped_b", "dropped_hot")


@dataclasses.dataclass
class ShuffleRun:
    """What a joiner's last ``run`` did: the drop counts ``(a, b, hot)`` of
    each attempt (the last is the accepted one; none on the one-shard fast
    path), the bucket capacities of the last attempt and the planned hot
    keys, hottest first.  The counts are global: every process of a mesh
    records the same run.  ``local_shards`` (compared with nothing: the
    same join over one or several processes makes equal runs) is the
    shards of the process that recorded it, all of them on one process;
    ``b_slot_bytes`` is what one B slot carries across, ``KEY_SLOT_BYTES``
    when the pipelined probe exchanges keys and valid flags only."""

    num_shards: int
    drops: List[Tuple[int, int, int]]
    cap_a: int
    cap_b: int
    hot_cap: int
    hot_keys: List[int]
    local_shards: Optional[int] = dataclasses.field(default=None, compare=False)
    b_slot_bytes: int = ROW_SLOT_BYTES

    @property
    def retries(self) -> int:
        return max(0, len(self.drops) - 1)

    @property
    def exchange_slots(self) -> int:
        """Send slots of the accepted attempt (each holds key, payload and
        valid), and as many receive slots: ``S * S * (cap_a + cap_b)``."""
        if not self.drops:
            return 0
        return self.num_shards * self.num_shards * (self.cap_a + self.cap_b)

    @property
    def cross_process_bytes(self) -> int:
        """Bytes of the accepted exchange that the recording process sends
        to other processes: its shards' blocks bound for shards it does not
        hold, ``L * (S - L)`` blocks of ``cap_a`` slots of ``ROW_SLOT_BYTES``
        and ``cap_b`` slots of ``b_slot_bytes``."""
        local = self.num_shards if self.local_shards is None else self.local_shards
        if not self.drops:
            return 0
        return local * (self.num_shards - local) * (
            self.cap_a * ROW_SLOT_BYTES + self.cap_b * self.b_slot_bytes)

    def record_exchange(self, dropped, cap_a: int, cap_b: int, hot_cap: int,
                        b_slot_bytes: int = ROW_SLOT_BYTES) -> None:
        self.drops.append(dropped)
        self.cap_a, self.cap_b, self.hot_cap = cap_a, cap_b, hot_cap
        self.b_slot_bytes = b_slot_bytes


@dataclasses.dataclass
class ExchangeRun:
    """What a distributed operator's last ``run`` did: the overflow
    counters of each attempt of each of its retry loops, named as in the
    operator's retry log, the attempts that overflowed and were retried, and
    the bytes its accepted exchanges send (as many are received)."""

    num_shards: int
    attempts: List[dict] = dataclasses.field(default_factory=list)
    retries: int = 0
    exchange_bytes: int = 0

    def record_exchange(self, dropped, cap_a: int, cap_b: int, hot_cap: int,
                        b_slot_bytes: int = ROW_SLOT_BYTES) -> None:
        self.attempts.append(dict(zip(DROP_NAMES, dropped)))
        if any(dropped):
            self.retries += 1
        else:
            s = self.num_shards
            self.exchange_bytes = s * s * (cap_a * ROW_SLOT_BYTES + cap_b * b_slot_bytes)


def _random_seed(mesh: Mesh) -> int:
    """A fresh seed for ``seed=None``; refused on a mesh over several
    processes, where each would draw its own and route rows differently."""
    if mesh.process_count > 1:
        raise ValueError(
            f"seed=None on a mesh over {mesh.process_count} processes: each "
            "would draw its own entropy and hash rows differently; pass one "
            "seed to every process"
        )
    return int(np.random.SeedSequence().entropy & _MASK)


class _ExchangeOperator:
    """The knobs and the retry policy that the shuffle join and the
    operators on its exchange share: seeds, the hot-key plan, the bucket
    capacities, and retries that grow the capacity that overflowed."""

    def __init__(self, mesh: Mesh, seed: Optional[int], slack: float,
                 handle_skew: bool, hot_capacity: int, hot_sample: int,
                 hot_min_frac: float, max_retries: int, name: str) -> None:
        self._mesh = mesh
        self._num_shards = int(mesh.size)
        if self._num_shards & (self._num_shards - 1):
            raise ValueError("mesh size must be a power of 2")
        if seed is None:
            seed = _random_seed(mesh)
        self._seed = seed & _MASK
        self._shard_seed = self._seed
        self._hot_seed = (seed ^ 0x9E3779B9) & _MASK
        self._slack = slack
        self._handle_skew = handle_skew
        self._hot_capacity = hot_capacity
        self._hot_sample = hot_sample
        self._hot_min_frac = hot_min_frac
        self._max_retries = max_retries
        self._logger = get_new_logger(name)

    def _capacity(self, rows_per_shard: int, slack: float) -> int:
        per_dest = rows_per_shard / self._num_shards
        # a shard can never send more than its own rows to one destination,
        # so rows_per_shard is a hard cap (slack is meaningless at S=1)
        return max(16, min(int(per_dest * slack + 1), rows_per_shard))

    def _hot_plan(self, keys_b: torch.Tensor):
        """``(hot_keys, hot_valid)``: the sampled hot probe keys, or an
        empty plan without skew handling."""
        if self._handle_skew:
            return plan_hot_keys(keys_b, self._hot_sample, self._hot_capacity,
                                 self._hot_min_frac, seed=self._hot_seed,
                                 mesh=self._mesh)
        device = keys_b.device
        return (torch.zeros((self._hot_capacity,), dtype=torch.int32, device=device),
                torch.zeros((self._hot_capacity,), dtype=torch.bool, device=device))

    def _check_inputs(self, table_a: Table, table_b: Table, valid_a, valid_b):
        """The shared input contract (``mesh.check_local_rows``): this
        process's rows of each relation divide by its shards and equal the
        other processes', the masks (per local row) and the tables sit on
        the mesh's device; any refusal raises in every process."""
        problem = None
        for name, t, table in (("table_a", table_a.keys, table_a),
                               ("table_b", table_b.keys, table_b),
                               ("valid_a", valid_a, table_a),
                               ("valid_b", valid_b, table_b)):
            if t is None or problem is not None:
                continue
            if t.device != self._mesh.device:
                problem = (f"{name} is on {t.device}, the mesh on "
                           f"{self._mesh.device}; place it with shard_table / "
                           "shard_array")
            elif t.shape != (table.size,):
                problem = (f"{name} has shape {tuple(t.shape)}, the relation "
                           f"{table.size} rows")
        check_local_rows([table_a.size, table_b.size], self._mesh, problem=problem)

    def _exchange_with_retries(self, keys_a, pays_a, keys_b, pays_b, hot_keys,
                               hot_valid, valid_a, valid_b, run, consume, what,
                               timer: Optional[IHashJoinTimer] = None,
                               cap_b_multiple: int = 1, exchange_b: bool = True):
        """Exchange until no counter overflows and ``consume`` returns a
        result, at most ``max_retries`` times.  Each attempt reads the three
        drop counts back and records them with ``run.record_exchange``; cold
        drops double the slack, hot drops grow ``hot_cap`` to
        ``4 * hot_cap + dropped``; the counts are summed over the processes
        first, so that every process retries or none does.  With
        ``exchange_b=False`` B's buckets are left to ``_pipelined_probe``,
        which sends ``KEY_SLOT_BYTES`` of each slot.
        ``consume(exchanged, cap_a, cap_b)``
        gets ``_exchange``'s outputs as a list, which it may clear to free
        what it does not read, and returns None to exchange again.
        The timer's partition phase sums every attempt's exchange."""
        lsz = self._mesh.local_size
        timer = timer or NoOpHashJoinTimer()
        slack = self._slack
        hot_cap = self._hot_capacity
        seconds = 0.0
        for _ in range(self._max_retries):
            cap_a = self._capacity(keys_a.shape[0] // lsz, slack)
            cap_b = self._capacity(keys_b.shape[0] // lsz, slack)
            cap_b = -(-cap_b // cap_b_multiple) * cap_b_multiple
            t0 = time.perf_counter()
            exchanged = list(_exchange(
                self._mesh, keys_a, pays_a, keys_b, pays_b, self._shard_seed,
                hot_keys, hot_valid, cap_a, cap_b, hot_cap, self._handle_skew,
                exchange_b=exchange_b, valid_a=valid_a, valid_b=valid_b,
            ))
            stats = exchanged[-1]
            dropped = tuple(psum(torch.stack(
                [stats.dropped_a, stats.dropped_b, stats.dropped_hot])[None],
                self._mesh).tolist())
            seconds += time.perf_counter() - t0
            timer.set_partitioning_phase_duration(seconds)
            run.record_exchange(dropped, cap_a, cap_b, hot_cap,
                                ROW_SLOT_BYTES if exchange_b else KEY_SLOT_BYTES)
            if any(dropped):
                self._logger.info(
                    "bucket overflow (a=%d b=%d hot=%d) at slack %.1f; retrying",
                    *dropped, slack,
                )
                # grow the capacity that actually overflowed: doubling slack
                # cannot fix a hot-replication overflow (hot_cap is separate)
                if dropped[0] > 0 or dropped[1] > 0:
                    slack *= 2
                if dropped[2] > 0:
                    hot_cap = hot_cap * 4 + dropped[2]
                continue
            result = consume(exchanged, cap_a, cap_b)
            if result is not None:
                return result
        raise RuntimeError(f"{what} overflowed after {self._max_retries} retries")


class DistributedShuffleJoiner(_ExchangeOperator):
    """Mesh-parallel shuffle hash joiner.

    Phases map onto the reference timer (utils/results.py): partition =
    exchange (bucketize + all_to_all + hot replication), build = per-shard
    table build, probe = cold + hot probe with the ``psum`` count.
    ``slack`` sets the bucket capacity; on overflow the run retries with
    doubled slack (and a grown ``hot_cap`` for hot overflow), so returned
    counts are always exact.  ``last_run`` records what the last ``run``
    did (``ShuffleRun``).
    """

    def __init__(
        self,
        mesh: Mesh,
        seed: Optional[int] = None,
        slack: float = 2.0,
        handle_skew: bool = True,
        hot_capacity: int = 64,
        hot_sample: int = 16_384,
        hot_min_frac: float = 0.005,
        max_retries: int = 3,
        local_join: str = "sort-merge",
        pipeline_chunks: int = 1,
        single_shard_fast_path: bool = True,
    ) -> None:
        if local_join not in ("sort-merge", "hash"):
            raise ValueError(f"unknown local_join {local_join}")
        if pipeline_chunks < 1:
            raise ValueError("pipeline_chunks must be >= 1")
        super().__init__(mesh, seed, slack, handle_skew, hot_capacity, hot_sample,
                         hot_min_frac, max_retries, "DistributedShuffleJoiner")
        self._single_shard_fast_path = single_shard_fast_path
        self._local_join = local_join
        self._pipeline_chunks = pipeline_chunks
        self._bucket_seed = (self._seed ^ 0xC2B2AE35) & _MASK
        self.last_run: Optional[ShuffleRun] = None

    def run(
        self,
        table_a: Table,
        table_b: Table,
        timer: Optional[IHashJoinTimer] = None,
        valid_a: Optional[torch.Tensor] = None,
        valid_b: Optional[torch.Tensor] = None,
    ) -> int:
        """Count matches; ``valid_a``/``valid_b`` are optional row-sharded
        validity masks (a pushed-down FILTER).  Invalid rows are dropped at
        the bucketizer so they never travel; the count is exact over valid
        rows only."""
        timer = timer or NoOpHashJoinTimer()
        s = self._num_shards
        self._check_inputs(table_a, table_b, valid_a, valid_b)
        if (
            s == 1
            and self._single_shard_fast_path
            and self._local_join == "sort-merge"
            and self._pipeline_chunks == 1
        ):
            # shuffle elision: a 1-shard exchange is the identity, so the
            # join IS the local join, and hot-key replication is a no-op.
            # single_shard_fast_path=False measures the exchange machinery.
            return self._run_single_shard(table_a, table_b, timer, valid_a, valid_b)
        if table_a.keys.dtype in _WIDE or table_b.keys.dtype in _WIDE:
            raise TypeError(
                f"the shuffle join over {s} shards hashes 32-bit keys; 64-bit "
                "keys run on one shard (single_shard_fast_path) or sort_merge"
            )
        hot_keys, hot_valid = self._hot_plan(table_b.keys)
        run = ShuffleRun(num_shards=s, drops=[], cap_a=0, cap_b=0, hot_cap=0,
                         hot_keys=hot_keys[hot_valid].tolist(),
                         local_shards=self._mesh.local_size)
        self.last_run = run
        pipelined = self._pipeline_chunks > 1

        def count_exchanged(exchanged, cap_a, cap_b):
            rk_a, _, rv_a, rk_b, _, rv_b, is_hot_b, hk, _, hv, _ = exchanged
            exchanged.clear()  # the count reads keys and masks only
            use_hot = self._handle_skew
            if pipelined:
                # B's buckets are exchanged chunk by chunk inside the probe
                timer.set_build_phase_begin()
                timer.set_build_phase_end()
                timer.set_probe_phase_begin()
                count = int(_pipelined_probe(
                    self._mesh, rk_a, rv_a, rk_b, rv_b, table_b.keys,
                    is_hot_b, hot_keys, hot_valid, hk, hv, cap_b, use_hot,
                    self._pipeline_chunks,
                ))
                timer.set_probe_phase_end()
            elif self._local_join == "sort-merge":
                # the sort subsumes the build: one local-join step
                timer.set_build_phase_begin()
                timer.set_build_phase_end()
                timer.set_probe_phase_begin()
                count = int(_sort_merge_local_count(
                    self._mesh, rk_a, rv_a, rk_b, rv_b, table_b.keys,
                    is_hot_b, hot_keys, hot_valid, hk, hv, use_hot,
                ))
                timer.set_probe_phase_end()
            else:
                table_size = ht.table_size_for(s * cap_a)
                timer.set_build_phase_begin()
                slot_keys, slot_rows, max_probes = _build_local_tables(
                    self._mesh, rk_a, rv_a, self._bucket_seed, table_size
                )
                sync(slot_rows.device)
                timer.set_build_phase_end()

                timer.set_probe_phase_begin()
                count = int(_probe_and_count(
                    self._mesh, slot_keys, slot_rows, max_probes,
                    self._bucket_seed, rk_b, rv_b, table_b.keys, is_hot_b,
                    hot_keys, hot_valid, hk, hv, use_hot,
                ))
                timer.set_probe_phase_end()
            return count

        count = self._exchange_with_retries(
            table_a.keys, table_a.payloads, table_b.keys, table_b.payloads,
            hot_keys, hot_valid, valid_a, valid_b, run, count_exchanged,
            "shuffle buckets", timer=timer,
            cap_b_multiple=self._pipeline_chunks, exchange_b=not pipelined,
        )
        self._logger.info("Number of joined tuples: %d", count)
        self._logger.info("Shuffle run: %s", run)
        return count

    def _run_single_shard(self, table_a, table_b, timer, valid_a, valid_b) -> int:
        """The S = 1 fast path: int32 keys through the two-run count (K1),
        int64 keys through K3, masked int64 keys through
        ``sort_merge_count``."""
        from partitionedhashjoin_tpu_torch.ops.sort_merge import sort_merge_count

        timer.set_partitioning_phase_begin()
        timer.set_partitioning_phase_end()
        timer.set_build_phase_begin()
        timer.set_build_phase_end()
        timer.set_probe_phase_begin()
        i64 = table_a.keys.dtype in _WIDE or table_b.keys.dtype in _WIDE
        if not i64:
            count = merge_join.two_run_count(
                table_a.keys, table_b.keys,
                build_valid=valid_a, probe_valid=valid_b,
            )
        elif valid_a is None and valid_b is None:
            count = merge_join.two_run_count_i64(table_a.keys, table_b.keys)
        else:
            count = sort_merge_count(
                table_a.keys, table_b.keys,
                build_valid=valid_a, probe_valid=valid_b,
            )
        count = int(count)
        timer.set_probe_phase_end()
        self.last_run = ShuffleRun(num_shards=1, drops=[], cap_a=0, cap_b=0,
                                   hot_cap=0, hot_keys=[])
        self._logger.info("Number of joined tuples: %d", count)
        return count
