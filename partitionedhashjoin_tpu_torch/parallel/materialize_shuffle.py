"""Distributed materializing join over a mesh of shards.

Counterpart of ``partitionedhashjoin_tpu/parallel/materialize_shuffle.py``:
the scale-out of the typed materializer (``ops/sort_merge._materialize_typed``)
on the shuffle join's exchange.  Each probe-side variant (inner, semi, anti,
left) is exact as a union of per-shard joins:

- a **cold** key's build and probe rows both route by that key, so they all
  land on its one owner shard, which decides each probe row with every
  build row of the key in view, once;
- a **hot** key's build rows are replicated to every shard and its probe
  rows stay local, so each hot probe row is decided once, against the
  whole (replicated) build set;
- the cross terms are empty: the hot set is a key set, so a cold probe row's
  key has no hot build row and the other way round.

``full`` cannot ride this plan (an unmatched replicated build row is
unmatched on every shard that holds none of its probe rows), so it raises
``ValueError``, as in JAX; the query layer keeps it on one device.

Output: each shard materializes into a pool of its received probe slots
plus its local rows (every probe-side variant emits at most one row per
probe row, so the pool cannot overflow); the pools are gathered and
compacted into one prefix-compacted ``JoinedTable`` of S·pool rows: K5 on
the card (``ops/kernels/compact.compact_rows``), its plain version on a CPU
tensor.  It equals the single-device materializer as a multiset of rows.
Row order differs: the rows come in shard order, and a shard's rows in the
order of its pool (received slots in source order, then local rows).  The
per-shard joins choose the LATEST valid build row of a key, and a key's
build rows reach its owner in row order (``_bucketize`` is stable), so
``payloads_a`` is the single-device materializer's even with duplicate build
keys.

Exactness: the exchange's three overflow counters (cold a, cold b, hot
replication) grow their capacity and retry.  Filters (``build_valid`` /
``probe_valid``) push into the exchange, and the received-slot masks feed the
typed materializer, so the variants under filters match the single-device
masked materializer row for row.

On a mesh over several processes every process passes its own rows of both
relations (``host_slice``'s layout, the same counts in every process) and
gets the whole joined table, replicated: each process's pools are cut to
the longest shard's rows (``pmax``) and gathered before the compaction
(``mesh.gather_prefixes``), so the rows, their order,
``count`` and ``matched`` are one process's bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from partitionedhashjoin_tpu_torch.data.table import JoinedTable, Table, make_table
from partitionedhashjoin_tpu_torch.ops.sort_merge import _materialize_typed
from partitionedhashjoin_tpu_torch.parallel.mesh import Mesh, gather_prefixes
from partitionedhashjoin_tpu_torch.parallel.shuffle import ExchangeRun, _ExchangeOperator


def _materialize_local(
    mesh: Mesh,
    rk_a, rp_a, rv_a,
    rk_b, rp_b, rv_b,
    keys_b, pays_b, is_hot_b,
    hk, hp, hv,
    join_type: str,
):
    """Per-shard union materialize into pools of the received probe slots
    plus the local rows.

    Returns ``(counts, keys, pay_a, pay_b, matched)``: each local shard's
    row count (``(local_size,)``) and its pool's columns, each
    ``(local_size, pool)`` int32 (``matched`` as 0/1), the first
    ``counts[i]`` rows of row ``i`` valid."""
    lsz = mesh.local_size
    device = rk_a.device
    rka, rpa, rva, rkb, rpb, rvb = (
        x.reshape(lsz, -1) for x in (rk_a, rp_a, rv_a, rk_b, rp_b, rv_b))
    kb, pb, ihb = (x.reshape(lsz, -1) for x in (keys_b, pays_b, is_hot_b))
    pool = rkb.shape[1] + kb.shape[1]
    cols = [torch.empty((lsz, pool), dtype=torch.int32, device=device)
            for _ in range(4)]
    counts = []
    for i in range(lsz):
        out = _materialize_typed(
            torch.cat([rka[i], hk]), torch.cat([rpa[i], hp]),
            torch.cat([rkb[i], kb[i]]), torch.cat([rpb[i], pb[i]]), join_type,
            build_valid=torch.cat([rva[i], hv]),
            probe_valid=torch.cat([rvb[i], ihb[i]]),
        )
        for dst, src in zip(cols, out[:4]):
            dst[i].copy_(src)
        counts.append(out[4])
        del out
    return (torch.stack(counts), *cols)


class DistributedMaterializeJoiner(_ExchangeOperator):
    """Mesh-parallel materializing joiner.

    ``run(build, probe, join_type)`` returns a prefix-compacted
    ``JoinedTable`` on the mesh's device, equal as a row multiset to the
    single-device ``sort_merge_materialize_typed``.  Shares the shuffle
    join's exchange knobs and exactness contract; ``last_run`` records each
    attempt's drops and the exchange bytes.
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
        max_retries: int = 5,
    ) -> None:
        super().__init__(mesh, seed, slack, handle_skew, hot_capacity, hot_sample,
                         hot_min_frac, max_retries, "DistributedMaterialize")
        self.last_run: Optional[ExchangeRun] = None

    def run(
        self,
        build: Table,
        probe: Table,
        join_type: str = "inner",
        build_valid=None,
        probe_valid=None,
    ) -> JoinedTable:
        if join_type not in ("inner", "semi", "anti", "left"):
            raise ValueError(
                f"distributed materialize supports inner/semi/anti/left; "
                f"{join_type!r} stays single-device (module docstring)"
            )
        for name, t in (("build", build), ("probe", probe)):
            if t.keys.dtype != torch.int32 or t.payloads.dtype != torch.int32:
                raise TypeError(
                    f"distributed materialize is int32-only ({name} keys "
                    f"{t.keys.dtype}, payloads {t.payloads.dtype})"
                )
        s = self._num_shards
        device = self._mesh.device
        ka, pa, kb, pb = (x.to(device) for x in (build.keys, build.payloads,
                                                 probe.keys, probe.payloads))
        va, vb = (None if v is None else torch.as_tensor(v).to(device)
                  for v in (build_valid, probe_valid))
        self._check_inputs(make_table(ka, pa), make_table(kb, pb), va, vb)
        hot_keys, hot_valid = self._hot_plan(kb)
        self.last_run = run = ExchangeRun(num_shards=s)

        def materialize_exchanged(exchanged, cap_a, cap_b):
            rk_a, rp_a, rv_a, rk_b, rp_b, rv_b, is_hot_b, hk, hp, hv, _ = exchanged
            exchanged.clear()
            counts, *pools = _materialize_local(
                self._mesh, rk_a, rp_a, rv_a, rk_b, rp_b, rv_b, kb, pb, is_hot_b,
                hk, hp, hv, join_type,
            )
            del rk_a, rp_a, rv_a, rk_b, rp_b, rv_b, is_hot_b
            # one stable compaction of the four columns (K5 on the card)
            keys, pay_a, pay_b, matched, count = gather_prefixes(
                self._mesh, counts, pools[0].shape[1], *pools)
            del pools
            matched = matched > 0
            self._logger.info("Number of joined tuples: %d", int(count))
            return JoinedTable(keys=keys, payloads_a=pay_a, payloads_b=pay_b,
                               count=count, matched=matched)

        return self._exchange_with_retries(
            ka, pa, kb, pb, hot_keys, hot_valid, va, vb, run,
            materialize_exchanged, "materialize exchange")
