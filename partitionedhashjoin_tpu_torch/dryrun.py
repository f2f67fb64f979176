"""Dry-run entry points: the single-device join, the one-process mesh, and
the shuffle join, the distributed operators and R6 across processes.

Counterpart of the JAX repository's ``__graft_entry__.py`` and of its
multi-process worker ``tests/mp_worker.py``:

- ``entry()``: the single-device program, the sort-merge count join, with
  example arguments;
- ``dryrun_multichip(n)``: every distributed operator once on an n-shard
  mesh of one device (hash exchange by ``all_to_all``, hot-key replication
  by ``all_gather``, per-shard joins, the ``psum`` count, the distributed
  GROUP BY, top-k, join -> GROUP BY, materializing join and SQL over the
  mesh), each against its count oracle;
- ``dryrun_multiprocess(n_processes, shards_per_process)``: spawns the
  worker below in ``n_processes`` processes joined by ``torch.distributed``.

Run as a module:

- ``python -m partitionedhashjoin_tpu_torch.dryrun [--platform cpu]``: the
  entry and ``dryrun_multichip(8)``;
- ``python -m partitionedhashjoin_tpu_torch.dryrun worker COORD N PID``: one
  process of ``dryrun_multiprocess``: bootstrap, per-process slices, the
  global shuffle join, three count oracles; prints ``MP_OK pid=...``;
- ``python -m partitionedhashjoin_tpu_torch.dryrun measure COORD N PID``:
  one process of a measured shuffle join at the CLI's workload (default 10M
  ⋈ 200M, 8 shards): every process generates the CLI's relations from one
  seed and keeps its ``host_slice``, then runs the sort-merge join, the
  hash local join and ``pipeline_chunks=4``, each once untimed and once
  timed, and prints one ``MP_STEP {json}`` line per step: the count, the
  ``ShuffleRun``, host and device ms, the cross-process collectives' ms and
  bytes, peak allocated bytes, the backend and the K1/K7 launches of the
  timed run;
- ``python -m partitionedhashjoin_tpu_torch.dryrun ops COORD N PID``: one
  process of the distributed operators and R6 over ``N`` processes at the
  pipeline's relations (``bench_pipeline.make_relations``, default 10M ⋈
  200M, 8 shards): every process draws the whole relations and keeps its
  ``host_slice``, then runs each step of ``ops_steps`` once untimed and
  once timed, and prints one ``MP_OPS {json}`` line per step: the
  ``digest`` of its result and its ``last_run``, host and device ms, the
  cross-process collectives' ms and bytes by collective, peak allocated
  bytes and each kernel's launches in the timed run.

Entry points run on the card unless the caller names the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

PKG = "partitionedhashjoin_tpu_torch"


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def entry(device: Optional[str] = None):
    """(fn, example_args): the single-device join step, the sort-merge count
    join (ops/sort_merge.py), on ``device`` ("cuda" when None)."""
    from partitionedhashjoin_tpu_torch.ops.sort_merge import SortMergeJoiner
    from partitionedhashjoin_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device or "cuda")

    def join_count(keys_a, keys_b):
        return SortMergeJoiner.count(keys_a, keys_b)

    keys_a = torch.arange(1, 4097, dtype=torch.int32, device=dev)
    keys_b = torch.ones((16384,), dtype=torch.int32, device=dev)
    return join_count, (keys_a, keys_b)


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> None:
    """One full distributed step of every operator on an ``n_devices``-shard
    mesh whose shards share ``device`` ("cuda" when None): row-sharded
    inputs, the hash-partitioned exchange with hot-key replication, the
    pipelined exchange, the distributed GROUP BY, top-k (also masked), join
    -> GROUP BY, the materializing join with a pushed-down probe filter, the
    masked count join and SQL over the mesh, each against its oracle."""
    from partitionedhashjoin_tpu_torch.data.table import make_table
    from partitionedhashjoin_tpu_torch.parallel.aggregate_shuffle import (
        DistributedAggregateOperator,
    )
    from partitionedhashjoin_tpu_torch.parallel.join_aggregate import (
        DistributedJoinAggregateOperator,
    )
    from partitionedhashjoin_tpu_torch.parallel.materialize_shuffle import (
        DistributedMaterializeJoiner,
    )
    from partitionedhashjoin_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_array,
        shard_table,
    )
    from partitionedhashjoin_tpu_torch.parallel.shuffle import DistributedShuffleJoiner
    from partitionedhashjoin_tpu_torch.parallel.top_k import distributed_top_k
    from partitionedhashjoin_tpu_torch.sql import execute_sql
    from partitionedhashjoin_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device or "cuda")
    mesh = make_mesh(n_devices, devices=[dev])
    n_a, n_b = 64 * n_devices, 256 * n_devices
    a = make_table(torch.arange(1, n_a + 1, dtype=torch.int32),
                   torch.arange(n_a, dtype=torch.int32))
    rng = np.random.default_rng(0)
    b_keys = rng.integers(1, n_a + 1, n_b).astype(np.int32)
    b = make_table(torch.from_numpy(b_keys), torch.arange(n_b, dtype=torch.int32))
    a_sh, b_sh = shard_table(a, mesh), shard_table(b, mesh)
    # one-shot exchange + heavy-hitter replication + psum count
    joiner = DistributedShuffleJoiner(mesh, seed=42, handle_skew=True)
    count = joiner.run(a_sh, b_sh)
    _check(count == n_b, f"dryrun count {count} != {n_b}")
    # chunked exchange, each chunk counted by the local joins
    pipelined = DistributedShuffleJoiner(mesh, seed=42, handle_skew=True,
                                         pipeline_chunks=2)
    count = pipelined.run(a_sh, b_sh)
    _check(count == n_b, f"pipelined dryrun count {count} != {n_b}")
    # distributed GROUP BY (combiner + partial exchange + merge)
    g = DistributedAggregateOperator(mesh, seed=42).run(b_sh)
    expected = len(set(b_keys.tolist()))
    _check(int(g.num_groups) == expected, f"dryrun groups {int(g.num_groups)} != {expected}")
    _check(int(g.count.to(torch.int64).sum()) == n_b, "dryrun group counts")
    # distributed ORDER BY ... LIMIT (local top-k, all_gather, final top-k)
    t, _ = distributed_top_k(mesh, b_sh, 4, by="key", descending=True)
    want_top = sorted(b_keys.tolist(), reverse=True)[:4]
    _check(t.keys.tolist() == want_top, f"dryrun top-k {t.keys.tolist()} != {want_top}")
    # distributed join -> GROUP BY
    jg = DistributedJoinAggregateOperator(mesh, seed=42).run(a_sh, b_sh)
    _check(int(jg.num_groups) == expected,
           f"dryrun join-agg groups {int(jg.num_groups)} != {expected}")
    _check(int(jg.count.to(torch.int64).sum()) == n_b, "dryrun join-agg counts")
    # distributed materializing join with a pushed-down probe filter, and the
    # filter-masked exchange on the count join
    vb = shard_array(torch.from_numpy(np.arange(n_b) % 2 == 0), mesh)
    jt = DistributedMaterializeJoiner(mesh, seed=42).run(a_sh, b_sh, "inner",
                                                         probe_valid=vb)
    _check(int(jt.count) == n_b // 2, f"dryrun materialize count {int(jt.count)}")
    fcount = joiner.run(a_sh, b_sh, valid_b=vb)
    _check(fcount == n_b // 2, f"dryrun masked count {fcount}")
    # masked distributed top-k (validity-dominant selection)
    keep = np.arange(n_b) % 4 == 0
    tk, n_live = distributed_top_k(mesh, b_sh, 4, by="key", descending=True,
                                   mask=shard_array(torch.from_numpy(keep), mesh))
    want_m = sorted(b_keys[keep].tolist(), reverse=True)[:4]
    _check(tk.keys.tolist() == want_m and int(n_live) == 4,
           f"masked top-k {tk.keys.tolist()}")
    # SQL over the mesh: lowers onto the distributed shuffle join (R6)
    r = execute_sql("SELECT COUNT(*) FROM b JOIN a USING (key)",
                    tables={"a": a_sh, "b": b_sh}, mesh=mesh)
    _check(int(r.columns["count"][0]) == n_b, f"sql mesh count {r.columns}")


def free_coordinator() -> str:
    """A "127.0.0.1:port" address on a port free at the time of the call."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def run_processes(commands: Sequence[Sequence[str]], timeout_s: float,
                  env=None, cwd=None) -> List[Tuple[int, str, str]]:
    """Run ``commands`` together; returns each one's (exit code, stdout,
    stderr).  When one exits non-zero, or ``timeout_s`` passes first, the
    others are killed and ``RuntimeError`` carries every output's tail."""
    procs = [subprocess.Popen(list(c), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=cwd) for c in commands]
    failed = None
    with ThreadPoolExecutor(len(procs)) as pool:
        futures = [pool.submit(p.communicate) for p in procs]
        pending = set(futures)
        deadline = time.monotonic() + timeout_s
        while pending and failed is None:
            done, pending = wait(pending, timeout=max(0.0, deadline - time.monotonic()),
                                 return_when=FIRST_COMPLETED)
            if not done:
                failed = f"timed out after {timeout_s:.0f} s"
            elif any(procs[futures.index(f)].returncode for f in done):
                failed = "a process failed"
        if failed is not None:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        outs = [f.result() for f in futures]
    results = [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]
    if failed is not None:
        tails = "\n".join(f"--- process {i}: exit {rc}\n{o[-3000:]}\n{e[-3000:]}"
                          for i, (rc, o, e) in enumerate(results))
        raise RuntimeError(f"{failed}:\n{tails}")
    return results


def dryrun_multiprocess(n_processes: int = 2, shards_per_process: int = 4,
                        platform: Optional[str] = None,
                        timeout_s: float = 560.0, env=None) -> List[str]:
    """Multi-process dry run: ``n_processes`` separate processes, each
    running ``worker`` (``python -m partitionedhashjoin_tpu_torch.dryrun
    worker``) on ``platform`` ("cuda" when None) with ``shards_per_process``
    shards, in ``env`` (this process's environment when None) with the
    package on ``PYTHONPATH``.  Raises unless every process exits 0 and
    prints its ``MP_OK`` line; returns those lines."""
    coord = free_coordinator()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH", "")) if p)
    extra = ["--platform", platform or "cuda",
             "--shards-per-process", str(shards_per_process)]
    results = run_processes(
        [[sys.executable, "-m", f"{PKG}.dryrun", "worker", coord, str(n_processes),
          str(i), *extra] for i in range(n_processes)], timeout_s, env=env, cwd=repo)
    lines = []
    for i, (_, out, err) in enumerate(results):
        ok = [line for line in out.splitlines() if line.startswith(f"MP_OK pid={i} ")]
        if not ok:
            raise RuntimeError(f"multiprocess dryrun worker {i} printed no MP_OK:\n"
                               f"{out}\n{err[-3000:]}")
        lines.append(ok[0])
    return lines


def worker(coord: str, nproc: int, pid: int, platform: str,
           shards_per_process: int) -> str:
    """One process of ``dryrun_multiprocess`` (the JAX repository's
    tests/mp_worker.py): three count oracles on the global mesh."""
    from partitionedhashjoin_tpu_torch.parallel import distributed
    from partitionedhashjoin_tpu_torch.parallel.shuffle import DistributedShuffleJoiner

    distributed.initialize(coord, nproc, pid, platform=platform)
    try:
        mesh = distributed.global_mesh(nproc * shards_per_process)
        _check(mesh.process_count == nproc, f"{mesh.process_count} processes")
        # oracle 1 (non-trivial intersection): A = all even keys in [0, 8192),
        # from per-process slices; B = 0..8191 -> exactly half match
        a_start, a_rows = distributed.host_slice(4096)
        keys_a = np.arange(a_start, a_start + a_rows, dtype=np.int32) * 2
        pays_a = np.arange(a_start, a_start + a_rows, dtype=np.int32)
        b_start, b_rows = distributed.host_slice(8192)
        keys_b = np.arange(b_start, b_start + b_rows, dtype=np.int32)
        table_a = distributed.make_global_table(keys_a, pays_a, mesh)
        table_b = distributed.make_global_table(keys_b, keys_b, mesh)
        count = DistributedShuffleJoiner(mesh, seed=3).run(table_a, table_b)
        _check(count == 4096, f"even-key oracle: got {count}")
        # oracle 2 (generated benchmark shape): the sequential primary covers
        # the Zipf domain, so every secondary row matches
        ta, tb = distributed.generate_global_tables(1024, 4096, 1.05, mesh, seed=11)
        c2 = DistributedShuffleJoiner(mesh, seed=5).run(ta, tb)
        _check(c2 == 4096, f"zipf oracle: got {c2}")
        # oracle 3: the pipelined exchange agrees with the one-shot exchange
        c3 = DistributedShuffleJoiner(mesh, seed=7, pipeline_chunks=2).run(ta, tb)
        _check(c3 == 4096, f"pipelined oracle: got {c3}")
        backend = mesh.backend
    finally:
        distributed.shutdown()
    return f"MP_OK pid={pid} counts={count},{c2},{c3} backend={backend}"


#: The steps of ``measure``: a name and the joiner's options.
MEASURE_STEPS = (
    ("sort-merge", {}),
    ("local_join=hash", {"local_join": "hash"}),
    ("pipeline_chunks=4", {"pipeline_chunks": 4}),
)


def _launches():
    from partitionedhashjoin_tpu_torch.ops.kernels import generate as kg
    from partitionedhashjoin_tpu_torch.ops.kernels import merge_probe as mp

    return mp, kg


def measure(coord: str, nproc: int, pid: int, platform: str, shards: int,
            primary: int, secondary: int, skew: float, seed: int) -> List[dict]:
    """One process of a measured shuffle join over ``nproc`` processes (see
    the module docstring); returns the ``MP_STEP`` records it printed."""
    from partitionedhashjoin_tpu_torch import cli
    from partitionedhashjoin_tpu_torch.data.table import make_table
    from partitionedhashjoin_tpu_torch.parallel import distributed
    from partitionedhashjoin_tpu_torch.parallel.shuffle import DistributedShuffleJoiner
    from partitionedhashjoin_tpu_torch.utils import logger as logging_utils
    from partitionedhashjoin_tpu_torch.utils.device import sync

    distributed.initialize(coord, nproc, pid, platform=platform)
    records = []
    try:
        mesh = distributed.global_mesh(shards)
        device = mesh.device
        on_card = device.type == "cuda"
        # the CLI's relations, drawn whole from one seed in every process;
        # each keeps its slice
        config, _ = cli.parse_arguments([
            "--primary", str(primary), "--secondary", str(secondary),
            "--skew", str(skew), "--seed", str(seed), "--platform", device.type])
        full_a, full_b = cli.generate_tables(
            config, logging_utils.get_new_logger("Main"), device)
        tables = []
        for full in (full_a, full_b):
            start, rows = distributed.host_slice(full.size)
            tables.append(make_table(full.keys[start:start + rows].clone(),
                                     full.payloads[start:start + rows].clone()))
        del full_a, full_b, full
        if on_card:
            torch.cuda.empty_cache()
        mp, kg = _launches()
        for name, options in MEASURE_STEPS:
            count = DistributedShuffleJoiner(mesh, seed=seed, **options).run(*tables)
            _check(count == secondary, f"{name} warm-up count {count}")
            joiner = DistributedShuffleJoiner(mesh, seed=seed, **options)
            sync(device)
            if on_card:
                torch.cuda.reset_peak_memory_stats()
                start_ev, end_ev = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            mesh.comm.reset()
            mp.LAUNCHES = kg.LAUNCHES_HASH = 0
            t0 = time.perf_counter()
            if on_card:
                start_ev.record()
            count = joiner.run(*tables)
            if on_card:
                end_ev.record()
            sync(device)
            host_ms = (time.perf_counter() - t0) * 1e3
            run = joiner.last_run
            record = {
                "step": name, "pid": pid, "processes": nproc, "count": count,
                "host_ms": host_ms,
                "device_ms": start_ev.elapsed_time(end_ev) if on_card else None,
                "comm_ms": mesh.comm.seconds * 1e3,
                "comm_bytes": mesh.comm.bytes_sent,
                "comm_sent": mesh.comm.sent,
                "comm_calls": mesh.comm.calls,
                "peak_bytes": torch.cuda.max_memory_allocated() if on_card else None,
                "backend": mesh.backend, "device": str(device),
                "launches": {"k1": mp.LAUNCHES, "k7": kg.LAUNCHES_HASH},
                "run": {"num_shards": run.num_shards, "local_shards": run.local_shards,
                        "drops": [list(d) for d in run.drops], "cap_a": run.cap_a,
                        "cap_b": run.cap_b, "hot_cap": run.hot_cap,
                        "hot_keys": run.hot_keys, "exchange_slots": run.exchange_slots,
                        "cross_process_bytes": run.cross_process_bytes},
            }
            print("MP_STEP " + json.dumps(record), flush=True)
            records.append(record)
    finally:
        distributed.shutdown()
    return records


#: The statements of the R6 steps (``chip_smoke.py`` phases 12 and 15).
SQL_PIPELINE = (
    "SELECT key, COUNT(*), SUM(b.payload), MIN(b.payload), MAX(b.payload) "
    "FROM b JOIN a USING (key) GROUP BY key ORDER BY count DESC LIMIT 10")
SQL_COUNT = "SELECT COUNT(*) FROM b JOIN a USING (key)"
#: The composite key's second column is the key XOR this salt.
SALT = 0x5A17


def ops_steps(mesh, rel, seed: int, group_capacity: Optional[int]):
    """The steps of the distributed operators and R6 on ``mesh``, as
    ``(name, run)`` pairs; ``run()`` returns ``(result, last_run or
    None)``.  ``rel`` is ``(a_keys, a_pay, b_keys, b_pay)``, the rows of
    this process (all of them on one process): (a) the GROUP BY of B, plain,
    masked (``b_pay % 2 == 0``) and with COUNT DISTINCT; (b) top-10 by key
    and by payload, each also masked; (c) the join → GROUP BY, with and
    without the skew plan; (d) the inner, anti and left materializing joins
    and the semi join under the mask; (e) the composite key (key, key ^
    SALT) and the keys widened to int64; (f) the pipeline statement and the
    count join through ``execute_sql`` with ``mesh=``.  The same calls on
    one process and on several give equal results (``digest``)."""
    from partitionedhashjoin_tpu_torch.data.table import make_table
    from partitionedhashjoin_tpu_torch.parallel.aggregate_shuffle import (
        DistributedAggregateOperator,
    )
    from partitionedhashjoin_tpu_torch.parallel.join_aggregate import (
        DistributedJoinAggregateOperator,
    )
    from partitionedhashjoin_tpu_torch.parallel.materialize_shuffle import (
        DistributedMaterializeJoiner,
    )
    from partitionedhashjoin_tpu_torch.parallel.multi_key_shuffle import (
        MultiKeyShuffleJoiner,
    )
    from partitionedhashjoin_tpu_torch.parallel.top_k import distributed_top_k
    from partitionedhashjoin_tpu_torch.sql import execute_sql

    a_keys, a_pay, b_keys, b_pay = rel
    a, b = make_table(a_keys, a_pay), make_table(b_keys, b_pay)
    even = (b_pay % 2) == 0
    db = {"a": a, "b": b}

    def operator(cls, method, *args, **kw):
        def run():
            op = cls(mesh, seed=seed, **kw)
            return getattr(op, method)(*args), op.last_run
        return run

    def aggregate(**kw):
        def run():
            op = DistributedAggregateOperator(mesh, seed=seed)
            return op.run(b, group_capacity=group_capacity, **kw), op.last_run
        return run

    def join_aggregate(**kw):
        def run():
            op = DistributedJoinAggregateOperator(mesh, seed=seed, **kw)
            return op.run(a, b, group_capacity=group_capacity), op.last_run
        return run

    def materialize(jt, probe_valid=None):
        def run():
            op = DistributedMaterializeJoiner(mesh, seed=seed)
            return op.run(a, b, jt, probe_valid=probe_valid), op.last_run
        return run

    def top_k(by, mask):
        return lambda: (distributed_top_k(mesh, b, 10, by=by, mask=mask), None)

    def sql(stmt, **kw):
        return lambda: (execute_sql(stmt, db, mesh=mesh, **kw), None)

    return [
        ("(a) aggregate", aggregate()),
        ("(a) aggregate mask", aggregate(mask=even)),
        ("(a) aggregate distinct", aggregate(with_distinct=True)),
        ("(b) top_k key", top_k("key", None)),
        ("(b) top_k key mask", top_k("key", even)),
        ("(b) top_k payload", top_k("payload", None)),
        ("(b) top_k payload mask", top_k("payload", even)),
        ("(c) join_aggregate", join_aggregate()),
        ("(c) join_aggregate handle_skew=False", join_aggregate(handle_skew=False)),
        ("(d) materialize inner", materialize("inner")),
        ("(d) materialize anti", materialize("anti")),
        ("(d) materialize left", materialize("left")),
        ("(d) materialize semi mask", materialize("semi", even)),
        ("(e) multi_key run", operator(MultiKeyShuffleJoiner, "run",
                                        [a_keys, a_keys ^ SALT], [b_keys, b_keys ^ SALT])),
        ("(e) multi_key run_i64", operator(MultiKeyShuffleJoiner, "run_i64",
                                            a_keys.to(torch.int64), b_keys.to(torch.int64))),
        ("(f) sql pipeline", sql(SQL_PIPELINE, group_capacity=group_capacity)),
        ("(f) sql count", sql(SQL_COUNT)),
    ]


#: Fields a digest leaves out: a GROUP BY's ``group_of_row`` has this
#: process's rows, and a table's ``uuid`` names nothing computed.
_NOT_DIGESTED = ("group_of_row", "uuid")
_MIX = (0x9E3779B97F4A7C15 - (1 << 64), 0xBF58476D1CE4E5B9 - (1 << 64))
_CHUNK = 1 << 26


def _tensor_digest(t: torch.Tensor) -> str:
    """dtype, shape and a 64-bit sum over the elements, each mixed with its
    position (int64 arithmetic wraps), computed where ``t`` lives, in
    chunks."""
    x = t.reshape(-1)
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    total = 0
    for start in range(0, x.numel(), _CHUNK):
        c = x[start:start + _CHUNK].to(torch.int64)
        i = torch.arange(start, start + c.numel(), dtype=torch.int64, device=c.device)
        h = (c ^ (i * _MIX[0])) * _MIX[1]
        total += int((h ^ (h >> 31)).sum())
    name = str(t.dtype).removeprefix("torch.")
    return f"{name}{list(t.shape)}:{total & ((1 << 64) - 1):016x}"


def digest(obj):
    """A JSON-able digest of an operator's result: every tensor or array
    by ``_tensor_digest``, numbers as they are, containers and dataclasses
    field by field (without ``_NOT_DIGESTED``); equal results give equal
    digests."""
    if isinstance(obj, torch.Tensor):
        return _tensor_digest(obj)
    if isinstance(obj, np.ndarray):
        return _tensor_digest(torch.from_numpy(np.ascontiguousarray(obj)))
    if isinstance(obj, (list, tuple)):
        return [digest(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): digest(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return {f.name: digest(getattr(obj, f.name)) for f in dataclasses.fields(obj)
                if f.name not in _NOT_DIGESTED}
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _launch_counters():
    """Each kernel's launch counters, ``(wrapper module, name)`` pairs, by
    kernel id (K6 launches two kernels)."""
    from partitionedhashjoin_tpu_torch.ops.kernels import bitonic_sort as bs
    from partitionedhashjoin_tpu_torch.ops.kernels import compact as kc
    from partitionedhashjoin_tpu_torch.ops.kernels import generate as kg
    from partitionedhashjoin_tpu_torch.ops.kernels import merge_count as mc
    from partitionedhashjoin_tpu_torch.ops.kernels import merge_payload as mpay
    from partitionedhashjoin_tpu_torch.ops.kernels import merge_probe as mp

    return {"k1": [(mp, "LAUNCHES")], "k2": [(mc, "LAUNCHES")],
            "k3": [(mp, "LAUNCHES_I64")], "k4": [(mpay, "LAUNCHES")],
            "k5": [(kc, "LAUNCHES")],
            "k6": [(bs, "LAUNCHES_UPSWEEP"), (bs, "LAUNCHES_SORT")],
            "k7": [(kg, "LAUNCHES_HASH")], "k8": [(kg, "LAUNCHES_ZIPF")]}


def ops(coord: str, nproc: int, pid: int, platform: str, shards: int, primary: int,
        secondary: int, seed: int, group_capacity: Optional[int],
        steps: Optional[Sequence[str]] = None) -> List[dict]:
    """One process of the distributed operators and R6 over ``nproc``
    processes (see the module docstring); ``steps`` names a subset of
    ``ops_steps``.  Returns the ``MP_OPS`` records it printed."""
    from partitionedhashjoin_tpu_torch import bench_pipeline
    from partitionedhashjoin_tpu_torch.parallel import distributed
    from partitionedhashjoin_tpu_torch.utils.device import sync

    distributed.initialize(coord, nproc, pid, platform=platform)
    records = []
    try:
        mesh = distributed.global_mesh(shards)
        device = mesh.device
        on_card = device.type == "cuda"
        rel = []
        for col in bench_pipeline.make_relations(primary, secondary, device):
            start, rows = distributed.host_slice(col.shape[0])
            rel.append(col[start:start + rows].clone())
            del col
        if on_card:
            torch.cuda.empty_cache()
        counters = _launch_counters()
        for name, run in ops_steps(mesh, rel, seed, group_capacity):
            if steps is not None and name not in steps:
                continue
            out, _ = run()
            del out
            sync(device)
            if on_card:
                torch.cuda.reset_peak_memory_stats()
                start_ev, end_ev = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            mesh.comm.reset()
            for pairs in counters.values():
                for module, attr in pairs:
                    setattr(module, attr, 0)
            t0 = time.perf_counter()
            if on_card:
                start_ev.record()
            out, last_run = run()
            if on_card:
                end_ev.record()
            sync(device)
            host_ms = (time.perf_counter() - t0) * 1e3
            record = {
                "step": name, "pid": pid, "processes": nproc, "shards": mesh.size,
                "digest": digest(out), "run": digest(last_run),
                "host_ms": host_ms,
                "device_ms": start_ev.elapsed_time(end_ev) if on_card else None,
                "comm_ms": mesh.comm.seconds * 1e3, "comm_bytes": mesh.comm.bytes_sent,
                "comm_sent": dict(mesh.comm.sent), "comm_calls": mesh.comm.calls,
                "peak_bytes": torch.cuda.max_memory_allocated() if on_card else None,
                "backend": mesh.backend, "device": str(device),
                "launches": {k: sum(getattr(m, a) for m, a in pairs)
                             for k, pairs in counters.items()},
            }
            del out
            print("MP_OPS " + json.dumps(record), flush=True)
            records.append(record)
    finally:
        distributed.shutdown()
    return records


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"python -m {PKG}.dryrun")
    p.add_argument("--platform", default="cuda", help="'cuda' (default) or 'cpu'")
    sub = p.add_subparsers(dest="command")
    for name in ("worker", "measure", "ops"):
        s = sub.add_parser(name)
        s.add_argument("coordinator")
        s.add_argument("num_processes", type=int)
        s.add_argument("process_id", type=int)
        s.add_argument("--platform", default=argparse.SUPPRESS,
                       help="'cuda' (default) or 'cpu'")
    sub.choices["worker"].add_argument("--shards-per-process", type=int, default=4)
    m = sub.choices["measure"]
    m.add_argument("--shards", type=int, default=8)
    m.add_argument("--primary", type=int, default=10_000_000)
    m.add_argument("--secondary", type=int, default=200_000_000)
    m.add_argument("--skew", type=float, default=1.05)
    m.add_argument("--seed", type=int, default=20260816)
    o = sub.choices["ops"]
    o.add_argument("--shards", type=int, default=8)
    o.add_argument("--primary", type=int, default=10_000_000)
    o.add_argument("--secondary", type=int, default=200_000_000)
    o.add_argument("--seed", type=int, default=20260816)
    o.add_argument("--group-capacity", type=int, default=1 << 24)
    o.add_argument("--steps", nargs="*", default=None,
                   help="names of ops_steps to run (default: every step)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if args.command == "worker":
        print(worker(args.coordinator, args.num_processes, args.process_id,
                     args.platform, args.shards_per_process), flush=True)
    elif args.command == "measure":
        measure(args.coordinator, args.num_processes, args.process_id, args.platform,
                args.shards, args.primary, args.secondary, args.skew, args.seed)
        print(f"MP_OK pid={args.process_id}", flush=True)
    elif args.command == "ops":
        ops(args.coordinator, args.num_processes, args.process_id, args.platform,
            args.shards, args.primary, args.secondary, args.seed, args.group_capacity,
            args.steps)
        print(f"MP_OK pid={args.process_id}", flush=True)
    else:
        fn, fn_args = entry(args.platform)
        print("entry:", int(fn(*fn_args)))
        dryrun_multichip(8, args.platform)
        print("dryrun_multichip OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
