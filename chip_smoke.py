#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It drives ``partitionedhashjoin_tpu_torch`` (never the JAX package) in phases
and raises on the first failure:

1. device  — needs ``torch.cuda.is_available()``; prints the card's name and
             power limit (nvidia-smi) and the torch / CUDA versions.
2. build   — builds every kernel library from ``csrc/`` with nvcc into
             ``build/kernels/``, one nvcc per source, and the host runtime
             library from ``native/phj_host.cpp`` with g++ into
             ``build/host/``, all started together; prints the build time
             and ptxas' report of each.
3. parity  — each kernel against its plain PyTorch version on the card,
             exactly, over edge cases and random runs of >= 1M rows:
             K1 (int32 merge-probe count, ``exclude_int32_max`` off and on;
             also the cases of its shared-memory merge: a build range of
             ~50 chunks, duplicate and INT32_MAX build runs across a chunk
             edge, empty ranges amid full tiles, tiles of one key, n_a = 1,
             a ragged last tile, a probe view off a 16-byte boundary; and
             a line with the main path's per-tile build-range lengths),
             K3 (int64 merge-probe count; also keys that differ only above
             bit 31 at a chunk edge), K2 (fused merge count; also rows in
             any order, a carry across 1,001 tiles, n = 1 and a tile +- 1,
             key and tag views off a 16-byte boundary), K4
             (merge-probe payload) and K5 (the one-pass stream compaction:
             densities 0, 0.01, 0.5 and 1, 1 to 6 columns, capacity
             overflow, ragged lengths, tile edges seen at each of the four
             byte alignments of ``keep``, one kept row per tile, n = 0).
             Then each is timed with CUDA events at the main path's shapes
             (10M ⋈ 200M; the 210M-row merged stream for K2; the 200M-row
             pass 2 of the pipeline's GROUP BY for K5, also at ~8M kept
             rows), beside its plain version, the
             nearest PyTorch call (``torch.isin(b, a).sum()`` for K1/K3,
             ``torch.searchsorted`` for K4, ``col[keep]`` for K5) and the
             sorts of the main path.  Then K6: the full tuple sort, a
             one-sweep LSD radix sort (1 to 4 operands, edge cases, random
             runs of >= 1M rows, runs of equal tuples longer than a tile,
             constant operands whose every digit is skipped, keys in
             [1, 10M], INT32_MIN/MAX-only operands, and 600,000,001 rows at
             k = 1 so that byte offsets pass 2^31, exactly), and its two
             phase counterparts, phase A K6a (the block-local radix sort:
             also eight edge blocks side by side, each with its own varying
             digits, and their views off a 16-byte boundary) and merge pass
             K6b; K6 on an int64 key (``sort_i64``, bit for bit against
             ``torch.sort``: keys over [1, 10M], Zipf keys, the full int64
             domain with INT64_MIN/MAX, one value, tile edges, a view off a
             16-byte boundary; its sweeps and skipped digits counted), timed
             at 210M Zipf keys over [1, 10M] and 200M full-domain keys; K7 (the
             seeded hash, bitwise) and
             K8 (the Zipf sampler: its uniforms bit for bit, at most 1e-4 of
             its keys off by at most 2, also with 1 round; with 0 rounds
             every key 1; the first m of 200M keys equal the m keys drawn
             alone; its bound from a round's SASS instructions by pipe and
             the rounds this seed needs), each timed at 200M rows beside its
             plain version, its bound and the library call where one exists
             (``torch.sort`` for a 1-operand sort, also over the main
             path's 200M Zipf probe keys, the packed int64
             ``sort_by_key_payload`` for 2 operands, the batched
             ``torch.sort(..., dim=1)`` over one row per block for K6a, at
             k = 1 and over the packed int64 (key, payload) at k = 2, and
             per pair of runs for K6b, each also checked equal to them).
             Last the chained-probe count kernel (no TPU counterpart) at
             every key-width pair against its plain version and
             ``torch.isin`` (misses, keys that differ only above bit 31, a
             chain of 4,096 entries, ``skip``, views off a 16-byte
             boundary), timed alone (median of 7, CUDA events) at 10M ⋈ 200M
             int64 Zipf(1.05) keys and 128M ⋈ 128M uniform unique int32 keys
             beside its bound, its plain version and the chain entries a row
             walks.  Then the chained build kernel (no TPU counterpart)
             against its plain version at both id widths (a long chain, wide
             gaps, ids past the table and below 0, ragged lengths, columns
             off a 16-byte boundary), timed alone at the chained cells'
             builds (10M int64 keys into 2^24 buckets, 128M int32 keys into
             2^27) beside its streamed bytes' bound, its plain version, the
             histogram steps it replaced and the key gather beside it.
4. library — at 10M ⋈ 200M: ``sort_merge_count`` and ``anti_count`` through
             K2, ``two_run_count_i64`` and an int64 ``PreparedBuild`` through
             K3, each exact.  Every key sort from here on is K6's, the
             engine's one sorter.
5. main    — ``cli.main`` at the reference workload (10M sequential build
             ⋈ 200M Zipf(1.05) probe drawn by the alias sampler, the CLI's
             rule up to 2^24 primary rows, with its warmup run) for the default
             join (no-partitioning), radix-partitioning, planned, sort-merge
             and sort-merge with int64 keys.  Each must count exactly
             200,000,000, print the JAX CLI's parameters, and launch its
             kernels: K1 or K3, and K6 (planned sorts no probe relation).

6. query   — at 10M ⋈ 200M with the probe payloads of
             ``scripts/bench_pipeline.py`` (uniform in [0, 2^20)):
             ``two_run_materialize`` (all match: keys equal to
             ``torch.sort`` of the probe keys, pay_a == key ^ 0x5A17, pay_b
             sum kept) and again with uniform probe keys
             over [1, 2·N_A] (half miss: K5 compacts the matches);
             ``SortMergeJoiner.run_materialize`` inner and anti;
             ``bench_pipeline.run_query`` for the ordered and the naive plan
             (equal on every group field, count 200,000,000, groups equal to
             a ``bincount`` / int64 ``scatter_add`` mod 2^32 oracle, and no
             more groups than keys the Zipf sampler can reach from float32
             uniforms); and
             ``filter_sort_aggregate_staged`` with ``(p & 1) == 0`` against
             ``filter_sort_aggregate``.  K4, K5 and K6 must launch.
7. (none: the sorter phase's checks are phases 5 and 6's, now that K6 is
             the one sorter.)
8. generate — ``hash_keys`` over the 200M probe keys (K7);
             ``zipf_keys_pallas`` draws 200M Zipf(1.05) keys over [1, 10M]
             on the card (K8), ``two_run_count`` against the 10M sequential
             build counts exactly 200,000,000; the TV distance of the 1,000
             hottest keys' frequencies from the exact pmf and the distinct
             keys reached are printed.
9. alias   — the host alias tables for Zipf(1.05) over [1, 10M] (host
             clock), 200M ``zipf_keys_alias`` draws timed with CUDA events,
             and the CLI's generation (``zipf_table(method="alias")``, seed
             20260816): its join with the sequential build counts
             200,000,000 (K1), and its distinct keys lie within ±0.5% of
             the exact law's sum of 1 - (1 - p_k)^n (7,949,313).
10. multi-key — ``multi_key_count`` at 10M ⋈ 200M on the keys of phase 9
             split as (key >> 12, key & 4095) (K6 and K3 on the packed
             pair) and (key >> 20, (key >> 10) & 1023, key & 1023); each
             equals the native ``host_join_count`` of the unsplit keys.
11. bench  — ``python -m partitionedhashjoin_tpu_torch.bench`` at 10M ⋈ 200M
             as a subprocess: exactly one JSON line with ``bench.py``'s keys
             plus ``device``; every algo counts 200,000,000 and launches K1
             in its measured run (read from its ``launches`` lines).
12. sql    — the SQL front end over the query layer at 10M ⋈ 200M: (a) the
             shell ``python -m partitionedhashjoin_tpu_torch.sql --table
             a=sequential:10000000 --table b=zipf:200000000:1.05:1:10000000
             "SELECT COUNT(*) FROM b JOIN a USING (key)"`` as a subprocess
             prints 200000000 (run through ``runpy``, which then reports
             K1's launches) and its ``--explain`` shows R1; on the
             pipeline's relations, (b) SELECT key, COUNT/SUM/MIN/MAX ... JOIN
             ... GROUP BY key ORDER BY count DESC LIMIT 10 through
             ``execute_sql`` equals ``bench_pipeline.run_query``'s top 10 and
             the phase-6 oracle, EXPLAIN R3 and R4, K6 and K4 launched; (c) the same
             with ``WHERE b.payload % 2 = 0`` takes R7 (K5, K4) and equals the
             oracle over the kept rows; (d) ``SELECT COUNT(*) FROM b ANTI
             JOIN a USING (key) WHERE a.key % 2 = 0`` equals the probe rows
             with an odd key, with ``torch.cummax`` refused, and its
             multiplicity scan is timed against a version that carries
             each run's start by ``torch.cummax`` (the JAX function's scan)
             on the same sort;
             (e) zero divisors and INT32_MIN // -1 through ``_compile_expr``
             on 1M card rows equal the CPU port bit for bit.
13. hash   — the hash-table layer at 10M ⋈ 200M on phase 12's relations
             (no new keys drawn): (a) ``NoPartitioningHashJoiner`` in mode
             "chained" and (b) ``RadixHashJoiner`` chained with 256
             partitions each count exactly 200,000,000 (with their phase
             times), and ``PHJ_BENCH_ALGOS=radix-chained python -m
             partitionedhashjoin_tpu_torch.bench`` prints its one JSON line;
             (c) ``run_materialize`` returns every probe row in probe order
             with payload key ^ 0x5A17; (d) ``hash_aggregate`` and
             ``filter_aggregate`` (payload % 2 == 0) equal
             ``sort_aggregate`` / ``filter_sort_aggregate`` in key order,
             their groups in first-row order; (e) ``build_hash_table`` over
             the 10M build keys, then ``probe_exists``, ``probe_get`` and
             ``probe_count_all`` over the 200M probe keys: all found, each
             row found holds its key, multiplicity 1.  Each step prints its
             host ms, its device ms between CUDA events, its peak allocated
             bytes and its K5/K7 launches and chained-probe launches
             (``LAUNCHES_CHAINED_COUNT`` and ``LAUNCHES_CHAINED_BUILD``: one
             each a count join in (a), (a2) and (b)); every hash runs on K7,
             (c)'s compaction on K5.

14. shuffle — the mesh and the distributed shuffle join at 10M ⋈ 200M on the
             CLI's relations, every shard on the one card: (a) ``cli.main
             --join shuffle --shards S`` for S = 1, 2 and 8 (Type
             DistributedShuffle, NumberOfShards S, exactly 200,000,000,
             with its phase times), then the library join on the same
             relations at each S, and at S = 1 with int64 keys (K3); at
             S = 8 (b) ``local_join="hash"`` (K7), (c) ``pipeline_chunks=4``
             (K1 once per chunk and shard), (d) ``handle_skew=False`` (its
             drops and retries) and validity masks (probe keys even, build
             keys not divisible by 3) against the elementwise oracle.  Each
             library step runs once untimed, then once timed: its host ms,
             device ms between CUDA events, peak allocated bytes, exchange
             bytes (S·S·(cap_a + cap_b) slots of key, payload and valid),
             drop counts per attempt, planned hot keys and K1/K3/K7
             launches.

15. dist   — the distributed operators and the query layer's mesh execution
             (R6) at 10M ⋈ 200M on phase 12's relations, 8 shards on the
             one card (and 2 for (a)), every step with ``torch.cummax``
             refused: (a) ``DistributedAggregateOperator.run`` over the
             200M probe rows equals ``sort_aggregate`` as a key →
             aggregates map, with ``payload % 2 == 0`` as a mask
             ``filter_sort_aggregate``, with ``with_distinct=True`` the
             single-device distinct aggregate (K5, K7); (b)
             ``distributed_top_k`` with k = 10 by key and by payload, each
             also masked, equals ``ops.order_by.top_k`` of the (filtered)
             relation row for row; (c) ``DistributedJoinAggregateOperator``
             with and without skew handling equals the phase-6 group
             oracle (K5, K7); (d) ``DistributedMaterializeJoiner`` inner
             (200,000,000 rows), anti (0), left and semi with the probe
             mask equal ``sort_merge_materialize_typed`` as multisets of
             (key, pay_a, pay_b, matched) rows (K5 compacts the gathered
             pools, K7); (e) ``MultiKeyShuffleJoiner.run`` over (key, key ^
             0x5A17) and ``run_i64`` over the keys widened to int64 count
             200,000,000 (K7); (f) R6 through the front ends:
             ``execute_sql`` of (b) of phase 12 with ``mesh=`` equals the
             single-device statement and the oracle (K5, K7), ``SELECT
             COUNT(*) FROM b JOIN a USING (key)`` with the mesh counts
             200,000,000 (K1, K7), ``explain_sql`` starts with ``physical
             plan [mesh S=8]`` and names R6, and the shell ``python -m
             partitionedhashjoin_tpu_torch.sql --platform cuda --mesh 8``
             on the reference workload prints 200000000 (K1, read in its
             own process).  Each library step runs once untimed, then once
             timed: its host ms, device ms between CUDA events, peak
             allocated bytes, exchange bytes, attempts with their overflow
             counters, retries and K1/K5/K7 launches.

16. multiprocess — the shuffle join over 2 processes that share the card
             (``torch.distributed``, gloo: NCCL refuses two ranks on one
             device), after a check that the card's compute mode is not
             Exclusive_Process: (a) ``python -m partitionedhashjoin_tpu_torch
             --coordinator 127.0.0.1:<port> --num-processes 2 --process-id i
             --join shuffle`` at the reference workload, with the default
             shards (one per process) and with ``--shards 8``: process 0's
             document has NumberOfProcesses 2 and NumberOfShards S, process 1
             prints none, both log 200,000,000 matches and their K1/K7
             launches; (b) ``python -m partitionedhashjoin_tpu_torch.dryrun
             measure`` in 2 processes, each generating the CLI's relations
             from the same seed and keeping its ``host_slice``, 4 shards each:
             the sort-merge join counts 200,000,000 and its ``ShuffleRun``
             equals phase 14's 8-shard run (drops per attempt, capacities,
             hot keys); (c) the same processes with ``local_join="hash"`` and
             ``pipeline_chunks=4`` (K1 once per chunk and local shard).  Per
             process and step: host and device ms, the cross-process
             collectives' ms (and the host copies' share) and bytes, peak
             allocated bytes, the backend and K1/K7 launches; whether gloo
             takes the card's tensors as they are.  A process that fails or
             outlives its time limit fails the phase, and the other is
             killed.

17. scripts — every entry of ``partitionedhashjoin_tpu_torch.scripts`` on
             the card at its defaults (10M ⋈ 200M, Zipf 1.05): in this
             process, ``record_results`` with all seven algos in µs
             (figure.dat's columns in the JAX script's order; K1, K7),
             ``bench_int64`` (K3), ``bench_materialize`` (its four oracles;
             K4), ``bench_operators`` (fused and staged agree; K5),
             ``bench_filtered_pipeline`` (R7 and its masked-count oracle;
             K1, K4, K5), ``bench_scaling`` (S = 1, 2, 4, 8 at 1.25M ⋈ 25M
             per shard, so weak scaling at S = 8 is 10M ⋈ 200M; K1, K7), ``bench_overlap`` at 10M ⋈ 200M (chunks 1,
             2, 4, 8 on 8 shards; K1, K7) and ``bench_sorter_ab`` (both
             counts 200,000,000; K1, K6); each one
             JSON line with its JAX script's keys plus the card's name, its
             stderr and wall time logged; K1, K3, K4, K5, K6 and K7 must
             each launch.  ``python -m ...scripts.sweep --partitions 32
             2048`` runs as a subprocess: three CLI processes, each logging
             200,000,000 matches, and its figure.dat.

18. multiprocess ops — the distributed operators and R6 over 2 processes x
             4 shards that share the card (gloo), at 10M ⋈ 200M: ``python -m
             partitionedhashjoin_tpu_torch.dryrun ops`` in each process,
             which draws phase 15's relations whole from their seeds and
             keeps its ``host_slice``, then runs every 8-shard step of phase
             15 ((a) the GROUP BY plain, masked and with COUNT DISTINCT; (b)
             the four top-10s; (c) the join → GROUP BY with and without the
             skew plan; (d) the four materializing joins; (e) the composite
             and int64 keys; (f) the pipeline statement and the count join
             through ``execute_sql`` with ``mesh=``; ``dryrun.ops_steps``,
             the same calls phase 15 makes) once untimed and once timed.
             Each step's result and ``last_run`` (attempts, retries, exchange
             bytes) must equal phase 15's one-process result in both
             processes (``dryrun.digest`` of every output tensor).  Per step
             and process: host and device ms, the cross-process collectives'
             ms and bytes by collective, retries, peak allocated bytes and
             each kernel's launches, counted inside the process.

Kernel launch counts are set to 0 just before each path of phases 4 to 15
and each in-process entry of phase 17, and read just after; in phases 16
and 18 each process counts its own (the CLI from its start, the dry-run
workers from just before each timed run) and prints them.  A kernel's ``launches`` is the sum over the paths that run it.  Comparison launches in phase 3 are not counted.  The script prints
one JSON line describing the kernels and, last, the ``"ok"`` line.  Without a
CUDA device, or outside the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import logging
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

N_PRIMARY = 10_000_000
N_SECONDARY = 200_000_000
SKEW = 1.05
SEED = 20260816
#: Rows of each side of the uniform join the chained-probe kernel is also
#: timed on (Balkesen et al.'s workload B, 128M ⋈ 128M unique int32 keys).
N_UNIFORM = 128_000_000
#: The H100 SXM's device-memory rate (NVIDIA data sheet), for the bounds.
HBM_BYTES_PER_S = 3.35e12
#: K8's operations bound: lanes per clock per SM of each pipe on compute
#: capability 9.0 (CUDA C++ Programming Guide, throughput of native
#: arithmetic instructions): fp32 add/multiply/fma 128; integer add, logic,
#: shift, compare, min/max and select 64 (float compare, select and
#: min/max issue to the same ALU pipe); integer multiply(-add) 64; MUFU
#: (special functions), conversions, popc and leading zeros 16.  Every
#: instruction also takes an issue slot: 4 warp instructions a clock per
#: SM (128 lanes).  The rates are least times per instruction, so the
#: bound stays a least time.
SASS_PIPES = (
    ("fp32", 128, ("FADD", "FMUL", "FFMA")),
    ("alu", 64, ("IADD3", "IADD", "VIADD", "LOP3", "LOP", "SHF", "SHL",
                 "SHR", "ISETP", "IMNMX", "VIMNMX", "LEA", "SEL", "FSEL",
                 "FSETP", "FMNMX", "PRMT", "IABS", "BMSK", "SGXT")),
    ("imad", 64, ("IMAD", "IMUL")),
    ("mufu", 16, ("MUFU", "F2I", "I2F", "F2F", "FRND", "POPC", "FLO", "BREV")),
)
ISSUE_LANES = 128
#: SASS opcodes that do none of a round's work: branches and convergence,
#: votes, special-register reads, moves, constant loads and the stores of
#: the kernel whose instructions are counted.  K8's bound leaves them out.
SASS_NOT_WORK = frozenset((
    "BRA", "BSSY", "BSYNC", "BREAK", "BMOV", "WARPSYNC", "EXIT", "RET",
    "CALL", "NOP", "YIELD", "VOTE", "VOTEU", "POPC", "MOV", "MOV32I", "UMOV",
    "IMAD.MOV", "HFMA2.MOV", "S2R", "S2UR", "CS2R", "LDC", "ULDC", "STG",
    "ST", "RED", "ATOM", "ATOMG"))
I32_MAX = 2**31 - 1
I32_MIN = -(2**31)
I64_MAX = 2**63 - 1
I64_MIN = -(2**63)
PKG = "partitionedhashjoin_tpu_torch"
SALT = 0x5A17
#: GROUP BY capacity of the pipeline (scripts/bench_pipeline.py)
GROUP_CAPACITY = 1 << 24
PALLAS = "partitionedhashjoin_tpu/ops/pallas"
#: The CLI paths of phase 5: (argv, expected parameters beyond the base set,
#: kernel counters that must be non-zero: the count kernel and K6, the key
#: sort; planned sorts no probe relation).
MAIN_RUNS = (
    ([], {"Type": "NoPartitioning"}, ("k1", "k6")),
    (["--join", "radix-partitioning"],
     {"Type": "RadixPartitioning", "NumberOfPartitions": "32"}, ("k1", "k6")),
    (["--join", "planned"], {"Type": "Planned", "Plan": "interval"}, ()),
    (["--join", "sort-merge"], {"Type": "SortMerge"}, ("k1", "k6")),
    (["--join", "sort-merge", "--key-dtype", "int64"],
     {"Type": "SortMerge"}, ("k3", "k6")),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: torch.cuda.is_available() is False; this needs an "
            "NVIDIA GPU"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {card}")
    log(
        f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}"
    )
    return card


def phase_build() -> None:
    from partitionedhashjoin_tpu_torch.ops.kernels import (
        _build,
        bitonic_sort,
        compact,
        generate,
        merge_count,
        merge_probe,
    )

    from partitionedhashjoin_tpu_torch.data import host_loader

    names = ("merge_probe", "merge_count", "compact", "bitonic_sort",
             "radix_sort", "generate")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 1) as pool:
        host = pool.submit(host_loader.build)  # g++, for the alias tables
        paths = list(pool.map(_build.build, names))
        host_path = host.result()
    log(f"[build] {', '.join(p.name for p in paths)}, {host_path.name} in "
        f"{time.perf_counter() - t0:.2f} s (parallel nvcc and g++)")
    merge_probe.load_library()  # loads each and checks its tile size
    merge_count.load_library()
    compact.load_library()
    bitonic_sort.load_library()
    bitonic_sort.load_radix_library()
    generate.load_library()
    for path in paths:
        report = path.with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                log(f"[build] {path.stem}: {line.strip()}")


def _time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _time_pair(torch, kernel, plain, rounds=3, reps=5):
    """Mean ms of each, measured in turns (plain, kernel, kernel, plain)."""
    k_ms, p_ms = [], []
    for _ in range(rounds):
        p_ms.append(_time_ms(torch, plain, reps))
        k_ms.append(_time_ms(torch, kernel, reps))
        k_ms.append(_time_ms(torch, kernel, reps))
        p_ms.append(_time_ms(torch, plain, reps))
    return sum(k_ms) / len(k_ms), sum(p_ms) / len(p_ms)


def _bound_ms(n_bytes):
    """Least time to move ``n_bytes`` at the card's memory rate."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def _sorted_on(torch, arr, dtype, device):
    import numpy as np

    t = torch.tensor(np.asarray(arr, dtype=dtype), device=device)
    return torch.sort(t).values


def _shape():
    return f"{N_PRIMARY:,} x {N_SECONDARY:,}"


def _reference_data(torch, device, dtype):
    """The main path's relations: 10M sequential ⋈ 200M Zipf(1.05) keys."""
    from partitionedhashjoin_tpu_torch.ops import generators

    a = generators.sequential_table(N_PRIMARY, dtype=dtype, device=device).keys
    b = generators.zipf_table(N_SECONDARY, SKEW, (1, N_PRIMARY), seed=SEED,
                              dtype=dtype, device=device).keys
    return a, b


class Parity:
    """Runs a kernel and its plain version on the same inputs on the card
    and keeps the largest difference; raises on any difference or on a
    disagreement with an oracle."""

    def __init__(self, torch, tag):
        self.torch = torch
        self.tag = tag
        self.max_err = 0

    def check(self, name, kernel, plain, oracle=None):
        got = int(kernel())
        want_plain = int(plain())
        self.torch.cuda.synchronize()
        self.max_err = max(self.max_err, abs(got - want_plain))
        want = want_plain if oracle is None else int(oracle)
        if got != want_plain or got != want:
            raise AssertionError(
                f"[parity {self.tag}] {name}: kernel {got}, plain "
                f"{want_plain}, oracle {want}"
            )
        log(f"[parity {self.tag}] {name}: {got} ok")

    def check_tensors(self, name, kernel, plain, prefix=None):
        """Each tensor the kernel returns equals the plain version's
        exactly; ``prefix(outputs)`` limits the comparison to a leading
        part of all but the first (where the rest is undefined)."""
        got, want = kernel(), plain()
        self.torch.cuda.synchronize()
        n = None if prefix is None else prefix(want)
        err = 0
        for i, (g, w) in enumerate(zip(got, want)):
            if n is not None and i > 0:
                g, w = g[:n], w[:n]
            if g.shape != w.shape:
                raise AssertionError(
                    f"[parity {self.tag}] {name}: output {i} has shape "
                    f"{tuple(g.shape)}, plain {tuple(w.shape)}"
                )
            if g.numel():
                err = max(err, int((g.to(self.torch.int64)
                                    - w.to(self.torch.int64)).abs().max()))
        self.max_err = max(self.max_err, err)
        if err or len(got) != len(want):
            raise AssertionError(f"[parity {self.tag}] {name}: max error {err}")
        log(f"[parity {self.tag}] {name}: ok")


# ---------------------------------------------------------------- K1 (int32)


def _k1_cases(np, tile):
    """(name, a, b) numpy inputs with the cases of the JAX package's tests:
    full domain, empty sides, long duplicate runs, tile edges."""
    rng = np.random.default_rng(SEED)
    cases = [
        ("empty_build", [], [1, 2]),
        ("empty_probe", [1, 2], []),
        ("full_domain", [I32_MAX, I32_MAX, 5, I32_MIN, -7],
         [I32_MAX, 5, 6, I32_MAX, -7, I32_MIN, I32_MIN]),
        ("max_absent", [5, -7], [I32_MAX, 5]),
        ("max_only", [I32_MAX], [I32_MAX] * 3),
        # one duplicate run longer than a tile on both sides
        ("giant_run",
         np.concatenate([np.full(3 * tile + 5, 42), [7, 99]]),
         np.concatenate([np.full(2 * tile + 100, 42), np.arange(0, 200)])),
        # runs whose edges straddle probe-tile edges
        ("straddle",
         np.arange(0, 100, 2),
         np.concatenate([np.full(tile - 3, 10), np.full(10, 11),
                         np.full(tile + 1, 12), np.repeat(np.arange(13, 90), 777)])),
        ("ragged",
         rng.integers(-5000, 5000, 3000),
         rng.integers(-6000, 6000, 5 * tile + 123)),
    ]
    a = rng.integers(I32_MIN, I32_MAX, 4000, dtype=np.int64)
    b = rng.integers(I32_MIN, I32_MAX, 70000, dtype=np.int64)
    b[:30000] = rng.choice(a, 30000)
    a[::97] = I32_MAX
    b[::89] = I32_MAX
    cases.append(("int32_domain", a, b))
    return cases


def _k1_merge_cases(np, tile, chunk):
    """(name, a, b) int32 inputs that reach the branches of K1's merge in
    shared memory (``chunk`` build rows per chunk): a build range of many
    chunks, a duplicate build run across a chunk edge, a tile whose range is
    empty amid full ones, tiles of one repeated key, INT32_MAX runs on both
    sides at a chunk edge, n_a = 1 and a ragged last tile."""
    rng = np.random.default_rng(SEED + 1)
    dense = np.arange(1, 2_000_001)
    return [
        # each tile of 4,096 probe rows spans ~200K build rows (~50 chunks)
        ("sparse_probe_many_chunks", dense, dense[::50]),
        # key `chunk` has build rows on both sides of the first chunk edge
        ("dup_run_across_chunk_edge",
         np.concatenate([np.arange(chunk - 3), np.full(9, chunk),
                         np.arange(chunk + 1, 3 * chunk)]),
         np.concatenate([np.arange(0, 3 * chunk, 3), np.full(50, chunk)])),
        # the middle tile's keys fall between two build runs
        ("empty_range_amid_full",
         np.concatenate([np.arange(10_000), np.arange(30_000, 40_000)]),
         np.concatenate([np.arange(tile), np.arange(10_001, 10_001 + tile),
                         np.arange(30_000, 30_000 + tile)])),
        # tiles of one key with a build run three chunks long, of one key
        # in the build, and of one key above every build key
        ("one_key_tiles",
         np.concatenate([np.arange(100), np.full(3 * chunk, 500),
                         np.arange(501, 1000)]),
         np.concatenate([np.arange(100), np.full(2 * tile + 7, 500),
                         np.full(tile, 777), np.full(tile, 5000)])),
        # the build's INT32_MAX run starts on a chunk edge; the probe's
        # crosses a tile edge
        ("int32_max_at_chunk_edge",
         np.concatenate([np.arange(chunk), np.full(20, I32_MAX)]),
         np.concatenate([np.arange(0, chunk, 2), np.full(5000, I32_MAX)])),
        ("n_a_1", [5],
         np.concatenate([np.full(3, 4), np.full(tile + 10, 5), np.full(7, 6)])),
        ("ragged_last_tile", rng.integers(0, 50_000, 20_000),
         rng.integers(0, 60_000, 3 * tile + 1)),
    ]


def _range_stats(torch, ranges, chunk):
    """min, median, p99 and max of the tiles' build-range lengths, and the
    share of tiles longer than one chunk."""
    sizes = (ranges[:, 1] - ranges[:, 0]).double()
    q = torch.quantile(sizes, torch.tensor([0.5, 0.99], dtype=torch.float64,
                                           device=sizes.device)).tolist()
    return (f"min {int(sizes.min())}, median {q[0]:.0f}, p99 {q[1]:.0f}, "
            f"max {int(sizes.max())}; longer than one chunk of {chunk:,} "
            f"rows: {float((sizes > chunk).double().mean()):.4%} of tiles; "
            f"no fallback path")


def _isin_oracle(np, a, b, exclude_max=None):
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    hit = np.isin(b, a)
    if exclude_max is not None:
        hit &= b != exclude_max
    return int(hit.sum())


def parity_k1(torch, device):
    import numpy as np

    from partitionedhashjoin_tpu_torch.ops import merge_join
    from partitionedhashjoin_tpu_torch.ops.kernels import merge_probe as mp

    par = Parity(torch, "K1")

    def check(name, a_s, b_s, oracle=None):
        for ex in (False, True):
            par.check(
                f"{name} exclude={ex}",
                lambda: mp.ranged_merge_count_prepared(a_s, b_s, ex),
                lambda: mp.ranged_merge_count_plain(a_s, b_s, ex),
                None if oracle is None else oracle(ex),
            )

    for name, a, b in (_k1_cases(np, mp.TILE_ROWS)
                       + _k1_merge_cases(np, mp.TILE_ROWS, mp.CHUNK_ROWS)):
        check(name, _sorted_on(torch, a, np.int32, device),
              _sorted_on(torch, b, np.int32, device),
              lambda ex, a=a, b=b: _isin_oracle(np, a, b, I32_MAX if ex else None))
    # a probe run that starts 4 bytes past a 16-byte boundary: element copies
    a, b = _k1_cases(np, mp.TILE_ROWS)[-2][1:]
    b_s = _sorted_on(torch, b, np.int32, device)
    check("ragged, probe view at row 1", _sorted_on(torch, a, np.int32, device),
          b_s[1:], lambda ex: _isin_oracle(np, a, np.sort(b)[1:],
                                           I32_MAX if ex else None))

    # the validity-mask protocol through merge_join on the card
    a = np.asarray([I32_MAX, 5, 9, I32_MAX, 77], np.int32)
    av = np.asarray([True, True, False, False, True])
    b = np.tile(np.asarray([I32_MAX, 9, 5, 77, I32_MAX, 3], np.int32), 11000)
    bv = np.tile(np.asarray([True, True, False, True, False, True]), 11000)
    t = lambda x: torch.tensor(x, device=device)  # noqa: E731
    got = int(merge_join.two_run_count(t(a), t(b), t(av), t(bv)))
    got_pb = int(merge_join.PreparedBuild(t(a), t(av)).count(t(b), t(bv)))
    if got != 22000 or got_pb != 22000:
        raise AssertionError(f"[parity K1] masks: {got}, {got_pb}, want 22000")
    log("[parity K1] validity masks: 22000 ok")

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    a = torch.sort(torch.randint(0, 3_000_000, (1_000_000,), generator=gen,
                                 dtype=torch.int32, device=device)).values
    b = torch.sort(torch.randint(-100, 3_000_100, (20_000_000,), generator=gen,
                                 dtype=torch.int32, device=device)).values
    check("random_1M_x_20M", a, b)
    del a, b

    # the main path's shapes and data
    a, b = _reference_data(torch, device, torch.int32)
    sort_a_ms = _time_ms(torch, lambda: torch.sort(a, stable=False), reps=3)
    sort_b_ms = _time_ms(torch, lambda: torch.sort(b, stable=False), reps=3)
    b_sorted = torch.sort(b, stable=False).values
    del b
    check(f"main {_shape()}", a, b_sorted, lambda ex: N_SECONDARY)
    log(f"[ranges K1] {_shape()}: build rows per probe tile (hi - lo) over "
        f"{-(-N_SECONDARY // mp.TILE_ROWS):,} tiles: " + _range_stats(
            torch, mp.tile_ranges_plain(a, b_sorted, True), mp.CHUNK_ROWS))
    kernel_ms, plain_ms = _time_pair(
        torch,
        lambda: mp.ranged_merge_count_prepared(a, b_sorted, True),
        lambda: mp.ranged_merge_count_plain(a, b_sorted, True),
    )
    library_ms = _time_ms(torch, lambda: torch.isin(b_sorted, a).sum(), reps=3)
    log(
        f"[time K1] {_shape()} sorted int32: kernel {kernel_ms:.4f} ms "
        f"({N_SECONDARY / (kernel_ms * 1e-3):.4e} probe rows/s), plain "
        f"{plain_ms:.4f} ms, torch.isin {library_ms:.4f} ms; torch.sort int32 "
        f"{N_PRIMARY:,} {sort_a_ms:.4f} ms, {N_SECONDARY:,} {sort_b_ms:.4f} ms"
    )
    del a, b_sorted
    return {
        "max_abs_err": par.max_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": _bound_ms((N_PRIMARY + N_SECONDARY) * 4),
        "library_ms": library_ms,
    }


# ---------------------------------------------------------------- K3 (int64)


def _k3_cases(np, tile):
    """(name, a, b) int64 inputs: the domain's ends, keys that differ only in
    the low word across 2^31 (the case the TPU's bias trick exists for),
    k and k + 2^32, duplicate runs longer than a tile, runs across tile
    edges, empty sides."""
    rng = np.random.default_rng(SEED + 3)
    hi_word = 5 << 32
    low = [hi_word, hi_word + 2**31 - 1, hi_word + 2**31, hi_word + 2**32 - 1]
    k = 123_456
    cases = [
        ("empty_build", [], [1, 2]),
        ("empty_probe", [1, 2], []),
        ("int64_ends", [I64_MAX, I64_MAX, 5, I64_MIN, -7],
         [I64_MAX, 5, 6, I64_MAX, -7, I64_MIN, I64_MIN, I64_MIN + 1]),
        ("max_absent", [5, -7], [I64_MAX, 5, I64_MIN]),
        ("low_word_across_2^31", low[::2], low * 3 + [hi_word - 1, hi_word + 1]),
        ("k_and_k_plus_2^32", [k, -k], [k, k + 2**32, k - 2**32, -k,
                                        -k + 2**32, -k - 2**32]),
        ("giant_run",
         np.concatenate([np.full(3 * tile + 5, 42 + 2**40), [7, 99]]),
         np.concatenate([np.full(2 * tile + 100, 42 + 2**40), np.arange(200)])),
        ("straddle",
         np.arange(0, 100, 2) * 2**33,
         np.concatenate([np.full(tile - 3, 10), np.full(10, 11),
                         np.full(tile + 1, 12),
                         np.repeat(np.arange(13, 90), 777)]) * 2**33),
    ]
    a = rng.integers(I64_MIN, I64_MAX, 4000, dtype=np.int64)
    b = rng.integers(I64_MIN, I64_MAX, 70000, dtype=np.int64)
    b[:30000] = rng.choice(a, 30000)
    b[30000:40000] = rng.choice(a, 10000) ^ (1 << 31)  # low-word neighbours
    cases.append(("int64_domain", a, b))
    return cases


def _k3_merge_cases(np, tile, chunk):
    """(name, a, b) int64 inputs for K3's merge in shared memory (``chunk``
    build rows per chunk): keys that differ from build keys only above bit
    31 around a chunk edge, a duplicate build run across a chunk edge and a
    build range of many chunks."""
    a = (np.arange(3 * chunk, dtype=np.int64) << 33) + 12_345
    edge = a[chunk - 8 : chunk + 8]
    dense = np.arange(1, 1_000_001, dtype=np.int64) + 2**40
    return [
        ("above_bit31_at_chunk_edge", a,
         np.concatenate([a[::4], a[::4] + 2**32, edge, edge + 2**32,
                         edge - 2**32])),
        ("dup_run_across_chunk_edge",
         np.concatenate([np.arange(chunk - 3), np.full(9, chunk),
                         np.arange(chunk + 1, 3 * chunk)]) << 33,
         np.concatenate([np.arange(0, 3 * chunk, 3),
                         np.full(50, chunk)]) << 33),
        ("sparse_probe_many_chunks", dense, dense[::50]),
    ]


def parity_k3(torch, device):
    import numpy as np

    from partitionedhashjoin_tpu_torch.ops.kernels import merge_probe as mp

    par = Parity(torch, "K3")

    def check(name, a_s, b_s, oracle=None):
        par.check(name, lambda: mp.ranged_merge_count_i64(a_s, b_s),
                  lambda: mp.ranged_merge_count_i64_plain(a_s, b_s), oracle)

    for name, a, b in (_k3_cases(np, mp.TILE_ROWS)
                       + _k3_merge_cases(np, mp.TILE_ROWS, mp.CHUNK_ROWS_I64)):
        check(name, _sorted_on(torch, a, np.int64, device),
              _sorted_on(torch, b, np.int64, device), _isin_oracle(np, a, b))
    a, b = _k3_cases(np, mp.TILE_ROWS)[-1][1:]  # 8 bytes past 16: element copies
    check("int64_domain, probe view at row 1",
          _sorted_on(torch, a, np.int64, device),
          _sorted_on(torch, b, np.int64, device)[1:],
          _isin_oracle(np, a, np.sort(b)[1:]))

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)
    a = torch.randint(-(2**62), 2**62, (1_000_000,), generator=gen,
                      dtype=torch.int64, device=device)
    b = torch.randint(-(2**62), 2**62, (20_000_000,), generator=gen,
                      dtype=torch.int64, device=device)
    b[: 10_000_000] = a[torch.randint(0, a.shape[0], (10_000_000,),
                                      generator=gen, device=device)]
    check("random_1M_x_20M", torch.sort(a).values, torch.sort(b).values)
    del a, b

    a, b = _reference_data(torch, device, torch.int64)
    sort_ms = _time_ms(torch, lambda: torch.sort(b, stable=False), reps=3)
    b_sorted = torch.sort(b, stable=False).values
    del b
    check(f"main {_shape()}", a, b_sorted, N_SECONDARY)
    log(f"[ranges K3] {_shape()}: " + _range_stats(
        torch, mp.tile_ranges_plain(a, b_sorted), mp.CHUNK_ROWS_I64))
    kernel_ms, plain_ms = _time_pair(
        torch,
        lambda: mp.ranged_merge_count_i64(a, b_sorted),
        lambda: mp.ranged_merge_count_i64_plain(a, b_sorted),
    )
    library_ms = _time_ms(torch, lambda: torch.isin(b_sorted, a).sum(), reps=3)
    log(
        f"[time K3] {_shape()} sorted int64: kernel {kernel_ms:.4f} ms "
        f"({N_SECONDARY / (kernel_ms * 1e-3):.4e} probe rows/s), plain "
        f"{plain_ms:.4f} ms, torch.isin {library_ms:.4f} ms; torch.sort int64 "
        f"{N_SECONDARY:,} {sort_ms:.4f} ms"
    )
    del a, b_sorted
    return {
        "max_abs_err": par.max_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": _bound_ms((N_PRIMARY + N_SECONDARY) * 8),
        "library_ms": library_ms,
    }


# ---------------------------------------------------------------- K2


def _merged(np, a, b):
    """The sort-merge join's merged stream of int32 build keys a and probe
    keys b (builds before equal-keyed probes) and its Get-count."""
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    keys = np.concatenate([a, b])
    is_build = np.concatenate([np.ones(a.size, bool), np.zeros(b.size, bool)])
    order = np.argsort(keys, kind="stable")
    hit = np.isin(b, a) & (b != I32_MIN)
    return keys[order], is_build[order], int(hit.sum())


def _k2_cases(np, tile):
    """(name, keys_sorted, is_build_sorted, oracle): the cases of
    tests/test_pallas_kernels.py:28-90 and the edges of this kernel's
    blocks."""
    rng = np.random.default_rng(SEED + 2)
    cases = []
    for n_a, n_b in ((100, 400), (5000, 20000), (1, 1), (0, 100), (3000, 0)):
        a = rng.integers(-500, 500, n_a)
        b = rng.integers(-600, 600, n_b)
        cases.append((f"random_{n_a}x{n_b}", *_merged(np, a, b)))
    # a build key whose max must carry across many block edges
    n = 3 * tile + 17
    carry = np.zeros(n, bool)
    carry[0] = True
    cases.append(("carry_across_blocks", np.zeros(n, np.int32), carry, n - 1))
    # an equal-key probe run spanning blocks, with no build row in it
    keys = np.concatenate([[5], np.full(2 * tile - 1, 7)]).astype(np.int32)
    build = np.zeros(2 * tile, bool)
    build[0] = True
    cases.append(("run_without_build", keys, build, 0))
    # INT32_MAX probe rows, present and absent on the build side
    cases.append(("max_probe_absent", *_merged(np, [1], [I32_MAX, I32_MAX])))
    cases.append(("max_probe_present",
                  *_merged(np, [1, I32_MAX], [I32_MAX, I32_MAX])))
    # INT32_MIN keys: never counted here (the caller's correction)
    cases.append(("int32_min_keys",
                  *_merged(np, [I32_MIN, 3], [I32_MIN, I32_MIN, 3, 4])))
    # build runs ending exactly on, and one past, a block edge
    a = np.arange(0, 3 * tile, 7)
    b = np.repeat(np.arange(0, 3 * tile, 3), 2)
    cases.append(("block_edges", *_merged(np, a, b)))
    a = rng.integers(I32_MIN, I32_MAX, 300_000, dtype=np.int64)
    b = rng.integers(I32_MIN, I32_MAX, 1_200_000, dtype=np.int64)
    b[:500_000] = rng.choice(a, 500_000)
    cases.append(("random_300K_x_1.2M_full_domain", *_merged(np, a, b)))
    # n = 1 and one row either side of a tile
    for n in (1, tile - 1, tile + 1):
        a = rng.integers(-300, 300, n // 3 + 1)
        b = rng.integers(-300, 300, n - a.size)
        cases.append((f"n_{n}", *_merged(np, a, b)))
    # the count is defined for rows in any order: keys on a random walk
    # that falls back often (the running maximum is not the last build
    # key), random tags; and a stream over 1,002 tiles whose largest build
    # key is its first row: it carries to the probe rows of the last tile
    # past later, smaller build keys
    keys = np.cumsum(rng.integers(-3, 5, 1_000_003)).astype(np.int32)
    build = rng.random(keys.size) < 0.3
    cases.append(("unsorted", keys, build, _count_oracle(np, keys, build)))
    n = 1001 * tile + 17
    keys = rng.integers(-50, 50, n).astype(np.int32)
    build = rng.random(n) < 0.01
    keys[0], build[0] = 60, True
    keys[500 * tile], build[500 * tile] = 55, True
    keys[-5:], build[-5:] = 60, False
    cases.append(("unsorted_carry_1001_tiles", keys, build,
                  _count_oracle(np, keys, build)))
    return cases


def _count_oracle(np, keys, build):
    """K2's count by numpy, for rows in any order."""
    last = np.maximum.accumulate(np.where(build, keys, I32_MIN))
    return int((~build & (last == keys) & (keys != I32_MIN)).sum())


def parity_k2(torch, device):
    import numpy as np

    from partitionedhashjoin_tpu_torch.ops import sort_merge
    from partitionedhashjoin_tpu_torch.ops.kernels import merge_count as mc

    par = Parity(torch, "K2")

    def check(name, keys, is_build, oracle=None):
        par.check(name, lambda: mc.merge_count_sorted(keys, is_build),
                  lambda: mc.merge_count_sorted_plain(keys, is_build), oracle)

    cases = _k2_cases(np, mc.TILE_ROWS)
    for name, keys, is_build, oracle in cases:
        t_keys = torch.tensor(keys, device=device)
        check(name, t_keys, torch.tensor(is_build, device=device), oracle)
        check(name + " (uint8 tags)", t_keys,
              torch.tensor(is_build.astype(np.uint8), device=device), oracle)
    # views off a 16-byte boundary: keys 0..3 rows in, tags at the same or
    # at another byte offset (then loaded byte by byte)
    name, keys, is_build, oracle = cases[-2]
    n = keys.size
    for k_off, t_off in ((1, 1), (3, 3), (1, 5), (0, 3), (2, 0)):
        k_buf = torch.zeros(n + 8, dtype=torch.int32, device=device)
        t_buf = torch.zeros(n + 16, dtype=torch.bool, device=device)
        k_buf[k_off:k_off + n] = torch.tensor(keys, device=device)
        t_buf[t_off:t_off + n] = torch.tensor(is_build, device=device)
        check(f"{name} as keys[{k_off}:], tags[{t_off}:]",
              k_buf[k_off:k_off + n], t_buf[t_off:t_off + n], oracle)

    # the main path's 210M-row merged stream
    a, b = _reference_data(torch, device, torch.int32)
    keys_s, is_build_s, order = sort_merge._merged_sort(a, b)
    del a, b, order
    check(f"main merged {_shape()}", keys_s, is_build_s, N_SECONDARY)
    kernel_ms, plain_ms = _time_pair(
        torch,
        lambda: mc.merge_count_sorted(keys_s, is_build_s),
        lambda: mc.merge_count_sorted_plain(keys_s, is_build_s),
    )
    n = keys_s.shape[0]
    bound = _bound_ms(n * (4 + 1))
    log(
        f"[time K2] {n}-row merged stream: kernel {kernel_ms:.4f} ms "
        f"({n / (kernel_ms * 1e-3):.4e} rows/s, {bound / kernel_ms:.1%} of "
        f"the bound {bound:.4f} ms), plain {plain_ms:.4f} ms"
    )
    del keys_s, is_build_s
    return {
        "max_abs_err": par.max_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound,
        # no single PyTorch call computes the merge count
        "library_ms": None,
    }


# ---------------------------------------------------------------- K4


def parity_k4(torch, device):
    import numpy as np

    from partitionedhashjoin_tpu_torch.ops.kernels import merge_payload as mpay
    from partitionedhashjoin_tpu_torch.ops.kernels import merge_probe as mp

    par = Parity(torch, "K4")

    def check(name, a_s, b_s, a_pay=None):
        if a_pay is None:
            a_pay = torch.arange(a_s.shape[0], dtype=torch.int32,
                                 device=device) * 3 + 1
        for ex in (False, True):
            par.check_tensors(
                f"{name} exclude={ex}",
                lambda: mpay.ranged_merge_payload_prepared(a_s, a_pay, b_s, ex),
                lambda: mpay.ranged_merge_payload_plain(a_s, a_pay, b_s, ex),
            )

    # K1's cases: duplicate runs across tiles, INT32_MIN/MAX keys, empty
    # sides, n_b not a tile multiple
    for name, a, b in _k1_cases(np, mp.TILE_ROWS):
        check(name, _sorted_on(torch, a, np.int32, device),
              _sorted_on(torch, b, np.int32, device))
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 4)
    a = torch.sort(torch.randint(0, 3_000_000, (1_000_000,), generator=gen,
                                 dtype=torch.int32, device=device)).values
    b = torch.sort(torch.randint(-100, 3_000_100, (20_000_000,), generator=gen,
                                 dtype=torch.int32, device=device)).values
    check("random_1M_x_20M", a, b)
    del a, b

    # the main path's shapes: the sorted build of the pipeline and the
    # sorted 200M Zipf probe
    a, b = _reference_data(torch, device, torch.int32)
    a_pay = a ^ SALT
    b_sorted = torch.sort(b).values
    del b
    check(f"main {_shape()}", a, b_sorted, a_pay)
    kernel_ms, plain_ms = _time_pair(
        torch,
        lambda: mpay.ranged_merge_payload_prepared(a, a_pay, b_sorted),
        lambda: mpay.ranged_merge_payload_plain(a, a_pay, b_sorted),
    )
    library_ms = _time_ms(torch, lambda: torch.searchsorted(a, b_sorted), reps=3)
    log(
        f"[time K4] {_shape()} sorted int32: kernel {kernel_ms:.4f} ms "
        f"({N_SECONDARY / (kernel_ms * 1e-3):.4e} probe rows/s), plain "
        f"{plain_ms:.4f} ms, torch.searchsorted (no hit test, no payload) "
        f"{library_ms:.4f} ms"
    )
    del a, a_pay, b_sorted
    return {
        "max_abs_err": par.max_err, "ms": kernel_ms, "plain_ms": plain_ms,
        # reads a, a_payloads, b once; writes pay and pos
        "bound_ms": _bound_ms((2 * N_PRIMARY + 3 * N_SECONDARY) * 4),
        "library_ms": library_ms,
    }


# ---------------------------------------------------------------- K5


def _pass2_columns(torch, keys, pay):
    """The pass-2 inputs of ``aggregate_sorted(payload_sorted=True)`` over
    the ordered materialized join: the run-start flags and the key,
    payload, exclusive payload cumsum (int32, wrapping) and previous-payload
    columns."""
    from partitionedhashjoin_tpu_torch.ops import aggregate

    is_start = torch.ones_like(keys, dtype=torch.bool)
    is_start[1:] = keys[1:] != keys[:-1]
    csx = aggregate._wrap(torch.cumsum(pay, 0, dtype=torch.int64) - pay, torch.int32)
    maxprev = torch.cat([pay[:1], pay[:-1]])
    return is_start, [keys, pay, csx, maxprev]


def _k5_bytes(n, kept, n_cols):
    """K5's compulsory bytes: ``keep`` read once, the kept rows of each
    column read, the kept rows of each column and ``pos`` written."""
    return n + kept * 4 * n_cols + kept * 4 * (n_cols + 1)


def parity_k5(torch, device):
    from partitionedhashjoin_tpu_torch.ops import merge_join
    from partitionedhashjoin_tpu_torch.ops.kernels import compact as kc

    par = Parity(torch, "K5")

    def check_rows(name, keep, cols, out_len):
        """``compact_rows`` as the port's operators call it (any n, no zero
        fill) against the plain version, up to the kept count."""
        par.check_tensors(
            f"{name} compact_rows out_len={out_len}",
            lambda: kc.compact_rows(keep, cols, out_len, zero_tail=False),
            lambda: kc.compact_plain(keep, cols, out_len),
            prefix=lambda want: min(int(want[0]), out_len),
        )

    def check(name, keep, cols, capacity=None):
        n = keep.shape[0]
        par.check_tensors(
            f"{name} block_compact",
            lambda: kc.block_compact(keep, *cols),
            lambda: kc.compact_plain(keep, cols, n + kc.BLK),
            prefix=lambda want: int(want[0]),  # undefined past the count
        )
        got = kc.compact_columns(keep, *cols, capacity=capacity)
        cap_bound = got[2].shape[0]
        want = kc.compact_plain(keep, cols, cap_bound)
        if bool(got[1]) != (int(want[0]) <= cap_bound):
            raise AssertionError(f"[parity K5] {name}: ok flag {bool(got[1])}")
        par.check_tensors(f"{name} compact_columns cap={capacity}",
                          lambda: (got[0],) + tuple(got[2:]), lambda: want)

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 5)
    n = 128 * kc.BLK  # 1,048,576 rows
    for density in (0.0, 0.01, 0.5, 1.0):
        keep = torch.rand(n, generator=gen, device=device) < density
        for n_cols in range(1, kc.MAX_COLS + 1):
            cols = [torch.randint(-(2**31), 2**31 - 1, (n,), generator=gen,
                                  dtype=torch.int32, device=device)
                    for _ in range(n_cols)]
            check(f"density {density} cols {n_cols}", keep, cols)
        # capacity overflow (density 0.5 and 1) and slack (0 and 0.01)
        check(f"density {density} capacity", keep, cols, capacity=5000)
        # n not a multiple of BLK or of the kernel's tile, short outputs
        ragged = n - 3 * kc.BLK - 77
        for out_len in (ragged, 5001):
            check_rows(f"density {density} ragged n={ragged}", keep[:ragged],
                       [c[:ragged] for c in cols], out_len)
    # kept rows on tile and warp edges
    keep = torch.zeros(2 * kc.BLK, dtype=torch.bool, device=device)
    t = kc.TILE_ROWS
    keep[[0, 31, 32, 255, 256, t - 1, t, t + 1, 2 * t - 1, 2 * kc.BLK - 1]] = True
    check("tile edges", keep, [torch.arange(2 * kc.BLK, dtype=torch.int32,
                                            device=device)])
    # tile edges seen through keep views at each of the four byte
    # alignments (the one pass reads keep with 16-byte loads where it can)
    n = 9 * t + 77
    edges = torch.zeros(n + 3, dtype=torch.bool, device=device)
    for e in range(t, 9 * t, t):
        edges[e - 2: e + 2] = True
    col = torch.arange(n, dtype=torch.int32, device=device)
    for off in range(4):
        check_rows(f"tile edges, keep offset {off} bytes", edges[off: off + n],
                   [col, col ^ I32_MAX], n)
    # one kept row per tile, on every offset within a tile
    n = 1_000_003
    one = torch.zeros(n, dtype=torch.bool, device=device)
    one[[r for r in (i * t + 37 * i % t for i in range(-(-n // t))) if r < n]] = True
    check_rows("one kept row per tile", one,
               [torch.arange(n, dtype=torch.int32, device=device)], n)
    empty = torch.zeros(0, dtype=torch.bool, device=device)
    before = kc.LAUNCHES
    check_rows("n = 0", empty, [torch.zeros(0, dtype=torch.int32, device=device)], 5)
    if kc.LAUNCHES != before:
        raise AssertionError("[parity K5] n = 0 launched the kernel")
    del keep, cols, edges, col, one

    # the main path's shapes: pass 2 of the ordered pipeline's GROUP BY,
    # as aggregate_sorted calls K5 (group capacity + 1 outputs, no fill)
    a_keys, a_pay, b_keys, b_pay = _query_relations(torch, device)
    keys, _, pb, _ = merge_join.two_run_materialize(
        a_keys, a_pay, b_keys, b_pay, probe_payload_sorted=True)
    del a_keys, a_pay, b_keys, b_pay
    is_start, cols = _pass2_columns(torch, keys, pb)
    del keys, pb
    groups = int(is_start.sum())
    n = is_start.shape[0]
    out_len = GROUP_CAPACITY + 1
    check_rows(f"pipeline pass 2 ({groups:,} groups)", is_start, cols, out_len)
    kernel_ms, plain_ms = _time_pair(
        torch,
        lambda: kc.compact_rows(is_start, cols, out_len, zero_tail=False),
        lambda: kc.compact_plain(is_start, cols, out_len),
    )
    library_ms = _time_ms(torch, lambda: cols[0][is_start], reps=3)
    n_bytes = _k5_bytes(n, groups, len(cols))
    log(
        f"[time K5] pass 2, {n:,} rows, {groups:,} groups, {len(cols)} "
        f"columns: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"col[keep] (one column) {library_ms:.4f} ms; bound "
        f"{n_bytes:,} B = {_bound_ms(n_bytes):.4f} ms"
    )
    # the same columns at ~8M kept rows: the distinct keys an exact
    # Zipf(1.05) over 10M keys gives in 200M draws, which the float32
    # sampler does not reach (see _zipf_reach)
    keep = torch.rand(n, generator=gen, device=device) < 8e6 / n
    kept = int(keep.sum())
    check_rows(f"pass-2 columns at {kept:,} kept", keep, cols, out_len)
    dense_ms, dense_plain_ms = _time_pair(
        torch,
        lambda: kc.compact_rows(keep, cols, out_len, zero_tail=False),
        lambda: kc.compact_plain(keep, cols, out_len),
    )
    dense_lib_ms = _time_ms(torch, lambda: cols[0][keep], reps=3)
    dense_bytes = _k5_bytes(n, kept, len(cols))
    log(
        f"[time K5] pass-2 columns, {n:,} rows, {kept:,} kept, {len(cols)} "
        f"columns: kernel {dense_ms:.4f} ms, plain {dense_plain_ms:.4f} ms, "
        f"col[keep] (one column) {dense_lib_ms:.4f} ms; bound "
        f"{dense_bytes:,} B = {_bound_ms(dense_bytes):.4f} ms"
    )
    del is_start, cols, keep
    # the staged filter's compaction: keys and payloads at half density
    keys = torch.randint(0, N_PRIMARY, (N_SECONDARY,), generator=gen,
                         dtype=torch.int32, device=device)
    pay = torch.arange(N_SECONDARY, dtype=torch.int32, device=device)
    keep = (pay & 1) == 0
    check_rows("staged filter", keep, [keys, pay], N_SECONDARY)
    staged_ms, staged_plain_ms = _time_pair(
        torch,
        lambda: kc.compact_rows(keep, [keys, pay], N_SECONDARY, zero_tail=False),
        lambda: kc.compact_plain(keep, [keys, pay], N_SECONDARY),
    )
    kept = int(keep.sum())
    staged_bytes = _k5_bytes(N_SECONDARY, kept, 2)
    log(f"[time K5] staged filter, {N_SECONDARY:,} rows, {kept:,} kept, 2 "
        f"columns: kernel {staged_ms:.4f} ms, plain {staged_plain_ms:.4f} ms; "
        f"bound {staged_bytes:,} B = {_bound_ms(staged_bytes):.4f} ms")
    del keys, pay, keep
    return {
        "max_abs_err": par.max_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": _bound_ms(n_bytes), "library_ms": library_ms,
    }


# ---------------------------------------------------------------- K6


def _tuple_operands(torch, device, gen, k, n, narrow=True):
    """k int32 operands of n rows: leading ones narrow (so ties carry down
    to the last), the last over the full domain, all-MAX rows beside the
    padding."""
    cols = [torch.randint(-3, 3, (n,), generator=gen, dtype=torch.int32,
                          device=device) for _ in range(k - 1 if narrow else 0)]
    while len(cols) < k:
        cols.append(torch.randint(I32_MIN, I32_MAX, (n,), generator=gen,
                                  dtype=torch.int32, device=device))
    for c in cols:
        c[::31] = I32_MAX
    return cols


def _radix_edge_operands(torch, device, gen, k, n):
    """The radix sort's own edge cases: every operand constant (every digit
    skipped), keys in [1, 10M] (their top byte skipped), and a first
    operand of only INT32_MIN and INT32_MAX."""
    narrow = [torch.randint(-2, 2, (n,), generator=gen, dtype=torch.int32,
                            device=device) for _ in range(k - 1)]
    keys = torch.randint(1, N_PRIMARY + 1, (n,), generator=gen,
                         dtype=torch.int32, device=device)
    ends = torch.where(torch.rand(n, generator=gen, device=device) < 0.5,
                       I32_MIN, I32_MAX).to(torch.int32)
    return {
        "every operand constant":
            [torch.full((n,), 5 - c, dtype=torch.int32, device=device)
             for c in range(k)],
        f"keys in [1, {N_PRIMARY:,}]": narrow + [keys],
        "INT32_MIN/MAX-only operand": [ends] + narrow,
    }


def _block_edge_operands(torch, device, gen, k, blk):
    """K6a's edge blocks side by side, one ``blk``-row block each, every
    block with its own set of varying digits (a digit plan shared across
    blocks would fail): one tuple; only byte 0 of the last operand varies;
    only the top byte varies; INT32_MIN, -1, 0 and INT32_MAX; keys in
    [1, 10M]; a narrow leading operand with full-domain trailing ones; 90%
    of rows one tuple; every row INT32_MAX."""

    def rand(lo, hi):
        return torch.randint(lo, hi, (blk,), generator=gen, dtype=torch.int64,
                             device=device)

    def full():
        return torch.randint(I32_MIN, I32_MAX, (blk,), generator=gen,
                             dtype=torch.int32, device=device)

    def const(v):
        return torch.full((blk,), v, dtype=torch.int32, device=device)

    def top_byte():
        biased = (rand(0, 256) << 24) | 0x00ABCDEF
        return (biased - (biased >= 2**31).to(torch.int64) * 2**32).to(torch.int32)

    ends = torch.tensor([I32_MIN, -1, 0, I32_MAX], dtype=torch.int32,
                        device=device)
    hot = torch.rand(blk, generator=gen, device=device) < 0.9
    narrow = [rand(-2, 2).to(torch.int32) for _ in range(k - 1)]
    blocks = [
        [const(5 - c) for c in range(k)],
        [const(-c) for c in range(k - 1)]
        + [(0x12345600 | rand(0, 256)).to(torch.int32)],
        [top_byte() for _ in range(k)],
        [ends[rand(0, 4)] for _ in range(k)],
        narrow + [rand(1, N_PRIMARY + 1).to(torch.int32)],
        [rand(-3, 3).to(torch.int32)] + [full() for _ in range(k - 1)],
        [torch.where(hot, 7, full()) for _ in range(k)],
        [const(I32_MAX) for _ in range(k)],
    ]
    return [torch.cat([b[c] for b in blocks]) for c in range(k)]


def parity_k6(torch, device):
    """The full sort (the radix sort), K6a and K6b against their plain
    versions at 1 to 4 operands; then times at 200M rows (and 10M at
    k = 1)."""
    from partitionedhashjoin_tpu_torch.ops import sort as sort_ops
    from partitionedhashjoin_tpu_torch.ops.kernels import bitonic_sort as bs

    blk = bs.BLK
    par_a, par_b, par = (Parity(torch, t) for t in ("K6a", "K6b", "K6"))
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 6)

    def check_sort(name, cols):
        """The radix sort against its plain version; it launches no K6a or
        K6b, and one sweep per digit of its plan."""
        before = (bs.LAUNCHES_BLOCKS, bs.LAUNCHES_MERGE, bs.LAUNCHES_SORT)
        par.check_tensors(name, lambda: bs.sort_i32_tuple(*cols),
                          lambda: bs.sort_i32_tuple_plain(*cols))
        n = cols[0].shape[0]
        passes = len(bs.radix_plan(bs.radix_histograms_plain(*cols)).passes) \
            if n else 0
        grew = (bs.LAUNCHES_BLOCKS - before[0], bs.LAUNCHES_MERGE - before[1],
                bs.LAUNCHES_SORT - before[2])
        if grew != (0, 0, passes):
            raise AssertionError(f"[parity K6] {name}: launches (K6a, K6b, "
                                 f"sweeps) {grew}, want (0, 0, {passes})")

    for k in range(1, bs.MAX_OPERANDS + 1):
        for n in (0, 1, 100, blk, blk + 1, 3 * blk - 5, 5 * blk + 17, 1_000_003):
            check_sort(f"sort k={k} n={n}", _tuple_operands(torch, device, gen, k, n))
        # one tuple covers 90% of 2M rows: its run is longer than a tile
        n = 2_000_003
        hot = torch.rand(n, generator=gen, device=device) < 0.9
        check_sort(f"sort k={k} 90% one tuple, n={n}",
                   [torch.where(hot, 7, c) for c in
                    _tuple_operands(torch, device, gen, k, n, narrow=False)])
        n = 1_000_003
        for name, cols in _radix_edge_operands(torch, device, gen, k, n).items():
            check_sort(f"sort k={k} {name}, n={n}", cols)
        n = 128 * blk
        cols = _tuple_operands(torch, device, gen, k, n)
        par_a.check_tensors(f"sort_blocks k={k} n={n}",
                            lambda: bs.sort_blocks_tuple(*cols),
                            lambda: bs.sort_blocks_plain(*cols))
        # the edge blocks in one call, then as views off a 16-byte boundary
        edges = _block_edge_operands(torch, device, gen, k, blk)
        shifted = [torch.cat([c[:1], c])[1:] for c in edges]
        for name, ops in (("edge blocks", edges),
                          ("edge blocks, unaligned", shifted)):
            par_a.check_tensors(f"sort_blocks k={k} {name}",
                                lambda: bs.sort_blocks_tuple(*ops),
                                lambda: bs.sort_blocks_plain(*ops))
        del edges, shifted
        # runs of 1 and 4 blocks, and of 3 blocks (lone and truncated runs)
        for run in (blk, 4 * blk, 3 * blk):
            src = [c.contiguous() for c in bs._segment_sort_plain(cols, run)]
            par_b.check_tensors(f"merge_pass k={k} run={run}",
                                lambda: bs.merge_pass_tuple(*src, run_len=run),
                                lambda: bs.merge_pass_plain(*src, run_len=run))
        del cols, src, hot
    # 2.4 GB of keys: byte offsets pass 2^31
    big = torch.randint(I32_MIN, I32_MAX, (600_000_001,), generator=gen,
                        dtype=torch.int32, device=device)
    check_sort("sort k=1 n=600,000,001", [big])
    del big
    torch.cuda.empty_cache()

    def timed(name, operands, library=None, reps=3):
        sort_ms, plain_ms = _time_pair(
            torch, lambda: bs.sort_i32_tuple(*operands),
            lambda: bs.sort_i32_tuple_plain(*operands), rounds=2, reps=reps)
        lib_ms = None if library is None else _time_ms(torch, library, reps=reps)
        n, k = operands[0].shape[0], len(operands)
        bound = _bound_ms(n * 4 * k * 2)
        passes = len(bs.radix_plan(bs.radix_histograms_plain(*operands)).passes)
        log(f"[time K6] sort_i32_tuple {name}, {n:,} rows, k={k}: kernel "
            f"{sort_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{'—' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{bound:.4f} ms ({sort_ms / bound:.1f}x); K6's own traffic "
            f"(upsweep read + {passes} passes of read and write) at peak "
            f"{_bound_ms(n * 4 * k * (1 + 2 * passes)):.4f} ms")
        return sort_ms, plain_ms, bound, lib_ms

    x = torch.randint(I32_MIN, I32_MAX, (N_SECONDARY,), generator=gen,
                      dtype=torch.int32, device=device)
    stat = timed("int32 keys", [x], lambda: torch.sort(x).values)
    timed("int32 keys (10M)", [x[:N_PRIMARY]],
          lambda: torch.sort(x[:N_PRIMARY]).values, reps=5)
    pay = torch.randint(0, 1 << 20, (N_SECONDARY,), generator=gen,
                        dtype=torch.int32, device=device)
    timed("(key, payload)", [x, pay],
          lambda: sort_ops.sort_by_key_payload(x, pay))
    inv = torch.zeros_like(x)
    timed("(invalid flag, key, payload): masked GROUP BY pass 1", [inv, x, pay])
    del inv
    _, zipf = _reference_data(torch, device, torch.int32)
    timed("the main path's Zipf probe keys", [zipf], lambda: torch.sort(zipf).values)
    del zipf

    # the phases alone over whole blocks
    n = N_SECONDARY // blk * blk
    k6a, k6b = time_block_phases(torch, bs, x[:n], pay[:n])
    del x, pay
    k6a["max_abs_err"] = max(k6a["max_abs_err"], par_a.max_err)
    k6b["max_abs_err"] = max(k6b["max_abs_err"], par_b.max_err)
    sort_ms, sort_plain_ms, sort_bound, sort_lib_ms = stat
    return k6a, k6b, {
        "max_abs_err": par.max_err, "ms": sort_ms, "plain_ms": sort_plain_ms,
        "bound_ms": sort_bound, "library_ms": sort_lib_ms,
    }


def parity_k6_i64(torch, device):
    """K6 on an int64 key (``sort_i64``) against the library sort, bit for
    bit: keys over [1, 10M] (3 passes), Zipf(1.05) keys over [1, 10M], the
    full int64 domain with INT64_MIN and INT64_MAX (8 passes), one value
    (0 passes), tile edges and a view off a 16-byte boundary; each sort
    launches one upsweep and a sweep per digit of its plan and counts the
    rest as skipped.  Then times at 210M Zipf keys over [1, 10M] and 200M
    full-domain keys beside ``torch.sort(x).values``."""
    from partitionedhashjoin_tpu_torch.ops import generators
    from partitionedhashjoin_tpu_torch.ops.kernels import bitonic_sort as bs

    par = Parity(torch, "K6 int64")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 64)
    tile = bs.RADIX_TILE_I64

    def cases(n):
        full = torch.randint(I64_MIN, I64_MAX, (n,), generator=gen,
                             dtype=torch.int64, device=device)
        full[:4] = torch.tensor([I64_MIN, I64_MAX, -1, 0], device=device)[:n]
        return {
            f"keys in [1, {N_PRIMARY:,}]": torch.randint(
                1, N_PRIMARY + 1, (n,), generator=gen, dtype=torch.int64,
                device=device),
            "Zipf keys": generators.zipf_keys(
                n, SKEW, N_PRIMARY, generator=gen, device=device).to(torch.int64),
            "full domain": full,
            "one value": torch.full((n,), -(2**40) + 7, dtype=torch.int64,
                                    device=device),
        }

    def check_sort(name, x):
        n = x.shape[0]
        passes = len(bs.radix_plan(bs.radix_histograms_plain(x)).passes) if n else 0
        before = (bs.LAUNCHES_UPSWEEP, bs.LAUNCHES_SORT, bs.SWEEPS_SKIPPED)
        par.check_tensors(name, lambda: [bs.sort_i64(x)],
                          lambda: [torch.sort(x).values])
        grew = (bs.LAUNCHES_UPSWEEP - before[0], bs.LAUNCHES_SORT - before[1],
                bs.SWEEPS_SKIPPED - before[2])
        want = (1, passes, 8 - passes) if n else (0, 0, 0)
        if grew != want:
            raise AssertionError(f"[parity K6 int64] {name}: (upsweeps, sweeps, "
                                 f"skipped) {grew}, want {want}")
        return passes

    for n in (0, 1, 100, tile - 1, tile + 1, 5 * tile + 17, (1 << 22) + 13,
              1_000_003):
        for name, x in cases(n).items():
            check_sort(f"sort_i64 {name}, n={n}", x)
    x = cases(1_000_004)["full domain"]
    check_sort("sort_i64 full domain, a view off 16 bytes", x[1:])
    del x
    torch.cuda.empty_cache()

    stats = {}
    for name, n, make in (
        (f"Zipf keys over [1, {N_PRIMARY:,}]", N_PRIMARY + N_SECONDARY,
         lambda n: generators.zipf_keys(n, SKEW, N_PRIMARY, generator=gen,
                                        device=device).to(torch.int64)),
        ("full-domain keys", N_SECONDARY,
         lambda n: torch.randint(I64_MIN, I64_MAX, (n,), generator=gen,
                                 dtype=torch.int64, device=device)),
    ):
        x = make(n)
        passes = check_sort(f"sort_i64 {name}, n={n}", x)
        sort_ms, lib_ms = _time_pair(torch, lambda: bs.sort_i64(x),
                                     lambda: torch.sort(x).values, rounds=2, reps=3)
        bound = _bound_ms(n * 8 * 2)
        log(f"[time K6 int64] sort_i64 {name}, {n:,} rows: kernel "
            f"{sort_ms:.4f} ms, library (torch.sort(x).values) {lib_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({sort_ms / bound:.1f}x); {passes} passes, "
            f"{8 - passes} skipped; K6's own traffic (upsweep read + {passes} "
            f"passes of read and write) at peak "
            f"{_bound_ms(n * 8 * (1 + 2 * passes)):.4f} ms")
        stats.setdefault("ms", sort_ms)
        stats.setdefault("library_ms", lib_ms)
        stats.setdefault("bound_ms", bound)
        del x
        torch.cuda.empty_cache()
    stats["plain_ms"] = stats["library_ms"]  # the plain version is torch.sort
    stats["max_abs_err"] = par.max_err
    return stats


def time_block_phases(torch, bs, x, pay):
    """K6a over ``x`` (k = 1) and ``(x, pay)`` (k = 2, payloads in
    [0, 2^31)), and one K6b pass (runs of one block) over x's sorted blocks,
    each timed beside its plain version, its bound and the library's
    batched segmented sort (one row per block, or per pair of runs; at
    k = 2 over the packed int64 (key << 32 | payload), packed and unpacked
    in the call), and checked equal to the library's result.  ``x`` holds
    whole blocks of the module ``bs`` (the port's ``bitonic_sort``, or
    another tree's, to time two versions by the same code).  Returns the
    stats of K6a (k = 2 under ``"k2"``) and of K6b."""
    blk = bs.BLK
    n = x.shape[0]
    par_a, par_b = Parity(torch, "K6a"), Parity(torch, "K6b")

    def sort_rows(t, width):
        return torch.sort(t.view(-1, width), dim=1).values

    def packed_rows():
        key_pay = (x.to(torch.int64) << 32) | pay.to(torch.int64)
        s = sort_rows(key_pay, blk).view(-1)
        return [(s >> 32).to(torch.int32), (s & 0x7FFFFFFF).to(torch.int32)]

    a_ms, a_plain_ms = _time_pair(torch, lambda: bs.sort_blocks_tuple(x),
                                  lambda: bs.sort_blocks_plain(x), rounds=2, reps=3)
    a_lib_ms = _time_ms(torch, lambda: sort_rows(x, blk), reps=3)
    # the same keys with only their low 0 and 16 bits varying: K6a's cost
    # without its digit passes, and with half of them
    part_ms = {}
    for bits in (0, 16):
        low = (x & ((1 << bits) - 1)).contiguous()
        part_ms[bits] = _time_ms(torch, lambda: bs.sort_blocks_tuple(low), reps=3)
        del low
    blocks = bs.sort_blocks_tuple(x)[0]
    par_a.check_tensors(f"sort_blocks {n:,} rows == torch.sort per block",
                        lambda: [blocks], lambda: [sort_rows(x, blk).view(-1)])
    a2_ms, a2_plain_ms = _time_pair(
        torch, lambda: bs.sort_blocks_tuple(x, pay),
        lambda: bs.sort_blocks_plain(x, pay), rounds=2, reps=3)
    a2_lib_ms = _time_ms(torch, packed_rows, reps=3)
    par_a.check_tensors(
        f"sort_blocks (key, payload) {n:,} rows == packed torch.sort per block",
        lambda: bs.sort_blocks_tuple(x, pay), packed_rows)
    # one row per pair of runs: n holds an even number of blocks
    pairs = blocks[: n // (2 * blk) * 2 * blk]
    b_ms, b_plain_ms = _time_pair(
        torch, lambda: bs.merge_pass_tuple(blocks, run_len=blk),
        lambda: bs.merge_pass_plain(blocks, run_len=blk), rounds=2, reps=3)
    b_lib_ms = _time_ms(torch, lambda: sort_rows(pairs, 2 * blk), reps=3)
    par_b.check_tensors(
        f"merge_pass {pairs.shape[0]:,} rows == torch.sort per run pair",
        lambda: [bs.merge_pass_tuple(pairs, run_len=blk)[0]],
        lambda: [sort_rows(pairs, 2 * blk).view(-1)])
    bound, bound2 = _bound_ms(n * 4 * 2), _bound_ms(n * 4 * 2 * 2)
    log(f"[time K6a] sort_blocks, {n:,} rows, k=1: kernel {a_ms:.4f} ms, plain "
        f"{a_plain_ms:.4f} ms, torch.sort(dim=1) over {blk}-row rows "
        f"{a_lib_ms:.4f} ms, bound {bound:.4f} ms; keys with only their low "
        f"0 / 16 / 32 bits varying {part_ms[0]:.4f} / {part_ms[16]:.4f} / "
        f"{a_ms:.4f} ms")
    log(f"[time K6a] sort_blocks (key, payload), {n:,} rows, k=2: kernel "
        f"{a2_ms:.4f} ms, plain {a2_plain_ms:.4f} ms, packed int64 "
        f"torch.sort(dim=1) over {blk}-row rows {a2_lib_ms:.4f} ms, bound "
        f"{bound2:.4f} ms")
    log(f"[time K6b] one merge pass (runs of {blk}), {n:,} rows, k=1: kernel "
        f"{b_ms:.4f} ms, plain {b_plain_ms:.4f} ms, torch.sort(dim=1) over "
        f"{2 * blk}-row rows {b_lib_ms:.4f} ms, bound {bound:.4f} ms")
    return (
        {"max_abs_err": par_a.max_err, "ms": a_ms, "plain_ms": a_plain_ms,
         "bound_ms": bound, "library_ms": a_lib_ms,
         "low_bits_ms": {"0": part_ms[0], "16": part_ms[16]},
         "k2": {"ms": a2_ms, "plain_ms": a2_plain_ms, "bound_ms": bound2,
                "library_ms": a2_lib_ms}},
        {"max_abs_err": par_b.max_err, "ms": b_ms, "plain_ms": b_plain_ms,
         "bound_ms": bound, "library_ms": b_lib_ms},
    )


# ---------------------------------------------------------------- K7, K8


def parity_k7(torch, device):
    """K7 against ``hashing.hash32`` bitwise; timed over the 200M probe keys
    of the main path."""
    import numpy as np

    from partitionedhashjoin_tpu_torch.ops import hashing
    from partitionedhashjoin_tpu_torch.ops.kernels import generate as kg

    par = Parity(torch, "K7")
    rng = np.random.default_rng(SEED + 7)
    keys = rng.integers(I32_MIN, I32_MAX, 1_000_003, dtype=np.int64)
    keys[:4] = [I32_MIN, -1, 0, I32_MAX]
    keys = torch.tensor(keys.astype(np.int32), device=device)
    for seed in (0, 42, 0x9E3779B9, 2**32 - 1):
        for name, view in (("aligned", keys), ("unaligned", keys[1:]),
                           ("tiny", keys[:3]), ("empty", keys[:0])):
            # uint32 compared through its int32 bit pattern
            par.check_tensors(f"hash_keys seed={seed} {name}",
                              lambda: [kg.hash_keys(view, seed).view(torch.int32)],
                              lambda: [hashing.hash32(view, seed).view(torch.int32)])
    _, b = _reference_data(torch, device, torch.int32)
    par.check_tensors(f"hash_keys {N_SECONDARY:,} probe keys",
                      lambda: [kg.hash_keys(b, SEED).view(torch.int32)],
                      lambda: [hashing.hash32(b, SEED).view(torch.int32)])
    kernel_ms, plain_ms = _time_pair(torch, lambda: kg.hash_keys(b, SEED),
                                     lambda: hashing.hash32(b, SEED))
    bound = _bound_ms(N_SECONDARY * 8)
    log(f"[time K7] hash_keys, {N_SECONDARY:,} keys: kernel {kernel_ms:.4f} ms "
        f"({bound / kernel_ms:.1%} of the bound {bound:.4f} ms), plain "
        f"{plain_ms:.4f} ms")
    del b
    return {"max_abs_err": par.max_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "library_ms": None}


def parity_k7_i64(torch, device):
    """K7 on int64 keys against ``hashing.hash64_pair`` of their words,
    bitwise: the full int64 domain with INT64_MIN, INT64_MAX and keys that
    differ only above bit 31, aligned, off 16 bytes, odd lengths and empty.
    Timed over the 210M keys of one upstream join (10M build + 200M Zipf
    probe keys, int64), whose bound is 12 bytes a key."""
    from partitionedhashjoin_tpu_torch.ops import hashing
    from partitionedhashjoin_tpu_torch.ops.kernels import generate as kg

    par = Parity(torch, "K7 int64")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 764)
    keys = torch.randint(I64_MIN, I64_MAX, (1_000_003,), generator=gen,
                         dtype=torch.int64, device=device)
    keys[:6] = torch.tensor([I64_MIN, -1, 0, I64_MAX, 2**32 + 5, 5], device=device)

    def plain(x, seed):
        return hashing.hash64_pair(*hashing.split64(x), seed)

    for seed in (0, 42, 0x9E3779B9, 2**32 - 1):
        for name, view in (("aligned", keys), ("off 16 bytes", keys[1:]),
                           ("odd", keys[:-2]), ("tiny", keys[:3]),
                           ("empty", keys[:0])):
            par.check_tensors(f"hash_keys int64 seed={seed} {name}",
                              lambda: [kg.hash_keys(view, seed).view(torch.int32)],
                              lambda: [plain(view, seed).view(torch.int32)])
    a, b = _reference_data(torch, device, torch.int64)
    x = torch.cat([a, b])
    del a, b
    par.check_tensors(f"hash_keys int64 {x.numel():,} keys",
                      lambda: [kg.hash_keys(x, SEED).view(torch.int32)],
                      lambda: [plain(x, SEED).view(torch.int32)])
    kernel_ms, plain_ms = _time_pair(torch, lambda: kg.hash_keys(x, SEED),
                                     lambda: plain(x, SEED), rounds=2, reps=3)
    bound = _bound_ms(x.numel() * 12)
    log(f"[time K7 int64] hash_keys, {x.numel():,} int64 keys: kernel "
        f"{kernel_ms:.4f} ms ({bound / kernel_ms:.1%} of the bound {bound:.4f} "
        f"ms), plain {plain_ms:.4f} ms")
    del x
    torch.cuda.empty_cache()
    return {"max_abs_err": par.max_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "library_ms": None}


# ---------------------------------------------------------------- chained probe


def _median_ms(torch, fn, runs):
    """Median ms of ``runs`` calls of ``fn``, each between two CUDA events,
    after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def _chain_reads(torch, table, keys, hashes, mask, chunk=25_000_000):
    """Mean chain entries a probe row walks up to its first match (its whole
    chain where it finds none), and the 16-byte chunks of ``entry_keys``
    the kernel reads for them, from the chains written out ``chunk`` rows
    at a time, as ``chained_count_plain`` does."""
    per = 16 // table.entry_keys.element_size()
    lead = table.entry_keys.data_ptr() % 16 // table.entry_keys.element_size()
    entries = chunks = 0
    for lo in range(0, keys.numel(), chunk):
        k, h = keys[lo:lo + chunk], hashes[lo:lo + chunk]
        bucket = (h.view(torch.int32).to(torch.int64) & 0xFFFFFFFF) & mask
        start = table.offsets[bucket].to(torch.int64)
        length = table.offsets[bucket + 1].to(torch.int64) - start
        owner = torch.repeat_interleave(torch.arange(k.numel(), device=k.device), length)
        at = torch.arange(owner.numel(), device=k.device) - (torch.cumsum(length, 0)
                                                             - length)[owner]
        hit = table.entry_keys[start[owner] + at].to(torch.int64) == k[owner].to(torch.int64)
        first = torch.full((k.numel(),), 2**62, dtype=torch.int64, device=k.device)
        first.scatter_reduce_(0, owner[hit], at[hit], "amin")
        walked = torch.where(first < length, first + 1, length)
        entries += int(walked.sum())
        last = start + walked - 1  # the last entry read, where walked > 0
        chunks += int(torch.where(walked > 0, (last + lead) // per - (start + lead) // per + 1,
                                  0).sum())
        del owner, at, hit, first
    return entries / max(1, keys.numel()), chunks / max(1, keys.numel())


def _time_chained(torch, kcp, ht, name, a, b):
    """The chained-probe kernel alone on one join's table and probe keys:
    median ms of 7 runs (CUDA events) against its bound (the probe keys and
    hashes streamed once at the card's memory rate) and the plain version
    (one run after a warm one), with the random loads a row makes.  The
    counts must agree."""
    table = ht.build_chained(a, SEED, ht.chained_num_buckets(a.numel()))
    hashes = ht.hash_bits(b, SEED)
    mask = table.num_buckets - 1

    def kernel():
        return kcp.chained_count(b, hashes, mask, table.offsets, table.entry_keys)

    def plain():
        return kcp.chained_count_plain(b, hashes, mask, table.offsets, table.entry_keys)

    want = int(torch.isin(b, a).sum())
    got, plain_count = int(kernel()), int(plain())
    _check(f"chained count {name}", got == plain_count == want,
           f"kernel {got}, plain {plain_count}, isin {want}")
    kernel_ms = _median_ms(torch, kernel, 7)
    plain_ms = _median_ms(torch, plain, 1)
    entries, chunks = _chain_reads(torch, table, b, hashes, mask)
    bound = _bound_ms(b.numel() * (b.element_size() + 4))
    log(f"[time chained] {name}: chained_count {kernel_ms:.4f} ms (median of 7; "
        f"{bound / kernel_ms:.1%} of the bound {bound:.4f} ms, {b.element_size() + 4} "
        f"streamed bytes a row); plain "
        f"{plain_ms:.4f} ms; random loads a row: 1 offsets pair + {chunks:.4f} "
        f"16-byte chunks of entries ({entries:.4f} entries walked); max chain "
        f"{int(table.max_chain)}; count {got:,} ok")
    del table, hashes
    torch.cuda.empty_cache()
    return kernel_ms, plain_ms, bound


def parity_chained(torch, device):
    """The chained-probe count kernel (no TPU counterpart) against its plain
    version on the card at every key-width pair, with misses, keys that
    differ only above bit 31, a chain of 4,096 entries, ``skip`` and views
    off a 16-byte boundary; then timed at 10M ⋈ 200M int64 Zipf(1.05) keys
    and at 128M ⋈ 128M uniform unique int32 keys."""
    from partitionedhashjoin_tpu_torch.ops import hash_table as ht
    from partitionedhashjoin_tpu_torch.ops.kernels import chained_probe as kcp

    par = Parity(torch, "chained probe")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 22)
    lo = torch.randint(I32_MIN, I32_MAX, (1_000_003,), generator=gen,
                       dtype=torch.int64, device=device)
    lo[:3] = torch.tensor([I32_MIN, I32_MAX, 0], device=device)
    for kd, ed in ((torch.int32, torch.int32), (torch.int32, torch.int64),
                   (torch.int64, torch.int32), (torch.int64, torch.int64)):
        build = (torch.cat([lo[:600_000], lo[:200_000] + 2**32])
                 if ed == torch.int64 else lo[:600_000]).to(ed)
        probe = lo[300_000:]  # half hit, half miss
        chain_probe = torch.cat([lo[:10_000], lo[300_000:340_000]])  # 4,096 hit
        if kd == torch.int64:
            probe = torch.cat([probe, lo[:100_000] + 2**32, lo[:100_000] ^ (1 << 62)])
            chain_probe = torch.cat([chain_probe, lo[:2_000] + 2**32])
        for tname, table, keys in (
                ("hashed", ht.build_chained(build, SEED,
                                            ht.chained_num_buckets(build.numel())),
                 probe.to(kd)),
                ("one chain", ht.build_chained_from_buckets(
                    torch.zeros(4096, dtype=torch.int32, device=device), build[:4096],
                    SEED, 2), chain_probe.to(kd))):
            chain = tname == "one chain"
            for vname, view in (("aligned", keys), ("off 16 bytes", keys[1:]),
                                ("odd", keys[:-3]), ("tiny", keys[:5])):
                if chain:
                    hashes, mask = torch.zeros_like(view, dtype=torch.int32), 0xFFFFFFFF
                else:
                    hashes = ht.hash_bits(ht._probe_keys(table, view)[1], table.seed)
                    mask = table.num_buckets - 1
                for skip in (0, 7):
                    args = (view, hashes, mask, table.offsets, table.entry_keys, skip)
                    par.check(f"{kd} probe, {ed} {tname} table, {vname}, skip {skip}",
                              lambda: kcp.chained_count(*args),
                              lambda: kcp.chained_count_plain(*args),
                              torch.isin(view[skip:].to(torch.int64),
                                         build[:4096 if chain else None]
                                         .to(torch.int64)).sum())
    del lo
    a, b = _reference_data(torch, device, torch.int64)
    kernel_ms, plain_ms, bound = _time_chained(
        torch, kcp, ht, f"{N_PRIMARY:,} x {N_SECONDARY:,} int64 Zipf({SKEW})", a, b)
    del a, b
    torch.cuda.empty_cache()
    n = N_UNIFORM
    gen.manual_seed(SEED + 128)
    a = (torch.randperm(n, generator=gen, device=device) + 1).to(torch.int32)
    b = (torch.randperm(n, generator=gen, device=device) + 1).to(torch.int32)
    _time_chained(torch, kcp, ht, f"{n:,} x {n:,} uniform unique int32", a, b)
    del a, b
    torch.cuda.empty_cache()
    return {"max_abs_err": par.max_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "library_ms": None}


def _histogram_build(torch, bucket, order, nb):
    """The build's steps after its sort before the build kernel, bar the
    key gather: the ``bincount`` histogram, its scan after a 0, the casts
    and the max."""
    counts = torch.bincount(bucket, minlength=nb)[:nb]
    offsets = torch.cat([counts.new_zeros((1,)), torch.cumsum(counts, 0)])
    return order.to(torch.int32), offsets.to(torch.int32), counts.max().to(torch.int32)


def _time_chained_build(torch, kcp, ht, name, keys):
    """The build kernel alone on a chained cell's build (K7's buckets of
    ``keys`` into ``chained_num_buckets`` buckets): median ms of 7 runs
    (CUDA events) against its bound (its columns streamed once at the
    card's memory rate), the histogram steps it replaced
    (``_histogram_build``, which reads back twice), its plain version and
    the key gather beside it.  All three tables must agree."""
    n = keys.numel()
    nb = ht.chained_num_buckets(n)
    bucket = ht.hash_bits(keys, SEED) & (nb - 1)
    sorted_bucket, order = torch.sort(bucket, stable=True)
    args = (sorted_bucket, order, nb)
    got = kcp.chained_build(*args)
    for other in (kcp.chained_build_plain(*args), _histogram_build(torch, bucket, order, nb)):
        _check(f"chained build {name}",
               all(torch.equal(g, w) for g, w in zip(got, other)), "tables differ")
    kernel_ms = _median_ms(torch, lambda: kcp.chained_build(*args), 7)
    replaced_ms = _median_ms(torch, lambda: _histogram_build(torch, bucket, order, nb), 7)
    plain_ms = _median_ms(torch, lambda: kcp.chained_build_plain(*args), 1)
    gather_ms = _median_ms(torch, lambda: keys[order], 7)
    streamed = n * (sorted_bucket.element_size() + 8 + 4) + (nb + 1) * 4
    bound = _bound_ms(streamed)
    log(f"[time chained build] {name}: chained_build {kernel_ms:.4f} ms (median of 7; "
        f"{bound / kernel_ms:.1%} of the bound {bound:.4f} ms, {streamed:,} bytes: ids, "
        f"order, entry rows, offsets); the histogram steps it replaced "
        f"{replaced_ms:.4f} ms; plain {plain_ms:.4f} ms; the key gather beside it "
        f"{gather_ms:.4f} ms; max chain {int(got[2])}; {n:,} rows, {nb:,} buckets ok")
    del bucket, sorted_bucket, order, got, args
    torch.cuda.empty_cache()
    return kernel_ms, plain_ms, bound


def parity_chained_build(torch, device):
    """The chained build kernel (no TPU counterpart) against its plain
    version on the card at both id widths: random ids at load 1, a chain of
    100,001 rows, gaps of 999 empty buckets, ids up to 2^31 - 1 (2^40 at
    int64) past the table, ids below 0, 1 to 9 rows, and the columns one
    element off their 16-byte alignment; then timed at the two chained
    cells' builds."""
    from partitionedhashjoin_tpu_torch.ops import hash_table as ht
    from partitionedhashjoin_tpu_torch.ops.kernels import chained_probe as kcp

    par = Parity(torch, "chained build")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 25)

    def ids(lo, hi, n, dtype):
        return torch.randint(lo, hi, (n,), generator=gen, device=device).to(dtype)

    def off16(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
        buf[1:] = t
        return buf[1:]

    for id_dtype in (torch.int32, torch.int64):
        top = I32_MAX if id_dtype == torch.int32 else 2**40
        cases = (
            ("random", ids(0, 1 << 20, 1_000_003, id_dtype), 1 << 20),
            ("one chain", torch.full((100_001,), 3, dtype=id_dtype, device=device), 8),
            ("gaps", ids(0, 1000, 30_007, id_dtype) * 1000, 1_000_003),
            ("past the table", torch.cat([ids(0, 4097, 20_000, id_dtype),
                                          ids(4097, top, 5_000, id_dtype)]), 4096),
            ("below 0", ids(-50, 600, 9_999, id_dtype), 512),
            *((f"{n} rows", ids(0, 6, n, id_dtype), 5) for n in (1, 2, 3, 5, 9)),
        )
        for cname, bucket, nb in cases:
            sorted_bucket, order = torch.sort(bucket, stable=True)
            for vname, cols in (("aligned", (sorted_bucket, order)),
                                ("off 16 bytes", (off16(sorted_bucket), off16(order)))):
                par.check_tensors(f"{id_dtype} ids, {cname}, {vname}",
                                  lambda: kcp.chained_build(*cols, nb),
                                  lambda: kcp.chained_build_plain(*cols, nb))
    a, _ = _reference_data(torch, device, torch.int64)
    kernel_ms, plain_ms, bound = _time_chained_build(
        torch, kcp, ht, f"{N_PRIMARY:,} int64 keys", a)
    del a
    torch.cuda.empty_cache()
    gen.manual_seed(SEED + 128)
    a = (torch.randperm(N_UNIFORM, generator=gen, device=device) + 1).to(torch.int32)
    _time_chained_build(torch, kcp, ht, f"{N_UNIFORM:,} uniform unique int32 keys", a)
    del a
    torch.cuda.empty_cache()
    return {"max_abs_err": par.max_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "library_ms": None}


def _sass_mixes(sass, function, loop):
    """SASS instructions of one round of the Zipf sampler, by opcode, in the
    function of ``cuobjdump -sass`` output ``sass`` whose mangled name
    contains ``function``: with ``loop``, its step loop (the widest backward
    branch), else its body up to the first unguarded EXIT.  Returns the
    shortest path in instructions through that region that passes its first
    MUFU (the first ``powf``, which every round evaluates), and the shortest
    that passes every MUFU (a round whose sample exceeds 1 also evaluates
    the third ``powf`` and a division).  Special cases of ``powf`` and the
    division's slow path lie off both, so each is a least count for its
    kind of round.  Returns ({opcode: count} of the first, of the second);
    the moves ``IMAD.MOV`` and ``HFMA2`` of a constant (``HFMA2.MOV``) are
    counted apart from ``IMAD`` and ``HFMA2``."""
    import re

    body = None
    for part in sass.split("Function : ")[1:]:
        if function in part.split(None, 1)[0]:
            body = part
    if body is None:
        raise AssertionError(f"[bound K8] no function {function} in the SASS")
    # (address, opcode, guarded, branch target or None)
    code, labels, pending = [], {}, []
    for line in body.splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for name in pending:
            labels[name] = addr
        pending = []
        words = m.group(2).split()
        guard = words.pop(0) if words[0].startswith("@") else None
        if guard == "@!PT":
            continue  # never runs
        op = words[0].split(".")[0]
        if words[0].startswith("IMAD.MOV"):
            op = "IMAD.MOV"
        elif op == "HFMA2" and words[2:4] == ["-RZ,", "RZ,"]:
            op = "HFMA2.MOV"  # -0 * 0 + a constant: a move
        target = None
        if op == "BRA":
            t = re.search(r"(\.L_x_\d+|0x[0-9a-f]+)", " ".join(words[1:]))
            target = t.group(1)
        code.append([addr, op, guard not in (None, "@PT")
                     or (op == "BRA" and "," in " ".join(words[1:])), target])
    for ins in code:
        if ins[3] is not None:
            ins[3] = labels[ins[3]] if ins[3] in labels else int(ins[3], 16)
    if loop:
        back = [ins for ins in code if ins[3] is not None and ins[3] < ins[0]]
        if not back:
            raise AssertionError(f"[bound K8] no loop in {function}")
        tail = max(back, key=lambda ins: ins[0] - ins[3])
        region = [ins for ins in code if tail[3] <= ins[0] <= tail[0]]
    else:
        tail = None
        end = next(i for i, ins in enumerate(code)
                   if ins[1] == "EXIT" and not ins[2])
        region = code[:end + 1]
    # basic blocks: a block starts at the head, at a branch target and
    # after a branch or exit
    starts = {region[0][0]} | {ins[3] for ins in region if ins[3] is not None}
    starts |= {b[0] for a, b in zip(region, region[1:])
               if a[1] in ("BRA", "EXIT")}
    blocks, index = [], {}
    for ins in region:
        if ins[0] in starts or not blocks:
            index[ins[0]] = len(blocks)
            blocks.append([])
        blocks[-1].append(ins)
    succ = []
    for i, block in enumerate(blocks):
        last = block[-1]
        nxt = [i + 1] if i + 1 < len(blocks) else []
        if last[1] == "BRA" and last is not tail:
            to = [index[last[3]]] if last[3] in index else []
            succ.append(to + nxt if last[2] else to)
        elif last[1] == "EXIT":
            succ.append(nxt if last[2] else [])
        else:
            succ.append(nxt)
    mufu = [i for i, b in enumerate(blocks) if any(x[1] == "MUFU" for x in b)]

    def shortest(src, dst):
        """Fewest instructions on a path src -> dst (blocks in address
        order; every edge but a loop's back edge goes forward)."""
        best = {src: (len(blocks[src]), [src])}
        for i in range(src, dst + 1):
            if i in best:
                for j in succ[i]:
                    cand = best[i][0] + len(blocks[j])
                    if j <= dst and (j not in best or cand < best[j][0]):
                        best[j] = (cand, best[i][1] + [j])
        return best[dst][1]

    def mix_through(stops):
        path, at = [0], 0
        for stop in [*stops, len(blocks) - 1]:
            path += shortest(at, stop)[1:]
            at = stop
        mix = {}
        for i in path:
            for ins in blocks[i]:
                mix[ins[1]] = mix.get(ins[1], 0) + 1
        return mix

    return mix_through(mufu[:1]), mix_through(mufu)


def _k8_bound(torch, card_line, rounds):
    """K8's least time at this run's rounds (``_k8_rounds``): the larger of
    its writes and the busiest pipe (``SASS_PIPES``, and the issue slots),
    counting for each round the least SASS instructions of its kind of
    round in ``zipf_round_kernel`` (one round as straight-line code), less
    the opcodes that do none of its work (``SASS_NOT_WORK``), on every SM at
    the card's top SM clock.  The step of ``zipf_kernel<false>`` is counted
    too, all of it, and its excess over the round printed as the schedule's
    overhead; the bound does not count it."""
    from pathlib import Path

    from partitionedhashjoin_tpu_torch.ops.kernels import _build

    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(_build.library_path("generate"))],
        capture_output=True, text=True, timeout=120, check=True).stdout
    whole = _sass_mixes(sass, "zipf_round_kernel", loop=False)
    short, long = ({op: c for op, c in mix.items() if op not in SASS_NOT_WORK}
                   for mix in whole)
    steps = _sass_mixes(sass, "zipf_kernelILb0E", loop=True)
    total, above_1 = rounds
    lanes = {op: short.get(op, 0) * (total - above_1) + long.get(op, 0) * above_1
             for op in {*short, *long}}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    clock_hz = float(smi.stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_ms = sms * clock_hz * 1e-3  # SM clocks per ms
    pipes = {"issue": sum(lanes.values()) / (ISSUE_LANES * per_ms)}
    for name, rate, ops in SASS_PIPES:
        pipes[name] = sum(lanes.get(op, 0) for op in ops) / (rate * per_ms)
    writes_ms = _bound_ms(N_SECONDARY * 4)
    by = max(pipes, key=pipes.get)

    def listed(mix):
        return dict(sorted(mix.items(), key=lambda kv: -kv[1]))

    def left_out(work, mix):
        return listed({op: c for op, c in mix.items() if op not in work})

    log(f"[bound K8] least SASS instructions of a round (zipf_round_kernel, "
        f"the opcodes of SASS_NOT_WORK left out): {sum(short.values())} for "
        f"a round whose sample is 1 {listed(short)}, {sum(long.values())} for "
        f"one above 1 {listed(long)}; left out {left_out(short, whole[0])} "
        f"and {left_out(long, whole[1])}")
    log(f"[bound K8] a step of zipf_kernel<false>, all of it: "
        f"{sum(steps[0].values())} and {sum(steps[1].values())} instructions, "
        f"so the schedule's overhead (loop, refill, branches, moves) is "
        f"{sum(steps[0].values()) - sum(short.values())} and "
        f"{sum(steps[1].values()) - sum(long.values())} a step, not counted "
        f"in the bound; step mix above 1 {listed(steps[1])}")
    log(f"[bound K8] {total:,} rounds, {above_1:,} above 1; {sms} SMs at "
        f"{clock_hz / 1e6:.0f} MHz (clocks.max.sm; {card_line}): pipes (ms) "
        f"{ {k: round(v, 4) for k, v in pipes.items()} }, writes "
        f"{writes_ms:.4f} ms; bound by {by}")
    return max(writes_ms, pipes[by])


def _k8_rounds(torch, n, card, device):
    """(rounds the sampler evaluates for slots [0, n) of this run's seed,
    those whose sample exceeds 1): each slot's rounds up to its first
    accept, or all 16 (the plain version's uniforms and arithmetic)."""
    from partitionedhashjoin_tpu_torch.ops import generators
    from partitionedhashjoin_tpu_torch.ops.kernels import generate as kg

    todo = torch.arange(n, dtype=torch.int64, device=device)
    total = above_1 = 0
    for r in range(16):
        if todo.numel() == 0:
            break
        total += todo.numel()
        u1, u2, u3 = kg.philox_uniforms_plain(SEED, todo, r)
        sample, ok = generators.zipf_candidates(u1, u2, SKEW, card, u3=u3)
        above_1 += int((sample > 1).sum())
        todo = todo[~ok]
    return total, above_1


def parity_k8(torch, device, card_line):
    """K8's uniforms against the plain Philox bit for bit; its keys against
    the plain version (at most 1e-4 differ, each by at most 2), at 4M and at
    the main path's 200M keys over [1, 10M], and with 1 round; exactly with
    0 rounds; a prefix of n keys equals the keys drawn for the prefix's
    length exactly; timed at 200M."""
    from partitionedhashjoin_tpu_torch.ops import generators
    from partitionedhashjoin_tpu_torch.ops.kernels import generate as kg

    par = Parity(torch, "K8")
    n = 4_000_000
    for r in (0, 3, 15):
        par.check_tensors(f"uniforms round {r}, {n:,} slots",
                          lambda: kg.philox_uniforms(SEED, n, r, device=device),
                          lambda: kg.philox_uniforms_plain(
                              SEED, torch.arange(n, device=device), r))

    def keys_within(name, n, card, rounds=16):
        got = kg.zipf_keys_pallas(SEED, n, SKEW, card, rounds, device=device)
        want = kg.zipf_keys_plain(SEED, n, SKEW, card, rounds, device=device)
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        err = int((got - want).abs().max())
        par.max_err = max(par.max_err, err)
        if differ > n * 1e-4 or err > 2 or int(got.min()) < 1 or int(got.max()) > card:
            raise AssertionError(f"[parity K8] {name}: {differ} keys differ, "
                                 f"by at most {err}")
        log(f"[parity K8] {name}: {differ} of {n:,} keys differ from the plain "
            f"version, by at most {err}: ok")
        return got

    for card in (500, N_PRIMARY, 100_000_000):
        keys_within(f"card {card:,}", n, card)
    keys_within(f"card {N_PRIMARY:,}, 1 round", n, N_PRIMARY, rounds=1)
    par.check_tensors(f"card {N_PRIMARY:,}, 0 rounds (every key 1)",
                      lambda: [kg.zipf_keys_pallas(SEED, n, SKEW, N_PRIMARY, 0,
                                                   device=device)],
                      lambda: [torch.ones(n, dtype=torch.int32, device=device)])
    main = keys_within(f"main {N_SECONDARY:,} keys over [1, {N_PRIMARY:,}]",
                       N_SECONDARY, N_PRIMARY)
    # the prefix property: a slot's key does not depend on n, on the warp
    # that drew it or on the step it was drawn in
    for m in (1, 33, 2_047, 1_000_003, n + 5):
        par.check_tensors(f"prefix: first {m:,} of {N_SECONDARY:,} keys",
                          lambda: [main[:m]],
                          lambda: [kg.zipf_keys_pallas(SEED, m, SKEW, N_PRIMARY,
                                                       device=device)])
    del main
    kernel_ms = _time_ms(torch, lambda: kg.zipf_keys_pallas(
        SEED, N_SECONDARY, SKEW, N_PRIMARY, device=device), reps=5)
    plain_ms = _time_ms(torch, lambda: kg.zipf_keys_plain(
        SEED, N_SECONDARY, SKEW, N_PRIMARY, device=device), reps=1)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    context_ms = _time_ms(torch, lambda: generators.zipf_keys(
        N_SECONDARY, SKEW, N_PRIMARY, gen, device), reps=1)
    rounds = _k8_rounds(torch, N_SECONDARY, N_PRIMARY, device)
    bound = _k8_bound(torch, card_line, rounds)
    log(f"[time K8] zipf_keys_pallas, {N_SECONDARY:,} keys over [1, "
        f"{N_PRIMARY:,}]: kernel {kernel_ms:.4f} ms ({bound / kernel_ms:.1%} of "
        f"the bound {bound:.4f} ms), plain {plain_ms:.4f} ms, "
        f"generators.zipf_keys (context, not the same function) "
        f"{context_ms:.4f} ms; {rounds[0] / N_SECONDARY:.6f} rounds per key "
        f"(measured: {rounds[0]:,} rounds)")
    return {"max_abs_err": par.max_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "library_ms": None}


# ---------------------------------------------------------------- paths


def _counters():
    from partitionedhashjoin_tpu_torch.ops.kernels import bitonic_sort as bs
    from partitionedhashjoin_tpu_torch.ops.kernels import chained_probe as kcp
    from partitionedhashjoin_tpu_torch.ops.kernels import compact as kc
    from partitionedhashjoin_tpu_torch.ops.kernels import generate as kg
    from partitionedhashjoin_tpu_torch.ops.kernels import merge_count as mc
    from partitionedhashjoin_tpu_torch.ops.kernels import merge_payload as mpay
    from partitionedhashjoin_tpu_torch.ops.kernels import merge_probe as mp

    return mp, mc, mpay, kc, bs, kg, kcp


def _reset_counts():
    mp, mc, mpay, kc, bs, kg, kcp = _counters()
    mp.LAUNCHES = mp.LAUNCHES_I64 = mc.LAUNCHES = mpay.LAUNCHES = 0
    kc.LAUNCHES = bs.LAUNCHES_BLOCKS = bs.LAUNCHES_MERGE = 0
    bs.LAUNCHES_UPSWEEP = bs.LAUNCHES_SORT = bs.SWEEPS_SKIPPED = 0
    kg.LAUNCHES_HASH = kg.LAUNCHES_HASH64 = kg.LAUNCHES_ZIPF = 0
    kg.LAUNCHES_UNIFORMS = kcp.LAUNCHES_CHAINED_COUNT = kcp.LAUNCHES_CHAINED_BUILD = 0


def _read_counts():
    mp, mc, mpay, kc, bs, kg, kcp = _counters()
    return {"k1": mp.LAUNCHES, "k3": mp.LAUNCHES_I64, "k2": mc.LAUNCHES,
            "k4": mpay.LAUNCHES, "k5": kc.LAUNCHES,
            "k6a": bs.LAUNCHES_BLOCKS, "k6b": bs.LAUNCHES_MERGE,
            "k6": bs.LAUNCHES_UPSWEEP + bs.LAUNCHES_SORT,
            "k7": kg.LAUNCHES_HASH, "k7i64": kg.LAUNCHES_HASH64,
            "k8": kg.LAUNCHES_ZIPF, "chained": kcp.LAUNCHES_CHAINED_COUNT,
            "chained_build": kcp.LAUNCHES_CHAINED_BUILD}


def _k6_sweeps():
    """K6's sweeps since the last reset: (launched, skipped by its plans)."""
    bs = _counters()[4]
    return bs.LAUNCHES_SORT, bs.SWEEPS_SKIPPED


def phase_library(torch, device, launches):
    """Library entry points at 10M ⋈ 200M; adds each path's launches."""
    from partitionedhashjoin_tpu_torch.ops import merge_join, sort_merge

    def run(name, fn, want, kernel):
        _reset_counts()
        t0 = time.perf_counter()
        got = int(fn())
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = _read_counts()
        sweeps = _k6_sweeps()
        if got != want or counts[kernel] == 0:
            raise AssertionError(
                f"[library] {name}: {got} (want {want}), launches {counts}"
            )
        launches[kernel] += counts[kernel]
        log(f"[library] {name}: {got} ok, {kernel} launches "
            f"{counts[kernel]}, K6 launches {counts['k6']} (sweeps launched / "
            f"skipped {sweeps[0]} / {sweeps[1]}), {wall_ms:.3f} ms host clock")

    a, b = _reference_data(torch, device, torch.int32)
    run("sort_merge_count int32", lambda: sort_merge.sort_merge_count(a, b),
        N_SECONDARY, "k2")
    run("anti_count int32", lambda: sort_merge.anti_count(a, b), 0, "k2")
    del a, b
    a, b = _reference_data(torch, device, torch.int64)
    run("two_run_count_i64", lambda: merge_join.two_run_count_i64(a, b),
        N_SECONDARY, "k3")
    prepared = merge_join.PreparedBuild(a)
    run("PreparedBuild(int64).count", lambda: prepared.count(b),
        N_SECONDARY, "k3")
    del a, b, prepared


class _JoinCounts(logging.Filter):
    """Collects the counts the CLI logs as "Join produced %d matches", and
    what the shuffle join logs of each run ("Shuffle run: %s")."""

    def __init__(self):
        super().__init__()
        self.counts = []
        self.shuffle_runs = []

    def filter(self, record):
        if record.msg == "Join produced %d matches":
            self.counts.append(int(record.args[0]))
        elif record.msg == "Shuffle run: %s":
            self.shuffle_runs.append(record.args[0])
        return True


def phase_main(torch, launches, runs=MAIN_RUNS, tag="main", kernels=()):
    """``cli.main`` for every path of ``runs``; each must launch its own
    kernels and ``kernels``; adds each path's launches."""
    from partitionedhashjoin_tpu_torch import cli

    base = {
        "PrimaryRelationSize": str(N_PRIMARY),
        "SecondaryRelationSize": str(N_SECONDARY),
        "Skew": f"{SKEW:.6f}",
    }
    for extra_argv, params, own in runs:
        argv = extra_argv + [
            "--primary", str(N_PRIMARY), "--secondary", str(N_SECONDARY),
            "--skew", str(SKEW), "--seed", str(SEED), "--output", "stdout",
            "--platform", "cuda",
        ]
        name = " ".join(extra_argv) or "(default join)"
        must = tuple(own) + tuple(kernels)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        counts = _JoinCounts()
        logger = logging.getLogger("phjoin_torch")
        logger.addFilter(counts)
        out = io.StringIO()
        _reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        wall_s = time.perf_counter() - t0
        run_counts = _read_counts()
        sweeps = _k6_sweeps()
        logger.removeFilter(counts)
        peak = torch.cuda.max_memory_allocated()
        doc = json.loads(out.getvalue())
        if rc != 0 or counts.counts != [N_SECONDARY]:
            raise AssertionError(f"[{tag}] {name}: rc {rc}, counts {counts.counts}")
        for k in must:
            if run_counts[k] == 0:
                raise AssertionError(f"[{tag}] {name}: {k} was never launched")
        if doc.get("id") != "hashjointimingresult" or doc["parameters"] != {
            **base, **params
        } or set(doc["results"]) != {"partition", "build", "probe"}:
            raise AssertionError(f"[{tag}] {name}: unexpected document {doc}")
        for k in must:
            launches[k] += run_counts[k]
        res = doc["results"]
        log(f"[{tag}] {name}: result {json.dumps(doc, sort_keys=True)}")
        log(
            f"[{tag}] {name}: count {counts.counts[0]}, launches {run_counts}, "
            f"K6 sweeps launched / skipped {sweeps[0]} / {sweeps[1]}, "
            f"phases partition {res['partition']} / build {res['build']} / "
            f"probe {res['probe']} ms, cli.main wall {wall_s:.3f} s "
            f"(generation + warmup + timed run), peak allocated {peak} B"
        )
        for run in counts.shuffle_runs:
            log(f"[{tag}] {name}: {_describe_shuffle(run)}")


def _query_relations(torch, device):
    """The pipeline's relations at 10M ⋈ 200M: build keys 1..N with payload
    key ^ 0x5A17, Zipf(1.05) probe keys and probe payloads uniform in
    [0, 2^20), from the seeds of scripts/bench_pipeline.py."""
    from partitionedhashjoin_tpu_torch import bench_pipeline

    return bench_pipeline.make_relations(N_PRIMARY, N_SECONDARY, device)


def _check(name, ok, detail=""):
    if not ok:
        raise AssertionError(f"[check] {name}: {detail}")


def _wrap_i32(x):
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _group_oracle(torch, b_keys, b_pay):
    """Per distinct probe key, ascending: (keys, COUNT by bincount, SUM by
    int64 scatter_add then mod 2^32, MIN, MAX by scatter_reduce)."""
    counts = torch.bincount(b_keys, minlength=N_PRIMARY + 1)
    present = counts > 0
    idx = b_keys.to(torch.int64)
    size = (N_PRIMARY + 1,)
    sums = torch.zeros(size, dtype=torch.int64, device=b_keys.device)
    sums.scatter_add_(0, idx, b_pay.to(torch.int64))
    mins = torch.full(size, 2**31 - 1, dtype=torch.int32, device=b_keys.device)
    mins.scatter_reduce_(0, idx, b_pay, "amin")
    maxs = torch.full(size, -(2**31), dtype=torch.int32, device=b_keys.device)
    maxs.scatter_reduce_(0, idx, b_pay, "amax")
    keys = torch.nonzero(present).squeeze(1).to(torch.int32)
    return {"keys": keys, "count": counts[present].to(torch.int32),
            "sum": _wrap_i32(sums[present]).to(torch.int32),
            "min": mins[present], "max": maxs[present]}


def _exact_distinct(torch, device, alpha, card, n):
    """Expected distinct keys of n draws from the exact Zipf(alpha) over
    [1, card]: sum over k of 1 - (1 - p_k)^n, in float64."""
    k = torch.arange(1, card + 1, dtype=torch.float64, device=device)
    p = k ** -alpha
    p /= p.sum()
    return float((-torch.expm1(n * torch.log1p(-p))).sum())


def _zipf_reach(torch, device):
    """(keys the Zipf sampler can draw at all, expected distinct keys of an
    exact Zipf(SKEW) in N_SECONDARY draws): every float32 uniform in
    [0, 1) through the sampler's inverse CDF, and the float64 law."""
    from partitionedhashjoin_tpu_torch.ops import generators

    u = torch.arange(1 << 24, dtype=torch.float32, device=device) * 2.0**-24
    keys, _ = generators.zipf_candidates(u, torch.zeros_like(u), SKEW, N_PRIMARY)
    reach = int(torch.unique(keys).numel())
    return reach, _exact_distinct(torch, device, SKEW, N_PRIMARY, N_SECONDARY)


def _run_path(torch, tag, launches, name, fn, kernels):
    """Runs ``fn`` with every count set to 0 just before and read just
    after; each of ``kernels`` must have launched, and its launches are
    added to ``launches``.  Returns what ``fn`` returned."""
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = _read_counts()
    sweeps = _k6_sweeps()
    for k in kernels:
        _check(name, counts[k] > 0, f"{k} was never launched ({counts})")
        launches[k] += counts[k]
    log(f"[{tag}] {name}: {wall_ms:.3f} ms host clock, launches "
        f"{ {k: v for k, v in counts.items() if v} }, K6 sweeps launched / "
        f"skipped {sweeps[0]} / {sweeps[1]}")
    return out


def phase_query(torch, device, launches):
    """The materializing joins and the JOIN → GROUP BY → top-10 pipeline at
    10M ⋈ 200M; adds each path's K4/K5/K6 launches."""
    from partitionedhashjoin_tpu_torch import bench_pipeline
    from partitionedhashjoin_tpu_torch.data.table import make_table
    from partitionedhashjoin_tpu_torch.ops import aggregate, merge_join
    from partitionedhashjoin_tpu_torch.ops.sort_merge import SortMergeJoiner

    run = functools.partial(_run_path, torch, "query", launches)

    a_keys, a_pay, b_keys, b_pay = _query_relations(torch, device)
    keys, pa, pb, count = run(
        "two_run_materialize (all match)",
        lambda: merge_join.two_run_materialize(a_keys, a_pay, b_keys, b_pay),
        ("k6", "k4"))
    _check("two_run_materialize", int(count) == N_SECONDARY, f"count {int(count)}")
    _check("two_run_materialize", torch.equal(keys, torch.sort(b_keys).values),
           "keys differ from torch.sort's")
    _check("two_run_materialize", torch.equal(pa, keys ^ SALT), "pay_a")
    _check("two_run_materialize",
           int(pb.sum(dtype=torch.int64)) == int(b_pay.sum(dtype=torch.int64)),
           "pay_b sum")
    del keys, pa, pb
    log(f"[query] two_run_materialize: {int(count):,} rows, keys == torch.sort, "
        f"pay_a == key ^ 0x5A17, pay_b sum kept: ok")

    # half the probe keys miss: the compaction runs
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 6)
    b_half = torch.randint(1, 2 * N_PRIMARY + 1, (N_SECONDARY,), generator=gen,
                           dtype=torch.int32, device=device)
    keys, pa, pb, count = run(
        "two_run_materialize (half miss)",
        lambda: merge_join.two_run_materialize(a_keys, a_pay, b_half, b_pay),
        ("k6", "k4", "k5"))
    hit = b_half <= N_PRIMARY
    c = int(count)
    _check("half miss", c == int(hit.sum()), f"count {c}")
    _check("half miss", bool((keys[1:c] >= keys[: c - 1]).all())
           and bool((keys[:c] <= N_PRIMARY).all()), "keys")
    _check("half miss", torch.equal(pa[:c], keys[:c] ^ SALT), "pay_a")
    _check("half miss", int(pb.sum(dtype=torch.int64))
           == int(torch.where(hit, b_pay, 0).sum(dtype=torch.int64)), "pay_b")
    _check("half miss", not keys[c:].any() and not pa[c:].any()
           and not pb[c:].any(), "zero tail")
    log(f"[query] two_run_materialize half miss: {c:,} of {N_SECONDARY:,} "
        "rows, compacted, zero tail: ok")
    del keys, pa, pb, b_half, hit

    table_a, table_b = make_table(a_keys, a_pay), make_table(b_keys, b_pay)
    joined = run("run_materialize inner (probe order)",
                 lambda: SortMergeJoiner().run_materialize(table_a, table_b), ())
    _check("run_materialize inner", int(joined.count) == N_SECONDARY
           and torch.equal(joined.keys, b_keys)
           and torch.equal(joined.payloads_a, b_keys ^ SALT)
           and torch.equal(joined.payloads_b, b_pay), "rows")
    del joined
    joined = run("run_materialize anti (probe order)",
                 lambda: SortMergeJoiner().run_materialize(
                     table_a, table_b, join_type="anti"), ())
    _check("run_materialize anti", int(joined.count) == 0
           and not joined.keys.any(), f"count {int(joined.count)}")
    del joined, table_a, table_b
    log("[query] run_materialize inner (every probe row, in probe order) and "
        "anti (none): ok")

    rel = (a_keys, a_pay, b_keys, b_pay)
    results = {}
    for plan, ordered in (("ordered", True), ("naive", False)):
        results[plan] = run(
            f"pipeline {plan} plan",
            lambda: bench_pipeline.run_query(*rel, GROUP_CAPACITY, ordered),
            ("k6", "k4", "k5"))
    (g1, hot1, c1), (g2, hot2, c2) = results.values()
    _check("pipeline", int(c1) == int(c2) == N_SECONDARY, "counts")
    _check("pipeline", bench_pipeline.plans_agree(g1, g2)
           and torch.equal(hot1.keys, hot2.keys), "plans disagree")
    want = _group_oracle(torch, b_keys, b_pay)
    groups = want["keys"].shape[0]
    _check("pipeline", int(g1.num_groups) == groups, f"{int(g1.num_groups)} groups")
    for f, w in want.items():
        _check("pipeline", torch.equal(getattr(g1, f)[:groups], w), f"oracle {f}")
    top = torch.sort(want["count"], descending=True, stable=True).values[:10]
    _check("pipeline", torch.equal(hot1.keys, top), "top-10 counts")
    log(f"[query] pipeline: {groups:,} groups; ordered == naive on every "
        f"field; == bincount / scatter_add mod 2^32 oracle; top-10 counts "
        f"{hot1.keys.tolist()}")
    reach, exact = _zipf_reach(torch, device)
    _check("pipeline", groups <= reach, f"{groups} groups > {reach} keys")
    log(f"[query] Zipf keys reachable from float32 uniforms: {reach:,}; "
        f"expected distinct keys of an exact Zipf({SKEW}) in "
        f"{N_SECONDARY:,} draws: {exact:,.1f}")
    del results, g1, hot1, g2, hot2, want, rel

    table = make_table(b_keys, torch.arange(N_SECONDARY, dtype=torch.int32,
                                            device=device))
    del a_keys, a_pay, b_pay

    def even(k, p):
        return (p & 1) == 0

    staged, n_staged = run(
        "filter_sort_aggregate_staged",
        lambda: aggregate.filter_sort_aggregate_staged(
            table, even, group_capacity=GROUP_CAPACITY), ("k5", "k6"))
    fused, n_fused = run(
        "filter_sort_aggregate",
        lambda: aggregate.filter_sort_aggregate(
            table, even, group_capacity=GROUP_CAPACITY), ("k5", "k6"))
    _check("staged filter", int(n_staged) == int(n_fused) == N_SECONDARY // 2
           and bench_pipeline.plans_agree(staged, fused), "staged != fused")
    log(f"[query] staged filter aggregate == fused: {int(staged.num_groups):,}"
        f" groups of {int(n_staged):,} rows: ok")


def phase_generate(torch, device, launches):
    """Phase 8: the generation kernels on the main path's scale; adds each
    path's launches."""
    from partitionedhashjoin_tpu_torch.ops import generators, hashing, merge_join
    from partitionedhashjoin_tpu_torch.ops.kernels import generate as kg

    run = functools.partial(_run_path, torch, "generate", launches)

    _, b = _reference_data(torch, device, torch.int32)
    h = run(f"hash_keys over {N_SECONDARY:,} probe keys",
            lambda: kg.hash_keys(b, SEED), ("k7",))
    _check("hash_keys", torch.equal(h.view(torch.int32),
                                    hashing.hash32(b, SEED).view(torch.int32)),
           "differs from hashing.hash32")
    del b, h
    keys = run(f"zipf_keys_pallas {N_SECONDARY:,} keys over [1, {N_PRIMARY:,}]",
               lambda: kg.zipf_keys_pallas(SEED, N_SECONDARY, SKEW, N_PRIMARY,
                                           device=device), ("k8",))
    a = generators.sequential_keys(N_PRIMARY, device=device)
    count = run("two_run_count against the sequential build",
                lambda: merge_join.two_run_count(a, keys), ("k1",))
    _check("generated join", int(count) == N_SECONDARY, f"count {int(count)}")
    freq = torch.bincount(keys, minlength=N_PRIMARY + 1)[1:].to(torch.float64)
    distinct = int((freq > 0).sum())
    k = torch.arange(1, N_PRIMARY + 1, dtype=torch.float64, device=device)
    pmf = k ** -SKEW
    pmf /= pmf.sum()
    tv_hot = 0.5 * float((freq[:1000] / N_SECONDARY - pmf[:1000]).abs().sum())
    # keys reachable at all: every 23-bit uniform through the sampler (K8),
    # every float32 uniform (generators.zipf_keys)
    u = torch.arange(1 << 23, dtype=torch.float32, device=device) * 2.0**-23
    reach23 = int(torch.unique(generators.zipf_candidates(
        u, torch.zeros_like(u), SKEW, N_PRIMARY)[0]).numel())
    reach24, _ = _zipf_reach(torch, device)
    _check("generated keys", distinct <= reach23, f"{distinct} > {reach23}")
    log(f"[generate] join of the generated keys: {int(count):,} ok; TV distance "
        f"of the 1,000 hottest keys' frequencies from the exact Zipf({SKEW}) "
        f"pmf {tv_hot:.6f}; distinct keys drawn {distinct:,} of {reach23:,} "
        f"reachable from 23-bit uniforms (generators.zipf_keys: {reach24:,} "
        f"reachable from float32 uniforms)")


def phase_alias(torch, device, launches, card_line):
    """Phase 9: the alias sampler at 10M ⋈ 200M — the host tables, 200M
    draws timed with CUDA events, the CLI's generation (``zipf_table``
    with ``method="alias"`` and the seed of phase 5) joined against the
    sequential build, and its distinct keys against the exact law.
    Returns the 200M keys."""
    from partitionedhashjoin_tpu_torch.data import host_loader
    from partitionedhashjoin_tpu_torch.ops import generators, merge_join

    t0 = time.perf_counter()
    prob, alias = host_loader.build_zipf_alias(SKEW, N_PRIMARY)
    table_s = time.perf_counter() - t0
    prob = torch.from_numpy(prob).to(device)
    alias = torch.from_numpy(alias).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    draw_ms = _time_ms(torch, lambda: generators.zipf_keys_alias(
        N_SECONDARY, prob, alias, gen, device), reps=5)
    del prob, alias
    log(f"[time alias] {card_line}: host alias tables ({N_PRIMARY:,} keys) "
        f"{table_s * 1e3:.3f} ms host clock; zipf_keys_alias {N_SECONDARY:,} "
        f"draws {draw_ms:.4f} ms ({N_SECONDARY / (draw_ms * 1e-3):.4e} keys/s, "
        "CUDA events)")

    run = functools.partial(_run_path, torch, "alias", launches)
    keys = run(f"zipf_table(method='alias') {N_SECONDARY:,} keys over "
               f"[1, {N_PRIMARY:,}]", lambda: generators.zipf_table(
                   N_SECONDARY, SKEW, (1, N_PRIMARY), seed=SEED,
                   method="alias", device=device).keys, ())
    a = generators.sequential_keys(N_PRIMARY, device=device)
    count = run("two_run_count against the sequential build",
                lambda: merge_join.two_run_count(a, keys), ("k1",))
    _check("alias join", int(count) == N_SECONDARY, f"count {int(count)}")
    distinct = int((torch.bincount(keys, minlength=N_PRIMARY + 1)[1:] > 0).sum())
    reach, exact = _zipf_reach(torch, device)
    _check("alias distinct keys", abs(distinct / exact - 1) <= 0.005,
           f"{distinct} against {exact:.1f}")
    log(f"[alias] join {int(count):,} ok; distinct keys {distinct:,} against "
        f"the exact law's {exact:,.1f} ({(distinct / exact - 1) * 100:+.4f}%, "
        f"gate ±0.5%); the rejection sampler reaches {reach:,}")
    return a, keys


def phase_multi_key(torch, launches, a, b, card_line):
    """Phase 10: composite-key counts at 10M ⋈ 200M — the keys of phase 9
    split into 2 columns (K6 and K3 on the packed pair) and 3 columns (the
    lexicographic sort-merge path), each equal to the native host join
    count of the unsplit keys."""
    from partitionedhashjoin_tpu_torch.data import host_loader
    from partitionedhashjoin_tpu_torch.ops import multi_key

    t0 = time.perf_counter()
    want = host_loader.host_join_count(a.cpu().numpy(), b.cpu().numpy())
    log(f"[multi-key] oracle host_join_count of the unsplit keys: {want:,} "
        f"({(time.perf_counter() - t0) * 1e3:.3f} ms host clock)")
    _check("multi-key oracle", want == N_SECONDARY, f"{want}")
    splits = {
        2: lambda k: (k >> 12, k & 4095),
        3: lambda k: (k >> 20, (k >> 10) & 1023, k & 1023),
    }
    run = functools.partial(_run_path, torch, "multi-key", launches)
    for k, split in splits.items():
        cols_a, cols_b = split(a), split(b)
        got = run(f"multi_key_count k={k}",
                  lambda: multi_key.multi_key_count(cols_a, cols_b),
                  {2: ("k6", "k3"), 3: ()}[k])
        _check(f"multi-key k={k}", int(got) == want, f"{int(got)}")
        dev_ms = _time_ms(torch, lambda: multi_key.multi_key_count(
            cols_a, cols_b), reps=3)
        log(f"[time multi-key] {card_line}: k={k}, {_shape()}: {int(got):,} "
            f"== host_join_count; {dev_ms:.4f} ms (CUDA events, warm)")
        del cols_a, cols_b
    # the k >= 3 path spreads each run's start prefix with a cumsum and two
    # gathers, where the JAX function takes a cummax
    n = N_PRIMARY + N_SECONDARY
    gen = torch.Generator(device=a.device)
    gen.manual_seed(SEED)
    starts = torch.rand((n,), generator=gen, device=a.device) < 0.04
    starts[0] = True
    prefix = torch.cumsum(starts, dim=0)
    snapshot = torch.where(starts, prefix, -1)
    cummax_ms = _time_ms(torch, lambda: torch.cummax(snapshot, dim=0), reps=1)
    spread_ms = _time_ms(torch, lambda: prefix[torch.nonzero(starts).squeeze(1)][
        torch.cumsum(starts, dim=0).sub_(1)], reps=3)
    log(f"[time multi-key] {card_line}: a run's start prefix spread over "
        f"{n:,} rows: torch.cummax {cummax_ms:.4f} ms, cumsum + nonzero + "
        f"gathers {spread_ms:.4f} ms (CUDA events)")


def phase_bench(torch, launches, card_line):
    """Phase 11: ``python -m partitionedhashjoin_tpu_torch.bench`` at
    10M ⋈ 200M as a subprocess: exactly one JSON line with bench.py's keys
    plus the card's name; each algo counts 200,000,000 (the bench raises
    otherwise) and launches K1 in its measured run (its ``launches`` lines
    on stderr)."""
    import os

    torch.cuda.empty_cache()
    env = dict(os.environ, PHJ_BENCH_PRIMARY=str(N_PRIMARY),
               PHJ_BENCH_SECONDARY=str(N_SECONDARY), PHJ_BENCH_SKEW=str(SKEW))
    env.pop("PHJ_BENCH_ALGOS", None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.bench"], env=env,
                          capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        log(f"[bench] {line}")
    _check("bench", proc.returncode == 0, f"exit {proc.returncode}")
    lines = proc.stdout.splitlines()
    _check("bench", len(lines) == 1, f"{len(lines)} stdout lines")
    doc = json.loads(lines[0])
    keys = {"metric", "value", "unit", "vs_baseline", "generation_path",
            "sort_impl", "roofline_fraction_single_touch", "device"}
    _check("bench", set(doc) == keys, f"keys {sorted(doc)}")
    _check("bench", doc["device"] == torch.cuda.get_device_name(0)
           and doc["metric"].endswith(f"_{N_PRIMARY}x{N_SECONDARY}_skew{SKEW}"),
           f"{doc}")
    for algo in ("sort-merge", "radix"):
        line = [x for x in proc.stderr.splitlines()
                if x.startswith(f"launches {algo}: ")]
        _check("bench", len(line) == 1, f"no launches line for {algo}")
        got = json.loads(line[0].split(": ", 1)[1]).get("merge_probe.LAUNCHES", 0)
        _check("bench", got > 0, f"{algo}: k1 was never launched")
        launches["k1"] += got
    log(f"[time bench] {card_line}: {doc['metric']} = {doc['value']} rows/s "
        f"(vs_baseline {doc['vs_baseline']}), subprocess wall {wall_s:.3f} s")
    log(f"[bench] {lines[0]}")


#: Runs the SQL shell module as ``python -m`` does (``runpy``), then prints
#: K1's launch count to stderr, so the shell's own process reports it.
_SHELL_WITH_COUNTS = (
    "import json, runpy, sys\n"
    "from partitionedhashjoin_tpu_torch.ops.kernels import merge_probe as mp\n"
    "try:\n"
    "    runpy.run_module('partitionedhashjoin_tpu_torch.sql', run_name='__main__',"
    " alter_sys=True)\n"
    "finally:\n"
    "    print('launches ' + json.dumps({'k1': mp.LAUNCHES}), file=sys.stderr)\n"
)
SQL_PIPELINE = (
    "SELECT key, COUNT(*), SUM(b.payload), MIN(b.payload), MAX(b.payload) "
    "FROM b JOIN a USING (key) {where}GROUP BY key ORDER BY count DESC LIMIT 10")
SQL_ANTI = "SELECT COUNT(*) FROM b ANTI JOIN a USING (key) WHERE a.key % 2 = 0"


def _host_ms(torch, fn):
    """Host-clock ms of one run of ``fn`` after a warmup, closed by a
    barrier."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _top10(torch, groups):
    """The oracle's groups ordered by COUNT descending, ties by key (the
    group table's row order), first 10."""
    order = torch.sort(groups["count"], descending=True, stable=True).indices[:10]
    return {f: c[order].cpu().numpy() for f, c in groups.items()}


def _check_sql_rows(name, r, want):
    """The SQL result's columns equal ``want``'s (key, count, sum, min,
    max), exactly."""
    import numpy as np

    _check(name, r.row_count == 10 and list(r.columns) == [
        "key", "count", "sum", "min", "max"], f"{r.row_count} rows {list(r.columns)}")
    for col, w in zip(r.columns, (want["keys"], want["count"], want["sum"],
                                  want["min"], want["max"])):
        _check(name, np.array_equal(r.columns[col], w), f"{col}: {r.columns[col]} != {w}")


@contextlib.contextmanager
def _no_cummax(torch):
    """``torch.cummax`` raises inside the block."""
    real = torch.cummax

    def refuse(*args, **kwargs):
        raise AssertionError("torch.cummax was called")

    torch.cummax = refuse
    try:
        yield
    finally:
        torch.cummax = real


def _multiplicity_by_cummax(torch, build_keys, probe_keys, build_valid):
    """``sort_merge._merged_multiplicity``'s third output with each run's
    start prefix carried by ``torch.cummax``, as the JAX function carries it
    (for the before/after time): the same sort, another scan."""
    from partitionedhashjoin_tpu_torch.ops import sort_merge

    keys_s, is_build_s, order = sort_merge._merged_sort(build_keys, probe_keys)
    valid_s = torch.cat([build_valid, torch.ones_like(probe_keys, dtype=torch.bool)])[order]
    counted = (is_build_s & valid_s).to(torch.int64)
    build_prefix = torch.cumsum(counted, dim=0)
    new_key = torch.ones_like(is_build_s)
    new_key[1:] = keys_s[1:] != keys_s[:-1]
    snapshot = torch.where(new_key, build_prefix - counted, -1)
    return build_prefix - torch.cummax(snapshot, dim=0).values


def phase_sql(torch, device, launches, card_line):
    """Phase 12: the SQL front end and the query layer at 10M ⋈ 200M; adds
    each path's launches.  Returns the pipeline's relations."""
    import numpy as np

    from partitionedhashjoin_tpu_torch import bench_pipeline
    from partitionedhashjoin_tpu_torch.data.table import make_table
    from partitionedhashjoin_tpu_torch.ops import sort_merge
    from partitionedhashjoin_tpu_torch.sql import _compile_expr, execute_sql, explain_sql
    from partitionedhashjoin_tpu_torch.sql import parse_sql

    run = functools.partial(_run_path, torch, "sql", launches)

    # (a) the shell, as a subprocess, at the reference workload: the count
    # (through runpy, reporting K1's launches) and --explain, side by side
    torch.cuda.empty_cache()
    argv = ["--table", f"a=sequential:{N_PRIMARY}",
            "--table", f"b=zipf:{N_SECONDARY}:{SKEW}:1:{N_PRIMARY}"]
    stmt = "SELECT COUNT(*) FROM b JOIN a USING (key)"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for cmd in ([sys.executable, "-c", _SHELL_WITH_COUNTS, *argv, stmt],
                         [sys.executable, "-m", f"{PKG}.sql", *argv, "--explain", stmt])]
    (count_out, count_err), (plan_out, plan_err) = (p.communicate(timeout=600)
                                                     for p in procs)
    wall_s = time.perf_counter() - t0
    for tag, text in (("count", count_err), ("explain", plan_err)):
        for line in text.splitlines():
            log(f"[sql shell {tag}] {line}")
    _check("sql shell", [p.returncode for p in procs] == [0, 0],
           f"exit {[p.returncode for p in procs]}")
    _check("sql shell", count_out == f"count\n{N_SECONDARY}\n(1 rows)\n", repr(count_out))
    _check("sql shell --explain", "R1" in plan_out, plan_out)
    k1 = json.loads(count_err.splitlines()[-1].removeprefix("launches "))["k1"]
    _check("sql shell", k1 > 0, "k1 was never launched")
    launches["k1"] += k1
    log(f"[time sql] {card_line}: (a) python -m {PKG}.sql {' '.join(argv)} "
        f"'{stmt}': prints {N_SECONDARY:,}, k1 launches {k1}, --explain shows R1; "
        f"both subprocesses {wall_s:.3f} s wall (startup, generation, count)")
    log("[sql shell] --explain:\n" + plan_out.rstrip())

    # (b)-(e) share the pipeline's relations (scripts/bench_pipeline.py)
    a_keys, a_pay, b_keys, b_pay = _query_relations(torch, device)
    db = {"a": make_table(a_keys, a_pay), "b": make_table(b_keys, b_pay)}
    kw = dict(group_capacity=GROUP_CAPACITY)
    _, hot, _ = bench_pipeline.run_query(a_keys, a_pay, b_keys, b_pay,
                                         GROUP_CAPACITY, True)
    hand = (hot.payloads.cpu().numpy(), hot.keys.cpu().numpy())
    want = _top10(torch, _group_oracle(torch, b_keys, b_pay))
    _check("sql oracle", np.array_equal(hand[0], want["keys"])
           and np.array_equal(hand[1], want["count"]), "hand-built plan != oracle")
    del hot

    # (b) the pipeline statement
    sql_b = SQL_PIPELINE.format(where="")
    plan = explain_sql(sql_b, db, **kw)
    _check("sql (b) explain", "R3" in plan and "R4" in plan, plan)
    b_ms = _host_ms(torch, lambda: execute_sql(sql_b, db, **kw))
    rb = run("(b) " + sql_b, lambda: execute_sql(sql_b, db, **kw), ("k6", "k4", "k5"))
    _check_sql_rows("sql (b)", rb, want)
    log(f"[time sql] {card_line}: (b) {b_ms:.3f} ms host clock (warm); 10 rows == "
        f"bench_pipeline.run_query's ordered plan == the bincount / scatter_add "
        f"mod 2^32 oracle; EXPLAIN R3 + R4")

    # (c) the same statement filtered: R7, K5 then K4
    sql_c = SQL_PIPELINE.format(where="WHERE b.payload % 2 = 0 ")
    plan = explain_sql(sql_c, db, **kw)
    _check("sql (c) explain", "R7" in plan, plan)
    keep = (b_pay % 2) == 0
    want_c = _top10(torch, _group_oracle(torch, b_keys[keep], b_pay[keep]))
    del keep
    c_ms = _host_ms(torch, lambda: execute_sql(sql_c, db, **kw))
    rc = run("(c) " + sql_c, lambda: execute_sql(sql_c, db, **kw), ("k5", "k4"))
    _check_sql_rows("sql (c)", rc, want_c)
    log(f"[time sql] {card_line}: (c) {c_ms:.3f} ms host clock (warm); == the "
        f"oracle over the kept rows; EXPLAIN R7")

    # (d) the masked anti count: sort_merge._merged_multiplicity at 210M
    # rows, with torch.cummax refused
    odd = int(torch.bincount(b_keys, minlength=N_PRIMARY + 1)[1::2].sum())
    with _no_cummax(torch):
        d_ms = _host_ms(torch, lambda: execute_sql(SQL_ANTI, db))
        rd = run("(d) " + SQL_ANTI, lambda: execute_sql(SQL_ANTI, db), ())
    _check("sql (d)", int(rd.columns["count"][0]) == odd,
           f"{int(rd.columns['count'][0])} != {odd} probe rows with an odd key")
    even = a_keys % 2 == 0
    _check("sql (d) multiplicity", torch.equal(
        sort_merge._merged_multiplicity(a_keys, b_keys, even, None)[2],
        _multiplicity_by_cummax(torch, a_keys, b_keys, even)),
        "the cummax and gather scans differ")
    cummax_ms = _time_ms(torch, lambda: _multiplicity_by_cummax(
        torch, a_keys, b_keys, even), reps=1)
    gather_ms = _time_ms(torch, lambda: sort_merge._merged_multiplicity(
        a_keys, b_keys, even, None), reps=3)
    del even
    log(f"[time sql] {card_line}: (d) {SQL_ANTI}: {odd:,} ok, {d_ms:.3f} ms host "
        f"clock (warm, no torch.cummax); sort_merge._merged_multiplicity over "
        f"{N_PRIMARY + N_SECONDARY:,} rows (sort and scan) {gather_ms:.4f} ms, "
        f"with a torch.cummax scan {cummax_ms:.4f} ms (CUDA events, equal)")

    # (e) zero divisors and INT32_MIN // -1 on 1M card rows == the CPU port
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 12)
    k = torch.randint(-6, 6, (1 << 20,), generator=gen, dtype=torch.int32, device=device)
    p = torch.randint(-3, 3, (1 << 20,), generator=gen, dtype=torch.int32, device=device)
    k[:4] = torch.tensor([I32_MIN, I32_MIN, 0, I32_MAX], dtype=torch.int32)
    p[:4] = torch.tensor([-1, 0, 0, -1], dtype=torch.int32)
    texts = ("key // payload", "key % payload", "key / 0", "key % 0", "payload // key",
             "(key * payload) // (payload - payload)", "key // -1", "key % -1")
    for text in texts:
        fn = _compile_expr(parse_sql(f"SELECT key FROM b WHERE {text} = 0").where.left)
        got = fn(k, p)
        _check(f"sql (e) {text}", torch.equal(got.cpu(), fn(k.cpu(), p.cpu())),
               "card != CPU")
    log(f"[sql] (e) {len(texts)} expressions with zero divisors and "
        f"INT32_MIN // -1 over {1 << 20:,} card rows: bit-equal to the CPU port")
    del k, p

    return a_keys, a_pay, b_keys, b_pay


def _hash_step(torch, launches, card_line, name, fn, kernels):
    """One step of phase 13: ``fn`` run with every count set to 0 just
    before and read just after (each of ``kernels`` must launch; their
    launches are added to ``launches``), then once more warm (the
    allocator keeps its cache).  Prints the host ms and the device ms
    between two CUDA events of both runs, the peak allocated bytes of the
    first and its K5/K7 launches.  Returns the first run's result."""
    times = []
    torch.cuda.empty_cache()
    for counted in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if counted:
            _reset_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(((time.perf_counter() - t0) * 1e3, start.elapsed_time(end)))
        if counted:
            first, counts = out, _read_counts()
            peak = torch.cuda.max_memory_allocated()
            for k in kernels:
                _check(f"hash {name}", counts[k] > 0, f"{k} was never launched ({counts})")
                launches[k] += counts[k]
        del out
    log(f"[time hash] {card_line}: {name}: host {times[0][0]:.3f} ms, device "
        f"{times[0][1]:.4f} ms (CUDA events); warm host {times[1][0]:.3f} ms, device "
        f"{times[1][1]:.4f} ms; peak allocated {peak} B; launches k5 {counts['k5']}, "
        f"k7 {counts['k7']}, k7 int64 {counts['k7i64']}, chained count "
        f"{counts['chained']} (LAUNCHES_CHAINED_COUNT), chained build "
        f"{counts['chained_build']} (LAUNCHES_CHAINED_BUILD)")
    return first


def _timed_join(make, a, b):
    """(count, partition, build, probe ms) of ``make().run(a, b)`` under a
    HashJoinTimer (each phase closed by a barrier)."""
    from partitionedhashjoin_tpu_torch.utils.results import HashJoinTimer, Parameters

    timer = HashJoinTimer(Parameters())
    count = make().run(a, b, timer)
    r = timer.get_result()
    return (count, r.get_partitioning_phase_duration() * 1e3,
            r.get_build_phase_duration() * 1e3, r.get_probe_phase_duration() * 1e3)


def _first_rows(torch, groups):
    """Each group's first row index (int64[num_groups])."""
    g = int(groups.num_groups)
    of = groups.group_of_row.to(torch.int64)
    rows = torch.arange(of.numel(), device=of.device)
    first = torch.full((g + 1,), of.numel(), dtype=torch.int64, device=of.device)
    return first.scatter_reduce_(0, torch.where(of >= 0, of, g), rows, "amin")[:g]


def _hash_equals_sort(torch, name, hashed, sorted_):
    """The hash GROUP BY's groups, put in key order, equal the sort
    GROUP BY's on every field; its group order is first occurrence."""
    g = int(hashed.num_groups)
    _check(name, g == int(sorted_.num_groups), f"{g} != {int(sorted_.num_groups)} groups")
    order = torch.argsort(hashed.keys[:g])
    for f in ("keys", "count", "sum", "min", "max"):
        _check(name, torch.equal(getattr(hashed, f)[:g][order], getattr(sorted_, f)[:g]),
               f"{f} differs from the sort GROUP BY")
    first = _first_rows(torch, hashed)
    _check(name, bool((first[1:] > first[:-1]).all()), "groups not in first-row order")
    return g


def phase_hash(torch, device, launches, card_line, rel):
    """Phase 13: the hash-table layer at 10M ⋈ 200M on the pipeline's
    relations (``rel``, from phase 12: build keys 1..N with payload
    key ^ 0x5A17, 200M Zipf(1.05) probe keys, probe payloads in
    [0, 2^20)); adds each step's K5/K7 launches."""
    from partitionedhashjoin_tpu_torch.config import (
        NoPartitioningConfiguration,
        RadixClusteringConfiguration,
    )
    from partitionedhashjoin_tpu_torch.data.table import make_table
    from partitionedhashjoin_tpu_torch.ops import aggregate
    from partitionedhashjoin_tpu_torch.ops import hash_table as ht
    from partitionedhashjoin_tpu_torch.ops.no_partitioning import (
        NoPartitioningHashJoiner,
    )
    from partitionedhashjoin_tpu_torch.ops.radix_cluster import RadixHashJoiner

    a_keys, a_pay, b_keys, b_pay = rel
    table_a, table_b = make_table(a_keys, a_pay), make_table(b_keys, b_pay)
    step = functools.partial(_hash_step, torch, launches, card_line)

    # (a), (b): the chained count joins, with their phase times
    joins = (
        ("(a) no-partitioning chained", lambda: NoPartitioningHashJoiner(
            NoPartitioningConfiguration(mode="chained"), seed=SEED)),
        ("(b) radix chained, 256 partitions", lambda: RadixHashJoiner(
            RadixClusteringConfiguration(number_of_partitions=256, mode="chained"),
            seed=SEED)),
    )
    for name, make in joins:
        count = step(name, lambda: make().run(table_a, table_b),
                     ("k7", "chained", "chained_build"))
        _check(name, count == N_SECONDARY, f"count {count}")
        count, part, build, probe = _timed_join(make, table_a, table_b)
        _check(name, count == N_SECONDARY, f"count {count}")
        log(f"[time hash] {card_line}: {name}: {count:,} ok; phases partition "
            f"{part:.3f} / build {build:.3f} / probe {probe:.3f} ms (host clock, "
            "each closed by a barrier, warm)")
    _phase_hash_i64(torch, step, card_line, a_keys, b_keys)
    _phase_hash_bench(torch, launches, card_line)

    # (c) run_materialize: every probe row, in probe order
    joined = step("(c) run_materialize", lambda: NoPartitioningHashJoiner(
        seed=SEED).run_materialize(table_a, table_b), ("k7", "k5"))
    _check("(c) run_materialize", int(joined.count) == N_SECONDARY
           and torch.equal(joined.keys, b_keys)
           and torch.equal(joined.payloads_a, b_keys ^ SALT)
           and torch.equal(joined.payloads_b, b_pay), f"count {int(joined.count)}")
    del joined
    log(f"[hash] (c) run_materialize: {N_SECONDARY:,} rows == the probe keys in order, "
        "payloads_a == key ^ 0x5A17, payloads_b == the probe payloads: ok")

    # (d) the hash GROUP BY against the sort GROUP BY
    hashed = step("(d) hash_aggregate", lambda: aggregate.hash_aggregate(
        table_b, seed=SEED), ("k7",))
    groups = _hash_equals_sort(torch, "(d) hash_aggregate", hashed, aggregate.sort_aggregate(
        table_b, group_capacity=GROUP_CAPACITY))
    del hashed

    def even(k, p):
        return p % 2 == 0

    hashed, n_hashed = step("(d) filter_aggregate payload % 2 == 0",
                            lambda: aggregate.filter_aggregate(table_b, even, seed=SEED),
                            ("k7",))
    sorted_, n_sorted = aggregate.filter_sort_aggregate(
        table_b, even, group_capacity=GROUP_CAPACITY)
    _check("(d) filter_aggregate", int(n_hashed) == int(n_sorted), "selected rows")
    kept = _hash_equals_sort(torch, "(d) filter_aggregate", hashed, sorted_)
    del hashed, sorted_
    log(f"[hash] (d) hash_aggregate: {groups:,} groups, filter_aggregate: {kept:,} groups "
        f"of {int(n_hashed):,} rows; each == the sort GROUP BY in key order, groups in "
        "first-row order: ok")

    # (e) the open-addressing table: build over A, three probes with B
    size = ht.table_size_for(N_PRIMARY)
    table = step(f"(e) build_hash_table, {size:,} slots",
                 lambda: ht.build_hash_table(a_keys, SEED, size), ("k7",))
    _check("(e) build", not bool(table.overflowed), "overflowed")
    found = step("(e) probe_exists", lambda: ht.probe_exists(table, b_keys), ("k7",))
    _check("(e) probe_exists", bool(found.all()), "a key was not found")
    del found
    found, row = step("(e) probe_get", lambda: ht.probe_get(table, b_keys), ("k7",))
    _check("(e) probe_get", bool(found.all())
           and torch.equal(a_keys[row.to(torch.int64)], b_keys), "rows")
    del found, row
    mult = step("(e) probe_count_all", lambda: ht.probe_count_all(table, b_keys), ("k7",))
    _check("(e) probe_count_all", bool((mult == 1).all()), "multiplicity")
    log(f"[hash] (e) build_hash_table over {N_PRIMARY:,} keys (max_probe "
        f"{int(table.max_probe)}), probe_exists / probe_get / probe_count_all over "
        f"{N_SECONDARY:,} keys: all found, rows hold the probed keys, multiplicity 1: ok")


def _phase_hash_i64(torch, step, card_line, a_keys, b_keys):
    """Phase 13 (a2): the chained no-partitioning join on int64 keys at
    10M ⋈ 200M: the pipeline's keys widened, every odd probe row moved by
    2^32 so that it matches only if the table tells the high word apart.
    Its count against ``torch.isin`` (the plain reference), its phase times
    and its K7 launches: int64 only."""
    from partitionedhashjoin_tpu_torch.config import NoPartitioningConfiguration
    from partitionedhashjoin_tpu_torch.data.table import make_table
    from partitionedhashjoin_tpu_torch.ops.no_partitioning import (
        NoPartitioningHashJoiner,
    )

    name = "(a2) no-partitioning chained, int64 keys"
    a64 = a_keys.to(torch.int64)
    b64 = b_keys.to(torch.int64)
    b64[1::2] += 2**32
    want = int(torch.isin(b64, a64).sum())
    _check(name, want == N_SECONDARY - N_SECONDARY // 2, f"reference {want}")
    table_a, table_b = make_table(a64, a64), make_table(b64, b64)

    def make():
        return NoPartitioningHashJoiner(NoPartitioningConfiguration(mode="chained"),
                                        seed=SEED)

    count = step(name, lambda: make().run(table_a, table_b),
                 ("k7i64", "chained", "chained_build"))
    _check(name, count == want, f"count {count}, reference {want}")
    count, part, build, probe = _timed_join(make, table_a, table_b)
    _check(name, count == want, f"count {count}, reference {want}")
    log(f"[time hash] {card_line}: {name}: {count:,} == torch.isin ok; phases "
        f"partition {part:.3f} / build {build:.3f} / probe {probe:.3f} ms (host "
        "clock, each closed by a barrier, warm)")
    del table_a, table_b, a64, b64
    torch.cuda.empty_cache()


def _phase_hash_bench(torch, launches, card_line):
    """Phase 13 (b): ``PHJ_BENCH_ALGOS=radix-chained python -m
    partitionedhashjoin_tpu_torch.bench`` at 10M ⋈ 200M: its one JSON line
    and its measured run's K7 launches."""
    import os

    torch.cuda.empty_cache()
    env = dict(os.environ, PHJ_BENCH_PRIMARY=str(N_PRIMARY),
               PHJ_BENCH_SECONDARY=str(N_SECONDARY), PHJ_BENCH_SKEW=str(SKEW),
               PHJ_BENCH_ALGOS="radix-chained")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.bench"], env=env,
                          capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        log(f"[hash bench] {line}")
    _check("hash bench", proc.returncode == 0, f"exit {proc.returncode}")
    lines = proc.stdout.splitlines()
    _check("hash bench", len(lines) == 1, f"{len(lines)} stdout lines")
    doc = json.loads(lines[0])
    metric = f"join_rows_per_s_radix-chained_{N_PRIMARY}x{N_SECONDARY}_skew{SKEW}"
    _check("hash bench", doc["metric"] == metric and doc["value"] > 0
           and doc["device"] == torch.cuda.get_device_name(0), f"{doc}")
    line = [x for x in proc.stderr.splitlines() if x.startswith("launches radix-chained: ")]
    _check("hash bench", len(line) == 1, "no launches line")
    got = json.loads(line[0].split(": ", 1)[1]).get("generate.LAUNCHES_HASH", 0)
    _check("hash bench", got > 0, "k7 was never launched")
    launches["k7"] += got
    log(f"[time hash] {card_line}: (b) bench radix-chained: {doc['value']} rows/s, "
        f"k7 launches {got}, subprocess wall {wall_s:.3f} s")
    log(f"[hash bench] {lines[0]}")


# ---------------------------------------------------------------- shuffle

#: Shard counts of phase 14, and the bytes of one exchange slot: an int32
#: key, an int32 payload and a bool valid flag.
SHUFFLE_SHARDS = (1, 2, 8)
SLOT_BYTES = 9


def _describe_shuffle(run):
    """One line on a ``ShuffleRun``: capacities, exchange bytes, the drop
    counts of each attempt and the hot keys planned."""
    hottest = run.hot_keys[0] if run.hot_keys else None
    return (f"S {run.num_shards}, cap_a {run.cap_a:,}, cap_b {run.cap_b:,}, "
            f"hot_cap {run.hot_cap}, exchange {run.exchange_slots:,} slots = "
            f"{run.exchange_slots * SLOT_BYTES:,} B each way, ShuffleStats "
            f"(dropped a, b, hot) per attempt {run.drops}, retries {run.retries}, "
            f"hot keys planned {len(run.hot_keys)} (hottest {hottest})")


def _shuffle_step(torch, launches, card_line, name, make, tables, want, kernels,
                  valid=None):
    """One library step of phase 14: ``make().run(*tables)`` once untimed,
    then once more with every count set to 0 just before and read just
    after (each of ``kernels`` must launch; their launches are added to
    ``launches``), between two CUDA events.  The count must be ``want``.
    Returns the joiner and the timed run's launch counts."""
    valid = valid or {}
    torch.cuda.empty_cache()
    _check(f"shuffle {name}", make().run(*tables, **valid) == want, "warm-up count")
    joiner = make()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    count = joiner.run(*tables, **valid)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    _check(f"shuffle {name}", count == want, f"count {count:,}, want {want:,}")
    for k in kernels:
        _check(f"shuffle {name}", counts[k] > 0, f"{k} was never launched ({counts})")
        launches[k] += counts[k]
    log(f"[time shuffle] {card_line}: {name}: {count:,} ok; host {host_ms:.3f} ms, "
        f"device {start.elapsed_time(end):.4f} ms (CUDA events, warm); peak allocated "
        f"{peak} B; launches k1 {counts['k1']}, k3 {counts['k3']}, k7 {counts['k7']}")
    log(f"[shuffle] {name}: {_describe_shuffle(joiner.last_run)}")
    return joiner, counts


def phase_shuffle(torch, device, launches, card_line):
    """Phase 14: the mesh and the shuffle join at 10M ⋈ 200M, every shard
    on the one card; adds each path's launches.  Returns the ``ShuffleRun``
    of the 8-shard sort-merge library join."""
    from partitionedhashjoin_tpu_torch import cli
    from partitionedhashjoin_tpu_torch.data.table import make_table
    from partitionedhashjoin_tpu_torch.parallel import mesh as pm
    from partitionedhashjoin_tpu_torch.parallel.shuffle import DistributedShuffleJoiner
    from partitionedhashjoin_tpu_torch.utils import logger as logging_utils

    # (a) the CLI at each shard count
    for s in SHUFFLE_SHARDS:
        run = (["--join", "shuffle", "--shards", str(s)],
               {"Type": "DistributedShuffle", "NumberOfShards": str(s)}, ("k1",))
        phase_main(torch, launches, (run,), "shuffle", () if s == 1 else ("k7",))

    # the library on the CLI's relations (same flags, same seed)
    config, _ = cli.parse_arguments([
        "--primary", str(N_PRIMARY), "--secondary", str(N_SECONDARY),
        "--skew", str(SKEW), "--seed", str(SEED), "--platform", "cuda"])
    table_a, table_b = cli.generate_tables(
        config, logging_utils.get_new_logger("Main"), device)
    step = functools.partial(_shuffle_step, torch, launches, card_line)
    meshes = {s: pm.make_mesh(s, devices=[device]) for s in SHUFFLE_SHARDS}

    def on(s, a=table_a, b=table_b):
        return pm.shard_table(a, meshes[s]), pm.shard_table(b, meshes[s])

    def joiner(s, **kw):
        return lambda: DistributedShuffleJoiner(meshes[s], seed=SEED, **kw)

    runs = {}
    for s in SHUFFLE_SHARDS:
        made, _ = step(f"(a) S={s} sort-merge", joiner(s), on(s), N_SECONDARY,
                       ("k1",) if s == 1 else ("k1", "k7"))
        runs[s] = made.last_run
    wide = tuple(make_table(t.keys.to(torch.int64), t.payloads) for t in (table_a, table_b))
    step("(a) S=1 int64 keys", joiner(1), on(1, *wide), N_SECONDARY, ("k3",))
    del wide

    s8 = on(8)
    step("(b) S=8 local_join=hash", joiner(8, local_join="hash"), s8, N_SECONDARY, ("k7",))
    _, counts = step("(c) S=8 pipeline_chunks=4", joiner(8, pipeline_chunks=4), s8,
                     N_SECONDARY, ("k1", "k7"))
    _check("shuffle (c)", counts["k1"] == 4 * 8, f"k1 launched {counts['k1']} times, not 32")
    step("(d) S=8 handle_skew=False", joiner(8, handle_skew=False), s8, N_SECONDARY,
         ("k1", "k7"))
    valid_a, valid_b = table_a.keys % 3 != 0, table_b.keys % 2 == 0
    # a sequential build holds every probe key once: a valid probe row
    # matches exactly when its key is even and not divisible by 3
    want = int((valid_b & (table_b.keys % 3 != 0)).sum())
    step("(d) S=8 masked (probe key even, build key % 3 != 0)", joiner(8), s8, want,
         ("k1", "k7"), valid={"valid_a": pm.shard_array(valid_a, meshes[8]),
                              "valid_b": pm.shard_array(valid_b, meshes[8])})
    log(f"[shuffle] (d) masked oracle: {want:,} valid probe rows with a valid build key")
    return runs[8]


# ---------------------------------------------------------------- dist


def _describe_run(record):
    """One line on a distributed operator's ``last_run``."""
    if record is None:
        return "exchange inside the query layer, not exposed"
    return (f"S {record.num_shards}, exchange {record.exchange_bytes:,} B each way, "
            f"attempts {record.attempts}, retries {record.retries}")


def _dist_step(torch, launches, card_line, digests, name, fn, kernels, check, key=None):
    """One step of phase 15: ``fn()`` once untimed, then once more (the
    allocator keeps its cache) with every count set to 0 just before and
    read just after (each of
    ``kernels`` must launch; their launches are added to ``launches``),
    between two CUDA events.  ``fn`` returns ``(result, last_run or
    None)``; ``check(result)`` raises on a wrong result and returns what it
    checked; ``digests[key]``, for a step of ``dryrun.ops_steps``, gets the
    digests of the timed run's result and ``last_run``, which phase 18
    holds its processes to.  Prints the host and device ms, the peak
    allocated bytes, the exchange and the K1/K5/K7 launches."""
    from partitionedhashjoin_tpu_torch import dryrun

    torch.cuda.empty_cache()
    out, _ = fn()
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    out, record = fn()
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    for k in kernels:
        _check(f"dist {name}", counts[k] > 0, f"{k} was never launched ({counts})")
        launches[k] += counts[k]
    detail = check(out)
    if key is not None:
        digests[key] = json.loads(json.dumps([dryrun.digest(out), dryrun.digest(record)]))
    del out
    log(f"[time dist] {card_line}: {name}: {detail}; host {host_ms:.3f} ms, device "
        f"{start.elapsed_time(end):.4f} ms (CUDA events, warm); peak allocated {peak} B; "
        f"launches k1 {counts['k1']}, k5 {counts['k5']}, k7 {counts['k7']}")
    log(f"[dist] {name}: {_describe_run(record)}")


def _key_ordered(torch, g):
    """A GroupByResult's valid groups in key order, as a dict of columns."""
    n = int(g.num_groups)
    order = torch.sort(g.keys[:n]).indices
    cols = {"keys": g.keys, "count": g.count, "sum": g.sum, "min": g.min, "max": g.max}
    if g.distinct is not None:
        cols["distinct"] = g.distinct
    return {f: c[:n][order] for f, c in cols.items()}


def _same_groups(torch, name, g, want):
    """``g`` equals ``want`` (a dict of key-ordered columns) as a key →
    aggregates map."""
    got = _key_ordered(torch, g)
    for f, w in want.items():
        _check(name, torch.equal(got[f], w.to(got[f].dtype)), f"field {f} differs")
    return f"{want['keys'].numel():,} groups == the single-device map"


def _packed_rows(torch, name, keys, pay_a, pay_b, matched, n):
    """The first ``n`` joined rows as sorted int64 (key << 21 | pay_b << 1
    | matched): keys < 2^24 and probe payloads < 2^20 fit, and pay_a must
    be key ^ 0x5A17 on a matched row and 0 on another (the build payload),
    so equal sorted words are equal multisets of (key, pay_a, pay_b,
    matched) rows."""
    keys, pay_a, pay_b, matched = (c[:n] for c in (keys, pay_a, pay_b, matched))
    _check(name, bool((pay_a == torch.where(matched, keys ^ SALT, 0)).all()),
           "pay_a is not the matched build payload")
    words = ((keys.to(torch.int64) << 21) | (pay_b.to(torch.int64) << 1)
             | matched.to(torch.int64))
    return torch.sort(words).values


def phase_dist(torch, device, launches, card_line, rel):
    """Phase 15: the distributed operators and R6 at 10M ⋈ 200M on phase
    12's relations (``rel``), 8 shards on the one card; adds each step's
    launches.  Returns the digests of the 8-shard steps of
    ``dryrun.ops_steps``, by step."""
    import numpy as np

    from partitionedhashjoin_tpu_torch import dryrun
    from partitionedhashjoin_tpu_torch.data.table import make_table
    from partitionedhashjoin_tpu_torch.ops import order_by
    from partitionedhashjoin_tpu_torch.ops.aggregate import (
        filter_sort_aggregate,
        sort_aggregate,
    )
    from partitionedhashjoin_tpu_torch.ops.sort_merge import sort_merge_materialize_typed
    from partitionedhashjoin_tpu_torch.parallel import mesh as pm
    from partitionedhashjoin_tpu_torch.parallel.aggregate_shuffle import (
        DistributedAggregateOperator,
    )
    from partitionedhashjoin_tpu_torch.sql import execute_sql, explain_sql

    a_keys, a_pay, b_keys, b_pay = rel
    a, b = make_table(a_keys, a_pay), make_table(b_keys, b_pay)
    meshes = {s: pm.make_mesh(s, devices=[device]) for s in (2, 8)}
    m8 = meshes[8]
    even = (b_pay % 2) == 0
    digests = {}
    step = functools.partial(_dist_step, torch, launches, card_line, digests)
    runs = dict(dryrun.ops_steps(m8, rel, SEED, GROUP_CAPACITY))

    def operator(cls, s=8, **kw):
        return cls(meshes[s], seed=SEED, **kw)

    with _no_cummax(torch):
        # (a) the combiner plan at S = 8 and 2, masked, and the distinct plan
        want = _key_ordered(torch, sort_aggregate(b, group_capacity=GROUP_CAPACITY))
        step("(a) S=8 DistributedAggregateOperator.run", runs["(a) aggregate"],
             ("k5", "k7"), functools.partial(_same_groups, torch, "dist (a) S=8", want=want),
             key="(a) aggregate")

        def run():
            op = operator(DistributedAggregateOperator, 2)
            return op.run(b, group_capacity=GROUP_CAPACITY), op.last_run
        step("(a) S=2 DistributedAggregateOperator.run", run, ("k5", "k7"),
             functools.partial(_same_groups, torch, "dist (a) S=2", want=want))
        want = _key_ordered(torch, filter_sort_aggregate(
            b, lambda k, p: even, group_capacity=GROUP_CAPACITY)[0])
        step("(a) S=8 mask payload % 2 == 0", runs["(a) aggregate mask"], ("k5", "k7"),
             functools.partial(_same_groups, torch, "dist (a) mask", want=want),
             key="(a) aggregate mask")
        want = _key_ordered(torch, sort_aggregate(b, group_capacity=GROUP_CAPACITY,
                                                  with_distinct=True))
        step("(a) S=8 with_distinct=True", runs["(a) aggregate distinct"], ("k5", "k7"),
             functools.partial(_same_groups, torch, "dist (a) distinct", want=want),
             key="(a) aggregate distinct")
        del want

        # (b) top-10 by key and by payload, each also masked
        for by in ("key", "payload"):
            for masked in (False, True):
                src = make_table(b_keys[even], b_pay[even]) if masked else b
                want = order_by.top_k(src, 10, by=by)
                del src

                def check(out, want=want, name=f"dist (b) {by} masked={masked}"):
                    got, live = out
                    _check(name, int(live) == 10 and torch.equal(got.keys, want.keys)
                           and torch.equal(got.payloads, want.payloads),
                           f"{got.keys.tolist()} != {want.keys.tolist()}")
                    return "10 rows == ops.order_by.top_k row for row"

                key = f"(b) top_k {by}" + (" mask" if masked else "")
                step(f"(b) S=8 distributed_top_k k=10 by {by}"
                     + (" mask payload % 2 == 0" if masked else ""), runs[key], (), check,
                     key=key)

        # (c) join → GROUP BY, with and without the skew plan
        want = _group_oracle(torch, b_keys, b_pay)
        for skew in (True, False):
            key = "(c) join_aggregate" + ("" if skew else " handle_skew=False")
            step(f"(c) S=8 DistributedJoinAggregateOperator.run handle_skew={skew}",
                 runs[key], ("k5", "k7"),
                 functools.partial(_same_groups, torch, f"dist (c) {skew}", want=want),
                 key=key)
        del want

        # (d) the materializing joins, as multisets of rows
        for jt, probe_valid, count in (
                ("inner", None, N_SECONDARY), ("anti", None, 0),
                ("left", None, N_SECONDARY), ("semi", even, int(even.sum()))):
            name = f"dist (d) {jt}"
            ref = sort_merge_materialize_typed(a_keys, a_pay, b_keys, b_pay, jt,
                                               probe_valid=probe_valid)
            _check(name, int(ref[4]) == count, f"single-device count {int(ref[4]):,}")
            want = _packed_rows(torch, name, *ref[:4], count)
            del ref
            key = f"(d) materialize {jt}" + (" mask" if probe_valid is not None else "")

            def check(j, name=name, count=count, want=want):
                _check(name, int(j.count) == count, f"count {int(j.count):,} != {count:,}")
                got = _packed_rows(torch, name, j.keys, j.payloads_a, j.payloads_b,
                                   j.matched, count)
                _check(name, torch.equal(got, want), "the row multisets differ")
                return (f"{count:,} rows == sort_merge_materialize_typed as a multiset "
                        f"({j.keys.numel():,} slots)")

            step(f"(d) S=8 DistributedMaterializeJoiner.run {jt}"
                 + (" probe mask payload % 2 == 0" if probe_valid is not None else ""),
                 runs[key], ("k5", "k7"), check, key=key)
            del want

        # (e) composite keys and 64-bit keys as two planes
        def count_is(name):
            def check(c):
                _check(name, c == N_SECONDARY, f"{c:,} != {N_SECONDARY:,}")
                return f"{c:,} ok"
            return check

        step("(e) S=8 MultiKeyShuffleJoiner.run (key, key ^ 0x5A17)",
             runs["(e) multi_key run"], ("k7",), count_is("dist (e) run"),
             key="(e) multi_key run")
        step("(e) S=8 MultiKeyShuffleJoiner.run_i64", runs["(e) multi_key run_i64"], ("k7",),
             count_is("dist (e) run_i64"), key="(e) multi_key run_i64")

        # (f) R6 through the SQL front end and the shell
        db = {"a": a, "b": b}
        sql_b = SQL_PIPELINE.format(where="")
        one = execute_sql(sql_b, db, group_capacity=GROUP_CAPACITY)
        want = _top10(torch, _group_oracle(torch, b_keys, b_pay))

        def check(r):
            _check_sql_rows("dist (f) pipeline", r, want)
            _check("dist (f) pipeline", all(np.array_equal(r.columns[c], one.columns[c])
                                            for c in one.columns), "!= one device")
            return "10 rows == the single-device statement == the oracle"

        step("(f) S=8 execute_sql pipeline statement, mesh=", runs["(f) sql pipeline"],
             ("k5", "k7"), check, key="(f) sql pipeline")
        stmt = dryrun.SQL_COUNT

        def check(r):
            c = int(r.columns["count"][0])
            _check("dist (f) count", c == N_SECONDARY, f"{c:,}")
            return f"{c:,} ok"

        step(f"(f) S=8 execute_sql '{stmt}', mesh=", runs["(f) sql count"], ("k1", "k7"),
             check, key="(f) sql count")
        for text in (sql_b, stmt):
            plan = explain_sql(text, db, mesh=m8, group_capacity=GROUP_CAPACITY)
            _check("dist (f) explain", plan.startswith("physical plan [mesh S=8]")
                   and "R6" in plan, plan)
            log("[dist] (f) explain_sql with the mesh:\n" + plan)
    del one, want, even

    # the shell with --mesh 8 on the reference workload, in its own process
    torch.cuda.empty_cache()
    argv = ["--platform", "cuda", "--mesh", "8", "--table", f"a=sequential:{N_PRIMARY}",
            "--table", f"b=zipf:{N_SECONDARY}:{SKEW}:1:{N_PRIMARY}"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _SHELL_WITH_COUNTS, *argv, stmt],
                          capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        log(f"[dist shell] {line}")
    _check("dist shell --mesh 8", proc.returncode == 0, f"exit {proc.returncode}")
    _check("dist shell --mesh 8", proc.stdout == f"count\n{N_SECONDARY}\n(1 rows)\n",
           repr(proc.stdout))
    k1 = json.loads(proc.stderr.splitlines()[-1].removeprefix("launches "))["k1"]
    _check("dist shell --mesh 8", k1 == 8, f"k1 launched {k1} times, not 8")
    launches["k1"] += k1
    log(f"[time dist] {card_line}: (f) python -m {PKG}.sql {' '.join(argv)} '{stmt}': "
        f"prints {N_SECONDARY:,}, k1 launches {k1}; {wall_s:.3f} s wall (startup, "
        "generation, count)")
    return digests



# ---------------------------------------------------------------- multi-process

#: Runs the CLI module as ``python -m`` does (``runpy``), then prints the
#: K1 and K7 launch counts of its process to stderr.
_CLI_WITH_COUNTS = (
    "import json, runpy, sys\n"
    "from partitionedhashjoin_tpu_torch.ops.kernels import generate as kg\n"
    "from partitionedhashjoin_tpu_torch.ops.kernels import merge_probe as mp\n"
    "try:\n"
    "    runpy.run_module('partitionedhashjoin_tpu_torch', run_name='__main__',"
    " alter_sys=True)\n"
    "finally:\n"
    "    print('launches ' + json.dumps({'k1': mp.LAUNCHES, 'k7': kg.LAUNCHES_HASH}),"
    " file=sys.stderr)\n"
)
#: Processes of phase 16, all on the one card.
MP_PROCESSES = 2
#: The fields of a ``ShuffleRun`` that one process and several must share.
RUN_FIELDS = ("num_shards", "drops", "cap_a", "cap_b", "hot_cap", "hot_keys")


def _process_launches(name, err):
    """The ``launches`` line that a process printed last on stderr."""
    lines = [line for line in err.splitlines() if line.startswith("launches ")]
    _check(name, bool(lines), "no launches line on stderr")
    return json.loads(lines[-1].removeprefix("launches "))


def _mp_cli(torch, launches, card_line, shards, repo):
    """(a) of phase 16: the CLI as MP_PROCESSES processes at ``shards``."""
    from partitionedhashjoin_tpu_torch import dryrun

    argv = ["--coordinator", dryrun.free_coordinator(),
            "--num-processes", str(MP_PROCESSES), "--join", "shuffle",
            "--primary", str(N_PRIMARY), "--secondary", str(N_SECONDARY),
            "--skew", str(SKEW), "--seed", str(SEED), "--output", "stdout",
            "--platform", "cuda"]
    if shards is not None:
        argv += ["--shards", str(shards)]
    s = MP_PROCESSES if shards is None else shards
    name = f"multiprocess (a) CLI S={s}"
    t0 = time.perf_counter()
    results = dryrun.run_processes(
        [[sys.executable, "-c", _CLI_WITH_COUNTS, *argv, "--process-id", str(i)]
         for i in range(MP_PROCESSES)], 900, cwd=repo)
    wall_s = time.perf_counter() - t0
    want = {"PrimaryRelationSize": str(N_PRIMARY),
            "SecondaryRelationSize": str(N_SECONDARY), "Skew": f"{SKEW:.6f}",
            "Type": "DistributedShuffle", "NumberOfShards": str(s),
            "NumberOfProcesses": str(MP_PROCESSES)}
    doc = json.loads(results[0][1])
    _check(name, doc.get("id") == "hashjointimingresult" and doc["parameters"] == want
           and set(doc["results"]) == {"partition", "build", "probe"}, str(doc))
    for pid, (_, out, err) in enumerate(results):
        if pid:
            _check(name, out == "", f"process {pid} printed {out!r}")
        _check(name, f"Join produced {N_SECONDARY} matches" in err,
               f"process {pid}: no count of {N_SECONDARY:,} in its log")
        counts = _process_launches(name, err)
        for k in ("k1", "k7"):
            _check(name, counts[k] > 0, f"process {pid}: {k} was never launched")
            launches[k] += counts[k]
        for line in err.splitlines():
            if "backend" in line or "Shuffle run" in line:
                log(f"[multiprocess] (a) S={s} process {pid}: {line.strip()}")
        log(f"[multiprocess] (a) S={s} process {pid}: launches {counts}")
    res = doc["results"]
    log(f"[multiprocess] (a) S={s}: result {json.dumps(doc, sort_keys=True)}")
    log(f"[time multiprocess] {card_line}: (a) python -m {PKG} --coordinator ... "
        f"--num-processes {MP_PROCESSES} --join shuffle --shards {s}: both processes "
        f"count {N_SECONDARY:,}, only process 0 renders; phases partition "
        f"{res['partition']} / build {res['build']} / probe {res['probe']} ms; "
        f"{wall_s:.3f} s wall (startup, generation, warmup, timed run)")


def phase_multiprocess(torch, launches, card_line, one_process_run):
    """Phase 16: the shuffle join over MP_PROCESSES processes on the one
    card (gloo); adds each path's launches, read inside the processes."""
    import os

    from partitionedhashjoin_tpu_torch import dryrun

    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"[multiprocess] compute mode {mode}")
    _check("multiprocess", "Exclusive_Process" not in mode,
           f"the card is in compute mode {mode}: {MP_PROCESSES} processes cannot "
           "share it")
    torch.cuda.empty_cache()
    repo = os.path.dirname(os.path.abspath(__file__))
    for shards in (None, 8):
        _mp_cli(torch, launches, card_line, shards, repo)

    # (b), (c): the library at S = 8 through the dry-run worker
    coord = dryrun.free_coordinator()
    t0 = time.perf_counter()
    results = dryrun.run_processes(
        [[sys.executable, "-m", f"{PKG}.dryrun", "measure", coord, str(MP_PROCESSES),
          str(i), "--platform", "cuda", "--shards", "8", "--primary", str(N_PRIMARY),
          "--secondary", str(N_SECONDARY), "--skew", str(SKEW), "--seed", str(SEED)]
         for i in range(MP_PROCESSES)], 900, cwd=repo)
    wall_s = time.perf_counter() - t0
    steps = {}
    for pid, (_, out, err) in enumerate(results):
        _check("multiprocess (b)", f"MP_OK pid={pid}" in out, f"process {pid}: {out}")
        for line in err.splitlines():
            if "backend" in line:
                log(f"[multiprocess] (b) process {pid}: {line.strip()}")
        for line in out.splitlines():
            if line.startswith("MP_STEP "):
                rec = json.loads(line.removeprefix("MP_STEP "))
                steps.setdefault(rec["step"], []).append(rec)
    _check("multiprocess (b)", set(steps) == {n for n, _ in dryrun.MEASURE_STEPS}
           and all(len(r) == MP_PROCESSES for r in steps.values()), str(list(steps)))
    want_run = {f: getattr(one_process_run, f) for f in RUN_FIELDS}
    want_run["drops"] = [list(d) for d in want_run["drops"]]
    for name, recs in steps.items():
        tag = "(b)" if name == "sort-merge" else "(c)"
        must = ("k7",) if name == "local_join=hash" else ("k1", "k7")
        for rec in recs:
            what = f"multiprocess {tag} {name} process {rec['pid']}"
            _check(what, rec["count"] == N_SECONDARY, f"count {rec['count']:,}")
            _check(what, rec["backend"] == "gloo", f"backend {rec['backend']}")
            _check(what, rec["run"] == recs[0]["run"], "the processes' runs differ")
            for k in must:
                _check(what, rec["launches"][k] > 0, f"{k} was never launched")
            if name == "pipeline_chunks=4":
                _check(what, rec["launches"]["k1"] == 4 * 8 // MP_PROCESSES,
                       f"k1 launched {rec['launches']['k1']} times")
            exchanged = rec["comm_sent"].get("all_to_all", 0)
            _check(what, len(rec["run"]["drops"]) > 1
                   or exchanged == rec["run"]["cross_process_bytes"],
                   f"all_to_all sent {exchanged:,} B, the exchange's count "
                   f"{rec['run']['cross_process_bytes']:,} B")
            if name == "sort-merge":
                got = {f: rec["run"][f] for f in RUN_FIELDS}
                _check(what, got == want_run,
                       f"ShuffleRun {got} != phase 14's 8-shard run {want_run}")
            for k in must:
                launches[k] += rec["launches"][k]
            run = rec["run"]
            log(f"[time multiprocess] {card_line}: {tag} S=8 over {MP_PROCESSES} "
                f"processes, {name}, process {rec['pid']} ({rec['device']}, backend "
                f"{rec['backend']}): {rec['count']:,} ok; host {rec['host_ms']:.3f} ms, "
                f"device {rec['device_ms']:.4f} ms (CUDA events, warm); cross-process "
                f"collectives {rec['comm_ms']:.3f} ms in {rec['comm_calls']} calls (CUDA "
                f"events), {rec['comm_bytes']:,} B sent (by collective "
                f"{json.dumps(rec['comm_sent'], sort_keys=True)}; the exchange's count "
                f"{run['cross_process_bytes']:,} B); peak allocated {rec['peak_bytes']} B; "
                f"launches k1 {rec['launches']['k1']}, k7 {rec['launches']['k7']}")
        run = recs[0]["run"]
        log(f"[multiprocess] {tag} {name}: S {run['num_shards']}, local shards "
            f"{run['local_shards']}, cap_a {run['cap_a']:,}, cap_b {run['cap_b']:,}, "
            f"hot_cap {run['hot_cap']}, exchange {run['exchange_slots']:,} slots, drops "
            f"per attempt {run['drops']}, hot keys {len(run['hot_keys'])}"
            + (", equal to phase 14's one-process 8-shard run" if name == "sort-merge"
               else ""))
    log(f"[time multiprocess] {card_line}: (b)+(c) both dry-run processes {wall_s:.3f} s "
        "wall (startup, generation of the whole relations, 3 warm + 3 timed joins)")


# ---------------------------------------------------------------- multi-process ops

#: Kernels each step of ``dryrun.ops_steps`` must launch in every process,
#: by the step's letter (the count join of (f) by its name).
OPS_KERNELS = {"(a)": ("k5", "k7"), "(b)": (), "(c)": ("k5", "k7"),
               "(d)": ("k5", "k7"), "(e)": ("k7",), "(f)": ("k5", "k7"),
               "(f) sql count": ("k1", "k7")}


def phase_multiprocess_ops(torch, launches, card_line, digests):
    """Phase 18: the distributed operators and R6 over MP_PROCESSES
    processes x 4 shards that share the card (gloo): ``python -m
    ...dryrun ops`` in each process, which draws phase 15's relations whole
    and keeps its ``host_slice``, runs each step of ``dryrun.ops_steps``
    once untimed and once timed; each step's result and ``last_run`` must
    equal phase 15's one-process 8-shard run (``digests``) in every process.
    Adds each step's launches, counted inside the processes."""
    import os

    from partitionedhashjoin_tpu_torch import dryrun

    torch.cuda.empty_cache()
    repo = os.path.dirname(os.path.abspath(__file__))
    coord = dryrun.free_coordinator()
    t0 = time.perf_counter()
    results = dryrun.run_processes(
        [[sys.executable, "-m", f"{PKG}.dryrun", "ops", coord, str(MP_PROCESSES), str(i),
          "--platform", "cuda", "--shards", "8", "--primary", str(N_PRIMARY),
          "--secondary", str(N_SECONDARY), "--seed", str(SEED),
          "--group-capacity", str(GROUP_CAPACITY)]
         for i in range(MP_PROCESSES)], 900, cwd=repo)
    wall_s = time.perf_counter() - t0
    steps = {}
    for pid, (_, out, err) in enumerate(results):
        _check("multiprocess ops", f"MP_OK pid={pid}" in out, f"process {pid}: {out}")
        for line in err.splitlines():
            if "backend" in line:
                log(f"[multiprocess ops] process {pid}: {line.strip()}")
        for line in out.splitlines():
            if line.startswith("MP_OPS "):
                rec = json.loads(line.removeprefix("MP_OPS "))
                steps.setdefault(rec["step"], []).append(rec)
    _check("multiprocess ops", set(steps) == set(digests)
           and all(len(r) == MP_PROCESSES for r in steps.values()),
           f"steps {sorted(steps)}, phase 15's {sorted(digests)}")
    for name, recs in steps.items():
        must = OPS_KERNELS.get(name, OPS_KERNELS[name[:3]])
        for rec in recs:
            what = f"multiprocess ops {name} process {rec['pid']}"
            _check(what, [rec["digest"], rec["run"]] == digests[name],
                   f"{rec['digest']} {rec['run']} != phase 15's one-process 8-shard "
                   f"result {digests[name]}")
            _check(what, rec["backend"] == "gloo", f"backend {rec['backend']}")
            for k in must:
                _check(what, rec["launches"][k] > 0, f"{k} was never launched")
            for k, v in rec["launches"].items():
                launches[k] += v
            run = rec["run"] or {}
            log(f"[time multiprocess ops] {card_line}: {name}, S=8 over {MP_PROCESSES} "
                f"processes, process {rec['pid']} ({rec['device']}, backend "
                f"{rec['backend']}): == phase 15's one-process result; host "
                f"{rec['host_ms']:.3f} ms, device {rec['device_ms']:.4f} ms (CUDA events, "
                f"warm); cross-process collectives {rec['comm_ms']:.3f} ms in "
                f"{rec['comm_calls']} calls (CUDA events), {rec['comm_bytes']:,} B sent (by "
                f"collective {json.dumps(rec['comm_sent'], sort_keys=True)}); retries "
                f"{run.get('retries', 0)}; peak allocated {rec['peak_bytes']} B; launches "
                f"{ {k: v for k, v in rec['launches'].items() if v} }")
        run = recs[0]["run"]
        log(f"[multiprocess ops] {name}: "
            + ("exchange inside the query layer, not exposed" if run is None else
               f"S {run['num_shards']}, exchange {run['exchange_bytes']:,} B each way "
               f"(all shards), attempts {run['attempts']}, retries {run['retries']}"))
    log(f"[time multiprocess ops] {card_line}: both ops processes {wall_s:.3f} s wall "
        f"(startup, generation of the whole relations, {len(steps)} steps each run "
        "untimed and timed)")


# ---------------------------------------------------------------- scripts

#: The knobs of the script entries, unset so that phase 17 runs each at its
#: defaults.
SCRIPT_ENV = ("PHJ_BENCH_PRIMARY", "PHJ_BENCH_SECONDARY", "PHJ_BENCH_SKEW",
              "PHJ_BENCH_FUSED_ONLY", "PHJ_AB_PRIMARY",
              "PHJ_AB_SECONDARY", "PHJ_AB_SKEW", "PHJ_AB_IMPLS")
#: record_results' algos and its figure.dat columns at the default partitions
GRID_ALGOS = ["sort-merge", "no-partitioning", "radix", "shuffle",
              "nopart-chained", "radix-2pass", "radix-chained"]
GRID_COLUMNS = ["SortMerge", "NoPartitioning", "Shuffle_1", "ShufflePiped_1",
                "Radix_32", "Radix_256", "Radix_2048", "NoPartChained",
                "Radix2Pass_32", "RadixChained_32"]
#: the two partition counts of the sweep (its default is nine)
SWEEP_PARTITIONS = ("32", "2048")
#: bench_scaling's rows per shard: weak scaling at S = 8 is the reference
#: workload, 10M ⋈ 200M, phase 14's 8-shard join
SCALING_BUILD, SCALING_PROBE = N_PRIMARY // 8, N_SECONDARY // 8
#: each one-line entry: (name, argv, the JSON keys of its JAX script)
SCRIPT_LINES = (
    ("bench_int64", [], {"metric", "value", "unit", "vs_baseline"}),
    ("bench_materialize", [], {"metric", "value", "unit", "seconds", "oracle_ok"}),
    ("bench_operators", [], {"metric", "value", "unit", "vs_baseline", "pipeline"}),
    ("bench_filtered_pipeline", [], {"metric", "filtered_R7_ms", "unfiltered_ms",
                                     "filter_overhead_ms", "survivors",
                                     "top1_count"}),
    ("bench_scaling", ["--build", str(SCALING_BUILD), "--probe", str(SCALING_PROBE)],
     {"workload", "backend", "host_cores", "note", "points"}),
    ("bench_overlap", ["--build", str(N_PRIMARY), "--probe", str(N_SECONDARY)],
     {"metric", "rows", "best_chunks", "best_speedup_vs_oneshot"}),
)


def _script_entry(torch, launches, card_line, name, argv):
    """``scripts.<name>.main(argv)`` on the card in this process; returns
    (stdout, stderr, launches of the run) after adding the launches."""
    import importlib

    module = importlib.import_module(f"{PKG}.scripts.{name}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, err = io.StringIO(), io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = module.main(argv + ["--platform", "cuda"])
    finally:
        for line in err.getvalue().splitlines():
            log(f"[scripts {name}] {line}")
    wall_s = time.perf_counter() - t0
    counts = _read_counts()
    _check(f"scripts {name}", rc == 0, f"exit {rc}")
    for k, v in counts.items():
        launches[k] += v
    log(f"[time scripts] {card_line}: {name}: {wall_s:.3f} s wall (generation, "
        f"warmups and timed runs), peak allocated "
        f"{torch.cuda.max_memory_allocated()} B, launches {counts}")
    return out.getvalue(), err.getvalue(), counts


def phase_scripts(torch, launches, card_line):
    """Phase 17: every entry of ``partitionedhashjoin_tpu_torch.scripts`` on
    the card at its defaults; adds each in-process entry's launches."""
    import os

    for var in SCRIPT_ENV:
        os.environ.pop(var, None)
    repo = os.path.dirname(os.path.abspath(__file__))
    outdir = os.path.join(repo, "build", "scripts")
    seen = dict.fromkeys(launches, 0)

    # record_results: every algo, the default partitions, in µs
    grid = os.path.join(outdir, "record_results")
    _, _, counts = _script_entry(torch, launches, card_line, "record_results",
                                 ["--outdir", grid, "--algos", *GRID_ALGOS,
                                  "--unit", "us"])
    with open(os.path.join(grid, "figure.dat")) as f:
        dat = f.read().splitlines()
    _check("scripts record_results", dat[0].split()[1:] == GRID_COLUMNS, dat[0])
    _check("scripts record_results", [x.split()[0] for x in dat[1:]]
           == ["partition", "build", "probe"], str(dat))
    for line in dat:
        log(f"[scripts record_results] figure.dat (us): {line}")
    seen = {k: seen[k] + counts[k] for k in seen}

    # sweep: the base join and two partition counts, each a CLI process
    sweep_dir = os.path.join(outdir, "sweep")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.scripts.sweep", "--outdir", sweep_dir,
         "--partitions", *SWEEP_PARTITIONS], cwd=repo, capture_output=True,
        text=True, timeout=900)
    wall_s = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        if "Join produced" in line or "wrote" in line or proc.returncode:
            log(f"[scripts sweep] {line}")
    _check("scripts sweep", proc.returncode == 0, f"exit {proc.returncode}")
    matched = proc.stderr.count(f"Join produced {N_SECONDARY} matches")
    _check("scripts sweep", matched == 1 + len(SWEEP_PARTITIONS),
           f"{matched} CLI runs counted {N_SECONDARY:,}")
    with open(os.path.join(sweep_dir, "figure.dat")) as f:
        dat = f.read().splitlines()
    _check("scripts sweep", dat[0].split()[1:] == ["NoPartitioning"] + [
        f"Radix_{p}" for p in SWEEP_PARTITIONS], dat[0])
    for line in dat:
        log(f"[scripts sweep] figure.dat (ms): {line}")
    log(f"[time scripts] {card_line}: sweep --partitions "
        f"{' '.join(SWEEP_PARTITIONS)}: {wall_s:.3f} s wall, "
        f"{1 + len(SWEEP_PARTITIONS)} CLI processes (each: start-up, alias "
        "generation, warmup, timed run)")

    # the one-line entries
    kind = torch.cuda.get_device_name(0)
    for name, argv, keys in SCRIPT_LINES:
        out, err, counts = _script_entry(torch, launches, card_line, name, argv)
        seen = {k: seen[k] + counts[k] for k in seen}
        lines = out.splitlines()
        _check(f"scripts {name}", len(lines) == 1, f"{len(lines)} stdout lines")
        doc = json.loads(lines[0])
        _check(f"scripts {name}", set(doc) == keys | {"device"}
               and doc["device"] == kind, str(doc))
        what = f"scripts {name}"
        if name == "bench_materialize":
            _check(what, doc["oracle_ok"] is True, str(doc))
        if name == "bench_filtered_pipeline":
            _check(what, 0 < doc["survivors"] < N_SECONDARY, str(doc))
        if name == "bench_scaling":
            _check(what, [p["shards"] for p in doc["points"]] == [1, 2, 4, 8]
                   and doc["backend"] == "cuda", str(doc))
        elif name == "bench_overlap":
            _check(what, doc["metric"] == "overlap_pipelined_vs_oneshot_S8"
                   and [r["chunks"] for r in doc["rows"]] == [1, 2, 4, 8], str(doc))
        else:
            _check(what, f"{N_SECONDARY}_skew{SKEW}" in doc["metric"], doc["metric"])
        log(f"[time scripts] {card_line}: {name}: {lines[0]}")

    # the sorter A/B: stderr only, both counts exact
    out, err, counts = _script_entry(torch, launches, card_line, "bench_sorter_ab", [])
    seen = {k: seen[k] + counts[k] for k in seen}
    _check("scripts bench_sorter_ab", out == "", out)
    for impl in ("xla", "pallas"):
        line = [x for x in err.splitlines() if x.startswith(f"{impl:7s}:")]
        _check("scripts bench_sorter_ab", len(line) == 1
               and f"count={N_SECONDARY} " in line[0], f"{impl}: {line}")

    for k in ("k1", "k3", "k4", "k5", "k6", "k7"):
        _check("scripts", seen[k] > 0, f"{k} was never launched by the entries")
    log(f"[scripts] launches of the in-process entries: {seen}")


def main() -> int:
    import torch

    card = phase_device(torch)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase_build()
    stats = {
        "merge_probe_count": parity_k1(torch, device),
        "merge_probe_count_i64": parity_k3(torch, device),
        "merge_count_sorted": parity_k2(torch, device),
        "merge_probe_payload": parity_k4(torch, device),
        "compact": parity_k5(torch, device),
    }
    stats["sort_blocks"], stats["merge_pass"], stats["tuple_sort"] = parity_k6(
        torch, device)
    stats["key_sort_i64"] = parity_k6_i64(torch, device)
    stats["hash_keys"] = parity_k7(torch, device)
    stats["hash_keys_i64"] = parity_k7_i64(torch, device)
    stats["chained_count"] = parity_chained(torch, device)
    stats["chained_build"] = parity_chained_build(torch, device)
    stats["zipf_keys_pallas"] = parity_k8(torch, device, card)
    launches = dict.fromkeys(("k1", "k2", "k3", "k4", "k5", "k6a", "k6b",
                              "k6", "k7", "k7i64", "k8", "chained",
                              "chained_build"), 0)
    phase_library(torch, device, launches)
    phase_main(torch, launches)
    phase_query(torch, device, launches)
    phase_generate(torch, device, launches)
    a, b = phase_alias(torch, device, launches, card)
    phase_multi_key(torch, launches, a, b, card)
    del a, b
    phase_bench(torch, launches, card)
    rel = phase_sql(torch, device, launches, card)
    phase_hash(torch, device, launches, card, rel)
    s8_run = phase_shuffle(torch, device, launches, card)
    digests = phase_dist(torch, device, launches, card, rel)
    del rel
    phase_multiprocess(torch, launches, card, s8_run)
    phase_scripts(torch, launches, card)
    phase_multiprocess_ops(torch, launches, card, digests)
    described = (
        ("merge_probe_count", "k1", "merge_probe.cu", "merge_probe.py:292"),
        ("merge_probe_count_i64", "k3", "merge_probe.cu",
         "merge_probe.py:674"),
        ("merge_count_sorted", "k2", "merge_count.cu", "merge_count.py:90"),
        ("merge_probe_payload", "k4", "merge_probe.cu", "merge_probe.py:487"),
        ("compact", "k5", "compact.cu", "compact.py:131"),
        ("sort_blocks", "k6a", "bitonic_sort.cu", "bitonic_sort.py:162"),
        ("merge_pass", "k6b", "bitonic_sort.cu", "bitonic_sort.py:375"),
        ("tuple_sort", "k6", "radix_sort.cu", "bitonic_sort.py:524"),
        ("key_sort_i64", "k6", "radix_sort.cu", "bitonic_sort.py:524"),
        ("hash_keys", "k7", "generate.cu", "generate.py:46"),
        ("hash_keys_i64", "k7i64", "generate.cu", "generate.py:46"),
        ("chained_count", "chained", "chained_probe.cu", None),
        ("chained_build", "chained_build", "chained_probe.cu", None),
        ("zipf_keys_pallas", "k8", "generate.cu", "generate.py:103"),
    )
    kernels = []
    for name, key, source, replaces in described:
        s = stats[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"{PKG}/csrc/{source}",
            "replaces": f"{PALLAS}/{replaces}" if replaces else None,
            "launches": launches[key],
            "max_abs_err": s["max_abs_err"],
            "ms": s["ms"],
            "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"],
            "bound_by": "operations" if key == "k8" else "bytes",
            "library_ms": s["library_ms"],
        })
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
