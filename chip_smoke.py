#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It drives ``partitionedhashjoin_tpu_torch`` (never the JAX package) in phases
and raises on the first failure:

1. device  — needs ``torch.cuda.is_available()``; prints the card's name and
             power limit (nvidia-smi) and the torch / CUDA versions.
2. build   — builds every kernel library from ``csrc/`` with nvcc into
             ``build/kernels/``, one nvcc per source, all started together;
             prints the build time and ptxas' report of each.
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
             phase counterparts, phase A K6a and merge pass K6b; K7 (the
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
             ``torch.sort(..., dim=1)`` over one row per block for K6a and
             per pair of runs for K6b, each also checked equal to them).
4. library — at 10M ⋈ 200M: ``sort_merge_count`` and ``anti_count`` through
             K2, ``two_run_count_i64`` and an int64 ``PreparedBuild`` through
             K3, each exact.
5. main    — ``cli.main`` at the reference workload (10M sequential build
             ⋈ 200M Zipf(1.05) probe, with its warmup run) for the default
             join (no-partitioning), radix-partitioning, planned, sort-merge
             and sort-merge with int64 keys.  Each must count exactly
             200,000,000, print the JAX CLI's parameters, and launch its
             kernel.

6. query   — at 10M ⋈ 200M with the probe payloads of
             ``scripts/bench_pipeline.py`` (uniform in [0, 2^20)):
             ``two_run_materialize`` (all match: keys ascending, pay_a ==
             key ^ 0x5A17, pay_b sum kept) and again with uniform probe keys
             over [1, 2·N_A] (half miss: K5 compacts the matches);
             ``SortMergeJoiner.run_materialize`` inner and anti;
             ``bench_pipeline.run_query`` for the ordered and the naive plan
             (equal on every group field, count 200,000,000, groups equal to
             a ``bincount`` / int64 ``scatter_add`` mod 2^32 oracle, and no
             more groups than keys the Zipf sampler can reach from float32
             uniforms); and
             ``filter_sort_aggregate_staged`` with ``(p & 1) == 0`` against
             ``filter_sort_aggregate``.  K4 and K5 must launch.
7. sorter  — ``merge_join.set_sort_impl("pallas")`` (restored to "xla"
             after): ``cli.main`` for no-partitioning, radix-partitioning,
             sort-merge and sort-merge int64 (each 200,000,000 and the
             radix sort plus K1 or K3 launched), ``two_run_materialize``
             (equal to the "xla" run on keys, pay_a and the pay_b sum) and
             both query plans (equal to the "xla" plans and to the oracle).
8. generate — ``hash_keys`` over the 200M probe keys (K7);
             ``zipf_keys_pallas`` draws 200M Zipf(1.05) keys over [1, 10M]
             on the card (K8), ``two_run_count`` against the 10M sequential
             build counts exactly 200,000,000; the TV distance of the 1,000
             hottest keys' frequencies from the exact pmf and the distinct
             keys reached are printed.

Kernel launch counts are set to 0 just before each path of phases 4 to 8
and read just after; a kernel's ``launches`` is the sum over the paths that
run it.  Comparison launches in phase 3 are not counted.  The script prints
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
#: kernel counter that must be non-zero or None).
MAIN_RUNS = (
    ([], {"Type": "NoPartitioning"}, "k1"),
    (["--join", "radix-partitioning"],
     {"Type": "RadixPartitioning", "NumberOfPartitions": "32"}, "k1"),
    (["--join", "planned"], {"Type": "Planned", "Plan": "interval"}, None),
    (["--join", "sort-merge"], {"Type": "SortMerge"}, "k1"),
    (["--join", "sort-merge", "--key-dtype", "int64"],
     {"Type": "SortMerge"}, "k3"),
)
#: The CLI paths of phase 7, under the sorter switch's "pallas" (planned
#: sorts no probe relation).
SORTER_RUNS = tuple(run for run in MAIN_RUNS if run[2] is not None)


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

    names = ("merge_probe", "merge_count", "compact", "bitonic_sort",
             "radix_sort", "generate")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(_build.build, names))
    log(f"[build] {', '.join(p.name for p in paths)} in "
        f"{time.perf_counter() - t0:.2f} s (parallel nvcc)")
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
    del inv, pay
    _, zipf = _reference_data(torch, device, torch.int32)
    timed("the main path's Zipf probe keys", [zipf], lambda: torch.sort(zipf).values)
    del zipf

    # the phases alone at k = 1 over whole blocks
    n = N_SECONDARY // blk * blk
    xb = x[:n]
    del x
    a_ms, a_plain_ms = _time_pair(torch, lambda: bs.sort_blocks_tuple(xb),
                                  lambda: bs.sort_blocks_plain(xb), rounds=2, reps=3)
    blocks = bs.sort_blocks_tuple(xb)[0]
    b_ms, b_plain_ms = _time_pair(
        torch, lambda: bs.merge_pass_tuple(blocks, run_len=blk),
        lambda: bs.merge_pass_plain(blocks, run_len=blk), rounds=2, reps=3)
    # the library's batched segmented sort: one row per block, and one row
    # per pair of runs (n holds an even number of blocks)
    pairs = blocks[: n // (2 * blk) * 2 * blk]

    def sort_rows(t, width):
        return torch.sort(t.view(-1, width), dim=1).values

    a_lib_ms = _time_ms(torch, lambda: sort_rows(xb, blk), reps=3)
    b_lib_ms = _time_ms(torch, lambda: sort_rows(pairs, 2 * blk), reps=3)
    par_a.check_tensors(f"sort_blocks {n:,} rows == torch.sort per block",
                        lambda: [blocks], lambda: [sort_rows(xb, blk).view(-1)])
    par_b.check_tensors(
        f"merge_pass {pairs.shape[0]:,} rows == torch.sort per run pair",
        lambda: [bs.merge_pass_tuple(pairs, run_len=blk)[0]],
        lambda: [sort_rows(pairs, 2 * blk).view(-1)])
    bound = _bound_ms(n * 4 * 2)
    log(f"[time K6a] sort_blocks, {n:,} rows, k=1: kernel {a_ms:.4f} ms, plain "
        f"{a_plain_ms:.4f} ms, torch.sort(dim=1) over {blk}-row rows "
        f"{a_lib_ms:.4f} ms, bound {bound:.4f} ms")
    log(f"[time K6b] one merge pass (runs of {blk}), {n:,} rows, k=1: kernel "
        f"{b_ms:.4f} ms, plain {b_plain_ms:.4f} ms, torch.sort(dim=1) over "
        f"{2 * blk}-row rows {b_lib_ms:.4f} ms, bound {bound:.4f} ms")
    del xb, blocks, pairs
    sort_ms, sort_plain_ms, sort_bound, sort_lib_ms = stat
    return (
        {"max_abs_err": par_a.max_err, "ms": a_ms, "plain_ms": a_plain_ms,
         "bound_ms": bound, "library_ms": a_lib_ms},
        {"max_abs_err": par_b.max_err, "ms": b_ms, "plain_ms": b_plain_ms,
         "bound_ms": bound, "library_ms": b_lib_ms},
        {"max_abs_err": par.max_err, "ms": sort_ms, "plain_ms": sort_plain_ms,
         "bound_ms": sort_bound, "library_ms": sort_lib_ms},
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
    from partitionedhashjoin_tpu_torch.ops.kernels import compact as kc
    from partitionedhashjoin_tpu_torch.ops.kernels import generate as kg
    from partitionedhashjoin_tpu_torch.ops.kernels import merge_count as mc
    from partitionedhashjoin_tpu_torch.ops.kernels import merge_payload as mpay
    from partitionedhashjoin_tpu_torch.ops.kernels import merge_probe as mp

    return mp, mc, mpay, kc, bs, kg


def _reset_counts():
    mp, mc, mpay, kc, bs, kg = _counters()
    mp.LAUNCHES = mp.LAUNCHES_I64 = mc.LAUNCHES = mpay.LAUNCHES = 0
    kc.LAUNCHES = bs.LAUNCHES_BLOCKS = bs.LAUNCHES_MERGE = 0
    bs.LAUNCHES_UPSWEEP = bs.LAUNCHES_SORT = 0
    kg.LAUNCHES_HASH = kg.LAUNCHES_ZIPF = kg.LAUNCHES_UNIFORMS = 0


def _read_counts():
    mp, mc, mpay, kc, bs, kg = _counters()
    return {"k1": mp.LAUNCHES, "k3": mp.LAUNCHES_I64, "k2": mc.LAUNCHES,
            "k4": mpay.LAUNCHES, "k5": kc.LAUNCHES,
            "k6a": bs.LAUNCHES_BLOCKS, "k6b": bs.LAUNCHES_MERGE,
            "k6": bs.LAUNCHES_UPSWEEP + bs.LAUNCHES_SORT,
            "k7": kg.LAUNCHES_HASH, "k8": kg.LAUNCHES_ZIPF}


def phase_library(torch, device, launches):
    """Library entry points at 10M ⋈ 200M; adds each path's launches."""
    from partitionedhashjoin_tpu_torch.ops import merge_join, sort_merge

    def run(name, fn, want, kernel):
        _reset_counts()
        t0 = time.perf_counter()
        got = int(fn())
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = _read_counts()
        if got != want or counts[kernel] == 0:
            raise AssertionError(
                f"[library] {name}: {got} (want {want}), launches {counts}"
            )
        launches[kernel] += counts[kernel]
        log(f"[library] {name}: {got} ok, {kernel} launches "
            f"{counts[kernel]}, {wall_ms:.3f} ms host clock")

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
    """Collects the counts the CLI logs as "Join produced %d matches"."""

    def __init__(self):
        super().__init__()
        self.counts = []

    def filter(self, record):
        if record.msg == "Join produced %d matches":
            self.counts.append(int(record.args[0]))
        return True


def phase_main(torch, launches, runs=MAIN_RUNS, tag="main", kernels=()):
    """``cli.main`` for every path of ``runs``; each must also launch
    ``kernels``; adds each path's launches."""
    from partitionedhashjoin_tpu_torch import cli

    base = {
        "PrimaryRelationSize": str(N_PRIMARY),
        "SecondaryRelationSize": str(N_SECONDARY),
        "Skew": f"{SKEW:.6f}",
    }
    for extra_argv, params, kernel in runs:
        argv = extra_argv + [
            "--primary", str(N_PRIMARY), "--secondary", str(N_SECONDARY),
            "--skew", str(SKEW), "--seed", str(SEED), "--output", "stdout",
            "--platform", "cuda",
        ]
        name = " ".join(extra_argv) or "(default join)"
        must = ((kernel,) if kernel else ()) + tuple(kernels)
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
            f"phases partition {res['partition']} / build {res['build']} / "
            f"probe {res['probe']} ms, cli.main wall {wall_s:.3f} s "
            f"(generation + warmup + timed run), peak allocated {peak} B"
        )


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


def _zipf_reach(torch, device):
    """(keys the Zipf sampler can draw at all, expected distinct keys of an
    exact Zipf(SKEW) in N_SECONDARY draws): every float32 uniform in
    [0, 1) through the sampler's inverse CDF, and the float64 law."""
    from partitionedhashjoin_tpu_torch.ops import generators

    u = torch.arange(1 << 24, dtype=torch.float32, device=device) * 2.0**-24
    keys, _ = generators.zipf_candidates(u, torch.zeros_like(u), SKEW, N_PRIMARY)
    reach = int(torch.unique(keys).numel())
    k = torch.arange(1, N_PRIMARY + 1, dtype=torch.float64, device=device)
    p = k ** -SKEW
    p /= p.sum()
    return reach, float((1 - torch.exp(-N_SECONDARY * p)).sum())


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
    for k in kernels:
        _check(name, counts[k] > 0, f"{k} was never launched ({counts})")
        launches[k] += counts[k]
    log(f"[{tag}] {name}: {wall_ms:.3f} ms host clock, launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return out


def phase_query(torch, device, launches):
    """The materializing joins and the JOIN → GROUP BY → top-10 pipeline at
    10M ⋈ 200M; adds each path's K4/K5 launches."""
    from partitionedhashjoin_tpu_torch import bench_pipeline
    from partitionedhashjoin_tpu_torch.data.table import make_table
    from partitionedhashjoin_tpu_torch.ops import aggregate, merge_join
    from partitionedhashjoin_tpu_torch.ops.sort_merge import SortMergeJoiner

    run = functools.partial(_run_path, torch, "query", launches)

    a_keys, a_pay, b_keys, b_pay = _query_relations(torch, device)
    keys, pa, pb, count = run(
        "two_run_materialize (all match)",
        lambda: merge_join.two_run_materialize(a_keys, a_pay, b_keys, b_pay),
        ("k4",))
    _check("two_run_materialize", int(count) == N_SECONDARY, f"count {int(count)}")
    _check("two_run_materialize", bool((keys[1:] >= keys[:-1]).all()),
           "keys not ascending")
    _check("two_run_materialize", torch.equal(pa, keys ^ SALT), "pay_a")
    _check("two_run_materialize",
           int(pb.sum(dtype=torch.int64)) == int(b_pay.sum(dtype=torch.int64)),
           "pay_b sum")
    del keys, pa, pb
    log(f"[query] two_run_materialize: {int(count):,} rows, keys ascending, "
        f"pay_a == key ^ 0x5A17, pay_b sum kept: ok")

    # half the probe keys miss: the compaction runs
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 6)
    b_half = torch.randint(1, 2 * N_PRIMARY + 1, (N_SECONDARY,), generator=gen,
                           dtype=torch.int32, device=device)
    keys, pa, pb, count = run(
        "two_run_materialize (half miss)",
        lambda: merge_join.two_run_materialize(a_keys, a_pay, b_half, b_pay),
        ("k4", "k5"))
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
            ("k4", "k5"))
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
    del results, g2, hot2, want, rel

    table = make_table(b_keys, torch.arange(N_SECONDARY, dtype=torch.int32,
                                            device=device))
    del a_keys, a_pay, b_pay

    def even(k, p):
        return (p & 1) == 0

    staged, n_staged = run(
        "filter_sort_aggregate_staged",
        lambda: aggregate.filter_sort_aggregate_staged(
            table, even, group_capacity=GROUP_CAPACITY), ("k5",))
    fused, n_fused = run(
        "filter_sort_aggregate",
        lambda: aggregate.filter_sort_aggregate(
            table, even, group_capacity=GROUP_CAPACITY), ("k5",))
    _check("staged filter", int(n_staged) == int(n_fused) == N_SECONDARY // 2
           and bench_pipeline.plans_agree(staged, fused), "staged != fused")
    log(f"[query] staged filter aggregate == fused: {int(staged.num_groups):,}"
        f" groups of {int(n_staged):,} rows: ok")
    return g1, hot1


def phase_sorter(torch, device, launches, xla_groups, xla_hot):
    """Phase 7: the main paths with the sorter switch on "pallas" (K6, the
    radix sort); adds each path's launches."""
    from partitionedhashjoin_tpu_torch import bench_pipeline
    from partitionedhashjoin_tpu_torch.ops import merge_join

    run = functools.partial(_run_path, torch, "sorter", launches)

    a_keys, a_pay, b_keys, b_pay = _query_relations(torch, device)
    want = merge_join.two_run_materialize(a_keys, a_pay, b_keys, b_pay)
    merge_join.set_sort_impl("pallas")
    try:
        phase_main(torch, launches, SORTER_RUNS, "sorter", ("k6",))
        got = run("two_run_materialize (all match)",
                  lambda: merge_join.two_run_materialize(a_keys, a_pay, b_keys, b_pay),
                  ("k6", "k4"))
        _check("sorter materialize", int(got[3]) == int(want[3]) == N_SECONDARY,
               f"count {int(got[3])}")
        _check("sorter materialize", torch.equal(got[0], want[0])
               and torch.equal(got[1], want[1]), "keys or pay_a")
        _check("sorter materialize", int(got[2].sum(dtype=torch.int64))
               == int(want[2].sum(dtype=torch.int64)), "pay_b sum")
        del got, want
        log("[sorter] two_run_materialize == the library sort's on keys, pay_a "
            "and the pay_b sum: ok")
        rel = (a_keys, a_pay, b_keys, b_pay)
        oracle = _group_oracle(torch, b_keys, b_pay)
        for plan, ordered in (("ordered", True), ("naive", False)):
            g, hot, count = run(
                f"pipeline {plan} plan",
                lambda: bench_pipeline.run_query(*rel, GROUP_CAPACITY, ordered),
                ("k6", "k4", "k5"))
            groups = oracle["keys"].shape[0]
            _check(f"sorter {plan}", int(count) == N_SECONDARY
                   and bench_pipeline.plans_agree(g, xla_groups)
                   and torch.equal(hot.keys, xla_hot.keys), "differs from xla")
            for f, w in oracle.items():
                _check(f"sorter {plan}", torch.equal(getattr(g, f)[:groups], w),
                       f"oracle {f}")
            log(f"[sorter] pipeline {plan} plan: {groups:,} groups, == the "
                "library sort's plans and the oracle: ok")
            del g, hot
    finally:
        merge_join.set_sort_impl("xla")


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
    stats["hash_keys"] = parity_k7(torch, device)
    stats["zipf_keys_pallas"] = parity_k8(torch, device, card)
    launches = dict.fromkeys(("k1", "k2", "k3", "k4", "k5", "k6a", "k6b",
                              "k6", "k7", "k8"), 0)
    phase_library(torch, device, launches)
    phase_main(torch, launches)
    xla_groups, xla_hot = phase_query(torch, device, launches)
    phase_sorter(torch, device, launches, xla_groups, xla_hot)
    del xla_groups, xla_hot
    phase_generate(torch, device, launches)
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
        ("hash_keys", "k7", "generate.cu", "generate.py:46"),
        ("zipf_keys_pallas", "k8", "generate.cu", "generate.py:103"),
    )
    kernels = []
    for name, key, source, replaces in described:
        s = stats[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"{PKG}/csrc/{source}",
            "replaces": f"{PALLAS}/{replaces}",
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
