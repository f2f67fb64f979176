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
             K1 (int32 merge-probe count, ``exclude_int32_max`` off and on),
             K3 (int64 merge-probe count), K2 (fused merge count).  Then each
             is timed with CUDA events at the main path's shapes (10M ⋈ 200M;
             the 210M-row merged stream for K2), beside its plain version,
             ``torch.isin(b, a).sum()`` (the one PyTorch call that computes
             the K1/K3 count) and the sorts of the main path.
4. library — at 10M ⋈ 200M: ``sort_merge_count`` and ``anti_count`` through
             K2, ``two_run_count_i64`` and an int64 ``PreparedBuild`` through
             K3, each exact.
5. main    — ``cli.main`` at the reference workload (10M sequential build
             ⋈ 200M Zipf(1.05) probe, with its warmup run) for the default
             join (no-partitioning), radix-partitioning, planned, sort-merge
             and sort-merge with int64 keys.  Each must count exactly
             200,000,000, print the JAX CLI's parameters, and launch its
             kernel.

Kernel launch counts are set to 0 just before each path of phases 4 and 5
and read just after; a kernel's ``launches`` is the sum over the paths that
run it.  Comparison launches in phase 3 are not counted.  The script prints
one JSON line describing the kernels and, last, the ``"ok"`` line.  Without a
CUDA device, or outside the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
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
I32_MAX = 2**31 - 1
I32_MIN = -(2**31)
I64_MAX = 2**63 - 1
I64_MIN = -(2**63)
PKG = "partitionedhashjoin_tpu_torch"
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
        merge_count,
        merge_probe,
    )

    names = ("merge_probe", "merge_count")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(_build.build, names))
    log(f"[build] {', '.join(p.name for p in paths)} in "
        f"{time.perf_counter() - t0:.2f} s (parallel nvcc)")
    merge_probe.load_library()  # loads each and checks its tile size
    merge_count.load_library()
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

    for name, a, b in _k1_cases(np, mp.TILE_ROWS):
        check(name, _sorted_on(torch, a, np.int32, device),
              _sorted_on(torch, b, np.int32, device),
              lambda ex, a=a, b=b: _isin_oracle(np, a, b, I32_MAX if ex else None))

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


def parity_k3(torch, device):
    import numpy as np

    from partitionedhashjoin_tpu_torch.ops.kernels import merge_probe as mp

    par = Parity(torch, "K3")

    def check(name, a_s, b_s, oracle=None):
        par.check(name, lambda: mp.ranged_merge_count_i64(a_s, b_s),
                  lambda: mp.ranged_merge_count_i64_plain(a_s, b_s), oracle)

    for name, a, b in _k3_cases(np, mp.TILE_ROWS):
        check(name, _sorted_on(torch, a, np.int64, device),
              _sorted_on(torch, b, np.int64, device), _isin_oracle(np, a, b))

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
    return cases


def parity_k2(torch, device):
    import numpy as np

    from partitionedhashjoin_tpu_torch.ops import sort_merge
    from partitionedhashjoin_tpu_torch.ops.kernels import merge_count as mc

    par = Parity(torch, "K2")

    def check(name, keys, is_build, oracle=None):
        par.check(name, lambda: mc.merge_count_sorted(keys, is_build),
                  lambda: mc.merge_count_sorted_plain(keys, is_build), oracle)

    for name, keys, is_build, oracle in _k2_cases(np, mc.TILE_ROWS):
        t_keys = torch.tensor(keys, device=device)
        check(name, t_keys, torch.tensor(is_build, device=device), oracle)
        check(name + " (uint8 tags)", t_keys,
              torch.tensor(is_build.astype(np.uint8), device=device), oracle)

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
    log(
        f"[time K2] {n}-row merged stream: kernel {kernel_ms:.4f} ms "
        f"({n / (kernel_ms * 1e-3):.4e} rows/s), plain {plain_ms:.4f} ms"
    )
    del keys_s, is_build_s
    return {
        "max_abs_err": par.max_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": _bound_ms(n * (4 + 1)),
        # no single PyTorch call computes the merge count
        "library_ms": None,
    }


# ---------------------------------------------------------------- paths


def _counters():
    from partitionedhashjoin_tpu_torch.ops.kernels import merge_count as mc
    from partitionedhashjoin_tpu_torch.ops.kernels import merge_probe as mp

    return mp, mc


def _reset_counts():
    mp, mc = _counters()
    mp.LAUNCHES = mp.LAUNCHES_I64 = mc.LAUNCHES = 0


def _read_counts():
    mp, mc = _counters()
    return {"k1": mp.LAUNCHES, "k3": mp.LAUNCHES_I64, "k2": mc.LAUNCHES}


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


def phase_main(torch, launches):
    """``cli.main`` for every path of MAIN_RUNS; adds each path's launches."""
    from partitionedhashjoin_tpu_torch import cli

    base = {
        "PrimaryRelationSize": str(N_PRIMARY),
        "SecondaryRelationSize": str(N_SECONDARY),
        "Skew": f"{SKEW:.6f}",
    }
    for extra_argv, params, kernel in MAIN_RUNS:
        argv = extra_argv + [
            "--primary", str(N_PRIMARY), "--secondary", str(N_SECONDARY),
            "--skew", str(SKEW), "--seed", str(SEED), "--output", "stdout",
            "--platform", "cuda",
        ]
        name = " ".join(extra_argv) or "(default join)"
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
            raise AssertionError(f"[main] {name}: rc {rc}, counts {counts.counts}")
        if kernel is not None and run_counts[kernel] == 0:
            raise AssertionError(f"[main] {name}: {kernel} was never launched")
        if doc.get("id") != "hashjointimingresult" or doc["parameters"] != {
            **base, **params
        } or set(doc["results"]) != {"partition", "build", "probe"}:
            raise AssertionError(f"[main] {name}: unexpected document {doc}")
        if kernel is not None:
            launches[kernel] += run_counts[kernel]
        res = doc["results"]
        log(f"[main] {name}: result {json.dumps(doc, sort_keys=True)}")
        log(
            f"[main] {name}: count {counts.counts[0]}, launches {run_counts}, "
            f"phases partition {res['partition']} / build {res['build']} / "
            f"probe {res['probe']} ms, cli.main wall {wall_s:.3f} s "
            f"(generation + warmup + timed run), peak allocated {peak} B"
        )


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
    }
    launches = {"k1": 0, "k2": 0, "k3": 0}
    phase_library(torch, device, launches)
    phase_main(torch, launches)
    described = (
        ("merge_probe_count", "k1", "merge_probe.cu", "merge_probe.py:292"),
        ("merge_probe_count_i64", "k3", "merge_probe.cu",
         "merge_probe.py:674"),
        ("merge_count_sorted", "k2", "merge_count.cu", "merge_count.py:90"),
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
            "bound_by": "bytes",
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
