"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
This file does not import jax, so on a machine with a card and without jax
it runs with tests/conftest.py (which imports jax) switched off:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu_torch.config import RadixClusteringConfiguration
from partitionedhashjoin_tpu_torch.data.table import table_from_numpy
from partitionedhashjoin_tpu_torch.ops import merge_join, sort_merge
from partitionedhashjoin_tpu_torch.ops.kernels import merge_count as mc
from partitionedhashjoin_tpu_torch.ops.kernels import merge_probe as mp
from partitionedhashjoin_tpu_torch.ops.no_partitioning import (
    NoPartitioningHashJoiner,
)
from partitionedhashjoin_tpu_torch.ops.planner import PlannedJoiner
from partitionedhashjoin_tpu_torch.ops.radix_cluster import RadixHashJoiner

pytestmark = pytest.mark.cuda

I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min
I64_MAX = np.iinfo(np.int64).max
I64_MIN = np.iinfo(np.int64).min


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _cases():
    t = mp.TILE_ROWS
    rng = np.random.default_rng(3)
    a = rng.integers(I32_MIN, I32_MAX, 4000, dtype=np.int64)
    b = rng.integers(I32_MIN, I32_MAX, 70000, dtype=np.int64)
    b[:30000] = rng.choice(a, 30000)
    a[::97] = I32_MAX
    b[::89] = I32_MAX
    return {
        "empty_build": ([], [1, 2]),
        "empty_probe": ([1, 2], []),
        "full_domain": ([I32_MAX, I32_MAX, 5, I32_MIN, -7],
                        [I32_MAX, 5, 6, I32_MAX, -7, I32_MIN, I32_MIN]),
        "max_absent": ([5, -7], [I32_MAX, 5]),
        "max_only": ([I32_MAX], [I32_MAX] * 3),
        "giant_run": (np.full(3 * t + 5, 42),
                      np.concatenate([np.full(2 * t + 100, 42), [41, 43]])),
        "straddle": (np.arange(0, 100, 2),
                     np.concatenate([np.full(t - 3, 10), np.full(10, 11),
                                     np.full(t + 1, 12),
                                     np.repeat(np.arange(13, 90), 777)])),
        "ragged": (rng.integers(-5000, 5000, 3000),
                   rng.integers(-6000, 6000, 5 * t + 123)),
        "int32_domain": (a, b),
    }


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("case", sorted(_cases()))
def test_kernel_matches_plain(cuda, case, exclude):
    a, b = (
        torch.sort(torch.tensor(np.asarray(x, np.int32), device=cuda)).values
        for x in _cases()[case]
    )
    before = mp.LAUNCHES
    got = mp.ranged_merge_count_prepared(a, b, exclude)
    want = mp.ranged_merge_count_plain(a, b, exclude)
    torch.cuda.synchronize()
    assert got.device == a.device and got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == int(want)
    assert mp.LAUNCHES == before + (1 if a.numel() and b.numel() else 0)


def test_two_run_count_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(23)
    a = rng.integers(-50, 50, 9000).astype(np.int32)
    b = rng.integers(-80, 80, 40000).astype(np.int32)
    av = rng.random(9000) < 0.9
    bv = rng.random(40000) < 0.8
    a[::701] = I32_MAX
    b[::503] = I32_MAX
    cpu = merge_join.two_run_count(*map(torch.from_numpy, (a, b, av, bv)))
    gpu = merge_join.two_run_count(
        *(torch.from_numpy(x).to(cuda) for x in (a, b, av, bv))
    )
    assert gpu.device.type == "cuda"
    assert int(gpu) == int(cpu)


def test_wrapper_rejects_mixed_devices(cuda):
    a = torch.arange(10, dtype=torch.int32)
    with pytest.raises(ValueError):
        mp.ranged_merge_count_prepared(a, a.to(cuda))


def _i64_cases():
    t = mp.TILE_ROWS
    rng = np.random.default_rng(31)
    w = 7 << 32
    a = rng.integers(I64_MIN, I64_MAX, 4000, dtype=np.int64)
    b = rng.integers(I64_MIN, I64_MAX, 70000, dtype=np.int64)
    b[:30000] = rng.choice(a, 30000)
    b[30000:40000] = rng.choice(a, 10000) ^ (1 << 31)
    return {
        "empty_build": ([], [1, 2]),
        "empty_probe": ([1, 2], []),
        "int64_ends": ([I64_MAX, 5, I64_MIN], [I64_MAX, I64_MAX, I64_MIN, 6]),
        "max_absent": ([5, -7], [I64_MAX, 5, I64_MIN]),
        "low_word_across_2^31": ([w, w + 2**31],
                                 [w, w + 2**31 - 1, w + 2**31, w + 2**32 - 1]),
        "k_and_k_plus_2^32": ([99, -99], [99, 99 + 2**32, -99, -99 - 2**32]),
        "giant_run": (np.full(3 * t + 5, 2**40),
                      np.concatenate([np.full(2 * t + 100, 2**40), [1, 2**41]])),
        "straddle": (np.arange(0, 100, 2) << 33,
                     np.concatenate([np.full(t - 3, 10), np.full(10, 11),
                                     np.full(t + 1, 12),
                                     np.repeat(np.arange(13, 90), 777)]) << 33),
        "int64_domain": (a, b),
    }


@pytest.mark.parametrize("case", sorted(_i64_cases()))
def test_i64_kernel_matches_plain(cuda, case):
    a, b = (
        torch.sort(torch.tensor(np.asarray(x, np.int64), device=cuda)).values
        for x in _i64_cases()[case]
    )
    before = mp.LAUNCHES_I64
    got = mp.ranged_merge_count_i64(a, b)
    want = mp.ranged_merge_count_i64_plain(a, b)
    torch.cuda.synchronize()
    assert got.device == a.device and got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == int(want) == int(np.isin(b.cpu().numpy(), a.cpu().numpy()).sum())
    assert mp.LAUNCHES_I64 == before + (1 if a.numel() and b.numel() else 0)


def _merged(a, b):
    a, b = np.asarray(a, np.int32), np.asarray(b, np.int32)
    keys = np.concatenate([a, b])
    is_build = np.concatenate([np.ones(a.size, bool), np.zeros(b.size, bool)])
    order = np.argsort(keys, kind="stable")
    return keys[order], is_build[order]


def _merge_count_cases():
    t = mc.TILE_ROWS
    rng = np.random.default_rng(37)
    carry = np.zeros(3 * t + 17, bool)
    carry[0] = True
    no_build = np.zeros(2 * t, bool)
    no_build[0] = True
    a = rng.integers(I32_MIN, I32_MAX, 30000, dtype=np.int64)
    b = rng.integers(I32_MIN, I32_MAX, 120000, dtype=np.int64)
    b[:50000] = rng.choice(a, 50000)
    return {
        "random_100x400": _merged(rng.integers(-500, 500, 100),
                                  rng.integers(-600, 600, 400)),
        "random_5000x20000": _merged(rng.integers(-500, 500, 5000),
                                     rng.integers(-600, 600, 20000)),
        "build_only": _merged(np.arange(10), []),
        "probe_only": _merged([], np.arange(10)),
        "carry_across_blocks": (np.zeros(3 * t + 17, np.int32), carry),
        "run_without_build": (
            np.concatenate([[5], np.full(2 * t - 1, 7)]).astype(np.int32),
            no_build,
        ),
        "int32_max_probes": _merged([1], [I32_MAX, I32_MAX]),
        "int32_max_both": _merged([1, I32_MAX], [I32_MAX, I32_MAX]),
        "int32_min_keys": _merged([I32_MIN, 3], [I32_MIN, I32_MIN, 3, 4]),
        "block_edges": _merged(np.arange(0, 3 * t, 7),
                               np.repeat(np.arange(0, 3 * t, 3), 2)),
        "full_domain": _merged(a, b),
    }


@pytest.mark.parametrize("tag_dtype", [torch.bool, torch.uint8])
@pytest.mark.parametrize("case", sorted(_merge_count_cases()))
def test_merge_count_kernel_matches_plain(cuda, case, tag_dtype):
    keys, is_build = _merge_count_cases()[case]
    k = torch.tensor(keys, device=cuda)
    tags = torch.tensor(is_build, device=cuda).to(tag_dtype)
    before = mc.LAUNCHES
    got = mc.merge_count_sorted(k, tags)
    want = mc.merge_count_sorted_plain(k, tags)
    torch.cuda.synchronize()
    assert got.device == k.device and got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == int(want)
    assert mc.LAUNCHES == before + (1 if k.numel() else 0)


def test_sort_merge_counts_on_card_match_cpu(cuda):
    rng = np.random.default_rng(41)
    a = rng.integers(-3000, 3000, 9000).astype(np.int32)
    b = rng.integers(-4000, 4000, 40000).astype(np.int32)
    a[:3] = I32_MIN
    b[:5] = I32_MIN
    av = rng.random(a.size) < 0.8
    bv = rng.random(b.size) < 0.7
    for fn in (sort_merge.sort_merge_count, sort_merge.anti_count,
               sort_merge.sort_merge_count_all):
        for args in ((a, b), (a, b, av, bv), (a.astype(np.int64), b)):
            cpu = fn(*map(torch.from_numpy, args))
            gpu = fn(*(torch.from_numpy(x).to(cuda) for x in args))
            assert gpu.device.type == "cuda"
            assert int(gpu) == int(cpu), (fn.__name__, len(args))


@pytest.mark.parametrize("key_dtype", [np.int32, np.int64])
def test_joiners_on_card(cuda, key_dtype):
    rng = np.random.default_rng(43)
    ak = rng.integers(0, 30000, 20000).astype(key_dtype)
    bk = rng.integers(-1000, 31000, 90000).astype(key_dtype)
    if key_dtype == np.int64:
        ak = ak << 33
        bk = bk << 33
    want = int(np.isin(bk, ak).sum())
    a = table_from_numpy(ak, np.arange(ak.size), cuda)
    b = table_from_numpy(bk, np.arange(bk.size), cuda)
    before = (mp.LAUNCHES, mp.LAUNCHES_I64)
    joiners = (
        NoPartitioningHashJoiner(),
        RadixHashJoiner(RadixClusteringConfiguration(number_of_partitions=8)),
        PlannedJoiner(),
    )
    for joiner in joiners:
        assert joiner.run(a, b) == want, type(joiner).__name__
    grew = (mp.LAUNCHES - before[0], mp.LAUNCHES_I64 - before[1])
    # each of the three probes through the kernel (the build has gaps, so
    # the planner takes its kernel plan)
    assert grew == ((3, 0) if key_dtype == np.int32 else (0, 3))
