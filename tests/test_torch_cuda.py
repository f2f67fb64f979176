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
from partitionedhashjoin_tpu_torch.data.table import make_table, table_from_numpy
from partitionedhashjoin_tpu_torch.ops import aggregate, hashing, merge_join, sort_merge
from partitionedhashjoin_tpu_torch.ops.kernels import bitonic_sort as bs
from partitionedhashjoin_tpu_torch.ops.kernels import compact as kc
from partitionedhashjoin_tpu_torch.ops.kernels import generate as gen
from partitionedhashjoin_tpu_torch.ops.kernels import merge_count as mc
from partitionedhashjoin_tpu_torch.ops.kernels import merge_payload as mpay
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
        **_merge_cases(t, mp.CHUNK_ROWS),
    }


def _merge_cases(t, c):
    """Inputs that reach the branches of K1's merge in shared memory (t
    probe rows per tile, c build rows per chunk), as chip_smoke.py builds
    them."""
    rng = np.random.default_rng(5)
    dense = np.arange(1, 2_000_001)
    return {
        "sparse_probe_many_chunks": (dense, dense[::50]),
        "dup_run_across_chunk_edge": (
            np.concatenate([np.arange(c - 3), np.full(9, c),
                            np.arange(c + 1, 3 * c)]),
            np.concatenate([np.arange(0, 3 * c, 3), np.full(50, c)])),
        "empty_range_amid_full": (
            np.concatenate([np.arange(10_000), np.arange(30_000, 40_000)]),
            np.concatenate([np.arange(t), np.arange(10_001, 10_001 + t),
                            np.arange(30_000, 30_000 + t)])),
        "one_key_tiles": (
            np.concatenate([np.arange(100), np.full(3 * c, 500),
                            np.arange(501, 1000)]),
            np.concatenate([np.arange(100), np.full(2 * t + 7, 500),
                            np.full(t, 777), np.full(t, 5000)])),
        "int32_max_at_chunk_edge": (
            np.concatenate([np.arange(c), np.full(20, I32_MAX)]),
            np.concatenate([np.arange(0, c, 2), np.full(5000, I32_MAX)])),
        "n_a_1": ([5], np.concatenate([np.full(3, 4), np.full(t + 10, 5),
                                       np.full(7, 6)])),
        "ragged_last_tile": (rng.integers(0, 50_000, 20_000),
                             rng.integers(0, 60_000, 3 * t + 1)),
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


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_kernel_on_unaligned_probe_view(cuda, dtype):
    """A probe run that starts off a 16-byte boundary is copied key by key
    and counted exactly."""
    rng = np.random.default_rng(41)
    a = torch.sort(torch.tensor(rng.integers(-5000, 5000, 3000),
                                dtype=dtype, device=cuda)).values
    b = torch.sort(torch.tensor(rng.integers(-6000, 6000, 5 * mp.TILE_ROWS + 9),
                                dtype=dtype, device=cuda)).values
    for start in (1, 2, 3):
        if start * b.element_size() % 16 == 0:
            continue
        view = b[start:]
        assert view.data_ptr() % 16 != 0
        if dtype == torch.int32:
            got = mp.ranged_merge_count_prepared(a, view, True)
            want = mp.ranged_merge_count_plain(a, view, True)
        else:
            got = mp.ranged_merge_count_i64(a, view)
            want = mp.ranged_merge_count_i64_plain(a, view)
        assert int(got) == int(want)


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
        **_i64_merge_cases(mp.CHUNK_ROWS_I64),
    }


def _i64_merge_cases(c):
    """K3's merge cases (c build rows per chunk), as chip_smoke.py builds
    them."""
    a = (np.arange(3 * c, dtype=np.int64) << 33) + 12_345
    edge = a[c - 8 : c + 8]
    dense = np.arange(1, 1_000_001, dtype=np.int64) + 2**40
    return {
        "above_bit31_at_chunk_edge": (
            a, np.concatenate([a[::4], a[::4] + 2**32, edge, edge + 2**32,
                               edge - 2**32])),
        "dup_run_across_chunk_edge": (
            np.concatenate([np.arange(c - 3), np.full(9, c),
                            np.arange(c + 1, 3 * c)]) << 33,
            np.concatenate([np.arange(0, 3 * c, 3), np.full(50, c)]) << 33),
        "sparse_probe_many_chunks": (dense, dense[::50]),
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
        "n_1": _merged([], [7]),
        "tile_minus_1": _merged(rng.integers(-300, 300, 1000),
                                rng.integers(-300, 300, t - 1001)),
        "tile_plus_1": _merged(rng.integers(-300, 300, 1000),
                               rng.integers(-300, 300, t - 999)),
        "unsorted": _unsorted(rng, 1_000_003),
        "carry_1001_tiles": _carry_tiles(rng, 1001 * t + 17),
    }


def _unsorted(rng, n):
    """Rows in no order (the count is defined for any): keys on a random
    walk that falls back often, random tags."""
    keys = np.cumsum(rng.integers(-3, 5, n)).astype(np.int32)
    return keys, rng.random(n) < 0.3


def _carry_tiles(rng, n):
    """The largest build key is the first row; smaller build keys follow in
    every tile, and the last rows probe the first key."""
    keys = rng.integers(-50, 50, n).astype(np.int32)
    is_build = rng.random(n) < 0.01
    keys[0], is_build[0] = 60, True
    keys[-5:], is_build[-5:] = 60, False
    return keys, is_build


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


@pytest.mark.parametrize("key_off,tag_off", [(1, 1), (3, 3), (1, 5), (0, 3), (2, 0)])
def test_merge_count_kernel_on_unaligned_views(cuda, key_off, tag_off):
    """Views off a 16-byte boundary: the kernel's tiles start before keys[0]
    and tags with another offset than the keys are read byte by byte."""
    keys, is_build = _unsorted(np.random.default_rng(43), 200_003)
    n = keys.size
    k_buf = torch.zeros(n + 8, dtype=torch.int32, device=cuda)
    t_buf = torch.zeros(n + 16, dtype=torch.bool, device=cuda)
    k_buf[key_off:key_off + n] = torch.from_numpy(keys)
    t_buf[tag_off:tag_off + n] = torch.from_numpy(is_build)
    k, t = k_buf[key_off:key_off + n], t_buf[tag_off:tag_off + n]
    got = mc.merge_count_sorted(k, t)
    want = mc.merge_count_sorted_plain(k, t)
    assert int(got) == int(want) == int(mc.merge_count_sorted_plain(
        torch.from_numpy(keys), torch.from_numpy(is_build)))


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


# ---------------------------------------------------------------- K4


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("case", sorted(_cases()))
def test_payload_kernel_matches_plain(cuda, case, exclude):
    """K4 on K1's cases (duplicate runs across tiles, INT32_MIN/MAX, empty
    sides, ragged n_b), with build payloads that differ per row."""
    a, b = (
        torch.sort(torch.tensor(np.asarray(x, np.int32), device=cuda)).values
        for x in _cases()[case]
    )
    a_pay = (torch.arange(a.numel(), device=cuda, dtype=torch.int32) * 3 + 1)
    before = mpay.LAUNCHES
    pay, pos = mpay.ranged_merge_payload_prepared(a, a_pay, b, exclude)
    want_pay, want_pos = mpay.ranged_merge_payload_plain(a, a_pay, b, exclude)
    torch.cuda.synchronize()
    assert pay.device == a.device and pay.dtype == pos.dtype == torch.int32
    assert torch.equal(pos, want_pos) and torch.equal(pay, want_pay)
    assert mpay.LAUNCHES == before + (1 if a.numel() and b.numel() else 0)


def test_payload_wrapper_rejects_bad_inputs(cuda):
    a = torch.arange(10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # mixed devices
        mpay.ranged_merge_payload_prepared(a, a.cpu(), a)
    with pytest.raises(TypeError):  # dtype
        mpay.ranged_merge_payload_prepared(a.long(), a, a)
    with pytest.raises(TypeError):  # rank
        mpay.ranged_merge_payload_prepared(a.view(2, 5), a, a)
    with pytest.raises(ValueError):  # contiguity
        mpay.ranged_merge_payload_prepared(a, a, torch.arange(20, dtype=torch.int32, device=cuda)[::2])
    with pytest.raises(ValueError):  # payloads do not match the build
        mpay.ranged_merge_payload_prepared(a, a[:5], a)


def test_two_run_materialize_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(47)
    a = rng.permutation(np.arange(0, 40000, 2)).astype(np.int32)
    b = rng.integers(0, 40000, 300000).astype(np.int32)
    a_pay = rng.integers(0, 1000, a.size).astype(np.int32)
    b_pay = rng.integers(0, 1000, b.size).astype(np.int32)
    for payload_sorted in (False, True):
        cpu = merge_join.two_run_materialize(
            *map(torch.from_numpy, (a, a_pay, b, b_pay)),
            probe_payload_sorted=payload_sorted)
        before, before_k5 = mpay.LAUNCHES, kc.LAUNCHES
        gpu = merge_join.two_run_materialize(
            *(torch.from_numpy(x).to(cuda) for x in (a, a_pay, b, b_pay)),
            probe_payload_sorted=payload_sorted)
        assert mpay.LAUNCHES == before + 1
        assert kc.LAUNCHES == before_k5 + 1  # half the probe rows miss
        for g, c in zip(gpu, cpu):
            assert g.device.type == "cuda" and torch.equal(g.cpu(), c)


# ---------------------------------------------------------------- K5


@pytest.mark.parametrize("n_cols", [0, 1, 6])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.5, 1.0])
def test_compact_kernel_matches_plain(cuda, density, n_cols):
    n = 5 * kc.BLK
    gen = torch.Generator(device=cuda)
    gen.manual_seed(int(density * 100) + n_cols)
    keep = torch.rand(n, generator=gen, device=cuda) < density
    cols = [torch.randint(-(2**31), 2**31 - 1, (n,), generator=gen,
                          device=cuda, dtype=torch.int32) for _ in range(n_cols)]
    before = kc.LAUNCHES
    total, pos, *outs = kc.block_compact(keep, *cols)
    want_total, want_pos, *want_outs = kc.compact_plain(keep, cols, n + kc.BLK)
    torch.cuda.synchronize()
    c = int(want_total)
    assert int(total) == c and pos.shape == (n + kc.BLK,)
    assert torch.equal(pos[:c], want_pos[:c])
    for o, w in zip(outs, want_outs):
        assert torch.equal(o[:c], w[:c])
    for capacity in (None, 1000):
        got = kc.compact_columns(keep, *cols, capacity=capacity)
        count, ok, *rest = got
        cap_bound = rest[0].shape[0]
        want = kc.compact_plain(keep, cols, cap_bound)
        assert int(count) == c and bool(ok) == (c <= cap_bound)
        for o, w in zip(rest, want[1:]):
            assert torch.equal(o, w)  # the zero tail too
    assert kc.LAUNCHES == before + 3


@pytest.mark.parametrize("zero_tail", [True, False])
@pytest.mark.parametrize("n,out_len", [
    (3 * kc.TILE_ROWS + 77, 3 * kc.TILE_ROWS + 77), (3 * kc.TILE_ROWS + 77, 999),
    (5000, 9000), (0, 3),
])
def test_compact_rows_any_length_on_card(cuda, n, out_len, zero_tail):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n + out_len)
    keep = torch.rand(n, generator=gen, device=cuda) < 0.4
    cols = [torch.randint(-(2**31), 2**31 - 1, (n,), generator=gen,
                          device=cuda, dtype=torch.int32) for _ in range(3)]
    before = kc.LAUNCHES
    got = kc.compact_rows(keep, cols, out_len, zero_tail=zero_tail)
    want = kc.compact_plain(keep, cols, out_len)
    assert kc.LAUNCHES == before + (1 if n else 0)
    live = min(int(want[0]), out_len)
    assert int(got[0]) == int(want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == (out_len,)
        assert torch.equal(g if zero_tail else g[:live], w if zero_tail else w[:live])


def test_compact_kernel_tile_edges_and_int32_extremes(cuda):
    n = 2 * kc.BLK
    keep = torch.zeros(n, dtype=torch.bool, device=cuda)
    t = kc.TILE_ROWS
    rows = [0, 31, 32, 255, 256, t - 1, t, t + 1, 2 * t - 1, n - 1]
    keep[rows] = True
    col = torch.arange(n, dtype=torch.int32, device=cuda)
    col[::2] = -(2**31)
    col[1::4] = 2**31 - 1
    count, ok, pos, out = kc.compact_columns(keep, col)
    assert int(count) == len(rows) and bool(ok)
    assert pos[: len(rows)].tolist() == rows
    assert torch.equal(out[: len(rows)], col[rows])
    assert not out[len(rows):].any() and not pos[len(rows):].any()


def _one_pass_cases(cuda):
    """(name, keep, out_len) for the one-pass K5: densities 0, 1 and 1/2,
    one kept row per tile, a ragged n, a capacity cut, and tile edges seen
    through keep views at each of the four byte alignments (the 16-byte
    loads give way to byte loads)."""
    t = kc.TILE_ROWS
    n = 7 * t + 123
    gen_ = torch.Generator(device=cuda)
    gen_.manual_seed(71)
    half = torch.rand(n, generator=gen_, device=cuda) < 0.5
    one = torch.zeros(n, dtype=torch.bool, device=cuda)
    one[[i * t + i * 97 % 100 for i in range(8)]] = True
    cases = [
        ("density_0", torch.zeros(n, dtype=torch.bool, device=cuda), n),
        ("density_1", torch.ones(n, dtype=torch.bool, device=cuda), n),
        ("density_half", half, n),
        ("one_per_tile", one, n),
        ("ragged", half[: 3 * t + 5], 3 * t + 5),
        ("capacity_cut", half, 1000),
    ]
    edges = torch.zeros(n + 3, dtype=torch.bool, device=cuda)
    for e in (t - 1, t, 2 * t - 1, 2 * t, 3 * t + 15, 3 * t + 16):
        edges[e: e + 4] = True
    for off in range(4):
        cases.append((f"edges_align_{off}", edges[off: off + n], n))
    return cases


@pytest.mark.parametrize("n_cols", [0, 2, 6])
def test_compact_one_pass_matches_plain(cuda, n_cols):
    """The one-pass K5 equals compact_plain bit for bit (count, pos and
    every column up to the capacity), with one launch per call."""
    for name, keep, out_len in _one_pass_cases(cuda):
        n = keep.shape[0]
        cols = [torch.arange(n, dtype=torch.int32, device=cuda) * (c + 3) - c
                for c in range(n_cols)]
        before = kc.LAUNCHES
        got = kc.compact_rows(keep, cols, out_len)
        want = kc.compact_plain(keep, cols, out_len)
        torch.cuda.synchronize()
        assert kc.LAUNCHES == before + 1, name
        assert int(got[0]) == int(want[0]), name
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g, w), name
    empty = torch.zeros(0, dtype=torch.bool, device=cuda)
    before = kc.LAUNCHES
    count, pos, *outs = kc.compact_rows(
        empty, [torch.zeros(0, dtype=torch.int32, device=cuda)] * n_cols, 4)
    assert kc.LAUNCHES == before and int(count) == 0
    assert not pos.any() and len(outs) == n_cols


def test_compact_wrapper_rejects_bad_inputs(cuda):
    keep = torch.ones(kc.BLK, dtype=torch.bool, device=cuda)
    col = torch.zeros(kc.BLK, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # mixed devices
        kc.block_compact(keep, col.cpu())
    with pytest.raises(TypeError):  # dtype
        kc.block_compact(keep, col.long())
    with pytest.raises(TypeError):  # rank
        kc.block_compact(keep.view(2, -1), col.view(2, -1))
    with pytest.raises(ValueError):  # contiguity
        kc.block_compact(keep, torch.zeros(2 * kc.BLK, dtype=torch.int32, device=cuda)[::2])
    with pytest.raises(ValueError):  # too many columns
        kc.block_compact(keep, *([col] * (kc.MAX_COLS + 1)))


def test_aggregates_on_card_match_cpu(cuda):
    rng = np.random.default_rng(53)
    keys = rng.integers(0, 5000, 200000).astype(np.int32)
    pay = rng.integers(-(2**31), 2**31, 200000, dtype=np.int64).astype(np.int32)
    cpu_t = make_table(torch.from_numpy(keys), torch.from_numpy(pay))
    gpu_t = make_table(cpu_t.keys.to(cuda), cpu_t.payloads.to(cuda))

    def even(k, p):
        return (p & 1) == 0

    calls = (
        lambda t: aggregate.sort_aggregate(t, group_capacity=4000,
                                           with_distinct=True),
        lambda t: aggregate.filter_sort_aggregate(t, even, group_capacity=6000)[0],
        lambda t: aggregate.filter_sort_aggregate_staged(t, even)[0],
    )
    for call in calls:
        before = kc.LAUNCHES
        got, want = call(gpu_t), call(cpu_t)
        assert kc.LAUNCHES > before  # "auto" takes K5 on the card
        assert int(got.num_groups) == int(want.num_groups)
        for f in ("keys", "count", "sum", "min", "max", "distinct"):
            g, w = getattr(got, f), getattr(want, f)
            assert (g is None) == (w is None)
            if g is not None:
                assert torch.equal(g.cpu(), w), f


# ---------------------------------------------------------------- K6


def _tuple_columns(cuda, k, n, seed):
    """k int32 operands: narrow leading ones (ties carry to the last),
    all-MAX rows beside the padding, a full-domain last operand."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(-3, 3, n).astype(np.int32) for _ in range(k - 1)]
    cols.append(rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64).astype(np.int32))
    for c in cols:
        c[::31] = I32_MAX
    return [torch.from_numpy(c).to(cuda) for c in cols]


def _equal_lists(got, want):
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == torch.int32
        assert torch.equal(g, w)


def _launches():
    return (bs.LAUNCHES_UPSWEEP, bs.LAUNCHES_SORT, bs.LAUNCHES_BLOCKS,
            bs.LAUNCHES_MERGE)


def _sort_checked(cols):
    """The radix sort against its plain version; it launches one upsweep
    and one sweep per digit of its plan, and never K6a or K6b."""
    before = _launches()
    _equal_lists(bs.sort_i32_tuple(*cols), bs.sort_i32_tuple_plain(*cols))
    n = cols[0].shape[0]
    passes = len(bs.radix_plan(bs.radix_histograms_plain(*cols)).passes) if n else 0
    grew = tuple(a - b for a, b in zip(_launches(), before))
    assert grew == ((1 if n else 0), passes, 0, 0)


def _radix_edge_columns(cuda, k, n, seed):
    """The edge cases of chip_smoke's parity loop at a small n: every
    operand constant (every digit skipped), keys in [1, 10M] (the top byte
    skipped), and an operand of only INT32_MIN and INT32_MAX."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 10_000_001, n).astype(np.int32)
    ends = np.where(rng.random(n) < 0.5, I32_MIN, I32_MAX).astype(np.int32)
    narrow = [rng.integers(-2, 2, n).astype(np.int32) for _ in range(k - 1)]
    cases = {
        "constant": [np.full(n, 5 - c, np.int32) for c in range(k)],
        "keys_1_to_10M": narrow + [keys],
        "int32_ends": [ends] + narrow,
    }
    return {name: [torch.from_numpy(c).to(cuda) for c in cols]
            for name, cols in cases.items()}


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_tuple_sort_kernels_match_plain(cuda, k):
    blk = bs.BLK
    for n in (0, 1, 100, blk, blk + 1, 3 * blk - 5, 5 * blk + 17, 300_007):
        _sort_checked(_tuple_columns(cuda, k, n, seed=n + k))
    for n in (1, bs.RADIX_TILE + 3, 70_001):
        for cols in _radix_edge_columns(cuda, k, n, seed=n + 10 * k).values():
            _sort_checked(cols)
    # an unaligned view: the upsweep's 16-byte loads give way to scalar loads
    cols = _tuple_columns(cuda, k, 50_001, seed=99 + k)
    _sort_checked([c[1:] for c in cols])
    # a dominant tuple whose run is longer than a tile and than a run
    n = 40 * blk + 123
    gen_ = torch.Generator(device=cuda)
    gen_.manual_seed(k)
    cols = [torch.where(torch.rand(n, generator=gen_, device=cuda) < 0.9, 7,
                        torch.randint(-5, 5, (n,), generator=gen_, device=cuda)
                        ).to(torch.int32) for _ in range(k)]
    _sort_checked(cols)
    # the phases alone: blocks, pairs, a lone tail run, runs of 3 blocks
    cols = [c[: 7 * blk].contiguous() for c in cols]
    sb = bs.sort_blocks_tuple(*cols)
    _equal_lists(sb, bs.sort_blocks_plain(*cols))
    for run in (blk, 2 * blk, 3 * blk, 8 * blk):
        src = [c.contiguous() for c in bs._segment_sort_plain(cols, run)]
        _equal_lists(bs.merge_pass_tuple(*src, run_len=run),
                     bs.merge_pass_plain(*src, run_len=run))


def test_tuple_sort_rejects_bad_inputs_on_card(cuda):
    x = torch.arange(bs.BLK, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # wider than the kernels' tuple
        bs.sort_i32_tuple(*([x] * (bs.MAX_OPERANDS + 1)))
    with pytest.raises(ValueError):  # mixed devices
        bs.sort_i32_tuple(x, x.cpu())
    with pytest.raises(ValueError):
        bs.merge_pass_i32(x, bs.BLK // 2)
    with pytest.raises(ValueError):
        bs.sort_blocks_i32(x[:-1])


def test_sorter_switch_launches_k6_on_card(cuda):
    """Under "pallas" every call site launches K6 on the card and gives
    the library sort's results; "auto" resolves to K6 on the card."""
    rng = np.random.default_rng(61)
    a = rng.integers(0, 20000, 15000).astype(np.int32)
    b = rng.integers(-100, 21000, 90000).astype(np.int32)
    a_pay = (a ^ 0x5A17).astype(np.int32)
    b_pay = rng.integers(0, 1 << 20, b.size).astype(np.int32)
    ta, tb, tap, tbp = (torch.from_numpy(x).to(cuda) for x in (a, b, a_pay, b_pay))
    a64, b64 = ta.to(torch.int64) << 33, tb.to(torch.int64) << 33
    table = make_table(tb, tbp)
    ak, ap = np.unique(a, return_index=True)  # unique build keys: one answer

    def run_all():
        return [
            int(merge_join.two_run_count(ta, tb)),
            int(merge_join.PreparedBuild(ta).count(tb)),
            int(merge_join.two_run_count_i64(a64, b64)),
            RadixHashJoiner().run(make_table(ta, tap), table),
            [t.cpu() for t in merge_join.two_run_materialize(
                torch.from_numpy(ak).to(cuda), torch.from_numpy(a_pay[ap]).to(cuda),
                tb, tbp, probe_payload_sorted=True)],
            aggregate.sort_aggregate(table, with_distinct=True),
        ]

    want = run_all()
    for impl in ("pallas", "auto"):
        merge_join.set_sort_impl(impl)
        try:
            before = _launches()
            got = run_all()
        finally:
            merge_join.set_sort_impl("xla")
        grew = tuple(a - b for a, b in zip(_launches(), before))
        # two sorts each for the counts, radix and materialize, one for the
        # prepared build's probe plus its build, one GROUP BY pass 1: each
        # the radix sort (an upsweep, then sweeps), never K6a or K6b
        assert grew[0] == 2 + 2 + 2 + 2 + 2 + 1
        assert grew[1] >= grew[0] and grew[2:] == (0, 0)
        assert got[:4] == want[:4] == [int(np.isin(b, a).sum())] * 4
        for g, w in zip(got[4], want[4]):
            assert torch.equal(g, w)
        for f in ("keys", "count", "sum", "min", "max", "distinct", "num_groups"):
            assert torch.equal(getattr(got[5], f), getattr(want[5], f)), f


# ---------------------------------------------------------------- K7, K8


@pytest.mark.parametrize("seed", [0, 42, 2**32 - 1])
def test_hash_kernel_matches_plain(cuda, seed):
    rng = np.random.default_rng(67)
    keys = torch.from_numpy(rng.integers(I32_MIN, I32_MAX, 1_000_003,
                                         dtype=np.int64).astype(np.int32)).to(cuda)
    keys[:4] = torch.tensor([I32_MIN, -1, 0, I32_MAX], dtype=torch.int32)
    for view in (keys, keys[1:], keys[:3], keys[:0]):  # aligned, unaligned, tiny
        before = gen.LAUNCHES_HASH
        got = gen.hash_keys(view, seed)
        want = hashing.hash32(view, seed)
        torch.cuda.synchronize()
        assert got.dtype == torch.uint32 and got.device.type == "cuda"
        assert torch.equal(got.cpu().to(torch.int64), want.cpu().to(torch.int64))
        assert gen.LAUNCHES_HASH == before + (1 if view.numel() else 0)


@pytest.mark.parametrize("card", [500, 10_000_000, 100_000_000])
def test_zipf_kernel_matches_plain(cuda, card):
    """Uniforms bit for bit; keys may differ only where powf and torch.pow
    round differently next to a floor: at most 1e-4 of them, by at most 2."""
    n = 2_000_000
    for r in (0, 5):
        got = gen.philox_uniforms(11, n, r, device=cuda)
        want = gen.philox_uniforms_plain(11, torch.arange(n, device=cuda), r)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    before = gen.LAUNCHES_ZIPF
    keys = gen.zipf_keys_pallas(11, n, 1.05, card, device=cuda)
    plain = gen.zipf_keys_plain(11, n, 1.05, card, device=cuda)
    torch.cuda.synchronize()
    assert gen.LAUNCHES_ZIPF == before + 1
    assert keys.dtype == torch.int32 and keys.device.type == "cuda"
    assert int(keys.min()) >= 1 and int(keys.max()) <= card
    differ = keys != plain
    assert int(differ.sum()) <= n * 1e-4
    assert int((keys - plain).abs().max()) <= 2
    assert (gen.zipf_keys_pallas(11, 1000, 1.05, card, rounds=0, device=cuda) == 1).all()


@pytest.mark.parametrize("m", [1, 33, 2_047, 1_000_003])
def test_zipf_kernel_prefix_property(cuda, m):
    """The first m of n keys equal the m keys drawn alone, exactly: a slot's
    key depends on the seed and the slot only, not on the warp or the step
    that drew it (the ranges per warp differ between the two calls)."""
    whole = gen.zipf_keys_pallas(13, 4_000_000, 1.05, 10_000_000, device=cuda)
    part = gen.zipf_keys_pallas(13, m, 1.05, 10_000_000, device=cuda)
    torch.cuda.synchronize()
    assert torch.equal(part, whole[:m])


@pytest.mark.parametrize("rounds", [0, 1])
def test_zipf_kernel_few_rounds(cuda, rounds):
    """0 rounds: every key 1; 1 round: a rejected slot gets key 1; both as
    the plain version (keys within the same rounding gate)."""
    n = 1_000_000
    keys = gen.zipf_keys_pallas(17, n, 1.05, 10_000_000, rounds, device=cuda)
    plain = gen.zipf_keys_plain(17, n, 1.05, 10_000_000, rounds, device=cuda)
    torch.cuda.synchronize()
    if rounds == 0:
        assert (keys == 1).all() and (plain == 1).all()
    else:
        # ~3.5% rejected (key 1) beside the ~7% whose sample is 1
        assert 0.05 < float((keys == 1).float().mean()) < 0.2
    assert int((keys != plain).sum()) <= n * 1e-4
    assert int((keys - plain).abs().max()) <= 2
