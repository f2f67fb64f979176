"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
This file does not import jax, so on a machine with a card and without jax
it runs with tests/conftest.py (which imports jax) switched off:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""


import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu_torch.config import (
    NoPartitioningConfiguration,
    RadixClusteringConfiguration,
)
from partitionedhashjoin_tpu_torch.data.table import make_table, table_from_numpy
from partitionedhashjoin_tpu_torch.ops import (
    aggregate,
    generators,
    hashing,
    merge_join,
    sort_merge,
)
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
    """The card (K6) against the CPU (K6's plain version): the probe rows
    come out in (key, payload) order on both."""
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


def _block_edge_columns(cuda, k, seed):
    """K6a's edge blocks side by side, one BLK-row block each, every block
    with its own set of varying digits (a digit plan shared across blocks
    would fail): one tuple; only byte 0 of the last operand varies; only
    the top byte varies; INT32_MIN, -1, 0 and INT32_MAX; keys in [1, 10M]; a
    narrow leading operand with full-domain trailing ones; 90% of rows one
    tuple; every row INT32_MAX."""
    blk = bs.BLK
    rng = np.random.default_rng(seed)

    def full():
        return rng.integers(I32_MIN, I32_MAX, blk, dtype=np.int64,
                            endpoint=True).astype(np.int32)

    def const(v):
        return np.full(blk, v, np.int32)

    def top_byte():
        low = np.int64(0x00ABCDEF)
        return ((rng.integers(0, 256, blk) << 24) | low).astype(np.uint32).view(np.int32)

    ends = np.asarray([I32_MIN, -1, 0, I32_MAX], np.int32)
    hot = rng.random(blk) < 0.9
    narrow = [rng.integers(-2, 2, blk).astype(np.int32) for _ in range(k - 1)]
    blocks = [
        [const(5 - c) for c in range(k)],
        [const(-c) for c in range(k - 1)]
        + [(0x12345600 | rng.integers(0, 256, blk)).astype(np.int32)],
        [top_byte() for _ in range(k)],
        [rng.choice(ends, blk) for _ in range(k)],
        narrow + [rng.integers(1, 10_000_001, blk).astype(np.int32)],
        [rng.integers(-3, 3, blk).astype(np.int32)] + [full() for _ in range(k - 1)],
        [np.where(hot, 7, full()).astype(np.int32) for _ in range(k)],
        [const(I32_MAX) for _ in range(k)],
    ]
    return [torch.from_numpy(np.concatenate([b[c] for b in blocks])).to(cuda)
            for c in range(k)]


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
    # K6a's edge blocks in one call, then as views off a 16-byte boundary
    # (its 16-byte loads give way to scalar loads); one launch each
    edges = _block_edge_columns(cuda, k, seed=80 + k)
    before = bs.LAUNCHES_BLOCKS
    _equal_lists(bs.sort_blocks_tuple(*edges), bs.sort_blocks_plain(*edges))
    shifted = [torch.cat([c[:1], c])[1:] for c in edges]
    assert all(c.data_ptr() % 16 for c in shifted)
    _equal_lists(bs.sort_blocks_tuple(*shifted), bs.sort_blocks_plain(*shifted))
    assert bs.LAUNCHES_BLOCKS - before == 2
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


def _i64_columns(cuda, n, seed):
    """int64 keys: Zipf(1.05) over [1, 10M] (3 varying bytes), the full
    domain with INT64_MIN, INT64_MAX and negatives (8), one value (0)."""
    gen_ = torch.Generator(device=cuda)
    gen_.manual_seed(seed)
    zipf = generators.zipf_keys(n, 1.05, 10_000_000, generator=gen_,
                                device=cuda).to(torch.int64)
    full = torch.randint(I64_MIN, I64_MAX, (n,), generator=gen_, device=cuda,
                         dtype=torch.int64)
    full[:4] = torch.tensor([I64_MIN, I64_MAX, -1, 0], device=cuda)[:n]
    return {"zipf_1_to_10M": zipf, "full_domain": full,
            "all_equal": torch.full((n,), -(2**40) + 7, dtype=torch.int64,
                                    device=cuda)}


def _i64_sort_checked(x):
    """sort_i64 bit-identical to torch.sort; one upsweep, a sweep per digit
    of its plan, and the other digits counted as skipped."""
    want = torch.sort(x).values
    n = x.shape[0]
    passes = len(bs.radix_plan(bs.radix_histograms_plain(x)).passes) if n else 0
    before = (_launches(), bs.SWEEPS_SKIPPED)
    got = bs.sort_i64(x)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.int64
    assert torch.equal(got, want)
    grew = tuple(a - b for a, b in zip(_launches(), before[0]))
    assert grew == ((1 if n else 0), passes, 0, 0)
    assert bs.SWEEPS_SKIPPED - before[1] == ((8 - passes) if n else 0)
    return passes


@pytest.mark.parametrize("n", [0, 1, bs.RADIX_TILE_I64 - 1,
                               bs.RADIX_TILE_I64 + 1, (1 << 22) + 13])
def test_sort_i64_kernels_match_library(cuda, n):
    for name, x in _i64_columns(cuda, n, seed=n + 3).items():
        passes = _i64_sort_checked(x)
        if n > 1 << 20:
            assert passes == {"zipf_1_to_10M": 3, "full_domain": 8,
                              "all_equal": 0}[name], name
    if n > 1:  # a view off a 16-byte boundary: the upsweep's scalar loads
        x = _i64_columns(cuda, n + 1, seed=n)["full_domain"]
        view = x[1:]
        assert view.data_ptr() % 16
        _i64_sort_checked(view)


def test_sort_i64_rejects_bad_inputs_on_card(cuda):
    x = torch.arange(100, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        bs.sort_i64(x.to(torch.int32))
    with pytest.raises(ValueError):
        bs.sort_i64(x[::2])


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_key_sort_runs_k6_under_the_default(cuda, dtype, monkeypatch):
    """A card's int32 or int64 keys are sorted by K6 alone: the plan's
    sweeps launch, the rest are counted as skipped, and the library sort is
    never called."""
    gen_ = torch.Generator(device=cuda)
    gen_.manual_seed(11)
    keys = generators.zipf_keys(300_007, 1.05, 10_000_000, generator=gen_,
                                device=cuda).to(dtype)
    want = torch.sort(keys).values
    plan = bs.radix_plan(bs.radix_histograms_plain(keys))
    digits = bs.radix_histograms_plain(keys).shape[0]

    def refused(*args, **kwargs):
        raise AssertionError("the library sort was called")

    monkeypatch.setattr(torch, "sort", refused)
    before = (_launches(), bs.SWEEPS_SKIPPED)
    got = merge_join.key_sort(keys)
    grew = tuple(a - b for a, b in zip(_launches(), before[0]))
    monkeypatch.undo()
    assert torch.equal(got, want)
    assert grew == (1, len(plan.passes), 0, 0)
    assert bs.SWEEPS_SKIPPED - before[1] == digits - len(plan.passes)
    assert len(plan.passes) == 3  # keys in [1, 10M]: bytes 0-2


def test_two_run_count_i64_on_card_matches_cpu(cuda):
    """The int64 count on K6's native key and K3 equals its plain version,
    over keys that differ only above bit 31 and over Zipf keys."""
    rng = np.random.default_rng(71)
    a = (rng.integers(0, 30000, 20000).astype(np.int64) << 33) - 5
    b = (rng.integers(-1000, 31000, 90000).astype(np.int64) << 33) - 5
    a[:2], b[:3] = I64_MIN, [I64_MIN, I64_MAX, I64_MAX]
    z = _i64_columns(cuda, 1_000_003, seed=5)["zipf_1_to_10M"]
    for build, probe in ((a, b), (np.arange(1, 2_000_001, 3, dtype=np.int64),
                                  z.cpu().numpy())):
        want = int(merge_join.two_run_count_i64(torch.from_numpy(build),
                                                torch.from_numpy(probe)))
        assert want == int(np.isin(probe, build).sum())
        before = (bs.LAUNCHES_UPSWEEP, mp.LAUNCHES_I64)
        got = merge_join.two_run_count_i64(torch.from_numpy(build).to(cuda),
                                           torch.from_numpy(probe).to(cuda))
        assert got.device.type == "cuda" and int(got) == want
        assert (bs.LAUNCHES_UPSWEEP - before[0], mp.LAUNCHES_I64 - before[1]) == (2, 1)


def test_every_sort_site_launches_k6_on_card(cuda):
    """Every sort site launches K6 on the card and gives the answers of the
    CPU, where K6's plain version runs, and of ``np.isin``."""
    rng = np.random.default_rng(61)
    a = rng.integers(0, 20000, 15000).astype(np.int32)
    b = rng.integers(-100, 21000, 90000).astype(np.int32)
    a_pay = (a ^ 0x5A17).astype(np.int32)
    b_pay = rng.integers(0, 1 << 20, b.size).astype(np.int32)
    ak, ap = np.unique(a, return_index=True)  # unique build keys: one answer

    def run_all(device):
        ta, tb, tap, tbp = (torch.from_numpy(x).to(device)
                            for x in (a, b, a_pay, b_pay))
        a64, b64 = ta.to(torch.int64) << 33, tb.to(torch.int64) << 33
        table = make_table(tb, tbp)
        return [
            int(merge_join.two_run_count(ta, tb)),
            int(merge_join.PreparedBuild(ta).count(tb)),
            int(merge_join.two_run_count_i64(a64, b64)),
            RadixHashJoiner().run(make_table(ta, tap), table),
            [t.cpu() for t in merge_join.two_run_materialize(
                torch.from_numpy(ak).to(device),
                torch.from_numpy(a_pay[ap]).to(device),
                tb, tbp, probe_payload_sorted=True)],
            aggregate.sort_aggregate(table, with_distinct=True),
        ]

    want = run_all("cpu")
    before = _launches()
    got = run_all(cuda)
    grew = tuple(a - b for a, b in zip(_launches(), before))
    # two sorts each for the counts, radix and materialize, one for the
    # prepared build's probe plus its build, one GROUP BY pass 1: each the
    # radix sort (an upsweep, then sweeps), never K6a or K6b
    assert grew[0] == 2 + 2 + 2 + 2 + 2 + 1
    assert grew[1] >= grew[0] and grew[2:] == (0, 0)
    assert got[:4] == want[:4] == [int(np.isin(b, a).sum())] * 4
    for g, w in zip(got[4], want[4]):
        assert torch.equal(g, w)
    for f in ("keys", "count", "sum", "min", "max", "distinct", "num_groups"):
        assert torch.equal(getattr(got[5], f).cpu(), getattr(want[5], f)), f


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


@pytest.mark.parametrize("seed", [0, 42, 2**32 - 1])
def test_hash64_kernel_matches_plain(cuda, seed):
    """K7 on int64 keys equals ``hash64_pair`` of their words bit for bit,
    aligned or not, at even and odd lengths (its vector holds two keys)."""
    rng = np.random.default_rng(71)
    keys = torch.from_numpy(rng.integers(I64_MIN, I64_MAX, 1_000_003,
                                         dtype=np.int64)).to(cuda)
    keys[:6] = torch.tensor([I64_MIN, -1, 0, I64_MAX, 2**32, -(2**32)])
    for view in (keys, keys[1:], keys[:-1], keys[:3], keys[:1], keys[:0]):
        before, before32 = gen.LAUNCHES_HASH64, gen.LAUNCHES_HASH
        got = gen.hash_keys(view, seed)
        want = hashing.hash64_pair(*hashing.split64(view.cpu()), seed)
        torch.cuda.synchronize()
        assert got.dtype == torch.uint32 and got.device.type == "cuda"
        assert torch.equal(got.cpu().to(torch.int64), want.to(torch.int64))
        assert gen.LAUNCHES_HASH64 == before + (1 if view.numel() else 0)
        assert gen.LAUNCHES_HASH == before32


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


# ------------------------------------------ multi-key, alias sampler, bench


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_multi_key_on_card_matches_cpu(cuda, k):
    """Counts on the card equal the CPU's (the kernels' plain versions);
    k = 2 launches K6 and K3."""
    from partitionedhashjoin_tpu_torch.ops import multi_key

    rng = np.random.default_rng(80 + k)
    a = [rng.integers(-6, 6, 40_000).astype(np.int32) for _ in range(k)]
    b = [rng.integers(-6, 6, 300_000).astype(np.int32) for _ in range(k)]
    for c in a + b:
        c[:4] = [I32_MIN, I32_MAX, I32_MAX, 0]
    cpu_a, cpu_b = [torch.from_numpy(c) for c in a], [torch.from_numpy(c) for c in b]
    dev_a, dev_b = [c.to(cuda) for c in cpu_a], [c.to(cuda) for c in cpu_b]
    want = (int(multi_key.multi_key_count(cpu_a, cpu_b)),
            int(multi_key.multi_key_count_all(cpu_a, cpu_b)))
    before = (mp.LAUNCHES_I64, bs.LAUNCHES_SORT)
    got = multi_key.multi_key_count(dev_a, dev_b)
    grew = (mp.LAUNCHES_I64 - before[0], bs.LAUNCHES_SORT - before[1])
    got_all = multi_key.multi_key_count_all(dev_a, dev_b)
    assert got.device.type == got_all.device.type == "cuda"
    assert (int(got), int(got_all)) == want
    if k == 2:
        assert grew[0] == 1 and grew[1] > 0


def test_alias_sampler_on_card(cuda):
    """200K draws over [1, 1000] at alpha 1.05 within the CPU tests' TV bound
    of the pmf; an integer bin at card = 3 * 2^22 (a float32 one would put
    half the mass on bins = 0 mod 3)."""
    from partitionedhashjoin_tpu_torch.data import host_loader
    from partitionedhashjoin_tpu_torch.ops import generators

    card, n = 1000, 200_000
    prob, alias = host_loader.build_zipf_alias(1.05, card)
    g = torch.Generator(device=cuda).manual_seed(0)
    keys = generators.zipf_keys_alias(n, torch.from_numpy(prob).to(cuda),
                                      torch.from_numpy(alias).to(cuda), g, cuda)
    assert keys.device.type == "cuda" and keys.dtype == torch.int32
    freq = np.bincount(keys.cpu().numpy(), minlength=card + 1)[1:] / n
    pmf = np.arange(1, card + 1, dtype=np.float64) ** -1.05
    assert 0.5 * np.abs(freq - pmf / pmf.sum()).sum() < 0.035
    card = 3 << 22
    keys = generators.zipf_keys_alias(
        60_000, torch.ones(card, device=cuda),
        torch.arange(card, dtype=torch.int32, device=cuda), g, cuda)
    share = np.bincount((keys.cpu().numpy() - 1) % 3, minlength=3) / 60_000
    np.testing.assert_allclose(share, 1 / 3, atol=0.02)
    table = generators.zipf_table(n, 1.05, (1, 1000), seed=3, method="alias",
                                  device=cuda)
    assert table.keys.device.type == "cuda"
    assert int(table.keys.min()) >= 1 and int(table.keys.max()) <= 1000


def test_bench_on_card(cuda, monkeypatch, capsys):
    """The bench at 100K ⋈ 2M on the card: one JSON line naming the card,
    and K1 launched in each measured run."""
    import json

    from partitionedhashjoin_tpu_torch import bench

    monkeypatch.setenv("PHJ_BENCH_PRIMARY", "100000")
    monkeypatch.setenv("PHJ_BENCH_SECONDARY", "2000000")
    monkeypatch.delenv("PHJ_BENCH_ALGOS", raising=False)
    assert bench.main(["--platform", "cuda"]) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    doc = json.loads(lines[0])
    assert doc["device"] == torch.cuda.get_device_name(0)
    assert doc["metric"].endswith("_100000x2000000_skew1.05") and doc["value"] > 0
    for algo in ("sort-merge", "radix"):
        line = next(x for x in err.splitlines() if x.startswith(f"launches {algo}: "))
        launched = json.loads(line.split(": ", 1)[1])
        assert launched.get("merge_probe.LAUNCHES", 0) >= 1, line


def test_trace_records_the_card(cuda, tmp_path):
    """``utils.profiling.trace`` writes a Chrome trace holding the card's
    kernels beside the CPU's operators."""
    import json

    from partitionedhashjoin_tpu_torch.utils import profiling

    x = torch.arange(1 << 20, device=cuda)
    with profiling.trace(str(tmp_path)):
        (x * 3).sum().item()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    cats = {e.get("cat") for e in events}
    assert "kernel" in cats and "cpu_op" in cats, cats


# --------------------------------------------------------------- query / SQL

_SQL_PIPELINE = (
    "SELECT key, COUNT(*), SUM(b.payload), MIN(b.payload), MAX(b.payload), "
    "AVG(b.payload) FROM b JOIN a USING (key) {where}GROUP BY key "
    "ORDER BY count DESC LIMIT 10")
_SQL_STATEMENTS = (
    _SQL_PIPELINE.format(where=""),
    _SQL_PIPELINE.format(where="WHERE b.payload % 2 = 0 "),
    "SELECT COUNT(*) FROM b JOIN a USING (key) WHERE b.payload > 0",
    "SELECT COUNT(*) FROM b ANTI JOIN a USING (key) WHERE a.key % 2 = 0",
    "SELECT key, SUM(a.payload) FROM b LEFT JOIN a USING (key) WHERE a.key > 50 "
    "GROUP BY key HAVING count > 3 ORDER BY sum DESC LIMIT 20",
    "SELECT key, payload FROM b WHERE payload // 0 = -2 AND key % 0 = 0 "
    "ORDER BY payload DESC LIMIT 15",
    "SELECT COUNT(*), SUM(payload), MIN(payload), MAX(payload), "
    "COUNT(DISTINCT payload) FROM b WHERE key BETWEEN 10 AND 900",
    "SELECT DISTINCT key FROM b SEMI JOIN a USING (key) ORDER BY key LIMIT 40",
)


def _sql_tables(device):
    from partitionedhashjoin_tpu_torch.ops import generators

    gen = torch.Generator().manual_seed(12)
    a_keys = torch.randperm(30_000, generator=gen)[:20_000].to(torch.int32) + 1
    b = generators.zipf_table(300_000, 1.05, (1, 30_000), seed=5, device="cpu")
    b_pay = torch.randint(-(1 << 20), 1 << 20, (300_000,), generator=gen,
                          dtype=torch.int32)
    return {"a": make_table(a_keys.to(device), (a_keys ^ 0x5A17).to(device)),
            "b": make_table(b.keys.to(device), b_pay.to(device))}


@pytest.mark.parametrize("sql", _SQL_STATEMENTS)
def test_sql_on_card_matches_cpu(cuda, sql):
    """Each statement on the card (K1, K4, K5, K6) equals the port's CPU run
    (the kernels' plain versions), column for column."""
    from partitionedhashjoin_tpu_torch.sql import execute_sql

    want = execute_sql(sql, _sql_tables("cpu"))
    got = execute_sql(sql, _sql_tables(cuda))
    assert got.row_count == want.row_count and list(got.columns) == list(want.columns)
    for name, w in want.columns.items():
        assert got.columns[name].dtype == w.dtype
        if name == "avg":
            np.testing.assert_allclose(got.columns[name], w, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got.columns[name], w, err_msg=name)


def test_sql_paths_launch_their_kernels(cuda):
    from partitionedhashjoin_tpu_torch.sql import execute_sql

    db = _sql_tables(cuda)
    for sql, counter in ((_SQL_STATEMENTS[2], (mp, "LAUNCHES")),
                         (_SQL_STATEMENTS[0], (mpay, "LAUNCHES")),
                         (_SQL_STATEMENTS[1], (kc, "LAUNCHES"))):
        module, name = counter
        before = getattr(module, name)
        execute_sql(sql, db)
        assert getattr(module, name) > before, sql


def test_division_by_zero_on_card_equals_cpu(cuda):
    from partitionedhashjoin_tpu_torch.sql import _compile_expr, parse_sql

    gen = torch.Generator().manual_seed(2)
    k = torch.randint(-5, 5, (1 << 20,), generator=gen, dtype=torch.int32)
    p = torch.randint(-3, 3, (1 << 20,), generator=gen, dtype=torch.int32)
    k[:4] = torch.tensor([I32_MIN, I32_MIN, 0, I32_MAX], dtype=torch.int32)
    p[:4] = torch.tensor([-1, 0, 0, -1], dtype=torch.int32)
    for text in ("key // payload", "key % payload", "key / 0", "key % 0",
                 "(key * payload) // (payload - payload)"):
        fn = _compile_expr(parse_sql(f"SELECT key FROM b WHERE {text} = 0").where.left)
        assert torch.equal(fn(k.to(cuda), p.to(cuda)).cpu(), fn(k, p)), text


def test_sql_shell_on_card(cuda, capsys):
    from partitionedhashjoin_tpu_torch import sql

    argv = ["--table", "a=sequential:100000", "--table", "b=zipf:2000000:1.05:1:100000",
            "SELECT COUNT(*) FROM b JOIN a USING (key)"]
    assert sql.main(argv) == 0
    assert capsys.readouterr().out == "count\n2000000\n(1 rows)\n"


# ---------------------------------------------------------------- hash tables


def _hash_relations(seed, n_a=4_000, n_b=70_000):
    """Build keys over the int32 domain with INT32_MIN/MAX and duplicates,
    probe keys half drawn from the build."""
    rng = np.random.default_rng(seed)
    a = rng.integers(I32_MIN, I32_MAX, n_a, dtype=np.int64).astype(np.int32)
    b = rng.integers(I32_MIN, I32_MAX, n_b, dtype=np.int64).astype(np.int32)
    b[: n_b // 2] = rng.choice(a, n_b // 2)
    a[:5], a[5:9], a[9:40] = I32_MAX, I32_MIN, a[40]
    b[::97] = I32_MAX
    return torch.from_numpy(a), torch.from_numpy(b)


def _same_fields(got, want, fields):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w), f


def test_hash_tables_on_card_match_cpu(cuda):
    """Every table and probe of ops/hash_table.py on the card equals the CPU
    port bit for bit, with every hash through K7."""
    from partitionedhashjoin_tpu_torch.ops import hash_table as ht

    a, b = _hash_relations(1)
    ac, bc = a.to(cuda), b.to(cuda)
    valid = torch.arange(a.numel()) % 3 != 0
    before = gen.LAUNCHES_HASH
    size = ht.table_size_for(a.numel())
    fields = ("slot_keys", "slot_rows", "max_probe", "overflowed")
    t_cpu, t_gpu = ht.build_hash_table(a, 7, size), ht.build_hash_table(ac, 7, size)
    _same_fields(t_gpu, t_cpu, fields)
    for fn in (ht.probe_exists, ht.probe_count_all):
        assert torch.equal(fn(t_gpu, bc).cpu(), fn(t_cpu, b))
    for g, w in zip(ht.probe_get(t_gpu, bc), ht.probe_get(t_cpu, b)):
        assert torch.equal(g.cpu(), w)
    (d_gpu, r_gpu), (d_cpu, r_cpu) = (
        ht.build_dedup_hash_table(k, 7, size, valid=v, has_valid=True)
        for k, v in ((ac, valid.to(cuda)), (a, valid)))
    _same_fields(d_gpu, d_cpu, fields)
    assert torch.equal(r_gpu.cpu(), r_cpu)
    nb = ht.chained_num_buckets(a.numel())
    c_cpu, c_gpu = ht.build_chained(a, 9, nb), ht.build_chained(ac, 9, nb)
    _same_fields(c_gpu, c_cpu, ("entry_keys", "entry_rows", "offsets", "max_chain"))
    assert int(ht.probe_chained_count(c_gpu, bc)) == int(ht.probe_chained_count(c_cpu, b))
    assert torch.equal(ht.probe_chained_count_all(c_gpu, bc).cpu(),
                       ht.probe_chained_count_all(c_cpu, b))
    for g, w in zip(ht.probe_chained_get(c_gpu, bc), ht.probe_chained_get(c_cpu, b)):
        assert torch.equal(g.cpu(), w)
    torch.cuda.synchronize()
    assert gen.LAUNCHES_HASH > before


def test_int64_chained_table_on_card_matches_cpu(cuda):
    """The int64 chained table and its probes on the card equal the CPU
    port bit for bit, every hash through K7's int64 kernel; keys that differ
    only above bit 31 are told apart."""
    from partitionedhashjoin_tpu_torch.ops import hash_table as ht

    a32, b32 = _hash_relations(2)
    a = a32.to(torch.int64) + (torch.arange(a32.numel()) % 3 - 1) * 2**32
    b = b32.to(torch.int64)
    b[1::2] += 2**32
    ac, bc = a.to(cuda), b.to(cuda)
    before, before32 = gen.LAUNCHES_HASH64, gen.LAUNCHES_HASH
    nb = ht.chained_num_buckets(a.numel())
    c_cpu, c_gpu = ht.build_chained(a, 9, nb), ht.build_chained(ac, 9, nb)
    _same_fields(c_gpu, c_cpu, ("entry_keys", "entry_rows", "offsets", "max_chain"))
    want = int(torch.isin(b, a).sum())
    assert 0 < want < b.numel()
    for chunks in (1, 3):
        assert int(ht.probe_chained_count(c_gpu, bc, chunks)) == want
    assert torch.equal(ht.probe_chained_count_all(c_gpu, bc).cpu(),
                       ht.probe_chained_count_all(c_cpu, b))
    for g, w in zip(ht.probe_chained_get(c_gpu, bc), ht.probe_chained_get(c_cpu, b)):
        assert torch.equal(g.cpu(), w)
    joiner = NoPartitioningHashJoiner(NoPartitioningConfiguration(mode="chained"), seed=5)
    pay = torch.arange(a.numel(), dtype=torch.int64) * 7
    ta, tb = make_table(ac, pay.to(cuda)), make_table(bc, bc ^ 0x5A17)
    got = joiner.run_materialize(ta, tb)
    ref = joiner.run_materialize(make_table(a, pay), make_table(b, b ^ 0x5A17))
    for f in ("keys", "payloads_a", "payloads_b", "count"):
        assert torch.equal(getattr(got, f).cpu(), getattr(ref, f)), f
    torch.cuda.synchronize()
    assert gen.LAUNCHES_HASH64 > before and gen.LAUNCHES_HASH == before32


def test_int64_chained_join_at_full_size(cuda):
    """The chained no-partitioning join at 10M ⋈ 200M int64 keys spread over
    the whole int64 range, an eighth of the probe rows missing by their
    high word alone: the exact count, every hash through K7's int64 kernel."""
    n_a, n_b = 10_000_000, 200_000_000
    g = torch.Generator(device=cuda).manual_seed(2026)
    a = torch.randint(I64_MIN, I64_MAX, (n_a,), generator=g, device=cuda)
    b = a[torch.randint(0, n_a, (n_b,), generator=g, device=cuda)]
    b[::8] ^= 1 << 45
    want = int(torch.isin(b, a).sum())
    assert n_b * 7 // 8 <= want < n_b
    before, before32 = gen.LAUNCHES_HASH64, gen.LAUNCHES_HASH
    joiner = NoPartitioningHashJoiner(NoPartitioningConfiguration(mode="chained"), seed=11)
    assert joiner.run(make_table(a, a), make_table(b, b)) == want
    assert gen.LAUNCHES_HASH64 == before + 2 and gen.LAUNCHES_HASH == before32


def test_int64_hash_aggregate_on_card(cuda):
    """The hash GROUP BY over 4M int64 keys with a Zipf(1.05) head (the head
    key takes ~7% of the rows), keys that differ only above bit 31: every
    group exact against a plain sort GROUP BY, in first-row order, every
    hash through K7's int64 kernel; ``filter_aggregate`` too."""
    from partitionedhashjoin_tpu_torch.ops import hash_table as ht

    n, domain = 4_000_000, 1_000_000
    g = torch.Generator(device=cuda).manual_seed(26)
    cdf = torch.cumsum(torch.arange(1, domain + 1, dtype=torch.float64,
                                    device=cuda).pow_(-1.05), 0)
    idx = torch.searchsorted(cdf / cdf[-1], torch.rand(n, dtype=torch.float64,
                                                       generator=g, device=cuda))
    keys = idx.clamp_(max=domain - 1) + (idx % 3 - 1) * 2**32
    pay = torch.randint(-(2**40), 2**40, (n,), generator=g, device=cuda)

    def plain(k, p):
        """``(key, count, sum, min, max, first row)`` by key, from sorts."""
        order = torch.sort(p, stable=True).indices
        order = order[torch.sort(k[order], stable=True).indices]
        ks, ps = k[order], p[order]
        new = torch.ones_like(ks, dtype=torch.bool)
        new[1:] = ks[1:] != ks[:-1]
        first = torch.nonzero(new).squeeze(1)
        last = torch.cat([first[1:], first.new_tensor([ks.numel()])]) - 1
        cs = torch.cumsum(ps, 0)
        rows = torch.full_like(ks, ks.numel()).scatter_reduce_(
            0, torch.cumsum(new, 0) - 1, order, "amin")[: first.numel()]
        return (ks[first], last - first + 1, cs[last] - cs[first] + ps[first],
                ps[first], ps[last], rows)

    def check(got, k, p):
        want = plain(k, p)
        m = int(got.num_groups)
        assert m == want[0].numel()
        by_key = torch.sort(got.keys[:m]).indices
        for col, w in zip((got.keys, got.count, got.sum, got.min, got.max), want):
            assert torch.equal(col[:m][by_key].to(torch.int64), w)
        # groups in the order of their keys' first rows
        first_rows = torch.empty_like(want[5])
        first_rows[by_key] = want[5]
        assert bool((first_rows[1:] > first_rows[:-1]).all())

    before, before32 = gen.LAUNCHES_HASH64, gen.LAUNCHES_HASH
    t = make_table(keys, pay)
    got = aggregate.hash_aggregate(t, seed=0x5EED)
    assert int(got.count.max()) > n // 20  # the Zipf head
    check(got, keys, pay)
    even = lambda k, p: (p % 2) == 0  # noqa: E731
    got, kept = aggregate.filter_aggregate(t, even, seed=0x5EED)
    mask = even(keys, pay)
    assert int(kept) == int(mask.sum())
    check(got, keys[mask], pay[mask])
    torch.cuda.synchronize()
    assert gen.LAUNCHES_HASH64 == before + 2 and gen.LAUNCHES_HASH == before32
    assert ht.CLAIM_ROUNDS > 0


def test_tail_and_fallback_on_card_match_cpu(cuda):
    """The chained count on the JAX package's tail and fallback shapes (a
    64-entry chain, and a 4,096-row chain that every probe row walks)
    equals the CPU's, where the kernel's plain version runs."""
    from partitionedhashjoin_tpu_torch.ops import hash_table as ht

    for build, probe in ((torch.arange(64, dtype=torch.int32),
                          torch.arange(2048, dtype=torch.int32) % 80),
                         (torch.full((4096,), 77, dtype=torch.int32),
                          torch.full((4096,), 78, dtype=torch.int32))):
        zeros = torch.zeros_like(build)
        t_cpu = ht.build_chained_from_buckets(zeros, build, 1, 2)
        t_gpu = ht.build_chained_from_buckets(zeros.to(cuda), build.to(cuda), 1, 2)
        bucket = torch.zeros_like(probe)
        for skip in (None, 5):
            want = ht._probe_chained_count_chunk(t_cpu, probe, bucket, skip=skip)
            got = ht._probe_chained_count_chunk(t_gpu, probe.to(cuda), bucket.to(cuda),
                                                skip=skip)
            assert int(got) == int(want)


WIDTHS = [(torch.int32, torch.int32), (torch.int32, torch.int64),
          (torch.int64, torch.int32), (torch.int64, torch.int64)]
CHAINED_CASES = ("mixed", "misses", "empty_build", "empty_probe", "one_chain")


def _chained_operands(case, probe_dtype, entry_dtype):
    """(build, probe) CPU keys of one chained-count case: build keys over
    int32's range (and, in an int64 build, the first 2,000 of them again
    moved by 2^32), probe keys of an odd length that hit, miss and, at
    int64, differ from a build key only above bit 31."""
    rng = np.random.default_rng(2200)
    lo = rng.integers(I32_MIN, I32_MAX, 5000, dtype=np.int64)
    lo[:3] = [I32_MIN, I32_MAX, 0]
    build = np.concatenate([lo, lo[:2000] + 2**32]) if entry_dtype == torch.int64 else lo
    if case == "one_chain":
        build = build[:3000]  # every entry in bucket 0: one chain of 3,000
    hits = rng.choice(lo if case == "one_chain" else build, 6001)
    if probe_dtype == torch.int32:
        hits = hits[(hits >= I32_MIN) & (hits <= I32_MAX)]
    probe = np.concatenate([hits, rng.integers(I32_MIN, I32_MAX, 3000, dtype=np.int64)])
    if probe_dtype == torch.int64:
        probe = np.concatenate([probe, lo[:1000] + 2**32, lo[:1000] - 2**32,
                                lo[:7] ^ (1 << 62)])
    probe = rng.permutation(probe)
    if case == "misses":
        probe = rng.integers(I32_MIN, I32_MAX, 4001, dtype=np.int64)
    elif case == "empty_build":
        build = build[:0]
    elif case == "empty_probe":
        probe = probe[:0]
    return (torch.from_numpy(build).to(entry_dtype),
            torch.from_numpy(probe).to(probe_dtype))


def _chained_table(case, build):
    from partitionedhashjoin_tpu_torch.ops import hash_table as ht

    if case == "one_chain":
        zeros = torch.zeros(build.shape, dtype=torch.int32, device=build.device)
        return ht.build_chained_from_buckets(zeros, build, 3, 2)
    return ht.build_chained(build, 3, ht.chained_num_buckets(build.numel()))


def _chained_hashes(table, probe, case):
    """(hashes, mask) of a probe: K7's with the table's mask, or, for the
    one-chain table, bucket 0 for every row under the all-ones mask."""
    from partitionedhashjoin_tpu_torch.ops import hash_table as ht

    if case == "one_chain":
        return torch.zeros(probe.shape, dtype=torch.int32, device=probe.device), 0xFFFFFFFF
    return ht.hash_bits(ht._probe_keys(table, probe)[1], table.seed), table.num_buckets - 1


@pytest.mark.parametrize("case", CHAINED_CASES)
@pytest.mark.parametrize("probe_dtype,entry_dtype", WIDTHS)
def test_chained_count_kernel_matches_plain(cuda, case, probe_dtype, entry_dtype):
    """The chained-probe kernel's count equals its plain version, the CPU
    count probe and ``torch.isin`` at every key-width pair, with and without
    ``skip``; on a probe view off its 16-byte alignment and at odd lengths
    around a thread's 4-row group too."""
    from partitionedhashjoin_tpu_torch.ops import hash_table as ht
    from partitionedhashjoin_tpu_torch.ops.kernels import chained_probe as kcp

    build, probe = _chained_operands(case, probe_dtype, entry_dtype)
    t_cpu = _chained_table(case, build)
    t_gpu = _chained_table(case, build.to(cuda))
    _same_fields(t_gpu, t_cpu, ("entry_keys", "entry_rows", "offsets", "max_chain"))
    if case == "one_chain":
        assert int(t_cpu.max_chain) == 3000 > ht.PROBE_WINDOW
    rows = kcp.ROWS_PER_THREAD
    n = probe.numel()
    views = [(0, n), (1, n), (3, n - 2), (0, min(n, 4 * rows + 3))]
    for lo_row, hi_row in views:
        p_cpu = probe[lo_row:hi_row]
        p_gpu = probe.to(cuda)[lo_row:hi_row]
        h_cpu, mask = _chained_hashes(t_cpu, p_cpu, case)
        h_gpu, _ = _chained_hashes(t_gpu, p_gpu, case)
        bucket = h_cpu if case == "one_chain" else None
        for skip in (0, 5, rows + 1):
            want = int(torch.isin(p_cpu[skip:].to(torch.int64),
                                  build.to(torch.int64)).sum())
            got = kcp.chained_count(p_gpu, h_gpu, mask, t_gpu.offsets,
                                    t_gpu.entry_keys, skip)
            assert got.device == p_gpu.device and got.dim() == 0
            assert int(got) == want, (lo_row, hi_row, skip)
            assert int(kcp.chained_count(p_cpu, h_cpu, mask, t_cpu.offsets,
                                         t_cpu.entry_keys, skip)) == want
            assert int(ht._probe_chained_count_chunk(t_cpu, p_cpu, bucket, skip)) == want
        # the table's entries as a view off their 16-byte alignment: the
        # chain is read in chunks aligned to memory, not to entry_keys[0]
        leads = range(1, 16 // t_gpu.entry_keys.element_size()) if build.numel() else ()
        for lead in leads:
            shifted = torch.cat([t_gpu.entry_keys.new_full((lead,), 77),
                                 t_gpu.entry_keys])[lead:]
            assert shifted.data_ptr() % 16 == lead * shifted.element_size()
            got = kcp.chained_count(p_gpu, h_gpu, mask, t_gpu.offsets, shifted)
            assert int(got) == int(torch.isin(p_cpu.to(torch.int64),
                                              build.to(torch.int64)).sum()), lead
    if case in ("mixed", "one_chain") and probe.numel():
        assert 0 < int(torch.isin(probe.to(torch.int64), build.to(torch.int64)).sum())


@pytest.mark.parametrize("probe_dtype,entry_dtype", WIDTHS)
def test_chained_probe_on_card_counts_once_per_call(cuda, probe_dtype, entry_dtype):
    """``probe_chained_count`` on the card launches the kernel once per
    chunk and equals ``torch.isin`` for any ``num_chunks``; on the CPU it
    never launches it."""
    from partitionedhashjoin_tpu_torch.ops import hash_table as ht
    from partitionedhashjoin_tpu_torch.ops.kernels import chained_probe as kcp

    build, probe = _chained_operands("mixed", probe_dtype, entry_dtype)
    want = int(torch.isin(probe.to(torch.int64), build.to(torch.int64)).sum())
    t_gpu = _chained_table("mixed", build.to(cuda))
    t_cpu = _chained_table("mixed", build)
    for chunks in (1, 3, 7):
        before = kcp.LAUNCHES_CHAINED_COUNT
        assert int(ht.probe_chained_count(t_gpu, probe.to(cuda), chunks)) == want
        assert kcp.LAUNCHES_CHAINED_COUNT == before + chunks
        before = kcp.LAUNCHES_CHAINED_COUNT
        assert int(ht.probe_chained_count(t_cpu, probe, chunks)) == want
        assert kcp.LAUNCHES_CHAINED_COUNT == before
    before = kcp.LAUNCHES_CHAINED_COUNT
    assert int(ht.probe_chained_count(t_gpu, probe[:0].to(cuda))) == 0
    assert kcp.LAUNCHES_CHAINED_COUNT == before


def test_chained_joiners_on_card_launch_the_kernel_once(cuda):
    """The no-partitioning chained join and the radix chained join (its
    segmented bucket ids under the all-ones mask) build on the build kernel
    and count on the count kernel, each once a join, and equal the CPU port
    and ``torch.isin``."""
    from partitionedhashjoin_tpu_torch.ops.kernels import chained_probe as kcp

    a, b = _hash_relations(4)
    want = int(torch.isin(b, a).sum())
    cpu = (make_table(a, a), make_table(b, b))
    gpu = tuple(make_table(t.keys.to(cuda), t.payloads.to(cuda)) for t in cpu)
    for make in (lambda: NoPartitioningHashJoiner(
                     NoPartitioningConfiguration(mode="chained"), seed=9),
                 lambda: RadixHashJoiner(
                     RadixClusteringConfiguration(number_of_partitions=64, mode="chained"),
                     seed=9)):
        before, built = kcp.LAUNCHES_CHAINED_COUNT, kcp.LAUNCHES_CHAINED_BUILD
        assert make().run(*gpu) == want
        assert kcp.LAUNCHES_CHAINED_COUNT == before + 1
        assert kcp.LAUNCHES_CHAINED_BUILD == built + 1
        assert make().run(*cpu) == want
        assert kcp.LAUNCHES_CHAINED_COUNT == before + 1
        assert kcp.LAUNCHES_CHAINED_BUILD == built + 1


def test_chained_count_wrapper_rejects_mixed_devices(cuda):
    from partitionedhashjoin_tpu_torch.ops.kernels import chained_probe as kcp

    keys = torch.arange(8, dtype=torch.int32)
    offsets = torch.tensor([0, 8], dtype=torch.int32)
    with pytest.raises(ValueError, match="different devices"):
        kcp.chained_count(keys.to(cuda), keys.to(cuda), 0, offsets, keys.to(cuda))


def _build_ids(case, id_dtype):
    """``(bucket ids, num_buckets)`` on the CPU for one build case of the
    card's build kernel: ragged lengths around a thread's 4-row group and a
    warp's 128 rows, one long chain, runs of empty buckets longer than a
    warp's stage of offsets, ids far past the table and below 0."""
    rng = np.random.default_rng(2500)
    if case == "random":
        ids, nb = rng.integers(0, 1 << 20, 1_000_003), 1 << 20
    elif case == "one_chain":
        ids, nb = np.full(100_001, 3), 8
    elif case == "gaps":  # runs of empty buckets far longer than a group
        ids, nb = rng.integers(0, 1000, 30_007) * 1000, 1_000_000 + 3
    elif case == "past_the_table":
        top = I32_MAX if id_dtype == torch.int32 else 2**40
        ids = np.concatenate([rng.integers(0, 4096, 20_000), np.full(99, 4096),
                              rng.integers(4097, top, 5_000, dtype=np.int64)])
        nb = 4096
    elif case == "below_zero":
        ids, nb = rng.integers(-50, 600, 9_999), 512
    elif case.startswith("tiny"):
        n = int(case[4:])
        ids, nb = rng.integers(0, 6, n), 5
    else:
        raise KeyError(case)
    return torch.from_numpy(rng.permutation(np.asarray(ids, np.int64))).to(id_dtype), nb


BUILD_CASES = ("random", "one_chain", "gaps", "past_the_table", "below_zero",
               "tiny1", "tiny2", "tiny3", "tiny5", "tiny9")


@pytest.mark.parametrize("case", BUILD_CASES)
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_chained_build_kernel_matches_plain(cuda, case, id_dtype):
    """The build kernel's entry rows, offsets and longest chain are
    bit-identical to its plain version's at both id widths, and with both
    columns one element off their 16-byte alignment (the kernel's
    one-row-at-a-time path)."""
    from partitionedhashjoin_tpu_torch.ops.kernels import chained_probe as kcp

    bucket, nb = _build_ids(case, id_dtype)
    sorted_bucket, order = torch.sort(bucket.to(cuda), stable=True)
    want = kcp.chained_build_plain(sorted_bucket.cpu(), order.cpu(), nb)
    got = kcp.chained_build(sorted_bucket, order, nb)
    for name, g, w in zip(("entry_rows", "offsets", "max_chain"), got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype, name
        assert torch.equal(g.cpu(), w), name
    if case == "one_chain":
        assert int(got[2]) == bucket.numel()
    shifted = [_off16(t) for t in (sorted_bucket, order)]
    assert all(t.data_ptr() % 16 for t in shifted)
    for name, g, w in zip(("entry_rows", "offsets", "max_chain"),
                          kcp.chained_build(*shifted, nb), want):
        assert torch.equal(g.cpu(), w), name


def _off16(t):
    """A copy of the 1-D ``t`` that starts one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t
    return buf[1:]


@pytest.mark.parametrize("n,log2_buckets,key_dtype", [
    (10_000_000, 24, torch.int64),  # upstream_nopart_chained's build
    (128_000_000, 27, torch.int32),  # kimb_nopart_chained's build
])
def test_chained_build_kernel_at_full_size(cuda, n, log2_buckets, key_dtype):
    """At the chained cells' shapes, on K7's buckets of unique keys of the
    cell's width, the build kernel is bit-identical to its plain version on
    the card."""
    from partitionedhashjoin_tpu_torch.ops import hash_table as ht
    from partitionedhashjoin_tpu_torch.ops.kernels import chained_probe as kcp

    g = torch.Generator(device=cuda).manual_seed(n)
    keys = (torch.randperm(n, generator=g, device=cuda) + 1).to(key_dtype)
    nb = 1 << log2_buckets
    assert ht.chained_num_buckets(n) == nb
    sorted_bucket, order = torch.sort(ht.hash_bits(keys, 7) & (nb - 1), stable=True)
    got = kcp.chained_build(sorted_bucket, order, nb)
    want = kcp.chained_build_plain(sorted_bucket, order, nb)
    for name, a, b in zip(("entry_rows", "offsets", "max_chain"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert int(got[1][-1]) == n and 1 < int(got[2]) < 32


def test_chained_build_on_card_launches_once_and_reads_nothing_back(cuda):
    """A chained build on the card launches the build kernel once (none on
    the CPU), no histogram, scan or cat, and waits on no value from the
    card: its longest chain stays there."""
    from torch.profiler import ProfilerActivity, profile

    from partitionedhashjoin_tpu_torch.ops import hash_table as ht
    from partitionedhashjoin_tpu_torch.ops.kernels import chained_probe as kcp

    a, _ = _hash_relations(6, n_a=300_000)
    nb = ht.chained_num_buckets(a.numel())
    ac = a.to(cuda)
    ht.build_chained(ac, 9, nb)  # warm: the library is built and loaded
    torch.cuda.synchronize()
    for _ in range(2):
        before = kcp.LAUNCHES_CHAINED_BUILD
        ht.build_chained(ac, 9, nb)
        assert kcp.LAUNCHES_CHAINED_BUILD == before + 1
    ht.build_chained(a, 9, nb)
    assert kcp.LAUNCHES_CHAINED_BUILD == before + 1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        table = ht.build_chained(ac, 9, nb)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert any("chained_build_kernel" in k for k in names), names
    for banned in ("kernelHistogram1D", "aten::bincount", "DeviceScanKernel",
                   "aten::cumsum", "CatArrayBatchedCopy", "aten::cat", "aten::max",
                   "_local_scalar_dense", "aten::item", "cudaStreamSynchronize"):
        assert not [k for k in names if banned in k], (banned, names)
    assert table.max_chain.device.type == "cuda" and table.max_chain.dim() == 0


def test_radix_partition_on_card_matches_cpu(cuda):
    from partitionedhashjoin_tpu_torch.ops import radix

    a, _ = _hash_relations(2, n_a=50_000)
    pay = torch.arange(a.numel(), dtype=torch.int32)
    fields = ("keys", "payloads", "row_ids", "histogram", "offsets")
    _same_fields(radix.radix_partition(a.to(cuda), pay.to(cuda), 3, 256),
                 radix.radix_partition(a, pay, 3, 256), fields)
    _same_fields(radix.radix_partition_padded(a.to(cuda), pay.to(cuda), 3, 64, 128),
                 radix.radix_partition_padded(a, pay, 3, 64, 128), fields)
    for g, w in zip(radix.radix_partition_keys(a.to(cuda), 3, 256, passes=2),
                    radix.radix_partition_keys(a, 3, 256)):
        assert torch.equal(g.cpu(), w)


def test_chained_paths_on_card_match_cpu(cuda):
    """The chained joins, run_materialize (K5) and the hash GROUP BY on the
    card equal the CPU port.  The float payloads are whole numbers with
    sums under 2^24, so their sums are exact in any order."""
    a, b = _hash_relations(3)
    pa, pb = (torch.randint(-2**31, 2**31 - 1, (t.numel(),), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(4)) for t in (a, b))
    cpu = (make_table(a, pa), make_table(b, pb))
    gpu = tuple(make_table(t.keys.to(cuda), t.payloads.to(cuda)) for t in cpu)
    chained = NoPartitioningConfiguration(mode="chained")
    for make in (lambda: NoPartitioningHashJoiner(chained, seed=5),
                 lambda: RadixHashJoiner(
                     RadixClusteringConfiguration(number_of_partitions=256, mode="chained"),
                     seed=5)):
        assert make().run(*gpu) == make().run(*cpu)
    before = kc.LAUNCHES
    got = NoPartitioningHashJoiner(seed=5).run_materialize(*gpu)
    want = NoPartitioningHashJoiner(seed=5).run_materialize(*cpu)
    assert kc.LAUNCHES == before + 1 and int(got.count) == int(want.count)
    _same_fields(got, want, ("keys", "payloads_a", "payloads_b"))
    keys = b % 700
    fields = ("keys", "count", "sum", "min", "max", "num_groups", "group_of_row")
    for pay in (pb, (pb % 1000).to(torch.float32)):
        t_cpu, t_gpu = make_table(keys, pay), make_table(keys.to(cuda), pay.to(cuda))
        _same_fields(aggregate.hash_aggregate(t_gpu, seed=6),
                     aggregate.hash_aggregate(t_cpu, seed=6), fields)
        even = lambda k, p: (k % 2) == 0  # noqa: E731
        (g, gn), (w, wn) = (aggregate.filter_aggregate(t, even, seed=6) for t in (t_gpu, t_cpu))
        _same_fields(g, w, fields)
        assert int(gn) == int(wn)


@pytest.mark.parametrize("dtype", [torch.int16, torch.uint8, torch.bool, torch.float16,
                                   torch.int64, torch.float64])
def test_run_materialize_payload_dtypes_on_card(cuda, dtype):
    """Payloads of every width ride K5 as int32 lanes and come back in their
    dtype, bit for bit the CPU port's."""
    a, b = _hash_relations(5)
    gen = torch.Generator().manual_seed(6)
    pa, pb = (torch.randint(-2**31, 2**31 - 1, (t.numel(),), dtype=torch.int64,
                            generator=gen) for t in (a, b))
    if dtype.is_floating_point:
        pa, pb = pa.to(torch.float64) / 7, pb.to(torch.float64) / 7
    cpu = (make_table(a, pa.to(dtype)), make_table(b, pb.to(dtype)))
    gpu = tuple(make_table(t.keys.to(cuda), t.payloads.to(cuda)) for t in cpu)
    before = kc.LAUNCHES
    got = NoPartitioningHashJoiner(seed=7).run_materialize(*gpu)
    want = NoPartitioningHashJoiner(seed=7).run_materialize(*cpu)
    assert kc.LAUNCHES == before + 1 and int(got.count) == int(want.count) > 0
    for f in ("keys", "payloads_a", "payloads_b"):
        g, w = getattr(got, f).cpu(), getattr(want, f)
        assert g.dtype == w.dtype and torch.equal(g.view(torch.uint8), w.view(torch.uint8)), f


@pytest.mark.parametrize("join_type,masked", [
    ("inner", False), ("anti", False), ("full", False), ("left", True), ("full", True),
])
@pytest.mark.parametrize("dtype_a,dtype_b", [
    (torch.int64, torch.float16), (torch.float16, torch.int64),
    (torch.float64, torch.int16),
])
def test_materialize_typed_payload_dtypes_on_card(cuda, dtype_a, dtype_b, join_type,
                                                  masked):
    """The typed materializer's compaction runs K5 on the card for payloads
    of any dtype (each as int32 lanes), bit for bit the CPU port's."""
    a, b = _hash_relations(5)
    gen = torch.Generator().manual_seed(8)

    def payloads(n, dtype):
        x = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int64, generator=gen)
        return (x.to(torch.float64) / 7).to(dtype) if dtype.is_floating_point else x.to(dtype)

    pa, pb = payloads(a.numel(), dtype_a), payloads(b.numel(), dtype_b)
    pv = (b % 3 != 0) if masked else None
    before = kc.LAUNCHES
    got = sort_merge.sort_merge_materialize_typed(
        a.to(cuda), pa.to(cuda), b.to(cuda), pb.to(cuda), join_type,
        probe_valid=None if pv is None else pv.to(cuda))
    launched = kc.LAUNCHES - before
    want = sort_merge.sort_merge_materialize_typed(a, pa, b, pb, join_type,
                                                   probe_valid=pv)
    assert launched >= 1 and int(got[-1]) == int(want[-1]) > 0
    for g, w in zip(got[:-1], want[:-1]):
        g = g.cpu()
        assert g.dtype == w.dtype and torch.equal(g.view(torch.uint8), w.view(torch.uint8))


def _shuffle_relations(n_a=1 << 20, n_b=1 << 23):
    """A sequential build and a Zipf(1.05) probe over it, and uniform keys
    with duplicate build keys over a wider range."""
    from partitionedhashjoin_tpu_torch.ops import generators

    zipf = (generators.sequential_table(n_a, device="cpu"),
            generators.zipf_table(n_b, 1.05, (1, n_a), seed=9, device="cpu"))
    gen = torch.Generator().manual_seed(10)
    ka = torch.randint(0, 2 * n_a, (n_a,), dtype=torch.int32, generator=gen)
    kb = torch.randint(0, 2 * n_a, (n_b,), dtype=torch.int32, generator=gen)
    return {"zipf": zipf, "uniform": (make_table(ka, ka), make_table(kb, kb))}


@pytest.mark.parametrize("num_shards", [1, 2, 8])
@pytest.mark.parametrize("local_join", ["sort-merge", "hash"])
def test_shuffle_join_on_card_counts_like_isin(cuda, num_shards, local_join):
    """~1M ⋈ 8M rows over a mesh of shards on the card: the count equals
    np.isin's, K1 counts the sort-merge local joins (and the one-shard fast
    path), K7 hashes the owner shards, the hot-key sample and the hash
    local joins."""
    from partitionedhashjoin_tpu_torch.parallel import mesh as pm
    from partitionedhashjoin_tpu_torch.parallel.shuffle import DistributedShuffleJoiner

    mesh = pm.make_mesh(num_shards, devices=[cuda])
    for name, (ta, tb) in _shuffle_relations().items():
        want = int(np.isin(tb.keys.numpy(), ta.keys.numpy()).sum())
        a, b = (pm.shard_table(make_table(t.keys.to(cuda), t.payloads.to(cuda)), mesh)
                for t in (ta, tb))
        k1, k7 = mp.LAUNCHES, gen.LAUNCHES_HASH
        joiner = DistributedShuffleJoiner(mesh, seed=11, local_join=local_join)
        assert joiner.run(a, b) == want, name
        fast = num_shards == 1 and local_join == "sort-merge"
        assert (mp.LAUNCHES - k1) == (0 if local_join == "hash" else 1 if fast else num_shards)
        assert (gen.LAUNCHES_HASH > k7) == (not fast)
        if name == "zipf" and not fast:
            assert 1 in joiner.last_run.hot_keys


def test_shuffle_options_on_card(cuda):
    """Pipelined chunks (K1 once per chunk and shard), no skew handling,
    validity masks, and int64 keys on one shard (K3)."""
    from partitionedhashjoin_tpu_torch.parallel import mesh as pm
    from partitionedhashjoin_tpu_torch.parallel.shuffle import DistributedShuffleJoiner

    ta, tb = _shuffle_relations(1 << 18, 1 << 21)["zipf"]
    mesh = pm.make_mesh(8, devices=[cuda])
    a, b = (pm.shard_table(make_table(t.keys.to(cuda), t.payloads.to(cuda)), mesh)
            for t in (ta, tb))
    k1 = mp.LAUNCHES
    assert DistributedShuffleJoiner(mesh, seed=12, pipeline_chunks=4).run(a, b) == tb.size
    assert mp.LAUNCHES - k1 == 4 * 8
    assert DistributedShuffleJoiner(mesh, seed=12, handle_skew=False).run(a, b) == tb.size
    va, vb = ta.keys % 3 != 0, tb.keys % 2 == 0
    want = int((vb & (tb.keys % 3 != 0)).sum())
    assert DistributedShuffleJoiner(mesh, seed=12).run(
        a, b, valid_a=pm.shard_array(va, mesh), valid_b=pm.shard_array(vb, mesh)) == want
    mesh1 = pm.make_mesh(1, devices=[cuda])
    a64, b64 = (pm.shard_table(make_table(t.keys.to(cuda, torch.int64),
                                          t.payloads.to(cuda)), mesh1) for t in (ta, tb))
    k3 = mp.LAUNCHES_I64
    assert DistributedShuffleJoiner(mesh1, seed=12).run(a64, b64) == tb.size
    assert mp.LAUNCHES_I64 == k3 + 1


def _dist_relations(cuda, n_a=1 << 18, n_b=1 << 21):
    """The Zipf relations of ``_shuffle_relations`` at 256K ⋈ 2M with
    payloads (build: key ^ 0x5A17; probe: uniform in [0, 2^20)), on the CPU
    and on the card."""
    ta, tb = _shuffle_relations(n_a, n_b)["zipf"]
    gen = torch.Generator().manual_seed(15)
    cpu = (make_table(ta.keys, ta.keys ^ 0x5A17),
           make_table(tb.keys, torch.randint(0, 1 << 20, (n_b,), dtype=torch.int32,
                                             generator=gen)))
    return cpu, tuple(make_table(t.keys.to(cuda), t.payloads.to(cuda)) for t in cpu)


def _meshes(cuda, s=8):
    from partitionedhashjoin_tpu_torch.parallel import mesh as pm

    return pm.make_mesh(s, devices=["cpu"]), pm.make_mesh(s, devices=[cuda])


def _assert_groups_equal(got, want):
    n = int(want.num_groups)
    assert int(got.num_groups) == n > 0
    for f in ("keys", "count", "sum", "min", "max", "distinct"):
        w = getattr(want, f)
        if w is not None:
            assert torch.equal(getattr(got, f).cpu(), w), f


def test_dist_aggregate_on_card_equals_cpu(cuda):
    """The combiner plan, masked, and the distinct plan: every field equal
    to the same operator on 8 CPU shards; K7 routes, K5 compacts."""
    from partitionedhashjoin_tpu_torch.parallel.aggregate_shuffle import (
        DistributedAggregateOperator,
    )

    (_, cpu), (_, gpu) = _dist_relations(cuda)
    mesh_cpu, mesh_gpu = _meshes(cuda)
    mask = cpu.payloads % 2 == 0
    for kw in ({}, {"mask": mask}, {"with_distinct": True, "mask": mask}):
        k5, k7 = kc.LAUNCHES, gen.LAUNCHES_HASH
        got = DistributedAggregateOperator(mesh_gpu, seed=3).run(
            gpu, group_capacity=1 << 18,
            **{k: v.to(cuda) if torch.is_tensor(v) else v for k, v in kw.items()})
        assert kc.LAUNCHES > k5 and gen.LAUNCHES_HASH > k7
        want = DistributedAggregateOperator(mesh_cpu, seed=3).run(
            cpu, group_capacity=1 << 18, **kw)
        _assert_groups_equal(got, want)


def test_dist_top_k_on_card_equals_cpu(cuda):
    from partitionedhashjoin_tpu_torch.parallel.top_k import distributed_top_k

    (_, cpu), (_, gpu) = _dist_relations(cuda)
    mesh_cpu, mesh_gpu = _meshes(cuda)
    mask = cpu.payloads % 3 == 0
    for by in ("key", "payload"):
        for m in (None, mask):
            got, live = distributed_top_k(mesh_gpu, gpu, 10, by=by,
                                          mask=None if m is None else m.to(cuda))
            want, want_live = distributed_top_k(mesh_cpu, cpu, 10, by=by, mask=m)
            assert int(live) == int(want_live) == 10
            assert torch.equal(got.keys.cpu(), want.keys)
            assert torch.equal(got.payloads.cpu(), want.payloads)


@pytest.mark.parametrize("handle_skew", [True, False])
def test_join_aggregate_on_card_equals_cpu(cuda, handle_skew):
    from partitionedhashjoin_tpu_torch.parallel.join_aggregate import (
        DistributedJoinAggregateOperator,
    )

    cpu, gpu = _dist_relations(cuda)
    mesh_cpu, mesh_gpu = _meshes(cuda)
    k5, k7 = kc.LAUNCHES, gen.LAUNCHES_HASH
    got = DistributedJoinAggregateOperator(mesh_gpu, seed=5, handle_skew=handle_skew).run(
        *gpu, group_capacity=1 << 18)
    assert kc.LAUNCHES > k5 and gen.LAUNCHES_HASH > k7
    want = DistributedJoinAggregateOperator(mesh_cpu, seed=5, handle_skew=handle_skew).run(
        *cpu, group_capacity=1 << 18)
    _assert_groups_equal(got, want)


@pytest.mark.parametrize("join_type", ["inner", "semi", "anti", "left"])
def test_dist_materialize_on_card_equals_cpu(cuda, join_type):
    """Rows in the same order as on the CPU shards; K5 compacts the gathered
    pools once."""
    from partitionedhashjoin_tpu_torch.parallel.materialize_shuffle import (
        DistributedMaterializeJoiner,
    )

    cpu, gpu = _dist_relations(cuda, 1 << 16, 1 << 19)
    mesh_cpu, mesh_gpu = _meshes(cuda)
    # a build mask leaves probe rows unmatched, so anti has rows too
    va, vb = cpu[0].keys % 5 != 0, cpu[1].payloads % 3 != 0
    k5 = kc.LAUNCHES
    got = DistributedMaterializeJoiner(mesh_gpu, seed=7).run(
        *gpu, join_type, build_valid=va.to(cuda), probe_valid=vb.to(cuda))
    assert kc.LAUNCHES > k5
    want = DistributedMaterializeJoiner(mesh_cpu, seed=7).run(
        *cpu, join_type, build_valid=va, probe_valid=vb)
    assert int(got.count) == int(want.count) > 0
    for f in ("keys", "payloads_a", "payloads_b", "matched"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


def test_multi_key_shuffle_on_card_equals_cpu(cuda):
    from partitionedhashjoin_tpu_torch.parallel.multi_key_shuffle import (
        MultiKeyShuffleJoiner,
    )

    (ta, tb), _ = _dist_relations(cuda)
    mesh_cpu, mesh_gpu = _meshes(cuda)
    cols = [[t.keys, t.keys ^ 0x5A17] for t in (ta, tb)]
    k7 = gen.LAUNCHES_HASH
    got = MultiKeyShuffleJoiner(mesh_gpu, seed=11).run(
        [c.to(cuda) for c in cols[0]], [c.to(cuda) for c in cols[1]])
    assert gen.LAUNCHES_HASH > k7
    assert got == MultiKeyShuffleJoiner(mesh_cpu, seed=11).run(*cols) == tb.size
    wide = [t.keys.to(torch.int64) << 20 for t in (ta, tb)]
    assert MultiKeyShuffleJoiner(mesh_gpu, seed=11).run_i64(
        *(w.to(cuda) for w in wide)) == tb.size


def test_r6_query_and_sql_on_card_equals_cpu(cuda):
    """The pipeline statement and the count join over a mesh of 8 shards of
    the card equal the same on 8 CPU shards; the count runs K1."""
    from partitionedhashjoin_tpu_torch import sql as tsql

    cpu, gpu = _dist_relations(cuda)
    mesh_cpu, mesh_gpu = _meshes(cuda)
    db_cpu, db_gpu = dict(zip("ab", cpu)), dict(zip("ab", gpu))
    stmt = ("SELECT key, COUNT(*), SUM(b.payload), MIN(b.payload), MAX(b.payload) "
            "FROM b JOIN a USING (key) GROUP BY key ORDER BY count DESC LIMIT 10")
    got = tsql.execute_sql(stmt, db_gpu, mesh=mesh_gpu, group_capacity=1 << 18)
    want = tsql.execute_sql(stmt, db_cpu, mesh=mesh_cpu, group_capacity=1 << 18)
    for c in want.columns:
        np.testing.assert_array_equal(got.columns[c], want.columns[c], err_msg=c)
    k1 = mp.LAUNCHES
    count = "SELECT COUNT(*) FROM b JOIN a USING (key)"
    assert tsql.execute_sql(count, db_gpu, mesh=mesh_gpu).columns["count"][0] == cpu[1].size
    assert mp.LAUNCHES == k1 + 8


def test_two_process_shuffle_join_on_one_card(cuda):
    """Two processes share the card: the group runs gloo, and the dry-run
    worker's three count oracles hold on a 2 x 4-shard mesh."""
    from partitionedhashjoin_tpu_torch import dryrun

    lines = dryrun.dryrun_multiprocess(2, 4, platform="cuda", timeout_s=300)
    for pid, line in enumerate(lines):
        assert line == f"MP_OK pid={pid} counts=4096,4096,4096 backend=gloo"


def _two_process_ops_equal_one_process(cuda, steps):
    """The dry-run ``ops`` worker in 2 processes x 4 shards on the card
    (gloo) at 40,000 x 400,000: each step's digest and ``last_run`` equal
    the one-process 8-shard run's on the same rows, in both processes.
    Returns the records, by step and process."""
    import json
    import os
    import sys

    from partitionedhashjoin_tpu_torch import bench_pipeline, dryrun
    from partitionedhashjoin_tpu_torch.parallel import mesh as pm

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    size = ["--primary", "40000", "--secondary", "400000", "--seed", "11",
            "--group-capacity", str(1 << 16)]
    coord = dryrun.free_coordinator()
    results = dryrun.run_processes(
        [[sys.executable, "-m", "partitionedhashjoin_tpu_torch.dryrun", "ops", coord, "2",
          str(pid), "--platform", "cuda", *size, "--steps", *steps] for pid in range(2)],
        300, env={**os.environ, "PYTHONPATH": repo}, cwd=repo)
    records = {}
    for _, out, _ in results:
        for line in out.splitlines():
            if line.startswith("MP_OPS "):
                rec = json.loads(line.removeprefix("MP_OPS "))
                records.setdefault(rec["step"], []).append(rec)
    assert sorted(records) == sorted(steps)
    rel = bench_pipeline.make_relations(40000, 400000, cuda)
    runs = dict(dryrun.ops_steps(pm.make_mesh(8, devices=[cuda]), rel, 11, 1 << 16))
    for name in steps:
        out, last_run = runs[name]()
        want = json.loads(json.dumps([dryrun.digest(out), dryrun.digest(last_run)]))
        assert len(records[name]) == 2
        for rec in records[name]:
            assert [rec["digest"], rec["run"]] == want, (name, rec["pid"])
            assert rec["backend"] == "gloo" and rec["device_ms"] > 0
    return records


def test_two_process_group_by_on_one_card(cuda):
    """The distributed GROUP BY, plain, masked and COUNT DISTINCT, over 2
    processes that share the card, equals the one-process run; K5 and K7
    launch inside each process."""
    records = _two_process_ops_equal_one_process(
        cuda, ["(a) aggregate", "(a) aggregate mask", "(a) aggregate distinct"])
    for recs in records.values():
        for rec in recs:
            assert rec["launches"]["k5"] > 0 and rec["launches"]["k7"] > 0
            assert rec["comm_sent"]["all_to_all"] > 0 and rec["comm_sent"]["pmax"] > 0


def test_two_process_materialize_on_one_card(cuda):
    """The four materializing joins over 2 processes that share the card
    equal the one-process rows, order, count and matched flags; K5 and K7
    launch inside each process."""
    records = _two_process_ops_equal_one_process(
        cuda, ["(d) materialize inner", "(d) materialize anti", "(d) materialize left",
               "(d) materialize semi mask"])
    for recs in records.values():
        for rec in recs:
            assert rec["launches"]["k5"] > 0 and rec["launches"]["k7"] > 0


def test_nccl_on_a_shared_card_raises(cuda):
    """Two processes on the one card asking for backend="nccl" both raise
    once they have read each other's card from the store, before any group
    is joined; with no backend named, the same pair is given gloo."""
    import os
    import sys

    from partitionedhashjoin_tpu_torch import dryrun
    from partitionedhashjoin_tpu_torch.parallel import distributed

    script = (
        "import sys, torch.distributed as dist\n"
        "from partitionedhashjoin_tpu_torch.parallel import distributed\n"
        "try:\n"
        "    distributed.initialize(sys.argv[1], 2, int(sys.argv[2]), platform='cuda',\n"
        "                           backend='nccl', timeout_s=60)\n"
        "except ValueError as e:\n"
        "    print('REFUSED', dist.is_initialized(), e)\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    coord = dryrun.free_coordinator()
    results = dryrun.run_processes(
        [[sys.executable, "-c", script, coord, str(pid)] for pid in range(2)], 120,
        env={**os.environ, "PYTHONPATH": repo}, cwd=repo)
    for _, out, _ in results:
        assert out.startswith("REFUSED False ") and "share a card" in out
    name = f"h/{cuda}"
    assert distributed._choose_backend(cuda, [name, name], None) == "gloo"
    assert distributed._choose_backend(cuda, [name], None) == "nccl"
