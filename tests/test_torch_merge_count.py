"""The port's fused merge count (K2) and sort-merge counts against the JAX
package, on the CPU.

``merge_count_sorted`` on CPU tensors runs its plain PyTorch version; it
must equal the JAX Pallas kernel (interpret mode) and a numpy running
maximum exactly on the cases of tests/test_pallas_kernels.py, on rows in
any order (the count is defined for every order) and on a carry across
many of the CUDA kernel's tiles.  The wrapper's tile and scratch sizes
must follow ``csrc/merge_count.cu``.  ``sort_merge_count``, ``anti_count`` and
``sort_merge_count_all`` must equal the JAX functions on the same numpy
inputs: masked and unmasked, int32 and int64 (JAX under x64), including
keys equal to the dtype minimum (the fast path's correction).  JAX's
``sort_merge_count_all`` returns a (hi, lo) uint32 pair, compared through
``widesum.pair_to_int``; the port returns an int64 scalar.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu.ops import sort_merge as jax_sm
from partitionedhashjoin_tpu.ops.pallas import merge_count as jax_mc
from partitionedhashjoin_tpu.utils.widesum import pair_to_int
from partitionedhashjoin_tpu_torch.ops import sort_merge as sm
from partitionedhashjoin_tpu_torch.ops.kernels import _build
from partitionedhashjoin_tpu_torch.ops.kernels import merge_count as mc

I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min
I64_MIN = np.iinfo(np.int64).min


def _merged(a, b):
    """Builds before equal-keyed probes (stable sort of the concatenation)."""
    a, b = np.asarray(a, np.int32), np.asarray(b, np.int32)
    keys = np.concatenate([a, b])
    is_build = np.concatenate([np.ones(a.size, bool), np.zeros(b.size, bool)])
    order = np.argsort(keys, kind="stable")
    return keys[order], is_build[order]


def _random(n_a, n_b):
    rng = np.random.default_rng(n_a + n_b)
    return _merged(rng.integers(-500, 500, n_a), rng.integers(-600, 600, n_b))


def _carry(n):
    keys = np.zeros(n, np.int32)
    is_build = np.zeros(n, bool)
    is_build[0] = True
    return keys, is_build


def _run_without_build(n):
    keys = np.concatenate([[5], np.full(n - 1, 7)]).astype(np.int32)
    is_build = np.zeros(n, bool)
    is_build[0] = True
    return keys, is_build


def _unsorted(n):
    """Keys on a random walk that falls back often, so the running maximum
    is often not the last build key; random tags."""
    rng = np.random.default_rng(n)
    keys = np.cumsum(rng.integers(-3, 5, n)).astype(np.int32)
    return keys, rng.random(n) < 0.3


def _carry_many_tiles(n):
    """The first row is the largest build key; later, smaller build keys in
    every tile must not replace it, and the last rows probe it."""
    rng = np.random.default_rng(n)
    keys = rng.integers(-50, 50, n).astype(np.int32)
    is_build = rng.random(n) < 0.01
    keys[0], is_build[0] = 60, True
    keys[-5:], is_build[-5:] = 60, False
    return keys, is_build


def _numpy_count(keys, is_build):
    last = np.maximum.accumulate(np.where(is_build, keys, I32_MIN))
    return int((~is_build & (last == keys) & (keys != I32_MIN)).sum())


# The JAX kernel in interpret mode compiles once per input length, so new
# cases reuse the lengths of the old ones (25,000 and BLOCK + 17 rows).
KERNEL_CASES = {
    "random_100x400": lambda: _random(100, 400),
    "random_5000x20000": lambda: _random(5000, 20000),
    "random_1x1": lambda: _random(1, 1),
    "random_0x100": lambda: _random(0, 100),
    # the carry crosses the JAX kernel's grid steps and the CUDA kernel's
    # blocks
    "carry_across_blocks": lambda: _carry(3 * mc.TILE_ROWS + 17),
    "carry_across_jax_blocks": lambda: _carry(jax_mc.BLOCK + 17),
    "run_without_build": lambda: _run_without_build(2 * mc.TILE_ROWS),
    "int32_max_probes": lambda: _merged([1], [I32_MAX, I32_MAX]),
    "int32_max_both": lambda: _merged([1, I32_MAX], [I32_MAX, I32_MAX]),
    "int32_min_keys": lambda: _merged([I32_MIN, 3], [I32_MIN, I32_MIN, 3, 4]),
    "block_edges": lambda: _merged(
        np.arange(0, 3 * mc.TILE_ROWS, 7),
        np.repeat(np.arange(0, 3 * mc.TILE_ROWS, 3), 2),
    ),
    "unsorted": lambda: _unsorted(25000),
    "carry_across_many_tiles": lambda: _carry_many_tiles(jax_mc.BLOCK + 17),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_plain_matches_jax_kernel(case):
    keys, is_build = KERNEL_CASES[case]()
    want = int(jax_mc.merge_count_sorted(
        jnp.asarray(keys), jnp.asarray(is_build), interpret=True
    ))
    got = mc.merge_count_sorted(torch.from_numpy(keys), torch.from_numpy(is_build))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want == _numpy_count(keys, is_build)
    tags = torch.from_numpy(is_build.astype(np.uint8))
    assert int(mc.merge_count_sorted(torch.from_numpy(keys), tags)) == want
    assert mc.LAUNCHES == 0  # CPU tensors never reach the kernel


def test_new_cases_have_their_geometry():
    keys, is_build = KERNEL_CASES["unsorted"]()
    assert (np.diff(keys) < 0).any() and _numpy_count(keys, is_build) > 1000
    keys, is_build = KERNEL_CASES["carry_across_many_tiles"]()
    assert keys.size // mc.TILE_ROWS >= 8 and is_build[1:].sum() > 100
    assert _numpy_count(keys, is_build) == 5  # only the last rows match


def test_tile_and_scratch_sizes_follow_the_source():
    """TILE_ROWS is the kernel's kTile, and the wrapper's scratch is never
    shorter than the C entry's least size, 2 + ceil((n + lead) / kTile)
    words for the 0..3 rows (``lead``) before keys[0] back to its 16-byte
    boundary; the entry refuses a shorter buffer."""
    src = (_build.CSRC_DIR / "merge_count.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    rows = int(re.search(r"constexpr int kRowsPerThread = (\d+);", src).group(1))
    assert "constexpr int kTile = kThreads * kRowsPerThread;" in src
    assert mc.TILE_ROWS == threads * rows
    assert "scratch_words < 2 + tiles" in src
    t = mc.TILE_ROWS
    for n in (1, 2, t - 3, t - 1, t, t + 1, 3 * t - 2, 3 * t, 3 * t + 5):
        least = max(2 + -(-(n + lead) // t) for lead in range(4))
        assert least <= mc.scratch_words(n) <= least + 1
    assert [mc.scratch_words(n) for n in (1, t, t + 1, 3 * t)] == [4, 4, 5, 6]


def test_wrapper_rejects_bad_inputs():
    k = torch.arange(10, dtype=torch.int32)
    t = torch.zeros(10, dtype=torch.bool)
    with pytest.raises(TypeError):
        mc.merge_count_sorted(k.to(torch.int64), t)
    with pytest.raises(TypeError):
        mc.merge_count_sorted(k, t.to(torch.int32))
    with pytest.raises(ValueError):
        mc.merge_count_sorted(k, t[:5])
    with pytest.raises(ValueError):
        mc.merge_count_sorted(k[::2], t[::2])
    with pytest.raises(ValueError):
        mc.merge_count_sorted(k, t.to("meta"))
    with pytest.raises(ValueError):
        mc.merge_count_sorted(k.to("meta"), t.to("meta"))


def _inputs(dtype, seed):
    rng = np.random.default_rng(seed)
    kmin = np.iinfo(dtype).min
    a = rng.integers(-3000, 3000, 2500).astype(dtype)
    b = rng.integers(-4000, 4000, 9000).astype(dtype)
    if dtype == np.int64:
        a, b = a << 33, b << 33  # keys only an int64 count tells apart
    a[:4] = kmin  # the dtype minimum on both sides: the fast path's correction
    b[:6] = kmin
    av = rng.random(a.size) < 0.8
    bv = rng.random(b.size) < 0.7
    return a, b, av, bv


def _jax_counts(a, b, av, bv, masked):
    args = (a, b, av, bv) if masked else (a, b)
    jargs = [jnp.asarray(x) for x in args]
    return (
        int(jax_sm.sort_merge_count(*jargs)),
        int(jax_sm.anti_count(*jargs)),
        pair_to_int(jax_sm.sort_merge_count_all(*jargs)),
    )


def _port_counts(a, b, av, bv, masked):
    args = (a, b, av, bv) if masked else (a, b)
    targs = [torch.from_numpy(x) for x in args]
    got = (sm.sort_merge_count(*targs), sm.anti_count(*targs),
           sm.sort_merge_count_all(*targs))
    for g in got:
        assert g.dtype == torch.int64 and g.dim() == 0
    return tuple(int(g) for g in got)


@pytest.mark.parametrize("masked", [False, True])
def test_counts_int32_match_jax(masked):
    a, b, av, bv = _inputs(np.int32, 3)
    want = _jax_counts(a, b, av, bv, masked)
    assert _port_counts(a, b, av, bv, masked) == want
    if not masked:
        assert want[0] == int(np.isin(b, a).sum())


@pytest.mark.parametrize("masked", [False, True])
def test_counts_int64_match_jax(masked):
    a, b, av, bv = _inputs(np.int64, 5)
    with jax.enable_x64(True):
        want = _jax_counts(a, b, av, bv, masked)
    assert _port_counts(a, b, av, bv, masked) == want
    if not masked:
        assert want[0] == int(np.isin(b, a).sum())


def test_count_all_beyond_int32():
    # 70k duplicated build keys x 35k probes of the same key > 2^31
    a = np.full(70_000, 7, np.int32)
    b = np.full(35_000, 7, np.int32)
    want = pair_to_int(jax_sm.sort_merge_count_all(jnp.asarray(a), jnp.asarray(b)))
    got = sm.sort_merge_count_all(torch.from_numpy(a), torch.from_numpy(b))
    assert int(got) == want == 70_000 * 35_000


def test_fast_path_runs_the_merge_count(monkeypatch):
    """Unmasked int32 keys go through K2's wrapper; int64 keys do not."""
    calls = []
    real = mc.merge_count_sorted
    monkeypatch.setattr(
        mc, "merge_count_sorted", lambda *a: calls.append(1) or real(*a)
    )
    k = torch.arange(10, dtype=torch.int32)
    assert int(sm.sort_merge_count(k, k)) == 10
    assert calls == [1]
    assert int(sm.sort_merge_count(k.to(torch.int64), k)) == 10
    assert int(sm.sort_merge_count(k, k, torch.ones(10, dtype=torch.bool))) == 10
    assert calls == [1]


def test_mixed_widths_and_empty_sides():
    k32 = torch.tensor([1, 2, 3], dtype=torch.int32)
    k64 = torch.tensor([3, 2**40, 1], dtype=torch.int64)
    assert int(sm.sort_merge_count(k32, k64)) == 2
    assert int(sm.sort_merge_count(k64, k32)) == 2
    for keys in (k32, k64):
        none = torch.zeros((0,), dtype=keys.dtype)
        for fn in (sm.sort_merge_count, sm.sort_merge_count_all):
            assert int(fn(none, keys)) == 0 and int(fn(keys, none)) == 0
            assert int(fn(none, none)) == 0
            assert int(fn(none, keys, None, torch.ones(3, dtype=torch.bool))) == 0
        assert int(sm.anti_count(none, keys)) == 3
    none = torch.zeros((0,), dtype=torch.int32)
    assert int(sm.anti_count(none, k32, None, torch.tensor([True, False, True]))) == 2
    with pytest.raises(TypeError):
        sm.sort_merge_count(k32.to(torch.float32), k32)
