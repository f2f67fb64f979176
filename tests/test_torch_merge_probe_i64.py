"""The port's int64 merge-probe count (K3) against the JAX package, on the CPU.

On CPU tensors ``ranged_merge_count_i64`` runs its plain PyTorch version; it
must equal the JAX hi/lo-plane kernel (interpret mode, under x64) and
``np.isin`` exactly, on the cases where a 64-bit count is likely to go
wrong: the ends of the int64 domain, keys that differ only in the low word
across 2^31 (the case the JAX bias trick exists for), keys k and k + 2^32,
duplicate runs longer than the CUDA kernel's probe tile and runs across its
edges, and empty sides.  Also ``two_run_count_i64`` and the int64
``PreparedBuild``, including its state carried across from JAX.  The CUDA
kernel itself is held to the plain version in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu.ops import merge_join as jax_mj
from partitionedhashjoin_tpu.ops.pallas import merge_probe as jax_mp
from partitionedhashjoin_tpu_torch.ops import merge_join as mj
from partitionedhashjoin_tpu_torch.ops.kernels import merge_probe as mp

I64_MAX = np.iinfo(np.int64).max
I64_MIN = np.iinfo(np.int64).min
TILE = mp.TILE_ROWS
WORD = 9 << 32  # a high word shared by the low-word cases


def _random(seed, n_a=3000, n_b=20000):
    rng = np.random.default_rng(seed)
    a = rng.integers(I64_MIN, I64_MAX, n_a, dtype=np.int64)
    b = rng.integers(I64_MIN, I64_MAX, n_b, dtype=np.int64)
    b[: n_b // 3] = rng.choice(a, n_b // 3)
    b[n_b // 3 : n_b // 2] = rng.choice(a, n_b // 2 - n_b // 3) ^ (1 << 31)
    return a, b


CASES = {
    "int64_ends": lambda: (
        [I64_MAX, I64_MAX, 5, I64_MIN, -7],
        [I64_MAX, 5, 6, I64_MAX, -7, I64_MIN, I64_MIN, I64_MIN + 1, I64_MAX - 1],
    ),
    "max_absent": lambda: ([5, -7], [I64_MAX, 5, I64_MIN]),
    "low_word_across_2^31": lambda: (
        [WORD, WORD + 2**31],
        [WORD, WORD + 1, WORD + 2**31 - 1, WORD + 2**31, WORD + 2**31 + 1,
         WORD + 2**32 - 1, WORD - 1],
    ),
    "k_and_k_plus_2^32": lambda: (
        [77, -77, 2**31],
        [77, 77 + 2**32, 77 - 2**32, -77, -77 + 2**32, 2**31, 2**31 + 2**32,
         2**31 - 2**32],
    ),
    "dup_run_longer_than_tile": lambda: (
        np.concatenate([np.full(3 * TILE + 5, 2**40 + 3), [7, 99]]),
        np.concatenate([np.full(2 * TILE + 100, 2**40 + 3), np.arange(200)]),
    ),
    "runs_across_tile_edges": lambda: (
        np.arange(0, 100, 2) << 33,
        np.concatenate([np.full(TILE - 3, 10), np.full(10, 11),
                        np.full(TILE + 1, 12),
                        np.repeat(np.arange(13, 20), 777)]) << 33,
    ),
    "random_full_domain": lambda: _random(19),
}


def _sorted(x):
    return np.sort(np.asarray(x, np.int64))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_kernel_and_numpy(case):
    a, b = (_sorted(x) for x in CASES[case]())
    want = int(np.isin(b, a).sum())
    with jax.enable_x64(True):
        got_jax = int(jax_mp.ranged_merge_count_i64(
            jnp.asarray(a), jnp.asarray(b), interpret=True
        ))
    got = mp.ranged_merge_count_i64(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == got_jax == want
    assert int(mp.ranged_merge_count_i64_plain(
        torch.from_numpy(a), torch.from_numpy(b))) == want
    assert mp.LAUNCHES_I64 == 0  # CPU tensors never reach the kernel


def test_empty_sides():
    one = torch.tensor([1, 2], dtype=torch.int64)
    none = torch.zeros((0,), dtype=torch.int64)
    for a, b in ((none, one), (one, none), (none, none)):
        assert int(mp.ranged_merge_count_i64(a, b)) == 0
        assert int(mj.two_run_count_i64(a, b)) == 0
    assert int(mj.PreparedBuild(none).count(one)) == 0
    assert int(mj.PreparedBuild(one).count(none)) == 0


def test_two_run_count_i64_matches_jax():
    a, b = _random(23, 4000, 16000)
    with jax.enable_x64(True):
        want = int(jax_mj.two_run_count_i64(
            jnp.asarray(a), jnp.asarray(b), interpret=True
        ))
    got = mj.two_run_count_i64(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want == int(np.isin(b, a).sum())
    # an int32 side widens to int64, never the other way
    got = mj.two_run_count_i64(torch.from_numpy(a), torch.arange(100, dtype=torch.int32))
    assert int(got) == int(np.isin(np.arange(100), a).sum())


def test_prepared_build_i64_and_from_numpy_match_jax():
    a, b = _random(29, 3000, 12000)
    with jax.enable_x64(True):
        jax_pb = jax_mj.PreparedBuild(jnp.asarray(a), interpret=True)
        assert jax_pb.max_in_a is None
        state = np.asarray(jax_pb.a_sorted)
        wants = [int(jax_pb.count(jnp.asarray(p)))
                 for p in (b, b[::-1].copy(), a)]
    own = mj.PreparedBuild(torch.from_numpy(a))
    carried = mj.PreparedBuild.from_numpy(state, None, "cpu")
    assert own.max_in_a is None and carried.max_in_a is None
    assert carried.a_sorted.dtype == torch.int64
    assert torch.equal(own.a_sorted, carried.a_sorted)
    for probe, want in zip((b, b[::-1].copy(), a), wants):
        assert int(own.count(torch.from_numpy(probe))) == want
        assert int(carried.count(torch.from_numpy(probe))) == want


def test_prepared_build_i64_rejects_masks_like_jax():
    k64 = np.arange(8, dtype=np.int64)
    valid = np.ones(8, bool)
    with jax.enable_x64(True):
        with pytest.raises(TypeError):
            jax_mj.PreparedBuild(jnp.asarray(k64), jnp.asarray(valid))
    with pytest.raises(TypeError):
        mj.PreparedBuild(torch.from_numpy(k64), torch.from_numpy(valid))
    with pytest.raises(TypeError):
        mj.PreparedBuild(torch.from_numpy(k64)).count(
            torch.from_numpy(k64), torch.from_numpy(valid)
        )


def test_wrapper_rejects_bad_inputs():
    a = torch.arange(10, dtype=torch.int64)
    with pytest.raises(TypeError):
        mp.ranged_merge_count_i64(a.to(torch.int32), a)
    with pytest.raises(TypeError):
        mp.ranged_merge_count_i64(a.reshape(2, 5), a)
    with pytest.raises(ValueError):
        mp.ranged_merge_count_i64(a, a[::2])
    with pytest.raises(ValueError):
        mp.ranged_merge_count_i64(a, a.to("meta"))
    with pytest.raises(ValueError):
        mp.ranged_merge_count_i64(a.to("meta"), a.to("meta"))
    with pytest.raises(TypeError):
        mj.two_run_count_i64(a.to(torch.uint64), a)


def _merge_cases(chunk):
    """The int64 inputs that reach the branches of the CUDA kernel's merge
    in shared memory (``chunk`` build rows per chunk), as chip_smoke.py
    builds them: keys that differ from build keys only above bit 31 around
    a chunk edge, a duplicate build run across a chunk edge and a build
    range of many chunks."""
    a = (np.arange(3 * chunk, dtype=np.int64) << 33) + 12_345
    edge = a[chunk - 8 : chunk + 8]
    dense = np.arange(1, 1_000_001, dtype=np.int64) + 2**40
    return {
        "above_bit31_at_chunk_edge": (
            a, np.concatenate([a[::4], a[::4] + 2**32, edge, edge + 2**32,
                               edge - 2**32]),
        ),
        "dup_run_across_chunk_edge": (
            np.concatenate([np.arange(chunk - 3), np.full(9, chunk),
                            np.arange(chunk + 1, 3 * chunk)]) << 33,
            np.concatenate([np.arange(0, 3 * chunk, 3),
                            np.full(50, chunk)]) << 33,
        ),
        "sparse_probe_many_chunks": (dense, dense[::50]),
    }


MERGE_CASES = _merge_cases(mp.CHUNK_ROWS_I64)


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_cases_plain_matches_numpy(case):
    """The chip's merge cases: the plain version and the tile ranges the
    kernel merges, against numpy; each case has the shape its name claims
    on the card (its first tile's range spans more than one chunk)."""
    a, b = (_sorted(x) for x in MERGE_CASES[case])
    got = mp.ranged_merge_count_i64(torch.from_numpy(a), torch.from_numpy(b))
    assert int(got) == int(np.isin(b, a).sum())
    ranges = mp.tile_ranges_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert ranges.shape == (-(-b.size // TILE), 2)
    for t, (lo, hi) in enumerate(ranges):
        rows = b[t * TILE : (t + 1) * TILE]
        first = np.searchsorted(a, rows[np.isin(rows, a)])
        assert ((first >= lo) & (first < hi)).all()
        assert ((a[lo:hi] >= rows[0]) & (a[lo:hi] <= rows[-1])).all()
    assert ranges[0, 1] - ranges[0, 0] > mp.CHUNK_ROWS_I64
    assert mp.LAUNCHES_I64 == 0


def test_above_bit31_matches_jax_kernel():
    """Keys that differ from build keys only above bit 31, at the (3,000,
    20,000) shape ``random_full_domain`` has compiled."""
    a = (np.arange(3000, dtype=np.int64) << 33) + 12_345
    b = np.concatenate([a, a + 2**32, a - 2**32, a ^ (1 << 40)])
    b = _sorted(np.resize(b, 20_000))
    with jax.enable_x64(True):
        got_jax = int(jax_mp.ranged_merge_count_i64(
            jnp.asarray(a), jnp.asarray(b), interpret=True
        ))
    got = mp.ranged_merge_count_i64(torch.from_numpy(a), torch.from_numpy(b))
    assert int(got) == got_jax == int(np.isin(b, a).sum())
