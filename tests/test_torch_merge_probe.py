"""The port's merge-probe count (K1) against the JAX kernel, on the CPU.

On CPU tensors ``ranged_merge_count_prepared`` runs its plain PyTorch
version; it must equal the JAX Pallas kernel (interpret mode) and
``np.isin`` exactly, in both ``exclude_int32_max`` modes, on the edge cases
of tests/test_merge_probe.py.  Each JAX call stays within 2 probe blocks of
65,536 rows (every new shape costs an interpret-mode compile).  The CUDA
kernel itself is held to the plain version in tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from partitionedhashjoin_tpu.ops.pallas import merge_probe as jax_mp
from partitionedhashjoin_tpu_torch.ops.kernels import _build
from partitionedhashjoin_tpu_torch.ops.kernels import merge_probe as mp

I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min
BLOCK, CAP = jax_mp.BLOCK, jax_mp.CAP


def _oracle(a, b, exclude):
    hit = np.isin(b, a)
    if exclude:
        hit &= b != I32_MAX
    return int(hit.sum())


def _random(dom, n_a=4000, n_b=70000):
    rng = np.random.default_rng(dom)
    return rng.integers(-dom, dom, n_a), rng.integers(-dom, dom, n_b)


def _dup_run_across_tiles():
    # one build key duplicated over 4 full JAX tiles, then a second key; the
    # probe's first block is all the hot key
    a = np.concatenate([np.full(4 * CAP, 10), np.full(100, 20)])
    b = np.concatenate([np.full(BLOCK + 1000, 10), np.full(BLOCK - 1000, 20)])
    return a, b


def _many_hot_runs():
    rng = np.random.default_rng(11)
    hot = np.repeat(
        rng.choice(10_000, 24, replace=False), rng.integers(CAP, 3 * CAP, 24)
    )
    a = np.concatenate([hot, rng.integers(0, 10_000, 5_000)])
    return a, rng.integers(-100, 10_100, 2 * BLOCK - 333)


def _multi_tile():
    rng = np.random.default_rng(5)
    return (rng.integers(0, 3_000_000, 200_000),
            rng.integers(0, 3_000_000, BLOCK + 17))


CASES = {
    "random_dom50": lambda: _random(50),
    "random_dom8000": lambda: _random(8000),
    "random_full_domain": lambda: _random(2**31 - 1),
    "full_domain_edges": lambda: (
        [I32_MAX, I32_MAX, 5, I32_MIN, -7],
        [I32_MAX, 5, 6, I32_MAX, -7, I32_MIN, I32_MIN],
    ),
    "max_absent": lambda: ([5, -7], [I32_MAX, 5, I32_MAX]),
    "max_only": lambda: ([I32_MAX, I32_MAX], [I32_MAX] * 3),
    "dup_run_across_tiles": _dup_run_across_tiles,
    "many_hot_runs": _many_hot_runs,
    "multi_tile": _multi_tile,
}


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_kernel_and_numpy(case, exclude):
    a, b = (np.sort(np.asarray(x, np.int32)) for x in CASES[case]())
    want = _oracle(a, b, exclude)
    got_jax = int(jax_mp.ranged_merge_count_prepared(
        jnp.asarray(a), jnp.asarray(b), exclude_int32_max=exclude,
        interpret=True,
    ))
    got = mp.ranged_merge_count_prepared(
        torch.from_numpy(a), torch.from_numpy(b), exclude
    )
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == got_jax == want
    assert mp.LAUNCHES == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("exclude", [False, True])
def test_empty_sides(exclude):
    one = torch.tensor([1, 2], dtype=torch.int32)
    none = torch.zeros((0,), dtype=torch.int32)
    for a, b in ((none, one), (one, none), (none, none)):
        assert int(mp.ranged_merge_count_prepared(a, b, exclude)) == 0
    assert int(jax_mp.ranged_merge_count_prepared(
        jnp.zeros((0,), jnp.int32), jnp.asarray([1, 2], jnp.int32),
        exclude_int32_max=exclude, interpret=True)) == 0


def test_tile_edges_plain_matches_numpy():
    """Runs longer than the CUDA kernel's probe tile, and runs straddling
    its edges: the plain version (the kernel's reference) against numpy."""
    t = mp.TILE_ROWS
    a = np.concatenate([np.full(3 * t + 5, 42), np.arange(0, 100, 2)])
    b = np.concatenate([
        np.full(t - 3, 10), np.full(10, 11), np.full(2 * t + 1, 42),
        np.repeat(np.arange(43, 90), 777), np.full(123, I32_MAX),
    ])
    a, b = np.sort(a.astype(np.int32)), np.sort(b.astype(np.int32))
    for exclude in (False, True):
        got = mp.ranged_merge_count_prepared(
            torch.from_numpy(a), torch.from_numpy(b), exclude
        )
        assert int(got) == _oracle(a, b, exclude)


def test_wrapper_rejects_bad_inputs():
    a = torch.arange(10, dtype=torch.int32)
    with pytest.raises(TypeError):
        mp.ranged_merge_count_prepared(a.to(torch.int64), a)
    with pytest.raises(TypeError):
        mp.ranged_merge_count_prepared(a.reshape(2, 5), a)
    with pytest.raises(ValueError):
        mp.ranged_merge_count_prepared(a, a[::2])
    with pytest.raises(ValueError):
        mp.ranged_merge_count_prepared(a, a.to("meta"))
    with pytest.raises(ValueError):
        mp.ranged_merge_count_prepared(a.to("meta"), a.to("meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No toolkit means an error, never a silent fallback."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_name_follows_source_hash():
    path = _build.library_path("merge_probe")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("merge_probe-") and path.suffix == ".so"
    assert path == _build.library_path("merge_probe")


def _merge_cases(tile, chunk):
    """The inputs that reach the branches of the CUDA kernel's merge in
    shared memory (``tile`` probe rows per block, ``chunk`` build rows per
    chunk), as chip_smoke.py builds them."""
    rng = np.random.default_rng(20260817)
    dense = np.arange(1, 2_000_001)
    return {
        "sparse_probe_many_chunks": (dense, dense[::50]),
        "dup_run_across_chunk_edge": (
            np.concatenate([np.arange(chunk - 3), np.full(9, chunk),
                            np.arange(chunk + 1, 3 * chunk)]),
            np.concatenate([np.arange(0, 3 * chunk, 3), np.full(50, chunk)]),
        ),
        "empty_range_amid_full": (
            np.concatenate([np.arange(10_000), np.arange(30_000, 40_000)]),
            np.concatenate([np.arange(tile), np.arange(10_001, 10_001 + tile),
                            np.arange(30_000, 30_000 + tile)]),
        ),
        "one_key_tiles": (
            np.concatenate([np.arange(100), np.full(3 * chunk, 500),
                            np.arange(501, 1000)]),
            np.concatenate([np.arange(100), np.full(2 * tile + 7, 500),
                            np.full(tile, 777), np.full(tile, 5000)]),
        ),
        "int32_max_at_chunk_edge": (
            np.concatenate([np.arange(chunk), np.full(20, I32_MAX)]),
            np.concatenate([np.arange(0, chunk, 2), np.full(5000, I32_MAX)]),
        ),
        "n_a_1": ([5], np.concatenate([np.full(3, 4), np.full(tile + 10, 5),
                                       np.full(7, 6)])),
        "ragged_last_tile": (rng.integers(0, 50_000, 20_000),
                             rng.integers(0, 60_000, 3 * tile + 1)),
    }


MERGE_CASES = _merge_cases(mp.TILE_ROWS, mp.CHUNK_ROWS)


def _sorted_i32(case):
    return (np.sort(np.asarray(x, np.int32)) for x in MERGE_CASES[case])


def _ranges(a, b, exclude):
    return mp.tile_ranges_plain(
        torch.from_numpy(a), torch.from_numpy(b), exclude
    ).numpy()


def check_tile_ranges(a, b, ranges, limit, tile):
    """Every build key a tile's rows can match first occurs in its range,
    the range holds only keys between the tile's first and last key, and
    it is empty exactly when no build key lies there."""
    a = a[:limit]
    assert ranges.shape == (-(-b.size // tile), 2)
    for t, (lo, hi) in enumerate(ranges):
        rows = b[t * tile : (t + 1) * tile]
        hits = rows[np.isin(rows, a)]
        first = np.searchsorted(a, hits, side="left")
        assert ((first >= lo) & (first < hi)).all()
        between = (a >= rows[0]) & (a <= rows[-1])
        assert (hi > lo) == bool(between.any())
        assert between[lo:hi].all()


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_cases_plain_matches_numpy(case, exclude):
    """The chip's merge cases: the plain version (the kernel's reference)
    and the tile ranges the kernel merges, against numpy."""
    a, b = _sorted_i32(case)
    got = mp.ranged_merge_count_prepared(
        torch.from_numpy(a), torch.from_numpy(b), exclude
    )
    assert int(got) == _oracle(a, b, exclude)
    limit = int(np.searchsorted(a, I32_MAX)) if exclude else a.size
    check_tile_ranges(a, b, _ranges(a, b, exclude), limit, mp.TILE_ROWS)
    assert mp.LAUNCHES == 0


def test_merge_cases_reach_their_branches():
    """Each merge case has the shape its name claims on the card."""
    tile, chunk = mp.TILE_ROWS, mp.CHUNK_ROWS
    size = lambda r: r[:, 1] - r[:, 0]  # noqa: E731
    a, b = _sorted_i32("sparse_probe_many_chunks")
    assert (size(_ranges(a, b, False)) > 30 * chunk).all()
    a, b = _sorted_i32("dup_run_across_chunk_edge")
    r = _ranges(a, b, False)
    assert r[0, 0] == 0 and r[0, 1] > 2 * chunk
    assert a[chunk - 1] == a[chunk] == chunk and (b == chunk).sum() == 50
    a, b = _sorted_i32("empty_range_amid_full")
    assert (size(_ranges(a, b, False)) > 0).tolist() == [True, False, True]
    a, b = _sorted_i32("one_key_tiles")
    for exclude in (False, True):
        r = _ranges(a, b, exclude)
        assert (b[tile : 2 * tile] == 500).all() and size(r)[1] == 1
        assert (b[-tile:] == 5000).all() and size(r)[-1] == 0
    a, b = _sorted_i32("int32_max_at_chunk_edge")
    assert a[chunk] == I32_MAX and a[chunk - 1] < I32_MAX
    assert size(_ranges(a, b, False))[0] == chunk + 1
    assert size(_ranges(a, b, True))[0] == chunk
    assert (b[tile - 1 : tile + 1] == I32_MAX).all()
    assert len(MERGE_CASES["n_a_1"][0]) == 1
    assert MERGE_CASES["ragged_last_tile"][1].size % tile == 1


def _jax_shaped_merge_cases():
    """Empty ranges amid full tiles and tiles of one key, at the (4,000,
    70,000) shape the JAX calls above have compiled."""
    rng = np.random.default_rng(7)
    return {
        "empty_ranges_amid_full": (
            np.concatenate([np.arange(2000), np.arange(30_000, 32_000)]),
            np.concatenate([rng.integers(0, 2000, 30_000),
                            np.arange(10_001, 20_001),
                            rng.integers(30_000, 32_000, 30_000)]),
        ),
        "one_key_tiles": (
            np.concatenate([np.arange(1000), np.full(2000, 1500),
                            np.arange(2000, 3000)]),
            np.concatenate([np.full(30_000, 1500), np.full(20_000, 2500),
                            np.full(20_000, 99_999)]),
        ),
    }


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("case", sorted(_jax_shaped_merge_cases()))
def test_merge_cases_match_jax_kernel(case, exclude):
    a, b = (np.sort(np.asarray(x, np.int32))
            for x in _jax_shaped_merge_cases()[case])
    assert (a.size, b.size) == (4000, 70000)
    got_jax = int(jax_mp.ranged_merge_count_prepared(
        jnp.asarray(a), jnp.asarray(b), exclude_int32_max=exclude,
        interpret=True,
    ))
    got = mp.ranged_merge_count_prepared(
        torch.from_numpy(a), torch.from_numpy(b), exclude
    )
    assert int(got) == got_jax == _oracle(a, b, exclude)


def test_chunk_and_scratch_sizes_follow_the_source():
    """CHUNK_ROWS / CHUNK_ROWS_I64 are the kernel's 16 KB chunks, and the
    scratch holds (lo, hi) per probe tile plus the limit."""
    src = (_build.CSRC_DIR / "merge_probe.cu").read_text()
    assert "constexpr int kChunk = 16384 / static_cast<int>(sizeof(Key));" in src
    assert "constexpr int kTile = kThreads * kRowsPerThread;" in src
    assert (mp.CHUNK_ROWS, mp.CHUNK_ROWS_I64) == (16384 // 4, 16384 // 8)
    t = mp.TILE_ROWS
    assert [mp.range_slots(n) for n in (1, t, t + 1, 3 * t)] == [3, 3, 5, 7]
