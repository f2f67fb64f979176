"""The port's stream compaction (K5's plain version on CPU tensors) against
the JAX package's Pallas kernel in interpret mode and a numpy oracle.

``block_compact`` may leave sentinel gaps (``pos == -1``) of < 128 rows per
block in JAX; the port's output has none, so its ``aligned_total`` is the
kept count and its prefix equals JAX's with the sentinels dropped.
``compact_columns`` is compared exactly: count, ``ok`` where JAX fits, and
every output row.  JAX's interpret-mode kernel compiles once per shape
(seconds), so its calls share one shape: 2 blocks, no carried column (``pos``
holds the whole permutation); the columns are held to numpy.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from partitionedhashjoin_tpu.ops.pallas import compact as jax_compact
from partitionedhashjoin_tpu_torch.ops.kernels import compact as kc

BLK = kc.BLK
N_JAX = 2 * BLK


def _keep(n, density, seed):
    return np.random.default_rng(seed).random(n) < density


@pytest.mark.parametrize("density", [0.0, 0.01, 0.5, 1.0])
def test_block_compact_matches_jax(density):
    keep = _keep(N_JAX, density, 10)
    want_total, want_pos = jax_compact.block_compact(
        jnp.asarray(keep), interpret=True)
    total, pos = kc.block_compact(torch.from_numpy(keep))
    want_pos = np.asarray(want_pos)[: int(want_total)]
    want_pos = want_pos[want_pos >= 0]
    assert total.dtype == torch.int64 and int(total) == keep.sum()
    assert pos.shape == (N_JAX + BLK,) and pos.dtype == torch.int32
    np.testing.assert_array_equal(pos[: int(total)].numpy(), want_pos)
    np.testing.assert_array_equal(want_pos, np.flatnonzero(keep))


@pytest.mark.parametrize("density,capacity", [
    (0.01, None), (0.5, None), (1.0, None), (0.0, None),
    (0.3, 100), (0.02, 1000), (1.0, 50),
])
def test_compact_columns_matches_jax(density, capacity):
    keep = _keep(N_JAX, density, 11)
    want = jax_compact.compact_columns(jnp.asarray(keep), capacity=capacity,
                                       interpret=True)
    count, ok, pos = kc.compact_columns(torch.from_numpy(keep),
                                        capacity=capacity)
    want_count, want_ok, want_pos = (np.asarray(w) for w in want)
    assert int(count) == int(want_count) == keep.sum()
    assert pos.shape == want_pos.shape
    cap_bound = pos.shape[0]
    assert bool(ok) == (keep.sum() <= cap_bound)
    if bool(want_ok):
        assert bool(ok)
        np.testing.assert_array_equal(pos.numpy(), want_pos)
    # the port's exact contract: the first kept rows, then zeros
    live = min(int(count), cap_bound)
    np.testing.assert_array_equal(pos[:live].numpy(), np.flatnonzero(keep)[:live])
    assert not pos[live:].any()


@pytest.mark.parametrize("n_cols", [1, 2, 3, 4, 5, 6])
def test_columns_ride_with_pos(n_cols):
    n = 3 * BLK
    rng = np.random.default_rng(n_cols)
    keep = rng.random(n) < 0.4
    cols = [rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
            for _ in range(n_cols)]
    t_cols = [torch.from_numpy(c) for c in cols]
    total, pos, *outs = kc.block_compact(torch.from_numpy(keep), *t_cols)
    c = int(total)
    assert c == keep.sum() and len(outs) == n_cols
    np.testing.assert_array_equal(pos[:c].numpy(), np.flatnonzero(keep))
    for out, col in zip(outs, cols):
        assert out.shape == (n + BLK,)
        np.testing.assert_array_equal(out[:c].numpy(), col[keep])
    count, ok, pos2, *outs2 = kc.compact_columns(
        torch.from_numpy(keep), *t_cols, capacity=777)
    assert int(count) == c and not bool(ok)
    live = pos2.shape[0]
    for out, col in zip(outs2, cols):
        np.testing.assert_array_equal(out.numpy(), col[keep][:live])


def test_kept_rows_on_tile_edges():
    n = 2 * BLK
    keep = np.zeros(n, bool)
    t = kc.TILE_ROWS
    keep[[0, t - 1, t, t + 1, 2 * t - 1, 2 * t, n - 1]] = True
    vals = np.arange(n, dtype=np.int32) * 3
    count, ok, pos, out = kc.compact_columns(torch.from_numpy(keep),
                                             torch.from_numpy(vals))
    assert int(count) == 7 and bool(ok)
    np.testing.assert_array_equal(pos[:7].numpy(), np.flatnonzero(keep))
    np.testing.assert_array_equal(out[:7].numpy(), vals[keep])
    assert not out[7:].any()


def test_rejects_bad_inputs():
    keep = torch.ones(BLK, dtype=torch.bool)
    col = torch.zeros(BLK, dtype=torch.int32)
    with pytest.raises(ValueError):
        kc.block_compact(keep, *([col] * (kc.MAX_COLS + 1)))
    with pytest.raises(ValueError):
        kc.block_compact(torch.ones(BLK + 1, dtype=torch.bool))
    with pytest.raises(TypeError):
        kc.block_compact(keep, col.to(torch.int64))
    with pytest.raises(TypeError):
        kc.block_compact(keep.to(torch.int32), col)
    with pytest.raises(TypeError):
        kc.compact_columns(keep, col[: BLK // 2])
    with pytest.raises(ValueError):
        kc.block_compact(torch.ones(2 * BLK, dtype=torch.bool)[::2], col)


@pytest.mark.parametrize("n,out_len", [
    (BLK + 77, BLK + 77), (BLK + 77, 100), (5000, 6000), (0, 3),
])
def test_compact_rows_any_length(n, out_len):
    """``compact_rows`` (what the port's operators call) takes any n and
    output length: the first kept rows in order, then zeros."""
    rng = np.random.default_rng(n + out_len)
    keep = rng.random(n) < 0.3
    col = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    count, pos, out = kc.compact_rows(torch.from_numpy(keep),
                                      [torch.from_numpy(col)], out_len)
    live = min(int(keep.sum()), out_len)
    assert int(count) == keep.sum() and out.shape == pos.shape == (out_len,)
    np.testing.assert_array_equal(pos[:live].numpy(), np.flatnonzero(keep)[:live])
    np.testing.assert_array_equal(out[:live].numpy(), col[keep][:live])
    assert not out[live:].any() and not pos[live:].any()


def test_compact_plain_keeps_column_dtypes():
    rng = np.random.default_rng(12)
    keep = rng.random(3000) < 0.5
    wide = rng.integers(-(2**62), 2**62, 3000, dtype=np.int64)
    real = rng.standard_normal(3000)
    count, pos, w, r = kc.compact_plain(
        torch.from_numpy(keep), [torch.from_numpy(wide), torch.from_numpy(real)],
        3000)
    c = int(count)
    assert w.dtype == torch.int64 and r.dtype == torch.float64
    np.testing.assert_array_equal(w[:c].numpy(), wide[keep])
    np.testing.assert_array_equal(r[:c].numpy(), real[keep])
    assert not w[c:].any() and not r[c:].any()
