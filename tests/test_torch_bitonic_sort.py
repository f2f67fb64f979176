"""The port's tuple sort (K6's plain version on CPU tensors) against the JAX
package's Pallas sorter in interpret mode and against np.lexsort.

A full-tuple sort has exactly one correct output (ties are bit-identical
tuples), so every comparison is exact.  JAX runs only its one-operand
sorter here: its interpret-mode tuple sorts take 40 s (2 operands) to 126 s
(3 operands) to compile on a CPU, so wider tuples are held to np.lexsort,
which gives the same unique answer (the JAX package's own tests hold its
tuple sort to it).  Each interpret-mode program costs ~12 s to compile per
shape, so JAX calls reuse few padded shapes: every full sort pads to 3
blocks and takes JAX's XLA phase A (``phase_a="xla"``) before its Pallas
merge passes, since the Pallas block-sort network is held to the port on its
own in ``test_sort_blocks_matches_jax``.

The radix sort's host plan (``radix_plan``: digit order, skipped digits,
buffer parity) is checked here too; its kernels run only on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from partitionedhashjoin_tpu.ops.pallas import bitonic_sort as jax_bs
from partitionedhashjoin_tpu_torch.ops.kernels import bitonic_sort as bs

BLK = bs.BLK
I32_MIN = np.iinfo(np.int32).min
I32_MAX = np.iinfo(np.int32).max


def _rng(seed):
    return np.random.default_rng(seed)


def _lexsorted(cols):
    order = np.lexsort(tuple(reversed(cols)))  # last key most significant
    return [c[order] for c in cols]


def _sort_cases():
    """(name, keys) of the sort_i32 cases; every length pads to 3 blocks."""
    r = _rng(1)
    extremes = r.integers(-5, 5, 2 * BLK + 100).astype(np.int32)
    extremes[::97] = I32_MAX
    extremes[::89] = I32_MIN
    heavy = (r.zipf(1.3, 3 * BLK - 77) % 50).astype(np.int32)
    heavy[::2] = 7  # a run of equal keys longer than a block
    asc = np.arange(3 * BLK, dtype=np.int32) - BLK
    return {
        "extremes": extremes,
        "all_max": np.full(2 * BLK + 100, I32_MAX, np.int32),
        "heavy_duplicates": heavy,
        "full_domain": r.integers(I32_MIN, I32_MAX, 2 * BLK + 777,
                                  dtype=np.int64).astype(np.int32),
        "sorted": asc,
        "reversed": asc[::-1].copy(),
    }


@pytest.mark.parametrize("case", sorted(_sort_cases()))
def test_sort_i32_matches_jax(case):
    x = _sort_cases()[case]
    got = bs.sort_i32(torch.from_numpy(x))
    want = np.asarray(jax_bs.sort_i32_tuple(jnp.asarray(x), interpret=True,
                                            phase_a="xla")[0])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.sort(x))


def test_empty_and_tiny():
    z = torch.zeros((0,), dtype=torch.int32)
    assert bs.sort_i32(z).shape == (0,)
    out = bs.sort_i32_tuple(z, z.clone())
    assert [o.shape for o in out] == [(0,), (0,)]
    assert np.asarray(jax_bs.sort_i32(jnp.zeros((0,), jnp.int32))).shape == (0,)
    x = torch.tensor([3, I32_MAX, -1, I32_MIN], dtype=torch.int32)
    assert bs.sort_i32(x).tolist() == [I32_MIN, -1, 3, I32_MAX]


def _tuple_cases(k):
    """(name, columns) with k int32 operands: narrow leading operands, so
    ties carry down to the last; all-MAX rows next to the padding; a
    dominant tuple longer than a block."""
    r = _rng(10 + k)
    n = 3 * BLK + 77
    cols = [r.integers(-3, 3, n).astype(np.int32) for _ in range(k - 1)]
    cols.append(r.integers(I32_MIN, I32_MAX, n, dtype=np.int64).astype(np.int32))
    all_max = [r.integers(-2, 2, BLK + 100).astype(np.int32) for _ in range(k)]
    for c in all_max:
        c[::31] = I32_MAX
    for c in all_max[1:]:
        c[::62] = I32_MAX  # some rows are all-MAX, the padding tuple
    heavy = [np.where(r.random(6 * BLK + 4321) < 0.8, 7,
                      r.integers(-9, 9, 6 * BLK + 4321)).astype(np.int32)
             for _ in range(k)]
    return {"lexicographic": cols, "all_max_rows": all_max, "heavy": heavy,
            "one_row": [np.asarray([i], np.int32) for i in range(k)]}


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_tuple_sort_matches_lexsort(k):
    for name, cols in _tuple_cases(k).items():
        got = bs.sort_i32_tuple(*map(torch.from_numpy, cols))
        assert len(got) == k
        for g, w in zip(got, _lexsorted(cols)):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_key_value_association_exact():
    """Distinct keys: every (key, value) pair survives verbatim."""
    r = _rng(32)
    n = 2 * BLK + 13
    keys = (r.permutation(n) - n // 2).astype(np.int32)
    vals = (keys * 7 + 3).astype(np.int32)
    ks, vs = bs.sort_i32_tuple(torch.from_numpy(keys), torch.from_numpy(vals))
    np.testing.assert_array_equal(ks.numpy(), np.sort(keys))
    np.testing.assert_array_equal(vs.numpy(), ks.numpy() * 7 + 3)


def _blocks_input():
    """4 blocks whose equal-key runs cross block edges."""
    r = _rng(2)
    x = np.repeat(r.integers(-100, 100, 64), 4 * BLK // 64).astype(np.int32)
    x[::3] = r.integers(I32_MIN, I32_MAX, x[::3].size, dtype=np.int64)
    return x


def test_sort_blocks_matches_jax():
    x = _blocks_input()
    got = bs.sort_blocks_i32(torch.from_numpy(x))
    want = np.asarray(jax_bs.sort_blocks_i32(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want.reshape(4, BLK),
                                  np.sort(x.reshape(4, BLK), axis=1))


def _runs(n, run, values):
    """``values`` (n of them) with each ``run``-row segment sorted."""
    x = values.astype(np.int32).copy()
    for s in range(0, n, run):
        x[s:s + run].sort()
    return x


def _merge_cases():
    """(n, run_len, input) of the merge-pass cases: a pair of runs, runs of
    2 blocks, a dominant key whose tie runs cross every block and run edge,
    and an odd run count (the lone tail run copies through)."""
    r = _rng(3)
    skew = np.where(r.random(4 * BLK) < 0.7, 42, r.integers(-50, 50, 4 * BLK))
    return {
        "pairs": (4 * BLK, BLK, _runs(4 * BLK, BLK, r.integers(
            I32_MIN, I32_MAX, 4 * BLK, dtype=np.int64))),
        "two_block_runs": (4 * BLK, 2 * BLK, _runs(4 * BLK, 2 * BLK,
                                                   r.integers(-1000, 1000, 4 * BLK))),
        "skewed_ties": (4 * BLK, BLK, _runs(4 * BLK, BLK, skew)),
        "lone_tail_run": (3 * BLK, BLK, _runs(3 * BLK, BLK,
                                              r.integers(-1000, 1000, 3 * BLK))),
    }


@pytest.mark.parametrize("case", sorted(_merge_cases()))
def test_merge_pass_matches_jax(case):
    n, run, x = _merge_cases()[case]
    got = bs.merge_pass_i32(torch.from_numpy(x), run)
    want = np.asarray(jax_bs.merge_pass_i32(jnp.asarray(x), run, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    for s in range(0, n, 2 * run):
        np.testing.assert_array_equal(want[s:s + 2 * run], np.sort(x[s:s + 2 * run]))


def test_tuple_phases_match_lexsort():
    """Phase A and a merge pass on 3 operands, per block and per run pair."""
    r = _rng(4)
    n = 6 * BLK
    cols = [r.integers(-2, 2, n).astype(np.int32) for _ in range(3)]
    blocks = bs.sort_blocks_tuple(*map(torch.from_numpy, cols))
    for b in range(6):
        seg = slice(b * BLK, (b + 1) * BLK)
        for g, w in zip(blocks, _lexsorted([c[seg] for c in cols])):
            np.testing.assert_array_equal(g.numpy()[seg], w)
    merged = bs.merge_pass_tuple(*blocks, run_len=2 * BLK)  # lone tail pair
    for s in range(0, n, 4 * BLK):
        seg = slice(s, s + 4 * BLK)
        for g, w in zip(merged, _lexsorted([c[seg] for c in cols])):
            np.testing.assert_array_equal(g.numpy()[seg], w)


def test_contract_errors():
    x = torch.arange(BLK, dtype=torch.int32)
    with pytest.raises(ValueError):
        bs.sort_blocks_i32(x[:-1])  # not a block multiple
    with pytest.raises(ValueError):
        bs.merge_pass_i32(x, BLK // 2)  # run not a block multiple
    with pytest.raises(ValueError):
        bs.merge_pass_i32(x, 0)
    with pytest.raises(ValueError):
        bs.sort_i32_tuple(x, x[:-1])  # lengths differ
    with pytest.raises(TypeError):
        bs.sort_i32(x.long())
    with pytest.raises(ValueError):
        bs.sort_i32(torch.arange(2 * BLK, dtype=torch.int32)[::2])
    with pytest.raises(ValueError):
        bs.sort_i32_tuple()


# ---------------------------------------------------------------- radix plan


def _hist(*cols):
    return bs.radix_histograms_plain(*map(torch.from_numpy, cols))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_radix_digit_order(k):
    """Least significant digit first: the last operand's byte 0 first, the
    first operand's byte 3 last; every digit of a varied tuple runs."""
    order = bs.digit_order(k)
    assert order[0] == (k - 1, 0) and order[-1] == (0, 3)
    assert order == [(c, b) for c in range(k - 1, -1, -1) for b in range(4)]
    cols = [np.asarray([I32_MIN, -1, 0, 0x01020304, I32_MAX], np.int32)] * k
    plan = bs.radix_plan(_hist(*cols))
    assert list(plan.passes) == order


def _skip_cases():
    """(name, columns, the passes that must run)."""
    r = _rng(40)
    n = 5000
    keys = r.integers(1, 10_000_001, n).astype(np.int32)
    keys[:2] = [1, 10_000_000]
    pay = r.integers(0, 1 << 20, n).astype(np.int32)
    pay[:2] = [0, (1 << 20) - 1]
    low3 = [(0, 0), (0, 1), (0, 2)]
    return {
        "constant_operand": ([np.full(n, -7, np.int32), keys],
                             [(1, 0), (1, 1), (1, 2)]),
        "keys_1_to_10M": ([keys], low3),
        "payloads_below_2^20": ([pay], low3),
        "all_zero_flag": ([np.zeros(n, np.int32), keys, pay],
                          [(2, 0), (2, 1), (2, 2), (1, 0), (1, 1), (1, 2)]),
        "all_constant": ([np.full(n, 3, np.int32)] * 3, []),
    }


@pytest.mark.parametrize("case", sorted(_skip_cases()))
def test_radix_plan_skips_constant_digits(case):
    cols, want = _skip_cases()[case]
    plan = bs.radix_plan(_hist(*cols))
    assert list(plan.passes) == want


@pytest.mark.parametrize("passes", [1, 2, 3, 4, 7])
def test_radix_plan_buffer_parity(passes):
    """The buffers alternate and the last pass writes the output: an odd
    count starts in the output, an even one in the scratch set."""
    hist = torch.zeros((16, 256), dtype=torch.int64)
    hist[:, 0] = 1
    for c, b in bs.digit_order(4)[:passes]:
        hist[4 * c + b, 1] = 1  # a second bucket: this digit varies
    plan = bs.radix_plan(hist)
    assert len(plan.passes) == passes
    assert plan.targets[-1] == "out"
    assert plan.targets[0] == ("out" if passes % 2 else "tmp")
    assert all(a != b for a, b in zip(plan.targets, plan.targets[1:]))


def _extreme_tuples(k):
    r = _rng(50 + k)
    n = 3000
    cols = []
    for c in range(k):
        x = r.integers(-3, 3, n).astype(np.int32) if c < k - 1 else \
            r.integers(I32_MIN, I32_MAX, n, dtype=np.int64).astype(np.int32)
        x[::7] = I32_MIN
        x[::11] = I32_MAX
        x[::13] = -1
        cols.append(x)
    return cols


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_radix_plan_passes_sort_like_lexsort(k):
    """Stable sorts by the plan's digits, in its order, give np.lexsort's
    unique answer, INT32_MIN and INT32_MAX included."""
    cols = _extreme_tuples(k)
    ts = [torch.from_numpy(c) for c in cols]
    plan = bs.radix_plan(bs.radix_histograms_plain(*ts))
    assert plan.passes  # the inputs vary
    for c, b in plan.passes:
        order = torch.sort(bs.digits_plain(ts[c], b), stable=True).indices
        ts = [t[order] for t in ts]
    for g, w in zip(ts, _lexsorted(cols)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_radix_histograms_plain_counts_biased_bytes():
    x = torch.tensor([I32_MIN, -1, 0, I32_MAX, 0x01020304], dtype=torch.int32)
    hist = bs.radix_histograms_plain(x)
    assert hist.shape == (4, 256) and int(hist.sum()) == 4 * 5
    # biased: INT32_MIN -> 0x00000000, -1 -> 0x7fffffff, 0 -> 0x80000000,
    # INT32_MAX -> 0xffffffff, 0x01020304 -> 0x81020304
    assert hist[3].nonzero().flatten().tolist() == [0x00, 0x7F, 0x80, 0x81, 0xFF]
    assert hist[0, 0x04] == 1 and hist[0, 0xFF] == 2 and hist[0, 0x00] == 2
    with pytest.raises(ValueError):
        bs.radix_plan(torch.zeros((5, 256)))
