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


def _edge_blocks(k, seed):
    """One BLK-row block of k operands per case, each case with its own set
    of varying digits: a block sort that shared one digit plan across
    blocks, or skipped a digit that varies, would miss one of them."""
    r = _rng(seed)

    def full():
        return r.integers(I32_MIN, I32_MAX, BLK, dtype=np.int64,
                          endpoint=True).astype(np.int32)

    def const(v):
        return np.full(BLK, v, np.int32)

    def top_byte():
        low = np.int64(0x00ABCDEF)
        return ((r.integers(0, 256, BLK) << 24) | low).astype(np.uint32).view(np.int32)

    ends = np.asarray([I32_MIN, -1, 0, I32_MAX], np.int32)
    hot = r.random(BLK) < 0.9
    narrow = [r.integers(-2, 2, BLK).astype(np.int32) for _ in range(k - 1)]
    return {
        "one_tuple": [const(5 - c) for c in range(k)],
        "last_byte_0": [const(-c) for c in range(k - 1)]
        + [(0x12345600 | r.integers(0, 256, BLK)).astype(np.int32)],
        "sign_byte": [top_byte() for _ in range(k)],
        "int32_ends": [r.choice(ends, BLK) for _ in range(k)],
        "keys_1_to_10M": narrow + [r.integers(1, 10_000_001, BLK).astype(np.int32)],
        "narrow_leading": [r.integers(-3, 3, BLK).astype(np.int32)]
        + [full() for _ in range(k - 1)],
        "hot_90": [np.where(hot, 7, full()).astype(np.int32) for _ in range(k)],
        "all_max": [const(I32_MAX) for _ in range(k)],
    }


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_sort_blocks_edge_blocks(k):
    """The edge blocks side by side in one call: at k = 1 equal to JAX's
    block sort (at the 4-block shape it already compiles), at every k equal
    to a per-block np.lexsort."""
    cases = _edge_blocks(k, seed=70 + k)
    cols = [np.concatenate([c[i] for c in cases.values()]) for i in range(k)]
    got = [g.numpy() for g in bs.sort_blocks_tuple(*map(torch.from_numpy, cols))]
    for b, name in enumerate(cases):
        seg = slice(b * BLK, (b + 1) * BLK)
        for g, w in zip(got, _lexsorted([c[seg] for c in cols])):
            np.testing.assert_array_equal(g[seg], w, err_msg=name)
    if k == 1:
        want = np.concatenate([
            np.asarray(jax_bs.sort_blocks_i32(jnp.asarray(cols[0][s:s + 4 * BLK]),
                                              interpret=True))
            for s in range(0, cols[0].size, 4 * BLK)])
        np.testing.assert_array_equal(got[0], want)


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


# ---------------------------------------------------------------- int64 keys

I64_MIN = np.iinfo(np.int64).min
I64_MAX = np.iinfo(np.int64).max


def _i64_cases():
    """(name, keys, passes): keys in [1, 10M] vary in bytes 0-2 of the lo
    word only; full-domain keys with INT64_MIN and INT64_MAX in every byte;
    a constant column in none."""
    r = _rng(64)
    full = r.integers(I64_MIN, I64_MAX, 3 * BLK + 11, dtype=np.int64, endpoint=True)
    full[:6] = [I64_MIN, I64_MAX, -1, 0, 1, 2**32]
    return {
        "keys_1_to_10M": (r.integers(1, 10_000_001, 2 * BLK + 5).astype(np.int64),
                          ((1, 0), (1, 1), (1, 2))),
        "full_domain": (full, tuple(bs.digit_order(2))),
        "constant": (np.full(BLK + 3, -(2**40) + 7, np.int64), ()),
    }


@pytest.mark.parametrize("case", sorted(_i64_cases()))
def test_int64_plan_passes(case):
    """The int64 key's histograms are a (hi, lo) tuple's rows: the plan
    takes exactly the bytes that vary, lo word first, and stable sorts by
    those digits in its order give the int64 order."""
    keys, passes = _i64_cases()[case]
    x = torch.from_numpy(keys)
    hist = bs.radix_histograms_plain(x)
    assert hist.shape == (8, 256) and int(hist.sum()) == 8 * keys.size
    plan = bs.radix_plan(hist)
    assert plan.passes == passes
    for c, b in plan.passes:
        digit = ((x ^ bs.INT64_MIN) >> bs.i64_shift(c, b)) & 255
        x = x[torch.sort(digit, stable=True).indices]
    np.testing.assert_array_equal(x.numpy(), np.sort(keys))


def test_int64_histograms_count_biased_bytes():
    x = torch.tensor([I64_MIN, -1, 0, I64_MAX, 0x0102030405060708], dtype=torch.int64)
    hist = bs.radix_histograms_plain(x)
    # rows 0-3: bytes 4-7 (the hi word, biased); rows 4-7: bytes 0-3 (the lo
    # word, unbiased): INT64_MIN -> 0x00.., -1 -> 0x7f ff.., 0 -> 0x80 00..,
    # INT64_MAX -> 0xff.., 0x0102.. -> 0x8102030405060708
    assert hist[3].nonzero().flatten().tolist() == [0x00, 0x7F, 0x80, 0x81, 0xFF]
    assert hist[0, 0x04] == 1 and hist[4, 0x08] == 1 and hist[7, 0x05] == 1
    assert hist[4, 0xFF] == 2 and hist[4, 0x00] == 2


@pytest.mark.parametrize("n", [0, 1, BLK - 1, BLK + 1, 50_021])
def test_sort_i64_on_cpu_is_the_library_sort(n):
    x = torch.from_numpy(_rng(n).integers(I64_MIN, I64_MAX, n, dtype=np.int64,
                                          endpoint=True))
    got = bs.sort_i64(x)
    assert got.dtype == torch.int64
    assert torch.equal(got, torch.sort(x).values)
    with pytest.raises(TypeError):
        bs.sort_i64(x.to(torch.int32))
    if n > 1:
        with pytest.raises(ValueError):
            bs.sort_i64(x[::2])


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_key_sort_under_the_default_is_the_library_sort_on_cpu(dtype, monkeypatch):
    """``key_sort`` of a CPU tensor runs K6's plain version (``sort_i32`` or
    ``sort_i64``) and gives the library sort's answer, for both key
    widths."""
    from partitionedhashjoin_tpu_torch.ops import merge_join as mj

    calls = []
    name = "sort_i32" if dtype == torch.int32 else "sort_i64"
    real = getattr(bs, name)
    monkeypatch.setattr(bs, name, lambda x: calls.append(x.dtype) or real(x))
    info = torch.iinfo(dtype)
    x = torch.from_numpy(_rng(9).integers(info.min, info.max, 30_001,
                                          endpoint=True)).to(dtype)
    x[:2] = torch.tensor([info.min, info.max], dtype=dtype)
    got = mj.key_sort(x)
    assert got.dtype == dtype and torch.equal(got, torch.sort(x).values)
    assert calls == [dtype]
