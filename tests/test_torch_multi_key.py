"""The port's composite-key counts against the JAX package's, on the CPU.

Oracles: Python ``Counter`` arithmetic over key TUPLES (any packing or
hashing collision would show), and the JAX package's plain-XLA programs
``_multi_key_count_xla`` / ``_multi_key_count_all_xla`` (the latter's
uint32 pair decoded with ``widesum.pair_to_int``).  k = 2 rides K3 through
``merge_join.two_run_count_i64`` (K6's int64 key sort, then K3); on the CPU
that is the kernels' plain versions.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu.ops import multi_key as jax_mk
from partitionedhashjoin_tpu.utils import widesum
from partitionedhashjoin_tpu_torch.ops import merge_join
from partitionedhashjoin_tpu_torch.ops import multi_key as mk

I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min


def _oracle(build_cols, probe_cols):
    """(count, count_all) over key tuples."""
    mult = Counter(zip(*[np.asarray(c).tolist() for c in build_cols]))
    probe = list(zip(*[np.asarray(c).tolist() for c in probe_cols]))
    return sum(1 for t in probe if t in mult), sum(mult[t] for t in probe)


def _t(cols):
    return [torch.from_numpy(np.asarray(c, np.int32)) for c in cols]


def _jax(cols):
    return tuple(jnp.asarray(np.asarray(c, np.int32)) for c in cols)


def _random_cols(rng, k, n, lo, hi):
    return [rng.integers(lo, hi, size=n).astype(np.int32) for _ in range(k)]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_counts_match_oracle_and_jax(k):
    rng = np.random.default_rng(100 + k)
    # a narrow domain duplicates tuples on both sides; the extremes ride along
    a = _random_cols(rng, k, 600, -4, 4)
    b = _random_cols(rng, k, 900, -4, 4)
    for c in a[:1] + b[:1]:
        c[:3] = [I32_MIN, I32_MAX, 0]
    count, count_all = _oracle(a, b)
    got = mk.multi_key_count(_t(a), _t(b))
    got_all = mk.multi_key_count_all(_t(a), _t(b))
    assert got.dtype == got_all.dtype == torch.int64 and got.ndim == got_all.ndim == 0
    assert int(got) == count
    assert int(got_all) == count_all
    assert int(jax_mk._multi_key_count_xla(_jax(a), _jax(b))) == count
    assert widesum.pair_to_int(
        jax_mk._multi_key_count_all_xla(_jax(a), _jax(b))) == count_all


def test_partial_tuple_matches_do_not_count():
    # rows agreeing on SOME columns but not all must not match
    a = [[1, 2, 3], [10, 20, 30], [7, 7, 7]]
    b = [[1, 2, 3], [99, 20, 31], [7, 7, 7]]
    assert int(mk.multi_key_count(_t(a[:2]), _t(b[:2]))) == 1
    assert int(mk.multi_key_count(_t(a), _t(b))) == 1
    assert int(mk.multi_key_count_all(_t(a), _t(b))) == 1
    # the k = 2 packing: equal high columns, low columns apart by 2^31 or 1
    a = [[5, 5, 5], [I32_MIN, 0, I32_MAX]]
    b = [[5, 5, 5, 4, 6], [0, I32_MAX - 1, -1, I32_MAX, I32_MIN]]
    assert int(mk.multi_key_count(_t(a), _t(b))) == 1


def test_extremes_in_both_columns():
    ext = [I32_MIN, I32_MIN + 1, -1, 0, 1, I32_MAX - 1, I32_MAX]
    pairs = [(x, y) for x in ext for y in ext]
    a = [np.array([p[0] for p in pairs[::2]]), np.array([p[1] for p in pairs[::2]])]
    b = [np.array([p[0] for p in pairs] * 2), np.array([p[1] for p in pairs] * 2)]
    count, count_all = _oracle(a, b)
    assert int(mk.multi_key_count(_t(a), _t(b))) == count == 50
    assert int(mk.multi_key_count_all(_t(a), _t(b))) == count_all
    assert int(jax_mk._multi_key_count_xla(_jax(a), _jax(b))) == count
    # one-to-one and ordered; (MAX, MAX) packs to INT64_MAX, K3's padding
    # key, whose genuine rows K3's closed-form correction counts
    packed = mk.pack_pair(*_t(b))
    assert int(mk.pack_pair(*_t([[I32_MAX], [I32_MAX]]))) == np.iinfo(np.int64).max
    assert int(mk.pack_pair(*_t([[I32_MIN], [I32_MIN]]))) == np.iinfo(np.int64).min
    assert torch.unique(packed).numel() == len(pairs)
    order = np.lexsort((b[1], b[0]))
    assert bool((packed[torch.from_numpy(order)].diff() >= 0).all())


def test_pair_rides_two_run_count_i64(monkeypatch):
    rng = np.random.default_rng(7)
    a = _random_cols(rng, 2, 3000, 0, 40)
    b = _random_cols(rng, 2, 5000, 0, 40)
    calls = []
    real = merge_join.two_run_count_i64

    def spy(build_keys, probe_keys):
        calls.append((build_keys.dtype, probe_keys.dtype))
        return real(build_keys, probe_keys)

    monkeypatch.setattr(merge_join, "two_run_count_i64", spy)
    got = int(mk.multi_key_count(_t(a), _t(b)))
    assert calls == [(torch.int64, torch.int64)]
    assert got == _oracle(a, b)[0]
    assert got == int(jax_mk._multi_key_count_xla(_jax(a), _jax(b)))


def test_empty_sides():
    e = [np.array([], np.int32)] * 2
    a = [np.array([1], np.int32), np.array([2], np.int32)]
    for build, probe in ((e, a), (a, e), (e, e)):
        for fn in (mk.multi_key_count, mk.multi_key_count_all):
            got = fn(_t(build), _t(probe))
            assert got.dtype == torch.int64 and got.ndim == 0 and int(got) == 0
    assert int(mk.multi_key_count(_t(e[:1]), _t(a[:1]))) == 0


def test_validation_errors_like_jax():
    a1 = np.array([1, 2], np.int32)
    cases = [
        (TypeError, [a1.astype(np.int64)], [a1]),
        (ValueError, [a1, a1], [a1]),  # k mismatch
        (ValueError, [], []),
        (ValueError, [a1, np.array([1], np.int32)], [a1, a1]),
    ]
    for exc, build, probe in cases:
        with pytest.raises(exc):
            jax_mk.multi_key_count(build, probe)
        with pytest.raises(exc):
            mk.multi_key_count([torch.from_numpy(c) for c in build],
                               [torch.from_numpy(c) for c in probe])
        with pytest.raises(exc):
            mk.multi_key_count_all([torch.from_numpy(c) for c in build],
                                   [torch.from_numpy(c) for c in probe])
    t = torch.from_numpy(a1)
    with pytest.raises(TypeError):
        mk.multi_key_count([t], [t.to(torch.uint64)])
    with pytest.raises(TypeError):  # the port refuses floats; JAX casts them
        mk.multi_key_count([t.to(torch.float32)], [t])
