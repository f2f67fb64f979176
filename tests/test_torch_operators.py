"""The port's filter, sort, radix sort, ORDER BY and top-k against the JAX
package, on the CPU.

Same numpy inputs into ``partitionedhashjoin_tpu.ops.{filter,sort,order_by}``
and ``partitionedhashjoin_tpu_torch.ops.{filter,sort,order_by}``; every
output must be equal exactly (all are integer), ties included.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from partitionedhashjoin_tpu.data.table import make_table as jax_table
from partitionedhashjoin_tpu.ops import filter as jax_filter
from partitionedhashjoin_tpu.ops import order_by as jax_order_by
from partitionedhashjoin_tpu.ops import sort as jax_sort
from partitionedhashjoin_tpu_torch.data.table import make_table
from partitionedhashjoin_tpu_torch.ops import filter as filter_ops
from partitionedhashjoin_tpu_torch.ops import order_by, sort

I32_MIN = np.iinfo(np.int32).min
I32_MAX = np.iinfo(np.int32).max


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _tables(keys, pay):
    return (jax_table(jnp.asarray(keys), jnp.asarray(pay)),
            make_table(torch.from_numpy(keys), torch.from_numpy(pay)))


def _columns(n=5000, seed=0, lo=-50, hi=50):
    rng = np.random.default_rng(seed)
    keys = rng.integers(lo, hi, n).astype(np.int32)
    keys[::97] = I32_MIN
    keys[::89] = I32_MAX
    pay = rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64).astype(np.int32)
    return keys, pay


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_compact_and_compact_sort_match_jax(density):
    keys, pay = _columns(seed=1)
    mask = np.random.default_rng(2).random(keys.size) < density
    for name in ("compact", "compact_sort"):
        want = getattr(jax_filter, name)(jnp.asarray(mask), jnp.asarray(keys),
                                         jnp.asarray(pay))
        got = getattr(filter_ops, name)(torch.from_numpy(mask),
                                        torch.from_numpy(keys),
                                        torch.from_numpy(pay))
        assert got[0].dtype == torch.int64 and int(got[0]) == int(want[0])
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == torch.int32
            _eq(g, w)


@pytest.mark.parametrize("zero_tail", [True, False])
def test_filter_table_matches_jax(zero_tail):
    keys, pay = _columns(seed=3)
    jt, tt = _tables(keys, pay)
    want_t, want_n = jax_filter.filter_table(
        jt, lambda k, p: (p & 1) == 0, zero_tail=zero_tail)
    got_t, got_n = filter_ops.filter_table(
        tt, lambda k, p: (p & 1) == 0, zero_tail=zero_tail)
    assert int(got_n) == int(want_n) == int(((pay & 1) == 0).sum())
    _eq(got_t.keys, want_t.keys)
    _eq(got_t.payloads, want_t.payloads)


def test_empty_filter():
    z = torch.zeros((0,), dtype=torch.int32)
    count, out = filter_ops.compact(torch.zeros((0,), dtype=torch.bool), z)
    assert int(count) == 0 and out.shape == (0,)


def test_sort_table_matches_jax_stable():
    keys, pay = _columns(seed=4)
    jt, tt = _tables(keys, pay)
    want = jax_sort.sort_table(jt)
    got = sort.sort_table(tt)
    _eq(got.keys, want.keys)
    _eq(got.payloads, want.payloads)  # stable: equal keys keep row order
    _eq(sort.sort_by_key(torch.from_numpy(keys)), np.sort(keys, kind="stable"))


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_radix_sort_matches_jax_full_range(bits):
    keys, pay = _columns(n=4000, seed=5, lo=I32_MIN, hi=I32_MAX)
    want = jax_sort.radix_sort(jnp.asarray(keys), jnp.asarray(pay),
                               bits_per_pass=bits)
    got = sort.radix_sort(torch.from_numpy(keys), torch.from_numpy(pay),
                          bits_per_pass=bits)
    assert got[0].dtype == torch.int32
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    order = np.argsort(keys, kind="stable")
    _eq(got[0], keys[order])
    _eq(got[1], pay[order])


def test_radix_sort_table_and_bad_bits():
    keys, pay = _columns(seed=6)
    jt, tt = _tables(keys, pay)
    want = jax_sort.radix_sort_table(jt)
    got = sort.radix_sort_table(tt)
    _eq(got.keys, want.keys)
    _eq(got.payloads, want.payloads)
    with pytest.raises(ValueError):
        sort.radix_sort(torch.from_numpy(keys), bits_per_pass=5)


@pytest.mark.parametrize("by", ["key", "payload"])
@pytest.mark.parametrize("descending", [False, True])
def test_order_by_matches_jax(by, descending):
    # few distinct values: many ties, which must keep ascending row order
    keys, _ = _columns(seed=7, lo=-3, hi=3)
    pay = np.random.default_rng(8).integers(-4, 4, keys.size).astype(np.int32)
    pay[::50] = I32_MIN
    jt, tt = _tables(keys, pay)
    want = jax_order_by.order_by(jt, by=by, descending=descending)
    got = order_by.order_by(tt, by=by, descending=descending)
    _eq(got.keys, want.keys)
    _eq(got.payloads, want.payloads)


@pytest.mark.parametrize("k", [1, 10, 333])
@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("by", ["key", "payload"])
def test_top_k_matches_jax_ties_by_lowest_index(k, descending, by):
    keys, _ = _columns(seed=9, lo=0, hi=5)
    pay = np.arange(keys.size, dtype=np.int32)[::-1].copy()
    pay[::7] = 3
    jt, tt = _tables(keys, pay)
    want = jax_order_by.top_k(jt, k, by=by, descending=descending)
    got = order_by.top_k(tt, k, by=by, descending=descending)
    _eq(got.keys, want.keys)
    _eq(got.payloads, want.payloads)


def test_order_by_and_top_k_validation():
    tt = make_table(torch.arange(5, dtype=torch.int32),
                    torch.arange(5, dtype=torch.int32))
    with pytest.raises(ValueError):
        order_by.order_by(tt, by="nope")
    for k in (0, 6):
        with pytest.raises(ValueError):
            order_by.top_k(tt, k)
    ft = make_table(torch.zeros(3), torch.zeros(3))
    with pytest.raises(TypeError):
        order_by.order_by(ft)
