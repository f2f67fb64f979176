"""The port's materializing joins against the JAX package, on the CPU.

- K4, ``ranged_merge_payload_prepared`` (its plain version on CPU tensors),
  against JAX's Pallas kernel in interpret mode: exact, duplicates included.
- ``two_run_materialize``: keys and ``pay_a`` row for row where build keys
  are unique; with ``probe_payload_sorted=True`` every column row for row;
  otherwise ``pay_b`` per key as a multiset (JAX's probe sort is unstable).
  With duplicate build keys each ``pay_a`` is a payload of its key (the
  port's is the earliest build row's).
- ``sort_merge_materialize_typed`` for every join type with and without
  validity masks, and ``SortMergeJoiner.run_materialize``: row for row.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from partitionedhashjoin_tpu.data.table import make_table as jax_table
from partitionedhashjoin_tpu.ops import merge_join as jax_mj
from partitionedhashjoin_tpu.ops import sort_merge as jax_sm
from partitionedhashjoin_tpu.ops.pallas.merge_probe import (
    ranged_merge_payload_prepared as jax_payload,
)
from partitionedhashjoin_tpu_torch.data.table import make_table
from partitionedhashjoin_tpu_torch.ops import merge_join, sort_merge
from partitionedhashjoin_tpu_torch.ops.kernels import merge_payload
from partitionedhashjoin_tpu_torch.ops.kernels.merge_probe import TILE_ROWS

I32_MIN = np.iinfo(np.int32).min
I32_MAX = np.iinfo(np.int32).max
JOIN_TYPES = ("inner", "semi", "anti", "left", "full")


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def _j(*arrays):
    return [jnp.asarray(x) for x in arrays]


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ------------------------------------------------------------------ K4


def _k4_cases():
    rng = np.random.default_rng(1)
    full_a = rng.integers(I32_MIN, I32_MAX, 2000, dtype=np.int64)
    full_b = rng.integers(I32_MIN, I32_MAX, 8192, dtype=np.int64)
    full_b[:3000] = rng.choice(full_a, 3000)
    full_a[::37] = I32_MAX
    full_a[::41] = I32_MIN
    full_b[::29] = I32_MAX
    full_b[::31] = I32_MIN
    # one duplicate run of 3 tiles: every probe of it takes the run's start
    giant = np.sort(np.concatenate([np.full(3 * TILE_ROWS + 100, 5),
                                    np.arange(-20, -10)]))
    return {
        "full_domain": (full_a, full_b),
        "dups_across_tiles": (giant, np.repeat([5, -15, 7], [9000, 3, 5])),
        "dup_runs_20k": (rng.integers(0, 2500, 3000),
                         rng.integers(0, 3000, 20000)),
    }


@pytest.mark.parametrize("case", sorted(_k4_cases()))
def test_payload_kernel_matches_jax(case):
    a, b = (np.sort(np.asarray(x, np.int32)) for x in _k4_cases()[case])
    a_pay = (np.arange(a.size, dtype=np.int32) * 7 + 1).astype(np.int32)
    excludes = (False, True) if case == "full_domain" else (False,)
    for exclude in excludes:
        want_pay, want_pos = jax_payload(*_j(a, a_pay, b),
                                         exclude_int32_max=exclude,
                                         interpret=True)
        pay, pos = merge_payload.ranged_merge_payload_prepared(
            *_t(a, a_pay, b), exclude_int32_max=exclude)
        assert pay.dtype == pos.dtype == torch.int32
        _eq(pos, want_pos)
        _eq(pay, want_pay)
        # the oracle: 1 + the first position of the key, 0 on a miss
        limit = np.searchsorted(a, I32_MAX) if exclude else a.size
        lb = np.searchsorted(a[:limit], b)
        hit = (lb < limit) & (a[np.minimum(lb, max(limit - 1, 0))] == b)
        _eq(pos, np.where(hit, lb + 1, 0))


def test_payload_kernel_first_position_and_empty_sides():
    a, a_pay, b = _t(np.array([3, 7, 7, 7, 9], np.int32),
                     np.array([30, 71, 72, 73, 90], np.int32),
                     np.array([4, 7, 7, 9], np.int32))
    pay, pos = merge_payload.ranged_merge_payload_prepared(a, a_pay, b)
    assert pos.tolist() == [0, 2, 2, 5] and pay.tolist() == [0, 71, 71, 90]
    z = torch.zeros((0,), dtype=torch.int32)
    pay, pos = merge_payload.ranged_merge_payload_prepared(z, z, b)
    assert pos.tolist() == [0] * 4 and pay.tolist() == [0] * 4
    pay, pos = merge_payload.ranged_merge_payload_prepared(a, a_pay, z)
    assert pos.shape == pay.shape == (0,)
    with pytest.raises(ValueError):
        merge_payload.ranged_merge_payload_prepared(a, a_pay[:3], b)
    with pytest.raises(TypeError):
        merge_payload.ranged_merge_payload_prepared(a.long(), a_pay, b)


# ------------------------------------------------------------------ two-run


def _per_key_multisets(keys, pay):
    order = np.lexsort((pay, keys))
    return keys[order], pay[order]


@pytest.mark.parametrize("n_a,n_b,key_hi,payload_sorted", [
    (4096, 16384, 4097, False), (1000, 9000, 2000, True),
])
def test_two_run_materialize_matches_jax(n_a, n_b, key_hi, payload_sorted):
    """Unique build keys; the first shape matches every probe row (no
    compaction), the second about half (even keys: compaction and zero
    tail)."""
    rng = np.random.default_rng(n_a)
    step = 1 if key_hi > n_a else 2
    a = rng.permutation(np.arange(1, n_a + 1, dtype=np.int32) * step)
    a_pay = rng.integers(0, 1000, n_a).astype(np.int32)
    b = rng.integers(1, key_hi, n_b).astype(np.int32)
    b_pay = rng.integers(-50, 50, n_b).astype(np.int32)
    want = [np.asarray(w) for w in jax_mj.two_run_materialize(
        *_j(a, a_pay, b, b_pay), interpret=True,
        probe_payload_sorted=payload_sorted)]
    keys, pa, pb, count = merge_join.two_run_materialize(
        *_t(a, a_pay, b, b_pay), probe_payload_sorted=payload_sorted)
    assert count.dtype == torch.int64 and count.dim() == 0
    c = int(count)
    assert c == int(want[3]) == int(np.isin(b, a).sum())
    _eq(keys, want[0])
    _eq(pa, want[1])
    if payload_sorted:
        _eq(pb, want[2])
    else:
        got_k, got_p = _per_key_multisets(keys.numpy()[:c], pb.numpy()[:c])
        want_k, want_p = _per_key_multisets(want[0][:c], want[2][:c])
        _eq(got_k, want_k)
        _eq(got_p, want_p)
    for col in (keys, pa, pb):
        assert col.dtype == torch.int32 and col.shape == (n_b,)
        assert not col[c:].any()


def test_two_run_materialize_duplicate_build_keys():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 400, 3000).astype(np.int32)
    a_pay = rng.integers(0, 10**6, 3000).astype(np.int32)
    b = rng.integers(0, 500, 20000).astype(np.int32)
    b_pay = rng.integers(0, 10**6, 20000).astype(np.int32)
    want = [np.asarray(w) for w in jax_mj.two_run_materialize(
        *_j(a, a_pay, b, b_pay), interpret=True, probe_payload_sorted=True)]
    keys, pa, pb, count = merge_join.two_run_materialize(
        *_t(a, a_pay, b, b_pay), probe_payload_sorted=True)
    c = int(count)
    assert c == int(want[3])
    _eq(keys, want[0])
    _eq(pb, want[2])
    # pay_a: a payload of the key in JAX; the earliest build row's here
    first = {}
    for k, p in zip(a.tolist(), a_pay.tolist()):
        first.setdefault(k, p)
    pays = {}
    for k, p in zip(a.tolist(), a_pay.tolist()):
        pays.setdefault(k, set()).add(p)
    for k, p_port, p_jax in zip(keys[:c].tolist(), pa[:c].tolist(),
                                want[1][:c].tolist()):
        assert p_port == first[k] and p_jax in pays[k]


def test_two_run_materialize_empty_and_int64():
    z = torch.zeros((0,), dtype=torch.int32)
    some = torch.arange(5, dtype=torch.int32)
    keys, pa, pb, count = merge_join.two_run_materialize(z, z, some, some)
    assert int(count) == 0 and keys.shape == (5,) and not keys.any()
    keys, pa, pb, count = merge_join.two_run_materialize(some, some, z, z)
    assert int(count) == 0 and keys.shape == (0,)
    with pytest.raises(TypeError):
        merge_join.two_run_materialize(some.long(), some, some, some)


# ------------------------------------------------------------------ typed


def _typed_inputs(seed=3, n_a=700, n_b=3000):
    rng = np.random.default_rng(seed)
    a = rng.integers(-60, 60, n_a).astype(np.int32)
    b = rng.integers(-80, 80, n_b).astype(np.int32)
    a[::53] = I32_MIN
    b[::47] = I32_MIN
    a[::59] = I32_MAX
    b[::61] = I32_MAX
    a_pay = rng.integers(1, 10**6, n_a).astype(np.int32)
    b_pay = rng.integers(1, 10**6, n_b).astype(np.int32)
    av = rng.random(n_a) < 0.7
    bv = rng.random(n_b) < 0.8
    return a, a_pay, b, b_pay, av, bv


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("join_type", JOIN_TYPES)
def test_materialize_typed_matches_jax(join_type, masked):
    a, a_pay, b, b_pay, av, bv = _typed_inputs()
    masks = (av, bv) if masked else (None, None)
    want = jax_sm.sort_merge_materialize_typed(
        *_j(a, a_pay, b, b_pay), join_type,
        *[None if m is None else jnp.asarray(m) for m in masks])
    got = sort_merge.sort_merge_materialize_typed(
        *_t(a, a_pay, b, b_pay), join_type,
        *[None if m is None else torch.from_numpy(m) for m in masks])
    assert int(got[4]) == int(want[4])
    for g, w in zip(got[:4], want[:4]):
        assert g.shape == np.asarray(w).shape
        _eq(g, w)


def test_match_probe_rows_latest_build_row():
    a, a_pay, b, _, av, _ = _typed_inputs(seed=4)
    for valid in (None, av):
        ok = np.ones(a.size, bool) if valid is None else valid
        latest = {}
        for row, (k, v) in enumerate(zip(a.tolist(), ok.tolist())):
            if v:
                latest[k] = row
        hit, row, pay = sort_merge._match_probe_rows(
            *_t(a, b), torch.from_numpy(a_pay),
            build_valid=None if valid is None else torch.from_numpy(valid))
        want_row = np.array([latest.get(k, -1) for k in b.tolist()])
        _eq(hit, want_row >= 0)
        _eq(row, np.maximum(want_row, 0))
        _eq(pay, np.where(want_row >= 0, a_pay[np.maximum(want_row, 0)], 0))


def test_materialize_int64_keys_match_jax():
    rng = np.random.default_rng(5)
    a = rng.integers(-(2**40), 2**40, 500, dtype=np.int64)
    b = rng.integers(-(2**40), 2**40, 2000, dtype=np.int64)
    b[:900] = rng.choice(a, 900)
    b[900:1000] = rng.choice(a, 100) + 2**32  # same low word, another key
    a_pay = np.arange(500, dtype=np.int64) * 3
    b_pay = np.arange(2000, dtype=np.int64)
    with jax.enable_x64(True):
        want = [np.asarray(w) for w in jax_sm.sort_merge_materialize(
            *_j(a, a_pay, b, b_pay))]
    got = sort_merge.sort_merge_materialize(*_t(a, a_pay, b, b_pay))
    assert int(got[3]) == int(want[3])
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.int64
        _eq(g, w)


def test_run_materialize_both_orders_match_jax():
    # the shapes of test_two_run_materialize_matches_jax's first case, so
    # JAX's interpret-mode kernel is compiled once for both
    rng = np.random.default_rng(6)
    a = np.arange(1, 4097, dtype=np.int32)
    a_pay = (a ^ 0x5A17).astype(np.int32)
    b = rng.integers(1, 5001, 16384).astype(np.int32)
    b_pay = np.arange(16384, dtype=np.int32)
    ja, jb = jax_table(*_j(a, a_pay)), jax_table(*_j(b, b_pay))
    ta, tb = make_table(*_t(a, a_pay)), make_table(*_t(b, b_pay))
    joiner = sort_merge.SortMergeJoiner()
    for join_type in ("inner", "anti"):
        want = jax_sm._materialize_typed(ja.keys, ja.payloads, jb.keys,
                                         jb.payloads, join_type)
        got = joiner.run_materialize(ta, tb, join_type=join_type)
        assert int(got.count) == int(want[4])
        for g, w in zip((got.keys, got.payloads_a, got.payloads_b, got.matched),
                        want[:4]):
            _eq(g, w)
    # order="key": the kernel path (JAX runs it only on a Mosaic backend)
    want = jax_mj.two_run_materialize(ja.keys, ja.payloads, jb.keys,
                                      jb.payloads, interpret=True)
    got = joiner.run_materialize(ta, tb, order="key")
    assert got.matched is None and int(got.count) == int(want[3])
    _eq(got.keys, want[0])
    _eq(got.payloads_a, want[1])
    with pytest.raises(ValueError):
        joiner.run_materialize(ta, tb, join_type="anti", order="key")
    with pytest.raises(ValueError):
        joiner.run_materialize(ta, tb, order="nope")
    with pytest.raises(ValueError):
        joiner.run_materialize(make_table(*_t(a.astype(np.int64), a_pay)), tb,
                               order="key")
