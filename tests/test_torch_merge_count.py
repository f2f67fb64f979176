"""The port's fused merge count (K2) and sort-merge counts against the JAX
package, on the CPU.

``merge_count_sorted`` on CPU tensors runs its plain PyTorch version; it
must equal the JAX Pallas kernel (interpret mode) exactly on the cases of
tests/test_pallas_kernels.py.  ``sort_merge_count``, ``anti_count`` and
``sort_merge_count_all`` must equal the JAX functions on the same numpy
inputs: masked and unmasked, int32 and int64 (JAX under x64), including
keys equal to the dtype minimum (the fast path's correction).  JAX's
``sort_merge_count_all`` returns a (hi, lo) uint32 pair, compared through
``widesum.pair_to_int``; the port returns an int64 scalar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu.ops import sort_merge as jax_sm
from partitionedhashjoin_tpu.ops.pallas import merge_count as jax_mc
from partitionedhashjoin_tpu.utils.widesum import pair_to_int
from partitionedhashjoin_tpu_torch.ops import sort_merge as sm
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
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_plain_matches_jax_kernel(case):
    keys, is_build = KERNEL_CASES[case]()
    want = int(jax_mc.merge_count_sorted(
        jnp.asarray(keys), jnp.asarray(is_build), interpret=True
    ))
    got = mc.merge_count_sorted(torch.from_numpy(keys), torch.from_numpy(is_build))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want
    tags = torch.from_numpy(is_build.astype(np.uint8))
    assert int(mc.merge_count_sorted(torch.from_numpy(keys), tags)) == want
    assert mc.LAUNCHES == 0  # CPU tensors never reach the kernel


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
