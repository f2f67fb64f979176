"""The port's two-run count join against the JAX package, on the CPU.

Same numpy inputs into ``partitionedhashjoin_tpu.ops.merge_join`` (Pallas
kernel in interpret mode) and ``partitionedhashjoin_tpu_torch.ops.merge_join``
(the kernel's plain version on CPU tensors).  All counts must be equal
exactly, including the INT32_MAX validity protocol.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from partitionedhashjoin_tpu.ops import merge_join as jax_mj
from partitionedhashjoin_tpu_torch.ops import merge_join as mj

I32_MAX = np.iinfo(np.int32).max


def _both(*arrays):
    return [jnp.asarray(x) for x in arrays], [torch.from_numpy(x) for x in arrays]


def _random_keys():
    rng = np.random.default_rng(11)
    a = rng.integers(-(2**31), 2**31 - 1, 3000, dtype=np.int64).astype(np.int32)
    b = rng.integers(-(2**31), 2**31 - 1, 66000, dtype=np.int64).astype(np.int32)
    b[:30000] = rng.choice(a, 30000)
    a[::301] = I32_MAX
    b[::503] = I32_MAX
    return a, b


def test_two_run_count_matches_jax():
    a, b = _random_keys()
    (ja, jb), (ta, tb) = _both(a, b)
    got = mj.two_run_count(ta, tb)
    assert got.dtype == torch.int64 and got.dim() == 0
    want = int(jax_mj.two_run_count(ja, jb, interpret=True))
    assert int(got) == want == int(np.isin(b, a).sum())


def test_validity_masks_with_int32_max_match_jax():
    # tests/test_merge_probe.py::test_two_run_count_validity_masks_with_int32_max
    a = np.asarray([I32_MAX, 5, 9, I32_MAX, 77], np.int32)
    av = np.asarray([True, True, False, False, True])
    b = np.tile(np.asarray([I32_MAX, 9, 5, 77, I32_MAX, 3], np.int32), 11000)
    bv = np.tile(np.asarray([True, True, False, True, False, True]), 11000)
    jax_args, torch_args = _both(a, b, av, bv)
    want = int(jax_mj.two_run_count(*jax_args, interpret=True))
    assert int(mj.two_run_count(*torch_args)) == want == 22000


def test_random_validity_masks_match_jax_and_oracle():
    rng = np.random.default_rng(23)
    a, b = _random_keys()
    av = rng.random(a.size) < 0.9
    bv = rng.random(b.size) < 0.8
    jax_args, torch_args = _both(a, b, av, bv)
    valid_build = set(a[av].tolist())
    oracle = sum(1 for k, v in zip(b.tolist(), bv.tolist()) if v and k in valid_build)
    want = int(jax_mj.two_run_count(*jax_args, interpret=True))
    assert int(mj.two_run_count(*torch_args)) == want == oracle


def test_prepared_build_many_probes_match_jax():
    a, b = _random_keys()
    jax_pb = jax_mj.PreparedBuild(jnp.asarray(a), interpret=True)
    pb = mj.PreparedBuild(torch.from_numpy(a))
    for probe in (b, b[::-1].copy(), np.roll(b, 17)):
        want = int(jax_pb.count(jnp.asarray(probe)))
        assert int(pb.count(torch.from_numpy(probe))) == want


def test_prepared_build_from_numpy_carries_jax_state():
    """A JAX PreparedBuild's state (a_sorted, max_in_a) goes across as
    numpy and probes to the same counts, with and without probe masks."""
    rng = np.random.default_rng(5)
    a, b = _random_keys()
    av = rng.random(a.size) < 0.7
    bv = rng.random(b.size) < 0.6
    jax_pb = jax_mj.PreparedBuild(jnp.asarray(a), jnp.asarray(av), interpret=True)
    pb = mj.PreparedBuild.from_numpy(
        np.asarray(jax_pb.a_sorted), np.asarray(jax_pb.max_in_a), "cpu"
    )
    assert pb.a_sorted.dtype == torch.int32
    assert bool(pb.max_in_a) == bool(jax_pb.max_in_a)
    assert int(pb.count(torch.from_numpy(b))) == int(jax_pb.count(jnp.asarray(b)))
    assert int(pb.count(torch.from_numpy(b), torch.from_numpy(bv))) == int(
        jax_pb.count(jnp.asarray(b), jnp.asarray(bv))
    )
    own = mj.PreparedBuild(torch.from_numpy(a), torch.from_numpy(av))
    assert torch.equal(own.a_sorted, pb.a_sorted)


def test_sorted_runs_count_matches_jax():
    a, b = (np.sort(x) for x in _random_keys())
    want = int(jax_mj.sorted_runs_count(jnp.asarray(a), jnp.asarray(b),
                                        interpret=True))
    assert int(mj.sorted_runs_count(torch.from_numpy(a), torch.from_numpy(b))) == want


def test_empty_sides():
    one = torch.tensor([1, 2], dtype=torch.int32)
    none = torch.zeros((0,), dtype=torch.int32)
    assert int(mj.two_run_count(none, one)) == 0
    assert int(mj.two_run_count(one, none)) == 0
    assert int(mj.PreparedBuild(none).count(one)) == 0
    assert int(mj.PreparedBuild(one).count(none)) == 0


def test_int64_keys_raise():
    """The int32 path never truncates 64-bit keys: two_run_count and an
    int32 PreparedBuild raise on them (int64 keys take two_run_count_i64 and
    an int64 PreparedBuild, tests/test_torch_merge_probe_i64.py), as do
    validity masks on an int64 build and state of other dtypes."""
    k64 = torch.arange(4, dtype=torch.int64)
    k32 = torch.arange(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="two_run_count_i64"):
        mj.two_run_count(k64, k32)
    with pytest.raises(TypeError, match="two_run_count_i64"):
        mj.two_run_count(k32, k64)
    with pytest.raises(TypeError):
        mj.PreparedBuild(k32).count(k64)
    with pytest.raises(TypeError):
        mj.PreparedBuild(k64, torch.ones(4, dtype=torch.bool))
    with pytest.raises(TypeError):
        mj.PreparedBuild.from_numpy(np.arange(4, dtype=np.int16), False, "cpu")
