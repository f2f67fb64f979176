"""The port's host loader against the JAX package's, on the CPU.

Both bind the same C entries of ``native/phj_host.cpp``, so for the same
arguments (seed and worker count included) their outputs are bit-identical.
The port builds its own copy of the library into ``build/host/`` and never
writes into ``native/``.
"""

import numpy as np
import pytest

from partitionedhashjoin_tpu.data import host_loader as jax_hl
from partitionedhashjoin_tpu_torch.data import host_loader as hl


@pytest.mark.parametrize("n,start,workers", [(10_000, 7, 4), (4_999, -3, 1)])
def test_generate_sequential_identical(n, start, workers):
    keys, pay = hl.generate_sequential(n, start=start, workers=workers)
    j_keys, j_pay = jax_hl.generate_sequential(n, start=start, workers=workers)
    np.testing.assert_array_equal(keys, j_keys)
    np.testing.assert_array_equal(pay, j_pay)
    np.testing.assert_array_equal(keys, np.arange(start, start + n, dtype=np.int32))


@pytest.mark.parametrize("alpha,key_range,seed,workers", [
    (0.99, (1, 10), 123456789, 1),
    (1.25, (100, 200), 5, 4),
    (1.05, (1, 100_000), 20260816, 3),
])
def test_generate_zipf_identical(alpha, key_range, seed, workers):
    keys, pay = hl.generate_zipf(50_000, alpha, key_range, seed=seed, workers=workers)
    j_keys, j_pay = jax_hl.generate_zipf(50_000, alpha, key_range, seed=seed,
                                         workers=workers)
    np.testing.assert_array_equal(keys, j_keys)
    np.testing.assert_array_equal(pay, j_pay)
    assert keys.min() >= key_range[0] and keys.max() <= key_range[1]
    with pytest.raises(ValueError):
        hl.generate_zipf(10, alpha, (5, 5), seed=seed)


@pytest.mark.parametrize("alpha,card", [(1.05, 1000), (0.5, 77_777), (1.5, 2)])
def test_build_zipf_alias_identical(alpha, card):
    prob, alias = hl.build_zipf_alias(alpha, card)
    j_prob, j_alias = jax_hl.build_zipf_alias(alpha, card)
    assert prob.dtype == np.float32 and alias.dtype == np.int32
    np.testing.assert_array_equal(prob, j_prob)
    np.testing.assert_array_equal(alias, j_alias)
    # the tables encode the pmf: bin i keeps prob[i] / card for key i and
    # hands the rest to alias[i]
    mass = prob.astype(np.float64) / card
    np.add.at(mass, alias, (1.0 - prob.astype(np.float64)) / card)
    pmf = np.arange(1, card + 1, dtype=np.float64) ** -alpha
    np.testing.assert_allclose(mass, pmf / pmf.sum(), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("workers", [1, 3, 8])
def test_host_join_count_agrees(workers):
    rng = np.random.default_rng(3 + workers)
    build = rng.integers(-10_000, 10_000, 20_000, dtype=np.int32)
    probe = rng.integers(-10_000, 10_000, 80_000, dtype=np.int32)
    probe[:5] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0, 1, -1]
    got = hl.host_join_count(build, probe, workers=workers)
    assert got == jax_hl.host_join_count(build, probe, workers=workers)
    assert got == int(np.isin(probe, build).sum())


def test_library_is_built_outside_native():
    hl._load()
    path = hl.library_path()
    assert path.parent == hl.REPO_DIR / "build" / "host"
    assert path.exists() and path.name.startswith("libphjhost-")
    assert hl._lib._name == str(path)
    assert hl.SOURCE == hl.REPO_DIR / "native" / "phj_host.cpp"
    native = hl.REPO_DIR / "native"
    assert not [p.name for p in native.iterdir() if p.name.startswith("libphjhost-")]
    assert not [p.name for p in native.iterdir() if p.name.endswith(".tmp")]


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(hl, "BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(hl.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        hl.build()
    assert not (tmp_path / "host").exists()
