"""The port's generators against the JAX package's, on the CPU.

- ``sequential_table``: exact.
- ``zipf_candidates`` on shared float32 uniforms: accept flags equal, samples
  equal on >= 99.9% with |diff| <= 2.  float32 ``pow`` rounds differently in
  XLA and PyTorch next to ``floor`` boundaries (measured on 2M candidates:
  1,179 samples differ at alpha 1.05 / cardinality 10M, 67 at 0.5 / 50K, 0 at
  1.5 / 1000, never by more than 2).
- ``zipf_keys``: JAX threefry and torch's generators never give the same
  bits, so both samplers are held to the true Zipf pmf by total-variation
  distance, with the bound tests/test_generators.py uses (0.035).
- ``zipf_keys_alias``: on the JAX package's own alias tables, both samplers
  are held to the pmf by the same bound, and to each other by 0.05 (two
  samples, each within 0.035 of the pmf).  The port draws the bin as an
  integer; a test fails if it comes from a float32 uniform.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from partitionedhashjoin_tpu.data import host_loader as jax_hl
from partitionedhashjoin_tpu.ops import generators as jax_gen
from partitionedhashjoin_tpu_torch.ops import generators as gen


def test_sequential_table_exact():
    for n, start in ((1000, 1), (777, -5)):
        t = gen.sequential_table(n, start=start, device="cpu")
        j = jax_gen.sequential_table(n, start=start)
        assert t.keys.dtype == torch.int32 and t.payloads.dtype == torch.int32
        np.testing.assert_array_equal(t.keys.numpy(), np.asarray(j.keys))
        np.testing.assert_array_equal(t.payloads.numpy(), np.asarray(j.payloads))
        assert t.get_size() == n and t.get_id() != j.get_id()


@pytest.mark.parametrize("alpha", [0.3, 0.995, 1.0, 1.05, 2.0])
def test_zipf_params_equal(alpha):
    assert gen._zipf_params(alpha, 10_000) == jax_gen._zipf_params(alpha, 10_000)


@pytest.mark.parametrize(
    "alpha,cardinality", [(1.05, 10_000_000), (0.5, 50_000), (1.5, 1000)]
)
def test_zipf_candidates_on_shared_uniforms(alpha, cardinality):
    rng = np.random.default_rng(cardinality)
    u1, u2 = rng.random((2, 400_000), dtype=np.float32)
    s_t, ok_t = gen.zipf_candidates(
        torch.from_numpy(u1), torch.from_numpy(u2), alpha, cardinality
    )
    s_j, ok_j = jax_gen.zipf_candidates(
        jnp.asarray(u1), jnp.asarray(u2), alpha, cardinality
    )
    s_j, ok_j = np.asarray(s_j), np.asarray(ok_j)
    assert s_t.dtype == torch.int32
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    diff = np.abs(s_t.numpy().astype(np.int64) - s_j)
    assert diff.max() <= 2
    assert (diff == 0).mean() >= 0.999
    assert s_t.min() >= 1 and s_t.max() <= cardinality


def test_zipf_candidates_dither_large_cardinality():
    """Above 2^24 the u3 dither spreads samples within their float32
    quantum; the port's bit arithmetic must give the JAX function's dither
    wherever the undithered samples agree."""
    card = 1 << 26
    rng = np.random.default_rng(9)
    u1, u2, u3 = rng.random((3, 200_000), dtype=np.float32)
    s0_t, _ = gen.zipf_candidates(torch.from_numpy(u1), torch.from_numpy(u2), 1.05, card)
    s0_j, _ = jax_gen.zipf_candidates(jnp.asarray(u1), jnp.asarray(u2), 1.05, card)
    s_t, _ = gen.zipf_candidates(
        torch.from_numpy(u1), torch.from_numpy(u2), 1.05, card, u3=torch.from_numpy(u3)
    )
    s_j, _ = jax_gen.zipf_candidates(
        jnp.asarray(u1), jnp.asarray(u2), 1.05, card, u3=jnp.asarray(u3)
    )
    same = s0_t.numpy() == np.asarray(s0_j)
    # more floor boundaries fall inside the range at 2^26: 99.86% measured
    assert same.mean() >= 0.995
    np.testing.assert_array_equal(s_t.numpy()[same], np.asarray(s_j)[same])
    assert s_t.max() <= card
    assert (s_t.numpy() % 2 == 1).any()  # odd keys above 2^24 are reachable


def _tv_to_zipf(keys, card, alpha):
    freq = np.bincount(keys, minlength=card + 1)[1:] / keys.size
    expected = np.arange(1, card + 1, dtype=np.float64) ** -alpha
    expected /= expected.sum()
    return 0.5 * np.abs(freq - expected).sum()


def test_zipf_keys_distribution_matches_jax_sampler():
    card, alpha, n = 1000, 1.05, 200_000
    g = torch.Generator().manual_seed(0)
    keys = gen.zipf_keys(n, alpha, card, generator=g, device="cpu").numpy()
    jkeys = np.asarray(jax_gen.zipf_keys(jax.random.PRNGKey(0), n, alpha, card))
    assert keys.shape == jkeys.shape == (n,)
    assert keys.min() >= 1 and keys.max() <= card
    assert _tv_to_zipf(keys, card, alpha) < 0.035
    assert _tv_to_zipf(jkeys, card, alpha) < 0.035


def test_zipf_keys_refill_loop_exact_count_and_range():
    n, card = 30_000, 1000
    g = torch.Generator().manual_seed(7)
    keys = gen.zipf_keys(n, 1.05, card, generator=g, device="cpu", oversample=0.01)
    assert keys.shape == (n,)
    assert int(keys.min()) >= 1 and int(keys.max()) <= card
    vals, counts = np.unique(keys.numpy(), return_counts=True)
    assert vals[np.argmax(counts)] == 1


def test_zipf_table_seeded_range_and_correction():
    t1 = gen.zipf_table(20_000, 1.05, (101, 600), seed=3, device="cpu")
    t2 = gen.zipf_table(20_000, 1.05, (101, 600), seed=3, device="cpu")
    assert torch.equal(t1.keys, t2.keys)
    assert int(t1.keys.min()) >= 101 and int(t1.keys.max()) <= 600
    assert torch.equal(t1.payloads, torch.arange(20_000, dtype=torch.int32))
    u = gen.zipf_table(20_000, 0.0, (1, 50), seed=3, device="cpu")  # Zipf(0) is uniform
    assert int(u.keys.min()) >= 1 and int(u.keys.max()) <= 50
    assert torch.unique(u.keys).numel() == 50


def test_zipf_table_validation():
    with pytest.raises(ValueError):
        gen.zipf_table(10, 1.05, (5, 5), seed=1, device="cpu")
    with pytest.raises(ValueError):
        gen.zipf_table(10, 0.001, (1, 100), seed=1, device="cpu")
    with pytest.raises(ValueError):
        gen.zipf_table(10, 1.05, (1, 100), seed=1, method="bogus", device="cpu")
    with pytest.raises(ValueError, match="2\\^24"):
        gen.zipf_table(10, 1.05, (1, (1 << 24) + 1), seed=1, method="alias",
                       device="cpu")
    with pytest.raises(ValueError):
        gen.zipf_table(10, 0.001, (1, 100), seed=1, method="alias", device="cpu")


def test_alias_sampler_distribution_matches_jax_sampler():
    """200K draws over [1, 1000] at alpha 1.05 from the JAX package's alias
    tables: the port's and JAX's samples against the pmf and each other."""
    card, alpha, n = 1000, 1.05, 200_000
    prob, alias = jax_hl.build_zipf_alias(alpha, card)
    g = torch.Generator().manual_seed(0)
    keys = gen.zipf_keys_alias(n, torch.from_numpy(prob), torch.from_numpy(alias),
                               generator=g, device="cpu").numpy()
    jkeys = np.asarray(jax_gen.zipf_keys_alias(
        jax.random.PRNGKey(0), n, jnp.asarray(prob), jnp.asarray(alias)))
    assert keys.dtype == np.int32 and keys.shape == jkeys.shape == (n,)
    assert keys.min() >= 1 and keys.max() <= card
    assert _tv_to_zipf(keys, card, alpha) < 0.035
    assert _tv_to_zipf(jkeys, card, alpha) < 0.035
    f = np.bincount(keys, minlength=card + 1) / n
    jf = np.bincount(jkeys, minlength=card + 1) / n
    assert 0.5 * np.abs(f - jf).sum() < 0.05


def test_alias_bin_is_not_a_float32_uniform():
    """With every bin kept (prob 1, alias = itself) a key is its bin + 1.  At
    card = 3 * 2^22 a bin floor(u * card) from a float32 uniform u (2^24
    values) puts half the mass on bins = 0 mod 3 (2^23 values: none on
    bins = 2 mod 3); an integer bin puts a third on each class."""
    card, n = 3 << 22, 60_000
    prob = torch.ones(card, dtype=torch.float32)
    alias = torch.arange(card, dtype=torch.int32)
    g = torch.Generator().manual_seed(11)
    keys = gen.zipf_keys_alias(n, prob, alias, generator=g, device="cpu")
    share = np.bincount((keys.numpy() - 1) % 3, minlength=3) / n
    np.testing.assert_allclose(share, 1 / 3, atol=0.02)
    assert int(keys.min()) >= 1 and int(keys.max()) <= card


def test_alias_table_range_correction_and_uniform():
    t1 = gen.zipf_table(20_000, 1.05, (101, 600), seed=3, method="alias", device="cpu")
    t2 = gen.zipf_table(20_000, 1.05, (101, 600), seed=3, method="alias", device="cpu")
    assert torch.equal(t1.keys, t2.keys) and t1.keys.dtype == torch.int32
    assert int(t1.keys.min()) >= 101 and int(t1.keys.max()) <= 600
    vals, counts = np.unique(t1.keys.numpy(), return_counts=True)
    assert vals[np.argmax(counts)] == 101  # the lo - 1 correction
    assert torch.equal(t1.payloads, torch.arange(20_000, dtype=torch.int32))
    t64 = gen.zipf_table(1000, 1.05, (101, 600), seed=3, method="alias",
                         dtype=torch.int64, device="cpu")
    assert t64.keys.dtype == torch.int64
    # alpha 0 keeps the uniform branch whatever the method
    u = gen.zipf_table(20_000, 0.0, (1, 50), seed=3, method="alias", device="cpu")
    assert torch.equal(u.keys, gen.uniform_table(20_000, (1, 50), seed=3,
                                                 device="cpu").keys)
    big = torch.empty((1 << 24) + 1, dtype=torch.float32)
    with pytest.raises(ValueError, match="2\\^24"):
        gen.zipf_keys_alias(10, big, big.view(torch.int32), torch.Generator(), "cpu")
