"""The port's hashing and generation kernels against the JAX package, on the
CPU.

- ``ops/hashing.py`` against JAX ``ops/hashing.py``, bitwise, over the int32
  domain's edges and random keys, for several seeds.
- ``hash_keys`` (K7's plain version on CPU tensors) against JAX
  ``generate.hash_keys(interpret=True)`` at the shapes of
  tests/test_pallas_generate.py, including n = 0.
- ``zipf_keys_pallas`` (K8's plain version on the CPU).  The JAX kernel
  needs the TPU's hardware generator and cannot run here, and the port draws
  from Philox instead, so the keys are held to the JAX test's distribution
  criterion (TV distance < 0.035 from the exact pmf); the Philox generator
  is held to the published known-answer vectors.  A slot's key and
  uniforms depend on the seed, the slot and the round alone, so the first m
  of n keys (or uniforms) are the m drawn alone: the property the CUDA
  kernel's schedule relies on.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from partitionedhashjoin_tpu.ops import hashing as jax_hashing
from partitionedhashjoin_tpu.ops.pallas import generate as jax_gen
from partitionedhashjoin_tpu_torch.ops import generators, hashing
from partitionedhashjoin_tpu_torch.ops.kernels import generate as gen

I32_MIN = np.iinfo(np.int32).min
I32_MAX = np.iinfo(np.int32).max
SEEDS = [0, 1, 42, 0x9E3779B9, 2**32 - 1]

# One intra-op thread per process: the suite runs in several pytest-xdist
# workers on shared cores, where torch's default of one thread per core
# oversubscribes them (the plain Philox version's many small elementwise
# ops slowed from 0.1 s to 28 s).  Each worker imports every test module,
# so this holds for all the port's CPU tests of a run.
torch.set_num_threads(1)


def _keys():
    rng = np.random.default_rng(0)
    edges = np.asarray([I32_MIN, I32_MIN + 1, -1, 0, 1, I32_MAX - 1, I32_MAX],
                       np.int32)
    rand = rng.integers(I32_MIN, I32_MAX, 50_000, dtype=np.int64).astype(np.int32)
    return np.concatenate([edges, rand, np.arange(-5000, 5000, dtype=np.int32)])


@pytest.mark.parametrize("seed", SEEDS)
def test_hash32_and_fmix32_bitwise(seed):
    keys = _keys()
    got = hashing.hash32(torch.from_numpy(keys), seed)
    assert got.dtype == torch.uint32
    want = np.asarray(jax_hashing.hash32(jnp.asarray(keys), seed))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        hashing.fmix32(torch.from_numpy(keys)).numpy(),
        np.asarray(jax_hashing.fmix32(jnp.asarray(keys).astype(jnp.uint32))))
    # uint32 keys hash like their int32 bit patterns
    np.testing.assert_array_equal(
        hashing.hash32(torch.from_numpy(keys.view(np.uint32)), seed).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_hash64_pair_bucket_and_vector_hasher_bitwise(seed):
    keys = _keys()
    lo, hi = keys, np.roll(keys, 1)
    np.testing.assert_array_equal(
        hashing.hash64_pair(torch.from_numpy(lo), torch.from_numpy(hi), seed).numpy(),
        np.asarray(jax_hashing.hash64_pair(jnp.asarray(lo), jnp.asarray(hi), seed)))
    h = jax_hashing.hash32(jnp.asarray(keys), seed)
    for card in (1, 64, 100, 2**31 - 1):
        np.testing.assert_array_equal(
            hashing.bucket(torch.from_numpy(np.array(h)), card).numpy(),
            np.asarray(jax_hashing.bucket(h, card)))
    jax_hasher = jax_hashing.VectorHasher()  # a random seed, carried over
    port = hashing.VectorHasher(seed=jax_hasher.seed)
    assert port.seed == jax_hasher.seed
    np.testing.assert_array_equal(port.hash_bits(torch.from_numpy(keys)).numpy(),
                                  np.asarray(jax_hasher.hash_bits(jnp.asarray(keys))))
    for card in (64, 100):
        got = port.hash(torch.from_numpy(keys), card)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_hasher.hash(jnp.asarray(keys), card)))


def test_split64_and_bad_cardinality():
    k = np.asarray([0, 1, -1, 2**63 - 1, -(2**63), 5 << 32, (7 << 32) - 3], np.int64)
    with jax.enable_x64(True):
        want_lo, want_hi = map(np.asarray, jax_hashing.split64(jnp.asarray(k)))
    for keys in (torch.from_numpy(k), torch.from_numpy(k).to(torch.uint64)):
        lo, hi = hashing.split64(keys)
        assert lo.dtype == hi.dtype == torch.uint32
        np.testing.assert_array_equal(lo.numpy(), want_lo)
        np.testing.assert_array_equal(hi.numpy(), want_hi)
    with pytest.raises(ValueError):
        hashing.bucket(torch.tensor([1]), 0)
    a, b = hashing.VectorHasher(), hashing.VectorHasher()
    assert 0 <= a.seed < 2**32 and a.seed != b.seed


@pytest.mark.parametrize("n", [50_000, 0])
def test_hash_keys_matches_jax_kernel(n):
    keys = np.random.default_rng(0).integers(I32_MIN, I32_MAX, n,
                                             dtype=np.int64).astype(np.int32)
    got = gen.hash_keys(torch.from_numpy(keys), 42)
    want = np.asarray(jax_gen.hash_keys(jnp.asarray(keys), 42, interpret=True))
    assert got.dtype == torch.uint32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_hash_keys_rejects_bad_inputs():
    wide = torch.arange(4, dtype=torch.int64)  # int64 keys hash by their two words
    assert torch.equal(gen.hash_keys(wide, 1),
                       hashing.hash64_pair(*hashing.split64(wide), 1))
    with pytest.raises(TypeError):
        gen.hash_keys(torch.arange(4, dtype=torch.float32), 1)
    with pytest.raises(TypeError):
        gen.hash_keys(torch.arange(4, dtype=torch.int16), 1)
    with pytest.raises(ValueError):
        gen.hash_keys(torch.arange(8, dtype=torch.int32)[::2], 1)


def test_philox_known_answers():
    """Philox4x32-10 against the known-answer vectors of its authors'
    Random123 distribution (counter, key → output)."""
    mask = 2**32 - 1
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((mask,) * 4, (mask, mask), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        got = gen.philox4x32_10(*(torch.tensor([c]) for c in ctr), *key)
        assert [int(w) for w in got] == list(want)


def test_uniforms_are_23_bit_and_slot_addressed():
    u1, u2, u3 = gen.philox_uniforms(5, 1000, 2, device="cpu")
    for u in (u1, u2, u3):
        assert u.dtype == torch.float32 and u.shape == (1000,)
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
        np.testing.assert_array_equal((u.numpy() * 2**23) % 1, 0)  # 23 bits
    # a slot's uniforms depend on (seed, slot, round) only
    part = gen.philox_uniforms_plain(5, torch.arange(500, 1000), 2)
    for whole, sub in zip((u1, u2, u3), part):
        assert torch.equal(whole[500:], sub)
    other = gen.philox_uniforms(5, 1000, 3, device="cpu")[0]
    assert float((other == u1).float().mean()) < 0.01


def test_zipf_keys_pallas_distribution():
    """tests/test_pallas_generate.py's criterion: TV distance < 0.035 from
    the exact Zipf pmf at card 500, n 200,000."""
    card, alpha, n = 500, 1.05, 200_000
    keys = gen.zipf_keys_pallas(7, n, alpha, card, device="cpu")
    assert keys.dtype == torch.int32 and keys.shape == (n,)
    k = keys.numpy()
    assert k.min() >= 1 and k.max() <= card
    freq = np.bincount(k, minlength=card + 1)[1:] / n
    expected = np.arange(1, card + 1, dtype=np.float64) ** -alpha
    expected /= expected.sum()
    assert 0.5 * np.abs(freq - expected).sum() < 0.035
    assert torch.equal(gen.zipf_keys_pallas(7, n, alpha, card, device="cpu"), keys)
    assert not torch.equal(gen.zipf_keys_pallas(8, n, alpha, card, device="cpu"), keys)


def test_zipf_rounds_and_first_accept():
    """A slot that never accepts gets key 1; with rounds, each slot takes
    the sample of its first accepted round, as zipf_candidates computes it."""
    assert (gen.zipf_keys_pallas(3, 5000, 1.05, 1000, rounds=0,
                                 device="cpu") == 1).all()
    keys = gen.zipf_keys_plain(3, 5000, 1.05, 1000, rounds=1, device="cpu")
    u1, u2, u3 = gen.philox_uniforms(3, 5000, 0, device="cpu")
    sample, ok = generators.zipf_candidates(u1, u2, 1.05, 1000, u3=u3)
    assert 0.9 < float(ok.float().mean()) < 1.0
    assert torch.equal(keys, torch.where(ok, sample, 1))
    with pytest.raises(ValueError):
        gen.zipf_keys_pallas(3, 10, 0.001, 1000, device="cpu")


@pytest.mark.parametrize("m", [1, 33, 2_047, 4_099])
def test_zipf_keys_plain_prefix(m):
    n = 5_000
    whole = gen.zipf_keys_plain(9, n, 1.05, 10_000_000, device="cpu")
    assert torch.equal(gen.zipf_keys_plain(9, m, 1.05, 10_000_000, device="cpu"),
                       whole[:m])


@pytest.mark.parametrize("round_", [0, 7])
@pytest.mark.parametrize("m", [1, 2_047])
def test_philox_uniforms_plain_prefix(m, round_):
    whole = gen.philox_uniforms_plain(9, torch.arange(5_000), round_)
    for w, part in zip(whole, gen.philox_uniforms_plain(9, torch.arange(m), round_)):
        assert torch.equal(part, w[:m])
