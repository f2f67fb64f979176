"""The port's chained hash table and chained no-partitioning join on int64
keys, against a plain PyTorch reference on the CPU.

The JAX package's hash layer is 32-bit, so these hold the port to the join's
semantics alone: a probe row counts once if its key is among the build keys
(``torch.isin``), ``Get`` returns the first build row that holds the key
(chains keep build-row order), and ``GetAll`` the key's multiplicity.  The
reference below imports no JAX and no kernel of the port.  Every case has
keys that differ only above bit 31, so a table that narrowed its keys to 32
bits would count, find and multiply them wrongly.
"""

import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu_torch.config import NoPartitioningConfiguration
from partitionedhashjoin_tpu_torch.data.table import make_table
from partitionedhashjoin_tpu_torch.ops import hash_table as ht
from partitionedhashjoin_tpu_torch.ops import hashing
from partitionedhashjoin_tpu_torch.ops.kernels import chained_probe as kcp
from partitionedhashjoin_tpu_torch.ops.kernels import generate as gen
from partitionedhashjoin_tpu_torch.ops.no_partitioning import (
    NoPartitioningHashJoiner,
)

torch.set_num_threads(1)

I64_MAX = np.iinfo(np.int64).max
I64_MIN = np.iinfo(np.int64).min
SEED = 0x5EED1234


def _key_cases():
    rng = np.random.default_rng(21)
    base = rng.integers(-(2**31), 2**31, 700)
    high = np.concatenate([base, base + 2**32, base - 2**32])  # lo words equal
    wide = rng.integers(I64_MIN, I64_MAX, 2500, dtype=np.int64)
    wide[:4] = [I64_MIN, I64_MAX, -1, 0]
    dups = rng.integers(-40, 40, 3000) * (2**33 + 1)  # ~38 rows a key
    i32 = np.concatenate([rng.integers(-(2**31), 2**31, 1500),
                          rng.integers(-(2**31), 2**31, 500) + 2**32])
    return {
        # build k, k + 2^32, k - 2^32; probe them, and the lo words alone
        "high_words": (high, np.concatenate(
            [high[::2], base + 2**33, base ^ (1 << 62), rng.permutation(base)])),
        # negative keys, INT64_MIN and INT64_MAX, with misses beside them
        "extremes": (wide, np.concatenate(
            [wide[::3], wide[:8] ^ (1 << 40), [I64_MIN, I64_MAX, I64_MIN + 1,
                                               I64_MAX - 1]])),
        # duplicate build keys: long chains, multiplicities above 1
        "duplicates": (dups, np.concatenate(
            [dups[::7], np.arange(-50, 50) * (2**33 + 1), np.arange(-50, 50)])),
        # probe keys that nearly all miss
        "misses": (wide[:900], rng.integers(I64_MIN, I64_MAX, 4000,
                                            dtype=np.int64)),
        "empty_build": (np.zeros(0, np.int64), wide[:50]),
        # an int32 probe of an int64 build (some build keys past int32)
        "i32_probe": (i32, np.concatenate(
            [i32[:1500:2], rng.integers(-(2**31), 2**31, 800)]).astype(np.int32)),
    }


KEY_CASES = _key_cases()


def _tensors(case):
    build, probe = KEY_CASES[case]
    return (torch.from_numpy(np.asarray(build, np.int64)),
            torch.from_numpy(np.asarray(probe)))


# ------------------------------------------------------- plain reference


def ref_found(build, probe):
    """Probe rows whose key is among the build keys, compared at int64."""
    return torch.isin(probe.to(torch.int64), build)


def ref_first_row(build, probe):
    """The smallest build row holding each probe key, -1 where none."""
    first = {}
    for row, key in enumerate(build.tolist()):
        first.setdefault(key, row)
    return torch.tensor([first.get(k, -1) for k in probe.tolist()],
                        dtype=torch.int32)


def ref_multiplicity(build, probe):
    """Build rows holding each probe key."""
    mult = {}
    for key in build.tolist():
        mult[key] = mult.get(key, 0) + 1
    return torch.tensor([mult.get(k, 0) for k in probe.tolist()],
                        dtype=torch.int32)


# ------------------------------------------------------------- the table


def test_high_word_cases_differ_only_above_bit_31():
    build = KEY_CASES["high_words"][0]
    assert np.unique(build).size == build.size == 3 * np.unique(build & 0xFFFFFFFF).size


@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_chained_build_i64(case):
    build, _ = _tensors(case)
    nb = ht.chained_num_buckets(build.numel())
    table = ht.build_chained(build, SEED, nb)
    assert table.entry_keys.dtype == torch.int64
    rows = table.entry_rows.to(torch.int64)
    assert torch.equal(torch.sort(rows).values, torch.arange(build.numel()))
    assert torch.equal(table.entry_keys, build[rows])
    # every entry lies in the chain of its key's bucket, chains in row order
    want = (hashing.hash64_pair(*hashing.split64(build), SEED).to(torch.int64)
            & (nb - 1))
    counts = torch.bincount(want, minlength=nb)
    assert torch.equal(table.offsets.to(torch.int64),
                       torch.cat([torch.zeros(1, dtype=torch.int64),
                                  torch.cumsum(counts, 0)]))
    assert torch.equal(want[rows], torch.sort(want, stable=True).values)
    assert int(table.max_chain) == (int(counts.max()) if build.numel() else 0)


@pytest.mark.parametrize("num_chunks", [1, 3])
@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_chained_probes_i64(case, num_chunks):
    build, probe = _tensors(case)
    table = ht.build_chained(build, SEED, ht.chained_num_buckets(build.numel()))
    found = ref_found(build, probe)
    assert int(ht.probe_chained_count(table, probe, num_chunks)) == int(found.sum())
    got_found, got_row = ht.probe_chained_get(table, probe)
    assert torch.equal(got_found, found)
    assert torch.equal(got_row, ref_first_row(build, probe))
    assert torch.equal(ht.probe_chained_count_all(table, probe),
                       ref_multiplicity(build, probe))


@pytest.mark.parametrize("skip", [0, 1, 37])
@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_chained_count_plain_matches_window_scan_i64(case, skip):
    """The chained-probe kernel's plain version counts what the plain
    reference finds, on K7's hashes under the table's mask, as the port's
    count probe does."""
    build, probe = _tensors(case)
    table = ht.build_chained(build, SEED, ht.chained_num_buckets(build.numel()))
    hashes = ht.hash_bits(ht._probe_keys(table, probe)[1], table.seed)
    got = kcp.chained_count_plain(probe, hashes, table.num_buckets - 1,
                                  table.offsets, table.entry_keys, skip)
    assert got.dtype == torch.int64 and got.dim() == 0
    want = ht._probe_chained_count_chunk(table, probe, skip=skip)
    assert int(got) == int(want) == int(ref_found(build, probe)[skip:].sum())


def test_int64_probe_of_int32_table():
    """An int64 probe of an int32 table compares at int64: a key past int32
    whose low word is a build key finds nothing."""
    build = torch.arange(-500, 500, 3, dtype=torch.int32)
    wide = build.to(torch.int64)
    probe = torch.cat([wide, wide + 2**32, wide - 2**32, wide + 1])
    table = ht.build_chained(build, SEED, ht.chained_num_buckets(build.numel()))
    assert table.entry_keys.dtype == torch.int32
    found = ref_found(wide, probe)
    assert int(ht.probe_chained_count(table, probe)) == int(found.sum()) == wide.numel()
    got_found, got_row = ht.probe_chained_get(table, probe)
    assert torch.equal(got_found, found)
    assert torch.equal(got_row, ref_first_row(wide, probe))
    assert torch.equal(ht.probe_chained_count_all(table, probe),
                       ref_multiplicity(wide, probe))


def test_chained_key_widths():
    wide = torch.tensor([2**40, -(2**40), 7], dtype=torch.int64)
    for keys, want in ((wide, torch.int64), (wide.view(torch.uint64), torch.int64),
                       (torch.tensor([1, 2], dtype=torch.int16), torch.int32),
                       (torch.tensor([1, 2], dtype=torch.int32), torch.int32)):
        assert ht.build_chained(keys, 1, 4).entry_keys.dtype == want
    table = ht.build_chained(wide.view(torch.uint64), 1, 4)
    assert int(ht.probe_chained_count(table, wide)) == 3
    for bad in (torch.tensor([1.0, 2.0]), torch.tensor([True, False])):
        with pytest.raises(TypeError, match="integers"):
            ht.build_chained(bad, 1, 4)
        with pytest.raises(TypeError, match="integers"):
            ht.probe_chained_count(table, bad)
    # the dedup table keeps int64 keys too
    assert ht.build_dedup_hash_table(wide, 1, 4)[0].slot_keys.dtype == torch.int64


def test_int32_chained_table_runs_the_int32_hash(monkeypatch):
    """An int32 table hashes int32 keys with K7's int32 form, as before;
    an int64 one with its int64 form."""
    seen = []
    real = gen.hash_keys
    monkeypatch.setattr(gen, "hash_keys",
                        lambda k, s: seen.append(k.dtype) or real(k, s))
    keys = torch.arange(64, dtype=torch.int32)
    table = ht.build_chained(keys, 3, 64)
    ht.probe_chained_count(table, keys)
    assert seen == [torch.int32, torch.int32]
    assert table.entry_keys.dtype == torch.int32
    seen.clear()
    table = ht.build_chained(keys.to(torch.int64), 3, 64)
    ht.probe_chained_count(table, keys)
    assert seen == [torch.int64, torch.int64]


# ------------------------------------------------------------- the joiner


@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_no_partitioning_chained_i64(case):
    build, probe = _tensors(case)
    pay_a = build * 3 + 1
    pay_b = torch.arange(probe.numel(), dtype=torch.int64) - 2**40
    joiner = NoPartitioningHashJoiner(NoPartitioningConfiguration(mode="chained"),
                                      seed=SEED)
    table_a, table_b = make_table(build, pay_a), make_table(probe, pay_b)
    found = ref_found(build, probe)
    assert joiner.run(table_a, table_b) == int(found.sum())
    joined = joiner.run_materialize(table_a, table_b)
    n = int(found.sum())
    assert int(joined.count) == n
    first = ref_first_row(build, probe)[found].to(torch.int64)
    assert torch.equal(joined.keys[:n], probe[found])
    assert joined.keys.dtype == probe.dtype
    assert torch.equal(joined.payloads_a[:n], pay_a[first])
    assert torch.equal(joined.payloads_b[:n], pay_b[found])
    assert not joined.keys[n:].any() and not joined.payloads_b[n:].any()


# ------------------------------------------------------------------- K7


@pytest.mark.parametrize("seed", [0, 42, 2**32 - 1])
def test_hash_keys_i64_is_hash64_pair(seed):
    keys = torch.from_numpy(KEY_CASES["extremes"][0])
    got = gen.hash_keys(keys, seed)
    assert got.dtype == torch.uint32 and got.shape == keys.shape
    assert torch.equal(got, hashing.hash64_pair(*hashing.split64(keys), seed))
    # the high word moves the hash
    assert not torch.equal(gen.hash_keys(keys ^ (1 << 45), seed), got)
    assert gen.hash_keys(keys[:0], seed).shape == (0,)
