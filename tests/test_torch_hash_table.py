"""The port's hash tables (``ops/hash_table.py``) and radix fan-out
(``ops/radix.py``) against the JAX package's, on the CPU.

The same numpy inputs go through both; every integer output is held bit for
bit: the open-addressing table's ``slot_keys``, ``slot_rows``, ``max_probe``
and ``overflowed``, the dedup table's ``rep_row``, the chained table's
``entry_keys``, ``entry_rows``, ``offsets`` and ``max_chain``, every count,
``found`` and ``first_row``, and the partitioned keys, payloads, row ids,
histograms and offsets.  No Pallas is involved: JAX computes these with XLA
ops.  Inputs stay at <= 4,096 rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu.ops import hash_table as jht
from partitionedhashjoin_tpu.ops import radix as jradix
from partitionedhashjoin_tpu_torch.ops import hash_table as ht
from partitionedhashjoin_tpu_torch.ops import radix
from partitionedhashjoin_tpu_torch.ops.kernels import chained_probe as kcp
from partitionedhashjoin_tpu_torch.ops.kernels import generate as kgen

import test_torch_chained_probe

torch.set_num_threads(1)

I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min
TABLE_FIELDS = ("slot_keys", "slot_rows", "max_probe", "overflowed")
CHAINED_FIELDS = ("entry_keys", "entry_rows", "offsets", "max_chain")
PART_FIELDS = ("keys", "payloads", "row_ids", "histogram", "offsets")


def _key_cases():
    rng = np.random.default_rng(11)
    extremes = rng.integers(I32_MIN, I32_MAX, 3000, dtype=np.int64).astype(np.int32)
    extremes[:40] = I32_MAX
    extremes[40:70] = I32_MIN
    extremes[70:75] = 0
    zipf = np.minimum(rng.zipf(1.3, 4096), 50).astype(np.int32)  # head ~1,900 rows
    return {
        "extremes": (extremes, np.concatenate(
            [extremes[::3], rng.integers(I32_MIN, I32_MAX, 2000, dtype=np.int64)
             .astype(np.int32), [I32_MAX, I32_MIN]]).astype(np.int32)),
        "zipf_head": (zipf, np.arange(-5, 60, dtype=np.int32).repeat(40)),
        "random": (rng.integers(-2000, 2000, 2500).astype(np.int32),
                   rng.integers(-2500, 2500, 4096).astype(np.int32)),
        "empty_build": (np.zeros(0, np.int32), np.arange(-3, 3, dtype=np.int32)),
        "empty_probe": (np.arange(10, dtype=np.int32), np.zeros(0, np.int32)),
    }


KEY_CASES = _key_cases()


def _eq(want, got, fields):
    for f in fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert w.dtype == g.dtype and np.array_equal(w, g), f


def _same(want, got):
    assert np.array_equal(np.asarray(want), got.numpy())


def _probe_all(jtable, table, probe):
    jp, tp = jnp.asarray(probe), torch.from_numpy(probe)
    _same(jht.probe_exists(jtable, jp), ht.probe_exists(table, tp))
    for w, g in zip(jht.probe_get(jtable, jp), ht.probe_get(table, tp)):
        _same(w, g)
    _same(jht.probe_count_all(jtable, jp), ht.probe_count_all(table, tp))


@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_open_addressing_matches_jax(case):
    build, probe = KEY_CASES[case]
    size = ht.table_size_for(build.size)
    assert size == jht.table_size_for(build.size)
    jtable = jht.build_hash_table(jnp.asarray(build), jnp.uint32(0xDEADBEEF), size)
    table = ht.build_hash_table(torch.from_numpy(build), 0xDEADBEEF, size)
    _eq(jtable, table, TABLE_FIELDS)
    _probe_all(jtable, table, probe)


@pytest.mark.parametrize("ratio", [1.0, 1.25])
def test_high_load_and_valid_mask_match_jax(ratio):
    build = KEY_CASES["random"][0]
    probe = KEY_CASES["random"][1]
    valid = np.random.default_rng(2).random(build.size) < 0.7
    size = ht.table_size_for(build.size, ratio)
    jtable = jht.build_hash_table(jnp.asarray(build), jnp.uint32(3), size,
                                  valid=jnp.asarray(valid), has_valid=True)
    table = ht.build_hash_table(torch.from_numpy(build), 3, size,
                                valid=torch.from_numpy(valid), has_valid=True)
    _eq(jtable, table, TABLE_FIELDS)
    _probe_all(jtable, table, probe)
    pvalid = np.arange(probe.size) % 3 != 0
    _same(jht.probe_exists(jtable, jnp.asarray(probe), jnp.asarray(pvalid)),
          ht.probe_exists(table, torch.from_numpy(probe), torch.from_numpy(pvalid)))


def test_overflow_surfaces_like_jax():
    """More valid rows than slots: the iteration bound stops the build and
    ``overflowed`` is set, in both packages, with the same partial table."""
    keys = np.arange(20, dtype=np.int32)
    valid = np.ones(20, bool)
    jtable = jht.build_hash_table(jnp.asarray(keys), jnp.uint32(1), 8,
                                  valid=jnp.asarray(valid), has_valid=True)
    table = ht.build_hash_table(torch.from_numpy(keys), 1, 8,
                                valid=torch.from_numpy(valid), has_valid=True)
    assert bool(table.overflowed) and bool(jtable.overflowed)
    _eq(jtable, table, TABLE_FIELDS)
    jd, jrep = jht.build_dedup_hash_table(jnp.asarray(keys), jnp.uint32(1), 8,
                                          valid=jnp.asarray(valid), has_valid=True)
    td, trep = ht.build_dedup_hash_table(torch.from_numpy(keys), 1, 8,
                                         valid=torch.from_numpy(valid), has_valid=True)
    _eq(jd, td, TABLE_FIELDS)
    _same(jrep, trep)


def test_errors_match_jax():
    keys = np.arange(16, dtype=np.int32)
    for build, k in ((jht.build_hash_table, jnp.asarray(keys)),
                     (jht.build_dedup_hash_table, jnp.asarray(keys)),
                     (ht.build_hash_table, torch.from_numpy(keys)),
                     (ht.build_dedup_hash_table, torch.from_numpy(keys))):
        with pytest.raises(ValueError, match="power of two"):
            build(k, 1, 12)
    with pytest.raises(ValueError, match="< number of keys"):
        jht.build_hash_table(jnp.asarray(keys), jnp.uint32(1), 8)
    with pytest.raises(ValueError, match="< number of keys"):
        ht.build_hash_table(torch.from_numpy(keys), 1, 8)
    wide = torch.arange(4, dtype=torch.int64)
    # the port's tables keep int64 keys' 8 bytes (JAX's raise, below)
    assert ht.build_hash_table(wide, 1, 8).slot_keys.dtype == torch.int64
    assert ht.build_chained(wide, 1, 4).entry_keys.dtype == torch.int64
    with pytest.raises(TypeError, match="integers"):
        ht.build_chained(wide.to(torch.float32), 1, 4)
    with pytest.raises(TypeError, match="32-bit"):
        radix.partition_ids(wide, 1, 4)
    with jax.enable_x64(True), pytest.raises(TypeError, match="32-bit"):
        jht.build_chained(jnp.arange(4, dtype=jnp.int64), jnp.uint32(1), 4)


@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_dedup_matches_jax(case):
    keys = KEY_CASES[case][0]
    size = ht.table_size_for(keys.size)
    valid = np.arange(keys.size) % 5 != 1
    for has_valid in (False, True):
        kw = dict(valid=valid, has_valid=True) if has_valid else {}
        jd, jrep = jht.build_dedup_hash_table(
            jnp.asarray(keys), jnp.uint32(77), size,
            **{k: jnp.asarray(v) if k == "valid" else v for k, v in kw.items()})
        td, trep = ht.build_dedup_hash_table(
            torch.from_numpy(keys), 77, size,
            **{k: torch.from_numpy(v) if k == "valid" else v for k, v in kw.items()})
        _eq(jd, td, TABLE_FIELDS)
        _same(jrep, trep)
        # a key's representative is its smallest valid row, whatever the seed
        rows = np.flatnonzero(valid) if has_valid else np.arange(keys.size)
        first = {}
        for r in rows:
            first.setdefault(keys[r], r)
        want = np.full(keys.size, -1)
        want[rows] = [first[keys[r]] for r in rows]
        assert np.array_equal(trep.numpy(), want)


@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_chained_matches_jax(case):
    build, probe = KEY_CASES[case]
    nb = ht.chained_num_buckets(build.size)
    assert nb == jht.chained_num_buckets(build.size)
    jtable = jht.build_chained(jnp.asarray(build), jnp.uint32(0x1234), nb)
    table = ht.build_chained(torch.from_numpy(build), 0x1234, nb)
    _eq(jtable, table, CHAINED_FIELDS)
    jp, tp = jnp.asarray(probe), torch.from_numpy(probe)
    if build.size == 0:
        # JAX's window gather cannot index an empty table (it raises); the
        # port finds nothing
        with pytest.raises(TypeError):
            jht.probe_chained_get(jtable, jp)
        found, rows = ht.probe_chained_get(table, tp)
        assert not found.any() and (rows == -1).all()
        assert not ht.probe_chained_count_all(table, tp).any()
        assert int(ht.probe_chained_count(table, tp)) == 0
        return
    for w, g in zip(jht.probe_chained_get(jtable, jp), ht.probe_chained_get(table, tp)):
        _same(w, g)
    _same(jht.probe_chained_count_all(jtable, jp), ht.probe_chained_count_all(table, tp))
    want = int(jht.probe_chained_count(jtable, jp))
    assert want == int(np.isin(probe, build).sum())
    for chunks in (1, 3, 7):  # 7 does not divide the probe sizes
        assert int(ht.probe_chained_count(table, tp, num_chunks=chunks)) == want


@pytest.mark.parametrize("skip", [0, 1, 37])
@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_chained_count_plain_matches_window_scan(case, skip):
    """The chained-probe kernel's plain version, which the port's count
    probe runs on the CPU, counts what JAX's window scan
    (``_probe_chained_count_chunk``) and ``np.isin`` count, on K7's hashes
    under the table's mask and on the one-chain table under a bucket
    override."""
    build, probe = KEY_CASES[case]
    tp = torch.from_numpy(probe)
    nb = ht.chained_num_buckets(build.size)
    table = ht.build_chained(torch.from_numpy(build), 0x1234, nb)
    got = kcp.chained_count_plain(tp, ht.hash_bits(tp, table.seed), table.num_buckets - 1,
                                  table.offsets, table.entry_keys, skip)
    want = int(np.isin(probe[skip:], build).sum())
    assert int(got) == int(ht._probe_chained_count_chunk(table, tp, skip=skip)) == want
    if build.size and probe.size:
        jtable = jht.build_chained(jnp.asarray(build), jnp.uint32(0x1234), nb)
        assert int(jht._probe_chained_count_chunk(
            jtable, jnp.asarray(probe), skip=jnp.int32(skip))) == want
    if build.size:
        jtable, one = _one_bucket_table(build)
        zeros = torch.zeros(probe.size, dtype=torch.int32)
        got = kcp.chained_count_plain(tp, zeros, 0xFFFFFFFF, one.offsets, one.entry_keys,
                                      skip)
        jwant = jht._probe_chained_count_chunk(
            jtable, jnp.asarray(probe), jnp.zeros(probe.size, jnp.int32),
            skip=jnp.int32(skip)) if probe.size else 0
        assert int(got) == int(jwant) == want


@pytest.mark.parametrize("case", test_torch_chained_probe.BUILD_CASES)
def test_chained_build_from_buckets_matches_jax(case):
    """The port's build from bucket ids (its one-pass build's plain version
    on the CPU) gives JAX's table, read through
    ``ChainedHashTable.from_numpy``, on every edge of the offsets: an empty
    build, one bucket, one chain, empty buckets at both ends and between,
    ids at and past the table, the radix joiner's segmented ids."""
    bucket, nb = test_torch_chained_probe.build_case(case)
    keys = test_torch_chained_probe._build_keys(bucket, torch.int32)
    j = jht.build_chained_from_buckets(jnp.asarray(bucket.numpy()),
                                       jnp.asarray(keys.numpy()), jnp.uint32(3), nb)
    want = ht.ChainedHashTable.from_numpy(j.entry_keys, j.entry_rows, j.offsets,
                                          j.max_chain, j.seed)
    got = ht.build_chained_from_buckets(bucket, keys, 3, nb)
    for f in ("entry_keys", "entry_rows", "offsets", "max_chain"):
        w, g = getattr(want, f), getattr(got, f)
        assert w.dtype == g.dtype and torch.equal(w, g), f
    assert got.seed == want.seed == 3


def _one_bucket_table(build):
    """JAX's and the port's table of ``build`` with every row in bucket 0
    of 2 (one chain as long as the build)."""
    j = jht.build_chained_from_buckets(
        jnp.zeros(build.size, jnp.int32), jnp.asarray(build), jnp.uint32(1), 2)
    t = ht.build_chained_from_buckets(
        torch.zeros(build.size, dtype=torch.int32), torch.from_numpy(build), 1, 2)
    _eq(j, t, CHAINED_FIELDS)
    return j, t


def test_tail_overflow_fallback_exact():
    """JAX's TestChainedTable::test_tail_overflow_fallback_exact shape: a
    4,096-row chain of one key that every probe row walks, so JAX's active
    rows overflow its tail and its full window loop counts; the port's
    count (the chained-probe kernel's plain version on the CPU) is exact."""
    build = np.full(4096, 77, np.int32)
    jtable, table = _one_bucket_table(build)
    zeros_j, zeros_t = jnp.zeros(4096, jnp.int32), torch.zeros(4096, dtype=torch.int32)
    for probe in (np.full(4096, 78, np.int32), build):
        want = int(jht._probe_chained_count_chunk(jtable, jnp.asarray(probe), zeros_j))
        got = int(ht._probe_chained_count_chunk(table, torch.from_numpy(probe), zeros_t))
        assert got == want
    assert want == 4096


def test_tail_path_with_skip():
    """A chain of 64 distinct keys probed by 2,048 rows of which 200 look
    past the first window (JAX's tail counts them), and ``skip`` leaves the
    first rows out, as in JAX."""
    build = np.arange(64, dtype=np.int32)
    jtable, table = _one_bucket_table(build)
    probe = np.full(2048, 1, np.int32)
    probe[::10][:200] = np.arange(200) % 80  # 4..63 hit late, >= 64 miss
    bucket_j, bucket_t = jnp.zeros(2048, jnp.int32), torch.zeros(2048, dtype=torch.int32)
    for skip in (None, 0, 37, 2048):
        want = int(jht._probe_chained_count_chunk(
            jtable, jnp.asarray(probe), bucket_j,
            skip=None if skip is None else jnp.int32(skip)))
        got = int(ht._probe_chained_count_chunk(
            table, torch.from_numpy(probe), bucket_t, skip=skip))
        assert got == want
        assert want == int((np.isin(probe, build) & (np.arange(2048) >= (skip or 0))).sum())


def test_tables_cross_between_packages():
    """A JAX-built table probed by the port (``from_numpy``), and a
    port-built table probed by JAX."""
    build, probe = KEY_CASES["extremes"]
    size = ht.table_size_for(build.size)
    jtable = jht.build_hash_table(jnp.asarray(build), jnp.uint32(9), size)
    table = ht.HashTable.from_numpy(
        *(np.asarray(getattr(jtable, f)) for f in ("slot_keys", "slot_rows", "max_probe")),
        np.asarray(jtable.seed), np.asarray(jtable.overflowed), device="cpu")
    _probe_all(jtable, table, probe)
    back = jht.HashTable(
        slot_keys=jnp.asarray(table.slot_keys.numpy()),
        slot_rows=jnp.asarray(table.slot_rows.numpy()),
        max_probe=jnp.asarray(table.max_probe.numpy()),
        seed=jnp.uint32(table.seed))
    _probe_all(back, table, probe)

    jc = jht.build_chained(jnp.asarray(build), jnp.uint32(5), ht.chained_num_buckets(build.size))
    tc = ht.ChainedHashTable.from_numpy(
        *(np.asarray(getattr(jc, f)) for f in CHAINED_FIELDS), np.asarray(jc.seed))
    _eq(jc, tc, CHAINED_FIELDS)
    jp, tp = jnp.asarray(probe), torch.from_numpy(probe)
    assert int(ht.probe_chained_count(tc, tp)) == int(jht.probe_chained_count(jc, jp))
    for w, g in zip(jht.probe_chained_get(jc, jp), ht.probe_chained_get(tc, tp)):
        _same(w, g)


def test_hashes_go_through_the_hash_kernel_wrapper(monkeypatch):
    """Every int32 hash of the hash layer calls K7's wrapper (which runs its
    plain version on a CPU tensor and the kernel on a CUDA one)."""
    calls = []
    real = kgen.hash_keys

    def spy(keys, seed):
        calls.append(keys.shape[0])
        return real(keys, seed)

    monkeypatch.setattr(kgen, "hash_keys", spy)
    keys = torch.arange(100, dtype=torch.int32)
    ht.build_hash_table(keys, 1, 256)
    ht.build_chained(keys, 1, 128)
    ht.build_dedup_hash_table(keys, 1, 256)
    radix.partition_ids(keys, 1, 8)
    assert calls == [100] * 4


@pytest.mark.parametrize("n", [0, 1, 5, 4096, 10**7 + 1])
def test_sizes_match_jax(n):
    for ratio in (1.0, 1.25, 2.0):
        assert ht.table_size_for(n, ratio) == jht.table_size_for(n, ratio)
        assert ht.segmented_capacity(n, 64, ratio) == jht.segmented_capacity(n, 64, ratio)
    assert ht.chained_num_buckets(n) == jht.chained_num_buckets(n)


@pytest.mark.parametrize("ratio", [1.0, 1.25, 2.0, 0.3])
def test_segment_geometry_matches_jax(ratio):
    hist = np.asarray([0, 1, 7, 8, 9, 1000, 3, 2**24 + 1, 123457], np.int32)
    for w, g in zip(jht.segment_geometry(jnp.asarray(hist), ratio),
                    ht.segment_geometry(torch.from_numpy(hist), ratio)):
        _same(w, g)


# ---------------------------------------------------------------- radix


def _relation(n=3000, seed=4):
    rng = np.random.default_rng(seed)
    keys = rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64).astype(np.int32)
    keys[::9] = keys[0]  # a heavy key
    keys[1], keys[2] = I32_MAX, I32_MIN
    return keys, rng.integers(-10**6, 10**6, n).astype(np.int32)


@pytest.mark.parametrize("partitions", [1, 8, 256])
def test_radix_partition_matches_jax(partitions):
    keys, pay = _relation()
    jk, jp, tk, tp = jnp.asarray(keys), jnp.asarray(pay), torch.from_numpy(keys), torch.from_numpy(pay)
    _same(jradix.partition_ids(jk, jnp.uint32(6), partitions),
          radix.partition_ids(tk, 6, partitions))
    want = jradix.radix_partition(jk, jp, jnp.uint32(6), partitions)
    got = radix.radix_partition(tk, tp, 6, partitions)
    _eq(want, got, PART_FIELDS)
    assert got.num_partitions == partitions
    back = radix.PartitionedRelation.from_numpy(
        *(np.asarray(getattr(want, f)) for f in PART_FIELDS))
    _eq(want, back, PART_FIELDS)
    for passes in (1, 2, 3):
        for w, g in zip(jradix.radix_partition_keys(jk, jnp.uint32(6), partitions, passes=passes),
                        radix.radix_partition_keys(tk, 6, partitions, passes=passes)):
            _same(w, g)
    _eq(jradix.radix_partition_padded(jk, jp, jnp.uint32(6), partitions, 64),
        radix.radix_partition_padded(tk, tp, 6, partitions, 64), PART_FIELDS)


def test_radix_partition_rejects_non_power_of_two():
    for fn, keys in ((jradix.partition_ids, jnp.arange(4, dtype=jnp.int32)),
                     (radix.partition_ids, torch.arange(4, dtype=torch.int32))):
        with pytest.raises(ValueError, match="power of 2"):
            fn(keys, 1, 12)
