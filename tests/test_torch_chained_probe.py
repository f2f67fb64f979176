"""The chained table's kernel wrappers (``ops/kernels/chained_probe``) on the
CPU: their argument checks and their plain versions, which the port's build
and count probe run on a CPU tensor.  The build's plain version is held to
the histogram formulation it replaced (``bincount``, ``cumsum``, a leading
0) on the edges of its offsets; the count's to ``torch.isin`` at every pair
of key widths.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
No JAX here: the JAX package's table is compared in
``tests/test_torch_hash_table.py``.
"""

import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu_torch.ops import hash_table as ht
from partitionedhashjoin_tpu_torch.ops import radix, radix_cluster
from partitionedhashjoin_tpu_torch.ops.kernels import chained_probe as kcp

torch.set_num_threads(1)

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
WIDTHS = [(torch.int32, torch.int32), (torch.int32, torch.int64),
          (torch.int64, torch.int32), (torch.int64, torch.int64)]


def _operands(probe_dtype, entry_dtype, seed=7):
    """Build keys over int32's range (plus, at int64, a third of them moved
    by 2^32) and probe keys that hit, miss and differ from a build key only
    above bit 31."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(I32_MIN, I32_MAX, 1500, dtype=np.int64)
    lo[:3] = [I32_MIN, I32_MAX, 0]
    build = np.concatenate([lo, lo[:500] + 2**32]) if entry_dtype == torch.int64 else lo
    hits = rng.choice(build, 2001)
    if probe_dtype == torch.int32:
        hits = hits[(hits >= I32_MIN) & (hits <= I32_MAX)]
    probe = np.concatenate([hits, rng.integers(I32_MIN, I32_MAX, 800, dtype=np.int64)])
    if probe_dtype == torch.int64:
        probe = np.concatenate([probe, lo[:300] + 2**32, lo[:300] - 2**32])
    return (torch.from_numpy(build).to(entry_dtype),
            torch.from_numpy(rng.permutation(probe)).to(probe_dtype))


def _args(probe_dtype=torch.int32, entry_dtype=torch.int32):
    build, probe = _operands(probe_dtype, entry_dtype)
    table = ht.build_chained(build, 3, ht.chained_num_buckets(build.numel()))
    hashes = ht.hash_bits(ht._probe_keys(table, probe)[1], table.seed)
    return build, probe, table, hashes


@pytest.mark.parametrize("skip", [0, 3, 10_000])
@pytest.mark.parametrize("probe_dtype,entry_dtype", WIDTHS)
def test_plain_count_matches_window_scan_and_isin(probe_dtype, entry_dtype, skip):
    build, probe, table, hashes = _args(probe_dtype, entry_dtype)
    want = int(torch.isin(probe[skip:].to(torch.int64), build.to(torch.int64)).sum())
    assert 0 < int(torch.isin(probe.to(torch.int64), build.to(torch.int64)).sum()) < probe.numel()
    got = kcp.chained_count(probe, hashes, table.num_buckets - 1, table.offsets,
                            table.entry_keys, skip)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == int(ht._probe_chained_count_chunk(table, probe, skip=skip)) == want
    # uint32 hashes are the same bit patterns
    assert int(kcp.chained_count(probe, hashes.view(torch.uint32), table.num_buckets - 1,
                                 table.offsets, table.entry_keys, skip)) == want


def test_plain_count_on_a_long_chain_and_past_the_table():
    """One chain of 2,000 entries (far past ``PROBE_WINDOW``), probed under
    the all-ones mask; bucket ids past the table count as empty chains."""
    build = torch.arange(2000, dtype=torch.int64) * 3
    zeros = torch.zeros(2000, dtype=torch.int32)
    table = ht.build_chained_from_buckets(zeros, build, 1, 2)
    probe = torch.arange(6000, dtype=torch.int64)
    bucket = torch.zeros(6000, dtype=torch.int32)
    assert int(kcp.chained_count(probe, bucket, 0xFFFFFFFF, table.offsets,
                                 table.entry_keys)) == 2000
    assert int(ht._probe_chained_count_chunk(table, probe, bucket)) == 2000
    bucket[::2] = 2  # past the table's 2 buckets
    bucket[1::4] = -1  # 0xFFFFFFFF
    assert int(kcp.chained_count(probe, bucket, 0xFFFFFFFF, table.offsets,
                                 table.entry_keys)) == int((probe % 12 == 3).sum())


def test_plain_count_of_empty_sides():
    build, probe, table, hashes = _args()
    args = (table.num_buckets - 1, table.offsets, table.entry_keys)
    assert int(kcp.chained_count(probe[:0], hashes[:0], *args)) == 0
    empty = ht.build_chained(build[:0], 3, 1)
    assert int(kcp.chained_count(probe, torch.zeros_like(hashes), 0, empty.offsets,
                                 empty.entry_keys)) == 0


def test_cpu_probe_runs_the_plain_version(monkeypatch):
    """``probe_chained_count`` of a CPU tensor calls the kernel's wrapper,
    which runs ``chained_count_plain`` and launches nothing."""
    build, probe, table, _ = _args()
    calls = []
    real = kcp.chained_count_plain
    monkeypatch.setattr(kcp, "chained_count_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    before = kcp.LAUNCHES_CHAINED_COUNT
    assert int(ht.probe_chained_count(table, probe, 3)) == int(
        torch.isin(probe, build).sum())
    assert len(calls) == 3 and kcp.LAUNCHES_CHAINED_COUNT == before


def _bad(name, value):
    _, probe, table, hashes = _args()
    args = dict(keys=probe, hashes=hashes, mask=table.num_buckets - 1,
                offsets=table.offsets, entry_keys=table.entry_keys, skip=0)
    args[name] = value
    return args


@pytest.mark.parametrize("name,value", [
    ("keys", torch.zeros(4, dtype=torch.int16)),
    ("keys", torch.zeros(4, dtype=torch.float32)),
    ("keys", torch.zeros((2, 2), dtype=torch.int32)),
    ("keys", [1, 2, 3]),
    ("hashes", torch.zeros(4, dtype=torch.int64)),
    ("offsets", torch.zeros(4, dtype=torch.int64)),
    ("entry_keys", torch.zeros(4, dtype=torch.uint8)),
])
def test_wrapper_rejects_wrong_dtype_or_rank(name, value):
    with pytest.raises(TypeError, match=name):
        kcp.chained_count(**_bad(name, value))


def test_wrapper_rejects_wrong_shape_layout_and_values():
    _, probe, table, hashes = _args()
    with pytest.raises(ValueError, match="do not match"):
        kcp.chained_count(**_bad("hashes", hashes[:-1]))
    with pytest.raises(ValueError, match="contiguous"):
        kcp.chained_count(**_bad("keys", torch.zeros(8, dtype=torch.int32)[::2]))
    with pytest.raises(ValueError, match="num_buckets"):
        kcp.chained_count(**_bad("offsets", torch.zeros(0, dtype=torch.int32)))
    for mask in (-1, 2**32):
        with pytest.raises(ValueError, match="mask"):
            kcp.chained_count(**_bad("mask", mask))
    with pytest.raises(ValueError, match="skip"):
        kcp.chained_count(**_bad("skip", -1))


def test_wrapper_rejects_other_devices():
    """Inputs on two devices, or on a device that is neither the CPU nor
    CUDA, raise before anything runs."""
    _, probe, table, hashes = _args()
    meta = dict(keys=probe.to("meta"), hashes=hashes.to("meta"),
                mask=table.num_buckets - 1, offsets=table.offsets.to("meta"),
                entry_keys=table.entry_keys.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        kcp.chained_count(**meta)
    with pytest.raises(ValueError, match="different devices"):
        kcp.chained_count(**dict(meta, keys=probe))


# ---------------------------------------------------------------- the build


def _histogram_table(bucket, keys, num_buckets):
    """The build as it was before the one-pass kernel: a stable sort, then a
    ``bincount`` of the ids below ``num_buckets``, its ``cumsum`` after a
    0, and its max."""
    _, order = torch.sort(bucket, stable=True)
    counts = torch.bincount(bucket, minlength=num_buckets)[:num_buckets]
    offsets = torch.cat([counts.new_zeros((1,)), torch.cumsum(counts, 0)])
    return (keys[order], order.to(torch.int32), offsets.to(torch.int32),
            counts.max().to(torch.int32))


def _segmented_ids(n=3000, partitions=16):
    """The radix joiner's partition-segmented bucket ids of ``n`` keys, and
    its bucket count."""
    keys = torch.from_numpy(np.random.default_rng(9).integers(
        I32_MIN, I32_MAX, n, dtype=np.int64)).to(torch.int32)
    part, hist, _ = radix.radix_partition_keys(keys, 5, partitions)
    boff, bcnt = ht.segment_geometry(hist, ratio=1.0)
    bucket = radix_cluster._segment_bucket_ids(part, 5, 6, boff, bcnt, partitions)
    return bucket, ht.segmented_capacity(n, partitions, ratio=1.0)


def build_case(name):
    """``(bucket ids, num_buckets)`` of one build edge: int32 ids, every
    one >= 0."""
    rng = np.random.default_rng(len(name))

    def ids(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(torch.int32)

    if name == "empty":
        return ids([]), 4
    if name == "one_bucket_table":  # num_buckets = 1
        return ids(np.zeros(37)), 1
    if name == "one_chain":  # every row in bucket 5 of 8
        return ids(np.full(1001, 5)), 8
    if name == "gaps":  # empty buckets at the front, in the middle, at the end
        return ids(rng.permutation(np.repeat([9, 10, 40, 41, 41, 70], 13))), 100
    if name == "past_the_table":  # ids at and past num_buckets: no chain
        return ids(rng.permutation(np.concatenate(
            [rng.integers(0, 64, 700), np.full(50, 64), rng.integers(65, 3000, 90)]))), 64
    if name == "all_past_the_table":
        return ids(rng.integers(16, 300, 95)), 16
    if name == "random":  # load ~1, ragged length
        return ids(rng.integers(0, 4096, 4093)), 4096
    if name == "segmented":
        return _segmented_ids()
    raise KeyError(name)


BUILD_CASES = ("empty", "one_bucket_table", "one_chain", "gaps", "past_the_table",
               "all_past_the_table", "random", "segmented")


def _build_keys(bucket, dtype):
    """Distinct build keys, at int64 spread past int32's range."""
    n = bucket.numel()
    keys = torch.arange(n, dtype=torch.int64) * 7919 - 3 * n
    if dtype == torch.int64:
        keys = keys * (2**33 + 1)
    return keys.to(dtype)


@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", BUILD_CASES)
def test_plain_build_matches_histogram_build(case, key_dtype):
    """``chained_build_plain`` and ``build_chained_from_buckets`` on the CPU
    give the table the histogram formulation gave, field for field and
    dtype for dtype, and every id past the table stays among the entries
    but in no chain."""
    bucket, nb = build_case(case)
    keys = _build_keys(bucket, key_dtype)
    want = _histogram_table(bucket, keys, nb)
    sorted_bucket, order = torch.sort(bucket, stable=True)
    got = (keys[order], *kcp.chained_build_plain(sorted_bucket, order, nb))
    table = ht.build_chained_from_buckets(bucket, keys, 3, nb)
    fields = (table.entry_keys, table.entry_rows, table.offsets, table.max_chain)
    for w, g, t in zip(want, got, fields):
        assert w.dtype == g.dtype == t.dtype and w.shape == g.shape == t.shape
        assert torch.equal(w, g) and torch.equal(w, t)
    assert table.offsets.shape == (nb + 1,) and table.max_chain.dim() == 0
    assert int(table.offsets[-1]) == int((bucket < nb).sum())
    assert sorted(table.entry_rows.tolist()) == list(range(bucket.numel()))


def test_cpu_build_runs_the_plain_version(monkeypatch):
    """``build_chained`` of a CPU tensor calls the build wrapper, which runs
    ``chained_build_plain`` and launches nothing."""
    calls = []
    real = kcp.chained_build_plain
    monkeypatch.setattr(kcp, "chained_build_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    before = kcp.LAUNCHES_CHAINED_BUILD
    build, _ = _operands(torch.int32, torch.int32)
    ht.build_chained(build, 3, ht.chained_num_buckets(build.numel()))
    assert len(calls) == 1 and kcp.LAUNCHES_CHAINED_BUILD == before


def _build_args():
    bucket, nb = build_case("random")
    sorted_bucket, order = torch.sort(bucket, stable=True)
    return dict(sorted_bucket=sorted_bucket, order=order, num_buckets=nb)


@pytest.mark.parametrize("name,value", [
    ("sorted_bucket", torch.zeros(4093, dtype=torch.int16)),
    ("sorted_bucket", torch.zeros(4093, dtype=torch.float32)),
    ("sorted_bucket", torch.zeros((1, 4093), dtype=torch.int32)),
    ("order", torch.zeros(4093, dtype=torch.int32)),
    ("order", torch.zeros((4093, 1), dtype=torch.int64)),
    ("order", list(range(4093))),
])
def test_build_wrapper_rejects_wrong_dtype_or_rank(name, value):
    with pytest.raises(TypeError, match=name):
        kcp.chained_build(**dict(_build_args(), **{name: value}))


def test_build_wrapper_rejects_wrong_shape_layout_and_values():
    args = _build_args()
    with pytest.raises(ValueError, match="does not match"):
        kcp.chained_build(**dict(args, order=args["order"][:-1].contiguous()))
    with pytest.raises(ValueError, match="contiguous"):
        kcp.chained_build(**dict(args, order=torch.zeros(2 * 4093, dtype=torch.int64)[::2]))
    for nb in (0, -1, 2**31 - 1):
        with pytest.raises(ValueError, match="num_buckets"):
            kcp.chained_build(**dict(args, num_buckets=nb))
    meta = dict(args, sorted_bucket=args["sorted_bucket"].to("meta"),
                order=args["order"].to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        kcp.chained_build(**meta)
    with pytest.raises(ValueError, match="different devices"):
        kcp.chained_build(**dict(meta, order=args["order"]))
