"""The port's hash GROUP BY, dedup table and open-addressing table on int64
keys, against a plain reference on the CPU.

The JAX package's hash layer is 32-bit, so these hold the port to the GROUP
BY's semantics alone: one group per distinct key, in the order of the key's
first valid row; COUNT int32, SUM (wrapping modulo 2^64), MIN and MAX in the
payloads' int64; ``group_of_row`` the dense group of each valid row, -1
elsewhere.  The open-addressing probes find, return the first build row of
and count each key as ``torch.isin`` and a scan of the build keys do.  Every
case has keys that differ only above bit 31, so a table that narrowed its
keys to 32 bits would merge or miss them.
"""

import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu_torch import hash_aggregate
from partitionedhashjoin_tpu_torch.data.table import make_table
from partitionedhashjoin_tpu_torch.ops import aggregate
from partitionedhashjoin_tpu_torch.ops import hash_table as ht
from partitionedhashjoin_tpu_torch.utils.results import HashJoinTimer, Parameters

torch.set_num_threads(1)

I64_MAX = np.iinfo(np.int64).max
I64_MIN = np.iinfo(np.int64).min
SEED = 0x5EED4321


def _cases():
    rng = np.random.default_rng(26)
    base = rng.integers(-(2**31), 2**31, 300)
    high = np.concatenate([base, base + 2**32, base - 2**32, base[::3] + 2**40])
    high = rng.permutation(np.repeat(high, rng.integers(1, 5, high.size)))
    wide = rng.integers(I64_MIN, I64_MAX, 1200, dtype=np.int64)
    wide[:4] = [I64_MIN, I64_MAX, -1, 0]
    extremes = np.concatenate([wide, wide[::4], -np.abs(wide[::7]) - 1])
    half = rng.integers(-(2**45), 2**45, 3000)
    half[rng.permutation(3000)[:1500]] = 2**33 + 7  # one key holds half the rows
    pay = {}
    for name, keys in (("high_words", high), ("extremes", extremes),
                       ("half_one_key", half)):
        p = rng.integers(-(2**40), 2**40, keys.size, dtype=np.int64)
        pay[name] = p
    # sums that wrap modulo 2^64
    pay["extremes"][::5] = I64_MAX - rng.integers(0, 9, pay["extremes"][::5].size)
    return {name: (keys, pay[name]) for name, keys in
            (("high_words", high), ("extremes", extremes), ("half_one_key", half))}


CASES = _cases()
EVEN = lambda k, p: (p % 2) == 0  # noqa: E731
NONE = lambda k, p: k != k  # noqa: E731


def _wrap64(x):
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >> 63 else x


def ref_group_by(keys, payloads, valid=None):
    """``(keys, count, sum, min, max, group_of_row)`` of a plain GROUP BY,
    groups in the order of each key's first valid row."""
    keys, payloads = keys.tolist(), payloads.tolist()
    valid = [True] * len(keys) if valid is None else valid.tolist()
    groups, of_row = {}, []
    for k, p, v in zip(keys, payloads, valid):
        if not v:
            of_row.append(-1)
            continue
        g = groups.setdefault(k, [len(groups), 0, 0, p, p])
        g[1] += 1
        g[2] += p
        g[3], g[4] = min(g[3], p), max(g[4], p)
        of_row.append(g[0])
    rows = list(groups.items())
    return ([k for k, _ in rows], [g[1] for _, g in rows],
            [_wrap64(g[2]) for _, g in rows], [g[3] for _, g in rows],
            [g[4] for _, g in rows], of_row)


def _assert_groups(got, keys, payloads, valid=None):
    wk, wc, ws, wmin, wmax, of_row = ref_group_by(keys, payloads, valid)
    n = int(got.num_groups)
    assert n == len(wk) and got.num_groups.dtype == torch.int32
    assert got.keys.dtype == got.sum.dtype == got.min.dtype == torch.int64
    assert got.count.dtype == torch.int32
    assert got.keys[:n].tolist() == wk
    assert got.count[:n].tolist() == wc
    assert got.sum[:n].tolist() == ws
    assert got.min[:n].tolist() == wmin
    assert got.max[:n].tolist() == wmax
    assert got.group_of_row.tolist() == of_row
    # past the groups: JAX's fill values
    assert not got.keys[n:].any() and not got.count[n:].any()
    assert (got.min[n:] == I64_MAX).all() and (got.max[n:] == I64_MIN).all()


def _table(case):
    keys, pay = CASES[case]
    return make_table(torch.from_numpy(keys), torch.from_numpy(pay))


def test_high_word_keys_share_their_low_words():
    keys = CASES["high_words"][0]
    lo = keys & 0xFFFFFFFF
    assert np.unique(keys).size > np.unique(lo).size


@pytest.mark.parametrize("case", sorted(CASES))
def test_hash_aggregate_i64(case):
    t = _table(case)
    _assert_groups(hash_aggregate(t, seed=SEED), t.keys, t.payloads)
    # the exported entry is the operator's
    _assert_groups(aggregate.hash_aggregate(t, seed=7), t.keys, t.payloads)


@pytest.mark.parametrize("case", sorted(CASES))
def test_filter_aggregate_i64(case):
    t = _table(case)
    g, n = aggregate.filter_aggregate(t, EVEN, seed=SEED)
    mask = EVEN(t.keys, t.payloads)
    assert int(n) == int(mask.sum())
    _assert_groups(g, t.keys, t.payloads, mask)


def test_empty_input_and_a_mask_that_rejects_everything():
    empty = make_table(torch.zeros(0, dtype=torch.int64),
                       torch.zeros(0, dtype=torch.int64))
    _assert_groups(hash_aggregate(empty, seed=SEED), empty.keys, empty.payloads)
    t = _table("extremes")
    g, n = aggregate.filter_aggregate(t, NONE, seed=SEED)
    assert int(n) == 0
    _assert_groups(g, t.keys, t.payloads, torch.zeros(t.size, dtype=torch.bool))


def test_timer_phases_and_claim_rounds():
    t = make_table(torch.full((500,), 2**40 + 3, dtype=torch.int64),
                   torch.arange(500, dtype=torch.int64))
    ht.CLAIM_ROUNDS = 0
    timer = HashJoinTimer(Parameters())
    g = hash_aggregate(t, seed=SEED, timer=timer)
    # one key: the first round claims its slot, the second resolves the rest
    assert ht.CLAIM_ROUNDS == 2 and int(g.num_groups) == 1
    r = timer.get_result()
    assert r.get_build_phase_duration() > 0 and r.get_probe_phase_duration() > 0
    aggregate.filter_aggregate(t, NONE, seed=SEED, timer=timer)
    assert ht.CLAIM_ROUNDS == 2  # no valid row, no round


def ref_first_row(build, probe):
    """First build row holding each probe key (compared at int64), -1 if
    none."""
    first = {}
    for i, k in enumerate(build.tolist()):
        first.setdefault(k, i)
    return torch.tensor([first.get(k, -1) for k in probe.tolist()],
                        dtype=torch.int32)


def ref_multiplicity(build, probe):
    values, counts = np.unique(build.numpy(), return_counts=True)
    mult = dict(zip(values.tolist(), counts.tolist()))
    return torch.tensor([mult.get(k, 0) for k in probe.tolist()],
                        dtype=torch.int32)


def _probe_cases():
    keys, _ = CASES["high_words"]
    rng = np.random.default_rng(5)
    build = torch.from_numpy(keys[:900])
    probe = torch.from_numpy(np.concatenate(
        [keys[::3], keys[:50] ^ (1 << 50), rng.integers(I64_MIN, I64_MAX, 300,
                                                         dtype=np.int64)]))
    i32 = torch.from_numpy(rng.integers(-(2**31), 2**31, 400).astype(np.int32))
    return {
        "i64_by_i64": (build, probe),
        "i64_by_i32": (build, torch.cat([i32, build[:200].to(torch.int32)])),
        "i32_by_i64": (i32, torch.cat([i32[::2].to(torch.int64),
                                       i32[:100].to(torch.int64) + 2**32])),
    }


@pytest.mark.parametrize("case", ["i64_by_i64", "i64_by_i32", "i32_by_i64"])
def test_open_addressing_build_and_probes(case):
    build, probe = _probe_cases()[case]
    table = ht.build_hash_table(build, SEED, ht.table_size_for(build.numel()))
    assert table.slot_keys.dtype == build.dtype
    assert not bool(table.overflowed)
    first = ref_first_row(build, probe)
    assert torch.equal(ht.probe_exists(table, probe), first >= 0)
    found, row = ht.probe_get(table, probe)
    assert torch.equal(found, first >= 0) and torch.equal(row, first)
    assert torch.equal(ht.probe_count_all(table, probe),
                       ref_multiplicity(build.to(torch.int64), probe))
    valid = torch.arange(probe.numel()) % 3 != 0
    assert torch.equal(ht.probe_exists(table, probe, valid=valid),
                       (first >= 0) & valid)


def test_dedup_key_widths():
    wide = torch.tensor([2**40, -(2**40), 7, 2**40], dtype=torch.int64)
    for keys, want in ((wide, torch.int64), (wide.view(torch.uint64), torch.int64),
                       (torch.tensor([1, 2], dtype=torch.int16), torch.int32),
                       (torch.tensor([1, 2], dtype=torch.int32), torch.int32)):
        table, rep = ht.build_dedup_hash_table(keys, 1, 8)
        assert table.slot_keys.dtype == want
    assert rep.tolist() == [0, 1]
    assert ht.build_dedup_hash_table(wide, 1, 8)[1].tolist() == [0, 1, 2, 0]
    for bad in (torch.tensor([1.0, 2.0]), torch.tensor([True, False])):
        with pytest.raises(TypeError, match="integers"):
            ht.build_dedup_hash_table(bad, 1, 4)
        with pytest.raises(TypeError, match="integers"):
            ht.build_hash_table(bad, 1, 4)
