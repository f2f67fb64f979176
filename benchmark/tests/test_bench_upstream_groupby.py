"""The cell ``upstream_hash_groupby`` (the hash GROUP BY over the upstream's
int64 probe tuples), its reference and summary, and its three per-layer
metrics: the digest and the top groups worked out by hand, the reference
against a GROUP BY in plain Python, the readers silent without a device
event, and a run with the GROUP BY broken underneath comes out not correct.
Unlike the count cells, a stale answer shows here: each variant's groups
differ."""

import dataclasses
import json

import pytest
import torch

from benchmark import run
from benchmark.metrics import dedup_claim_rounds, groupby_dedup_ms, groupby_scatter_ms
from benchmark.operations import hash_groupby
from benchmark.reference import groupby
from conftest import SEED, tiny_bench, tiny_layout
from partitionedhashjoin_tpu_torch.ops import aggregate
from partitionedhashjoin_tpu_torch.ops import hash_table as ht

CELL = "upstream_hash_groupby"
CONFIG = "upstream_groupby_200M_zipf105"
CPU = torch.device("cpu")
MASK = (1 << 64) - 1


def _mix(z):
    """splitmix64's finalizer on Python ints."""
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK
    return z ^ (z >> 31)


def _digest_by_hand(groups):
    total = 0
    for fields in groups:
        h = 0
        for f in fields:
            h = _mix(((h + 0x9E3779B97F4A7C15) & MASK) ^ (f & MASK))
        total = (total + h) & MASK
    return total - (1 << 64) if total >> 63 else total


def _plain_groups(keys, payloads):
    """{key: [count, sum, min, max]} in plain Python."""
    out = {}
    for k, p in zip(keys.tolist(), payloads.tolist()):
        g = out.setdefault(k, [0, 0, p, p])
        g[0] += 1
        g[1] += p
        g[2], g[3] = min(g[2], p), max(g[3], p)
    return out


def _cols(groups):
    keys = sorted(groups)
    return tuple(torch.tensor(c, dtype=torch.int64) for c in
                 (keys, *zip(*(groups[k] for k in keys))))


def test_digest_and_top_by_hand():
    keys = torch.tensor([7, -3, 7, 2**40, 7, -3, 2**63 - 1, -(2**63), 5, 5, 5],
                        dtype=torch.int64)
    pay = torch.tensor([1, -2, 3, 10**15, 5, 8, -1, 0, 4, 4, 9], dtype=torch.int64)
    cols = groupby.group_by(keys, pay)
    want = [(-(2**63), 1, 0, 0, 0), (-3, 2, 6, -2, 8), (5, 3, 17, 4, 9),
            (7, 3, 9, 1, 5), (2**40, 1, 10**15, 10**15, 10**15),
            (2**63 - 1, 1, -1, -1, -1)]
    assert [tuple(r) for r in zip(*(c.tolist() for c in cols))] == want
    assert groupby.digest(*cols) == _digest_by_hand(want)
    # the digest holds for any order of the groups, and sees one field
    perm = torch.tensor([3, 0, 5, 1, 4, 2])
    assert groupby.digest(*(c[perm] for c in cols)) == _digest_by_hand(want)
    moved = list(cols)
    moved[2] = moved[2] + (torch.arange(6) == 4)
    assert groupby.digest(*moved) != groupby.digest(*cols)
    # COUNT descending, ties to the lower key
    assert groupby.top(*cols, k=3) == {
        "key": [5, 7, -3], "count": [3, 3, 2], "sum": [17, 9, 6],
        "min": [4, 1, -2], "max": [9, 5, 8]}
    top = groupby.top(*cols)
    assert top["key"] == [5, 7, -3, -(2**63), 2**40, 2**63 - 1]
    empty = groupby.answer(*groupby.group_by(keys[:0], pay[:0]))
    assert empty == {"num_groups": 0, "digest": 0,
                     "top": {c: [] for c in groupby.COLUMNS}}


@pytest.mark.parametrize("block", [7, 1 << 25])
def test_reference_is_a_plain_group_by(block, monkeypatch):
    """Blocks smaller than the input combine their partial groups."""
    monkeypatch.setattr(groupby, "BLOCK", block)
    gen = torch.Generator().manual_seed(3)
    keys = torch.randint(-40, 40, (500,), generator=gen) * (2**33 + 1)
    keys[::9] = 2**32 + 5  # a head key; its low word equals 5's
    keys[1::50] = 5
    pay = torch.randint(-(2**40), 2**40, (500,), generator=gen)
    want = _cols(_plain_groups(keys, pay))
    got = groupby.group_by(keys, pay)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the control's float32 sums are off at this size
    control = groupby.group_by(keys, pay, sum_dtype=torch.float32)
    assert not torch.equal(control[2], want[2])
    assert torch.equal(control[1], want[1])


def test_compulsory_bytes_at_the_upstream_shape():
    assert hash_groupby.groupby_bytes(200_000_000, 7_951_239) == (
        16 * 200_000_000 + 36 * 7_951_239)


class _Stretch:
    def __init__(self, device_events):
        self.device_events = device_events


def _ctx(phases, device_events, traced=True):
    ops = [run.OpRecord(0, 0.5, None, p, traced) for p in phases]
    return run.Context(10, 200, 8, 0, 0.0, 1.0, 0, ops,
                       None if device_events is None else _Stretch(device_events))


READERS = (groupby_dedup_ms, groupby_scatter_ms, dedup_claim_rounds)


def test_readers_return_none_without_a_device_event():
    phases = [{"build": 0.2, "probe": 0.1, "claim_rounds": 5},
              {"build": 0.4, "probe": 0.3, "claim_rounds": 7}]
    for ctx in (_ctx(phases, None), _ctx(phases, 0),
                _ctx(phases, 10, traced=False), _ctx([None, {}], 10)):
        assert all(r.read(ctx) is None for r in READERS)
    ctx = _ctx(phases, 10)
    assert groupby_dedup_ms.read(ctx) == pytest.approx(300.0)
    assert groupby_scatter_ms.read(ctx) == pytest.approx(200.0)
    assert dedup_claim_rounds.read(ctx) == pytest.approx(6.0)


def test_cell_is_the_upstream_data_through_the_hash_group_by():
    bench = json.loads(run.BENCHMARK_JSON.read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "hash_groupby", 1)
    per_layer = {m["name"] for m in run.cell_metrics(bench, CELL)[1]}
    assert per_layer == {r.__name__.rsplit(".", 1)[1] for r in READERS}


def test_config_is_the_upstream_probe_relation_uncut():
    """The GROUP BY's own source, on the upstream's default probe relation at
    its published widths, drawn as the join cells draw it."""
    bench = json.loads(run.BENCHMARK_JSON.read_text())
    configs = {c["name"]: c for c in bench["configs"]}
    ours, data = configs[CONFIG], configs["upstream_10Mx200M_zipf105"]
    assert ours["reduced"] == [] and ours["source"] != data["source"]
    ours, data = (json.loads((run.HERE.parent / c["file"]).read_text())
                  for c in (ours, data))
    assert (ours["build"], ours["probe"]) == (data["build"], data["probe"])
    assert ours["probe"]["rows"] == 200_000_000
    assert ours["probe"]["dtype"] == "int64"
    assert ours["groupby"]["relation"] == "probe"


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_int64_keys_correct_on_cpu(trace, monkeypatch):
    seen = []
    orig = aggregate.hash_aggregate

    def spy(table, *a, **kw):
        seen.append((table.keys.dtype, kw.get("timer") is not None))
        return orig(table, *a, **kw)

    monkeypatch.setattr(aggregate, "hash_aggregate", spy)
    result, lines = run.execute(tiny_bench(), CELL, SEED, 0.3, bool(trace),
                                CPU, tiny_layout())
    assert result["correct"] and result["failed"] == 0, lines
    assert set(seen) == {(torch.int64, True)}
    if trace:  # no device trace on the CPU: the readers stay silent
        assert result["metrics"] == {} and "busy_s" in result["device"]


def half_the_rows(mp):
    orig = ht.build_dedup_hash_table

    def broken(keys, seed, size, valid=None, has_valid=False):
        half = torch.arange(keys.shape[0]) < keys.shape[0] // 2
        if has_valid:
            half &= valid.to(torch.bool)
        return orig(keys, seed, size, valid=half, has_valid=True)
    mp.setattr(ht, "build_dedup_hash_table", broken)


def sum_plus_one(mp):
    orig = aggregate.hash_aggregate

    def broken(*a, **kw):
        g = orig(*a, **kw)
        return dataclasses.replace(g, sum=g.sum + 1)
    mp.setattr(aggregate, "hash_aggregate", broken)


def stale_first_answer(mp):
    orig, first = aggregate.hash_aggregate, []

    def broken(*a, **kw):
        if not first:
            first.append(orig(*a, **kw))
        return first[0]
    mp.setattr(aggregate, "hash_aggregate", broken)


@pytest.mark.parametrize("fault", [half_the_rows, sum_plus_one, stale_first_answer])
def test_broken_group_by_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, lines = run.execute(tiny_bench(), CELL, SEED, 0.2, False, CPU,
                                tiny_layout())
    assert result["failed"] == 0
    assert not result["correct"], lines
    checks = result["checks"]
    assert checks["digest_wrong"]["value"] > checks["digest_wrong"]["limit"]
