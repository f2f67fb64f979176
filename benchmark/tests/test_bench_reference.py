"""The plain reference against answers worked out by hand, its controls, and
the generator."""

import numpy as np
import torch

from benchmark import generate
from benchmark.reference import joins

I32 = dict(dtype=torch.int32)


def test_semi_join_count_by_hand():
    build = torch.tensor([5, 2, 2, 1], **I32)
    probe = torch.tensor([2, 2, 3, 5, 5, 5, 7], **I32)
    assert joins.semi_join_count(build, probe) == 5  # 2, 2, 5, 5, 5
    assert joins.semi_join_count(build[:0], probe) == 0


def test_join_groupby_top_by_hand():
    build = torch.tensor([5, 2, 2, 9], **I32)
    probe = torch.tensor([2, 2, 3, 5, 5, 5, 9], **I32)
    pay = torch.tensor([10, 20, 99, 1, 2, 3, 7], **I32)
    got = joins.join_groupby_top(build, probe, pay, k=10)
    # key 2 joins twice: 2 probe rows x 2 build rows; 5 and 9 once
    want = {"key": [2, 5, 9], "count": [4, 3, 1], "sum": [60, 6, 7],
            "min": [10, 1, 7], "max": [20, 3, 7]}
    assert {c: v.tolist() for c, v in got.items()} == want
    assert joins.join_groupby_top(build, probe, pay, k=2)["key"].tolist() == [2, 5]


def test_ties_go_to_the_lower_key():
    build = torch.tensor([7, 3, 5], **I32)
    probe = torch.tensor([7, 5, 3, 7, 5, 3], **I32)
    pay = torch.zeros(6, **I32)
    assert joins.join_groupby_top(build, probe, pay, k=2)["key"].tolist() == [3, 5]


def test_sum_wraps_as_an_int32_column():
    build = torch.tensor([1], **I32)
    probe = torch.ones(3, **I32)
    pay = torch.full((3,), 2**30, **I32)
    got = joins.join_groupby_top(build, probe, pay, k=1)
    assert got["sum"].tolist() == [3 * 2**30 - 2**32]


def test_controls_break_exactness():
    gen = torch.Generator().manual_seed(3)
    build = torch.arange(1, 2001, **I32)
    probe = torch.randint(1, 2001, (40000,), generator=gen, **I32)
    pay = torch.randint(0, 1 << 20, (40000,), generator=gen, **I32)
    exact = joins.semi_join_count(build, probe)
    assert exact == 40000
    assert joins.control_sampled_count(build, probe, seed=11) != exact
    want = joins.join_groupby_top(build, probe, pay, k=10)
    low = joins.join_groupby_top(build, probe, pay, k=10, sum_dtype=torch.float32)
    assert not np.array_equal(low["sum"], want["sum"])
    assert np.array_equal(low["key"], want["key"])


def test_generator_is_a_function_of_the_seed():
    config = {"build": {"rows": 500, "dtype": "int32",
                        "keys": {"dist": "sequential", "start": 1},
                        "payloads": {"dist": "xor_key", "salt": 23063}},
              "probe": {"rows": 20000, "dtype": "int32",
                        "keys": {"dist": "zipf", "alpha": 1.05, "lo": 1, "hi": 500},
                        "payloads": {"dist": "uniform", "lo": 0, "hi": 1 << 20}}}
    cpu = torch.device("cpu")
    a = generate.make_pair(config, 2**40 + 1, 0, cpu)
    b = generate.make_pair(config, 2**40 + 1, 0, cpu)
    c = generate.make_pair(config, 2**40 + 1, 1, cpu)
    assert torch.equal(a[1].keys, b[1].keys) and torch.equal(a[1].payloads, b[1].payloads)
    assert not torch.equal(a[1].keys, c[1].keys)
    assert a[0].keys.tolist() == list(range(1, 501))
    assert torch.equal(a[0].payloads, a[0].keys ^ 23063)
    keys = a[1].keys
    assert keys.dtype == torch.int32 and int(keys.min()) >= 1 and int(keys.max()) <= 500
    # the exact law: P(1) = 1 / H(500, 1.05)
    h = sum(k ** -1.05 for k in range(1, 501))
    share = float((keys == 1).float().mean())
    assert abs(share - 1 / h) < 0.01
    assert int(torch.unique(keys).numel()) > 450


def test_permutation_keys():
    spec = {"rows": 1000, "dtype": "int32",
            "keys": {"dist": "permutation", "lo": 1, "hi": 1000},
            "payloads": {"dist": "uniform", "lo": 0, "hi": 16}}
    r = generate.make_relation(spec, 5, 0, 0, torch.device("cpu"))
    assert sorted(r.keys.tolist()) == list(range(1, 1001))
    assert r.keys.tolist() != list(range(1, 1001))


def test_int64_relations_and_sums():
    cpu = torch.device("cpu")
    spec = {"rows": 3000, "dtype": "int64",
            "keys": {"dist": "zipf", "alpha": 1.05, "lo": 1, "hi": 100},
            "payloads": {"dist": "uniform", "lo": 0, "hi": 1 << 20}}
    r = generate.make_relation(spec, 9, 0, 1, cpu)
    assert r.keys.dtype == r.payloads.dtype == torch.int64
    assert int(r.keys.min()) >= 1 and int(r.keys.max()) <= 100
    # an int64 SUM does not wrap at 2^32; COUNT stays an int32 column
    build = torch.tensor([1], dtype=torch.int64)
    pay = torch.full((3,), 2**30, dtype=torch.int64)
    got = joins.join_groupby_top(build, torch.ones(3, dtype=torch.int64), pay, k=1)
    assert got["sum"].tolist() == [3 * 2**30] and got["sum"].dtype == np.int64
    assert got["count"].dtype == np.int32 and got["min"].dtype == np.int64
