"""The distributed operators and R6 across processes: 2 processes x 4 shards.

Counterpart, across processes, of tests/test_torch_dist_aggregate.py and
tests/test_torch_dist_join.py, which hold the one-process runs to the JAX
package.  One pair of spawned processes (one torch thread each, gloo on the
CPU) joins a ``torch.distributed`` group, each process holding its
``host_slice`` of the same global rows, and runs every step of
``dryrun.ops_steps`` and the scenarios below on the global mesh; what each
process returns is held to the port's one-process 8-shard run on the
concatenated rows, bit for bit, and to a numpy oracle.  This file does not
import jax.
"""

import inspect
import json
import os
import sys

import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu_torch import dryrun
from partitionedhashjoin_tpu_torch.ops import generators
from partitionedhashjoin_tpu_torch.parallel import mesh as pm
from partitionedhashjoin_tpu_torch.query import scan

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_A, N_B = 4096, 16384
SEED = 3
GROUP_CAPACITY = 4096
SALT = dryrun.SALT
STEPS = [name for name, _ in dryrun.ops_steps(
    None, [torch.zeros(0, dtype=torch.int32)] * 4, SEED, None)]
#: Operators that hash rows: each refuses ``seed=None`` across processes.
HASHING = ("aggregate", "join_aggregate", "materialize", "multi_key")
#: Calls given unequal row counts in the two processes.
UNEQUAL = ("aggregate", "top_k", "join_aggregate", "materialize", "multi_key",
           "query_count", "sql_count")


def _flatten(obj, prefix="out"):
    """Every tensor, array and number in ``obj`` as numpy arrays, keyed by
    their path (dataclass fields, tuple positions and dict keys); a
    GROUP BY's ``group_of_row`` and a table's ``uuid`` are left out."""
    if isinstance(obj, torch.Tensor):
        return {prefix: obj.numpy()}
    if isinstance(obj, (np.ndarray, np.generic, int, float, bool)):
        return {prefix: np.asarray(obj)}
    items = ()
    if isinstance(obj, (tuple, list)):
        items = enumerate(obj)
    elif isinstance(obj, dict):
        items = obj.items()
    elif hasattr(obj, "__dataclass_fields__"):
        items = ((f, getattr(obj, f)) for f in obj.__dataclass_fields__
                 if f not in ("group_of_row", "uuid"))
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}.{k}"))
    return out


def _queries(a, b, mesh, scan, execute_sql):
    """The R6 shapes beyond ``ops_steps``: name -> thunk."""
    even = lambda k, p: p % 2 == 0  # noqa: E731
    return {
        "filter count": lambda: scan(b).filter(even).count(mesh=mesh),
        "scalar aggregate": lambda: scan(b).aggregate(with_distinct=True, mesh=mesh),
        "filter execute": lambda: scan(b).filter(lambda k, p: p % 97 == 0).execute(mesh=mesh),
        "filter top_k": lambda: scan(b).filter(even).order_by("payload").limit(7)
        .execute(mesh=mesh),
        "join execute": lambda: scan(b).join(scan(a), join_type="left").execute(mesh=mesh),
        "join filter group_by": lambda: scan(b).join(scan(a)).filter(
            lambda k, p: p % 3 == 0).group_by().order_by("sum", descending=True)
        .limit(5).execute(mesh=mesh),
        "filtered join group_by": lambda: scan(b).filter(even).join(
            scan(a).filter(lambda k, p: k % 3 != 0)).group_by().order_by("count")
        .limit(6).execute(mesh=mesh),
        "sql filtered scalar": lambda: execute_sql(
            "SELECT SUM(b.payload), MIN(b.payload), COUNT(*) FROM b WHERE b.key % 5 = 1",
            {"a": a, "b": b}, mesh=mesh),
        "sql join count": lambda: execute_sql(
            "SELECT COUNT(*) FROM b JOIN a USING (key) WHERE b.payload % 2 = 0",
            {"a": a, "b": b}, mesh=mesh),
    }


QUERIES = list(_queries(None, None, None, None, None))

#: One process of the pair: argv = coordinator, process id, the .npz of the
#: global rows, the output directory.
_WORKER = inspect.getsource(_flatten) + inspect.getsource(_queries) + r'''
import json, sys
import numpy as np, torch
from partitionedhashjoin_tpu_torch import dryrun
from partitionedhashjoin_tpu_torch.data.table import make_table
from partitionedhashjoin_tpu_torch.parallel import distributed, mesh as pm
from partitionedhashjoin_tpu_torch.parallel.aggregate_shuffle import DistributedAggregateOperator
from partitionedhashjoin_tpu_torch.parallel.join_aggregate import DistributedJoinAggregateOperator
from partitionedhashjoin_tpu_torch.parallel.materialize_shuffle import DistributedMaterializeJoiner
from partitionedhashjoin_tpu_torch.parallel.multi_key_shuffle import MultiKeyShuffleJoiner
from partitionedhashjoin_tpu_torch.parallel.top_k import distributed_top_k
from partitionedhashjoin_tpu_torch.query import scan
from partitionedhashjoin_tpu_torch.sql import execute_sql

coord, pid, data, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
SEED, GC = int(sys.argv[5]), int(sys.argv[6])
rel = dict(np.load(data))
distributed.initialize(coord, 2, pid, platform="cpu", timeout_s=60)
mesh = distributed.global_mesh(8)

def local(x):
    start, rows = distributed.host_slice(x.shape[0])
    return torch.from_numpy(x[start:start + rows].copy())

cols = [local(rel[k]) for k in ("a_keys", "a_pay", "b_keys", "b_pay")]
a, b = make_table(cols[0], cols[1]), make_table(cols[2], cols[3])
arrays, res = {}, {"runs": {}, "refused": {}, "seed_none": {}}
x = (10 * (torch.arange(4) + 4 * pid)[:, None] + torch.arange(3)[None, :]) % 23
arrays["pmax"] = pm.pmax(x, mesh).numpy()
for name, run in dryrun.ops_steps(mesh, cols, SEED, GC):
    result, last_run = run()
    arrays.update(_flatten(result, name))
    res["runs"][name] = dryrun.digest(last_run)
for name, run in _queries(a, b, mesh, scan, execute_sql).items():
    arrays.update(_flatten(run(), name))
# only process 0's rows overflow the combiner's capacity: both retry
rk = local(rel["retry_keys"])
op = DistributedAggregateOperator(mesh, seed=SEED)
arrays.update(_flatten(op.run(make_table(rk, rk.clone()), group_capacity=16), "retry"))
res["retry"] = dryrun.digest(op.last_run)
# unequal row counts, and a mask of the wrong length in process 0 only
half = 512 if pid else 1024
ua, ub = make_table(cols[0][:half], cols[1][:half]), make_table(cols[2][:half], cols[3][:half])
calls = {
    "aggregate": lambda: DistributedAggregateOperator(mesh, seed=1).run(ub),
    "top_k": lambda: distributed_top_k(mesh, ub, 4),
    "join_aggregate": lambda: DistributedJoinAggregateOperator(mesh, seed=1).run(ua, ub),
    "materialize": lambda: DistributedMaterializeJoiner(mesh, seed=1).run(ua, ub),
    "multi_key": lambda: MultiKeyShuffleJoiner(mesh, seed=1).run([ua.keys], [ub.keys]),
    "query_count": lambda: scan(ub).join(scan(ua)).count(mesh=mesh),
    "sql_count": lambda: execute_sql("SELECT COUNT(*) FROM b", {"b": ub}, mesh=mesh),
    "mask": lambda: DistributedAggregateOperator(mesh, seed=1).run(
        b, mask=torch.ones(b.size - 8 * (1 - pid), dtype=torch.bool)),
    "mask_2d": lambda: DistributedAggregateOperator(mesh, seed=1).run(
        b, mask=torch.ones(b.size, dtype=torch.bool).reshape((-1,) if pid else (2, -1))),
    "top_k_mask": lambda: distributed_top_k(
        mesh, b, 4, mask=torch.ones(b.size - 8 * (1 - pid), dtype=torch.bool)),
}
for name, call in calls.items():
    try:
        call()
        res["refused"][name] = "accepted"
    except ValueError as e:
        res["refused"][name] = str(e)
for name, cls in zip(HASHING_NAMES, (DistributedAggregateOperator, DistributedJoinAggregateOperator,
                         DistributedMaterializeJoiner, MultiKeyShuffleJoiner)):
    try:
        cls(mesh)
        res["seed_none"][name] = "accepted"
    except ValueError as e:
        res["seed_none"][name] = str(e)
# the collectives still line up after every refusal
res["after"] = int(pm.psum(torch.ones(4, dtype=torch.int64), mesh))
np.savez(f"{out}/arrays{pid}.npz", **arrays)
json.dump(res, open(f"{out}/result{pid}.json", "w"))
distributed.shutdown()
print(f"OPS_OK pid={pid}", flush=True)
'''.replace("HASHING_NAMES", repr(HASHING))


def _relations():
    """The global rows: a shuffled build 1..N_A with payload key ^ SALT, a
    Zipf(1.25) probe over it with 2% of its keys off the build's range and
    payloads uniform in [0, 2^20), and the retry relation: process 0's
    half distinct keys, process 1's one key."""
    rng = np.random.default_rng(29)
    a_keys = rng.permutation(np.arange(1, N_A + 1, dtype=np.int32))
    b_keys = generators.zipf_table(N_B, 1.25, (1, N_A), seed=SEED,
                                   device="cpu").keys.numpy()
    b_keys = np.where(rng.random(N_B) < 0.02, b_keys + N_A, b_keys).astype(np.int32)
    return {
        "a_keys": a_keys, "a_pay": a_keys ^ SALT, "b_keys": b_keys,
        "b_pay": rng.integers(0, 1 << 20, N_B).astype(np.int32),
        "retry_keys": np.concatenate([np.arange(1, 2049, dtype=np.int32),
                                      np.full(2048, 7, np.int32)]),
    }


@pytest.fixture(scope="module")
def relations():
    return _relations()


@pytest.fixture(scope="module")
def pair(relations, tmp_path_factory):
    """The worker in 2 processes: per process, ``(arrays, results)``."""
    out = tmp_path_factory.mktemp("ops")
    data = out / "relations.npz"
    np.savez(data, **relations)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    coord = dryrun.free_coordinator()
    results = dryrun.run_processes(
        [[sys.executable, "-c", _WORKER, coord, str(pid), str(data), str(out), str(SEED),
          str(GROUP_CAPACITY)] for pid in range(2)], 120, env=env, cwd=REPO)
    for pid, (_, stdout, _) in enumerate(results):
        assert f"OPS_OK pid={pid}" in stdout
    return [(dict(np.load(out / f"arrays{pid}.npz")),
             json.loads((out / f"result{pid}.json").read_text())) for pid in range(2)]


@pytest.fixture(scope="module")
def one_process(relations):
    """The same global rows on a one-process 8-shard mesh: ``(mesh, tables
    as columns, a, b)``."""
    from partitionedhashjoin_tpu_torch.data.table import make_table

    mesh = pm.make_mesh(8, devices=["cpu"])
    cols = [torch.from_numpy(relations[k]) for k in ("a_keys", "a_pay", "b_keys", "b_pay")]
    return mesh, cols, make_table(cols[0], cols[1]), make_table(cols[2], cols[3])


def _equal_to_one_process(pair, flat):
    """Every array of ``flat`` (the one-process result, flattened) equals
    both processes' bit for bit, dtype and shape included."""
    for arrays, _ in pair:
        keys = {k for k in arrays if k.split(".")[0] == next(iter(flat)).split(".")[0]}
        assert keys == set(flat)
        for k, want in flat.items():
            got = arrays[k]
            assert got.dtype == want.dtype and np.array_equal(got, want), k


def _groups(keys, pays):
    """The numpy GROUP BY oracle: key -> (count, sum mod 2^32, min, max,
    distinct payloads)."""
    out = {}
    for k in np.unique(keys):
        p = pays[keys == k].astype(np.int64)
        s = (int(p.sum()) + 2**31) % 2**32 - 2**31
        out[int(k)] = (len(p), s, int(p.min()), int(p.max()), len(np.unique(p)))
    return out


def _as_groups(arrays, name, distinct=False):
    n = int(arrays[f"{name}.num_groups"])
    cols = [arrays[f"{name}.{f}"][:n] for f in ("keys", "count", "sum", "min", "max")]
    if distinct:
        cols.append(arrays[f"{name}.distinct"][:n])
    return {int(k): tuple(int(c[i]) for c in cols[1:]) for i, k in enumerate(cols[0])}


def _top(vals, carried, k, descending):
    """Rows ordered by value (descending or not), ties by row: the first k."""
    v = vals.astype(np.int64)
    order = np.lexsort((np.arange(len(v)), -v if descending else v))[:k]
    return vals[order], carried[order]


def _step_oracle(name, arrays, r):
    """Hold one ``ops_steps`` result (process 0's arrays) to numpy."""
    ak, bk, bp = r["a_keys"], r["b_keys"], r["b_pay"]
    even = bp % 2 == 0
    hit = np.isin(bk, ak)
    if name.startswith("(a)"):
        keep = even if "mask" in name else np.ones_like(hit)
        want = _groups(bk[keep], bp[keep])
        distinct = "distinct" in name
        got = _as_groups(arrays, name, distinct)
        assert got == {k: v if distinct else v[:4] for k, v in want.items()}
    elif name.startswith("(b)"):
        keep = even if "mask" in name else np.ones_like(hit)
        by_key = "key" in name.split()[2]
        vals, carried = (bk, bp) if by_key else (bp, bk)
        want_v, want_c = _top(vals[keep], carried[keep], 10, True)
        got_k, got_p = arrays[f"{name}.0.keys"], arrays[f"{name}.0.payloads"]
        assert np.array_equal(got_k if by_key else got_p, want_v)
        assert np.array_equal(got_p if by_key else got_k, want_c)
        assert int(arrays[f"{name}.1"]) == 10
    elif name.startswith("(c)"):
        want = _groups(bk[hit], bp[hit])
        assert _as_groups(arrays, name) == {k: v[:4] for k, v in want.items()}
    elif name.startswith("(d)"):
        jt = name.split()[2]
        keep = {"inner": hit, "anti": ~hit, "left": np.ones_like(hit),
                "semi": hit & even}[jt]
        matched = hit[keep] if jt == "left" else np.full(int(keep.sum()), jt != "anti")
        keys = bk[keep]
        want = sorted(zip(keys.tolist(), np.where(matched, keys ^ SALT, 0).tolist(),
                          bp[keep].tolist(), matched.tolist()))
        n = int(arrays[f"{name}.count"])
        got = sorted(zip(*(arrays[f"{name}.{f}"][:n].tolist() for f in
                           ("keys", "payloads_a", "payloads_b", "matched"))))
        assert got == want
    elif name.startswith("(e)") or name == "(f) sql count":
        key = f"{name}.columns.count" if name.startswith("(f)") else name
        assert int(np.asarray(arrays[key]).reshape(-1)[0]) == int(hit.sum())
    else:  # the pipeline statement: a top-10 of the join's groups by count
        groups = _groups(bk[hit], bp[hit])
        counts = arrays[f"{name}.columns.count"]
        assert counts.tolist() == sorted((g[0] for g in groups.values()), reverse=True)[:10]
        for row in zip(*(arrays[f"{name}.columns.{c}"] for c in
                         ("key", "count", "sum", "min", "max"))):
            assert groups[int(row[0])][:4] == tuple(int(v) for v in row[1:])


@pytest.mark.parametrize("name", STEPS)
def test_step_equals_one_process(pair, relations, one_process, name):
    """Each step of ``ops_steps`` gives, in both processes, the one-process
    8-shard result bit for bit, the same ``last_run`` (attempts, retries,
    exchange bytes), and what numpy computes."""
    mesh, cols, _, _ = one_process
    result, last_run = dict(dryrun.ops_steps(mesh, cols, SEED, GROUP_CAPACITY))[name]()
    _equal_to_one_process(pair, _flatten(result, name))
    for _, res in pair:
        assert res["runs"][name] == json.loads(json.dumps(dryrun.digest(last_run)))
    _step_oracle(name, pair[0][0], relations)


@pytest.mark.parametrize("name", QUERIES)
def test_query_equals_one_process(pair, relations, one_process, name):
    """R6 shapes that read a scanned relation whole (the count ``psum``'d,
    the scalar aggregate and the filtered table over the gathered rows), a
    replicated join output into a table result and into the distributed
    GROUP BY (each process's slice), and the filtered join → GROUP BY."""
    from partitionedhashjoin_tpu_torch.sql import execute_sql

    mesh, _, a, b = one_process
    _equal_to_one_process(pair, _flatten(_queries(a, b, mesh, scan, execute_sql)[name](),
                                         name))
    arrays = pair[0][0]
    bk, bp = relations["b_keys"], relations["b_pay"]
    if name == "filter count":
        assert int(arrays[name]) == int((bp % 2 == 0).sum())
    elif name == "scalar aggregate":
        s = (int(bp.astype(np.int64).sum()) + 2**31) % 2**32 - 2**31
        assert [int(arrays[f"{name}.{f}"]) for f in ("count", "sum", "min", "max",
                                                     "distinct")] == [
            N_B, s, int(bp.min()), int(bp.max()), len(np.unique(bp))]
    elif name == "filter execute":
        keep = bp % 97 == 0
        n = int(arrays[f"{name}.count"])
        assert n == int(keep.sum())
        assert np.array_equal(arrays[f"{name}.table.keys"][:n], bk[keep])


def test_pmax_across_processes(pair):
    """``pmax`` is the max over the local shards, then over the processes."""
    x = (10 * np.arange(8)[:, None] + np.arange(3)[None, :]) % 23
    for arrays, _ in pair:
        assert np.array_equal(arrays["pmax"], x.max(axis=0))


def test_overflow_on_one_process_retries_on_both(pair, relations):
    """Process 0's rows hold 2,048 distinct keys, process 1's one key: only
    process 0's combiners overflow 16 group slots, but the ``pmax``'d need
    makes both retry, with the attempts of one process over the same rows."""
    from partitionedhashjoin_tpu_torch.data.table import table_from_numpy
    from partitionedhashjoin_tpu_torch.parallel.aggregate_shuffle import (
        DistributedAggregateOperator,
    )

    rk = relations["retry_keys"]
    op = DistributedAggregateOperator(pm.make_mesh(8, devices=["cpu"]), seed=SEED)
    g = op.run(table_from_numpy(rk, rk, "cpu"), group_capacity=16)
    assert op.last_run.retries > 0 and op.last_run.attempts[0]["local_need"] == 512
    _equal_to_one_process(pair, _flatten(g, "retry"))
    for _, res in pair:
        assert res["retry"] == json.loads(json.dumps(dryrun.digest(op.last_run)))
    assert int(g.num_groups) == 2048


@pytest.mark.parametrize("name", UNEQUAL)
def test_unequal_rows_refused_in_both(pair, name):
    """1,024 rows in process 0 and 512 in process 1: every operator and the
    query layer raise ``ValueError`` in both processes, and the collectives
    after it still line up."""
    for _, res in pair:
        assert "unequal" in res["refused"][name], res["refused"][name]
        assert res["after"] == 8


@pytest.mark.parametrize("name,shape", [("mask", (8184,)), ("mask_2d", (2, 4096)),
                                        ("top_k_mask", (8184,))])
def test_bad_mask_in_one_process_refused_in_both(pair, name, shape):
    """A mask of the wrong shape in process 0 only (8 rows short, or 2-D
    with the right element count), given to the GROUP BY or the top k:
    process 0 names it, process 1 raises that process 0 refused its
    inputs."""
    (_, r0), (_, r1) = pair
    assert f"mask shape {shape} must match table rows (8192,)" in r0["refused"][name]
    assert r1["refused"][name] == "process 0 refused its relation inputs"


@pytest.mark.parametrize("op", ["aggregate", "top_k"])
@pytest.mark.parametrize("rows", [(8,), (16,), (2, 5)])
def test_bad_mask_refused_on_one_process(op, rows):
    """On a one-process mesh a mask whose shape is not the table's rows
    (short, long or 2-D) raises ``ValueError`` before any padding, in the
    GROUP BY and the top k alike; the table's 10 rows pad to 16."""
    from partitionedhashjoin_tpu_torch.data.table import make_table
    from partitionedhashjoin_tpu_torch.parallel.aggregate_shuffle import (
        DistributedAggregateOperator,
    )
    from partitionedhashjoin_tpu_torch.parallel.top_k import distributed_top_k

    mesh = pm.make_mesh(8, devices=["cpu"])
    keys = torch.arange(10, dtype=torch.int32)
    t, mask = make_table(keys, keys.clone()), torch.ones(rows, dtype=torch.bool)
    with pytest.raises(ValueError, match=r"mask shape .* must match table rows \(10,\)"):
        if op == "aggregate":
            DistributedAggregateOperator(mesh, seed=1).run(t, mask=mask)
        else:
            distributed_top_k(mesh, t, 1, mask=mask)


@pytest.mark.parametrize("name", HASHING)
def test_seed_none_refused_across_processes(pair, name):
    for _, res in pair:
        assert "seed=None on a mesh over 2 processes" in res["seed_none"][name]
