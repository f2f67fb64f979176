"""The port's multi-process execution: 2 processes x 4 shards, gloo on the CPU.

Counterpart of tests/test_multiprocess.py.  Real separate processes (one
torch thread each) join a ``torch.distributed`` group, hold per-process
slices of the same global rows, and run the shuffle join over the global
mesh; what they compute is held to the port's one-process 8-shard run on
the same rows (itself held to JAX's ``_exchange`` in test_torch_shuffle.py)
and to ``np.isin``.  A few fixtures start every process pair once per
module: the dry-run worker's oracles, one worker that runs every scenario
below and saves what it saw, the CLI, and a peer that dies.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu.parallel import distributed as jax_distributed
from partitionedhashjoin_tpu_torch import dryrun
from partitionedhashjoin_tpu_torch.data.table import table_from_numpy
from partitionedhashjoin_tpu_torch.ops import generators
from partitionedhashjoin_tpu_torch.parallel import distributed
from partitionedhashjoin_tpu_torch.parallel import mesh as pm
from partitionedhashjoin_tpu_torch.parallel import shuffle as ps

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_A, N_B = 4096, 16384
SEED = 3
#: The joiner runs of the scenario worker: name -> (options, masked).
RUNS = {
    "sort-merge": ({}, False),
    "hash": ({"local_join": "hash"}, False),
    "pipelined-2": ({"pipeline_chunks": 2}, False),
    "pipelined-4": ({"pipeline_chunks": 4}, False),
    "no-skew": ({"handle_skew": False}, False),
    "masked": ({}, True),
    "masked-hash": ({"local_join": "hash"}, True),
    "masked-pipelined": ({"pipeline_chunks": 2}, True),
}
RUN_FIELDS = ("num_shards", "drops", "cap_a", "cap_b", "hot_cap", "hot_keys")

#: One process of the scenario worker: argv = coordinator, process id, the
#: .npz of the global rows, the output directory.
_WORKER = r'''
import json, sys
import numpy as np, torch
from partitionedhashjoin_tpu_torch import dryrun
from partitionedhashjoin_tpu_torch.data.table import make_table
from partitionedhashjoin_tpu_torch.parallel import distributed, mesh as pm, shuffle as ps

coord, pid, data, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
RUNS, SEED = json.loads(sys.argv[5]), int(sys.argv[6])
SEED_HOT = (SEED ^ 0x9E3779B9) & 0xFFFFFFFF
rel = dict(np.load(data))
distributed.initialize(coord, 2, pid, platform="cpu", timeout_s=60)
mesh = distributed.global_mesh(8)
res = {"backend": mesh.backend, "local_size": mesh.local_size,
       "process_index": mesh.process_index, "process_count": mesh.process_count}

def local(x):
    start, rows = distributed.host_slice(x.shape[0])
    return torch.from_numpy(x[start:start + rows].copy())

ka, pa, kb, pb, va, vb = (local(rel[k]) for k in ("ka", "pa", "kb", "pb", "va", "vb"))
# the collectives on known values: x[src_local, dst] = 10 * src + dst
src = torch.arange(4) + 4 * pid
x = (10 * src[:, None] + torch.arange(8)[None, :]).to(torch.int32)
res["all_to_all"] = pm.all_to_all(x, mesh).tolist()
res["all_to_all_bool"] = pm.all_to_all(x % 3 == 0, mesh).tolist()
res["all_gather"] = pm.all_gather(src[:, None].repeat(1, 2), mesh).tolist()
res["psum"] = int(pm.psum(src, mesh))
# the hot plan and one exchange at the joiner's capacities
hk, hv = ps.plan_hot_keys(kb, 16_384, 64, 0.005, seed=SEED_HOT, mesh=mesh)
ex = ps._exchange(mesh, ka, pa, kb, pb, SEED, hk, hv, 129, 513, 64, True,
                  valid_a=va, valid_b=vb)
np.savez(f"{out}/exchange{pid}.npz", hk=hk.numpy(), hv=hv.numpy(),
         **{f"x{i}": t.numpy() for i, t in enumerate(ex[:10])},
         drops=np.array([int(ex[10].dropped_a), int(ex[10].dropped_b),
                         int(ex[10].dropped_hot)]))
ta, tb = make_table(ka, pa), make_table(kb, pb)
runs = {}
for name, (options, masked) in RUNS.items():
    j = ps.DistributedShuffleJoiner(mesh, seed=SEED, **options)
    mesh.comm.reset()
    count = j.run(ta, tb, **({"valid_a": va, "valid_b": vb} if masked else {}))
    r = j.last_run
    runs[name] = {"count": count, "num_shards": r.num_shards,
                  "drops": [list(d) for d in r.drops], "cap_a": r.cap_a,
                  "cap_b": r.cap_b, "hot_cap": r.hot_cap, "hot_keys": r.hot_keys,
                  "local_shards": r.local_shards,
                  "cross_process_bytes": r.cross_process_bytes,
                  "comm_sent": dict(mesh.comm.sent), "comm_calls": mesh.comm.calls,
                  "comm_seconds": mesh.comm.seconds}
res["runs"] = runs
# only process 0's rows overflow their buckets: both processes retry
ra, rb = local(rel["retry_a"]), local(rel["retry_b"])
j = ps.DistributedShuffleJoiner(mesh, seed=SEED, handle_skew=False, max_retries=4)
count = j.run(make_table(ra, ra.clone()), make_table(rb, rb.clone()))
res["retry"] = {"count": count, "drops": [list(d) for d in j.last_run.drops],
                "cap_b": j.last_run.cap_b}
try:
    ps.DistributedShuffleJoiner(mesh)
    res["seed_none"] = "accepted"
except ValueError as e:
    res["seed_none"] = str(e)
json.dump(res, open(f"{out}/result{pid}.json", "w"))
distributed.shutdown()
print(f"SCENARIO_OK pid={pid}", flush=True)
'''


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return env


def _relations():
    """The global rows: a 1..N_A build in a shuffled order, a Zipf(1.25)
    probe over it with 2% of its keys off the build's range, validity masks,
    and the retry relations: the build 1..1024, and a probe whose first
    half (process 0's) is one key and second half (process 1's) distinct."""
    rng = np.random.default_rng(17)
    ka = rng.permutation(np.arange(1, N_A + 1, dtype=np.int32))
    kb = generators.zipf_table(N_B, 1.25, (1, N_A), seed=SEED, device="cpu").keys.numpy()
    miss = rng.random(N_B) < 0.02
    kb = np.where(miss, kb + N_A, kb).astype(np.int32)
    return {
        "ka": ka, "pa": ka ^ 0x5A17, "kb": kb, "pb": np.arange(N_B, dtype=np.int32),
        "va": ka % 3 != 0, "vb": rng.random(N_B) < 0.7,
        "retry_a": np.arange(1, 1025, dtype=np.int32),
        "retry_b": np.concatenate([np.full(2048, 7, np.int32),
                                   np.arange(1, 2049, dtype=np.int32)]),
    }


@pytest.fixture(scope="module")
def relations():
    return _relations()


@pytest.fixture(scope="module")
def scenario(relations, tmp_path_factory):
    """The scenario worker in 2 processes: ``(per-process results, the
    directory of their saved exchanges)``."""
    out = tmp_path_factory.mktemp("scenario")
    data = out / "relations.npz"
    np.savez(data, **relations)
    coord = dryrun.free_coordinator()
    results = dryrun.run_processes(
        [[sys.executable, "-c", _WORKER, coord, str(pid), str(data), str(out),
          json.dumps(RUNS), str(SEED)] for pid in range(2)], 120, env=_env(), cwd=REPO)
    for pid, (_, stdout, _) in enumerate(results):
        assert f"SCENARIO_OK pid={pid}" in stdout
    return [json.loads((out / f"result{pid}.json").read_text()) for pid in range(2)], out


@pytest.fixture(scope="module")
def one_process(relations):
    """The same global rows on a one-process 8-shard mesh."""
    mesh = pm.make_mesh(8, devices=["cpu"])
    ta = pm.shard_table(table_from_numpy(relations["ka"], relations["pa"], "cpu"), mesh)
    tb = pm.shard_table(table_from_numpy(relations["kb"], relations["pb"], "cpu"), mesh)
    va = pm.shard_array(torch.from_numpy(relations["va"]), mesh)
    vb = pm.shard_array(torch.from_numpy(relations["vb"]), mesh)
    return mesh, ta, tb, va, vb


def test_dryrun_worker_oracles():
    """The JAX worker's three oracles (tests/mp_worker.py) in 2 processes x
    4 shards: the even-key join counts 4096, the generated Zipf join and its
    pipelined exchange 4096."""
    lines = dryrun.dryrun_multiprocess(2, 4, platform="cpu", timeout_s=120, env=_env())
    assert lines == [f"MP_OK pid={pid} counts=4096,4096,4096 backend=gloo"
                     for pid in range(2)]


def test_mesh_over_processes(scenario):
    results, _ = scenario
    for pid, res in enumerate(results):
        assert (res["backend"], res["local_size"], res["process_index"],
                res["process_count"]) == ("gloo", 4, pid, 2)


def test_collectives_across_processes(scenario):
    """``all_to_all`` delivers ``[dst_local, src]`` what global shard src
    sent to dst (bool too), ``all_gather`` every shard in global order,
    ``psum`` the global sum."""
    results, _ = scenario
    for pid, res in enumerate(results):
        dst = np.arange(4) + 4 * pid
        want = 10 * np.arange(8)[None, :] + dst[:, None]
        assert np.array_equal(res["all_to_all"], want)
        assert np.array_equal(res["all_to_all_bool"], want % 3 == 0)
        assert res["all_gather"] == [s for s in range(8) for _ in range(2)]
        assert res["psum"] == sum(range(8))


def test_hot_plan_equals_one_process(scenario, relations):
    """Every process plans the hot keys of the global sample."""
    _, out = scenario
    want_k, want_v = ps.plan_hot_keys(torch.from_numpy(relations["kb"]), 16_384, 64,
                                      0.005, seed=(SEED ^ 0x9E3779B9) & 0xFFFFFFFF)
    assert int(want_v.sum()) > 0
    for pid in range(2):
        saved = np.load(out / f"exchange{pid}.npz")
        assert np.array_equal(saved["hk"], want_k.numpy())
        assert np.array_equal(saved["hv"], want_v.numpy())


def test_exchange_equals_one_process(scenario, relations, one_process):
    """The received rows of every shard, the hot probe mask, the replicated
    hot build rows and the drop counts equal the one-process exchange's bit
    for bit (process-major: process 0 holds global shards 0-3)."""
    _, out = scenario
    mesh, ta, tb, va, vb = one_process
    hk, hv = ps.plan_hot_keys(tb.keys, 16_384, 64, 0.005,
                              seed=(SEED ^ 0x9E3779B9) & 0xFFFFFFFF)
    want = ps._exchange(mesh, ta.keys, ta.payloads, tb.keys, tb.payloads, SEED, hk, hv,
                        129, 513, 64, True, valid_a=va, valid_b=vb)
    saved = [np.load(out / f"exchange{pid}.npz") for pid in range(2)]
    for i in range(7):  # received A and B (keys, pays, valid), is_hot_b
        got = np.concatenate([s[f"x{i}"] for s in saved])
        assert np.array_equal(got, want[i].numpy()), i
    for i in range(7, 10):  # the replicated hot rows, on every process
        for s in saved:
            assert np.array_equal(s[f"x{i}"], want[i].numpy()), i
    drops = sum(s["drops"] for s in saved)
    assert drops.tolist() == [int(want[10].dropped_a), int(want[10].dropped_b),
                              int(want[10].dropped_hot)]


@pytest.mark.parametrize("name", list(RUNS))
def test_join_equals_one_process(scenario, relations, one_process, name):
    """Each local join and option counts exactly, and its ``ShuffleRun``
    (drops per attempt, capacities, hot keys) equals the one-process
    8-shard run's on both processes."""
    results, _ = scenario
    mesh, ta, tb, va, vb = one_process
    options, masked = RUNS[name]
    joiner = ps.DistributedShuffleJoiner(mesh, seed=SEED, **options)
    count = joiner.run(ta, tb, **({"valid_a": va, "valid_b": vb} if masked else {}))
    keep_b = relations["vb"] if masked else np.ones(N_B, bool)
    keep_a = relations["va"] if masked else np.ones(N_A, bool)
    assert count == int((keep_b & np.isin(relations["kb"], relations["ka"][keep_a])).sum())
    want = {f: getattr(joiner.last_run, f) for f in RUN_FIELDS}
    want["drops"] = [list(d) for d in want["drops"]]
    for res in results:
        got = res["runs"][name]
        assert got["count"] == count
        assert {f: got[f] for f in RUN_FIELDS} == want
        assert got["local_shards"] == 4
        # 4 local x 4 remote shards; the pipelined probe sends B's keys and
        # valid flags only
        b_slot = ps.KEY_SLOT_BYTES if "pipeline_chunks" in options else ps.ROW_SLOT_BYTES
        assert got["cross_process_bytes"] == 16 * (
            got["cap_a"] * ps.ROW_SLOT_BYTES + got["cap_b"] * b_slot)


@pytest.mark.parametrize("name", list(RUNS))
def test_exchange_bytes_are_what_crosses(scenario, name):
    """``ShuffleRun.cross_process_bytes`` is what the ``all_to_all`` calls
    of the accepted attempt sent across the process boundary (all of them
    when there was one attempt; an attempt that overflowed sent more); the
    rest of ``mesh.comm``'s bytes are the small collectives (hot rows,
    sample, drop and count sums), each call spanned and timed."""
    results, _ = scenario
    for res in results:
        got = res["runs"][name]
        sent = got["comm_sent"]
        if len(got["drops"]) == 1:
            assert sent["all_to_all"] == got["cross_process_bytes"] > 0
        else:
            assert sent["all_to_all"] > got["cross_process_bytes"] > 0
        assert set(sent) <= {"all_to_all", "all_gather", "psum"} and sent["psum"] > 0
        assert got["comm_calls"] >= 7 and got["comm_seconds"] > 0


def test_overflow_on_one_process_retries_on_both(scenario, relations):
    """Process 0's probe rows are one key, so only its buckets overflow at
    the first attempt's capacity; the summed drops make both processes
    retry, at the same capacities as one process over the same rows."""
    results, _ = scenario
    retry_b = relations["retry_b"]
    first_cap = 129  # 512 rows per shard, 64 per destination, slack 2
    for pid in range(2):
        rows = torch.from_numpy(retry_b[pid * 2048:(pid + 1) * 2048]).view(4, -1)
        owners = ps._owner_shard(rows, SEED, 8)
        per_dest = torch.stack([torch.bincount(o, minlength=8) for o in owners])
        assert (int(per_dest.max()) > first_cap) == (pid == 0)
    mesh = pm.make_mesh(8, devices=["cpu"])
    joiner = ps.DistributedShuffleJoiner(mesh, seed=SEED, handle_skew=False, max_retries=4)
    a = table_from_numpy(relations["retry_a"], relations["retry_a"], "cpu")
    b = table_from_numpy(retry_b, retry_b, "cpu")
    assert joiner.run(a, b) == 2048 + 1024
    want = [list(d) for d in joiner.last_run.drops]
    assert len(want) > 1 and want[0][1] > 0 and want[-1] == [0, 0, 0]
    for res in results:
        assert res["retry"] == {"count": 3072, "drops": want,
                                "cap_b": joiner.last_run.cap_b}


def test_seed_none_refused_across_processes(scenario):
    results, _ = scenario
    for res in results:
        assert "seed=None on a mesh over 2 processes" in res["seed_none"]


def test_cli_renders_on_process_zero(tmp_path):
    """As tests/test_multiprocess.py's CLI test: two processes, 8 shards;
    process 0 writes the one document, process 1 prints none."""
    outfile = tmp_path / "mp_result.json"
    base = [sys.executable, "-m", "partitionedhashjoin_tpu_torch",
            "--coordinator", dryrun.free_coordinator(), "--num-processes", "2",
            "--platform", "cpu", "--join", "shuffle", "--shards", "8",
            "--primary", "1024", "--secondary", "4096", "--seed", "9",
            "--log", "info", "--no-warmup"]
    results = dryrun.run_processes(
        [base + ["--process-id", "0", "--output", "file", "--filename", str(outfile)],
         base + ["--process-id", "1", "--output", "stdout"]], 120, env=_env(), cwd=REPO)
    doc = json.loads(outfile.read_text())
    assert doc["id"] == "hashjointimingresult"
    assert doc["parameters"]["Type"] == "DistributedShuffle"
    assert doc["parameters"]["NumberOfShards"] == "8"
    assert doc["parameters"]["NumberOfProcesses"] == "2"
    assert set(doc["results"]) == {"partition", "build", "probe"}
    assert results[1][1] == ""  # process 1: no document on stdout
    for _, _, err in results:
        assert "Join produced 4096 matches" in err
        assert "backend gloo" in err


def test_dead_peer_fails_within_the_timeout():
    """A peer that exits after joining makes the other's next collective
    fail well inside the group's timeout, instead of hanging."""
    script = (
        "import os, sys, torch\n"
        "from partitionedhashjoin_tpu_torch.parallel import distributed, mesh as pm\n"
        "pid = int(sys.argv[2])\n"
        "distributed.initialize(sys.argv[1], 2, pid, platform='cpu', timeout_s=20)\n"
        "if pid == 1:\n"
        "    os._exit(3)\n"
        "pm.psum(torch.ones(1, 4), distributed.global_mesh())\n"
        "print('SURVIVED')\n"
    )
    coord = dryrun.free_coordinator()
    t0 = time.monotonic()
    procs = [subprocess.Popen([sys.executable, "-c", script, coord, str(pid)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=_env(), cwd=REPO) for pid in range(2)]
    outs = [p.communicate(timeout=90) for p in procs]
    assert time.monotonic() - t0 < 60
    assert procs[1].returncode == 3
    assert procs[0].returncode != 0 and "SURVIVED" not in outs[0][0]


@pytest.mark.parametrize("total,nproc,pid", [
    (4096, 2, 0), (4096, 2, 1), (8192, 4, 3), (1024, 1, 0), (0, 2, 1),
    (10, 4, 0), (7, 2, 1), (200_000_000, 8, 5),
])
def test_host_slice_matches_jax(total, nproc, pid):
    """With both arguments given neither package reads a process group:
    the same (start, rows), or the same ValueError."""
    try:
        want = jax_distributed.host_slice(total, nproc, pid)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            distributed.host_slice(total, nproc, pid)
        assert str(got.value) == str(e)
    else:
        assert distributed.host_slice(total, nproc, pid) == want


def test_no_group_refusals():
    """Without ``initialize``: no global mesh, no implicit host slice; a
    mesh whose shards do not split over its processes, a process id out of
    range, NCCL on the CPU and an unknown backend all raise."""
    with pytest.raises(RuntimeError, match="initialize first"):
        distributed.global_mesh()
    with pytest.raises(RuntimeError, match="initialize first"):
        distributed.host_slice(8)
    with pytest.raises(ValueError, match="do not split"):
        pm.Mesh(device=torch.device("cpu"), size=8, process_count=3)
    with pytest.raises(ValueError, match="outside"):
        distributed.initialize("127.0.0.1:1", 2, 2, platform="cpu")
    cpu, holders = torch.device("cpu"), ["h/cpu", "h/cpu"]
    assert distributed._choose_backend(cpu, holders, None) == "gloo"
    with pytest.raises(ValueError, match="the device is cpu"):
        distributed._choose_backend(cpu, holders, "nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        distributed._choose_backend(cpu, holders, "mpi")


def test_backend_follows_the_cards_held():
    """NCCL wherever every process holds a card of its own, on one host or
    several (two hosts of one card each, two processes); gloo, and an
    explicit NCCL raising, only where two processes of one host hold the
    same card."""
    card = torch.device("cuda", 0)
    for own in (["a/cuda:0", "b/cuda:0"], ["a/cuda:0", "a/cuda:1"],
                [f"{h}/cuda:{i}" for h in "ab" for i in range(8)]):
        assert distributed._choose_backend(card, own, None) == "nccl"
        assert distributed._choose_backend(card, own, "nccl") == "nccl"
        assert distributed._choose_backend(card, own, "gloo") == "gloo"
    for shared in (["a/cuda:0", "a/cuda:0"], ["a/cuda:0", "b/cuda:0", "b/cuda:0"]):
        assert distributed._choose_backend(card, shared, None) == "gloo"
        with pytest.raises(ValueError, match="share a card"):
            distributed._choose_backend(card, shared, "nccl")


def test_refusal_raises_in_every_process():
    """backend="nccl" on the CPU: both processes read each other's device
    from the store, and both raise before any group is joined (process 0,
    which serves the store, waits until the other has read it)."""
    script = (
        "import sys, torch.distributed as dist\n"
        "from partitionedhashjoin_tpu_torch.parallel import distributed\n"
        "try:\n"
        "    distributed.initialize(sys.argv[1], 2, int(sys.argv[2]), platform='cpu',\n"
        "                           backend='nccl', timeout_s=30)\n"
        "except ValueError as e:\n"
        "    print('REFUSED', dist.is_initialized(), e)\n"
    )
    coord = dryrun.free_coordinator()
    results = dryrun.run_processes(
        [[sys.executable, "-c", script, coord, str(pid)] for pid in range(2)], 60,
        env=_env(), cwd=REPO)
    for _, out, _ in results:
        assert out.startswith("REFUSED False ") and "the device is cpu" in out


def test_holders_gathered_through_the_store():
    """Each process publishes "host/device" in the coordinator's store and
    reads every process's, before the group forms."""
    import socket

    from torch.distributed import TCPStore

    port = int(dryrun.free_coordinator().rsplit(":", 1)[1])
    store = TCPStore("127.0.0.1", port, 1, True)
    assert distributed._holders(store, 1, 0, torch.device("cpu")) == [
        f"{socket.gethostname()}/cpu"]


def test_shuffle_run_cross_process_bytes():
    run = ps.ShuffleRun(num_shards=8, drops=[(0, 0, 0)], cap_a=312_501,
                        cap_b=6_250_001, hot_cap=64, hot_keys=[], local_shards=4)
    assert run.cross_process_bytes == 16 * 6_562_502 * 9 == 945_000_288
    chunked = ps.ShuffleRun(num_shards=8, drops=[], cap_a=0, cap_b=0, hot_cap=0,
                            hot_keys=[], local_shards=4)
    chunked.record_exchange((0, 0, 0), 312_501, 6_250_001, 64, ps.KEY_SLOT_BYTES)
    assert chunked.cross_process_bytes == 16 * (312_501 * 9 + 6_250_001 * 5) == 545_000_224
    assert chunked != run
    assert run == ps.ShuffleRun(num_shards=8, drops=[(0, 0, 0)], cap_a=312_501,
                                cap_b=6_250_001, hot_cap=64, hot_keys=[])
    assert ps.ShuffleRun(8, [(0, 0, 0)], 1, 1, 64, []).cross_process_bytes == 0


def test_entry_matches_jax():
    """``entry()``'s single-device join step counts what the JAX entry's
    does on the same example arguments."""
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    jax_entry = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_entry)
    jfn, jargs = jax_entry.entry()
    fn, args = dryrun.entry("cpu")
    assert int(fn(*args)) == int(jfn(*jargs)) == 16384


@pytest.mark.parametrize("n", [1, 2, 8])
def test_dryrun_multichip_on_cpu(n):
    """Every step of ``dryrun_multichip`` holds its oracle on an n-shard
    mesh of the CPU."""
    dryrun.dryrun_multichip(n, device="cpu")
