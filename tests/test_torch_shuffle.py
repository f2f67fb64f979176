"""The port's mesh and shuffle join against the JAX package's, on the CPU.

A few tiny shapes (<= 4,096 ⋈ 16,384 rows) go through both packages, JAX
on its 8 virtual CPU devices (tests/conftest.py): the owner shards and the
hot-key plan bit for bit, ``_bucketize`` and one 8-shard ``_exchange`` as
per-destination multisets of the valid rows (the port fills a bucket's
spare slots with zeros, JAX with a neighbour's rows; both mask them), the
hot replication and the drop counts exactly, and one joiner run per local
join.  Everything else, every option of ``DistributedShuffleJoiner``, is
held to ``np.isin`` without JAX, so the file stays cheap.
"""

import json
import re
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu import cli as jax_cli
from partitionedhashjoin_tpu.data.table import make_table as jax_table
from partitionedhashjoin_tpu.parallel import mesh as jax_mesh
from partitionedhashjoin_tpu.parallel import shuffle as jax_shuffle
import partitionedhashjoin_tpu_torch as port
from partitionedhashjoin_tpu_torch import cli
from partitionedhashjoin_tpu_torch.data.table import table_from_numpy
from partitionedhashjoin_tpu_torch.ops import generators
from partitionedhashjoin_tpu_torch.parallel import mesh as pm
from partitionedhashjoin_tpu_torch.parallel import shuffle as ps
from partitionedhashjoin_tpu_torch.utils.results import HashJoinTimer, Parameters

torch.set_num_threads(1)

I32_MAX = np.iinfo(np.int32).max
N_A, N_B = 4096, 16384


def _zipf_relations(alpha=1.25, seed=11):
    """A 1..N_A build and an N_B-row Zipf probe over it, as numpy."""
    a = np.arange(1, N_A + 1, dtype=np.int32)
    b = generators.zipf_table(N_B, alpha, (1, N_A), seed=seed, device="cpu").keys.numpy()
    return (a, a ^ 0x5A17), (b, np.arange(N_B, dtype=np.int32))


def _port_tables(mesh, rel_a, rel_b):
    return (pm.shard_table(table_from_numpy(*rel_a, "cpu"), mesh),
            pm.shard_table(table_from_numpy(*rel_b, "cpu"), mesh))


def _jax_tables(mesh, rel_a, rel_b):
    return tuple(jax_mesh.shard_table(jax_table(jnp.asarray(k), jnp.asarray(p)), mesh)
                 for k, p in (rel_a, rel_b))


@pytest.fixture(scope="module")
def mesh8():
    return pm.make_mesh(8, devices=["cpu"])


@pytest.fixture(scope="module")
def jax_mesh8():
    return jax_mesh.make_mesh(8)


def _isin(a, b):
    return int(np.isin(b, a).sum())


def _rows(keys, pays, valid):
    """Multiset of the valid (key, payload) rows."""
    keys, pays, valid = (np.asarray(x) for x in (keys, pays, valid))
    return Counter(zip(keys[valid].tolist(), pays[valid].tolist()))


# ---------------------------------------------------------------- against JAX


@pytest.mark.parametrize("num_shards", [1, 2, 4, 8])
def test_owner_shard_matches_jax(num_shards):
    rng = np.random.default_rng(num_shards)
    keys = rng.integers(np.iinfo(np.int32).min, I32_MAX, 4096, dtype=np.int64).astype(np.int32)
    keys[:3] = (I32_MAX, 0, -1)
    for seed in (0, 3, 0xFFFFFFFF):
        want = np.asarray(jax_shuffle._owner_shard(jnp.asarray(keys), jnp.uint32(seed), num_shards))
        got = ps._owner_shard(torch.tensor(keys), seed, num_shards)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="power of 2"):
        ps._owner_shard(torch.tensor(keys), 0, 3)


def _bucket_inputs():
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 5000, N_B).astype(np.int32)
    pays = np.arange(N_B, dtype=np.int32)
    valid = rng.random(N_B) < 0.8
    dest = ps._owner_shard(torch.tensor(keys), 9, 8).numpy()
    return dest, valid, keys, pays


@pytest.mark.parametrize("capacity", [4096, 1500])
def test_bucketize_matches_jax(capacity):
    """Per destination: the same multiset of valid rows (every row fits),
    or at a capacity that drops rows, the same counts kept and dropped, the
    port's kept rows drawn from the destination's rows."""
    dest, valid, keys, pays = _bucket_inputs()
    want_k, want_p, want_v, want_drop = (np.asarray(x) for x in jax_shuffle._bucketize(
        jnp.asarray(dest), jnp.asarray(valid), capacity, 8, jnp.asarray(keys), jnp.asarray(pays)))
    got_k, got_p, got_v, got_drop = ps._bucketize(
        torch.tensor(dest), torch.tensor(valid), capacity, 8, torch.tensor(keys),
        torch.tensor(pays))
    assert int(got_drop) == int(want_drop)
    assert (int(got_drop) > 0) == (capacity == 1500)
    assert got_k.shape == got_v.shape == (8 * capacity,)
    for s in range(8):
        sl = slice(s * capacity, (s + 1) * capacity)
        assert got_v[sl].sum() == want_v[sl].sum()
        got = _rows(got_k[sl].numpy(), got_p[sl].numpy(), got_v[sl].numpy())
        want = _rows(want_k[sl], want_p[sl], want_v[sl])
        rows_of_s = Counter(zip(keys[valid & (dest == s)].tolist(), pays[valid & (dest == s)].tolist()))
        if capacity == 4096:
            assert got == want == rows_of_s
        else:
            assert not got - rows_of_s


def test_bucketize_batched_equals_one_shard_at_a_time():
    dest, valid, keys, pays = _bucket_inputs()
    batched = ps._bucketize(*(torch.tensor(x).view(8, -1) for x in (dest, valid)), 210, 8,
                            *(torch.tensor(x).view(8, -1) for x in (keys, pays)))
    singles = [ps._bucketize(*(torch.tensor(x).view(8, -1)[i] for x in (dest, valid)), 210, 8,
                             *(torch.tensor(x).view(8, -1)[i] for x in (keys, pays)))
               for i in range(8)]
    for j in range(3):
        assert torch.equal(batched[j], torch.stack([one[j] for one in singles]))
    assert int(batched[3]) == sum(int(one[3]) for one in singles) > 0


def _adversarial_keys():
    """tests/test_parallel.py's layout: the hot key fills half of every
    stride window but never sits at a multiple of the stride."""
    n, stride = 65536, 256
    keys = np.arange(n, dtype=np.int32) % 50_000 + 1000
    off = np.arange(n) % stride
    keys[(off >= 1) & (off < 129)] = 7
    return keys


@pytest.mark.parametrize("case", ["zipf", "adversarial"])
def test_plan_hot_keys_matches_jax(case):
    if case == "zipf":
        keys, args = _zipf_relations()[1][0], dict(sample_size=8192, capacity=16,
                                                  min_frac=0.01, seed=1)
    else:
        keys, args = _adversarial_keys(), dict(sample_size=256, capacity=16,
                                               min_frac=0.05, seed=3)
    want_k, want_v = (np.asarray(x) for x in jax_shuffle.plan_hot_keys(jnp.asarray(keys), **args))
    got_k, got_v = ps.plan_hot_keys(torch.tensor(keys), **args)
    assert np.array_equal(got_k.numpy(), want_k) and np.array_equal(got_v.numpy(), want_v)
    hot = set(got_k[got_v].tolist())
    assert (1 if case == "zipf" else 7) in hot


def _plan(keys_b, joiner_seed):
    """The joiner's default hot plan for ``keys_b`` (numpy), in both packages."""
    seed = (joiner_seed ^ 0x9E3779B9) & 0xFFFFFFFF
    want = jax_shuffle.plan_hot_keys(jnp.asarray(keys_b), 16_384, 64, 0.005, seed=seed)
    got = ps.plan_hot_keys(torch.tensor(keys_b), 16_384, 64, 0.005, seed=seed)
    assert all(np.array_equal(np.asarray(w), g.numpy()) for w, g in zip(want, got))
    return want, got


def test_exchange_matches_jax(mesh8, jax_mesh8):
    """One 8-shard exchange with a hot plan: each shard receives the same
    rows, hot probe rows and replicated hot build rows are the same bit for
    bit, and so are the drop counts."""
    rel_a, rel_b = _zipf_relations()
    (jhk, jhv), (hk, hv) = _plan(rel_b[0], 3)
    ja, jb = _jax_tables(jax_mesh8, rel_a, rel_b)
    ta, tb = _port_tables(mesh8, rel_a, rel_b)
    caps = (129, 513, 64)  # DistributedShuffleJoiner's at these sizes
    want = jax_shuffle._exchange(jax_mesh8, ja.keys, ja.payloads, jb.keys, jb.payloads,
                                 jnp.uint32(3), jhk, jhv, jnp.uint32(4), *caps, True)
    got = ps._exchange(mesh8, ta.keys, ta.payloads, tb.keys, tb.payloads, 3, hk, hv,
                       *caps, True)
    want_arrays = [np.asarray(x) for x in want[:10]]
    got_arrays = [x.numpy() for x in got[:10]]
    for side in (0, 3):  # A's and B's received (keys, pays, valid)
        wk, wp, wv = (w.reshape(8, -1) for w in want_arrays[side:side + 3])
        gk, gp, gv = (g.reshape(8, -1) for g in got_arrays[side:side + 3])
        for j in range(8):
            assert _rows(gk[j], gp[j], gv[j]) == _rows(wk[j], wp[j], wv[j])
    for i in range(6, 10):  # is_hot_b, hot keys, payloads, valid
        assert np.array_equal(got_arrays[i], want_arrays[i]), i
    assert got_arrays[6].sum() > 0 and got_arrays[9].sum() > 0
    for f in ("dropped_a", "dropped_b", "dropped_hot"):
        assert int(getattr(got[10], f)) == int(getattr(want[10], f)) == 0


@pytest.mark.parametrize("local_join", ["sort-merge", "hash"])
def test_joiner_matches_jax(mesh8, jax_mesh8, local_join):
    rel_a, rel_b = _zipf_relations()
    ja, jb = _jax_tables(jax_mesh8, rel_a, rel_b)
    ta, tb = _port_tables(mesh8, rel_a, rel_b)
    want = jax_shuffle.DistributedShuffleJoiner(jax_mesh8, seed=3, local_join=local_join).run(ja, jb)
    joiner = ps.DistributedShuffleJoiner(mesh8, seed=3, local_join=local_join)
    assert joiner.run(ta, tb) == want == N_B
    run = joiner.last_run
    assert run.drops == [(0, 0, 0)] and run.retries == 0 and 1 in run.hot_keys
    assert (run.cap_a, run.cap_b, run.hot_cap) == (129, 513, 64)
    assert run.exchange_slots == 64 * (129 + 513)


def _cli_doc(main, argv, capsys):
    assert main(argv + ["--output", "stdout", "--platform", "cpu", "--log", "info"]) == 0
    out = capsys.readouterr()
    return json.loads(out.out), re.findall(r"Join produced (\d+) matches", out.err)


def test_cli_shuffle_writes_the_jax_parameters(capsys):
    # JAX at this module's shapes (its exchange programs are compiled)
    want, _ = _cli_doc(jax_cli.main, ["--join", "shuffle", "--shards", "8", "--primary",
                                      str(N_A), "--secondary", str(N_B), "--seed", "5"], capsys)
    doc, counts = _cli_doc(cli.main, ["--join", "shuffle", "--shards", "8", "--primary",
                                      "5000", "--secondary", "70000", "--seed", "5"], capsys)
    assert counts == ["70000"]
    assert set(doc["parameters"]) == set(want["parameters"])
    assert doc["parameters"]["Type"] == want["parameters"]["Type"] == "DistributedShuffle"
    assert doc["parameters"]["NumberOfShards"] == "8"
    assert set(doc["results"]) == set(want["results"]) == {"partition", "build", "probe"}


# ---------------------------------------------------------------- against np.isin


@pytest.mark.parametrize("extra", [
    [],
    ["--shards", "2", "--local-join", "hash"],
    ["--shards", "8", "--pipeline-chunks", "4"],
])
def test_cli_shuffle_counts_every_probe_row(extra, capsys):
    doc, counts = _cli_doc(cli.main, ["--join", "shuffle", "--primary", "5000",
                                      "--secondary", "70000", "--seed", "1"] + extra, capsys)
    assert counts == ["70000"]
    shards = extra[extra.index("--shards") + 1] if extra else "1"
    assert doc["parameters"]["NumberOfShards"] == shards


@pytest.mark.parametrize("num_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("local_join", ["sort-merge", "hash"])
def test_uniform_keys_match_isin(num_shards, local_join):
    rng = np.random.default_rng(num_shards)
    a = rng.choice(np.arange(1, 10000, dtype=np.int32), 2048, replace=False)
    b = rng.integers(1, 10000, 8192).astype(np.int32)
    mesh = pm.make_mesh(num_shards, devices=["cpu"])
    ta, tb = _port_tables(mesh, (a, np.arange(2048, dtype=np.int32)),
                          (b, np.arange(8192, dtype=np.int32)))
    assert ps.DistributedShuffleJoiner(mesh, seed=3, local_join=local_join).run(ta, tb) == _isin(a, b)


def test_duplicate_build_keys_and_int32_extremes(mesh8):
    rng = np.random.default_rng(2)
    a = rng.integers(-3000, 3000, 2048).astype(np.int32)
    b = rng.integers(-3500, 3500, 8192).astype(np.int32)
    a[:5], b[:7] = I32_MAX, I32_MAX
    a[5:9], b[7:11] = np.iinfo(np.int32).min, np.iinfo(np.int32).min
    ta, tb = _port_tables(mesh8, (a, a), (b, b))
    for kw in ({}, {"local_join": "hash"}, {"pipeline_chunks": 2}):
        assert ps.DistributedShuffleJoiner(mesh8, seed=4, **kw).run(ta, tb) == _isin(a, b)


@pytest.mark.parametrize("alpha", [1.05, 1.25])
@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_zipf_with_hot_keys(mesh8, alpha, chunks):
    rel_a, rel_b = _zipf_relations(alpha, seed=13)
    joiner = ps.DistributedShuffleJoiner(mesh8, seed=5, pipeline_chunks=chunks)
    assert joiner.run(*_port_tables(mesh8, rel_a, rel_b)) == N_B
    assert 1 in joiner.last_run.hot_keys and joiner.last_run.cap_b % chunks == 0


def test_without_skew_handling_retries_to_exact(mesh8):
    rel_a, rel_b = _zipf_relations(1.25, seed=13)
    joiner = ps.DistributedShuffleJoiner(mesh8, seed=6, handle_skew=False)
    assert joiner.run(*_port_tables(mesh8, rel_a, rel_b)) == N_B
    run = joiner.last_run
    assert run.retries >= 1 and run.drops[0][1] > 0 and run.drops[-1] == (0, 0, 0)
    assert run.hot_keys == [] and run.cap_b > 513


def test_retries_exhausted_raise(mesh8):
    rel_a, rel_b = _zipf_relations(1.25, seed=13)
    joiner = ps.DistributedShuffleJoiner(mesh8, seed=6, handle_skew=False, max_retries=1)
    with pytest.raises(RuntimeError, match="overflowed after 1 retries"):
        joiner.run(*_port_tables(mesh8, rel_a, rel_b))


def test_hot_capacity_overflow_grows_hot_cap(mesh8):
    rng = np.random.default_rng(55)
    a = rng.integers(100, 5000, 2048).astype(np.int32)
    a[:512] = 7  # 512 duplicate build rows of the hot key
    b = rng.integers(100, 5000, 8192).astype(np.int32)
    b[:4096] = 7
    joiner = ps.DistributedShuffleJoiner(mesh8, seed=3, hot_capacity=16)
    ta, tb = _port_tables(mesh8, (a, a), (b, b))
    assert joiner.run(ta, tb) == _isin(a, b)
    run = joiner.last_run
    assert run.drops[0][2] > 0 and run.hot_cap == 16 * 4 + run.drops[0][2]


def test_tiny_relations(mesh8):
    rng = np.random.default_rng(77)
    a, b = (rng.integers(0, 100, 32).astype(np.int32) for _ in range(2))
    ta, tb = _port_tables(mesh8, (a, a), (b, b))
    for kw in ({"hot_capacity": 64}, {"local_join": "hash"}, {"pipeline_chunks": 4}):
        assert ps.DistributedShuffleJoiner(mesh8, seed=1, **kw).run(ta, tb) == _isin(a, b)


def _masked_oracle(a, b, va, vb):
    return int((vb & np.isin(b, np.unique(a[va]))).sum())


@pytest.mark.parametrize("kw", [{}, {"local_join": "hash"}, {"pipeline_chunks": 4}])
def test_validity_masks(mesh8, kw):
    rng = np.random.default_rng(19)
    a = rng.integers(0, 800, 2048).astype(np.int32)
    b = rng.integers(0, 1000, 8192).astype(np.int32)
    va, vb = np.arange(2048) % 3 != 0, np.arange(8192) % 2 == 0
    ta, tb = _port_tables(mesh8, (a, a), (b, b))
    sa, sb = pm.shard_array(torch.tensor(va), mesh8), pm.shard_array(torch.tensor(vb), mesh8)
    joiner = ps.DistributedShuffleJoiner(mesh8, seed=23, **kw)
    assert joiner.run(ta, tb, valid_a=sa, valid_b=sb) == _masked_oracle(a, b, va, vb)
    assert joiner.run(ta, tb, valid_a=sa) == _masked_oracle(a, b, va, np.ones(8192, bool))


def test_validity_masks_with_hot_keys(mesh8):
    rel_a, rel_b = _zipf_relations(1.25, seed=31)
    va = rel_a[0] % 3 != 0
    vb = rel_b[0] % 2 == 0
    joiner = ps.DistributedShuffleJoiner(mesh8, seed=37)
    got = joiner.run(*_port_tables(mesh8, rel_a, rel_b),
                     valid_a=pm.shard_array(torch.tensor(va), mesh8),
                     valid_b=pm.shard_array(torch.tensor(vb), mesh8))
    assert got == _masked_oracle(rel_a[0], rel_b[0], va, vb) > 0
    assert 2 in joiner.last_run.hot_keys


@pytest.mark.parametrize("masked", [False, True])
def test_single_shard_fast_path_matches_general(masked):
    mesh1 = pm.make_mesh(1, devices=["cpu"])
    rng = np.random.default_rng(41)
    a = rng.integers(0, 500, 1024).astype(np.int32)
    b = rng.integers(0, 600, 4096).astype(np.int32)
    va, vb = np.arange(1024) % 5 != 0, np.arange(4096) % 3 != 0
    ta, tb = _port_tables(mesh1, (a, a), (b, b))
    masks = dict(valid_a=torch.tensor(va), valid_b=torch.tensor(vb)) if masked else {}
    want = _masked_oracle(a, b, va, vb) if masked else _isin(a, b)
    fast = ps.DistributedShuffleJoiner(mesh1, seed=2)
    timer = HashJoinTimer(Parameters())
    assert fast.run(ta, tb, timer, **masks) == want
    assert fast.last_run.drops == [] and fast.last_run.exchange_slots == 0
    slow = ps.DistributedShuffleJoiner(mesh1, seed=2, single_shard_fast_path=False)
    slow_timer = HashJoinTimer(Parameters())
    assert slow.run(ta, tb, slow_timer, **masks) == want
    assert slow.last_run.drops == [(0, 0, 0)]
    assert (slow_timer.get_result().get_partitioning_phase_duration()
            > timer.get_result().get_partitioning_phase_duration())


def test_int64_keys(mesh8):
    """One shard: K3's path (plain on the CPU), and sort_merge_count with
    masks; keys past 32 bits stay distinct.  More shards refuse them."""
    mesh1 = pm.make_mesh(1, devices=["cpu"])
    rng = np.random.default_rng(5)
    a = rng.integers(0, 3000, 1024) + (rng.integers(0, 4, 1024) << 33)
    b = rng.integers(0, 3000, 4096) + (rng.integers(0, 4, 4096) << 33)
    ta, tb = _port_tables(mesh1, (a, a), (b, b))
    assert ps.DistributedShuffleJoiner(mesh1, seed=1).run(ta, tb) == _isin(a, b)
    vb = np.arange(4096) % 2 == 0
    assert ps.DistributedShuffleJoiner(mesh1, seed=1).run(
        ta, tb, valid_b=torch.tensor(vb)) == _masked_oracle(a, b, np.ones(1024, bool), vb)
    for mesh, kw in ((mesh1, {"single_shard_fast_path": False}), (mesh8, {})):
        ta, tb = _port_tables(mesh, (a, a), (b, b))
        with pytest.raises(TypeError, match="32-bit keys"):
            ps.DistributedShuffleJoiner(mesh, seed=1, **kw).run(ta, tb)


def test_timer_records_the_three_phases(mesh8):
    rel_a, rel_b = _zipf_relations(1.05, seed=19)
    ta, tb = _port_tables(mesh8, rel_a, rel_b)
    for local_join in ("hash", "sort-merge"):
        timer = HashJoinTimer(Parameters())
        ps.DistributedShuffleJoiner(mesh8, seed=7, local_join=local_join).run(ta, tb, timer)
        r = timer.get_result()
        assert r.get_partitioning_phase_duration() > 0
        assert r.get_build_phase_duration() > 0
        assert r.get_probe_phase_duration() > 0


def test_argument_errors(mesh8):
    a = np.arange(16, dtype=np.int32)
    ta, tb = _port_tables(mesh8, (a, a), (a, a))
    for kw, match in (({"local_join": "nested-loop"}, "unknown local_join"),
                      ({"pipeline_chunks": 0}, "pipeline_chunks")):
        with pytest.raises(ValueError, match=match):
            ps.DistributedShuffleJoiner(mesh8, **kw)
    with pytest.raises(ValueError, match="power of 2"):
        ps.DistributedShuffleJoiner(pm.make_mesh(3, devices=["cpu"]))
    odd = table_from_numpy(np.arange(12, dtype=np.int32), np.arange(12, dtype=np.int32), "cpu")
    with pytest.raises(ValueError, match="divide the shard count"):
        ps.DistributedShuffleJoiner(mesh8, seed=1).run(ta, odd)
    with pytest.raises(ValueError, match="shape"):
        ps.DistributedShuffleJoiner(mesh8, seed=1).run(
            ta, tb, valid_a=torch.ones(8, dtype=torch.bool))


# ---------------------------------------------------------------- mesh


def test_mesh_places_rows_on_one_device():
    mesh = pm.make_mesh(8, devices=["cpu"])
    assert (mesh.size, mesh.device) == (8, torch.device("cpu"))
    assert pm.make_mesh(devices=["cpu", "cpu"]).size == 2
    t = pm.shard_table(generators.sequential_table(800, device="cpu"), mesh)
    assert t.size == 800 and np.array_equal(t.keys.numpy(), np.arange(1, 801))
    assert pm.row_sharding(mesh).spec == ("shards",) and pm.replicated(mesh).spec == ()
    assert pm.replicated(mesh).place(np.arange(3)).tolist() == [0, 1, 2]
    with pytest.raises(ValueError, match="not divisible"):
        pm.shard_table(generators.sequential_table(801, device="cpu"), mesh)
    with pytest.raises(ValueError, match="not divisible"):
        pm.shard_array(torch.ones(7, dtype=torch.bool), mesh)
    arr, n = pm.pad_to_multiple(torch.arange(10, dtype=torch.int32), 8, -1)
    assert arr.shape[0] == 16 and n == 10 and int(arr[-1]) == -1


def test_mesh_errors(monkeypatch):
    # two cards are named without one present: only the distinct-device
    # refusal is under test
    monkeypatch.setattr(pm, "resolve_device", torch.device)
    with pytest.raises(NotImplementedError, match="distributed.initialize"):
        pm.make_mesh(2, devices=["cuda:0", "cuda:1"])
    monkeypatch.undo()
    with pytest.raises(ValueError, match="at least one device"):
        pm.make_mesh(2, devices=[])
    with pytest.raises(ValueError, match="at least one shard"):
        pm.make_mesh(0, devices=["cpu"])
    with pytest.raises(ValueError, match="unsupported device"):
        pm.make_mesh(2, devices=["cpu", "meta"])


def test_collectives():
    # one process: the collectives take the mesh and never touch a group
    m2, m3 = pm.make_mesh(2, devices=["cpu"]), pm.make_mesh(3, devices=["cpu"])
    x = torch.arange(2 * 2 * 3).view(2, 2, 3)
    got = pm.all_to_all(x, m2)
    assert got.is_contiguous() and torch.equal(got[1, 0], x[0, 1])
    assert got.data_ptr() != x.data_ptr()
    assert torch.equal(pm.all_gather(torch.arange(6).view(3, 2), m3), torch.arange(6))
    assert torch.equal(pm.psum(torch.tensor([3, 4, 5]), m3), torch.tensor(12))
    with pytest.raises(ValueError, match="send buffer"):
        pm.all_to_all(torch.zeros(2, 3), m2)
    assert (m2.local_size, m2.process_index, m2.process_count) == (2, 0, 1)
    assert m2.group is None and m2.backend is None


@pytest.mark.parametrize("n_small", [0, 1, 16, 64])
def test_member_of_small_matches_isin(n_small):
    rng = np.random.default_rng(n_small)
    keys = rng.integers(-50, 50, (8, 1000)).astype(np.int32)
    keys[:, :4] = (I32_MAX, np.iinfo(np.int32).min, I32_MAX - 1, 0)
    small = rng.integers(-60, 60, n_small).astype(np.int32)
    small[:2] = (I32_MAX, np.iinfo(np.int32).min)[:n_small]
    valid = rng.random(n_small) < 0.7
    got = ps._member_of_small(torch.tensor(keys), torch.tensor(small), torch.tensor(valid))
    assert got.shape == keys.shape
    assert np.array_equal(got.numpy(), np.isin(keys, small[valid]))


def test_searchsorted_counter_matches_isin():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 500, 700).astype(np.int32)
    b = rng.integers(0, 600, 3000).astype(np.int32)
    a[:3], b[:5] = I32_MAX, I32_MAX
    va, vb = rng.random(700) < 0.7, rng.random(3000) < 0.6
    count = ps._searchsorted_counter(torch.tensor(a), torch.tensor(va))
    assert int(count(torch.tensor(b), torch.tensor(vb))) == _masked_oracle(a, b, va, vb)


def test_lazy_exports():
    assert port.DistributedShuffleJoiner is ps.DistributedShuffleJoiner
    assert port.make_mesh is pm.make_mesh and port.shard_table is pm.shard_table
