"""The port's copies of the JAX package's host utilities, on the CPU:
``utils/profiling.py`` (peaks and roofline; its ``torch.profiler`` trace is
tested on the card, in tests/test_torch_cuda.py),
``utils/rng.py`` (the reference's Park–Miller LCG, stream for stream) and
``utils/pipeline.py`` (the host thread pool, the cases of
tests/test_pipeline.py)."""

import os
import threading
import time

import numpy as np
import pytest

from partitionedhashjoin_tpu.utils import profiling as jax_profiling
from partitionedhashjoin_tpu.utils import rng as jax_rng
from partitionedhashjoin_tpu_torch.utils import profiling, rng
from partitionedhashjoin_tpu_torch.utils.pipeline import (
    Pipeline,
    TasksErrorHolder,
    ThreadPool,
)


def test_peaks_and_default_chip():
    assert profiling.HBM_PEAK_GBPS == {**jax_profiling.HBM_PEAK_GBPS, "h100": 3350.0}
    assert profiling.DEFAULT_CHIP == "h100"
    assert not hasattr(profiling, "sort_merge_bytes")


@pytest.mark.parametrize("chip", ["h100", "v5e", "nonexistent"])
def test_roofline_matches_jax(chip):
    got = profiling.roofline(seconds=0.5, bytes_moved=1_675_000_000_000, chip=chip)
    peak = profiling.HBM_PEAK_GBPS.get(chip, 3350.0)
    assert got.achieved_gbps == pytest.approx(3350.0)
    assert got.fraction_of_peak == pytest.approx(3350.0 / peak)
    if chip in jax_profiling.HBM_PEAK_GBPS:  # else JAX takes its own default
        want = jax_profiling.roofline(0.5, 1_675_000_000_000, chip=chip)
        assert (got.achieved_gbps, got.peak_gbps, str(got)) == (
            want.achieved_gbps, want.peak_gbps, str(want))
    assert "100%" in str(profiling.roofline(1.0, 3_350_000_000_000))


@pytest.mark.parametrize("seed", [1, 42, 123456789, 2**31 - 1, 0])
def test_lcg_streams_equal_jax(seed):
    a, b = rng.MultiplicativeLCG(seed), jax_rng.MultiplicativeLCG(seed)
    assert [a.next() for _ in range(50)] == [b.next() for _ in range(50)]
    np.testing.assert_array_equal(a.next_batch(3000), b.next_batch(3000))
    assert a.state == b.state
    for n in (0, 1, 1000, 10**9):
        assert rng.lcg_skip(seed, n) == jax_rng.lcg_skip(seed, n)


def test_lcg_park_miller_and_factory():
    g = rng.MultiplicativeLCG(1)
    m = 2147483647
    assert [g.next() for _ in range(3)] == [16807 / m, 282475249 / m, 1622650073 / m]
    g = rng.MultiplicativeLCG(42)
    for _ in range(1000):
        g.next()
    assert g.state == rng.lcg_skip(42, 1000)
    f = rng.MultiplicativeLCGFactory()
    assert f.get_new_generator(seed=7).state == 7
    assert f.get_new_generator().next() != f.get_new_generator().next()


def test_single_task_and_batch():
    pool = ThreadPool(workers=3)
    hits = []
    holder = pool.push(lambda: hits.append(1)).result(timeout=10)
    assert holder.empty() and hits == [1]
    holder = pool.push([lambda: hits.append(2)] * 5).result(timeout=10)
    assert holder.empty() and len(hits) == 6
    pool.stop()


def test_batch_runs_in_parallel():
    pool = ThreadPool(workers=4)
    barrier = threading.Barrier(4, timeout=5)
    holder = pool.push([barrier.wait] * 4).result(timeout=10)  # deadlocks if serial
    assert holder.empty()
    pool.stop()


def test_pipeline_stage_ordering_is_a_barrier():
    pool = ThreadPool(workers=4)
    order = []
    lock = threading.Lock()

    def task(stage):
        def run():
            time.sleep(0.01 if stage == 0 else 0)
            with lock:
                order.append(stage)
        return run

    pipe = Pipeline().add([task(0)] * 4).add([task(1)] * 4)
    assert pool.push(pipe).result(timeout=10).empty()
    assert order == [0] * 4 + [1] * 4
    pool.stop()


def test_pipeline_failure_short_circuits_later_stages():
    pool = ThreadPool(workers=2)
    ran = []

    def boom():
        raise ValueError("stage failed")

    pipe = (
        Pipeline()
        .add([lambda: ran.append("s0")])
        .add([boom, lambda: ran.append("s1")])
        .add([lambda: ran.append("s2")])
    )
    holder = pool.push(pipe).result(timeout=10)
    assert not holder.empty()
    assert isinstance(holder.pop(), ValueError)  # real exception preserved
    assert str(holder.pop()) == "stage failed"
    assert "s2" not in ran and "s1" in ran
    pool.stop()


def test_error_holder_aggregates_multiple():
    holder = TasksErrorHolder()
    holder.add(ValueError("a"))
    holder.add(KeyError("b"))
    assert len(holder.errors) == 2 and not holder.empty()


def test_single_worker_pipeline_does_not_deadlock():
    pool = ThreadPool(workers=1)
    pipe = Pipeline().add([lambda: None] * 3).add([lambda: None])
    assert pool.push(pipe).result(timeout=10).empty()
    pool.stop()


def test_default_worker_count():
    pool = ThreadPool()
    assert pool.get_number_of_workers() == max(1, (os.cpu_count() or 2) - 1)
    pool.stop()
