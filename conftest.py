"""Hooks of the whole test suite: the `slow` marker, a per-test time limit and
the benchmark tests' tiny form of a newer configuration.

pytest loads this file for any run started at the repository's root, before
tests/conftest.py, which belongs to the JAX package's suite and is kept as it
is. Nothing here imports jax or torch.
"""

import faulthandler
import os

import pytest

# JAX reference tests that compile and run an interpret-mode Pallas sorter or
# compactor for 90-600 s each on 8 CPU cores, as load varies. No change may
# edit the package they check, and cheaper tests in the same files cover the
# same paths, so tier-1 deselects them with -m 'not slow'; run them with
# -m slow. Entries are the file name and the rest of the node id.
SLOW_TESTS = (
    "test_operators.py::TestSortAggregate::"
    "test_kernel_compaction_agrees_with_sort_path",
    "test_operators.py::TestSortAggregatePallasSorter::"
    "test_pass1_pallas_sorter_agrees",
    "test_bitonic_sort.py::TestTupleSort::test_three_operands",
    "test_merge_probe.py::test_int64_planes_pallas_sorter_agrees",
    "test_pallas_compact.py::TestBlockCompact::test_multi_column_carry",
    "test_merge_materialize.py::test_two_run_materialize_pallas_sorter_agrees",
)

# Seconds one test may take, setup and teardown included, before its process
# prints every thread's stack and exits. Under xdist the test counts as
# failed and, with --dist loadfile, a new worker runs the rest of its file;
# without xdist the stop ends the pytest process. Above the slowest test
# measured on 8 CPU cores (~600 s, under load).
TEST_TIME_LIMIT_S = 900

# Tiny forms of benchmark configurations younger than the map of
# benchmark/tests/conftest.py (TINY), which a PR that adds a configuration may
# not edit: set on each collected module's tiny_bench, as benchmark/conftest.py
# sets its own, so any one file of benchmark/tests runs alone.
BENCH_TINY = {"upstream_groupby_200M_zipf105": "tiny_zipf"}

_stderr_fd = pytest.StashKey[int]()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: a test of SLOW_TESTS in the root conftest.py"
    )
    # Output is not captured while pytest configures, so this copy of stderr
    # reaches the terminal even when the limit fires inside a captured test.
    config.stash[_stderr_fd] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[_stderr_fd])


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    # tryfirst: before -m deselects
    for item in items:
        if f"{item.path.name}::{item.nodeid.partition('::')[2]}" in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
    for module in {getattr(item, "module", None) for item in items}:
        tiny_bench = getattr(module, "tiny_bench", None)
        if tiny_bench is not None:
            tiny_bench.__globals__["TINY"].update(BENCH_TINY)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item):
    # The timer runs in C, so it fires inside a compile or a blocked wait too.
    faulthandler.dump_traceback_later(
        TEST_TIME_LIMIT_S, exit=True, file=item.config.stash[_stderr_fd]
    )
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class Scheduling(LoadFileScheduling):
        def remove_node(self, node):
            # xdist's own puts a crashed worker's file back in the queue with
            # the test that crashed it still to run, so a test stopped at the
            # limit would stop every new worker in turn; this one counts that
            # test as done, and the rest of its file runs.
            workload = self.assigned_work.pop(node)
            crashed = next((nodeid for unit in workload.values()
                            for nodeid, done in unit.items() if not done), None)
            if crashed is None:
                return None
            workload[self._split_scope(crashed)][crashed] = True
            self.workqueue.update(
                (scope, unit) for scope, unit in workload.items()
                if not all(unit.values())
            )
            for other in self.assigned_work:
                self._reschedule(other)
            return crashed

    return Scheduling(config, log)
