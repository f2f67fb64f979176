"""Test settings for the cell ``upstream_nopart_chained``, which is younger
than the benchmark's own test helpers: its configuration's tiny form, for
``tests/conftest.tiny_bench``, and its per-layer metric that a CPU run reads,
for ``tests/test_bench_harness.HOST_METRICS``. Both are set on whatever test
modules are collected, so any one file of ``benchmark/tests`` runs alone."""

#: The cell's configuration holds the upstream's default data.
TINY = {"upstream_nopart_10Mx200M_zipf105": "tiny_zipf"}
#: The chained joiner's build span, read on the CPU as the probe span is.
HOST_METRICS = {"chained_build_ms"}


def pytest_collection_modifyitems(items):
    for module in {getattr(item, "module", None) for item in items}:
        tiny_bench = getattr(module, "tiny_bench", None)
        if tiny_bench is not None:
            tiny_bench.__globals__["TINY"].update(TINY)
        host = getattr(module, "HOST_METRICS", None)
        if isinstance(host, set):
            host |= HOST_METRICS
