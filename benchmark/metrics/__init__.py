"""One reader per metric, ``<metric name>.py``, found by the name in
BENCHMARK.json.  Each defines ``read(ctx)`` (``ctx`` is ``run.Context``)
returning the value, or None when the run has nothing for it to read."""
