"""The script surface of the port: the counterparts of the repository's
``scripts/*.py``, each as ``python -m partitionedhashjoin_tpu_torch.scripts.<name>``.

One module per JAX script, with the JAX script's name, flags, ``PHJ_*``
environment variables, seeds, defaults and output (the same JSON keys and
metric names, plus ``"device"``: the card's name or ``"cpu"``):

- ``record_results``: the reference's partition grid (``partitions_*.txt``
  and ``figure.dat``) from one process;
- ``sweep``: the same grid, one CLI process per configuration;
- ``bench_int64``, ``bench_materialize``, ``bench_operators``,
  ``bench_filtered_pipeline``: one-JSON-line benches of the int64 count
  join, the materializing join, filter + GROUP BY, and the filtered R7
  query;
- ``bench_sorter_ab``: the library sort against K6 under the two-run count
  join (stderr only);
- ``bench_scaling``, ``bench_overlap``: the shuffle join over a mesh whose
  shards share one device.

Each has ``main(argv=None) -> int`` and the port's ``--platform`` flag
("cuda" by default; a missing card raises, it never falls back to the CPU).
``bench_pipeline``, the JOIN → GROUP BY → top-10 query, stays at
``partitionedhashjoin_tpu_torch/bench_pipeline.py``, where it was first
ported.  ``scripts/figure.py`` imports no JAX and reads the ``figure.dat``
written here as it is.
"""
