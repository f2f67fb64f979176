"""partitionedhashjoin_tpu_torch — the PyTorch/CUDA port of the engine.

A second package beside ``partitionedhashjoin_tpu`` (the JAX reference).  It
imports torch and numpy and never jax.  The layout mirrors the JAX package so
that each counterpart is easy to find:

- ``config``, ``utils.logger``, ``utils.results``, ``utils.rng``,
  ``utils.pipeline``, ``utils.profiling``: copies of the JAX package's
  backend-free modules (importing those would import jax).
- ``utils.device``: explicit torch device selection and synchronisation.
- ``data.table``: relations as dataclasses of tensors; ``data.host_loader``:
  the native host runtime (``native/phj_host.cpp``, built with g++ at first
  use).
- ``ops.generators``: the sequential and Zipf relation generators
  (rejection and alias samplers).
- ``ops.hashing``: the seeded hashes; ``ops.hash_table``: the
  open-addressing, chained and dedup hash tables; ``ops.radix``: the
  hash fan-out into partitions.
- ``ops.merge_join`` / ``ops.sort_merge``: the count joins and the
  materializing joins; ``ops.no_partitioning``, ``ops.radix_cluster``,
  ``ops.planner``: the joiners of the CLI (the first two in their sorted
  "vmem" and hash-table "chained" modes).
- ``ops.aggregate``, ``ops.filter``, ``ops.sort``, ``ops.order_by``: the
  hash and sort GROUP BY families and the relational operators;
  ``ops.multi_key``: composite-key counts.
- ``ops.kernels`` + ``csrc/``: the hand-written CUDA kernels (K1–K8), each
  beside its plain PyTorch version, built with nvcc at first use.
- ``parallel.mesh`` / ``parallel.shuffle``: a mesh of shards on one device
  and the distributed shuffle join over it; ``parallel.aggregate_shuffle``,
  ``parallel.top_k``, ``parallel.join_aggregate``,
  ``parallel.materialize_shuffle``, ``parallel.multi_key_shuffle``: the
  distributed GROUP BY, top-k, join → GROUP BY, materializing join and
  composite-key join on its exchange (the query layer's R6).
- ``query`` / ``sql``: the fluent query layer and the SQL front end.
- ``cli``: ``python -m partitionedhashjoin_tpu_torch``; ``bench``: the
  reference workload's one-line bench;
  ``bench_pipeline``: the JOIN → GROUP BY → top-10 query;
  ``profile_joins``: a device-time breakdown of each path.

The JAX package's convenience exports (``NoPartitioningHashJoiner``,
``DistributedShuffleJoiner``, ``hash_aggregate``, ``scan``, ``execute_sql``,
...) and ``make_mesh`` / ``shard_table`` resolve lazily to the port's
modules.  Importing the package imports no joiner and builds no
kernel and no host library.
"""

import importlib

from partitionedhashjoin_tpu_torch import config
from partitionedhashjoin_tpu_torch.config import (
    Configuration,
    JoinAlgorithmType,
    OutputType,
    ResultsFormat,
)

__version__ = "0.1.0"

__all__ = [
    "Configuration",
    "JoinAlgorithmType",
    "OutputType",
    "ResultsFormat",
    "config",
]

_LAZY = {
    "Table": ("data.table", "Table"),
    "SortMergeJoiner": ("ops.sort_merge", "SortMergeJoiner"),
    "NoPartitioningHashJoiner": ("ops.no_partitioning", "NoPartitioningHashJoiner"),
    "RadixHashJoiner": ("ops.radix_cluster", "RadixHashJoiner"),
    "DistributedShuffleJoiner": ("parallel.shuffle", "DistributedShuffleJoiner"),
    "make_mesh": ("parallel.mesh", "make_mesh"),
    "shard_table": ("parallel.mesh", "shard_table"),
    "sequential_table": ("ops.generators", "sequential_table"),
    "zipf_table": ("ops.generators", "zipf_table"),
    "hash_aggregate": ("ops.aggregate", "hash_aggregate"),
    "filter_table": ("ops.filter", "filter_table"),
    "sort_table": ("ops.sort", "sort_table"),
    "radix_sort_table": ("ops.sort", "radix_sort_table"),
    "scan": ("query", "scan"),
    "Query": ("query", "Query"),
    "execute_sql": ("sql", "execute_sql"),
    "explain_sql": ("sql", "explain_sql"),
}


def __getattr__(name):
    """The JAX package's lazy exports, from the port's modules."""
    if name in _LAZY:
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(f"{__name__}.{module}"), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
