"""partitionedhashjoin_tpu_torch — the PyTorch/CUDA port of the engine.

A second package beside ``partitionedhashjoin_tpu`` (the JAX reference).  It
imports torch and numpy and never jax.  The layout mirrors the JAX package so
that each counterpart is easy to find:

- ``config``, ``utils.logger``, ``utils.results``: copies of the JAX package's
  backend-free modules (importing those would import jax).
- ``utils.device``: explicit torch device selection and synchronisation.
- ``data.table``: relations as dataclasses of tensors.
- ``ops.generators``: the sequential and Zipf relation generators.
- ``ops.merge_join`` / ``ops.sort_merge``: the count joins and the
  materializing joins; ``ops.no_partitioning``, ``ops.radix_cluster``,
  ``ops.planner``: the joiners of the CLI.
- ``ops.aggregate``, ``ops.filter``, ``ops.sort``, ``ops.order_by``: the
  sort-based GROUP BY and the relational operators.
- ``ops.kernels`` + ``csrc/``: the hand-written CUDA kernels (K1–K5), each
  beside its plain PyTorch version, built with nvcc at first use.
- ``cli``: ``python -m partitionedhashjoin_tpu_torch``;
  ``bench_pipeline``: the JOIN → GROUP BY → top-10 query;
  ``profile_joins``: a device-time breakdown of each path.

Importing the package builds no kernel.
"""

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
