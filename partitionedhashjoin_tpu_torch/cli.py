"""Command line of the port, with `phjoin` flag and output parity.

Counterpart of ``partitionedhashjoin_tpu/cli.py`` and of the reference's
src/main.cpp:141-293: parse flags → init logger → generate relations → run
the join → render timing JSON.  The parser, flags, defaults and JSON schema
are the JAX CLI's.

Ported: ``--join no-partitioning`` (the default), ``radix-partitioning``,
``sort-merge`` and ``planned``, with ``--key-dtype int64`` for sort-merge
only (the other joins exit with the JAX CLI's message).  ``--join shuffle``
and the shuffle / multi-host flags are parsed and rejected with exit code 2
and "not yet ported (ROADMAP)".  ``--platform`` names the torch device,
"cuda" (the default) or "cpu"; a missing card raises rather than falling
back to the CPU.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from partitionedhashjoin_tpu_torch.config import (
    Configuration,
    JoinAlgorithmType,
    OutputType,
    validate_parsed_configuration,
)
from partitionedhashjoin_tpu_torch.utils import logger as logging_utils
from partitionedhashjoin_tpu_torch.utils.results import (
    HashJoinTimer,
    Parameters,
    select_results_formatter,
    select_results_renderer,
)

#: Extended join selector values (the reference knows only the first two,
#: src/Common/Configuration.cpp:4-40).
JOIN_CHOICES = (
    "no-partitioning",
    "radix-partitioning",
    "sort-merge",
    "shuffle",
    "planned",
)

#: Joins this package runs; the others are listed in ROADMAP.md.
PORTED_JOINS = ("no-partitioning", "radix-partitioning", "sort-merge", "planned")

#: Flags that only the shuffle join or multi-host runs read.
_UNPORTED_FLAGS = (
    "shards", "local_join", "pipeline_chunks", "coordinator",
    "num_processes", "process_id",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="phjoin-torch",
        description="PyTorch/CUDA partitioned hash join benchmark",
    )
    # names/defaults per main.cpp:144-186
    p.add_argument("--primary", type=int, default=10_000_000,
                   help="primary (build) relation size")
    p.add_argument("--secondary", type=int, default=200_000_000,
                   help="secondary (probe) relation size")
    p.add_argument("--skew", type=float, default=1.05,
                   help="Zipf skew of the secondary relation (0 = uniform)")
    p.add_argument("--join", choices=JOIN_CHOICES, default="no-partitioning",
                   help="join algorithm (shuffle is not ported yet)")
    p.add_argument("--partitions", type=int, default=None,
                   help="radix partition count (radix-partitioning only)")
    p.add_argument("--log", default="info", help="log severity level")
    p.add_argument("--format", default="json", help="results format")
    p.add_argument("--unit", default="ms", choices=("ns", "us", "ms", "s"),
                   help="duration unit in results")
    p.add_argument("--output", default="file", choices=("file", "stdout"),
                   help="results sink")
    p.add_argument("--filename", default="hashjoin.txt",
                   help="results file name (when --output file)")
    # engine extensions
    p.add_argument("--shards", type=int, default=None,
                   help="device count for --join shuffle (not yet ported)")
    p.add_argument("--seed", type=int, default=None,
                   help="data generation seed (default: fresh entropy)")
    p.add_argument("--local-join", default="sort-merge",
                   choices=("sort-merge", "hash"),
                   help="shuffle join's per-shard join strategy "
                   "(not yet ported)")
    p.add_argument("--pipeline-chunks", type=int, default=1,
                   help="shuffle join: probe exchange chunks (not yet ported)")
    p.add_argument("--key-dtype", default="int32", choices=("int32", "int64"),
                   help="tuple id width; int64 matches the reference's "
                   "Tuple::id (requires the sort-merge join)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the untimed warmup run (timed phases then "
                   "include the one-time kernel build and CUDA start-up)")
    p.add_argument("--reference-spelling", action="store_true",
                   help="emit the reference's literal Type tags, including "
                   "its 'RadixParitioning' typo (main.cpp:127)")
    p.add_argument("--coordinator", default=None,
                   help="multi-host coordinator address (not yet ported)")
    p.add_argument("--num-processes", type=int, default=1,
                   help="total process count (not yet ported)")
    p.add_argument("--process-id", type=int, default=0,
                   help="this process's id (not yet ported)")
    p.add_argument("--platform", default="cuda",
                   help="torch device: 'cuda' (default) or 'cpu'")
    return p


def parse_arguments(argv: Optional[Sequence[str]] = None) -> "tuple[Configuration, argparse.Namespace]":
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.join not in PORTED_JOINS:
        parser.error(f"--join {args.join} is not yet ported (ROADMAP)")
    for dest in _UNPORTED_FLAGS:
        if getattr(args, dest) != parser.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            parser.error(f"{flag} is not yet ported (ROADMAP)")
    config = Configuration()
    config.primary_relation_size = args.primary
    config.secondary_relation_size = args.secondary
    config.skew_parameter = args.skew
    if args.join in ("no-partitioning", "radix-partitioning"):
        config.join_type = JoinAlgorithmType.from_string(args.join)
    config.logger_config.log_level = args.log
    config.output_format_config.format = config.output_format_config.format.from_string(args.format)
    config.output_format_config.time_unit = args.unit
    config.output_config.type = OutputType.from_string(args.output)
    config.output_config.file.name = args.filename
    if args.partitions is not None:
        config.radix_clustering_config.number_of_partitions = args.partitions
    config.seed = args.seed
    config.key_dtype = args.key_dtype
    if args.key_dtype == "int64" and args.join != "sort-merge":
        raise SystemExit(
            "int64 keys are supported by the sort-merge join only "
            "(hash-table kernels are 32-bit)."
        )
    # cross-field check (src/Arguments.hpp:7-18): --partitions is only legal
    # with the radix join
    try:
        validate_parsed_configuration(
            config, partitions_given=args.partitions is not None
        )
    except ValueError as e:
        raise SystemExit(str(e)) from e
    return config, args


def generate_tables(config: Configuration, log, device):
    """Generate both relations on ``device`` (main.cpp:35-79).

    The secondary relation uses the rejection sampler.  The JAX CLI picks
    the alias sampler for primaries up to 2^24 rows (its cli.py:175-177);
    that sampler is not ported yet, so the two CLIs draw from the same
    distribution by different methods.
    """
    from partitionedhashjoin_tpu_torch.ops.generators import (
        sequential_table,
        zipf_table,
    )
    import torch

    from partitionedhashjoin_tpu_torch.utils.device import sync

    dtype = torch.int64 if config.key_dtype == "int64" else torch.int32
    log.info(
        "Generating primary (%d) and secondary (%d, skew %.2f) relations",
        config.primary_relation_size,
        config.secondary_relation_size,
        config.skew_parameter,
    )
    table_a = sequential_table(
        config.primary_relation_size, dtype=dtype, device=device
    )
    table_b = zipf_table(
        config.secondary_relation_size,
        alpha=config.skew_parameter,
        key_range=(1, config.primary_relation_size),
        seed=config.seed,
        dtype=dtype,
        method="rejection",
        device=device,
    )
    sync(device)
    return table_a, table_b


def _base_parameters(config: Configuration) -> Parameters:
    params = Parameters()
    params.set_parameter(
        "PrimaryRelationSize", str(config.primary_relation_size)
    )
    params.set_parameter(
        "SecondaryRelationSize", str(config.secondary_relation_size)
    )
    # six decimals like C++ std::to_string(double) (main.cpp:97)
    params.set_parameter("Skew", f"{config.skew_parameter:.6f}")
    return params


def _make_joiner(join_name: str, config: Configuration, args, params: Parameters):
    """The selected joiner, with the join's own parameters set (the JAX
    CLI's cli.py:210-246)."""
    if join_name == "no-partitioning":
        from partitionedhashjoin_tpu_torch.ops.no_partitioning import (
            NoPartitioningHashJoiner,
        )

        params.set_parameter("Type", "NoPartitioning")
        return NoPartitioningHashJoiner(
            config.no_partitioning_config, seed=config.seed
        )
    if join_name == "radix-partitioning":
        from partitionedhashjoin_tpu_torch.ops.radix_cluster import RadixHashJoiner

        params.set_parameter(
            "Type",
            # the reference's enum literal is typo'd (main.cpp:127); tooling
            # that diffs against its output can opt into byte parity
            "RadixParitioning" if args.reference_spelling else "RadixPartitioning",
        )
        params.set_parameter(
            "NumberOfPartitions",
            str(config.radix_clustering_config.number_of_partitions),
        )
        return RadixHashJoiner(config.radix_clustering_config, seed=config.seed)
    if join_name == "sort-merge":
        from partitionedhashjoin_tpu_torch.ops.sort_merge import SortMergeJoiner

        params.set_parameter("Type", "SortMerge")
        return SortMergeJoiner()
    if join_name == "planned":
        from partitionedhashjoin_tpu_torch.ops.planner import PlannedJoiner

        params.set_parameter("Type", "Planned")
        return PlannedJoiner()
    raise ValueError(f"--join {join_name} is not yet ported (ROADMAP)")


def run_join(
    join_name: str, config: Configuration, args, table_a, table_b, log,
    warmup: bool = True,
):
    """Run the selected joiner (main.cpp:260-282) and return its timing."""
    params = _base_parameters(config)
    timer = HashJoinTimer(params)
    joiner = _make_joiner(join_name, config, args, params)
    if warmup:
        # untimed, so the phases measure the join and not the one-time
        # kernel build and CUDA start-up
        joiner.run(table_a, table_b)
    count = joiner.run(table_a, table_b, timer)
    if join_name == "planned":
        # observability: which plan the stats routed to
        params.set_parameter("Plan", joiner.last_plan or "")
    log.info("Join produced %d matches", count)
    return timer.get_result()


def main(argv: Optional[Sequence[str]] = None) -> int:
    from partitionedhashjoin_tpu_torch.utils.device import resolve_device

    config, args = parse_arguments(argv)
    device = resolve_device(args.platform)
    logging_utils.initialize_logger(config.logger_config.log_level)
    log = logging_utils.get_new_logger("Main")

    formatter = select_results_formatter(config.output_format_config)
    renderer = select_results_renderer(config.output_config)

    table_a, table_b = generate_tables(config, log, device)
    result = run_join(
        args.join, config, args, table_a, table_b, log,
        warmup=not args.no_warmup,
    )
    renderer.render(formatter, result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
