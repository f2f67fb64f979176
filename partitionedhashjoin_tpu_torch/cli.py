"""Command line of the port, with `phjoin` flag and output parity.

Counterpart of ``partitionedhashjoin_tpu/cli.py`` and of the reference's
src/main.cpp:141-293: parse flags → init logger → generate relations → run
the join → render timing JSON.  The parser, flags, defaults and JSON schema
are the JAX CLI's.

Every join is ported: ``--join no-partitioning`` (the default),
``radix-partitioning``, ``sort-merge``, ``planned`` and ``shuffle`` (the
mesh join, ``parallel/shuffle.py``, with ``--shards``, ``--local-join`` and
``--pipeline-chunks``), with ``--key-dtype int64`` for sort-merge only (the
other joins exit with the JAX CLI's message).  In one process the shards of
``--join shuffle`` share the ``--platform`` device, so ``--shards`` defaults
to 1 where the JAX CLI takes every device.

``--coordinator host:port`` with ``--num-processes P`` and ``--process-id
i`` runs the shuffle join over P processes (``run_distributed``, the JAX
CLI's counterpart): start the same command once per process, each with its
own id.  Each process joins the group (``parallel/distributed.py``: card
``i % device_count``, NCCL, or gloo where processes share a card or on the
CPU), generates its slice of both relations, and runs the join over
``--shards`` shards (default: one per process); only process 0 renders a
document, and every process logs its count.  ``--coordinator`` requires
``--join shuffle``; without it ``--num-processes`` and ``--process-id`` are
ignored, as the JAX CLI ignores them.  ``--platform`` names the torch
device, "cuda" (the default) or "cpu"; a missing card raises rather than
falling back to the CPU.
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
                   help="join algorithm")
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
                   help="shard count for --join shuffle (a power of 2; a "
                   "process's shards share its device; default 1, or one per "
                   "process with --coordinator)")
    p.add_argument("--seed", type=int, default=None,
                   help="data generation seed (default: fresh entropy)")
    p.add_argument("--local-join", default="sort-merge",
                   choices=("sort-merge", "hash"),
                   help="shuffle join's per-shard join strategy")
    p.add_argument("--pipeline-chunks", type=int, default=1,
                   help="shuffle join: split the probe exchange into K "
                   "chunks, each counted by the per-chunk local join")
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
                   help="multi-process coordinator address host:port "
                   "(requires --join shuffle)")
    p.add_argument("--num-processes", type=int, default=1,
                   help="total process count (with --coordinator)")
    p.add_argument("--process-id", type=int, default=0,
                   help="this process's id (with --coordinator)")
    p.add_argument("--platform", default="cuda",
                   help="torch device: 'cuda' (default) or 'cpu'")
    return p


def parse_arguments(argv: Optional[Sequence[str]] = None) -> "tuple[Configuration, argparse.Namespace]":
    args = build_parser().parse_args(argv)
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

    The secondary relation uses the alias sampler (exact, from host-built
    Vose tables) for primaries up to 2^24 rows and the rejection sampler
    above, the JAX CLI's rule (its cli.py:175-177), for int32 and int64
    keys alike.
    """
    from partitionedhashjoin_tpu_torch.ops.generators import (
        ALIAS_MAX_CARDINALITY,
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
    method = (
        "alias"
        if config.primary_relation_size <= ALIAS_MAX_CARDINALITY
        else "rejection"
    )
    table_b = zipf_table(
        config.secondary_relation_size,
        alpha=config.skew_parameter,
        key_range=(1, config.primary_relation_size),
        seed=config.seed,
        dtype=dtype,
        method=method,
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


def _make_joiner(join_name: str, config: Configuration, args, params: Parameters,
                 mesh=None):
    """The selected joiner, with the join's own parameters set (the JAX
    CLI's cli.py:210-263); ``shuffle`` runs over ``mesh``."""
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
    if join_name == "shuffle":
        from partitionedhashjoin_tpu_torch.parallel.shuffle import (
            DistributedShuffleJoiner,
        )

        params.set_parameter("Type", "DistributedShuffle")
        params.set_parameter("NumberOfShards", str(mesh.size))
        return DistributedShuffleJoiner(
            mesh,
            seed=config.seed,
            local_join=args.local_join,
            pipeline_chunks=args.pipeline_chunks,
        )
    raise ValueError(f"unknown join {join_name!r}")


def run_join(
    join_name: str, config: Configuration, args, table_a, table_b, log,
    warmup: bool = True,
):
    """Run the selected joiner (main.cpp:260-282) and return its timing."""
    params = _base_parameters(config)
    timer = HashJoinTimer(params)
    mesh = None
    if join_name == "shuffle":
        from partitionedhashjoin_tpu_torch.parallel.mesh import make_mesh, shard_table

        mesh = make_mesh(args.shards, devices=[table_a.keys.device])
        table_a, table_b = shard_table(table_a, mesh), shard_table(table_b, mesh)
    joiner = _make_joiner(join_name, config, args, params, mesh)
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


def run_distributed(config: Configuration, args, log):
    """Multi-process path: join the group, generate this process's slices,
    run the global shuffle join.

    Every process runs this same entry point with its own
    ``--process-id``; only process 0 returns a result document (the others
    return None and render nothing), the single-writer convention of the
    JAX CLI (its cli.py:278-323).  The process leaves the group at the end.
    """
    from partitionedhashjoin_tpu_torch.parallel import distributed
    from partitionedhashjoin_tpu_torch.parallel.shuffle import DistributedShuffleJoiner

    if args.join != "shuffle":
        raise SystemExit("--coordinator requires --join shuffle")
    distributed.initialize(
        args.coordinator,
        args.num_processes,
        args.process_id,
        platform=args.platform,
    )
    try:
        mesh = distributed.global_mesh(args.shards)
        # one seed for every process (a process's own entropy would route
        # its rows differently)
        seed = config.seed if config.seed is not None else 0
        table_a, table_b = distributed.generate_global_tables(
            config.primary_relation_size,
            config.secondary_relation_size,
            config.skew_parameter,
            mesh,
            seed=seed,
        )
        params = _base_parameters(config)
        params.set_parameter("Type", "DistributedShuffle")
        params.set_parameter("NumberOfShards", str(mesh.size))
        params.set_parameter("NumberOfProcesses", str(mesh.process_count))
        timer = HashJoinTimer(params)
        joiner = DistributedShuffleJoiner(
            mesh,
            seed=seed,
            local_join=args.local_join,
            pipeline_chunks=args.pipeline_chunks,
        )
        if not args.no_warmup:
            joiner.run(table_a, table_b)
        count = joiner.run(table_a, table_b, timer)
        log.info("Join produced %d matches", count)
        return timer.get_result() if mesh.process_index == 0 else None
    finally:
        distributed.shutdown()


def main(argv: Optional[Sequence[str]] = None) -> int:
    from partitionedhashjoin_tpu_torch.utils.device import resolve_device

    config, args = parse_arguments(argv)
    device = resolve_device(args.platform)
    logging_utils.initialize_logger(config.logger_config.log_level)
    log = logging_utils.get_new_logger("Main")

    formatter = select_results_formatter(config.output_format_config)
    renderer = select_results_renderer(config.output_config)

    if args.coordinator is not None:
        result = run_distributed(config, args, log)
        if result is not None:
            renderer.render(formatter, result)
        return 0

    table_a, table_b = generate_tables(config, log, device)
    result = run_join(
        args.join, config, args, table_a, table_b, log,
        warmup=not args.no_warmup,
    )
    renderer.render(formatter, result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
