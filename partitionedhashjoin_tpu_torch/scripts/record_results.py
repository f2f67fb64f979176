"""Record a results grid on one device, in the reference's schema.

Counterpart of ``scripts/record_results.py``.  Writes
``<outdir>/partitions_*.txt`` (and ``sortmerge.txt``, ``shuffle*.txt``) in
the CLI's JSON schema, plus ``figure.dat`` with the JAX script's columns in
its order (``SortMerge``, ``NoPartitioning``, ``Shuffle_1``,
``ShufflePiped_1``, ``Radix_<P>``, ``NoPartChained``, ``Radix2Pass_<P>``,
``RadixChained_<P>``), from ONE process: the relations are generated once
(the sequential primary; the secondary from the rejection sampler
``zipf_keys``, or ``uniform_keys`` at skew 0, seeded ``--seed``, with zero
payloads), then each algo runs once untimed with its count checked and once
under ``HashJoinTimer``.  A sampler that fails raises.

``--algos`` takes sort-merge, no-partitioning, radix, shuffle,
nopart-chained, radix-2pass and radix-chained.  ``shuffle`` runs on a
one-shard mesh of the device with the exchange kept
(``single_shard_fast_path=False``), then again with 4 pipelined chunks.
``--unit`` (ns, us, ms or s; default ms, the JAX script's) sets the unit of
the written durations: the schema prints whole units, and phases under a
millisecond print as 0 ms.

In the default radix mode ("vmem") the partition count is advisory, as in
the JAX package, so the ``Radix_<P>`` columns come out flat across P; P
changes the work of ``Radix2Pass_<P>`` and ``RadixChained_<P>`` only.

Usage:

    python -m partitionedhashjoin_tpu_torch.scripts.record_results \\
        --outdir results/h100 --partitions 32 256 2048 --unit us
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional, Sequence, Tuple

import torch

from partitionedhashjoin_tpu_torch.config import (
    NoPartitioningConfiguration,
    RadixClusteringConfiguration,
    ResultsFormatConfiguration,
)
from partitionedhashjoin_tpu_torch.data.table import Table, make_table
from partitionedhashjoin_tpu_torch.ops import generators
from partitionedhashjoin_tpu_torch.scripts._common import (
    add_platform,
    generator,
    log,
    open_device,
)
from partitionedhashjoin_tpu_torch.utils.device import sync
from partitionedhashjoin_tpu_torch.utils.results import (
    HashJoinTimer,
    JSONResultsFormatter,
    Parameters,
)

PHASES = ("partition", "build", "probe")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--outdir", required=True)
    p.add_argument("--skew", type=float, default=1.05)
    p.add_argument("--primary", type=int, default=10_000_000)
    p.add_argument("--secondary", type=int, default=200_000_000)
    p.add_argument("--partitions", type=int, nargs="*", default=[32, 256, 2048])
    p.add_argument("--seed", type=int, default=20260816)
    p.add_argument("--algos", nargs="*",
                   default=["sort-merge", "no-partitioning", "radix"])
    p.add_argument("--unit", default="ms", choices=("ns", "us", "ms", "s"),
                   help="duration unit of the written results")
    return add_platform(p)


def generate(args, device) -> Tuple[Table, Table]:
    """The sequential primary and the secondary: uniform ids at skew 0,
    else the rejection sampler's Zipf ids; zero payloads."""
    table_a = generators.sequential_table(args.primary, device=device)
    gen = generator(args.seed, device)
    if args.skew == 0.0:
        ids = generators.uniform_keys(args.secondary, 1, args.primary, gen,
                                      device)
    else:
        ids = generators.zipf_keys(args.secondary, args.skew, args.primary,
                                   generator=gen, device=device)
    table_b = make_table(
        ids, torch.zeros((args.secondary,), dtype=torch.int32, device=device))
    sync(device)
    return table_a, table_b


def write_figure(path: str, columns: List[Tuple[str, dict]]) -> None:
    """figure.dat: a header of configuration names, then one row per phase
    (the reference's column-stacked layout, scripts/figure.plot)."""
    lines = ["Phase " + " ".join(name for name, _ in columns)]
    for phase in PHASES:
        lines.append(
            phase + " " + " ".join(doc["results"][phase] for _, doc in columns)
        )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device, kind = open_device(args.platform)
    os.makedirs(args.outdir, exist_ok=True)

    from partitionedhashjoin_tpu_torch.ops.no_partitioning import (
        NoPartitioningHashJoiner,
    )
    from partitionedhashjoin_tpu_torch.ops.radix_cluster import RadixHashJoiner
    from partitionedhashjoin_tpu_torch.ops.sort_merge import SortMergeJoiner

    log(f"device: {kind}")
    t0 = time.perf_counter()
    table_a, table_b = generate(args, device)
    log(f"generate: {time.perf_counter() - t0:.3f}s")

    formatter = JSONResultsFormatter(
        ResultsFormatConfiguration(time_unit=args.unit))

    def record(joiner, type_tag, filename, extra_params=(), tables=None):
        a, b = tables or (table_a, table_b)
        params = Parameters()
        params.set_parameter("PrimaryRelationSize", str(args.primary))
        params.set_parameter("SecondaryRelationSize", str(args.secondary))
        params.set_parameter("Skew", f"{args.skew:.6f}")
        params.set_parameter("Type", type_tag)
        for k, v in extra_params:
            params.set_parameter(k, v)
        timer = HashJoinTimer(params)
        count = joiner.run(a, b)  # warmup
        if count != args.secondary:
            raise AssertionError(f"{type_tag}: {count}")
        t0 = time.perf_counter()
        joiner.run(a, b, timer)
        log(f"{filename}: {time.perf_counter() - t0:.6f}s total")
        path = os.path.join(args.outdir, filename)
        with open(path, "w") as f:
            formatter.format(f, timer.get_result())
        with open(path) as f:
            return json.load(f)

    columns = []
    if "sort-merge" in args.algos:
        doc = record(SortMergeJoiner(), "SortMerge", "sortmerge.txt")
        columns.append(("SortMerge", doc))
    if "no-partitioning" in args.algos:
        doc = record(NoPartitioningHashJoiner(seed=7), "NoPartitioning",
                     "partitions_1.txt")
        columns.append(("NoPartitioning", doc))
    if "shuffle" in args.algos:
        from partitionedhashjoin_tpu_torch.parallel.mesh import (
            make_mesh,
            shard_table,
        )
        from partitionedhashjoin_tpu_torch.parallel.shuffle import (
            DistributedShuffleJoiner,
        )

        # one shard on the device, the counterpart of make_mesh() on one
        # chip; the exchange machinery is kept, not elided
        mesh = make_mesh(1, devices=[device])
        sharded = (shard_table(table_a, mesh), shard_table(table_b, mesh))
        shards = str(mesh.size)
        doc = record(
            DistributedShuffleJoiner(mesh, seed=7, single_shard_fast_path=False),
            "DistributedShuffle", "shuffle.txt",
            [("NumberOfShards", shards)], sharded,
        )
        columns.append((f"Shuffle_{mesh.size}", doc))
        doc = record(
            DistributedShuffleJoiner(mesh, seed=7, pipeline_chunks=4,
                                     single_shard_fast_path=False),
            "DistributedShufflePipelined", "shuffle_pipelined.txt",
            [("NumberOfShards", shards), ("PipelineChunks", "4")], sharded,
        )
        columns.append((f"ShufflePiped_{mesh.size}", doc))
        del sharded
    if "radix" in args.algos:
        for parts in args.partitions:
            joiner = RadixHashJoiner(
                RadixClusteringConfiguration(number_of_partitions=parts),
                seed=7,
            )
            doc = record(joiner, "RadixPartitioning", f"partitions_{parts}.txt",
                         [("NumberOfPartitions", str(parts))])
            columns.append((f"Radix_{parts}", doc))
    if "nopart-chained" in args.algos:
        doc = record(
            NoPartitioningHashJoiner(
                NoPartitioningConfiguration(mode="chained"), seed=7),
            "NoPartitioning", "partitions_1_chained.txt", [("Mode", "chained")],
        )
        columns.append(("NoPartChained", doc))
    if "radix-2pass" in args.algos:
        # the Manegold multi-pass fan-out, chained mode, first P only
        for parts in args.partitions[:1]:
            joiner = RadixHashJoiner(
                RadixClusteringConfiguration(
                    number_of_partitions=parts, mode="chained",
                    partition_passes=2,
                ),
                seed=7,
            )
            doc = record(
                joiner, "RadixPartitioning", f"partitions_{parts}_2pass.txt",
                [("NumberOfPartitions", str(parts)), ("Mode", "chained"),
                 ("PartitionPasses", "2")],
            )
            columns.append((f"Radix2Pass_{parts}", doc))
    if "radix-chained" in args.algos:
        # the reference-structured hash fan-out + chained tables, first P only
        for parts in args.partitions[:1]:
            joiner = RadixHashJoiner(
                RadixClusteringConfiguration(
                    number_of_partitions=parts, mode="chained"),
                seed=7,
            )
            doc = record(
                joiner, "RadixPartitioning", f"partitions_{parts}_chained.txt",
                [("NumberOfPartitions", str(parts)), ("Mode", "chained")],
            )
            columns.append((f"RadixChained_{parts}", doc))

    write_figure(os.path.join(args.outdir, "figure.dat"), columns)
    log("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
