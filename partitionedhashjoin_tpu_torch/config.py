"""Typed configuration for the engine.

A copy of ``partitionedhashjoin_tpu/config.py`` (importing that module would
import jax through its package ``__init__``).  Some fields only steer joins
that the port has not taken over yet; they are kept so both packages share
one configuration schema.

Counterpart of the reference's configuration layer
(src/Common/Configuration.hpp:55-68, src/Common/Configuration.cpp:4-106,
src/Arguments.hpp:7-18, src/NoPartitioning/Configuration.hpp,
src/RadixCluster/Configuration.hpp).  String forms of the enums match the
reference CLI exactly ("no-partitioning" / "radix-partitioning", "json",
"file": src/Common/Configuration.cpp:4-84).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class JoinAlgorithmType(enum.Enum):
    """Join algorithm selector (src/Common/Configuration.hpp:10-15).

    The reference enum value is (typo'd) ``RadixParitioning``; we keep a clean
    Python name but emit the reference's exact output-JSON spelling via
    ``results_type_tag`` for schema parity (src/main.cpp:127).
    """

    NO_PARTITIONING = "no-partitioning"
    RADIX_PARTITIONING = "radix-partitioning"

    @staticmethod
    def from_string(s: str) -> "JoinAlgorithmType":
        for member in JoinAlgorithmType:
            if member.value == s:
                return member
        raise ValueError(f"Unrecognized join algorithm type: {s}.")

    def __str__(self) -> str:
        return self.value

    @property
    def results_type_tag(self) -> str:
        """The 'Type' parameter string used in output JSON (src/main.cpp:96,127).

        Note: the reference emits the typo'd 'RadixParitioning'; we emit the
        corrected spelling and the CLI accepts both when parsing old files.
        """
        if self is JoinAlgorithmType.NO_PARTITIONING:
            return "NoPartitioning"
        return "RadixPartitioning"


class ResultsFormat(enum.Enum):
    """Output format (src/Common/Configuration.hpp:17-19); only JSON exists."""

    JSON = "json"

    @staticmethod
    def from_string(s: str) -> "ResultsFormat":
        if s == "json":
            return ResultsFormat.JSON
        raise ValueError(f"Unrecognized results format: {s}.")

    def __str__(self) -> str:
        return self.value


class OutputType(enum.Enum):
    """Output sink (src/Common/Configuration.hpp:21-23); file or stdout."""

    FILE = "file"
    STDOUT = "stdout"  # engine extension; the reference supports file only

    @staticmethod
    def from_string(s: str) -> "OutputType":
        for member in OutputType:
            if member.value == s:
                return member
        raise ValueError(f"Unrecognized output type: {s}.")

    def __str__(self) -> str:
        return self.value


_ALLOWED_TIME_UNITS = ("ns", "us", "ms", "s")


@dataclasses.dataclass
class LoggerConfiguration:
    """Logging config (src/Common/Configuration.hpp:27-29)."""

    log_level: str = "debug"


@dataclasses.dataclass
class FileOutputConfiguration:
    name: str = "hashjoin.txt"


@dataclasses.dataclass
class OutputConfiguration:
    """Where results go (src/Common/Configuration.hpp:31-38,.cpp:86-93)."""

    type: OutputType = OutputType.FILE
    file: FileOutputConfiguration = dataclasses.field(
        default_factory=FileOutputConfiguration
    )

    def validate(self) -> None:
        if self.type == OutputType.FILE and not self.file.name:
            raise ValueError(
                "OutputConfiguration.validate: empty configuration filename specified."
            )


@dataclasses.dataclass
class ResultsFormatConfiguration:
    """Format + time unit of rendered results (Configuration.hpp:40-46,.cpp:95-106)."""

    format: ResultsFormat = ResultsFormat.JSON
    time_unit: str = "ms"

    def validate(self) -> None:
        if self.time_unit not in _ALLOWED_TIME_UNITS:
            raise ValueError(
                "ResultsFormatConfiguration.validate: Unrecognized time unit: "
                + self.time_unit
            )


@dataclasses.dataclass
class NoPartitioningConfiguration:
    """No-partitioning join knobs (src/NoPartitioning/Configuration.hpp:5-8).

    The reference's MinBatchSize (=10000) sizes per-thread work batches; the
    TPU analogue is the probe chunk size — rows per dispatched probe program
    (ops/hash_table.py::dispatch_chunks).
    """

    min_batch_size: int = 10_000
    #: probe rows per dispatched chunk in "chained" mode (the TPU analogue of
    #: MinBatchSize's per-thread batching: bounds single-program runtime and
    #: temp memory — the gather probe costs ~90 ns/row, so 25M rows ≈ 2.3 s
    #: per program, safely under the 20-30 s device watchdog)
    probe_chunk_rows: int = 25_000_000
    #: probe rows per dispatched chunk in "vmem" mode.  The sort+kernel probe
    #: costs ~3 ns/row — ~30x cheaper than the gather probe — so its chunk
    #: bound engages only for relations ~10x past the benchmark scale
    #: (2B rows ≈ 6 s/program); int64 probes are never chunked (validity
    #: masks are int32-path only, documented in merge_join.PreparedBuild).
    #: The port ignores it: the windows exist for the TPU's watchdog, and
    #: ops/no_partitioning.py probes in one call.
    vmem_probe_chunk_rows: int = 2_000_000_000
    #: global-structure layout: "vmem" = sorted build run probed by the
    #: Mosaic merge-probe kernel (zero HBM gathers), "chained" = chained
    #: hash table probed by HBM gathers (the literal table analogue),
    #: "auto" = vmem when the kernel backend is available.  In the port
    #: "vmem" is the sorted run probed by the CUDA merge-probe kernel,
    #: "auto" is "vmem" on every device, and "chained" is not ported yet.
    mode: str = "auto"


@dataclasses.dataclass
class RadixClusteringConfiguration:
    """Radix join knobs (src/RadixCluster/Configuration.hpp:5-9).

    number_of_partitions mirrors the reference default (=32).  On TPU the
    partitioner is VMEM-conscious instead of TLB-conscious: partitions are
    sized so build-side partitions fit VMEM during the probe kernel.
    """

    number_of_partitions: int = 32
    min_batch_size: int = 10_000
    #: engine extension: multi-pass radix cluster (Manegold/Balkesen); the
    #: reference is single-pass.  >1 = LSD digit passes over the pid bits.
    partition_passes: int = 1
    #: partition/probe implementation:
    #:   "vmem"    range-radix clustering (sort by key = contiguous key-range
    #:             partitions, Manegold's radix-cluster on key bits) + the
    #:             VMEM merge-probe kernel (ops/pallas/merge_probe.py) — no
    #:             HBM gathers; number_of_partitions is advisory (the kernel
    #:             ranges every probe block individually)
    #:   "chained" hash(key)&(P-1) fan-out + per-partition chained tables
    #:             (the reference's exact structure, HashJoin.hpp:243-440)
    #:   "auto"    "vmem" when the Mosaic kernel runs on this backend,
    #:             else "chained"
    #: In the port "auto" is "vmem" on every device and "chained" is not
    #: ported yet (ops/radix_cluster.py).
    mode: str = "auto"


@dataclasses.dataclass
class Configuration:
    """Aggregate run configuration (src/Common/Configuration.hpp:55-68)."""

    primary_relation_size: int = 10_000_000
    secondary_relation_size: int = 200_000_000
    skew_parameter: float = 1.05
    join_type: JoinAlgorithmType = JoinAlgorithmType.NO_PARTITIONING
    logger_config: LoggerConfiguration = dataclasses.field(
        default_factory=LoggerConfiguration
    )
    output_config: OutputConfiguration = dataclasses.field(
        default_factory=OutputConfiguration
    )
    output_format_config: ResultsFormatConfiguration = dataclasses.field(
        default_factory=ResultsFormatConfiguration
    )
    no_partitioning_config: NoPartitioningConfiguration = dataclasses.field(
        default_factory=NoPartitioningConfiguration
    )
    radix_clustering_config: RadixClusteringConfiguration = dataclasses.field(
        default_factory=RadixClusteringConfiguration
    )
    # Engine extensions (no reference equivalent):
    seed: Optional[int] = None  # data-generation seed; None -> fresh entropy
    key_dtype: str = "int32"  # 'int32' (default) or 'int64'

    def validate(self) -> None:
        self.output_config.validate()
        self.output_format_config.validate()
        if self.primary_relation_size <= 0 or self.secondary_relation_size <= 0:
            raise ValueError("Relation sizes must be positive.")
        if self.key_dtype not in ("int32", "int64"):
            raise ValueError(f"Unsupported key dtype: {self.key_dtype}")


def validate_parsed_configuration(
    configuration: Configuration, partitions_given: bool
) -> None:
    """Cross-field CLI validation (src/Arguments.hpp:7-18).

    ``--partitions`` is only legal for the radix-partitioning join.
    """
    if (
        partitions_given
        and configuration.join_type != JoinAlgorithmType.RADIX_PARTITIONING
    ):
        raise ValueError(
            "Number of partitions can only be specified for "
            "radix-partitioning join algorithm."
        )
    configuration.validate()
