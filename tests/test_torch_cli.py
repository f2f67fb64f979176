"""The port's CLI against the JAX CLI, on the CPU: the counterpart of
tests/test_cli.py for ``python -m partitionedhashjoin_tpu_torch``.

Both CLIs get the same argv with ``--platform cpu``; the result documents
must have the same ``id``, ``parameters`` and result keys, and the port's
count (read from its "Join produced" log line) must be the probe size —
every key of the Zipf relation lies in the sequential build's range.
"""

import json
import re

import jax
import pytest

from partitionedhashjoin_tpu import cli as jax_cli
from partitionedhashjoin_tpu_torch import cli

SIZES = ["--primary", "1024", "--secondary", "4096", "--seed", "7"]


def _port(argv, capsys):
    """(document, count) of one port run on the CPU."""
    assert cli.main(argv + ["--output", "stdout", "--platform", "cpu",
                            "--log", "info"]) == 0
    captured = capsys.readouterr()
    counts = re.findall(r"Join produced (\d+) matches", captured.err)
    assert len(counts) == 1, captured.err
    return json.loads(captured.out), int(counts[0])


def _jax(argv, capsys):
    try:
        assert jax_cli.main(argv + ["--output", "stdout", "--platform", "cpu",
                                    "--log", "error"]) == 0
    finally:
        # the JAX CLI turns x64 on process-wide for int64 keys
        jax.config.update("jax_enable_x64", False)
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("extra", [
    [],
    ["--join", "no-partitioning"],
    ["--join", "radix-partitioning", "--partitions", "16"],
    ["--join", "radix-partitioning", "--reference-spelling"],
    ["--join", "planned"],
    ["--join", "sort-merge"],
    ["--join", "sort-merge", "--key-dtype", "int64"],
])
def test_document_matches_jax_cli(extra, capsys):
    want = _jax(SIZES + extra, capsys)
    doc, count = _port(SIZES + extra, capsys)
    assert count == 4096
    assert doc["id"] == want["id"] == "hashjointimingresult"
    assert doc["parameters"] == want["parameters"]
    assert set(doc["results"]) == set(want["results"]) == {
        "partition", "build", "probe"
    }


def test_default_join_is_no_partitioning(capsys):
    doc, count = _port(SIZES, capsys)
    assert count == 4096
    assert doc["parameters"] == {
        "PrimaryRelationSize": "1024",
        "SecondaryRelationSize": "4096",
        "Skew": "1.050000",
        "Type": "NoPartitioning",
    }
    assert doc["results"]["partition"] == "0"


@pytest.mark.parametrize("spelling,tag", [
    ([], "RadixPartitioning"), (["--reference-spelling"], "RadixParitioning"),
])
def test_radix_partitions_and_spelling(spelling, tag, capsys):
    doc, count = _port(SIZES + ["--join", "radix-partitioning",
                                "--partitions", "64"] + spelling, capsys)
    assert count == 4096
    assert doc["parameters"]["Type"] == tag
    assert doc["parameters"]["NumberOfPartitions"] == "64"


def test_planned_records_plan(capsys):
    doc, count = _port(SIZES + ["--join", "planned"], capsys)
    assert count == 4096
    assert doc["parameters"]["Type"] == "Planned"
    # sequential primary relation => covered => the interval plan
    assert doc["parameters"]["Plan"] == "interval"


def test_int64_sort_merge(capsys):
    doc, count = _port(SIZES + ["--join", "sort-merge", "--key-dtype", "int64"],
                       capsys)
    assert count == 4096
    assert doc["parameters"]["Type"] == "SortMerge"


@pytest.mark.parametrize("join", ["no-partitioning", "radix-partitioning", "planned"])
def test_int64_rejected_for_other_joins_like_jax(join):
    argv = ["--join", join, "--key-dtype", "int64"]
    with pytest.raises(SystemExit) as jax_exc:
        jax_cli.parse_arguments(argv)
    with pytest.raises(SystemExit) as exc:
        cli.parse_arguments(argv)
    assert str(exc.value) == str(jax_exc.value) == (
        "int64 keys are supported by the sort-merge join only "
        "(hash-table kernels are 32-bit)."
    )


@pytest.mark.parametrize("join", [
    "no-partitioning", "radix-partitioning", "planned", "sort-merge",
])
def test_prime_sized_relations(join, capsys):
    extra = ["--partitions", "8"] if join == "radix-partitioning" else []
    doc, count = _port(["--primary", "1009", "--secondary", "4999", "--seed",
                        "4", "--join", join] + extra, capsys)
    assert count == 4999
    assert int(doc["results"]["probe"]) >= 0


def test_partitions_rejected_for_non_radix():
    for parse in (jax_cli.parse_arguments, cli.parse_arguments):
        with pytest.raises(SystemExit):
            parse(["--join", "no-partitioning", "--partitions", "8"])


def test_default_configuration_matches_jax():
    config, args = cli.parse_arguments([])
    jax_config, jax_args = jax_cli.parse_arguments([])
    assert args.join == jax_args.join == "no-partitioning"
    for field in ("primary_relation_size", "secondary_relation_size",
                  "skew_parameter", "key_dtype"):
        assert getattr(config, field) == getattr(jax_config, field)
    assert config.join_type.value == jax_config.join_type.value
    assert config.radix_clustering_config.number_of_partitions == 32
    assert args.platform == "cuda"


@pytest.mark.parametrize("primary,method", [
    (1024, "alias"), (1 << 24, "alias"), ((1 << 24) + 1, "rejection"),
])
@pytest.mark.parametrize("key_dtype", ["int32", "int64"])
def test_generation_method_follows_jax_rule(primary, method, key_dtype, monkeypatch):
    """The alias sampler for primaries up to 2^24, rejection above, for both
    key widths (the JAX CLI's cli.py:175-177)."""
    import logging

    from partitionedhashjoin_tpu_torch.ops import generators

    calls = []
    monkeypatch.setattr(generators, "sequential_table", lambda n, **kw: None)
    monkeypatch.setattr(generators, "zipf_table",
                        lambda *a, **kw: calls.append(kw["method"]))
    config, _ = cli.parse_arguments(["--primary", str(primary), "--join", "sort-merge",
                                     "--key-dtype", key_dtype])
    cli.generate_tables(config, logging.getLogger("test"), "cpu")
    assert calls == [method]
