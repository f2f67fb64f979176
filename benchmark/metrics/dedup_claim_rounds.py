"""Rounds of the dedup claim loop per operation (``hash_table.CLAIM_ROUNDS``,
read around each operation), mean over the traced stretch, None where the
stretch holds no device event."""

from benchmark.metrics.groupby_dedup_ms import mean_phase


def read(ctx):
    return mean_phase(ctx, "claim_rounds")
