"""The hash GROUP BY's probe phase (HashJoinTimer, closed by a barrier): the
dense group ids and the COUNT, SUM, MIN and MAX scatters; mean ms over the
traced stretch, None where the stretch holds no device event."""

from benchmark.metrics.groupby_dedup_ms import mean_phase


def read(ctx):
    seconds = mean_phase(ctx, "probe")
    return None if seconds is None else seconds * 1e3
