"""The 95th percentile of every operation's wall time in the window, from the
call to its answer on the host (linear interpolation between ranks)."""

import statistics


def read(ctx):
    ms = [op.seconds * 1e3 for op in ctx.ops]
    if len(ms) < 2:
        return ms[0]
    return statistics.quantiles(ms, n=100, method="inclusive")[94]
