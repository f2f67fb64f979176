"""Probe rows of every operation of the window over the window's wall time."""


def read(ctx):
    return ctx.n_probe * len(ctx.ops) / ctx.window_s
