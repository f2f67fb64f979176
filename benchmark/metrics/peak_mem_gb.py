"""``torch.cuda.max_memory_allocated()`` over the window (reset at its start),
the resident relations included, in GB (1e9 B)."""


def read(ctx):
    return ctx.peak_bytes / 1e9
