"""1 − (union of the device's kernel, copy and set intervals) / the traced
stretch's wall time, in %."""


def read(ctx):
    s = ctx.stretch
    if s is None or not s.device_events:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
