"""The hash GROUP BY's build phase (HashJoinTimer, closed by a barrier): the
dedup claim loop over the table's slots, K7 included; mean ms over the
traced stretch, None where the stretch holds no device event."""


def mean_phase(ctx, name):
    """The mean of the phase ``name`` over the traced stretch's operations,
    None where the stretch holds no device event or no such phase."""
    if ctx.stretch is None or not ctx.stretch.device_events:
        return None
    phases = [op.phases[name] for op in ctx.stretch_ops()
              if op.phases and op.phases.get(name) is not None]
    if not phases:
        return None
    return sum(phases) / len(phases)


def read(ctx):
    seconds = mean_phase(ctx, "build")
    return None if seconds is None else seconds * 1e3
