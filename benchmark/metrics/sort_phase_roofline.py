"""The joiner's partition phase (both key sorts, closed by a barrier) against
both key columns read and written once, mean over the traced stretch."""

from benchmark import bytes as model


def read(ctx):
    phases = [op.phases["partition"] for op in ctx.stretch_ops()
              if op.phases and op.phases.get("partition")]
    if not phases:
        return None
    mean_s = sum(phases) / len(phases)
    return model.roofline_pct(
        model.sort_phase_bytes(ctx.n_build, ctx.n_probe, ctx.key_bytes), mean_s)
