"""The joiner's probe phase (HashJoinTimer), mean ms over the traced stretch."""


def read(ctx):
    phases = [op.phases["probe"] for op in ctx.stretch_ops()
              if op.phases and op.phases.get("probe")]
    if not phases:
        return None
    return sum(phases) / len(phases) * 1e3
