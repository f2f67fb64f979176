"""The chained joiner's build phase (HashJoinTimer, closed by a barrier): the
hash (K7), the stable sort by bucket, the bucket histogram and the key
gather; mean ms over the traced stretch."""


def read(ctx):
    phases = [op.phases["build"] for op in ctx.stretch_ops()
              if op.phases and op.phases.get("build")]
    if not phases:
        return None
    return sum(phases) / len(phases) * 1e3
