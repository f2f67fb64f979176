"""The operation's compulsory bytes at 3.35 TB/s over the mean wall time of an
operation in the traced stretch."""

from benchmark import bytes as model


def read(ctx):
    ops = ctx.stretch_ops()
    if not ops:
        return None
    mean_s = sum(op.seconds for op in ops) / len(ops)
    return model.roofline_pct(ctx.op_bytes, mean_s)
