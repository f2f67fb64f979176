"""K1 (``tile_ranges_kernel`` + ``ranged_count_kernel`` on int32 keys): its
device time per operation in the traced stretch against both key runs read
once."""

from benchmark import bytes as model

KERNELS = ("tile_ranges_kernel<int>", "ranged_count_kernel<int>")


def read(ctx):
    seconds = ctx.kernel_seconds_per_op(KERNELS)
    if not seconds:
        return None
    return model.roofline_pct(model.k1_bytes(ctx.n_build, ctx.n_probe), seconds)
