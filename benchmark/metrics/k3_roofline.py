"""K3 (``tile_ranges_kernel`` + ``ranged_count_kernel`` on int64 keys): its
device time per operation in the traced stretch against both int64 key runs
read once."""

from benchmark import bytes as model

KERNELS = ("tile_ranges_kernel<long long>", "ranged_count_kernel<long long>")


def read(ctx):
    seconds = ctx.kernel_seconds_per_op(KERNELS)
    if not seconds:
        return None
    return model.roofline_pct(model.k3_bytes(ctx.n_build, ctx.n_probe), seconds)
