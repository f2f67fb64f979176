"""K7 on int64 keys (``hash64_vec_kernel``, and ``hash64_kernel`` for an odd
or unaligned tail): its device time per operation in the traced stretch
against every build and probe key hashed once, each 8 bytes read and a
4-byte hash written."""

from benchmark import bytes as model

KERNELS = ("hash64_vec_kernel", "hash64_kernel")
#: Bytes of one key's hash: the int64 key read, the uint32 hash written.
BYTES_PER_KEY = 8 + 4


def k7_i64_bytes(n_a: int, n_b: int) -> int:
    """Both key columns hashed once."""
    return BYTES_PER_KEY * (n_a + n_b)


def read(ctx):
    seconds = ctx.kernel_seconds_per_op(KERNELS)
    if not seconds:
        return None
    return model.roofline_pct(k7_i64_bytes(ctx.n_build, ctx.n_probe), seconds)
