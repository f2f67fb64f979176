"""``NoPartitioningHashJoiner.run_materialize`` with payloads of every width.

K5 carries int32 lanes, so the port moves an 8- or 16-bit column (bool and
float16 included) widened from its bits and a 64-bit column as its two
32-bit halves, and returns each in its own dtype.  The narrow dtypes are
held to JAX's ``run_materialize`` bit for bit on one shape; JAX runs
without x64 here, so int64 and float64 are held to a numpy oracle: the
matched probe rows in probe order, each with its key's first build row's
payload, zeros after them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partitionedhashjoin_tpu.data.table import make_table as jax_table
from partitionedhashjoin_tpu.ops.no_partitioning import (
    NoPartitioningHashJoiner as JaxNoPartitioning,
)
from partitionedhashjoin_tpu_torch.data.table import table_from_numpy
from partitionedhashjoin_tpu_torch.ops.no_partitioning import NoPartitioningHashJoiner

torch.set_num_threads(1)

N_A, N_B = 300, 1000


def _relations(dtype_a, dtype_b):
    rng = np.random.default_rng(1)
    a = rng.permutation(np.arange(1, 400, dtype=np.int32))[:N_A]
    a[:20] = a[20:40]  # duplicate build keys: the first row's payload wins
    b = rng.integers(0, 500, N_B).astype(np.int32)

    def payloads(dtype, n):
        if dtype == np.bool_:
            return rng.random(n) < 0.5
        if np.issubdtype(dtype, np.floating):
            x = rng.normal(0, 1e3, n).astype(dtype)
            x[:4] = (np.inf, -np.inf, -0.0, np.nan)
            return x
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)

    return (a, payloads(dtype_a, N_A)), (b, payloads(dtype_b, N_B))


def _port(rel_a, rel_b):
    return NoPartitioningHashJoiner(seed=3).run_materialize(
        table_from_numpy(*rel_a, "cpu"), table_from_numpy(*rel_b, "cpu"))


def _same_bits(got: torch.Tensor, want: np.ndarray) -> bool:
    return got.numpy().dtype == want.dtype and got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.bool_, np.float16])
def test_narrow_payloads_match_jax(dtype):
    rel_a, rel_b = _relations(dtype, dtype)
    want = JaxNoPartitioning(seed=3).run_materialize(
        *(jax_table(jnp.asarray(k), jnp.asarray(p)) for k, p in (rel_a, rel_b)))
    got = _port(rel_a, rel_b)
    assert int(got.count) == int(want.count) > 0
    for f in ("keys", "payloads_a", "payloads_b"):
        assert _same_bits(getattr(got, f), np.asarray(getattr(want, f))), f


@pytest.mark.parametrize("dtype_a,dtype_b", [
    (np.int64, np.int64), (np.float64, np.float64), (np.int64, np.uint8),
    (np.float64, np.float16),
])
def test_wide_payloads_match_numpy(dtype_a, dtype_b):
    (a, pa), (b, pb) = _relations(dtype_a, dtype_b)
    got = _port((a, pa), (b, pb))
    hit = np.isin(b, a)
    first = {k: p for k, p in zip(a[::-1], pa[::-1])}
    c = int(hit.sum())
    want_a = np.zeros(N_B, dtype_a)
    want_b = np.zeros(N_B, dtype_b)
    want_a[:c] = [first[k] for k in b[hit]]
    want_b[:c] = pb[hit]
    want_k = np.zeros(N_B, np.int32)
    want_k[:c] = b[hit]
    assert int(got.count) == c > 0
    assert _same_bits(got.keys, want_k)
    assert _same_bits(got.payloads_a, want_a) and _same_bits(got.payloads_b, want_b)
