"""Random number generation on the host.

Copy of ``partitionedhashjoin_tpu/utils/rng.py`` (importing that module
would import jax).

- ``MultiplicativeLCG``: the reference's Lehmer/Park-Miller multiplicative LCG
  (a=16807, m=2^31-1, Schrage's method; src/Common/Random.hpp:26-36,
  src/Common/Random.cpp:9-30, credited to genzipf.c).  Host-side numpy
  implementation with vectorized leapfrog skip-ahead — used by the host data
  oracle and by parity tests that replicate the reference's exact sample
  streams.
- The device-side generators (ops/generators.py) draw from an explicit
  ``torch.Generator`` (Philox on CUDA) instead: a per-worker stateful LCG
  does not map to thousands of device threads, while counter-based streams
  are reproducible under any launch geometry (equivalent by distribution;
  match counts depend only on key multisets).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_A = 16807
_M = 2147483647  # 2^31 - 1


class MultiplicativeLCG:
    """Park-Miller minimal standard generator, doubles in (0, 1).

    Bit-compatible with the reference stream for the same seed
    (src/Common/Random.cpp:9-30).
    """

    def __init__(self, seed: int) -> None:
        seed = int(seed) % _M
        if seed == 0:
            seed = 1  # zero is a fixed point of the multiplicative LCG
        self._state = seed

    def next(self) -> float:
        self._state = (_A * self._state) % _M
        return self._state / _M

    def next_batch(self, n: int) -> np.ndarray:
        """Vectorized batch: states s * a^k mod m for k = 1..n.

        uint64 modmul is exact here (a * state < 16807 * 2^31 < 2^46), so the
        recurrence vectorizes as a doubling scan: each round advances the
        second half of the computed prefix by a^len(prefix) — log2(n) numpy
        passes instead of n Python-level steps.  Returns float64 in (0, 1).
        """
        states = np.empty(n + 1, dtype=np.uint64)
        states[0] = self._state
        filled = 1
        while filled < n + 1:
            take = min(filled, n + 1 - filled)
            step = np.uint64(pow(_A, filled, _M))  # a^filled mod m
            states[filled : filled + take] = (states[:take] * step) % _M
            filled += take
        self._state = int(states[n])
        return states[1:].astype(np.float64) / _M

    @property
    def state(self) -> int:
        return self._state


class MultiplicativeLCGFactory:
    """Factory with fresh-entropy or explicit seeding (Random.cpp:32-41)."""

    def get_new_generator(self, seed: Optional[int] = None) -> MultiplicativeLCG:
        if seed is None:
            seed = int(np.random.SeedSequence().entropy % _M)
        return MultiplicativeLCG(seed)


def lcg_skip(seed: int, n: int) -> int:
    """State after n steps: a^n * seed mod m (for leapfrogged parallel streams)."""
    return (pow(_A, n, _M) * (seed % _M)) % _M
