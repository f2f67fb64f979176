"""Vectorized seedable hashing.

Counterpart of ``partitionedhashjoin_tpu/ops/hashing.py`` (the reference's
XXHasher, src/Common/XXHasher.hpp:10-28, as a murmur3-style finalizer): the
same functions, bit for bit.  A port ``VectorHasher(seed=s)`` hashes exactly
as a JAX ``VectorHasher(seed=s)``.

torch on the CPU has no ``>>`` for uint32, and int32 ``>>`` is arithmetic,
so the arithmetic runs in int64 with every intermediate masked to its low
32 bits; results are ``torch.uint32`` (JAX's dtype) and bucket indices
int32.  ``hash32`` is also the plain version of the hash kernel K7
(``ops/kernels/generate.hash_keys``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def _u32(x) -> torch.Tensor:
    """The low 32 bits of an integer tensor, as non-negative int64."""
    return torch.as_tensor(x).to(torch.int64) & _MASK


def _mul_lo32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32): the constant is split into
    16-bit halves so no int64 product overflows."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _MASK


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """fmix32 on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul_lo32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul_lo32(h, _C2)
    return h ^ (h >> 16)


def fmix32(h) -> torch.Tensor:
    """murmur3 32-bit finalizer: full avalanche on uint32 values."""
    return _fmix32(_u32(h)).to(torch.uint32)


def _hash32(keys, seed) -> torch.Tensor:
    h = _u32(keys) ^ (int(seed) & _MASK)
    h = _fmix32(h)
    # second round decorrelates consecutive keys fully even after xor-seed
    return _fmix32((h + _GOLDEN) & _MASK)


def hash32(keys, seed: int = 0) -> torch.Tensor:
    """Seeded uint32 hash of 32-bit keys (int32/uint32 accepted)."""
    return _hash32(keys, seed).to(torch.uint32)


def hash64_pair(lo, hi, seed: int = 0) -> torch.Tensor:
    """Seeded uint32 hash of 64-bit keys given as (lo, hi) uint32 halves:
    both halves go through the finalizer with distinct round constants."""
    h = _fmix32(_u32(lo) ^ (int(seed) & _MASK))
    return _fmix32(h ^ _u32(hi) ^ _GOLDEN).to(torch.uint32)


def bucket(h, cardinality: int) -> torch.Tensor:
    """Reduce a uint32 hash to [0, cardinality) as int32 (XXHasher.hpp:19-22
    semantics): a mask of the low bits for a power of two, else modulo."""
    if cardinality <= 0:
        raise ValueError("bucket: cardinality must be positive")
    h = _u32(h)
    if cardinality & (cardinality - 1) == 0:
        return (h & (cardinality - 1)).to(torch.int32)
    return (h % (cardinality & _MASK)).to(torch.int32)


class VectorHasher:
    """Per-instance randomly seeded hasher (XXHasher.hpp:12-22 semantics).

    ``hash(keys, cardinality)`` maps a key vector to bucket/partition indices
    in [0, cardinality).  Two independently constructed instances are
    decorrelated by their seeds (src/main.cpp:215-217,267).
    """

    def __init__(self, seed: Optional[int] = None) -> None:
        if seed is None:
            seed = int(np.random.SeedSequence().entropy & _MASK)
        self.seed = int(seed) & _MASK

    def hash_bits(self, keys) -> torch.Tensor:
        return hash32(keys, self.seed)

    def hash(self, keys, cardinality: int) -> torch.Tensor:
        return bucket(_hash32(keys, self.seed), cardinality)


def split64(keys64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split int64/uint64 keys into (lo, hi) uint32 halves."""
    k = torch.as_tensor(keys64)
    k = k.view(torch.int64) if k.dtype == torch.uint64 else k.to(torch.int64)
    return (k & _MASK).to(torch.uint32), ((k >> 32) & _MASK).to(torch.uint32)
