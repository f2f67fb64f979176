"""Generation kernels: seeded hashing and Zipf sampling, the ports of the TPU
kernels K7 and K8.

Counterparts of ``partitionedhashjoin_tpu/ops/pallas/generate.py``:

- ``hash_keys(keys, seed)`` (K7): ``ops/hashing.hash32`` of int32 keys as
  ``torch.uint32``, bit for bit.  On a CUDA tensor it launches the CUDA
  kernel in ``csrc/generate.cu``; on a CPU tensor it runs ``hashing.hash32``,
  its plain version.
- ``zipf_keys_pallas(seed, n, alpha, cardinality, rounds=16, *, device)``
  (K8): n Zipf(alpha) keys over [1, cardinality] (int32) by up to
  ``rounds`` rounds of the rejection sampler ``generators.zipf_candidates``
  on 23-bit uniforms; the first accepted round wins and a slot never
  accepted gets key 1.  On a CUDA device it launches the CUDA kernel; on the
  CPU it runs ``zipf_keys_plain``.  The TPU kernel draws from the TPU's
  hardware generator, which nothing else reproduces; here the uniforms come
  from Philox4x32-10 keyed by ``seed`` with counter (slot, round), so the
  keys match the JAX function in distribution, not sample for sample.  The
  kernel and ``zipf_keys_plain`` draw the same uniforms bit for bit
  (``philox_uniforms``); a key can still differ where ``powf`` and
  ``torch.pow`` round differently next to a ``floor``.

The JAX names are kept so that a reader finds the counterpart; the port has
no Pallas.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from partitionedhashjoin_tpu_torch.ops import generators, hashing
from partitionedhashjoin_tpu_torch.ops.kernels import _build

_MASK = 0xFFFFFFFF
_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85

#: Kernel calls since the last reset (set to 0 to reset): ``LAUNCHES_HASH``
#: for K7, ``LAUNCHES_ZIPF`` for K8, ``LAUNCHES_UNIFORMS`` for the kernel
#: that exposes K8's uniforms.
LAUNCHES_HASH = 0
LAUNCHES_ZIPF = 0
LAUNCHES_UNIFORMS = 0

_SIGNATURES = {
    "phj_hash_keys": (
        (
            ctypes.c_void_p,  # keys
            ctypes.c_int64,  # n
            ctypes.c_uint32,  # seed
            ctypes.c_void_p,  # out (uint32)
            ctypes.c_void_p,  # cudaStream_t
        ),
        ctypes.c_int,
    ),
    "phj_zipf_keys": (
        (
            ctypes.c_uint64,  # seed
            ctypes.c_int64,  # n
            ctypes.c_int,  # rounds
            *([ctypes.c_float] * 6),  # alpha, sd, inv_sd, norm, inv_norm, card_f
            ctypes.c_int32,  # cardinality
            ctypes.c_int,  # dither
            ctypes.c_void_p,  # out (int32)
            ctypes.c_void_p,  # cudaStream_t
        ),
        ctypes.c_int,
    ),
    "phj_philox_uniforms": (
        (
            ctypes.c_uint64,  # seed
            ctypes.c_int64,  # n
            ctypes.c_uint32,  # round
            ctypes.c_void_p,  # u1
            ctypes.c_void_p,  # u2
            ctypes.c_void_p,  # u3
            ctypes.c_void_p,  # cudaStream_t
        ),
        ctypes.c_int,
    ),
}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    return _build.load("generate", _SIGNATURES)


def _stream(device: torch.device):
    return torch.cuda.current_stream(device).cuda_stream


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


# ---------------------------------------------------------------- K7


def hash_keys(keys: torch.Tensor, seed) -> torch.Tensor:
    """Seeded uint32 hash of int32 keys (= ``hashing.hash32``).  A CUDA
    input launches the CUDA kernel or raises; a CPU input runs
    ``hashing.hash32``."""
    global LAUNCHES_HASH
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise TypeError(
            f"keys must be a 1-D int32 tensor, got {keys.dtype} of shape "
            f"{tuple(keys.shape)}"
        )
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    seed = int(seed) & _MASK
    device = keys.device
    if device.type == "cpu":
        return hashing.hash32(keys, seed)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n = keys.shape[0]
    out = torch.empty((n,), dtype=torch.uint32, device=device)
    if n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.phj_hash_keys(keys.data_ptr(), n, seed, out.data_ptr(),
                                _stream(device))
    _check_launch("phj_hash_keys", err)
    LAUNCHES_HASH += 1
    return out


# ---------------------------------------------------------------- K8


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit product a * m, for a in
    [0, 2^32) as int64 and a 32-bit constant m: the factors are split into
    16-bit halves so that no int64 product overflows."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    ll, lh, hl = a_lo * m_lo, a_lo * m_hi, a_hi * m_lo
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    hi = a_hi * m_hi + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) in int64 arithmetic: counter
    words c0..c3 (tensors or ints in [0, 2^32)) under the key (k0, k1);
    returns the four output words as int64 tensors in [0, 2^32)."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64)
                      for c in (c0, c1, c2, c3))
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W0) & _MASK, (k1 + _PHILOX_W1) & _MASK
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform23(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from the top 23 bits, as the TPU kernel builds it."""
    mantissa = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mantissa.view(torch.float32) - 1.0


def _philox_key(seed: int) -> Tuple[int, int]:
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _MASK, seed >> 32


def philox_uniforms_plain(seed, slots: torch.Tensor, round_: int):
    """The three float32 uniforms of round ``round_`` for each slot
    (int64 tensor): the plain version of the kernel's generator."""
    k0, k1 = _philox_key(seed)
    bits = philox4x32_10(slots & _MASK, slots >> 32, round_, 0, k0, k1)
    return tuple(_uniform23(b) for b in bits[:3])


def philox_uniforms(seed, n: int, round_: int, *, device):
    """The three uniforms of round ``round_`` for slots [0, n), as the Zipf
    kernel draws them.  On a CUDA device this launches the CUDA kernel; on
    the CPU it runs ``philox_uniforms_plain``."""
    global LAUNCHES_UNIFORMS
    device = torch.device(device)
    if device.type == "cpu":
        return philox_uniforms_plain(
            seed, torch.arange(n, dtype=torch.int64), round_)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    u = torch.empty((3, n), dtype=torch.float32, device=device)
    if n:
        lib = load_library()
        with torch.cuda.device(device):
            err = lib.phj_philox_uniforms(
                int(seed) & 0xFFFFFFFFFFFFFFFF, n, round_, u[0].data_ptr(),
                u[1].data_ptr(), u[2].data_ptr(), _stream(device))
        _check_launch("phj_philox_uniforms", err)
        LAUNCHES_UNIFORMS += 1
    return u[0], u[1], u[2]


def _zipf_constants(alpha: float, cardinality: int):
    """The float32 constants ``zipf_candidates`` computes (``alpha``, the
    skew differential, its reciprocal, the normalization and its reciprocal,
    the cardinality), computed the same way."""
    alpha_c, sd, norm = generators._zipf_params(alpha, cardinality)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    sd_v, norm_v = f32(sd), f32(norm)
    return tuple(float(v) for v in (
        f32(alpha_c), sd_v, 1.0 / sd_v, norm_v, 1.0 / norm_v,
        f32(float(cardinality)),
    ))


def zipf_keys_plain(seed, n: int, alpha: float, cardinality: int,
                    rounds: int = 16, *, device) -> torch.Tensor:
    """The plain version of ``zipf_keys_pallas``: the same Philox uniforms
    (``philox_uniforms_plain``) through ``generators.zipf_candidates``,
    round by round over the slots not yet accepted.  Works on any device."""
    generators._zipf_params(alpha, cardinality)  # validate (raises early)
    vals = torch.ones((n,), dtype=torch.int32, device=device)
    todo = torch.arange(n, dtype=torch.int64, device=device)
    for r in range(rounds):
        if todo.numel() == 0:
            break
        u1, u2, u3 = philox_uniforms_plain(seed, todo, r)
        sample, ok = generators.zipf_candidates(u1, u2, alpha, cardinality,
                                                u3=u3)
        vals[todo[ok]] = sample[ok]
        todo = todo[~ok]
    return vals


def zipf_keys_pallas(seed, n: int, alpha: float, cardinality: int,
                     rounds: int = 16, *, device) -> torch.Tensor:
    """n Zipf(alpha) samples over [1, cardinality], int32, by the on-card
    rejection sampler (see the module note).  On a CUDA device this launches
    the CUDA kernel or raises; on the CPU it runs ``zipf_keys_plain``."""
    global LAUNCHES_ZIPF
    device = torch.device(device)
    if device.type == "cpu":
        return zipf_keys_plain(seed, n, alpha, cardinality, rounds,
                               device=device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not 1 <= cardinality < 2**31:
        raise ValueError(f"cardinality must be in [1, 2^31), got {cardinality}")
    consts = _zipf_constants(alpha, cardinality)
    out = torch.empty((n,), dtype=torch.int32, device=device)
    if n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.phj_zipf_keys(
            int(seed) & 0xFFFFFFFFFFFFFFFF, n, rounds, *consts,
            cardinality, int(cardinality > (1 << 24)), out.data_ptr(),
            _stream(device))
    _check_launch("phj_zipf_keys", err)
    LAUNCHES_ZIPF += 1
    return out
