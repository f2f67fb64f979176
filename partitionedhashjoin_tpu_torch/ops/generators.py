"""Relation generators on the device.

Counterpart of ``partitionedhashjoin_tpu/ops/generators.py`` and of the
reference's src/DataGenerator/:

- ``sequential_keys`` / ``sequential_table``: ids ``start, start+1, ...``
  with ``payload = row index`` (src/DataGenerator/Sequential.cpp:20-25).
- ``zipf_keys`` / ``zipf_table``: Zipf(alpha) ids over a closed range via the
  reference's inverse-CDF-proposal rejection sampler
  (src/DataGenerator/Zipf.cpp:14-56), as one oversampled round of candidates
  whose accepted draws are kept in draw order, plus a refill loop.
- ``zipf_keys_alias`` / ``zipf_table(method="alias")``: exact Zipf(alpha)
  ids from Vose alias tables built on the host (``data/host_loader.py``,
  ``native/phj_host.cpp``): one integer bin and one float32 uniform per draw.
- ``uniform_keys`` / ``uniform_table``: Zipf(0), the uniform distribution.

Every random draw comes from an explicit ``torch.Generator`` (Philox on CUDA,
Mersenne Twister on the CPU), seeded from ``seed``.  The streams differ from
JAX's threefry, so the two packages agree in distribution, not in samples.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from partitionedhashjoin_tpu_torch.data.table import Table, make_table

_ERROR_DIFFERENTIAL = 0.01


def _zipf_params(alpha: float, cardinality: int) -> Tuple[float, float, float]:
    """Clamped (alpha, skew_differential, normalization) — Zipf.cpp:16-29."""
    if alpha < 0.01:
        raise ValueError("Skew parameter must be greater than 0.01.")
    skew_differential = 1.001 - alpha
    diff = 1.0 - alpha
    if abs(diff) < _ERROR_DIFFERENTIAL:
        skew_differential = _ERROR_DIFFERENTIAL * (1.0 if diff < 0 else -1.0)
        alpha = 1.0 - skew_differential
    normalization = (
        math.pow(cardinality, skew_differential) - alpha
    ) / skew_differential
    return alpha, skew_differential, normalization


def zipf_candidates(
    u1: torch.Tensor,
    u2: torch.Tensor,
    alpha: float,
    cardinality: int,
    u3: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One accept/reject round given float32 uniforms in [0, 1).

    Returns (samples int32 in [1, cardinality], accepted bool).  For
    cardinality > 2^24, ``u3`` dithers each sample uniformly within its
    float32 quantum so that large keys stay reachable (see the JAX
    counterpart for the error bound).  float32 ``pow`` rounds differently
    here than in XLA, so a sample next to a ``floor`` boundary may differ
    from the JAX function's by one or two.
    """
    alpha_c, sd, norm = _zipf_params(alpha, cardinality)
    dtype, device = u1.dtype, u1.device
    alpha_v = torch.tensor(alpha_c, dtype=dtype, device=device)
    sd_v = torch.tensor(sd, dtype=dtype, device=device)
    norm_v = torch.tensor(norm, dtype=dtype, device=device)

    # each temporary is ~1 GB at the main path's 270M candidates; the `del`s
    # free them as soon as they are spent, to bound the generator's peak
    un = u1 * norm_v
    # inverse CDF of the proposal (Zipf.cpp:35-43)
    icdf_tail = torch.pow(un * sd_v + alpha_v, 1.0 / sd_v)
    icdf = torch.where(un <= 1.0, un, icdf_tail)
    del icdf_tail
    sample = torch.floor(icdf + 1.0)
    # guard float rounding at the top of the range
    sample = torch.clamp(sample, 1.0, float(cardinality))

    density_original = torch.pow(sample, -alpha_v)
    density_sampling = torch.where(
        sample <= 1.0, 1.0 / norm_v, torch.pow(icdf, -alpha_v) / norm_v
    )
    del icdf
    ratio = density_original / (density_sampling * norm_v)
    del density_original, density_sampling
    accepted = u2 < ratio
    del ratio

    sample_i = sample.to(torch.int32)
    if u3 is not None and cardinality > (1 << 24):
        # float32 spacing at |sample|: 2^(exponent - 23)
        exponent = ((sample.to(torch.float32).view(torch.int32) >> 23) & 0xFF) - 127
        shift = torch.clamp(exponent - 23, min=0)
        spacing = torch.where(
            exponent > 23, torch.bitwise_left_shift(torch.ones_like(shift), shift), 1
        )
        dither = (u3 * spacing.to(torch.float32)).to(torch.int32)
        sample_i = torch.clamp(sample_i + dither, max=cardinality)
    return sample_i, accepted


def _zipf_round(
    generator: torch.Generator, m: int, alpha: float, cardinality: int, device
) -> torch.Tensor:
    """One oversampled rejection round: the accepted samples of m candidates,
    in draw order (a draw-order prefix of an iid stream is itself iid).
    Boolean-mask indexing keeps order, which is what the JAX function's
    2-key sort on (rejected flag, draw position) achieves."""
    u = torch.rand((3, m), generator=generator, dtype=torch.float32, device=device)
    sample, ok = zipf_candidates(u[0], u[1], alpha, cardinality, u3=u[2])
    del u
    return sample[ok]


def zipf_keys(
    n: int,
    alpha: float,
    cardinality: int,
    generator: torch.Generator,
    device,
    oversample: float = 1.35,
) -> torch.Tensor:
    """n Zipf(alpha) samples over the closed range [1, cardinality], int32.

    Draws ``oversample * n`` candidates in one round and keeps the first n
    accepted ones; a refill loop tops up any shortfall exactly (acceptance is
    >= 0.96 at alpha 1.05, so one round is the rule).
    """
    _zipf_params(alpha, cardinality)  # validate alpha (raises early)
    if n == 0:
        return torch.zeros((0,), dtype=torch.int32, device=device)
    parts = []
    remaining = n
    first_m = int(n * oversample) + 4096
    while remaining > 0:
        m = int(remaining * oversample) + 4096
        if remaining < n:
            # refill rounds: same sizes as the JAX function draws
            m = min(first_m, 1 << (m - 1).bit_length())
        vals = _zipf_round(generator, m, alpha, cardinality, device)
        take = min(vals.shape[0], remaining)
        if take > 0:
            parts.append(vals[:take])
            remaining -= take
        del vals
    return parts[0] if len(parts) == 1 else torch.cat(parts)


#: Largest cardinality of the alias sampler, as in the JAX package.
ALIAS_MAX_CARDINALITY = 1 << 24
#: Bits of the integer behind each alias bin: bin = (r * card) >> BITS for r
#: uniform in [0, 2^BITS), so a bin's weight is within card / 2^BITS
#: (< 3.1e-5 of 1/card for card <= 2^24) of exact, and r * card < 2^63.
_BIN_BITS = 39


def zipf_keys_alias(
    n: int,
    prob: torch.Tensor,
    alias: torch.Tensor,
    generator: torch.Generator,
    device,
) -> torch.Tensor:
    """n Zipf samples via Vose alias tables (exact, rejection-free), int32
    over [1, card] with card = ``prob.shape[0]``.

    ``(prob float32, alias int32)`` come from the native library
    (``data/host_loader.py::build_zipf_alias``) and lie on ``device``.  Each
    draw is one integer bin, uniform over [0, card), and a float32 uniform
    u2: emit bin if u2 < prob[bin] else alias[bin] (+1 for the 1-based key
    range).  The bin is drawn as an integer: a float32 uniform has only
    2^23 or 2^24 values, which leaves bins unreachable or unevenly weighted
    (the JAX function's ``floor(u1 * card)``).
    """
    card = prob.shape[0]
    if card > ALIAS_MAX_CARDINALITY:
        raise ValueError(
            "alias sampler requires cardinality <= 2^24; use zipf_keys"
        )
    bins = torch.randint(
        0, 1 << _BIN_BITS, (n,), generator=generator, dtype=torch.int64,
        device=device,
    )
    bins.mul_(card).bitwise_right_shift_(_BIN_BITS)
    u2 = torch.rand((n,), generator=generator, dtype=torch.float32, device=device)
    take_bin = u2 < prob[bins]
    del u2
    out = torch.where(take_bin, bins.to(torch.int32), alias[bins])
    return out.add_(1)


def uniform_keys(
    n: int,
    lo: int,
    hi: int,
    generator: torch.Generator,
    device,
    dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    """n uniform ids over the closed range [lo, hi] — Zipf with alpha = 0."""
    return torch.randint(
        lo, hi + 1, (n,), generator=generator, dtype=dtype, device=device
    )


def _generator(seed: Optional[int], device) -> torch.Generator:
    if seed is None:
        # fresh entropy, like the reference's random_device-seeded factory
        # (src/Common/Random.cpp:32-41)
        seed = int(np.random.SeedSequence().entropy & 0x7FFFFFFF)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def uniform_table(
    n: int,
    key_range: Tuple[int, int],
    seed: Optional[int] = None,
    dtype: torch.dtype = torch.int32,
    *,
    device,
) -> Table:
    """Secondary relation with uniform ids over closed [lo, hi]."""
    lo, hi = key_range
    if lo >= hi:
        raise ValueError(
            f"Range for uniform generation is incorrectly specified: [{lo}, {hi}]."
        )
    ids = uniform_keys(n, lo, hi, _generator(seed, device), device, dtype=dtype)
    return make_table(ids, torch.arange(n, dtype=dtype, device=device))


def sequential_keys(
    n: int, start: int = 1, dtype: torch.dtype = torch.int32, *, device
) -> torch.Tensor:
    """ids start..start+n-1 (Sequential.cpp:20-25)."""
    return torch.arange(start, start + n, dtype=dtype, device=device)


def sequential_table(
    n: int, start: int = 1, dtype: torch.dtype = torch.int32, *, device
) -> Table:
    """Primary relation: sequential unique ids, payload = row index."""
    return make_table(
        sequential_keys(n, start, dtype, device=device),
        torch.arange(n, dtype=dtype, device=device),
    )


def zipf_table(
    n: int,
    alpha: float,
    key_range: Tuple[int, int],
    seed: Optional[int] = None,
    dtype: torch.dtype = torch.int32,
    method: str = "rejection",
    *,
    device,
) -> Table:
    """Secondary relation: Zipf ids over closed [lo, hi], payload = row index.

    Mirrors Zipf::FillTable (Zipf.cpp:58-108): range validation, closed-range
    cardinality, and the ``lo - 1`` correction.

    ``method``: "rejection" (the reference's sampler math, on the device) or
    "alias" (Vose tables built on the host by the native library, moved to
    the device once, then two gathers per draw — exact and rejection-free;
    requires cardinality <= 2^24).
    """
    lo, hi = key_range
    if lo >= hi:
        raise ValueError(
            f"Range for Zipf generation is incorrectly specified: [{lo}, {hi}]."
        )
    if float(alpha) == 0.0:
        # Zipf(0) is the uniform distribution
        return uniform_table(n, key_range, seed=seed, dtype=dtype, device=device)
    cardinality = int(hi - lo + 1)
    gen = _generator(seed, device)
    if method == "alias":
        if cardinality > ALIAS_MAX_CARDINALITY:
            raise ValueError(
                "alias sampling requires cardinality <= 2^24; "
                "use method='rejection'"
            )
        from partitionedhashjoin_tpu_torch.data.host_loader import build_zipf_alias

        # same clamped alpha as the rejection path (Zipf.cpp:22-26), so both
        # methods target the same distribution for any skew
        alpha_c, _, _ = _zipf_params(float(alpha), cardinality)
        prob, alias = build_zipf_alias(alpha_c, cardinality)
        prob = torch.from_numpy(prob).to(device)
        alias = torch.from_numpy(alias).to(device)
        ids = zipf_keys_alias(n, prob, alias, gen, device)
        del prob, alias
    elif method == "rejection":
        ids = zipf_keys(n, float(alpha), cardinality, gen, device)
    else:
        raise ValueError(f"unknown Zipf sampling method: {method!r}")
    ids = (ids + (lo - 1)).to(dtype)
    return make_table(ids, torch.arange(n, dtype=dtype, device=device))
