"""The benchmark's one relation generator: a configuration file's relations,
made on the device from the run's seed.

A configuration names two relations, ``build`` and ``probe``, each with a
row count, a ``dtype`` for both its columns (``int32`` or ``int64``; the
source's tuple width) and a rule for its keys and for its payloads:

- keys ``sequential``: ``start, start + 1, ...``;
- keys ``zipf``: an exact Zipf(``alpha``) law over [``lo``, ``hi``], drawn
  by inverting its CDF in float64 (every key of the domain can be drawn);
- keys ``permutation``: a uniformly random permutation of [``lo``, ``hi``]
  (``rows`` must equal the domain's size);
- payloads ``xor_key``: ``key ^ salt``;
- payloads ``uniform``: uniform in [``lo``, ``hi``).

Every column of every variant draws from its own ``torch.Generator``, seeded
from (seed, variant, relation, column) through ``numpy.random.SeedSequence``,
so the same seed gives the same relations and any whole number is a seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: Rows drawn per call of the Zipf sampler: bounds its float64 temporaries
#: to a few hundred MB.
ZIPF_CHUNK = 1 << 24
DTYPES = {"int32": torch.int32, "int64": torch.int64}

_RELATIONS = ("build", "probe")


@dataclasses.dataclass
class Relation:
    """Two aligned integer columns of one dtype on one device."""

    keys: torch.Tensor
    payloads: torch.Tensor

    @property
    def rows(self) -> int:
        return self.keys.shape[0]


def stream_seed(seed: int, *path: int) -> int:
    """A 63-bit generator seed for one column of one variant."""
    state = np.random.SeedSequence([int(seed) % (1 << 128), *path])
    return int(state.generate_state(1, np.uint64)[0]) >> 1


def _generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def zipf_keys(rows: int, alpha: float, lo: int, hi: int, gen, device,
              dtype=torch.int32):
    """``rows`` keys from P(k) ∝ (k − lo + 1)^−alpha on [lo, hi]."""
    ranks = torch.arange(1, hi - lo + 2, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks.pow_(-alpha), 0)
    cdf /= cdf[-1].clone()
    del ranks
    out = torch.empty(rows, dtype=dtype, device=device)
    for start in range(0, rows, ZIPF_CHUNK):
        n = min(ZIPF_CHUNK, rows - start)
        u = torch.rand(n, dtype=torch.float64, generator=gen, device=device)
        idx = torch.searchsorted(cdf, u, right=True).clamp_(max=hi - lo)
        out[start:start + n] = (idx + lo).to(dtype)
    return out


def make_keys(spec: dict, rows: int, gen, device, dtype) -> torch.Tensor:
    dist = spec["dist"]
    if dist == "sequential":
        start = int(spec.get("start", 1))
        return torch.arange(start, start + rows, dtype=dtype, device=device)
    if dist == "zipf":
        return zipf_keys(rows, float(spec["alpha"]), int(spec["lo"]),
                         int(spec["hi"]), gen, device, dtype)
    if dist == "permutation":
        lo, hi = int(spec["lo"]), int(spec["hi"])
        if hi - lo + 1 != rows:
            raise ValueError(f"a permutation of [{lo}, {hi}] has "
                             f"{hi - lo + 1} rows, not {rows}")
        perm = torch.randperm(rows, generator=gen, device=device,
                              dtype=torch.int64)
        return (perm + lo).to(dtype)
    raise ValueError(f"unknown key distribution {dist!r}")


def make_payloads(spec: dict, keys: torch.Tensor, gen, device) -> torch.Tensor:
    dist = spec["dist"]
    if dist == "xor_key":
        return keys ^ int(spec["salt"])
    if dist == "uniform":
        return torch.randint(int(spec["lo"]), int(spec["hi"]), keys.shape,
                             generator=gen, dtype=keys.dtype, device=device)
    raise ValueError(f"unknown payload distribution {dist!r}")


def make_relation(spec: dict, seed: int, variant: int, which: int,
                  device) -> Relation:
    rows = int(spec["rows"])
    gk = _generator(device, stream_seed(seed, variant, which, 0))
    keys = make_keys(spec["keys"], rows, gk, device, DTYPES[spec["dtype"]])
    gp = _generator(device, stream_seed(seed, variant, which, 1))
    return Relation(keys, make_payloads(spec["payloads"], keys, gp, device))


def make_pair(config: dict, seed: int, variant: int, device):
    """``(build, probe)`` of one variant of a configuration."""
    return tuple(make_relation(config[name], seed, variant, i, device)
                 for i, name in enumerate(_RELATIONS))
