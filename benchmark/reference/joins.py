"""Plain PyTorch references of the count join and of the JOIN → GROUP BY →
ORDER BY count LIMIT k statement, and their controls.

Semantics (the upstream suite's and the engine's):

- count join: the number of probe rows whose key is among the build keys
  (a probe row counts once, however many build rows share its key);
- the statement ``SELECT key, COUNT(*), SUM(b.payload), MIN(b.payload),
  MAX(b.payload) FROM b JOIN a USING (key) GROUP BY key ORDER BY count DESC
  LIMIT k``: an inner join, so a group's COUNT and SUM are its probe rows'
  times the build rows sharing the key; COUNT is an int32 column that
  wraps modulo 2^32, SUM, MIN and MAX keep the payloads' dtype (an int32
  SUM wraps modulo 2^32, an int64 one modulo 2^64); ties in COUNT go to
  the lower key.

The probe side is read in blocks, so the reference's memory stays a few GB
over the relations.
"""

from __future__ import annotations

import torch

#: Probe rows per block.
BLOCK = 1 << 25
#: The sampled count's rate is 2^-SAMPLE_SHIFT.
SAMPLE_SHIFT = 4


def _blocks(n: int):
    for start in range(0, n, BLOCK):
        yield start, min(start + BLOCK, n)


def _lookup(unique_keys: torch.Tensor, keys: torch.Tensor):
    """(found, index into ``unique_keys``) of each key."""
    idx = torch.searchsorted(unique_keys, keys)
    idx.clamp_(max=max(unique_keys.numel() - 1, 0))
    if unique_keys.numel() == 0:
        return torch.zeros_like(keys, dtype=torch.bool), idx
    return unique_keys[idx] == keys, idx


def semi_join_count(build_keys: torch.Tensor, probe_keys: torch.Tensor) -> int:
    """Probe rows whose key is among the build keys."""
    unique_keys = torch.unique(build_keys)
    total = 0
    for lo, hi in _blocks(probe_keys.numel()):
        found, _ = _lookup(unique_keys, probe_keys[lo:hi])
        total += int(found.sum())
    return total


def control_sampled_count(build_keys: torch.Tensor, probe_keys: torch.Tensor,
                          seed: int) -> int:
    """The count estimated from a Bernoulli sample of the probe rows at
    rate 2^-SAMPLE_SHIFT, scaled up: an approximate answer where the
    configuration states an exact one."""
    gen = torch.Generator(device=probe_keys.device)
    gen.manual_seed(seed)
    unique_keys = torch.unique(build_keys)
    total = 0
    for lo, hi in _blocks(probe_keys.numel()):
        block = probe_keys[lo:hi]
        pick = torch.rand(block.shape, generator=gen,
                          device=block.device) < 2.0 ** -SAMPLE_SHIFT
        found, _ = _lookup(unique_keys, block[pick])
        total += int(found.sum())
    return total << SAMPLE_SHIFT


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values as int32 columns hold them: modulo 2^32, signed."""
    return (torch.remainder(x + (1 << 31), 1 << 32) - (1 << 31)).to(torch.int32)


def _wrap(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 values as a ``dtype`` column holds them (int64 arithmetic
    already wraps modulo 2^64)."""
    return _wrap_i32(x) if dtype == torch.int32 else x.to(dtype)


def join_groupby_top(build_keys: torch.Tensor, probe_keys: torch.Tensor,
                     probe_payloads: torch.Tensor, k: int,
                     sum_dtype: torch.dtype = torch.int64) -> dict:
    """The statement's k rows as numpy columns ``key, count, sum, min, max``.

    ``sum_dtype=torch.float32`` is the control: SUM accumulated in float32.
    """
    unique_keys, mult = torch.unique(build_keys, return_counts=True)
    u = unique_keys.numel()
    dev = probe_keys.device
    rows = torch.zeros(u, dtype=torch.int64, device=dev)
    sums = torch.zeros(u, dtype=sum_dtype, device=dev)
    pdt = probe_payloads.dtype
    mins = torch.full((u,), torch.iinfo(pdt).max, dtype=pdt, device=dev)
    maxs = torch.full((u,), torch.iinfo(pdt).min, dtype=pdt, device=dev)
    for lo, hi in _blocks(probe_keys.numel()):
        found, idx = _lookup(unique_keys, probe_keys[lo:hi])
        gid = idx[found]
        pay = probe_payloads[lo:hi][found]
        rows += torch.bincount(gid, minlength=u)
        sums.index_add_(0, gid, pay.to(sum_dtype))
        mins.scatter_reduce_(0, gid, pay, "amin")
        maxs.scatter_reduce_(0, gid, pay, "amax")
    if sum_dtype.is_floating_point:
        sums = sums.double().round().to(torch.int64)
    live = torch.nonzero(rows).squeeze(1)
    count = _wrap_i32(rows[live] * mult[live])
    # a stable sort on the keys' ascending order: ties go to the lower key
    top = live[torch.sort(-count.to(torch.int64), stable=True).indices[:k]]
    return {
        "key": unique_keys[top].cpu().numpy(),
        "count": _wrap_i32(rows[top] * mult[top]).cpu().numpy(),
        "sum": _wrap(sums[top] * mult[top], pdt).cpu().numpy(),
        "min": mins[top].cpu().numpy(),
        "max": maxs[top].cpu().numpy(),
    }
