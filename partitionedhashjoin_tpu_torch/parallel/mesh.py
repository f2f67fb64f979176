"""A mesh of shards, the layouts that place tensors on it, and its collectives.

Counterpart of ``partitionedhashjoin_tpu/parallel/mesh.py``.  The JAX module
builds a ``jax.sharding.Mesh`` over chips and lets ``shard_map`` programs and
ICI collectives take the place of the reference's worker threads
(src/Common/ThreadPool.cpp:9-34).  Here a ``Mesh`` is S shards that all live
on ONE torch device, "cuda" unless the caller names "cpu"; several shards may
share it, where the JAX mesh needs one device per shard.

Layouts keep JAX's global view of an array:

- **row sharding** (``row_sharding``): a column stays one tensor of n rows
  whose ``(S, n // S)`` view holds each shard's rows, shard ``s`` the rows
  ``[s * n // S, (s + 1) * n // S)``: the layout of JAX's
  ``NamedSharding(mesh, P("shards"))``;
- **replication** (``replicated``): one tensor that every shard reads.

The collectives are plain functions on tensors whose leading axis is the
shard:

- ``all_to_all(x)``: ``x[src, dst, ...]`` is what shard ``src`` sends to
  shard ``dst``; the result's ``[dst, src, ...]`` is what ``dst`` receives.
  It is the materialised transpose, a copy, so the exchange's bytes move;
- ``all_gather(x)``: every shard's ``x[s]``, concatenated in shard order;
- ``psum(x)``: the sum over shards.

Placing shards on several devices (and the process groups that joins them)
is not built: a ``devices`` list naming two distinct devices raises
``NotImplementedError`` (ROADMAP Queue 1 item 6c).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from partitionedhashjoin_tpu_torch.data.table import Table
from partitionedhashjoin_tpu_torch.utils.device import resolve_device

SHARD_AXIS = "shards"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ``size`` shards over ``device`` (one axis,
    ``SHARD_AXIS``, the analogue of the reference's worker count)."""

    device: torch.device
    size: int


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A layout on a mesh: rows split across the shards (``spec`` ==
    ``(SHARD_AXIS,)``) or replicated (``spec`` == ``()``)."""

    mesh: Mesh
    spec: Tuple[str, ...]

    def place(self, array) -> torch.Tensor:
        """``array`` as a tensor on the mesh's device in this layout; a
        row-split array's length must divide by the shard count."""
        t = torch.as_tensor(array).to(self.mesh.device)
        if self.spec and t.shape[0] % self.mesh.size:
            raise ValueError(
                f"array length {t.shape[0]} not divisible by "
                f"{self.mesh.size} shards; pad first (pad_to_multiple)"
            )
        return t


def _indexed(device: torch.device) -> torch.device:
    """"cuda" as the current card's "cuda:N", so that tensors placed on the
    mesh report the mesh's own device."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D mesh of ``num_devices`` shards (default: one per entry of
    ``devices``) over the one device that ``devices`` names ("cuda" when
    None).  Shards may share the device, so any positive count is allowed;
    two distinct devices raise ``NotImplementedError``."""
    names: Sequence = ["cuda"] if devices is None else list(devices)
    if not names:
        raise ValueError("make_mesh needs at least one device")
    distinct = {_indexed(resolve_device(str(d))) for d in names}
    if len(distinct) > 1:
        raise NotImplementedError(
            f"a mesh over {len(distinct)} devices is not yet ported (ROADMAP "
            "Queue 1 item 6c); every shard lives on one device"
        )
    size = len(names) if num_devices is None else int(num_devices)
    if size < 1:
        raise ValueError(f"a mesh needs at least one shard, got {size}")
    return Mesh(device=distinct.pop(), size=size)


def row_sharding(mesh: Mesh) -> Sharding:
    """Rows split across the shard axis."""
    return Sharding(mesh, (SHARD_AXIS,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def pad_to_multiple(
    array: torch.Tensor, multiple: int, fill
) -> Tuple[torch.Tensor, int]:
    """Pad a 1-D tensor up to a length multiple; returns (padded, n_valid)."""
    n = array.shape[0]
    padded = (n + multiple - 1) // multiple * multiple
    if padded == n:
        return array, n
    tail = torch.full((padded - n,), fill, dtype=array.dtype, device=array.device)
    return torch.cat([array, tail]), n


def shard_array(array, mesh: Mesh) -> torch.Tensor:
    """Place a 1-D per-row array (e.g. a validity mask) row-sharded on the
    mesh, matching ``shard_table``'s layout so it can ride the exchange."""
    return row_sharding(mesh).place(array)


def shard_table(table: Table, mesh: Mesh) -> Table:
    """Place a table's columns row-sharded on the mesh.

    Row count must divide evenly by the shard count (pad first with
    ``pad_to_multiple`` + a validity convention if it does not).
    """
    sharding = row_sharding(mesh)
    return Table(
        keys=sharding.place(table.keys),
        payloads=sharding.place(table.payloads),
        uuid=table.uuid,
    )


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """``x[src, dst, ...]`` sent, ``[dst, src, ...]`` received: the
    transpose of the two shard axes, materialised."""
    if x.dim() < 2 or x.shape[0] != x.shape[1]:
        raise ValueError(
            f"all_to_all takes an (S, S, ...) send buffer, got {tuple(x.shape)}"
        )
    return x.transpose(0, 1).contiguous()


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every shard's ``x[s]``, concatenated in shard order (replicated)."""
    return x.reshape(-1)


def psum(x: torch.Tensor) -> torch.Tensor:
    """The sum of the per-shard values ``x[s]`` over the shards."""
    return x.sum(dim=0)
