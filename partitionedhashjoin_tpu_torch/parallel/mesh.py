"""A mesh of shards, the layouts that place tensors on it, and its collectives.

Counterpart of ``partitionedhashjoin_tpu/parallel/mesh.py``.  The JAX module
builds a ``jax.sharding.Mesh`` over chips and lets ``shard_map`` programs and
ICI collectives take the place of the reference's worker threads
(src/Common/ThreadPool.cpp:9-34).  Here a ``Mesh`` is S shards over the
processes of a ``torch.distributed`` group (``parallel/distributed.py``),
each process on ONE torch device, "cuda" unless the caller names "cpu".  A
process holds ``local_size = S / P`` shards, and several shards share its
device, where the JAX mesh needs one device per shard.  ``make_mesh`` builds
the one-process mesh (P = 1, every shard on one device); a mesh over P > 1
processes comes from ``distributed.global_mesh``.

Layouts keep JAX's global view of an array, process-major
(``distributed.host_slice``):

- **row sharding** (``row_sharding``): a process holds its own rows only,
  one tensor of n_local rows whose ``(local_size, n_local // local_size)``
  view holds its shards' rows; local shard ``i`` is global shard
  ``process_index * local_size + i``, and the rows of global shard ``s``
  are the global rows ``[s * n // S, (s + 1) * n // S)``: the layout of
  JAX's ``NamedSharding(mesh, P("shards"))``;
- **replication** (``replicated``): one tensor that every shard reads, a
  copy on every process.

The collectives are plain functions on tensors whose leading axis is the
local shard, and take the mesh:

- ``all_to_all(x, mesh)``: ``x[src_local, dst, ...]`` is what shard ``src``
  sends to global shard ``dst``; the result's ``[dst_local, src, ...]`` is
  what ``dst`` receives from global shard ``src``.  Between the shards of
  one process it is the materialised transpose, a copy; the blocks bound
  for other processes go through one ``all_to_all_single``;
- ``all_gather(x, mesh)``: every shard's ``x[s]``, concatenated in global
  shard order (``all_gather_into_tensor`` across processes);
- ``psum(x, mesh)`` / ``pmax(x, mesh)``: the sum (the max) over the
  leading axis, then over the processes (``all_reduce``);
- ``check_local_rows(rows, mesh)``: every process's local row counts,
  gathered and checked equal, so that a refusal raises in every process;
- ``local_rows(mesh, cols, mask)``: the row layout of the distributed
  operators: this process's rows checked, padded to its shards, with their
  validity and the global row count;
- ``gather_prefixes(mesh, nums, cap, *cols)``: every shard's valid prefix
  packed into one, in global shard order, in every process.

Across processes the collectives hand the group the card's tensors as they
are, under NCCL and gloo alike.  Gloo (processes that share one card: NCCL
refuses two ranks on one device) copies them to host memory itself, moves
them over loopback TCP and copies them back; that is neither NVLink nor
NCCL.  ``mesh.comm`` counts what crosses: the bytes this process sends to
other processes, per collective, and the time of its cross-process calls,
read from CUDA events only when asked for, so no collective waits for the
device.  A ``devices`` list naming two distinct devices in one process
raises ``NotImplementedError``: one process owns one device, as under
torchrun, and more cards mean more processes (``distributed.initialize``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from partitionedhashjoin_tpu_torch.data.table import Table
from partitionedhashjoin_tpu_torch.ops.kernels import compact as kcompact
from partitionedhashjoin_tpu_torch.utils.device import resolve_device

SHARD_AXIS = "shards"


@dataclasses.dataclass
class CommStats:
    """What a mesh's cross-process collectives cost this process since the
    last ``reset``: the bytes it sent to other processes, by collective
    (``sent``), the calls, and their time (``seconds``).  On a card each
    call is spanned by two CUDA events on the current stream, read only when
    ``seconds`` is asked for; on the CPU, where the collectives return when
    they are done, by the host clock."""

    sent: Dict[str, int] = dataclasses.field(default_factory=dict)
    calls: int = 0
    host_seconds: float = 0.0
    events: List[tuple] = dataclasses.field(default_factory=list)

    def reset(self) -> None:
        self.sent, self.calls, self.host_seconds, self.events = {}, 0, 0.0, []

    @property
    def bytes_sent(self) -> int:
        return sum(self.sent.values())

    @property
    def seconds(self) -> float:
        """The calls' time: waits for the last call's end event."""
        if self.events:
            self.events[-1][1].synchronize()
        return self.host_seconds + sum(
            start.elapsed_time(end) for start, end in self.events) / 1e3


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ``size`` shards (one axis, ``SHARD_AXIS``, the analogue
    of the reference's worker count) over ``process_count`` processes, of
    which this one, ``process_index``, holds ``local_size`` shards on
    ``device``.  ``group`` is the ``torch.distributed`` group that joins the
    processes and ``backend`` its backend ("gloo" or "nccl"), both None for
    one process; ``comm`` counts the cross-process traffic."""

    device: torch.device
    size: int
    local_size: Optional[int] = None
    process_index: int = 0
    process_count: int = 1
    group: object = dataclasses.field(default=None, compare=False, repr=False)
    backend: Optional[str] = None
    comm: CommStats = dataclasses.field(default_factory=CommStats, compare=False,
                                        repr=False)

    def __post_init__(self) -> None:
        if self.local_size is None:
            object.__setattr__(self, "local_size", self.size // self.process_count)
        if self.local_size * self.process_count != self.size:
            raise ValueError(
                f"{self.size} shards do not split evenly over "
                f"{self.process_count} processes"
            )


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A layout on a mesh: rows split across the shards (``spec`` ==
    ``(SHARD_AXIS,)``) or replicated (``spec`` == ``()``)."""

    mesh: Mesh
    spec: Tuple[str, ...]

    def place(self, array) -> torch.Tensor:
        """``array`` as a tensor on the mesh's device in this layout; a
        row-split array holds this process's rows, and its length must
        divide by the process's shard count."""
        t = torch.as_tensor(array).to(self.mesh.device)
        if self.spec and t.shape[0] % self.mesh.local_size:
            raise ValueError(
                f"array length {t.shape[0]} not divisible by "
                f"{self.mesh.local_size} shards; pad first (pad_to_multiple)"
            )
        return t


def _indexed(device: torch.device) -> torch.device:
    """"cuda" as the current card's "cuda:N", so that tensors placed on the
    mesh report the mesh's own device."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    """A one-process mesh of ``num_devices`` shards (default: one per entry
    of ``devices``) over the one device that ``devices`` names ("cuda" when
    None).  Shards may share the device, so any positive count is allowed;
    two distinct devices raise ``NotImplementedError``: a process owns one
    device, and a mesh over several comes from ``distributed.initialize``
    and ``distributed.global_mesh``, one process per device."""
    names: Sequence = ["cuda"] if devices is None else list(devices)
    if not names:
        raise ValueError("make_mesh needs at least one device")
    distinct = {_indexed(resolve_device(str(d))) for d in names}
    if len(distinct) > 1:
        raise NotImplementedError(
            f"a one-process mesh over {len(distinct)} devices: a process owns "
            "one device; start one process per device and join them with "
            "distributed.initialize and distributed.global_mesh"
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


def _collective(mesh: Mesh, name: str, out: torch.Tensor, call,
                sent: torch.Tensor, sent_bytes: int) -> torch.Tensor:
    """Run ``call(out, sent)`` (bool tensors as uint8) and return ``out``;
    counts ``sent_bytes`` under ``name`` and the call's span in
    ``mesh.comm``."""
    wire_out, wire_in = out, sent
    if out.dtype == torch.bool:
        wire_out, wire_in = out.view(torch.uint8), sent.view(torch.uint8)
    comm = mesh.comm
    if mesh.device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        call(wire_out, wire_in)
        end.record()
        comm.events.append((start, end))
    else:
        t0 = time.perf_counter()
        call(wire_out, wire_in)
        comm.host_seconds += time.perf_counter() - t0
    comm.sent[name] = comm.sent.get(name, 0) + sent_bytes
    comm.calls += 1
    return out


def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x[src_local, dst, ...]`` sent, ``[dst_local, src, ...]`` received:
    within a process the transpose of the two shard axes, materialised;
    across processes one ``all_to_all_single`` of the blocks bound for other
    processes (this process's own block is never sent)."""
    lsz, size = mesh.local_size, mesh.size
    if x.dim() < 2 or x.shape[0] != lsz or x.shape[1] != size:
        raise ValueError(
            f"all_to_all takes an ({lsz}, {size}, ...) send buffer, got "
            f"{tuple(x.shape)}"
        )
    if mesh.process_count == 1:
        return x.transpose(0, 1).contiguous()
    import torch.distributed as dist

    nproc, me = mesh.process_count, mesh.process_index
    rest = tuple(x.shape[2:])
    # blocks[q, dst_local, src_local]: what this process sends to process q
    blocks = x.reshape(lsz, nproc, lsz, *rest).transpose(0, 1).transpose(1, 2)
    others = torch.tensor([q for q in range(nproc) if q != me], device=x.device)
    send = blocks.index_select(0, others).contiguous()
    splits = [0 if q == me else 1 for q in range(nproc)]  # blocks, along dim 0
    recv = _collective(mesh, "all_to_all", torch.empty_like(send),
                       lambda o, i: dist.all_to_all_single(o, i, splits, splits,
                                                           group=mesh.group),
                       send, send.numel() * send.element_size())
    # received[p, dst_local, src_local] from process p, own block in place
    received = torch.empty((nproc, lsz, lsz, *rest), dtype=x.dtype, device=x.device)
    received[others] = recv
    received[me] = blocks[me]
    return received.transpose(0, 1).reshape(lsz, size, *rest)


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every shard's ``x[s]``, concatenated in global shard order
    (replicated on every process)."""
    flat = x.reshape(-1)
    if mesh.process_count == 1:
        return flat
    import torch.distributed as dist

    out = flat.new_empty((mesh.process_count * flat.numel(),))
    return _collective(
        mesh, "all_gather", out,
        lambda o, i: dist.all_gather_into_tensor(o, i, group=mesh.group), flat,
        flat.numel() * flat.element_size() * (mesh.process_count - 1))


def _all_reduce(x: torch.Tensor, mesh: Mesh, name: str, op) -> torch.Tensor:
    import torch.distributed as dist

    def reduce(out, inp):
        out.copy_(inp)
        dist.all_reduce(out, op=op, group=mesh.group)

    return _collective(mesh, name, torch.empty_like(x), reduce, x,
                       x.numel() * x.element_size())


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of the values ``x[i]`` over the leading axis (this process's
    shards), then over the processes."""
    local = x.sum(dim=0)
    if mesh.process_count == 1:
        return local
    import torch.distributed as dist

    return _all_reduce(local, mesh, "psum", dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The max of the values ``x[i]`` over the leading axis (this process's
    shards), then over the processes: ``jax.lax.pmax``."""
    local = x.amax(dim=0)
    if mesh.process_count == 1:
        return local
    import torch.distributed as dist

    return _all_reduce(local, mesh, "pmax", dist.ReduceOp.MAX)


def check_local_rows(rows: Sequence[int], mesh: Mesh, what: str = "relation",
                     problem: Optional[str] = None) -> None:
    """Raise ``ValueError`` in every process unless each count in ``rows``
    (this process's rows of each input) divides by the process's shard
    count and equals the other processes' (gathered, so that the check
    raises alike in every process, where a check on the local counts alone
    would raise in one while the others wait in a collective): the row layout
    of ``host_slice``, in which global shard ``s`` holds the rows ``[s * n
    // S, (s + 1) * n // S)``.  ``problem``, a local refusal found by the
    caller (a mask of the wrong shape), raises here too, in its own process
    with its words and in every other."""
    every = [[*rows, problem is not None]]
    if mesh.process_count > 1:  # one small all_gather of every process's counts
        x = torch.tensor(every[0], dtype=torch.int64, device=mesh.device)
        every = all_gather(x[None], mesh).view(mesh.process_count, -1).tolist()
    if problem is not None:
        raise ValueError(problem)
    refused = [q for q, r in enumerate(every) if r[-1]]
    if refused:
        raise ValueError(f"process {refused[0]} refused its {what} inputs")
    every = [r[:-1] for r in every]
    if any(r != every[0] for r in every):
        raise ValueError(
            f"the processes hold unequal {what} row counts {every}: each must "
            "pass its host_slice of the global rows, the same count in every "
            "process"
        )
    if any(n % mesh.local_size for n in every[0]):
        raise ValueError(
            f"{what} sizes must divide the shard count (this process's rows "
            f"{every[0]} over its {mesh.local_size} shards)"
        )


def local_rows(mesh: Mesh, cols: Sequence[torch.Tensor], mask=None,
               what: str = "relation"):
    """The row layout that the distributed operators share.  ``cols`` are
    this process's rows of one relation (``host_slice``'s layout; on one
    process the whole relation) and ``mask`` their validity, one flag per
    row.  The mask's shape is checked, and across processes the row counts
    (``check_local_rows``), so that a refusal raises in every process.  The
    columns are placed on the mesh's device and padded with zeros to a
    multiple of ``local_size``: on one process that pads to S, across
    processes the checked counts divide already.  Returns ``(n, valid,
    cols)``: the global row count (this process's times the process count),
    the padded rows' validity (False on padding and masked-out rows) and
    the padded columns."""
    device = mesh.device
    n_local = cols[0].shape[0]
    m = problem = None
    if mask is not None:
        m = torch.as_tensor(mask).to(device=device, dtype=torch.bool)
        if m.shape != (n_local,):
            problem = f"mask shape {tuple(m.shape)} must match table rows ({n_local},)"
    if mesh.process_count > 1:
        check_local_rows([n_local], mesh, what, problem=problem)
    elif problem is not None:
        raise ValueError(problem)
    pad = -n_local % mesh.local_size
    cols = [c.to(device) for c in cols]
    if pad:
        cols = [torch.cat([c, c.new_zeros((pad,))]) for c in cols]
    valid = torch.arange(n_local + pad, device=device) < n_local
    if m is not None:
        valid[:n_local] &= m
    return n_local * mesh.process_count, valid, cols


def gather_prefixes(mesh: Mesh, nums: torch.Tensor, cap: int, *columns):
    """The per-shard valid prefixes (``nums`` rows of each ``(local_size,
    cap)`` int32 column) packed into one global prefix in global shard
    order, zeros after it, ``S * cap`` long: the distributed GROUP BY's
    merged groups (owners hold disjoint keys, so the concatenation is the
    global result) and the materializer's pools.  Across processes each
    process's columns are first cut to the widest shard's prefix (``pmax``)
    and gathered with the counts, so that every process holds every shard's
    rows; the packed result is the one-process result bit for bit.  One
    compaction, K5 on the card, its plain version on a CPU tensor.  Returns
    ``(*cols, count)``."""
    width = cap
    if mesh.process_count > 1:
        width = max(1, int(pmax(nums, mesh)))
        columns = [all_gather(c[:, :width].contiguous(), mesh).view(mesh.size, width)
                   for c in columns]
        nums = all_gather(nums, mesh)
    slot = torch.arange(width, device=nums.device)
    keep = (slot[None, :] < nums[:, None]).reshape(-1)
    count, _, *outs = kcompact.compact_rows(
        keep, [c.reshape(-1) for c in columns], mesh.size * cap)
    return (*outs, count)
