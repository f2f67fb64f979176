"""Multi-process execution: the scale-out layer past one device.

Counterpart of ``partitionedhashjoin_tpu/parallel/distributed.py``.  The
reference has no analogue (it is a single process whose "workers" are
threads, src/Common/ThreadPool.cpp); this layer is what replaces it past one
card:

- ``initialize``: the ``torch.distributed`` bootstrap, one coordinator and
  N processes, each owning one device, as under torchrun: the card
  ``cuda:{process_id % device_count}``, or the CPU in tests.
- ``global_mesh``: one 1-D "shards" mesh over every process
  (``parallel/mesh.py``); the shuffle join (``parallel/shuffle.py``) is
  unchanged from the one-process path, and the mesh's collectives route
  each block within a process (a copy) or across processes (the group).
- ``host_slice`` + ``make_global_table``: each process GENERATES only its
  row slice (the per-host generation of docs/SCALING.md) and holds it as
  its part of one globally row-sharded relation, with no data motion.

The backend follows the devices that the processes actually hold.  Before
the group forms, every process publishes its host name and device in the
coordinator's store and reads everyone's.  NCCL needs a card per process,
and refuses two ranks on one device, so where two processes of one host
hold the same card the group runs gloo, whose collectives then move each
block through host memory and loopback TCP (``mesh.py``); an explicit
``backend="nccl"`` there raises in every process, and never gives way
quietly.  Processes on several hosts, each with a card of its own, run
NCCL.  The CPU runs gloo.

Per-process generator streams are decorrelated by folding the process id into
the base seed, as in the JAX module: the multi-process counterpart of the
reference's per-worker leapfrogged LCG streams (src/Common/Random.cpp:9-30;
like there, the stream an individual row sees depends on the process count,
the distribution does not).
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
from typing import List, Optional, Sequence, Tuple

import torch

from partitionedhashjoin_tpu_torch.data.table import Table, make_table
from partitionedhashjoin_tpu_torch.parallel.mesh import Mesh
from partitionedhashjoin_tpu_torch.utils.device import resolve_device
from partitionedhashjoin_tpu_torch.utils.logger import get_new_logger

_log = get_new_logger("Distributed")

#: Seconds a collective waits for its peers before it fails: minutes, not
#: the default 30 minutes, so a dead peer fails a run instead of hanging it.
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class _Runtime:
    device: torch.device
    backend: str


#: What ``initialize`` chose for this process (one group per process, like
#: ``torch.distributed``'s default group, which it accompanies).
_runtime: Optional[_Runtime] = None


def _choose_backend(device: torch.device, holders: Sequence[str],
                    backend: Optional[str]) -> str:
    """gloo on the CPU and where two processes hold one card (two equal
    entries of ``holders``, every process's "host/device"), else NCCL; an
    explicit NCCL where it cannot run raises."""
    shared = device.type == "cuda" and len(set(holders)) < len(holders)
    fits_nccl = device.type == "cuda" and not shared
    if backend is None:
        return "nccl" if fits_nccl else "gloo"
    if backend == "nccl" and not fits_nccl:
        where = ("the processes share a card (NCCL refuses two ranks on one "
                 "device)" if shared else f"the device is {device.type}")
        raise ValueError(f"backend='nccl' requested, but {where}; use gloo")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}; use 'gloo' or 'nccl'")
    return backend


def _holders(store, num_processes: int, process_id: int,
             device: torch.device) -> List[str]:
    """Every process's "host/device", gathered through ``store``."""
    store.set(f"holder/{process_id}", f"{socket.gethostname()}/{device}")
    holders = [store.get(f"holder/{q}").decode() for q in range(num_processes)]
    # process 0 serves the store: it stays until every process has read it,
    # so that a refusal raises alike in every process
    store.set(f"read/{process_id}", "1")
    if process_id == 0:
        store.wait([f"read/{q}" for q in range(num_processes)])
    return holders


def initialize(
    coordinator: str,
    num_processes: int,
    process_id: int,
    platform: Optional[str] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the process group at ``coordinator`` ("host:port"; idempotent
    per process).

    ``platform`` names the device type, "cuda" (the default) or "cpu"; on
    "cuda" this process takes card ``process_id % device_count`` and makes
    it current.  ``backend`` (default: chosen as the module docstring says,
    from every process's device, which the processes exchange through the
    coordinator's store before the group forms) is logged and recorded in
    every mesh's ``backend``.
    """
    global _runtime
    import torch.distributed as dist

    if _runtime is not None and dist.is_initialized():
        return
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside [0, {num_processes})")
    device = resolve_device(platform or "cuda")
    if device.type == "cuda":
        device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    host, port = coordinator.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes, process_id == 0,
                          timeout=timeout)
    chosen = _choose_backend(
        device, _holders(store, num_processes, process_id, device), backend)
    dist.init_process_group(chosen, store=store, world_size=num_processes,
                            rank=process_id, timeout=timeout)
    _runtime = _Runtime(device=device, backend=chosen)
    _log.info("process %d/%d up on %s, backend %s%s", process_id, num_processes,
              device, chosen,
              " (processes share a card)" if device.type == "cuda"
              and chosen == "gloo" else "")


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    global _runtime
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _runtime = None


def _require_runtime() -> _Runtime:
    import torch.distributed as dist

    if _runtime is None or not dist.is_initialized():
        raise RuntimeError("call distributed.initialize first")
    return _runtime


def global_mesh(num_shards: Optional[int] = None) -> Mesh:
    """1-D "shards" mesh over every process: ``num_shards`` shards (default:
    one per process, the counterpart of JAX's every device), a power of 2
    that the process count divides."""
    import torch.distributed as dist

    runtime = _require_runtime()
    nproc, pid = dist.get_world_size(), dist.get_rank()
    size = nproc if num_shards is None else int(num_shards)
    if size < 1 or size & (size - 1):
        raise ValueError(f"num_shards must be a power of 2, got {size}")
    if size % nproc:
        raise ValueError(f"{size} shards do not split over {nproc} processes")
    return Mesh(device=runtime.device, size=size, process_index=pid,
                process_count=nproc, group=dist.group.WORLD,
                backend=runtime.backend)


def host_slice(total_rows: int, num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> Tuple[int, int]:
    """(start, rows) of this process's generation slice.

    Row counts must divide evenly by the process count (pad upstream
    otherwise — the same contract as mesh.shard_table).  With both
    arguments given it reads no process group.
    """
    nproc, pid = num_processes, process_id
    if nproc is None or pid is None:
        import torch.distributed as dist

        _require_runtime()
        nproc = dist.get_world_size() if nproc is None else nproc
        pid = dist.get_rank() if pid is None else pid
    if total_rows % nproc:
        raise ValueError(
            f"total rows {total_rows} not divisible by {nproc} processes"
        )
    rows = total_rows // nproc
    return pid * rows, rows


def make_global_table(local_keys, local_payloads, mesh: Mesh) -> Table:
    """This process's part of one globally row-sharded Table.

    Each process passes ONLY its local slice, and it stays there: no
    cross-process transfer happens.  Global row order is process-major —
    exactly ``host_slice``'s layout.
    """
    keys = torch.as_tensor(local_keys).to(mesh.device)
    payloads = torch.as_tensor(local_payloads).to(mesh.device)
    if keys.shape[0] % mesh.local_size:
        raise ValueError(
            f"{keys.shape[0]} local rows not divisible by {mesh.local_size} "
            "local shards"
        )
    return make_table(keys, payloads)


def generate_global_tables(
    primary_rows: int,
    secondary_rows: int,
    skew: float,
    mesh: Mesh,
    seed: int,
    zipf_method: str = "alias",
) -> Tuple[Table, Table]:
    """Per-process generation of both relations, on the mesh's device.

    Primary: this process's slice of the sequential ids 1..N (payload =
    global row).  Secondary: Zipf over [1, primary_rows] with a per-process
    folded seed (the leapfrog-stream analogue; see module docstring),
    payload = global row.  ``zipf_method="alias"`` builds the Vose tables
    on the host in every process (``data/host_loader``).
    """
    from partitionedhashjoin_tpu_torch.ops import generators

    nproc, pid = mesh.process_count, mesh.process_index
    a_start, a_rows = host_slice(primary_rows, nproc, pid)
    b_start, b_rows = host_slice(secondary_rows, nproc, pid)
    device = mesh.device
    keys_a = torch.arange(a_start + 1, a_start + a_rows + 1, dtype=torch.int32,
                          device=device)
    pays_a = torch.arange(a_start, a_start + a_rows, dtype=torch.int32,
                          device=device)
    host_seed = (seed ^ (0x9E3779B9 * (pid + 1))) & 0x7FFFFFFF
    table_b_local = generators.zipf_table(
        b_rows,
        alpha=skew,
        key_range=(1, primary_rows),
        seed=host_seed,
        method=zipf_method,
        device=device,
    )
    pays_b = torch.arange(b_start, b_start + b_rows, dtype=torch.int32,
                          device=device)
    table_a = make_global_table(keys_a, pays_a, mesh)
    table_b = make_global_table(table_b_local.keys, pays_b, mesh)
    return table_a, table_b
