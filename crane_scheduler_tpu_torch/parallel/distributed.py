"""Multi-process scheduling: the node axis split across processes.

Counterpart of ``crane_scheduler_tpu/parallel/distributed.py``, on
``torch.distributed``. The reference runs one SPMD program over a global
``Mesh`` of every process's devices; here every process holds only its
own node tiles (``global_node_mesh``), and ``ShardedScheduleStep`` makes
the step's cross-process traffic explicit: three small ``all_reduce``
sums (the level totals, each tile's exact-token sum with ``sum(upper)``)
and one final ``all_reduce`` that assembles the packed vector, so every
rank returns the full ``[N+2]`` result in process order.

``initialize`` takes the coordinator address, the world size and the
rank explicitly (nothing on the host tells a program of its cluster):
NCCL for a process on the GPU, gloo for one on the CPU, or the
``backend=`` asked for. NCCL runs one rank per GPU; a gloo world may put
several ranks on one card, and then the combines travel through CPU
tensors. NCCL never turns into gloo on its own.

Deployment shape, as in the reference: each process's annotator syncs the
node shard it owns (``partition_nodes``) into a local ``NodeLoadStore``,
and ``prepare_from_local_shard`` uploads that shard into the process's
tiles of the global step. Hybrid f32 rescue rows are computed per shard.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..device import resolve_device
from .mesh import NodeMesh

# A step over a mesh that spans processes runs its combines as a fixed
# sequence of collectives; two such steps launched concurrently from
# different threads (the shard plane runs one scheduler per thread) would
# interleave their all_reduce calls across processes. Such steps
# serialize process-wide, held through the output sync.
COLLECTIVE_LOCK = threading.Lock()

_STATE: dict = {"device": None}


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               backend: str | None = None, device=None) -> None:
    """``torch.distributed.init_process_group`` over
    ``tcp://coordinator_address`` (idempotent per process).

    ``device`` is this process's device (``None`` means the GPU and raises
    without one; a ``cuda`` device without an index is the GPU at rank
    modulo the GPU count). ``backend``: NCCL for a GPU process, gloo for a
    CPU one, unless given."""
    import torch.distributed as dist

    if num_processes is None or process_id is None:
        raise ValueError("initialize needs num_processes and process_id")
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if dev.type == "cuda" and (device is None or torch.device(device).index is None):
        dev = torch.device("cuda", int(process_id) % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
    )
    _STATE["device"] = dev


def process_device() -> torch.device:
    """This process's device, as ``initialize`` chose it."""
    if _STATE["device"] is None:
        raise RuntimeError("parallel.initialize has not run in this process")
    return _STATE["device"]


def shutdown() -> None:
    """Leave the process group (no-op when none is up)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE["device"] = None


def global_node_mesh(devices=None) -> NodeMesh:
    """1-D mesh over every process's tiles: this process holds ``devices``
    (default: its own device from ``initialize``). Every process must pass
    the same number of tiles — the multi-controller contract."""
    import torch.distributed as dist

    if devices is None:
        devices = [process_device()]
    return NodeMesh(devices, process_count=dist.get_world_size(),
                    process_index=dist.get_rank(), collective=True)


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of ``t`` over every process, on ``t``'s device.
    Under NCCL in place on the GPU; under gloo through a CPU tensor."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        dist.all_reduce(t)
        return t
    host = t.cpu() if t.is_cuda else t
    dist.all_reduce(host)
    return host.to(t.device) if t.is_cuda else host


def partition_nodes(names, num_processes: int, process_id: int):
    """Contiguous node-name shard owned by ``process_id``.

    Deterministic given identical name order on every host (the
    annotator sorts); the global array assembles shards in process
    order, so global row i maps back to the same node everywhere.
    """
    names = list(names)
    n = len(names)
    base, rem = divmod(n, num_processes)
    start = process_id * base + min(process_id, rem)
    end = start + base + (1 if process_id < rem else 0)
    return names[start:end]


def host_local_to_global(local: np.ndarray, mesh: NodeMesh, sharded_dim0: bool = True):
    """This process's part of a global node-axis array: its dim-0 rows
    split over its local tiles (a tuple of per-tile tensors), the shards of
    all processes forming the global array in process order. Without
    ``sharded_dim0`` the input is the same on every process and each tile
    holds all of it."""
    from .column_cache import upload

    local = np.asarray(local)
    if not sharded_dim0:
        return tuple(upload(local, dev) for dev in mesh.devices)
    k = mesh.local_size
    if local.shape[0] % k:
        raise ValueError(
            f"the local shard of {local.shape[0]} rows does not split into "
            f"{k} equal tiles"
        )
    rows = local.shape[0] // k
    return tuple(upload(local[t * rows:(t + 1) * rows], dev)
                 for t, dev in enumerate(mesh.devices))


def prepare_from_local_shard(step, snapshot, now: float, capacity=None, offsets=None):
    """Multi-process twin of ``ShardedScheduleStep.prepare``: ``snapshot``
    holds only this process's node shard; the result is this process's
    tiles of the global snapshot. The local shard length must be equal
    across processes (pad each store snapshot to the same bucket multiple).
    A hybrid step computes the f64 rescue vectors for this shard only."""
    mesh = step.mesh
    n_local = int(np.asarray(snapshot.ts).shape[0])
    return step._prepare_rows(snapshot, now, capacity, offsets,
                              n_local * mesh.process_count,
                              mesh.process_index * n_local)
