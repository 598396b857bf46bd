"""Node-mesh helpers: the node axis is the scaling axis.

Counterpart of ``crane_scheduler_tpu/parallel/mesh.py``. The reference
shards the cluster's node dimension across TPU devices on a 1-D
``jax.sharding.Mesh``; here a ``NodeMesh`` is the ordered tuple of tile
devices the node axis is split over. Scoring is elementwise over nodes,
and the gang solve needs only small cross-tile combines (level totals,
one prefix offset per tile), which ``parallel.sharded`` does by hand.

The reference's ``node_sharding`` / ``replicated_sharding`` have no
PyTorch counterpart: a tensor has one device and no sharding spec. Their
role is taken by ``node_tiles``, which says which global rows each local
tile holds; a replicated value is computed once, on the first tile.

``make_node_mesh(n)`` takes the first ``n`` distinct GPUs and raises when
there are fewer. Repeated tile devices (``[torch.device("cpu")] * 8``,
``[cuda:0] * 4``) are accepted only when passed explicitly: they are the
counterpart of XLA's virtual host devices, and the only way to run the
tiling on the CPU or on one card. A mesh built by
``distributed.global_node_mesh`` also spans other processes: each process
holds only its own tiles (``devices``), and ``size`` counts every tile of
every process.
"""

from __future__ import annotations

import torch

from ..device import resolve_device

NODE_AXIS = "nodes"


def _indexed(device) -> torch.device:
    """``device`` with its index: ``cuda`` means the current GPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class NodeMesh:
    """A 1-D mesh over the node axis: this process's tile devices, in node
    order, and where they sit among every process's tiles."""

    axis_names = (NODE_AXIS,)

    def __init__(self, devices, process_count: int = 1, process_index: int = 0,
                 collective: bool = False):
        """``collective``: the mesh belongs to a ``torch.distributed`` group
        (``distributed.global_node_mesh``), and the step's combines run as
        collectives over it, also in a world of one process."""
        self.devices = tuple(_indexed(d) for d in devices)
        if not self.devices:
            raise ValueError("a node mesh needs at least one device")
        self.process_count = int(process_count)
        self.process_index = int(process_index)
        self.collective = bool(collective) or self.process_count > 1

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Tiles over every process (the reference's ``mesh.devices.size``)."""
        return self.local_size * self.process_count

    @property
    def first_tile(self) -> int:
        """Global index of this process's first tile."""
        return self.process_index * self.local_size

    @property
    def distributed(self) -> bool:
        """Combines run as collectives over the process group."""
        return self.collective

    def token(self) -> tuple:
        """What identifies the partitioning (``DeviceColumnCache.set_partition``)."""
        return (tuple(str(d) for d in self.devices), self.axis_names, (self.size,),
                self.process_count, self.process_index)

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.devices)
        extra = (f", process {self.process_index}/{self.process_count}"
                 if self.distributed else "")
        return f"NodeMesh([{devs}]{extra})"


def _local_devices(n: int | None) -> list:
    """The first ``n`` distinct GPUs (all of them for None); raises with the
    reference's message when there are fewer."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n is None:
        resolve_device(None)  # no GPU at all: the entry points' error
        n = count
    if count < n:
        raise ValueError(f"requested {n} devices, only {count} available")
    return [torch.device("cuda", i) for i in range(int(n))]


def make_node_mesh(n_devices: int | None = None, devices=None) -> NodeMesh:
    """1-D mesh over the node axis: the first ``n_devices`` of ``devices``
    (default: the distinct local GPUs, all of them for None)."""
    if devices is None:
        return NodeMesh(_local_devices(n_devices))
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} available"
            )
        devices = devices[:n_devices]
    return NodeMesh(devices)


def local_mesh(n_devices: int | None, device=None) -> NodeMesh:
    """The operator flags' mesh: ``n_devices`` distinct GPUs (None: all)
    for a ``cuda`` device (or None), the host's one CPU device for
    ``cpu`` — asking for more raises the reference's device-count error."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return make_node_mesh(n_devices, devices=[dev])
    return make_node_mesh(n_devices)


def make_placement_mesh(n_shards: int | None = None, devices=None) -> NodeMesh:
    """The drip window's placement mesh: the node mesh under the role's
    name (the window's columns are node-major). Its columns tile along
    ``NODE_AXIS`` over ``n_shards`` devices (default: all local GPUs); a
    1-tile mesh runs the single-device window."""
    return make_node_mesh(n_shards, devices)


def mesh_shape(mesh: NodeMesh) -> dict:
    """Self-describing mesh metadata for result lines."""
    return {"axes": {NODE_AXIS: mesh.size}, "devices": mesh.size}


def round_up_to_shards(n: int, mesh: NodeMesh) -> int:
    """Smallest multiple of the mesh's tile count >= ``n`` (tiles are equal)."""
    s = int(mesh.size)
    return -(-int(n) // s) * s


def node_tiles(mesh: NodeMesh, n: int) -> list:
    """``(device, start, stop)`` of each local tile over ``n`` global rows.
    Raises as the reference's ``NamedSharding`` does when ``n`` is not a
    multiple of the tile count: tiles are equal and nothing pads here."""
    s = int(mesh.size)
    if int(n) % s:
        raise ValueError(
            f"the node axis of length {n} does not split into {s} equal "
            f"tiles: it must be a multiple of the mesh size {s}"
        )
    nloc = int(n) // s
    first = mesh.first_tile
    return [(dev, (first + t) * nloc, (first + t + 1) * nloc)
            for t, dev in enumerate(mesh.devices)]
