"""Batched NUMA topology evaluation: every candidate node at once.

Counterpart of ``crane_scheduler_tpu/topology/batched.py``. The plugin's
Filter runs per node (ref: pkg/plugins/noderesourcetopology/filter.go:
45-86): rebuild zone usage, check fit, greedily pack. For gang and
mixed-batch scheduling this vectorizes over one ``[N, Z, R]``
free-capacity tensor:

- zones sort per node by free CPU descending (the reference's order,
  stable, invalid zones last);
- non-aware packing floors zone CPU to whole cores, then assigns the
  request across the sorted zones; a zone "contributes" when any resource
  takes a nonzero bite; the score divides by the number of contributing
  zones (ref: helper.go:173-212, scorer.go:11-29);
- aware pods need a single zone that fits everything;
- ``copies_capacity`` bounds how many identical copies fit per node.

The reference jits ``_evaluate`` and ``_copies_capacity``; here both are
plain PyTorch float64 functions on the caller's device (the
``BatchScheduler``'s), with no bucket padding: nothing compiles per
shape. Parity details that a GPU could break:

- every division is tensor by tensor: CUDA rewrites ``x / scalar`` as
  ``x * (1/scalar)``, which can floor a whole-core boundary one core low;
- ``torch.argsort(stable=True)``: ties in free CPU (both zones of an idle
  node) keep the CR's zone order, as ``jnp.argsort`` does;
- the copy bound clips to ``[0, 2^31-1]`` per zone, and the aware sum
  saturates at ``2^31-1`` on the int32 cast as XLA's conversion does.

Host-side prep (zone usage from pod annotations) stays in
``helper.NodeWrapper``; ``pack_node_wrappers`` and ``request_vector`` are
numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..constants import MAX_NODE_SCORE
from ..device import resolve_device
from ..framework.types import Resource
from .helper import NodeWrapper

# resource channels: [cpu_milli, memory, ephemeral_storage]
_R = 3
_I32_MAX = 2.0**31 - 1


@dataclass
class BatchedTopologyResult:
    aware_fits: Any  # [N] bool — some single zone fits the whole request
    zones_used: Any  # [N] int32 — contributing zones under greedy pack
    finished: Any  # [N] bool — the request fully packed
    scores: Any  # [N] int32 — 100 // zones_used (0 when nothing packs)


def pack_node_wrappers(wrappers: list[NodeWrapper], max_zones: int | None = None):
    """``[N, Z, R]`` allocatable and requested arrays and the ``[N, Z]``
    validity mask from per-node wrappers (allocatable kept raw: the greedy
    pack floors CPU, the aware fit check does not — ref: helper.go:194 vs
    :230-282). Zones past a node's own count are ``valid=False``."""
    n = len(wrappers)
    z = max(max_zones or max((len(w.numa_nodes) for w in wrappers), default=1), 1)
    alloc = np.zeros((n, z, _R), dtype=np.float64)
    used = np.zeros((n, z, _R), dtype=np.float64)
    valid = np.zeros((n, z), dtype=bool)
    rows, cols, a_vals, u_vals = [], [], [], []
    for i, w in enumerate(wrappers):
        for j, nn in enumerate(w.numa_nodes[:z]):
            a, u = nn.allocatable, nn.requested
            rows.append(i)
            cols.append(j)
            a_vals.append((a.milli_cpu, a.memory, a.ephemeral_storage))
            u_vals.append((u.milli_cpu, u.memory, u.ephemeral_storage))
    if rows:
        alloc[rows, cols] = np.array(a_vals, dtype=np.float64)
        used[rows, cols] = np.array(u_vals, dtype=np.float64)
        valid[rows, cols] = True
    return alloc, used, valid


def request_vector(request: Resource) -> np.ndarray:
    return np.array(
        [request.milli_cpu, request.memory, request.ephemeral_storage],
        dtype=np.float64,
    )


def _whole_cores(alloc_cpu: torch.Tensor) -> torch.Tensor:
    """``floor(alloc / 1000) * 1000``, dividing by a tensor (see above)."""
    thousand = torch.full_like(alloc_cpu, 1000.0)
    return torch.floor(alloc_cpu / thousand) * 1000.0


def _evaluate(alloc, used, valid, request):
    """alloc/used ``[N, Z, R]`` float64, valid ``[N, Z]`` bool, request
    ``[R]`` float64, all on one device.

    Mirrors ``assign_request_for_numa_node`` faithfully, including the Go
    arithmetic on overcommitted zones: ``assigned = min(remaining,
    capacity)`` with negative capacity inflates the remaining request
    (capacity is never clamped), and packing stops after the zone that
    finishes the request. The zone axis is small: the sequential
    recurrence is a Python loop over it.
    """
    free = alloc - used  # raw free: the fit check and the sort order

    # aware: one zone fitting the whole request (ref: filter.go:107-123)
    fits_zone = (free >= request[None, None, :]).all(dim=2) & valid
    aware_fits = fits_zone.any(dim=1)

    # greedy pack order: free CPU descending (stable, invalid zones last)
    neg_inf = torch.full_like(free[:, :, 0], float("-inf"))
    order = torch.argsort(-torch.where(valid, free[:, :, 0], neg_inf), dim=1, stable=True)
    idx = order[:, :, None].expand(-1, -1, _R)
    s_alloc = torch.gather(alloc, 1, idx)
    s_used = torch.gather(used, 1, idx)
    s_valid = torch.gather(valid, 1, order)
    # whole-core rounding of allocatable CPU (ref: helper.go:194)
    cpu_cap = _whole_cores(s_alloc[:, :, 0]) - s_used[:, :, 0]
    # may be negative: overcommitted zones give back
    capacity = torch.cat([cpu_cap[:, :, None], (s_alloc - s_used)[:, :, 1:]], dim=2)

    n, z, _ = capacity.shape
    remaining = request[None, :].expand(n, _R)
    active = torch.ones((n,), dtype=torch.bool, device=alloc.device)
    zones_used = torch.zeros((n,), dtype=torch.int32, device=alloc.device)
    for j in range(z):
        # ref: helper.go:288-293, an all-zero remainder assigns nothing
        can = active & s_valid[:, j] & (remaining != 0).any(dim=1)
        assigned = torch.where(can[:, None], torch.minimum(remaining, capacity[:, j, :]),
                               torch.zeros_like(remaining))
        remaining = remaining - assigned
        zones_used = zones_used + (can & (assigned > 0).any(dim=1)).to(torch.int32)
        finished_now = can & (remaining <= 0).all(dim=1)
        active = active & ~finished_now
    finished = (remaining <= 0).all(dim=1)

    score = torch.where(
        zones_used > 0,
        torch.div(torch.full_like(zones_used, MAX_NODE_SCORE), zones_used.clamp(min=1),
                  rounding_mode="floor"),
        torch.zeros_like(zones_used),
    )
    return aware_fits, zones_used, finished, score


def _upload(wrappers, request, dev):
    alloc, used, valid = pack_node_wrappers(wrappers)
    return (torch.from_numpy(alloc).to(dev), torch.from_numpy(used).to(dev),
            torch.from_numpy(valid).to(dev),
            torch.from_numpy(request_vector(request)).to(dev))


def evaluate_topology_batch(
    wrappers: list[NodeWrapper], request: Resource, device=None
) -> BatchedTopologyResult:
    """Aware fit, zones used, finished and score per wrapper, as numpy.
    ``device``: ``None`` means the GPU (raises without one); ``"cpu"`` for
    the CPU."""
    dev = resolve_device(device)
    out = _evaluate(*_upload(wrappers, request, dev))
    return BatchedTopologyResult(*(o.cpu().numpy() for o in out))


def _copies_capacity(alloc, used, valid, request, aware):
    """How many identical copies of ``request`` fit per node: the gang
    ``capacity`` vector for guaranteed-CPU bursts.

    Aware pods need every copy inside a single zone (ref: filter.go:
    107-123 applied per copy), so the per-node capacity is
    Σ_z floor(min_r free[z,r] / request_r). Non-aware copies pack across
    zones greedily; total free per resource bounds them:
    min_r floor(Σ_z free[z,r] / request_r) with allocatable CPU floored to
    whole cores per zone (ref: helper.go:194). request_r == 0 never binds.

    An admission estimate, not bit-parity with a sequential packer: exact
    for non-aware packing over non-overcommitted zones and for CPU-bound
    aware requests; overcommitted (negative-free) zones subtract from the
    pool, which under-counts where the sequential packer's early finish
    would have skipped them (never over-admits). Per-pod admission stays
    with the plugin at bind time.
    """
    free = alloc - used  # [N, Z, R]
    cpu_floored = _whole_cores(alloc[:, :, 0]) - used[:, :, 0]
    free_pack = torch.cat([cpu_floored[:, :, None], free[:, :, 1:]], dim=2)

    req = torch.clamp(request, min=0.0)
    bind = req > 0  # resources with zero request never limit capacity
    safe_req = torch.where(bind, req, torch.ones_like(req))
    inf = torch.tensor(float("inf"), dtype=free.dtype, device=free.device)

    # aware: per-zone copy count, summed over valid zones
    per_zone = torch.floor(free / safe_req[None, None, :])
    per_zone = torch.where(bind[None, None, :], per_zone, inf)
    zone_copies = torch.clamp(per_zone.amin(dim=2), 0.0, _I32_MAX)
    aware_cap = torch.where(valid, zone_copies, torch.zeros_like(zone_copies)).sum(dim=1)

    # non-aware: pooled free (negative zones give back), per-resource bound
    pooled = torch.where(valid[:, :, None], free_pack, torch.zeros_like(free_pack)).sum(dim=1)
    per_res = torch.floor(pooled / safe_req[None, :])
    per_res = torch.where(bind[None, :], per_res, inf)
    pool_cap = torch.clamp(per_res.amin(dim=1), 0.0, _I32_MAX)

    cap = torch.where(aware, aware_cap, pool_cap)
    # an empty request is unbounded; the int32 cast saturates like XLA's
    cap = torch.where(bind.any(), cap, torch.full_like(cap, _I32_MAX))
    return torch.clamp(cap, max=_I32_MAX).to(torch.int32)


def copies_capacity(
    wrappers: list[NodeWrapper], request: Resource, aware, device=None
) -> np.ndarray:
    """``[N]`` int32 identical-copy capacity per node (gang capacity).

    ``aware`` is a scalar bool or an ``[N]`` mask (per-node awareness);
    both bounds are computed and selected per node. ``device`` as for
    ``evaluate_topology_batch``."""
    dev = resolve_device(device)
    n = len(wrappers)
    aware = np.asarray(aware, dtype=bool)
    aware = aware if aware.shape else np.full((n,), bool(aware))
    cap = _copies_capacity(*_upload(wrappers, request, dev), torch.from_numpy(aware).to(dev))
    return cap.cpu().numpy()


def stranded_copies(capacity, upper, exact) -> np.ndarray:
    """[N] int64 — copy capacity a node would strand if every token it
    holds at or above the waterline binds: ``capacity - (upper + exact)``
    clipped at zero. The gang queue's fragmentation-aware tie policy fills
    waterline tokens on the nodes stranding the least capacity first
    (Tesserae-style bin protection: leave the large contiguous copy blocks
    on other nodes intact for future gangs), which only reorders the
    waterline split — the level and token multiset are
    tie-policy-independent (see ``scorer.topk.waterline_take``)."""
    cap = np.asarray(capacity, np.int64)
    taken = np.asarray(upper, np.int64) + np.asarray(exact, np.int64)
    return np.clip(cap - taken, 0, None)
