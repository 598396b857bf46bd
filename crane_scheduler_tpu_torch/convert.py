"""Carrying state across from the JAX package, as plain numpy.

The port imports nothing of ``crane_scheduler_tpu``. A caller that holds
that package's objects (a test feeding both packages identical inputs,
or a process migrating a live store) passes their fields as numpy
arrays and scalars, or NRT custom resources as plain mappings; these
functions build the port's objects from them.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np

from .cluster.state import ClusterState, Node, NodeAddress
from .loadstore.store import DeviceSnapshot
from .policy.compile import PolicyTensors
from .topology.types import (
    CraneManagerPolicy,
    InMemoryNRTLister,
    NodeResourceTopology,
    Zone,
)

_SNAPSHOT_FIELDS = (
    "values", "ts", "hot_value", "hot_ts", "node_valid", "n_nodes", "node_names",
)


def policy_tensors_from_numpy(d) -> PolicyTensors:
    """``PolicyTensors`` from a mapping of its fields (``metric_names``,
    ``metric_index``, the entry arrays and ``weight_sum``). Arrays are
    copied with the dtypes the port's ``compile_policy`` produces."""
    names = [f.name for f in fields(PolicyTensors)]
    missing = [k for k in names if k not in d]
    if missing:
        raise KeyError(f"policy tensors lack fields {missing}")
    dtypes = {
        "sync_seconds": np.float64, "active_seconds": np.float64,
        "pred_idx": np.int32, "pred_threshold": np.float64,
        "pred_active": np.float64, "prio_idx": np.int32,
        "prio_weight": np.float64, "prio_active": np.float64,
        "hv_range_seconds": np.float64, "hv_count": np.int64,
    }
    kw = {k: np.array(d[k], dtype=dt) for k, dt in dtypes.items()}
    return PolicyTensors(
        metric_names=tuple(d["metric_names"]),
        metric_index=dict(d["metric_index"]),
        weight_sum=float(d["weight_sum"]),
        **kw,
    )


def snapshot_from_numpy(d) -> DeviceSnapshot:
    """``DeviceSnapshot`` from a mapping with ``values``, ``ts``,
    ``hot_value``, ``hot_ts``, ``node_valid``, ``n_nodes`` and
    ``node_names`` (arrays copied; ``version`` is -1, synthetic)."""
    missing = [k for k in _SNAPSHOT_FIELDS if k not in d]
    if missing:
        raise KeyError(f"snapshot lacks fields {missing}")
    return DeviceSnapshot(
        values=np.array(d["values"], dtype=np.float64),
        ts=np.array(d["ts"], dtype=np.float64),
        hot_value=np.array(d["hot_value"], dtype=np.float64),
        hot_ts=np.array(d["hot_ts"], dtype=np.float64),
        node_valid=np.array(d["node_valid"], dtype=bool),
        n_nodes=int(d["n_nodes"]),
        node_names=tuple(d["node_names"]),
    )


def nrt_lister_from_crs(crs) -> InMemoryNRTLister:
    """``InMemoryNRTLister`` from NodeResourceTopology CRs as plain
    mappings, one per node, in upsert order: ``name``,
    ``cpu_manager_policy``, ``topology_manager_policy`` and ``zones`` (a
    list of ``Zone.to_wire`` dicts: ``name``, ``type``, ``resources`` with
    ``allocatable`` / ``capacity``). Absent policies take the CR defaults
    (``None``)."""
    lister = InMemoryNRTLister()
    default = CraneManagerPolicy()
    for cr in crs:
        lister.upsert(NodeResourceTopology(
            name=str(cr["name"]),
            crane_manager_policy=CraneManagerPolicy(
                str(cr.get("cpu_manager_policy", default.cpu_manager_policy)),
                str(cr.get("topology_manager_policy", default.topology_manager_policy)),
            ),
            zones=tuple(Zone.from_wire(z) for z in cr.get("zones", ())),
        ))
    return lister


def cluster_from_nodes(nodes) -> ClusterState:
    """A ``ClusterState`` holding ``nodes``, given as plain mappings in
    insertion order: ``name``, and optionally ``annotations``, ``labels``
    and ``allocatable`` (copied into plain dicts) and ``addresses`` (a
    list of ``(type, address)`` pairs)."""
    cluster = ClusterState()
    for n in nodes:
        cluster.add_node(Node(
            name=str(n["name"]),
            annotations=dict(n.get("annotations") or {}),
            labels=dict(n.get("labels") or {}),
            addresses=tuple(
                NodeAddress(str(t), str(a)) for t, a in n.get("addresses") or ()
            ),
            allocatable=dict(n.get("allocatable") or {}),
        ))
    return cluster
