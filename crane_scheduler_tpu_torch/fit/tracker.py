"""Incremental columnar allocatable/requested accounting.

Counterpart of ``crane_scheduler_tpu/fit/tracker.py``: ``FitTracker``
with ``refresh``, ``fits``, ``fits_mask``, ``free_matrix``,
``alloc_version``, the gang solver's ``free_copy_counts`` and
``free_for``, and the request/reason helpers with ``copy_counts_rows``.
Allocatable rows refresh through the cluster's dirty-name journal: a
covered interval with unchanged membership identity-checks only the
journal's names (``crane_dirty_rows_total{consumer="fit"}``), anything
else takes one identity sweep.

ref: k8s.io/kubernetes/pkg/scheduler/framework/plugins/noderesources —
the fit math (effective pod request = max(sum of containers, max over
init containers) + overhead; insufficient when request exceeds
allocatable minus requested) — computed over numpy columns maintained
off the ``ClusterState`` mirror instead of per-NodeInfo structs.

Incrementality rides the mirror's change journal: requested sums are
version-gated on ``pod_version`` and, when the journal window still
covers the interval, only the nodes named by ``pod_changes_since`` are
recounted; a journal overrun falls back to a from-scratch recount.
Allocatable columns are gated on ``node_version`` with a per-node
identity check, so the annotator's sweep (which bumps ``node_version``
without touching allocatable) costs one ``is`` comparison per node, not
a quantity reparse.

Nodes that never reported ``status.allocatable`` (the sim's synthetic
nodes, sparse fixtures) are UNBOUNDED — the fit layer fails open, so
wiring it into an existing cluster changes no placement until kubelets
actually report capacity.
"""

from __future__ import annotations

import threading
from typing import Any, Iterable, Mapping

import numpy as np

from ..cluster.state import Pod
from ..framework.types import (
    CPU,
    EPHEMERAL_STORAGE,
    MEMORY,
    PODS,
    Resource,
)
from ..utils.quantity import to_milli, to_value

# Capacity sentinel for "no limit" — matches the gang solver's historical
# default so min(solver_default, fit_rows) is an identity on unreported
# nodes and plain-path parity is preserved bit-for-bit.
UNBOUNDED = 1 << 30

# Columnar dim order: [milli_cpu, memory, ephemeral_storage, pods].
_N_DIMS = 4
_DIM_CPU, _DIM_MEM, _DIM_EPH, _DIM_PODS = range(_N_DIMS)
_DIM_NAMES = (CPU, MEMORY, EPHEMERAL_STORAGE, PODS)


def _max_into(acc: Resource, other: Resource) -> None:
    """Element-wise max of ``other`` into ``acc`` (init-container rule)."""
    acc.milli_cpu = max(acc.milli_cpu, other.milli_cpu)
    acc.memory = max(acc.memory, other.memory)
    acc.ephemeral_storage = max(acc.ephemeral_storage, other.ephemeral_storage)
    for k, v in other.scalar_resources.items():
        if v > acc.scalar_resources.get(k, 0):
            acc.scalar_resources[k] = v


def pod_fit_request(pod: Pod) -> Resource:
    """Effective scheduling request, kube semantics: per-resource
    max(sum of container requests, max over init-container requests),
    plus pod overhead. Missing requests default to 0."""
    r = Resource()
    for c in pod.containers:
        r.add(c.resources.requests)
    for c in getattr(pod, "init_containers", ()):
        one = Resource()
        one.add(c.resources.requests)
        _max_into(r, one)
    overhead = getattr(pod, "overhead", None)
    if overhead:
        r.add(overhead)
    return r


def request_vec(r: Resource) -> np.ndarray:
    """Dense int64 request row in columnar dim order."""
    vec = np.zeros((_N_DIMS,), dtype=np.int64)
    vec[_DIM_CPU] = r.milli_cpu
    vec[_DIM_MEM] = r.memory
    vec[_DIM_EPH] = r.ephemeral_storage
    vec[_DIM_PODS] = 1  # every pod consumes one slot
    return vec


def copy_counts_rows(free: np.ndarray, bounded: np.ndarray, vec: np.ndarray) -> np.ndarray:
    """``free_copy_counts`` math over an explicit free matrix: how many
    request rows ``vec`` fit in each row of ``free`` (int64[N,4]),
    unbounded rows (``~bounded``) coming back UNBOUNDED. The gang window's
    host twin and its device window both derive capacity this way; it
    equals the tracker's own ``free_copy_counts`` over the same rows
    (minus the scalar-resources walk, which columnar callers route to the
    fallback)."""
    counts = np.full((free.shape[0],), UNBOUNDED, dtype=np.int64)
    clipped = np.clip(free, 0, None)
    for d in range(_N_DIMS):
        if vec[d] > 0:
            np.minimum(counts, clipped[:, d] // vec[d], out=counts)
    counts[~np.asarray(bounded, bool)] = UNBOUNDED
    return counts


def row_fail_reason(free_row, vec) -> str:
    """First failing dimension of a bounded free row against ``vec``,
    in NodeResourcesFit's check order and wording (pods slot first,
    then cpu/memory/ephemeral-storage). Empty string means it fits."""
    if free_row[_DIM_PODS] < vec[_DIM_PODS]:
        return "Too many pods"
    for d in (_DIM_CPU, _DIM_MEM, _DIM_EPH):
        if vec[d] > 0 and vec[d] > free_row[d]:
            return f"Insufficient {_DIM_NAMES[d]}"
    return ""


def rows_fail_codes(free: np.ndarray, vec: np.ndarray) -> np.ndarray:
    """Vectorized ``row_fail_reason``: int8[N] of first-failing dims
    (-1 = fits) in the same check order — pods slot first, then
    cpu/memory/ephemeral-storage. One pass over the free matrix instead
    of a Python loop per row; ``fail_code_reason`` maps codes back to
    the exact scalar wording."""
    codes = np.full((free.shape[0],), -1, dtype=np.int8)
    # reverse priority order, later writes win
    for d in (_DIM_EPH, _DIM_MEM, _DIM_CPU):
        if vec[d] > 0:
            codes[vec[d] > free[:, d]] = d
    codes[free[:, _DIM_PODS] < vec[_DIM_PODS]] = _DIM_PODS
    return codes


def fail_code_reason(code: int) -> str:
    """``row_fail_reason`` wording for a ``rows_fail_codes`` entry."""
    if code == _DIM_PODS:
        return "Too many pods"
    return f"Insufficient {_DIM_NAMES[code]}"


class FitTracker:
    """Columnar free-allocatable accounting over a cluster mirror.

    Thread-safe; ``refresh()`` is cheap when nothing changed (two
    version reads) and incremental when the mirror's change journal
    covers the interval. All read methods operate on the columns built
    by the last ``refresh()`` — callers refresh once per cycle, not per
    lookup.
    """

    def __init__(self, cluster, telemetry=None):
        self._cluster = cluster
        self._lock = threading.Lock()
        self._node_ver = -1
        self._pod_ver = -1
        self._names: list[str] = []
        self._index: dict[str, int] = {}
        self._has_alloc = np.zeros((0,), dtype=bool)
        self._alloc = np.zeros((0, _N_DIMS), dtype=np.int64)
        self._req = np.zeros((0, _N_DIMS), dtype=np.int64)
        # rare paths, keyed by node name; only nodes that have any
        self._alloc_maps: dict[str, Mapping[str, Any]] = {}
        self._scalar_alloc: dict[str, dict[str, int]] = {}
        self._scalar_req: dict[str, dict[str, int]] = {}
        self._full_recounts = 0
        self._incremental_recounts = 0
        self._node_patches = 0  # journal-driven O(dirty) node refreshes
        self._req_dirty = True  # requested columns not yet counted
        # bumps only when capacity state actually moved (membership or
        # an allocatable row) — annotation patches bump node_version
        # without touching it, so free_matrix consumers can skip the
        # O(n) aligned copy entirely
        self.alloc_version = 0
        # name->row gathers cached per (names list identity, index
        # epoch): the drip column cache and the gang solver's capacity
        # rows re-pass the SAME list object every call, so steady state is
        # pure fancy indexing
        self._index_ver = 0
        self._aligned: list[tuple] = []  # (names_ref, index_ver, rows, known)
        self.mask_builds = 0  # aligned-gather rebuilds (regression gate)
        self._telemetry = telemetry
        if telemetry is not None:
            reg = telemetry.registry
            self._m_refresh = reg.counter(
                "crane_fit_refresh_total",
                "Fit-tracker requested-column refreshes by kind.",
                ("kind",),
            )
            self._m_nodes = reg.gauge(
                "crane_fit_tracked_nodes",
                "Nodes with reported allocatable under fit accounting.",
            )
            self._m_dirty_rows = reg.counter(
                "crane_dirty_rows_total",
                "Rows patched via the dirty-name journal instead of a "
                "full identity sweep, by consumer",
                ("consumer",),
            )

    # -- refresh -----------------------------------------------------------

    def refresh(self) -> None:
        """Bring the columns up to date with the mirror (version-gated)."""
        with self._lock:
            nv = self._cluster.node_version
            pv = self._cluster.pod_version
            if nv != self._node_ver:
                dirty = None
                if self._names and self._node_ver >= 0:
                    dirty = self._cluster.dirty_nodes_since(self._node_ver)
                if dirty is not None and not dirty[1]:
                    # journal-covered, membership unchanged: identity-check
                    # only the dirty names instead of every node
                    self._patch_nodes_locked(dirty[0])
                else:
                    self._rebuild_nodes_locked()
                self._node_ver = nv
            if not self._has_alloc.any():
                # nothing bounded: requested sums can't matter, so skip
                # the recount — a capacity-free cluster (the sim, parity
                # fixtures) pays two version reads per refresh, nothing
                # more. Mark the columns dirty for when allocatable
                # first appears.
                self._req_dirty = True
                self._pod_ver = pv
                return
            if pv == self._pod_ver and not self._req_dirty:
                return
            changed: Iterable[str] | None
            if self._req_dirty:
                changed = None
            else:
                changed = self._cluster.pod_changes_since(self._pod_ver)
            if changed is None:
                self._recount_all_locked()
                self._full_recounts += 1
                if self._telemetry is not None:
                    self._m_refresh.labels(kind="full").inc()
            else:
                for name in changed:
                    i = self._index.get(name)
                    if i is not None:
                        self._recount_node_locked(name, i)
                self._incremental_recounts += 1
                if self._telemetry is not None:
                    self._m_refresh.labels(kind="incremental").inc()
            self._req_dirty = False
            self._pod_ver = pv

    def _patch_nodes_locked(self, touched) -> None:
        """O(dirty) twin of ``_rebuild_nodes_locked``: membership is
        unchanged, so only the journal's dirty names can have a new
        allocatable object."""
        if not touched:
            return
        index = self._index
        get_node = self._cluster.get_node
        changed = 0
        for name in touched:
            i = index.get(name)
            if i is None:
                continue
            node = get_node(name)
            if node is None:
                continue
            if self._apply_alloc_locked(name, i, node):
                changed += 1
        self._node_patches += 1
        if self._telemetry is not None:
            self._m_dirty_rows.labels(consumer="fit").inc(len(touched))
        if changed:
            self.alloc_version += 1
            if self._telemetry is not None:
                self._m_nodes.set(int(self._has_alloc.sum()))

    def _apply_alloc_locked(self, name: str, i: int, node) -> bool:
        """Identity-gated allocatable row update for one node; returns
        True when the row actually changed."""
        amap = getattr(node, "allocatable", None) or None
        prev = self._alloc_maps.get(name)
        if amap is prev:
            return False  # annotation fold kept the same allocatable object
        if amap is None:
            self._alloc_maps.pop(name, None)
            self._scalar_alloc.pop(name, None)
            self._has_alloc[i] = False
            return True
        self._alloc_maps[name] = amap
        row = self._alloc[i]
        row[:] = 0
        # kubelet always reports "pods"; a fixture that omits it
        # means "don't model pod count" — fail open on that dim only
        row[_DIM_PODS] = UNBOUNDED
        scalars: dict[str, int] = {}
        for key, quantity in amap.items():
            if key == CPU:
                row[_DIM_CPU] = to_milli(quantity)
            elif key == MEMORY:
                row[_DIM_MEM] = to_value(quantity)
            elif key == EPHEMERAL_STORAGE:
                row[_DIM_EPH] = to_value(quantity)
            elif key == PODS:
                row[_DIM_PODS] = to_value(quantity)
            else:
                scalars[key] = to_value(quantity)
        if scalars:
            self._scalar_alloc[name] = scalars
        else:
            self._scalar_alloc.pop(name, None)
        self._has_alloc[i] = True
        return True

    def _rebuild_nodes_locked(self) -> None:
        nodes = self._cluster.list_nodes()
        names = [n.name for n in nodes]
        if names != self._names:
            # membership changed: rebuild index and realign requested rows
            old_index, old_req = self._index, self._req
            old_scalar_req = self._scalar_req
            self._names = names
            self._index = {name: i for i, name in enumerate(names)}
            self._has_alloc = np.zeros((len(names),), dtype=bool)
            self._alloc = np.zeros((len(names), _N_DIMS), dtype=np.int64)
            req = np.zeros((len(names), _N_DIMS), dtype=np.int64)
            stale = []
            for i, name in enumerate(names):
                j = old_index.get(name)
                if j is None:
                    stale.append((name, i))
                else:
                    req[i] = old_req[j]
            self._req = req
            self._scalar_req = {
                k: v for k, v in old_scalar_req.items() if k in self._index
            }
            self._alloc_maps = {}
            self._index_ver += 1
            self._aligned.clear()
            self.alloc_version += 1  # membership moved the capacity rows
            if not self._req_dirty:
                for name, i in stale:
                    self._recount_node_locked(name, i)
        changed = 0
        for i, node in enumerate(nodes):
            if self._apply_alloc_locked(node.name, i, node):
                changed += 1
        if changed:
            self.alloc_version += 1
        if self._telemetry is not None:
            self._m_nodes.set(int(self._has_alloc.sum()))

    def _recount_node_locked(self, name: str, i: int) -> None:
        row = np.zeros((_N_DIMS,), dtype=np.int64)
        scalars: dict[str, int] = {}
        for pod in self._cluster.list_pods(name):
            r = pod_fit_request(pod)
            row[_DIM_CPU] += r.milli_cpu
            row[_DIM_MEM] += r.memory
            row[_DIM_EPH] += r.ephemeral_storage
            row[_DIM_PODS] += 1
            for k, v in r.scalar_resources.items():
                scalars[k] = scalars.get(k, 0) + v
        self._req[i] = row
        if scalars:
            self._scalar_req[name] = scalars
        else:
            self._scalar_req.pop(name, None)

    def _recount_all_locked(self) -> None:
        self._req[:] = 0
        self._scalar_req = {}
        index = self._index
        req = self._req
        scalar_req = self._scalar_req
        for pod in self._cluster.list_pods():
            node_name = pod.node_name
            i = index.get(node_name) if node_name else None
            if i is None:
                continue
            r = pod_fit_request(pod)
            row = req[i]
            row[_DIM_CPU] += r.milli_cpu
            row[_DIM_MEM] += r.memory
            row[_DIM_EPH] += r.ephemeral_storage
            row[_DIM_PODS] += 1
            if r.scalar_resources:
                dst = scalar_req.setdefault(node_name, {})
                for k, v in r.scalar_resources.items():
                    dst[k] = dst.get(k, 0) + v

    # -- reads -------------------------------------------------------------

    def fits(self, pod: Pod, node_name: str, request: Resource | None = None):
        """Does ``pod`` fit in the node's current free allocatable?
        Returns ``(ok, reason)`` — reason mirrors NodeResourcesFit's
        ("Too many pods" / "Insufficient <resource>"). Unknown nodes and
        nodes without reported allocatable fail open."""
        if request is None:
            request = pod_fit_request(pod)
        with self._lock:
            i = self._index.get(node_name)
            if i is None or not self._has_alloc[i]:
                return True, ""
            vec = request_vec(request)
            reason = row_fail_reason(self._alloc[i] - self._req[i], vec)
            if reason:
                return False, reason
            if request.scalar_resources:
                salloc = self._scalar_alloc.get(node_name) or {}
                sused = self._scalar_req.get(node_name) or {}
                for k, v in request.scalar_resources.items():
                    if v > 0 and v > salloc.get(k, 0) - sused.get(k, 0):
                        return False, f"Insufficient {k}"
            return True, ""

    def _rows_for_locked(self, names) -> tuple[np.ndarray, np.ndarray]:
        """``(rows[N], known[N])`` aligning ``names`` with the tracker's
        columns, cached by list identity + index epoch (a caller that
        re-passes the same list object pays the O(N) dict-get gather
        once, not per call)."""
        for ent in self._aligned:
            if ent[0] is names and ent[1] == self._index_ver:
                return ent[2], ent[3]
        index = self._index
        n = len(names)
        rows = np.fromiter(
            (index.get(nm, -1) for nm in names), dtype=np.int64, count=n
        )
        known = rows >= 0
        self.mask_builds += 1
        self._aligned.append((names, self._index_ver, rows, known))
        if len(self._aligned) > 8:
            del self._aligned[0]
        return rows, known

    def fits_mask(self, names, request: Resource) -> np.ndarray:
        """Vectorized ``fits`` verdict over ``names`` — bit-identical
        per node, one broadcast instead of a per-node Python walk.
        Unknown/unreported nodes fail open (True)."""
        with self._lock:
            n = len(names)
            ok = np.ones((n,), dtype=bool)
            if not self._names or n == 0:
                return ok
            rows, known = self._rows_for_locked(names)
            bounded = np.zeros((n,), dtype=bool)
            bounded[known] = self._has_alloc[rows[known]]
            bidx = np.flatnonzero(bounded)
            if not bidx.size:
                return ok
            vec = request_vec(request)
            br = rows[bidx]
            free = self._alloc[br] - self._req[br]
            fail = ((vec > 0) & (free < vec)).any(axis=1)
            if request.scalar_resources:
                # rare path: per-name dict walk, mirroring fits()
                for j, i in enumerate(bidx):
                    if fail[j]:
                        continue
                    nm = names[i]
                    salloc = self._scalar_alloc.get(nm) or {}
                    sused = self._scalar_req.get(nm) or {}
                    for k, v in request.scalar_resources.items():
                        if v > 0 and v > salloc.get(k, 0) - sused.get(k, 0):
                            fail[j] = True
                            break
            ok[bidx] = ~fail
            return ok

    def free_matrix(self, names) -> tuple[np.ndarray, np.ndarray]:
        """Aligned ``(bounded[N] bool, free[N,4] int64)`` COPIES for a
        column cache: callers may fold their own binds into ``free``
        (subtract a request row) without touching tracker state.
        Unknown/unreported rows come back unbounded (False, zeros)."""
        with self._lock:
            n = len(names)
            bounded = np.zeros((n,), dtype=bool)
            free = np.zeros((n, _N_DIMS), dtype=np.int64)
            if not self._names or n == 0:
                return bounded, free
            rows, known = self._rows_for_locked(names)
            kr = rows[known]
            bounded[known] = self._has_alloc[kr]
            free[known] = self._alloc[kr] - self._req[kr]
            return bounded, free

    def free_copy_counts(self, names: list, request: Resource) -> np.ndarray:
        """How many copies of ``request`` fit on each node, vectorized and
        aligned with ``names`` — the gang solver's capacity row.
        Unreported/unknown nodes are UNBOUNDED; results clip to [0,
        UNBOUNDED]."""
        with self._lock:
            n = len(names)
            out = np.full((n,), UNBOUNDED, dtype=np.int64)
            if not self._names:
                return out
            rows, known = self._rows_for_locked(names)
            if not known.any():
                return out
            r = rows[known]
            bounded = self._has_alloc[r]
            if not bounded.any():
                return out
            free = self._alloc[r] - self._req[r]
            np.clip(free, 0, None, out=free)
            vec = request_vec(request)
            counts = np.full((len(r),), UNBOUNDED, dtype=np.int64)
            for d in range(_N_DIMS):
                if vec[d] > 0:
                    np.minimum(counts, free[:, d] // vec[d], out=counts)
            if request.scalar_resources:
                # rare path: walk only the known rows' scalar maps
                for j, nm_i in enumerate(r):
                    nm = self._names[nm_i]
                    salloc = self._scalar_alloc.get(nm) or {}
                    sused = self._scalar_req.get(nm) or {}
                    for k, v in request.scalar_resources.items():
                        if v > 0:
                            cap = max(0, salloc.get(k, 0) - sused.get(k, 0)) // v
                            if cap < counts[j]:
                                counts[j] = cap
            counts[~bounded] = UNBOUNDED
            out[known] = counts
            return out

    def free_for(self, node_name: str) -> dict | None:
        """Free amounts per dimension, or None when the node is unknown or
        reports no allocatable (unbounded)."""
        with self._lock:
            i = self._index.get(node_name)
            if i is None or not self._has_alloc[i]:
                return None
            free = self._alloc[i] - self._req[i]
            return {
                CPU: int(free[_DIM_CPU]),
                MEMORY: int(free[_DIM_MEM]),
                EPHEMERAL_STORAGE: int(free[_DIM_EPH]),
                PODS: int(free[_DIM_PODS]),
            }

    def stats(self) -> dict:
        with self._lock:
            return {
                "tracked_nodes": len(self._names),
                "bounded_nodes": int(self._has_alloc.sum()),
                "full_recounts": self._full_recounts,
                "incremental_recounts": self._incremental_recounts,
                "node_patches": self._node_patches,
                "alloc_version": self.alloc_version,
                "mask_builds": self.mask_builds,
            }
