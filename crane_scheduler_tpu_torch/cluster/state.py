"""In-memory cluster state: the framework's kube-apiserver stand-in.

Counterpart of ``crane_scheduler_tpu/cluster/state.py``, cut to what the
scheduling paths, the annotator, the simulator and the replication mirror
read and write: nodes with annotations, labels, addresses and
allocatable, the annotator's patch primitives (single, bulk, columnar
through a lazy overlay, and column groups), pods with containers, owner
references, init containers and overhead, as objects or as columnar
bursts, binds that stamp ``Scheduled`` events into a bounded log and
deliver them to subscribers (per event, in batches, or as columns),
PreBind's pod-annotation patch, the eviction subresource (``evict_pod``,
with its ``Evicted`` event), the mirror's bulk transactions
(``apply_node_changes``, ``replace_nodes``, ``apply_pod_changes``,
``replace_pods``) and the kube mirror's pieces (``count_pods``,
``retire_burst_rows``, ``notify=False`` binds, a watch echo shadowing its
burst row), the ``sched_version``,
``node_version``, ``node_set_version`` and ``pod_version`` counters (and
the port's own ``bound_version``, which keys the simulator's bound-count
caches), the
pod-change journal behind ``pod_changes_since``, and the global
dirty-name journal behind ``dirty_nodes_since`` (every named node write
journals its name; a name-less columnar sweep or relist resets the
floor), and the shard plane's pieces: per-shard (sched, pod, node)
fences and dirty-name journals (``configure_shards``,
``shard_versions``, ``dirty_nodes_since(version, shard)``), a sorted crc
index over the node names, and ring resharding (``reshard``), which
journals only the moved names. Every write moves the fences of the
shards that observe its node, as the reference's does; a name-less
write (relist, columnar sweep, burst bind) moves every shard's.
``node_annotations_since`` is the port's own: the kube mirror re-keys its
relist columns through it (``cluster/kube.py``).

The reference coordinates its two processes exclusively through the
Kubernetes API — the controller JSON-patches node annotations
(ref: pkg/controller/annotator/node.go:123-146) and watches ``Scheduled``
events (ref: cmd/controller/app/options/factory.go:25-33); the scheduler
plugin reads nodes from its informer snapshot. Binds here emit the same
"Successfully assigned <ns/pod> to <node>" events the reference parses.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from dataclasses import dataclass, field, replace
from types import MappingProxyType
from typing import Any, Callable, Mapping

import numpy as np

# bounded event log, as an apiserver's event TTL bounds it
_MAX_EVENTS = 4096

# bounded pod-change journal (``pod_changes_since``)
_POD_LOG_CAP = 8192

# Shared empty-mapping default of the optional resource fields: a plain
# default (not a default_factory) so every instance shares one read-only
# "not reported" map.
_EMPTY_MAP: Mapping[str, Any] = MappingProxyType({})


@dataclass(frozen=True)
class NodeAddress:
    type: str  # "InternalIP", "Hostname", ...
    address: str


@dataclass(frozen=True)
class Node:
    name: str
    annotations: Mapping[str, str] = field(default_factory=dict)
    labels: Mapping[str, str] = field(default_factory=dict)
    addresses: tuple[NodeAddress, ...] = ()
    # ``status.allocatable`` quantities (cpu/memory/pods/...), verbatim
    # wire strings. Empty = the node never reported allocatable — the fit
    # layer treats that as unknown (fail-open), not as zero.
    allocatable: Mapping[str, Any] = _EMPTY_MAP

    def internal_ip(self) -> str:
        """ref: node.go:179-187 — InternalIP, falling back to the name."""
        for addr in self.addresses:
            if addr.type == "InternalIP":
                return addr.address
        return self.name


@dataclass(frozen=True)
class OwnerReference:
    kind: str
    name: str = ""


@dataclass(frozen=True)
class ResourceRequirements:
    requests: Mapping[str, float] = field(default_factory=dict)
    limits: Mapping[str, float] = field(default_factory=dict)


@dataclass(frozen=True)
class Container:
    name: str
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)


@dataclass(frozen=True)
class Pod:
    name: str
    namespace: str = "default"
    annotations: Mapping[str, str] = field(default_factory=dict)
    owner_references: tuple[OwnerReference, ...] = ()
    containers: tuple[Container, ...] = ()
    node_name: str = ""
    # ``spec.initContainers`` / ``spec.overhead``: inputs to the kube
    # effective-request rule max(init, sum(containers)) + overhead
    init_containers: tuple[Container, ...] = ()
    overhead: Mapping[str, Any] = _EMPTY_MAP

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def is_daemonset_pod(self) -> bool:
        """ref: pkg/utils/utils.go:17-24."""
        return any(ref.kind == "DaemonSet" for ref in self.owner_references)


@dataclass(frozen=True)
class Event:
    namespace: str
    name: str
    type: str  # "Normal" | "Warning"
    reason: str
    message: str
    count: int = 1
    event_time: float = 0.0  # used when count == 0 (ref: event.go:131-137)
    last_timestamp: float = 0.0
    resource_version: int = 0


EventHandler = Callable[[Event], None]


class _PodBurst:
    """Columnar pod population: a burst of bare pods as rows, not objects.

    Names are a list, placements are one int32 column indexing a
    burst-local node table. A row becomes a real ``Pod`` object only when
    an object-path write (``add_pod``, ``bind_pods``) reaches its key.
    """

    __slots__ = ("namespace", "names", "node_ids", "table", "table_map", "dead")

    def __init__(self, namespace: str, names: list):
        self.namespace = namespace
        self.names = names
        self.node_ids = np.full((len(names),), -1, dtype=np.int32)
        self.table: list[str] = []  # burst-local node intern table
        self.table_map: dict[str, int] = {}
        self.dead: set[int] = set()  # rows materialized out

    def materialize(self, row: int) -> Pod:
        node = self.table[self.node_ids[row]] if self.node_ids[row] >= 0 else ""
        return Pod(name=self.names[row], namespace=self.namespace, node_name=node)


class _DirtyJournal:
    """Bounded (version, name, membership) journal keyed on a node
    fence. ``since(v)`` replays the tail: the set of names written
    after ``v`` plus a membership-changed flag, or ``None`` when the
    interval is not covered — a name-less bulk write (a columnar sweep)
    reset the floor, the deque overran its cap, or ``v`` predates the
    journal. ``None`` costs the caller exactly one identity sweep; every
    covered interval is O(dirty)."""

    __slots__ = ("log", "floor", "overruns", "bulk_marks")

    def __init__(self, cap: int, floor: int = 0):
        self.log: deque[tuple[int, str, bool]] = deque(maxlen=cap)
        self.floor = floor  # versions < floor are not covered
        self.overruns = 0  # cap evictions (bounded-journal overflow)
        self.bulk_marks = 0  # name-less bulk writes

    def note(self, version: int, name: str, membership: bool = False) -> None:
        log = self.log
        if len(log) == log.maxlen:
            evicted = log[0][0]
            if evicted > self.floor:
                self.floor = evicted
            self.overruns += 1
        log.append((version, name, membership))

    def mark_bulk(self, version: int) -> None:
        if version > self.floor:
            self.floor = version
        self.bulk_marks += 1
        self.log.clear()

    def since(self, version: int):
        if version < self.floor:
            return None
        names: set[str] = set()
        membership = False
        for v, name, m in self.log:
            if v > version:
                names.add(name)
                if m:
                    membership = True
        return (names, membership)


class ClusterState:
    """Thread-safe cluster model with event subscription."""

    def __init__(self, dirty_journal_cap: int = 4096):
        self._lock = threading.RLock()
        self._nodes: dict[str, Node] = {}
        # Lazy annotation overlay: columnar patches append segments
        # (names, pos, {key: values}, dead) holding the sweep's column
        # lists by reference, so a 50k-node flush is O(keys) bookkeeping.
        # ``pos`` is a name->row map cached per names-list object. Reads
        # fold lazily (list_nodes folds everything). Writes of another
        # style (add_node, delete_node, single/bulk dict patches) mark the
        # name ``dead`` in every existing segment so a stale column value
        # never shadows a newer authoritative write.
        self._anno_segments: list[
            tuple[list[str], dict[str, int], dict[str, list[str]], set]
        ] = []
        self._names_pos_cache: tuple[list[str], dict[str, int]] | None = None
        self._node_set_version = 0
        # bumps on node mutations only (membership or annotations)
        self._node_version = 0
        self._pods: dict[str, Pod] = {}
        # per-node bound-pod key index (insertion-ordered)
        self._pods_by_node: dict[str, dict[str, None]] = {}
        self._events: deque[Event] = deque(maxlen=_MAX_EVENTS)
        self._event_index: dict[str, Event] = {}
        self._event_handlers: list[EventHandler] = []
        self._batch_handlers: list[Callable[[list[Event]], None]] = []
        # batch handlers that also accept columnar delivery (parallel to
        # _batch_handlers; None = must materialize events for this one)
        self._batch_columnar: list[Callable | None] = []
        self._rv_next = 1  # next event resourceVersion
        self._sched_version = 0
        # moves whenever a node's bound-pod count may change (never on an
        # annotation patch): the key of per-sweep bound-count caches
        self._bound_version = 0
        # columnar pod bursts (see add_pod_burst)
        self._bursts: list[_PodBurst] = []
        self._burst_index: dict[str, tuple[_PodBurst, int]] | None = None
        # burst bound-pod counts, slot-interned and columnar: one growable
        # int64 array indexed by a cluster-wide name->slot map, so a
        # 100k-pod bind folds in as one vectorized fancy-index add;
        # count_pods_all reads a merged dict cached on _count_version
        self._count_slot: dict[str, int] = {}
        self._slot_names: list[str] = []
        self._count_arr = np.zeros((0,), dtype=np.int64)
        self._count_version = 0
        self._count_dict_cache: tuple | None = None
        self._table_slots_cache: tuple | None = None
        self._gather_cache: tuple | None = None
        # pod-change journal: which nodes had bound-pod or membership
        # changes, per pod_version. Annotation patches and columnar burst
        # binds leave it alone, as in the reference.
        self._pod_version = 0
        self._pod_change_log: deque[tuple[int, str]] = deque(maxlen=_POD_LOG_CAP)
        self._pod_log_floor = 0  # oldest version not fully covered
        # dirty-name journal (O(dirty) refresh): every named node write
        # appends (node_version after it, name, membership?); name-less
        # bulk writes reset the floor instead. Consumers (FitTracker,
        # DripColumns and the device column cache behind them) replay the
        # tail to patch only dirty rows; an uncovered interval costs
        # exactly one identity sweep.
        self._dirty_cap = int(dirty_journal_cap)
        self._dirty_global = _DirtyJournal(self._dirty_cap)
        # per-shard watch fences (the sharded placement plane): with a
        # layout configured, every write also bumps the fences of each
        # shard that observes the touched node, and named node writes
        # journal into those shards' dirty journals. Writes without a
        # node name (relists, sweeps, burst binds) bump every shard.
        self._shard_layout: tuple[int, float] | None = None  # (count, overlap)
        self._shard_sched: list[int] = []
        self._shard_pod: list[int] = []
        self._shard_node: list[int] = []
        self._shard_owner_cache: dict[str, tuple[int, ...]] = {}
        self._shard_dirty: list[_DirtyJournal] = []
        # pluggable keyspace (None = static crc32 modulo; a
        # ``shards.HashRing`` makes ownership dynamic, see ``reshard``)
        self._shard_keyspace = None
        # sorted (crc32, name) index over the node table, built lazily for
        # resharding: moved names are found by bisecting the moved arcs
        self._crc_index: tuple[list[int], list[str]] | None = None

    @property
    def sched_version(self) -> int:
        """Monotonic mutation counter (an informer resourceVersion
        stand-in) over changes a scheduling snapshot can observe: node
        add/delete and bound-pod add/replace/bind. Adding a pending
        (unbound) pod does NOT bump it."""
        with self._lock:
            return self._sched_version

    @property
    def bound_version(self) -> int:
        """Moves whenever a node's bound-pod count may change: a bound
        pod added, replaced or deleted (object or burst row), a bind.
        Annotation patches do not move it, so a metric sweep that reads
        ``count_pods_all`` per node can cache it across its own writes."""
        with self._lock:
            return self._bound_version

    @property
    def pod_version(self) -> int:
        """Bumps on bound-pod set/placement/annotation changes and node
        membership. Node annotation patches do not bump it."""
        with self._lock:
            return self._pod_version

    def _note_pod_change_locked(self, node_name: str) -> None:
        """Journal a bound-pod change on ``node_name`` (caller holds the
        lock)."""
        self._pod_version += 1
        log = self._pod_change_log
        if len(log) == log.maxlen:
            self._pod_log_floor = log[0][0]
        log.append((self._pod_version, node_name))
        if self._shard_layout is not None:
            self._bump_shards_locked(node_name, pod=True)

    # -- per-shard watch fences (the sharded placement plane) --------------

    def configure_shards(self, count: int, overlap: float = 0.0, layout=None) -> None:
        """Enable per-shard version fences for a ``count``-way node
        partition (``cluster.shards.shard_owners`` ownership, or a
        ``layout`` such as ``shards.HashRing`` answering ``owners(name)``).
        Each shard's (sched, pod, node) counters start at the global
        values and from then on move only when a write touches a node
        that shard observes. Reconfiguring resets the fences and the
        per-shard dirty journals."""
        if count < 1:
            raise ValueError(f"shard count must be >= 1, got {count}")
        if layout is not None and layout.count != count:
            raise ValueError(f"layout has {layout.count} shards, expected {count}")
        with self._lock:
            self._shard_layout = (int(count), float(overlap))
            self._shard_keyspace = layout
            self._shard_sched = [self._sched_version] * count
            self._shard_pod = [self._pod_version] * count
            self._shard_node = [self._node_version] * count
            self._shard_owner_cache = {}
            # fresh journals: nothing before the current fence is covered
            self._shard_dirty = [_DirtyJournal(self._dirty_cap, floor=self._node_version)
                                 for _ in range(count)]

    def shard_keyspace(self):
        """The pluggable keyspace (``shards.HashRing``), or None when
        ownership is the static crc32 modulo."""
        with self._lock:
            return self._shard_keyspace

    def shard_layout(self) -> tuple[int, float] | None:
        with self._lock:
            return self._shard_layout

    def shard_versions(self, index: int) -> tuple[int, int, int]:
        """(sched, pod, node) fence of shard ``index``; the global
        counters when no layout is configured (a view over an
        unconfigured mirror degrades to global invalidation)."""
        with self._lock:
            if self._shard_layout is None:
                return (self._sched_version, self._pod_version, self._node_version)
            return (self._shard_sched[index], self._shard_pod[index],
                    self._shard_node[index])

    def _bump_shards_locked(self, name: str | None, pod: bool = False,
                            node: bool = False, member: bool = False) -> None:
        layout = self._shard_layout
        if layout is None:
            return
        count, overlap = layout
        if name is None:
            owners = range(count)
        else:
            owners = self._shard_owner_cache.get(name)
            if owners is None:
                if self._shard_keyspace is not None:
                    owners = self._shard_keyspace.owners(name)
                else:
                    from .shards import shard_owners

                    owners = shard_owners(name, count, overlap)
                cache = self._shard_owner_cache
                if len(cache) > 2_000_000:  # churn backstop
                    cache.clear()
                cache[name] = owners
        for i in owners:
            self._shard_sched[i] += 1
            if pod:
                self._shard_pod[i] += 1
            if node:
                self._shard_node[i] += 1
                if name is None:
                    self._shard_dirty[i].mark_bulk(self._shard_node[i])
                else:
                    self._shard_dirty[i].note(self._shard_node[i], name, member)

    def pod_changes_since(self, version: int):
        """Node names with bound-pod changes after ``version``, or None
        when the journal no longer covers the interval (the caller must
        rebuild in full)."""
        with self._lock:
            if version < self._pod_log_floor:
                return None
            return {name for v, name in self._pod_change_log if v > version}

    def dirty_nodes_since(self, version: int, shard: int | None = None):
        """Replay the dirty-name journal: ``(names, membership_changed)``
        for node writes after node-fence ``version``, or None when the
        interval is not covered (a columnar sweep, a journal overrun, or a
        pre-journal version) — the caller then does exactly one identity
        sweep. ``shard`` selects that shard's journal (keyed on its node
        fence) when a layout is configured."""
        with self._lock:
            if shard is not None and self._shard_layout is not None:
                return self._shard_dirty[shard].since(version)
            return self._dirty_global.since(version)

    def dirty_journal_stats(self) -> dict:
        """Journal health for telemetry, over the global and per-shard
        journals: cap overruns, name-less bulk floor resets, and the
        deepest current depth."""
        with self._lock:
            js = [self._dirty_global] + list(self._shard_dirty)
            return {
                "overruns": sum(j.overruns for j in js),
                "bulk_marks": sum(j.bulk_marks for j in js),
                "depth": max(len(j.log) for j in js),
                "cap": self._dirty_cap,
            }

    def forget_dirty_names(self) -> None:
        """Drop dirty-name coverage exactly as a name-less bulk write
        does: the floor moves to the current fence, so the next consumer
        refresh pays the one identity-sweep fallback. A hook for measuring
        that fallback against the O(dirty) path in one process."""
        with self._lock:
            self._dirty_global.mark_bulk(self._node_version)
            for i, j in enumerate(self._shard_dirty):
                j.mark_bulk(self._shard_node[i])

    def _note_dirty_locked(self, version: int, name: str, member: bool = False) -> None:
        self._dirty_global.note(version, name, member)

    # -- dynamic resharding (consistent-hash ring keyspace) ----------------

    def _ensure_crc_index_locked(self):
        """Sorted (crc32, name) parallel lists over the node table, built
        once and then kept up to date by node adds and deletes, so a
        reshard finds the names inside the moved arcs by bisecting."""
        idx = self._crc_index
        if idx is None:
            from .shards import name_point

            pairs = sorted((name_point(name), name) for name in self._nodes)
            idx = ([p for p, _ in pairs], [n for _, n in pairs])
            self._crc_index = idx
        return idx

    def _crc_index_add_locked(self, name: str) -> None:
        idx = self._crc_index
        if idx is None:
            return
        from .shards import name_point

        point = name_point(name)
        crcs, names = idx
        i = bisect.bisect_left(crcs, point)
        # same-crc collisions: names stay sorted within the run
        while i < len(crcs) and crcs[i] == point and names[i] < name:
            i += 1
        if i < len(crcs) and crcs[i] == point and names[i] == name:
            return
        crcs.insert(i, point)
        names.insert(i, name)

    def _crc_index_remove_locked(self, name: str) -> None:
        idx = self._crc_index
        if idx is None:
            return
        from .shards import name_point

        point = name_point(name)
        crcs, names = idx
        i = bisect.bisect_left(crcs, point)
        while i < len(crcs) and crcs[i] == point:
            if names[i] == name:
                del crcs[i]
                del names[i]
                return
            i += 1

    def _names_in_arcs_locked(self, arcs) -> list[str]:
        """Names whose hash lies inside any ``(lo, hi]`` ring arc (lo > hi
        wraps around zero)."""
        crcs, names = self._ensure_crc_index_locked()
        out: list[str] = []
        for lo, hi in arcs:
            if lo <= hi:
                out.extend(names[bisect.bisect_right(crcs, lo):bisect.bisect_right(crcs, hi)])
            else:  # wraparound arc
                out.extend(names[bisect.bisect_right(crcs, lo):])
                out.extend(names[:bisect.bisect_right(crcs, hi)])
        return out

    def reshard(self, target) -> list[str]:
        """Swap the ring keyspace for ``target`` (a ``shards.HashRing``
        with the same shard count), migrating only the moved names: each
        name whose observation set changed gets a membership-dirty journal
        entry (and fence bumps) on its old and new owners, so incremental
        consumers add or drop exactly those rows. The live ring object is
        updated in place, so every view holding it reads the new
        ownership at once. Returns the moved names."""
        with self._lock:
            ring = self._shard_keyspace
            if ring is None or self._shard_layout is None:
                raise ValueError(
                    "reshard requires a HashRing keyspace "
                    "(configure_shards(..., layout=HashRing(...)))"
                )
            if target.count != ring.count:
                raise ValueError(
                    f"reshard cannot change the shard count in place "
                    f"({ring.count} -> {target.count}); reconfigure the "
                    f"plane instead"
                )
            cache = self._shard_owner_cache
            moved: list[str] = []
            for name in self._names_in_arcs_locked(ring.moved_arcs(target)):
                old_owners = ring.owners(name)
                new_owners = target.owners(name)
                if old_owners == new_owners:
                    continue
                moved.append(name)
                cache.pop(name, None)
                self._sched_version += 1
                self._node_version += 1
                self._note_dirty_locked(self._node_version, name, True)
                for i in set(old_owners) | set(new_owners):
                    self._shard_sched[i] += 1
                    self._shard_node[i] += 1
                    self._shard_dirty[i].note(self._shard_node[i], name, True)
            ring.adopt(target)
            return moved

    @property
    def node_set_version(self) -> int:
        """Bumps only on node add/delete, not on annotation patches."""
        with self._lock:
            return self._node_set_version

    @property
    def node_version(self) -> int:
        """Bumps on any node change (membership or annotations) and on
        nothing else."""
        with self._lock:
            return self._node_version

    # -- nodes -------------------------------------------------------------

    def _drop_overlay_locked(self, name: str) -> None:
        """A newer authoritative write for ``name`` supersedes every
        existing segment's values for it; later segments apply again."""
        for seg in self._anno_segments:
            seg[3].add(name)

    def _pos_for_locked(self, names: list[str]) -> dict[str, int]:
        cache = self._names_pos_cache
        if cache is None or cache[0] is not names:
            # keyed on object identity; the strong ref keeps the id stable
            cache = (names, {n: i for i, n in enumerate(names)})
            self._names_pos_cache = cache
        return cache[1]

    def _merged_annotations_locked(self, node: Node):
        """Node's annotations with the overlay applied; the node's own
        mapping when the overlay has nothing for it."""
        merged = None
        name = node.name
        for _names, pos, cols, dead in self._anno_segments:
            if name in dead:
                continue
            i = pos.get(name)
            if i is None:
                continue
            if merged is None:
                merged = dict(node.annotations)
            for key, values in cols.items():
                merged[key] = values[i]
        return merged if merged is not None else node.annotations

    def _fold_overlay_locked(self) -> None:
        """Materialize every overlay segment into the node objects (paid
        once per full read instead of every flush)."""
        if not self._anno_segments:
            return
        segments, self._anno_segments = self._anno_segments, []
        nodes = self._nodes
        for name, node in nodes.items():
            anno = None
            for _names, pos, cols, dead in segments:
                if name in dead:
                    continue
                i = pos.get(name)
                if i is None:
                    continue
                if anno is None:
                    anno = dict(node.annotations)
                for key, values in cols.items():
                    anno[key] = values[i]
            if anno is not None:
                nodes[name] = replace(node, annotations=anno)

    def add_node(self, node: Node) -> None:
        with self._lock:
            prev = self._nodes.get(node.name)
            # the incoming object is authoritative: stale overlay values
            # must not shadow it
            self._drop_overlay_locked(node.name)
            self._nodes[node.name] = node
            self._sched_version += 1
            self._node_version += 1
            member = prev is None
            self._note_dirty_locked(self._node_version, node.name, member)
            self._bump_shards_locked(node.name, node=True, member=member)
            if member:
                self._crc_index_add_locked(node.name)
            # annotation-only updates must not defeat (name, ip) pair
            # caches keyed on node_set_version
            if prev is None or prev.addresses != node.addresses:
                self._node_set_version += 1
            if prev is None:
                self._note_pod_change_locked(node.name)  # new node row

    def delete_node(self, name: str) -> None:
        with self._lock:
            existed = name in self._nodes
            if existed:
                self._note_pod_change_locked(name)
            self._nodes.pop(name, None)
            self._drop_overlay_locked(name)
            self._sched_version += 1
            self._node_version += 1
            self._note_dirty_locked(self._node_version, name, existed)
            self._node_set_version += 1
            self._bump_shards_locked(name, node=True, member=existed)
            self._shard_owner_cache.pop(name, None)
            if existed:
                self._crc_index_remove_locked(name)

    def get_node(self, name: str) -> Node | None:
        with self._lock:
            node = self._nodes.get(name)
            if node is None or not self._anno_segments:
                return node
            merged = self._merged_annotations_locked(node)
            if merged is node.annotations:
                return node
            # fold this node so repeated reads stay cheap
            node = replace(node, annotations=merged)
            self._nodes[name] = node
            self._drop_overlay_locked(name)
            return node

    def list_nodes(self) -> list[Node]:
        with self._lock:
            self._fold_overlay_locked()
            return list(self._nodes.values())

    def node_names(self) -> list[str]:
        with self._lock:
            return list(self._nodes)

    def has_node(self, name: str) -> bool:
        """Membership test without materializing the node (the dirty
        journal consumers' add/remove classifier)."""
        with self._lock:
            return name in self._nodes

    # -- bulk transactions (relist / coalesced delta apply) ----------------
    #
    # A relist or a replication frame lands here as ONE transaction: one
    # lock hold and a single sched_version bump per batch.
    # node_set_version tracks membership/address identity (bumped once per
    # batch when any changed); pod_version journals per-node membership
    # changes for the incremental NUMA path, which needs every entry.

    def _apply_node_change_locked(self, change_type: str, node: Node):
        """One watch-shaped node change (caller holds the lock). Returns
        ``(set_changed, member)``: whether the node SET (membership or
        addresses) changed, and whether the NAME set changed (the
        narrower membership bit the dirty journal carries)."""
        name = node.name
        if change_type == "DELETED":
            existed = name in self._nodes
            if existed:
                self._note_pod_change_locked(name)
                self._crc_index_remove_locked(name)
            self._nodes.pop(name, None)
            self._drop_overlay_locked(name)
            self._sched_version += 1
            self._bump_shards_locked(name, node=True, member=existed)
            return True, existed
        prev = self._nodes.get(name)
        self._drop_overlay_locked(name)
        self._nodes[name] = node
        self._sched_version += 1
        member = prev is None
        self._bump_shards_locked(name, node=True, member=member)
        if member:
            self._note_pod_change_locked(name)
            self._crc_index_add_locked(name)
        return member or prev.addresses != node.addresses, member

    def apply_node_changes(self, changes) -> None:
        """Coalesced apply: an ordered batch of ``(change_type, Node)``
        pairs (DELETED removes, anything else add/replaces) as one
        transaction — one lock hold, one sched_version bump, one
        node_version bump journaling every changed name."""
        with self._lock:
            v0 = self._sched_version
            set_changed = False
            dirty: list[tuple[str, bool]] = []
            for change_type, node in changes:
                changed, member = self._apply_node_change_locked(
                    change_type, node
                )
                if changed:
                    set_changed = True
                dirty.append((node.name, member))
            if self._sched_version > v0:
                self._sched_version = v0 + 1
                self._node_version += 1
                v = self._node_version
                for name, member in dirty:
                    self._note_dirty_locked(v, name, member)
            if set_changed:
                self._node_set_version += 1

    def replace_nodes(self, nodes) -> None:
        """Relist apply: every listed node is added/updated and nodes
        absent from the list are pruned, as ONE transaction with a
        single sched_version bump (a relist is semantically one
        snapshot, however many rows it carries). The new node table is
        built directly (a duplicate listing keeps the last entry, like
        sequential adds); the dirty journal's floor moves to the new
        fence, as for any name-less bulk write."""
        nodes = list(nodes)
        with self._lock:
            current = self._nodes
            new = {node.name: node for node in nodes}
            added = [name for name in new if name not in current]
            deleted = []
            if len(current) - (len(new) - len(added)):
                deleted = [name for name in current if name not in new]
            set_changed = bool(added or deleted)
            if not set_changed:
                # same membership: addresses are the remaining way the
                # node SET can have changed
                get = current.get
                for name, node in new.items():
                    if get(name).addresses != node.addresses:
                        set_changed = True
                        break
            for name in added:
                self._note_pod_change_locked(name)
            for name in deleted:
                self._note_pod_change_locked(name)
            # every listed name is replaced and the rest are pruned, so
            # clearing the overlay IS the per-name tombstone sweep
            self._anno_segments.clear()
            self._nodes = new
            self._sched_version += 1
            self._node_version += 1
            self._dirty_global.mark_bulk(self._node_version)
            if set_changed:
                self._crc_index = None  # rebuilt lazily at the next reshard
            self._bump_shards_locked(None, node=True)  # relist: every fence
            if set_changed:
                self._node_set_version += 1

    def apply_pod_changes(self, changes) -> None:
        """Pod twin of ``apply_node_changes`` (same event order and
        per-pod semantics as add_pod/delete_pod, one transaction)."""
        with self._lock:
            v0 = self._sched_version
            for change_type, pod in changes:
                if change_type == "DELETED":
                    self._delete_pod_locked(pod.key())
                else:
                    self._add_pod_locked(pod)
            if self._sched_version > v0:
                self._sched_version = v0 + 1

    def replace_pods(self, pods) -> None:
        """Pod twin of ``replace_nodes`` (burst rows the server no longer
        lists are retired too, like delete_pod would)."""
        pods = list(pods)
        with self._lock:
            v0 = self._sched_version
            for pod in pods:
                self._add_pod_locked(pod)
            live = {p.key() for p in pods}
            stale = [k for k in self._pods if k not in live]
            if self._bursts:
                stale += [
                    p.key() for p in self._burst_pods_locked(None)
                    if p.key() not in live
                ]
            for key in stale:
                self._delete_pod_locked(key)
            if self._sched_version > v0:
                self._sched_version = v0 + 1

    def node_annotations_since(self, version: int):
        """``(node_version, {name: annotations})`` for every node the
        dirty-name journal records after node-fence ``version``, read in
        one lock hold; None when the journal does not cover the interval
        or a name joined or left the node set. The port's own: the kube
        mirror patches its relist columns with it
        (``KubeClusterClient.node_annotation_columns``)."""
        with self._lock:
            dirty = self._dirty_global.since(version)
            if dirty is None or dirty[1]:
                return None
            out = {}
            for name in dirty[0]:
                node = self._nodes.get(name)
                if node is None:
                    return None
                out[name] = self._merged_annotations_locked(node)
            return self._node_version, out

    def patch_node_annotation(self, name: str, key: str, value: str) -> bool:
        """The annotator's write primitive: one (node, key) annotation.
        The node's map is replaced, so ``bulk_ingest``'s identity skip
        sees the change."""
        with self._lock:
            node = self._nodes.get(name)
            if node is None:
                return False
            anno = dict(self._merged_annotations_locked(node))
            anno[key] = value
            self._drop_overlay_locked(name)
            self._nodes[name] = replace(node, annotations=anno)
            self._sched_version += 1
            self._node_version += 1
            self._note_dirty_locked(self._node_version, name)
            self._bump_shards_locked(name, node=True)
            return True

    def patch_node_annotations_bulk(self, per_node: Mapping[str, Mapping[str, str]]) -> int:
        """Batch annotation patch: one lock hold and one new map per node
        for a whole sweep's writes. Returns the patched count; missing
        nodes are skipped like ``patch_node_annotation``'s False."""
        patched = 0
        with self._lock:
            nodes = self._nodes
            has_overlay = bool(self._anno_segments)
            patched_names: list[str] = []
            for name, kv in per_node.items():
                node = nodes.get(name)
                if node is None:
                    continue
                if has_overlay:
                    anno = dict(self._merged_annotations_locked(node))
                    self._drop_overlay_locked(name)
                else:
                    anno = dict(node.annotations)
                anno.update(kv)
                nodes[name] = replace(node, annotations=anno)
                self._sched_version += 1
                self._bump_shards_locked(name, node=True)
                patched += 1
                patched_names.append(name)
            if patched:
                self._node_version += 1
                v = self._node_version
                for name in patched_names:
                    self._note_dirty_locked(v, name)
        return patched

    def patch_node_annotations_columns(
        self, names: list[str], columns: Mapping[str, list[str]]
    ) -> int:
        """Columnar batch patch: every column in ``columns`` is aligned
        with ``names``. Lands in the lazy overlay as an O(keys) segment
        append or merge; readers fold it. Returns the submitted row count;
        rows for unknown nodes are dropped at fold time."""
        with self._lock:
            segments = self._anno_segments
            if segments and segments[-1][0] is names and not segments[-1][3]:
                # steady state: same names object, no tombstones
                segments[-1][2].update(columns)
            else:
                segments.append((names, self._pos_for_locked(names), dict(columns), set()))
                if len(segments) > 8:
                    # churning node sets or tombstones: bound the read cost
                    self._fold_overlay_locked()
            self._sched_version += len(names)
            self._node_version += 1
            # the sweep rewrites every listed row: journal coverage would be
            # the whole cluster, so reset the floor instead
            self._dirty_global.mark_bulk(self._node_version)
            self._bump_shards_locked(None, node=True)  # sweep: every fence
        return len(names)

    def patch_node_annotation_groups(self, groups) -> int:
        """Apply several aligned column groups (``[(names, {key:
        values}), ...]``), each as an overlay segment."""
        patched = 0
        for names, columns in groups:
            patched += self.patch_node_annotations_columns(names, columns)
        return patched

    # -- pods --------------------------------------------------------------

    def _index_remove(self, pod: Pod) -> None:
        if pod.node_name:
            keys = self._pods_by_node.get(pod.node_name)
            if keys is not None:
                keys.pop(pod.key(), None)
                if not keys:
                    del self._pods_by_node[pod.node_name]

    def _index_add(self, pod: Pod) -> None:
        if pod.node_name:
            self._pods_by_node.setdefault(pod.node_name, {})[pod.key()] = None

    def _shadow_burst_locked(self, key: str) -> bool:
        """An object pod added under a live burst key replaces the row
        (add_pod's replace semantics; a kube watch echo of a created pod
        lands here). Returns True when the retired row was bound: the
        caller counts that as replacing a bound pod."""
        hit = self._burst_lookup_locked(key)
        if hit is None:
            return False
        burst, row = hit
        was_bound = int(burst.node_ids[row]) >= 0
        self._burst_retire_row_locked(burst, row)
        if self._burst_index is not None:
            self._burst_index.pop(key, None)
        return was_bound

    def _add_pod_locked(self, pod: Pod) -> None:
        """Add or replace (caller holds the lock): shadow any live burst
        row, replace the object entry; replacing a bound pod, object or
        burst row, counts as a bound-pod change."""
        key = pod.key()
        prev_burst_bound = self._shadow_burst_locked(key) if self._bursts else False
        prev = self._pods.get(key)
        if prev is not None:
            self._index_remove(prev)
        self._pods[key] = pod
        self._index_add(pod)
        if pod.node_name or (prev is not None and prev.node_name) or prev_burst_bound:
            self._sched_version += 1
            self._bound_version += 1
        # journal only real changes: re-adding an identical bound pod
        # leaves pod_version where it was
        same = (
            prev is not None
            and prev.node_name == pod.node_name
            and prev.annotations == pod.annotations
            and prev.containers == pod.containers
            and prev.init_containers == pod.init_containers
            and prev.overhead == pod.overhead
        )
        if pod.node_name and not same:
            self._note_pod_change_locked(pod.node_name)
        if prev is not None and prev.node_name and prev.node_name != pod.node_name:
            self._note_pod_change_locked(prev.node_name)

    def add_pod(self, pod: Pod) -> None:
        with self._lock:
            self._add_pod_locked(pod)

    def add_pods(self, pods) -> None:
        """Batch ``add_pod``: one lock hold for a whole burst's pods."""
        with self._lock:
            for pod in pods:
                self._add_pod_locked(pod)

    def delete_pod(self, key: str) -> None:
        with self._lock:
            self._delete_pod_locked(key)

    def evict_pod(self, key: str, now: float | None = None) -> bool:
        """Eviction-subresource semantics for the in-memory apiserver:
        remove the pod and emit the ``Evicted`` event (the signal the
        closed placement loop observes). Returns False when the pod
        does not exist — the 404 the real subresource answers."""
        if now is None:
            now = time.time()
        with self._lock:
            pod = self._pods.get(key)
            if pod is None and self._bursts:
                hit = self._burst_lookup_locked(key)
                if hit is not None:
                    pod = hit[0].materialize(hit[1])
            if pod is None:
                return False
            node_name = pod.node_name
            self._delete_pod_locked(key)
        self.emit_event(
            Event(
                namespace=pod.namespace,
                name=f"{pod.name}.evicted",
                type="Normal",
                reason="Evicted",
                message=f"Evicted pod {key} from {node_name}",
                count=1,
                last_timestamp=now,
            )
        )
        return True

    def _delete_pod_locked(self, key: str) -> None:
        pod = self._pods.pop(key, None)
        if pod is None and self._bursts:
            hit = self._burst_lookup_locked(key)
            if hit is not None:
                burst, row = hit
                pod = burst.materialize(row)
                self._burst_retire_row_locked(burst, row)
                self._burst_index.pop(key, None)
                # a burst row's delete moves no pod_version, as in the
                # reference (burst rows are outside the journal)
                if pod.node_name:
                    self._sched_version += 1
                    self._bound_version += 1
                    self._bump_shards_locked(None, pod=True)
                return
        if pod is not None:
            self._index_remove(pod)
        if pod is not None and pod.node_name:
            self._sched_version += 1
            self._bound_version += 1
            self._note_pod_change_locked(pod.node_name)

    def get_pod(self, key: str) -> Pod | None:
        with self._lock:
            pod = self._pods.get(key)
            if pod is None and self._bursts:
                hit = self._burst_lookup_locked(key)
                if hit is not None:
                    return hit[0].materialize(hit[1])
            return pod

    def list_pods(self, node_name: str | None = None) -> list[Pod]:
        """Every pod, or the pods bound to ``node_name`` (object pods in
        insertion order, then burst rows)."""
        with self._lock:
            if node_name is None:
                out = list(self._pods.values())
            else:
                keys = self._pods_by_node.get(node_name)
                out = [self._pods[k] for k in keys] if keys else []
            if self._bursts:
                out.extend(self._burst_pods_locked(node_name))
            return out

    def _burst_pods_locked(self, node_name: str | None) -> list[Pod]:
        """Materialize burst rows (all, or those bound to ``node_name``)."""
        out: list[Pod] = []
        for b in self._bursts:
            if node_name is None:
                rows = (r for r in range(len(b.names)) if r not in b.dead)
            else:
                tid = b.table_map.get(node_name)
                if tid is None:
                    continue
                rows = (int(r) for r in np.nonzero(b.node_ids == tid)[0]
                        if int(r) not in b.dead)
            out.extend(b.materialize(r) for r in rows)
        return out

    def count_pods(self, node_name: str) -> int:
        """Bound pods on ``node_name``, O(1) through the per-node index."""
        with self._lock:
            keys = self._pods_by_node.get(node_name)
            count = len(keys) if keys else 0
            burst_counts = self._burst_counts_locked()
            if burst_counts:
                count += burst_counts.get(node_name, 0)
            return count

    def count_pods_all(self) -> dict[str, int]:
        """Bound-pod counts for every node (object pods and burst rows)."""
        with self._lock:
            counts = {name: len(keys) for name, keys in self._pods_by_node.items()}
            burst_counts = self._burst_counts_locked()
            if burst_counts:
                for name, c in burst_counts.items():
                    counts[name] = counts.get(name, 0) + c
            return counts

    def patch_pod_annotation(self, key: str, anno_key: str, value: str) -> bool:
        """PreBind's write primitive (ref: noderesourcetopology/binder.go:
        19-65). A burst row materializes first; on a bound pod the write
        bumps ``sched_version`` and journals the pod's node, since the
        topology-result annotation feeds NUMA usage reconstruction."""
        with self._lock:
            pod = self._pods.get(key)
            if pod is None and self._bursts:
                hit = self._burst_lookup_locked(key)
                if hit is not None:
                    pod = self._materialize_out_locked(*hit)
            if pod is None:
                return False
            anno = dict(pod.annotations)
            anno[anno_key] = value
            self._pods[key] = replace(pod, annotations=anno)
            if pod.node_name:
                self._sched_version += 1
                self._note_pod_change_locked(pod.node_name)
            return True

    def bind_pod(self, pod_key: str, node_name: str, now: float | None = None) -> bool:
        """Bind one pod and stamp its ``Scheduled`` event (``bind_pods``
        is the single implementation)."""
        return bool(self.bind_pods(((pod_key, node_name),), now))

    def bind_pods(self, assignments, now: float | None = None,
                  notify: bool = True) -> list[str]:
        """Batch bind: one lock hold moves every pod and stamps its
        ``Scheduled`` event, then handlers run outside the lock in bind
        order — the same pods, events, order and feedback as binding one
        pod at a time. ``assignments`` is a ``{pod_key: node_name}``
        mapping (or iterable of pairs); returns the keys actually bound
        (missing pods are skipped).

        ``notify=False`` applies the placements without recording or
        delivering events: the kube mirror's optimistic apply, whose
        authoritative events arrive through the watch."""
        if now is None:
            now = time.time()
        items = assignments.items() if hasattr(assignments, "items") else assignments
        bound: list[str] = []
        stamped: list[Event] = []
        with self._lock:
            pods = self._pods
            for pod_key, node_name in items:
                pod = pods.get(pod_key)
                if pod is None:
                    hit = self._burst_lookup_locked(pod_key)
                    if hit is None:
                        continue
                    pod = self._materialize_out_locked(*hit)
                self._index_remove(pod)
                new_pod = replace(pod, node_name=node_name)
                pods[pod_key] = new_pod
                self._index_add(new_pod)
                self._sched_version += 1
                self._bound_version += 1
                self._note_pod_change_locked(node_name)
                bound.append(pod_key)
                if not notify:
                    continue
                event = Event(
                    namespace=pod.namespace,
                    name=f"{pod.name}.scheduled",
                    type="Normal",
                    reason="Scheduled",
                    message=f"Successfully assigned {pod_key} to {node_name}",
                    count=1,
                    last_timestamp=now,
                    resource_version=self._next_rv(),
                )
                self._events.append(event)
                self._event_index[f"{event.namespace}/{event.name}"] = event
                stamped.append(event)
            handlers = list(self._event_handlers)
            batch_handlers = list(self._batch_handlers)
        for event in stamped:
            for handler in handlers:
                handler(event)
        if stamped:
            for handler in batch_handlers:
                handler(stamped)
        return bound

    # -- columnar pod bursts -----------------------------------------------
    #
    # A burst of bare pods lives as rows (names + one int32 placement
    # column), not 100k Python objects. A bind is one array transaction,
    # and only the bounded event log's tail becomes Event objects.

    def add_pod_burst(self, namespace: str, names: list) -> _PodBurst:
        """Create a columnar burst of bare pending pods. Names must be
        unique within the namespace like any pod key."""
        burst = _PodBurst(namespace, list(names))
        with self._lock:
            self._bursts.append(burst)
            index = self._burst_index
            if index is not None:
                # extend the existing index instead of invalidating it —
                # a rebuild walks every live row of every burst
                ns = burst.namespace
                for row, name in enumerate(burst.names):
                    index[f"{ns}/{name}"] = (burst, row)
        return burst

    def _burst_lookup_locked(self, key: str):
        if not self._bursts:
            return None
        index = self._burst_index
        if index is None:
            index = {}
            for b in self._bursts:
                ns = b.namespace
                dead = b.dead
                for row, name in enumerate(b.names):
                    if row not in dead:
                        index[f"{ns}/{name}"] = (b, row)
            self._burst_index = index
        return index.get(key)

    def _burst_retire_row_locked(self, burst: _PodBurst, row: int) -> None:
        """Mark a row dead, keeping the bound counts true. A fully dead
        burst is dropped."""
        burst.dead.add(row)
        tid = int(burst.node_ids[row])
        if tid >= 0:
            slot = self._count_slot.get(burst.table[tid])
            if slot is not None and self._count_arr[slot] > 0:
                self._count_arr[slot] -= 1
            self._count_version += 1
        if len(burst.dead) == len(burst.names):
            self._bursts.remove(burst)

    def _materialize_out_locked(self, burst: _PodBurst, row: int) -> Pod:
        """Copy-on-write: move a burst row into the object world."""
        pod = burst.materialize(row)
        self._burst_retire_row_locked(burst, row)
        if self._burst_index is not None:
            self._burst_index.pop(pod.key(), None)
        self._pods[pod.key()] = pod
        self._index_add(pod)
        return pod

    def retire_burst_rows(self, burst: _PodBurst, rows) -> None:
        """Remove burst rows entirely (pod creations an apiserver
        refused): marked dead, dropped from the key index, invisible to
        every read."""
        with self._lock:
            ns = burst.namespace
            for row in rows:
                self._burst_retire_row_locked(burst, row)
                if self._burst_index is not None:
                    self._burst_index.pop(f"{ns}/{burst.names[row]}", None)

    def _count_slots_for_locked(self, table: list) -> np.ndarray:
        """Slot indices for a node table, cached on the table OBJECT
        (bursts over one snapshot share one table); assigns new slots and
        grows the count array as needed."""
        cache = self._table_slots_cache
        if cache is not None and cache[0] is table and len(cache[1]) == len(table):
            return cache[1]
        slot = self._count_slot
        names_by_slot = self._slot_names
        out = np.empty((len(table),), dtype=np.int64)
        for j, name in enumerate(table):
            s = slot.get(name)
            if s is None:
                s = slot[name] = len(names_by_slot)
                names_by_slot.append(name)
            out[j] = s
        if len(self._count_arr) < len(names_by_slot):
            grown = np.zeros((len(names_by_slot),), dtype=np.int64)
            grown[: len(self._count_arr)] = self._count_arr
            self._count_arr = grown
        self._table_slots_cache = (table, out)
        return out

    def _burst_counts_locked(self) -> dict[str, int] | None:
        """Bound-pod counts of live burst rows as a dict, rebuilt lazily
        from the slot array and cached on the counts version."""
        if not self._bursts:
            return None
        cache = self._count_dict_cache
        if cache is None or cache[0] != self._count_version:
            arr = self._count_arr
            names_by_slot = self._slot_names
            merged = {names_by_slot[i]: int(arr[i]) for i in np.nonzero(arr)[0].tolist()}
            cache = (self._count_version, merged)
            self._count_dict_cache = cache
        return cache[1]

    def bound_counts_for(self, names: list) -> np.ndarray:
        """Vectorized bound-pod counts aligned with ``names`` (object
        pods + burst rows): one gather through a per-``names``-object
        cached slot index. ``names`` is treated as a stable, immutable
        list (callers pass a cached table)."""
        with self._lock:
            out = np.zeros((len(names),), dtype=np.int64)
            pbn = self._pods_by_node
            if pbn:
                get = pbn.get
                out += np.fromiter(
                    (len(get(n) or ()) for n in names),
                    dtype=np.int64, count=len(names),
                )
            if self._bursts and len(self._count_arr):
                cache = self._gather_cache
                n_slots = len(self._count_slot)
                if (cache is None or cache[0] is not names
                        or cache[1] != n_slots):
                    sget = self._count_slot.get
                    idx = np.fromiter(
                        (sget(n, -1) for n in names),
                        dtype=np.int64, count=len(names),
                    )
                    cache = (names, n_slots, idx)
                    self._gather_cache = cache
                idx = cache[2]
                valid = idx >= 0
                out[valid] += self._count_arr[idx[valid]]
            return out

    def bind_burst(self, burst: _PodBurst, node_table, node_idx, now=None,
                   notify: bool = True):
        """Columnar bind: row ``i`` -> ``node_table[node_idx[i]]`` (``-1``
        leaves the row pending). One lock transaction applies the whole
        column and stamps ``sched_version`` and resourceVersions exactly
        as per-pod ``bind_pods`` would; Event objects are built only for
        the bounded log's tail (the deque would evict the rest) and for
        subscribers without columnar support, and columnar subscribers get
        ``(node_table, node_idx_bound, now)`` outside the lock. Returns
        the bound row indices (ascending = event order). Like the
        reference, it leaves ``pod_version`` and the pod-change journal
        alone: burst rows are bare pods. ``notify=False`` records and
        delivers no event (the kube mirror's optimistic apply; the
        apiserver's events arrive through the watch)."""
        if now is None:
            now = time.time()
        node_idx = np.asarray(node_idx, dtype=np.int32)
        with self._lock:
            table_map = burst.table_map
            table = burst.table
            slots_key = None
            if not table_map:
                # first bind of the burst (the common case): adopt the
                # whole node table at C speed; a size mismatch means
                # duplicate names, which take the dedup loop below
                table_map.update(zip(node_table, range(len(node_table))))
                if len(table_map) == len(node_table):
                    table.extend(node_table)
                    remap = np.arange(len(node_table), dtype=np.int32)
                    # table contents == node_table: key the slot cache on
                    # the caller's table object, shared across bursts
                    slots_key = node_table
                else:
                    table_map.clear()
            if slots_key is None:
                remap = np.empty((len(node_table),), dtype=np.int32)
                for j, name in enumerate(node_table):
                    tid = table_map.get(name)
                    if tid is None:
                        tid = table_map[name] = len(table)
                        table.append(name)
                    remap[j] = tid
                slots_key = table
            eligible = (node_idx >= 0) & (burst.node_ids[: len(node_idx)] == -1)
            if burst.dead:
                dead_rows = np.fromiter(burst.dead, dtype=np.int64)
                eligible[dead_rows[dead_rows < len(eligible)]] = False
            rows = np.nonzero(eligible)[0]
            bound_idx = node_idx[rows]
            burst.node_ids[rows] = remap[bound_idx]
            n = len(rows)
            # slots are unique per table, so the fancy-index += is exact
            bc = np.bincount(remap[bound_idx], minlength=len(table))
            slots = self._count_slots_for_locked(slots_key)  # may grow the array
            self._count_arr[slots] += bc
            self._count_version += 1
            self._sched_version += n
            self._bound_version += 1
            # burst binds skip the pod journal; the shard fences cannot
            # attribute them, so every fence moves
            self._bump_shards_locked(None, pod=True)
            rv_base = self._rv_next
            self._rv_next += n
            if notify:
                handlers = list(self._event_handlers)
                batch = list(zip(self._batch_handlers, self._batch_columnar))
            else:
                handlers, batch = [], []
            need_full = bool(handlers) or any(c is None for _, c in batch)
            # materialize the log tail (the deque would evict everything
            # older), or everything when a subscriber needs Event objects
            maxlen = self._events.maxlen
            if not notify:
                first = n  # no local events: the server's arrive instead
            elif need_full:
                first = 0
            else:
                first = max(0, n - maxlen)
            tail_events: list[Event] = []
            ns = burst.namespace
            names = burst.names
            for k in range(first, n):
                pod_name = names[int(rows[k])]
                # raw construction: field-identical to Event(...) without
                # the frozen-dataclass __init__, which costs milliseconds
                # over a 4096-event tail
                ev = object.__new__(Event)
                ev.__dict__.update(
                    namespace=ns,
                    name=f"{pod_name}.scheduled",
                    type="Normal",
                    reason="Scheduled",
                    message=(
                        f"Successfully assigned {ns}/{pod_name} "
                        f"to {node_table[int(bound_idx[k])]}"
                    ),
                    count=1,
                    event_time=0.0,
                    last_timestamp=now,
                    resource_version=rv_base + k,
                )
                tail_events.append(ev)
            for ev in tail_events[-maxlen:] if need_full else tail_events:
                self._events.append(ev)
                self._event_index[f"{ev.namespace}/{ev.name}"] = ev
        if n:
            for ev in tail_events if need_full else ():
                for handler in handlers:
                    handler(ev)
            for handler, columnar in batch:
                if columnar is not None:
                    columnar(node_table, bound_idx, now)
                elif tail_events:
                    handler(tail_events)
        return rows

    # -- events ------------------------------------------------------------

    def _next_rv(self) -> int:
        v = self._rv_next
        self._rv_next = v + 1
        return v

    def _record_event_locked(self, event: Event) -> Event:
        """Stamp + append + index an event; the recording invariant lives
        only here (callers hold the lock)."""
        event = replace(event, resource_version=self._next_rv())
        self._events.append(event)
        self._event_index[f"{event.namespace}/{event.name}"] = event
        return event

    def emit_event(self, event: Event) -> None:
        with self._lock:
            event = self._record_event_locked(event)
            handlers = list(self._event_handlers)
            batch_handlers = list(self._batch_handlers)
        for handler in handlers:
            handler(event)
        single = [event]
        for handler in batch_handlers:
            handler(single)

    def emit_events(self, events) -> None:
        """Batched emit: stamp + record every event under ONE lock hold,
        then deliver — per-event handlers in order, batch handlers once
        with the whole list (a ``bind_pods``-shaped delivery)."""
        events = list(events)
        if not events:
            return
        with self._lock:
            stamped = [self._record_event_locked(e) for e in events]
            handlers = list(self._event_handlers)
            batch_handlers = list(self._batch_handlers)
        for event in stamped:
            for handler in handlers:
                handler(event)
        for handler in batch_handlers:
            handler(stamped)

    def get_event(self, key: str) -> Event | None:
        with self._lock:
            return self._event_index.get(key)

    def list_events(self) -> list[Event]:
        with self._lock:
            return list(self._events)

    def subscribe_events(self, handler: EventHandler) -> None:
        """Informer-style subscription (new events only, like a watch)."""
        with self._lock:
            self._event_handlers.append(handler)

    def subscribe_events_batch(
        self,
        handler: Callable[[list[Event]], None],
        columnar: Callable | None = None,
    ) -> None:
        """Like ``subscribe_events`` but delivered in bursts: a single
        emit arrives as a 1-element list, ``bind_pods`` delivers the
        whole burst in one call (event order preserved).

        ``columnar``: optional fast-path alternative for columnar binds
        (``bind_burst``) — called as ``columnar(node_table, node_idx,
        ts)`` instead of materializing one Event per pod for ``handler``.
        Subscribers without it still get full Event lists."""
        with self._lock:
            self._batch_handlers.append(handler)
            self._batch_columnar.append(columnar)
