"""Sharded placement plane: N drip schedulers over node shards.

Counterpart of ``crane_scheduler_tpu/framework/shardplane.py``. The
schedulers are the port's drip ``Scheduler``; each one's batched window
runs on its own device (``Scheduler(device=...)``), or, with ``mesh=``,
tiles its columns over that placement mesh (the shard-parallel window).

One scheduler over 250k nodes pays O(cluster) per column rebuild and
serializes every bind through one loop. This module splits the node
keyspace into ``count`` deterministic shards (``cluster.shards``) and
runs one unmodified ``framework.Scheduler`` per shard over a
``ShardView`` of the cluster mirror — the view narrows ``list_nodes()``
to the shard's nodes and swaps the version properties for the mirror's
per-shard watch fences (``ClusterState.configure_shards``), so each
scheduler's drip columns are 1/N-sized, rebuild only when ITS shard is
dirtied, and its snapshot cache survives the other schedulers' binds.

Concurrency is optimistic, Omega/Agon-style (arxiv 2109.00665):
schedulers place over possibly-stale shared state and validate at
commit. Two mechanisms:

* **Pod claims** (``BindArbiter``): an atomic first-writer-wins claim
  per pod key taken BEFORE the binding POST. Whatever pod sets two
  schedulers race for (overlapping queues, requeues, recovery replays),
  exactly one POST ever leaves the process — the stub's per-pod
  ``bind_posts == 1`` oracle is enforced here, not hoped for.
* **Version-stamp windows**: the dispatch window re-reads its shard's
  pod_version fence after the kernel and before the POSTs
  (``Scheduler.conflict_retry``). A competing binder moving a co-owned
  node (overlapping shards) bumps the fence of every observing shard,
  the window detects the mismatch against the fit-column stamp — the
  same pre -> pre+1 discipline the single-scheduler fold path already
  uses — and drops-and-retries the pods at queue position over rebuilt
  columns.

Placement is restricted to the shard's own nodes (the view filters
them); the documented tradeoff (doc/sharding.md) is that a pod handed
to shard i is placed on the best node IN shard i, not the global best.
Disjoint shards maximize throughput; overlap trades conflict retries
for a wider choice of nodes on the boundary.

Conflicts are counted per outcome in ``crane_shard_conflicts_total``:
``stale_window`` (fence moved pre-POST, window retried), ``claim_lost``
(another scheduler claimed the pod first; no POST), ``bind_failed``
(claim released after a failed write so the pod stays bindable).
"""

from __future__ import annotations

import threading

from ..cluster.shards import RingRebalancer, ShardSpec

__all__ = ["BindArbiter", "ShardView", "ShardedPlacementPlane"]


class BindArbiter:
    """Atomic per-pod bind claims shared by every scheduler in the
    plane. ``claim`` is first-writer-wins and idempotent for the
    holder; ``release`` returns the pod to the pool (failed POST)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._claims: dict[str, int] = {}
        self.contested = 0  # claim() calls that lost

    def claim(self, pod_key: str, owner: int) -> bool:
        with self._lock:
            cur = self._claims.setdefault(pod_key, owner)
            if cur == owner:
                return True
            self.contested += 1
            return False

    def release(self, pod_key: str, owner: int) -> None:
        with self._lock:
            if self._claims.get(pod_key) == owner:
                del self._claims[pod_key]

    def holder(self, pod_key: str) -> int | None:
        with self._lock:
            return self._claims.get(pod_key)

    def __len__(self) -> int:
        with self._lock:
            return len(self._claims)


class ShardView:
    """One shard's window onto a cluster mirror (ClusterState or
    KubeClusterClient): per-shard version fences, shard-filtered
    ``list_nodes``, claim-guarded binds. Everything else delegates to
    the wrapped cluster, so ``Scheduler``, ``DripColumns`` and
    ``FitTracker`` run over a view unchanged."""

    def __init__(self, cluster, spec: ShardSpec, arbiter: BindArbiter | None = None,
                 conflict_cb=None, bind_cb=None):
        self._inner = cluster
        self.spec = spec
        self._arbiter = arbiter
        self._nodes_cache: tuple[int, list] | None = None
        self._member: set[str] | None = None  # observed names (live set)
        self._member_key = None  # (node_set_version, ring version) at rehash
        self._pos: dict[str, int] | None = None  # name -> row (lazy)
        self.rehashes = 0  # full crc refilters (regression gate)
        self.incremental_refreshes = 0  # journal-driven cache patches
        self.conflicts: dict[str, int] = {}
        self._conflict_cb = conflict_cb
        self._bind_cb = bind_cb

    # -- per-shard fences --------------------------------------------------

    @property
    def sched_version(self) -> int:
        return self._inner.shard_versions(self.spec.index)[0]

    @property
    def pod_version(self) -> int:
        return self._inner.shard_versions(self.spec.index)[1]

    @property
    def node_version(self) -> int:
        return self._inner.shard_versions(self.spec.index)[2]

    @property
    def node_set_version(self) -> int:
        # membership-vs-annotation granularity is not tracked per shard;
        # the node fence is a safe (conservative) stand-in
        return self._inner.shard_versions(self.spec.index)[2]

    # -- shard-filtered reads ----------------------------------------------

    def dirty_nodes_since(self, version: int):
        """This shard's dirty-name journal tail (see
        ``ClusterState.dirty_nodes_since``); ``version`` is a value of
        THIS view's node fence."""
        return self._inner.dirty_nodes_since(version, self.spec.index)

    def has_node(self, name: str) -> bool:
        """Observed by this shard AND present in the mirror — the
        membership test the dirty-journal consumers classify against
        (ring ownership is read live, so a reshard moves the answer)."""
        return self.spec.observes(name) and self._inner.has_node(name)

    def list_nodes(self):
        """The shard's nodes, cached on the shard node fence.

        A fence move covered by the dirty-name journal patches the
        CACHED list in place — replace dirty rows, drop names the ring
        no longer routes here, append (sorted) names it now does — so a
        named write costs O(dirty) and a reshard costs O(moved), not a
        relist plus an O(cluster) crc refilter. The full rehash runs
        only when the journal can't localize the change (bulk relist,
        overrun) and is counted in ``rehashes``. Callers get the live
        list object, same as ``ClusterState.list_nodes`` returning its
        own fresh materialization each call."""
        ver = self.node_version
        cached = self._nodes_cache
        if cached is not None and cached[0] == ver:
            return cached[1]
        if cached is not None and self._member is not None:
            dirty = self.dirty_nodes_since(cached[0])
            if dirty is not None and self._patch_cache(cached[1], dirty):
                self._nodes_cache = (ver, cached[1])
                self._member_key = self._live_member_key()
                self.incremental_refreshes += 1
                return cached[1]
        inner_nodes = self._inner.list_nodes()
        # membership is a pure function of the node NAME: on a journal
        # miss the O(cluster) crc rehash reruns only when the node set
        # or the ring actually moved; an annotation-only bulk sweep
        # reuses the member set and pays one set-membership pass
        key = self._live_member_key()
        member = self._member
        if member is None or key != self._member_key:
            observes = self.spec.observes
            member = {n.name for n in inner_nodes if observes(n.name)}
            self._member = member
            self._member_key = key
            self.rehashes += 1
        nodes = [n for n in inner_nodes if n.name in member]
        self._nodes_cache = (ver, nodes)
        self._pos = None
        return nodes

    def _live_member_key(self):
        lay = self.spec.layout
        return (self._inner.node_set_version,
                lay.version if lay is not None else 0)

    def _pos_map(self, nodes) -> dict[str, int]:
        pos = self._pos
        if pos is None:
            pos = self._pos = {n.name: i for i, n in enumerate(nodes)}
        return pos

    def _patch_cache(self, nodes, dirty) -> bool:
        """Apply a covered journal interval to the cached node list in
        place; returns False when the delta is inconsistent and the
        caller must refilter."""
        touched, membership = dirty
        if not touched:
            return True
        member = self._member
        get_node = self._inner.get_node
        if not membership:
            pos = self._pos_map(nodes)
            for nm in touched:
                if nm not in member:
                    continue  # co-owner churn outside this shard's slice
                i = pos.get(nm)
                node = get_node(nm)
                if i is None or node is None:
                    return False  # membership drifted without the flag
                nodes[i] = node
            return True
        observes = self.spec.observes
        adds: list = []
        remove_rows: list[int] = []
        pos = self._pos_map(nodes)
        for nm in touched:
            node = get_node(nm)
            present = node is not None and observes(nm)
            if present and nm not in member:
                adds.append(node)
            elif not present and nm in member:
                i = pos.get(nm)
                if i is None:
                    return False
                remove_rows.append(i)
                member.discard(nm)
            elif present:
                i = pos.get(nm)
                if i is None:
                    return False
                nodes[i] = node
        for i in sorted(remove_rows, reverse=True):
            del nodes[i]
        # sorted appends: the same splice discipline DripColumns uses,
        # so view order and column order stay in lockstep across moves
        adds.sort(key=lambda n: n.name)
        for node in adds:
            member.add(node.name)
            nodes.append(node)
        if adds or remove_rows:
            self._pos = None
        return True

    # -- claim-guarded writes ----------------------------------------------

    def note_conflict(self, outcome: str) -> None:
        self.conflicts[outcome] = self.conflicts.get(outcome, 0) + 1
        if self._conflict_cb is not None:
            self._conflict_cb(outcome)

    def bind_pod(self, pod_key: str, node_name: str, now: float | None = None) -> bool:
        arb = self._arbiter
        if arb is not None and not arb.claim(pod_key, self.spec.index):
            self.note_conflict("claim_lost")
            return False
        ok = self._inner.bind_pod(pod_key, node_name, now)
        if ok:
            if self._bind_cb is not None:
                self._bind_cb(1)
        elif arb is not None:
            arb.release(pod_key, self.spec.index)
            self.note_conflict("bind_failed")
        return ok

    def bind_pods(self, assignments, now: float | None = None):
        assignments = list(assignments)
        arb = self._arbiter
        if arb is None:
            bound = self._inner.bind_pods(assignments, now)
            if bound and self._bind_cb is not None:
                self._bind_cb(len(bound))
            return bound
        mine = []
        for key, node in assignments:
            if arb.claim(key, self.spec.index):
                mine.append((key, node))
            else:
                self.note_conflict("claim_lost")
        if not mine:
            return []
        bound = self._inner.bind_pods(mine, now)
        if len(bound) < len(mine):
            ok = set(bound)
            for key, _node in mine:
                if key not in ok:
                    arb.release(key, self.spec.index)
                    self.note_conflict("bind_failed")
        if bound and self._bind_cb is not None:
            self._bind_cb(len(bound))
        return bound

    def __getattr__(self, name):
        return getattr(self._inner, name)


class ShardedPlacementPlane:
    """Owner of the N-scheduler arrangement: configures the mirror's
    per-shard fences, builds the views and the shared bind arbiter,
    wires conflict telemetry, and (optionally) runs a threaded storm.

    ``factory(view)`` must return a fully-registered ``Scheduler`` over
    the given view (the plane flips ``conflict_retry`` on and wires
    ``conflict_cb`` afterwards); plugin sets are the caller's business.
    """

    def __init__(self, cluster, count: int, overlap: float = 0.0,
                 telemetry=None, mesh=None, layout=None):
        if count < 1:
            raise ValueError(f"scheduler count must be >= 1, got {count}")
        cluster.configure_shards(count, overlap, layout=layout)
        self.cluster = cluster
        self.count = count
        self.overlap = overlap
        self.layout = layout
        self.mesh = mesh
        self.arbiter = BindArbiter()
        self._telemetry = telemetry
        self._m_conflicts = None
        self._m_binds = None
        self._m_overruns = None
        self._overruns_seen = 0
        self._m_resharded = None
        if telemetry is not None:
            reg = telemetry.registry
            self._m_conflicts = reg.counter(
                "crane_shard_conflicts_total",
                "Optimistic bind conflicts across the shard plane",
                ("outcome",),
            )
            self._m_binds = reg.counter(
                "crane_shard_binds_total",
                "Accepted binds per shard",
                ("shard",),
            )
            reg.gauge(
                "crane_shard_schedulers",
                "Configured scheduler count in the shard plane",
            ).set(count)
            self._g_nodes = reg.gauge(
                "crane_shard_nodes",
                "Nodes observed per shard",
                ("shard",),
            )
            self._m_overruns = reg.counter(
                "crane_dirty_journal_overruns_total",
                "Dirty-name journal evictions forcing an identity sweep",
            )
            self._g_journal_depth = reg.gauge(
                "crane_dirty_journal_depth",
                "Entries currently buffered in the global dirty-name journal",
            )
            self._m_resharded = reg.counter(
                "crane_reshard_moved_names_total",
                "Node names migrated between shards by ring repartitions",
            )
        self.views = [
            ShardView(
                cluster,
                ShardSpec(i, count, overlap, layout=layout),
                self.arbiter,
                conflict_cb=self._conflict_noter(),
                bind_cb=self._bind_noter(i),
            )
            for i in range(count)
        ]
        self.schedulers: list = []

    def _conflict_noter(self):
        m = self._m_conflicts
        if m is None:
            return None
        return lambda outcome: m.labels(outcome=outcome).inc()

    def _bind_noter(self, index: int):
        m = self._m_binds
        if m is None:
            return None
        lab = m.labels(shard=str(index))
        return lambda n: lab.inc(n)

    def add_scheduler(self, factory):
        """Build one scheduler per shard via ``factory(view)`` (call
        once; returns the scheduler list)."""
        for view in self.views:
            sched = factory(view)
            sched.conflict_retry = True
            sched.conflict_cb = view.note_conflict
            if self.mesh is not None:
                sched._kernel_mesh = self.mesh
            self.schedulers.append(sched)
        return self.schedulers

    def refresh_node_gauges(self) -> None:
        if self._telemetry is None:
            return
        for view in self.views:
            self._g_nodes.labels(shard=str(view.spec.index)).set(
                len(view.list_nodes())
            )
        stats = getattr(self.cluster, "dirty_journal_stats", None)
        if stats is not None:
            s = stats()
            self._g_journal_depth.set(s["depth"])
            # counters are monotonic; the mirror reports a running
            # total, so publish only the delta since the last refresh
            new = s["overruns"] - self._overruns_seen
            if new > 0:
                self._m_overruns.inc(new)
                self._overruns_seen = s["overruns"]

    def reshard(self, target) -> list[str]:
        """Adopt ``target`` (a detached ring from ``with_moves``/
        ``split``/``merge``/a rebalancer plan) as the live keyspace.
        Migration cost is O(moved): only names whose owner set changed
        are journaled as membership-dirty on their old and new shards,
        and every view/column patches just those rows on its next
        refresh. Returns the moved names."""
        if self.layout is None:
            raise ValueError("plane was built without a ring layout")
        # the live ring object is shared by the mirror and every view's
        # spec; ClusterState.reshard atomically swaps its state in
        moved = self.cluster.reshard(target)
        if self._m_resharded is not None and moved:
            self._m_resharded.inc(len(moved))
        return moved

    def rebalance(self, skew: float = 0.25, max_moves: int = 8):
        """One rebalancer step against the observed per-shard node
        counts; adopts and returns the moved names, or ``None`` when
        the plane is already within the skew envelope."""
        if self.layout is None:
            raise ValueError("plane was built without a ring layout")
        load = {
            view.spec.index: len(view.list_nodes()) for view in self.views
        }
        plan = RingRebalancer(skew=skew, max_moves=max_moves).plan(
            self.layout, load)
        if plan is None:
            return None
        return self.reshard(plan)

    def conflict_stats(self) -> dict[str, int]:
        """Aggregate per-outcome conflict counts across all views."""
        out: dict[str, int] = {}
        for view in self.views:
            for outcome, n in view.conflicts.items():
                out[outcome] = out.get(outcome, 0) + n
        return out

    def run_storm(self, pod_lists, window: int = 32, threaded: bool = True):
        """Drive every scheduler's ``schedule_queue`` over its pod list
        (``pod_lists[i]`` goes to shard i). Threaded by default — the
        point is concurrent binders racing through the arbiter and the
        version fences; pass ``threaded=False`` for deterministic
        debugging. Returns the per-shard result lists."""
        if len(pod_lists) != len(self.schedulers):
            raise ValueError(
                f"{len(pod_lists)} pod lists for {len(self.schedulers)} schedulers"
            )
        results: list = [None] * len(self.schedulers)
        if not threaded:
            for i, (sched, pods) in enumerate(zip(self.schedulers, pod_lists)):
                results[i] = sched.schedule_queue(pods, window=window)
            return results
        errors: list = []

        def run(i, sched, pods):
            try:
                results[i] = sched.schedule_queue(pods, window=window)
            except BaseException as e:  # surfaced after join
                errors.append((i, e))

        threads = [
            threading.Thread(target=run, args=(i, s, p), daemon=True)
            for i, (s, p) in enumerate(zip(self.schedulers, pod_lists))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0][1]
        return results
