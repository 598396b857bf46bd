"""The port's shard plane against the JAX package's.

``crane_scheduler_tpu_torch.cluster.shards`` (crc ownership, the
consistent-hash ring, the rebalancer), the per-shard fences and dirty
journals of the port's ``ClusterState`` (and their delegation through the
kube mirror), ``framework/shardplane.py`` (``BindArbiter``, ``ShardView``,
``ShardedPlacementPlane``) and ``reshard``, held to ``crane_scheduler_tpu``
on the same inputs:

- every ownership function on seeded names;
- ``shard_versions`` and every per-shard dirty set after the same
  operations, the port's own write paths (columnar bursts, watch
  shadowing, retired burst rows) included;
- the claim and stale-window retry cases of ``tests/test_shard_plane.py``;
- a ``run_storm(threaded=False)`` whose placements equal the reference's;
- ``reshard`` moving the same names, and the views' patched caches.

Equality throughout, no tolerance. The reference's drip window imports
only under the scoped ``enable_x64`` shim of ``tests/test_torch_drip.py``;
every reference ``schedule_queue`` runs inside it.
"""

import random
import signal
from types import SimpleNamespace

import numpy as np
import pytest

import crane_scheduler_tpu.cluster as ref_cluster
import crane_scheduler_tpu.cluster.shards as ref_shards
import crane_scheduler_tpu.fit as ref_fit
import crane_scheduler_tpu.framework.scheduler as ref_sched
import crane_scheduler_tpu.framework.shardplane as ref_plane
import crane_scheduler_tpu.plugins as ref_plugins
import crane_scheduler_tpu.policy as ref_policy
import crane_scheduler_tpu_torch.cluster as port_cluster
import crane_scheduler_tpu_torch.cluster.shards as port_shards
import crane_scheduler_tpu_torch.fit as port_fit
import crane_scheduler_tpu_torch.framework.scheduler as port_sched
import crane_scheduler_tpu_torch.framework.shardplane as port_plane
import crane_scheduler_tpu_torch.plugins as port_plugins
import crane_scheduler_tpu_torch.policy as port_policy
from test_drip_columnar import METRICS, NOW, _anno
from test_torch_drip import jax_drip_reference

REF = SimpleNamespace(c=ref_cluster, shards=ref_shards, fit=ref_fit, sched=ref_sched,
                      plane=ref_plane, plugins=ref_plugins, policy=ref_policy, kw={})
PORT = SimpleNamespace(c=port_cluster, shards=port_shards, fit=port_fit, sched=port_sched,
                       plane=port_plane, plugins=port_plugins, policy=port_policy,
                       kw={"device": "cpu"})
NAMES = [f"node-{i:04d}" for i in range(1500)] + [f"ip-10-0-{i}-{i * 7 % 255}" for i in range(300)]


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        raise TimeoutError("test case exceeded its 120 s limit")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


def make_pod(pkg, name, cpu_milli, mem):
    c = pkg.c
    return c.Pod(name=name, namespace="default", containers=(
        c.Container("c", c.ResourceRequirements(
            requests={"cpu": f"{cpu_milli}m", "memory": str(mem)})),))


def factory(pkg):
    def build(view):
        s = pkg.sched.Scheduler(view, clock=lambda: NOW, columnar=True, **pkg.kw)
        s.register(pkg.fit.ResourceFitPlugin(pkg.fit.FitTracker(view)), weight=1)
        s.register(pkg.plugins.DynamicPlugin(pkg.policy.DEFAULT_POLICY, clock=lambda: NOW),
                   weight=3)
        return s
    return build


def mk_cluster(pkg, n_nodes, count=None, overlap=0.0, layout=None, seed=0):
    rng = random.Random(seed)
    cluster = pkg.c.ClusterState()
    for i in range(n_nodes):
        cluster.add_node(pkg.c.Node(
            name=f"node-{i:03d}",
            annotations={m: _anno(rng.choice([0.1, 0.3, 0.5, 0.7]), 30.0) for m in METRICS},
            allocatable={"cpu": str(rng.randrange(2, 9)), "memory": "16Gi", "pods": "20"}))
    if count is not None:
        cluster.configure_shards(count, overlap, layout=layout)
    return cluster


# -- ownership -------------------------------------------------------------------


@pytest.mark.parametrize("count,overlap", [(1, 0.0), (2, 0.0), (4, 0.25), (3, 0.5), (8, 0.1)])
def test_static_ownership_equals_reference(count, overlap):
    for name in NAMES:
        assert port_shards.name_point(name) == ref_shards.name_point(name)
        assert port_shards.shard_of(name, count) == ref_shards.shard_of(name, count)
        assert port_shards.shard_owners(name, count, overlap) == \
            ref_shards.shard_owners(name, count, overlap)
    for index in range(count):
        p = port_shards.ShardSpec(index, count, overlap)
        r = ref_shards.ShardSpec(index, count, overlap)
        assert [p.observes(n) for n in NAMES] == [r.observes(n) for n in NAMES]


@pytest.mark.parametrize("count,vnodes,overlap", [(2, 16, 0.0), (4, 32, 0.0), (3, 8, 0.25)])
def test_hash_ring_equals_reference(count, vnodes, overlap):
    def drive(mod):
        ring = mod.HashRing(count, vnodes=vnodes, overlap=overlap)
        _points, owners = ring.tokens()
        moved = ring.with_moves([(i, (owners[i] + 1) % count) for i in range(0, len(owners), 5)])
        split = ring.split(0, count - 1)
        merged = ring.merge(count - 1, 0)
        again = mod.HashRing.from_spec(moved.spec_dict())
        trace = [ring.spec_dict(), moved.spec_dict(), split.spec_dict(), merged.spec_dict(),
                 again.spec_dict(), ring.load_shares(), moved.load_shares(),
                 ring.moved_arcs(moved), ring.moved_arcs(merged),
                 [ring.owners(n) for n in NAMES], [moved.owners(n) for n in NAMES],
                 [merged.owners(n) for n in NAMES]]
        plan = mod.RingRebalancer(skew=0.1, max_moves=4).plan(
            ring, {i: 100 + 40 * i for i in range(count)})
        trace.append(None if plan is None else plan.spec_dict())
        live = mod.HashRing(count, vnodes=vnodes, overlap=overlap)
        live.adopt(moved)
        trace.append((live.version, [live.owners(n) for n in NAMES[:200]]))
        return trace

    assert drive(port_shards) == drive(ref_shards)


def test_rebalancer_converges_like_reference():
    def drive(mod):
        ring = mod.HashRing(4, vnodes=32)
        names = NAMES[:1200]
        steps = []
        for _ in range(6):
            load = [0] * 4
            for n in names:
                load[ring.owners(n)[0]] += 1
            steps.append(list(load))
            plan = mod.RingRebalancer(skew=0.05, max_moves=8).plan(ring, load)
            if plan is None:
                break
            ring.adopt(plan)
        return steps

    ref = drive(ref_shards)
    assert drive(port_shards) == ref and len(ref) >= 2


def test_shard_spec_validation_equals_reference():
    for mod in (ref_shards, port_shards):
        with pytest.raises(ValueError):
            mod.ShardSpec(2, 2)
        with pytest.raises(ValueError):
            mod.ShardSpec(0, 2, overlap=1.0)
        with pytest.raises(ValueError):
            mod.HashRing(0)


# -- the per-shard fences and dirty journals ---------------------------------------


def _fence_trace(pkg, count, overlap, ring):
    """A mixed write sequence on one package's ``ClusterState``; after
    each write, every shard's (sched, pod, node) fence and the dirty set
    each shard's journal gives since the start."""
    c = pkg.c
    layout = pkg.shards.HashRing(count, vnodes=16) if ring else None
    cs = mk_cluster(pkg, 40, count, overlap, layout=layout, seed=5)
    base = [cs.shard_versions(i)[2] for i in range(count)]
    base_global = cs.node_version
    trace = []

    def snap(tag):
        trace.append((tag, [cs.shard_versions(i) for i in range(count)],
                      [cs.dirty_nodes_since(base[i], i) for i in range(count)],
                      cs.dirty_nodes_since(base_global),
                      (cs.sched_version, cs.pod_version, cs.node_version),
                      cs.dirty_journal_stats()))

    snap("start")
    cs.patch_node_annotation("node-003", METRICS[0], _anno(0.9, 10.0))
    snap("patch")
    cs.patch_node_annotations_bulk({"node-007": {METRICS[1]: _anno(0.2, 5.0)},
                                    "node-011": {METRICS[0]: _anno(0.4, 5.0)},
                                    "missing": {METRICS[0]: "x"}})
    snap("bulk")
    cs.add_node(c.Node(name="node-new", annotations={}))
    snap("add_node")
    cs.apply_node_changes([("MODIFIED", c.Node(name="node-012", annotations={"a": "1"})),
                           ("ADDED", c.Node(name="node-new2")),
                           ("DELETED", c.Node(name="node-013"))])
    snap("watch_nodes")
    pods = [make_pod(pkg, f"p{i}", 100, 1 << 20) for i in range(6)]
    cs.add_pods(pods)
    snap("pending")
    cs.bind_pods([(p.key(), f"node-{i * 5:03d}") for i, p in enumerate(pods[:4])], NOW)
    snap("bind")
    cs.patch_pod_annotation(pods[0].key(), "k", "v")
    snap("pod_anno")
    cs.add_pod(make_pod(pkg, "bound-obj", 50, 1 << 10).__class__(
        name="bound-obj", namespace="default", node_name="node-021"))
    snap("bound_add")
    cs.evict_pod(pods[1].key(), now=NOW)
    snap("evict")
    cs.delete_pod(pods[2].key())
    snap("delete_pod")
    burst = cs.add_pod_burst("burst", [f"b{i}" for i in range(10)])
    table = cs.node_names()
    cs.bind_burst(burst, table, np.array([i % 7 for i in range(8)] + [-1, -1], np.int32), NOW)
    snap("bind_burst")
    cs.delete_pod("burst/b1")  # a bound burst row
    snap("burst_delete")
    cs.retire_burst_rows(burst, [8])
    snap("retire")
    cs.add_pod(c.Pod(name="b2", namespace="burst", node_name="node-030"))  # watch shadow
    snap("shadow")
    cs.patch_node_annotations_columns(table, {METRICS[2]: [_anno(0.1, 1.0)] * len(table)})
    snap("columns")
    cs.patch_node_annotation("node-015", METRICS[0], _anno(0.6, 10.0))
    snap("patch_after_sweep")
    cs.delete_node("node-014")
    snap("delete_node")
    cs.replace_nodes([n for n in cs.list_nodes() if n.name != "node-016"])
    snap("relist")
    cs.patch_node_annotation("node-017", METRICS[0], _anno(0.6, 10.0))
    snap("patch_after_relist")
    if ring:
        _points, owners = layout.tokens()
        moved = cs.reshard(layout.with_moves([(0, (owners[0] + 1) % count),
                                              (3, (owners[3] + 1) % count)]))
        trace.append(("moved", sorted(moved)))
        snap("reshard")
    cs.forget_dirty_names()
    snap("forget")
    return trace


@pytest.mark.parametrize("count,overlap,ring", [(2, 0.0, False), (3, 0.5, False),
                                                (4, 0.0, True), (2, 0.0, True)])
def test_shard_fences_and_dirty_sets_equal_reference(count, overlap, ring):
    ref = _fence_trace(REF, count, overlap, ring)
    port = _fence_trace(PORT, count, overlap, ring)
    for r, p in zip(ref, port):
        assert p == r, r[0]
    assert len(port) == len(ref)


def test_named_write_bumps_only_observing_shards():
    cluster = mk_cluster(PORT, 24, 2)
    assert cluster.shard_layout() == (2, 0.0)
    own = {s: next(n.name for n in cluster.list_nodes()
                   if port_shards.shard_owners(n.name, 2) == (s,)) for s in (0, 1)}
    v1 = cluster.shard_versions(1)
    cluster.patch_node_annotation(own[0], METRICS[0], _anno(0.9, 10.0))
    assert cluster.shard_versions(1) == v1
    pod = make_pod(PORT, "p-fence", 100, 1 << 20)
    cluster.add_pod(pod)
    b0 = cluster.shard_versions(0)
    cluster.bind_pod(pod.key(), own[1], NOW)
    assert cluster.shard_versions(0) == b0 and cluster.shard_versions(1)[1] > v1[1]


def test_kube_mirror_delegates_the_shard_calls():
    """The kube mirror's shard calls reach its ``ClusterState`` (no
    apiserver is contacted: the mirror is filled directly)."""
    from crane_scheduler_tpu_torch.cluster.kube import KubeClusterClient

    client = KubeClusterClient("http://127.0.0.1:1")
    try:
        for i in range(30):
            client._mirror.add_node(port_cluster.Node(name=f"node-{i:03d}"))
        ring = port_shards.HashRing(2, vnodes=8)
        client.configure_shards(2, layout=ring)
        assert client.shard_layout() == (2, 0.0) and client.shard_keyspace() is ring
        v = [client.shard_versions(i)[2] for i in range(2)]
        client._mirror.patch_node_annotation("node-004", "k", "v")
        owner = ring.owners("node-004")[0]
        assert client.dirty_nodes_since(v[owner], owner) == ({"node-004"}, False)
        _p, owners = ring.tokens()
        v = [client.shard_versions(i)[2] for i in range(2)]
        target = ring.with_moves([(0, 1 - owners[0])])
        want = {f"node-{i:03d}" for i in range(30)
                if ring.owners(f"node-{i:03d}") != target.owners(f"node-{i:03d}")}
        moved = client.reshard(target)
        assert set(moved) == want
        assert [client.dirty_nodes_since(v[i], i) for i in range(2)] == [(want, bool(want))] * 2
        assert client.dirty_journal_stats()["cap"] == 4096
    finally:
        client.stop()


# -- bind arbiter and views ---------------------------------------------------------


def test_bind_arbiter_first_writer_wins():
    arb = port_plane.BindArbiter()
    assert arb.claim("default/p", 0) and arb.claim("default/p", 0)
    assert not arb.claim("default/p", 1) and arb.contested == 1
    arb.release("default/p", 1)
    assert arb.holder("default/p") == 0
    arb.release("default/p", 0)
    assert arb.holder("default/p") is None and arb.claim("default/p", 1) and len(arb) == 1


@pytest.mark.parametrize("pkg_name", ["ref", "port"])
def test_view_bind_claim_lost_posts_nothing(pkg_name):
    pkg = REF if pkg_name == "ref" else PORT
    cluster = mk_cluster(pkg, 8, 2)
    arb = pkg.plane.BindArbiter()
    view0 = pkg.plane.ShardView(cluster, pkg.shards.ShardSpec(0, 2), arb)
    view1 = pkg.plane.ShardView(cluster, pkg.shards.ShardSpec(1, 2), arb)
    pod = make_pod(pkg, "p-claim", 0, 0)
    cluster.add_pod(pod)
    node = cluster.list_nodes()[0].name
    assert view0.bind_pod(pod.key(), node, NOW)
    pre = cluster.pod_version
    assert not view1.bind_pod(pod.key(), node, NOW)
    assert cluster.pod_version == pre and view1.conflicts == {"claim_lost": 1}
    p2, p3 = make_pod(pkg, "p-b2", 0, 0), make_pod(pkg, "p-b3", 0, 0)
    cluster.add_pod(p2)
    cluster.add_pod(p3)
    assert arb.claim(p2.key(), 0)
    assert view1.bind_pods([(p2.key(), node), (p3.key(), node)], NOW) == [p3.key()]
    assert view1.conflicts["claim_lost"] == 2


def test_shard_view_filters_and_caches_like_reference():
    def drive(pkg):
        cluster = mk_cluster(pkg, 40, 2)
        views = [pkg.plane.ShardView(cluster, pkg.shards.ShardSpec(i, 2)) for i in range(2)]
        lists = [[n.name for n in v.list_nodes()] for v in views]
        first = views[0].list_nodes()
        victim = next(n for n in lists[1])
        cluster.patch_node_annotation(victim, METRICS[0], _anno(0.8, 5.0))
        same = views[0].list_nodes() is first
        lists.append([n.name for n in views[1].list_nodes()])
        return lists, same, [(v.rehashes, v.incremental_refreshes) for v in views]

    ref = drive(REF)
    assert drive(PORT) == ref
    assert set(ref[0][0]).isdisjoint(ref[0][1]) and ref[1]


# -- deterministic stale-window conflicts ------------------------------------------------


class _InterferingKernel:
    """Kernel proxy: after the real dispatch and before the scheduler's
    pre-POST fence check, a rival binds onto a node this shard observes."""

    def __init__(self, inner, rival_bind):
        self._inner = inner
        self._rival_bind = rival_bind
        self.fired = 0

    def dispatch(self, *a, **kw):
        out = self._inner.dispatch(*a, **kw)
        if self._rival_bind is not None:
            rival, self._rival_bind = self._rival_bind, None
            rival()
            self.fired += 1
        return out

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _stale_window_leg(pkg, kernel_cls):
    cluster = mk_cluster(pkg, 48, None)
    plane = pkg.plane.ShardedPlacementPlane(cluster, 2, overlap=0.5)
    sched0 = plane.add_scheduler(factory(pkg))[0]
    co_name = next(n.name for n in cluster.list_nodes()
                   if pkg.shards.shard_owners(n.name, 2, 0.5) == (0, 1))
    rival_pod = make_pod(pkg, "p-rival", 10, 1 << 10)
    cluster.add_pod(rival_pod)

    def rival():
        assert plane.views[1].bind_pod(rival_pod.key(), co_name, NOW)

    sched0._batch_kernel = _InterferingKernel(kernel_cls(**pkg.kw), rival)
    pods = [make_pod(pkg, f"p-sw{i:02d}", 20, 1 << 16) for i in range(12)]
    cluster.add_pods(pods)
    results = sched0.schedule_queue(pods, window=12)
    observed = {n.name for n in plane.views[0].list_nodes()}
    assert all(r.feasible > 0 and r.node in observed for r in results)
    return ([(r.pod_key, r.node, r.feasible) for r in results], sched0._batch_kernel.fired,
            sched0.drip_stats()["batch"]["conflicts"], dict(plane.views[0].conflicts),
            cluster.get_pod(rival_pod.key()).node_name)


def test_stale_window_drops_and_retries_at_queue_position():
    with jax_drip_reference() as ref_window:
        ref = _stale_window_leg(REF, ref_window.DripBatchKernel)
    from crane_scheduler_tpu_torch.scorer.drip_batch import DripBatchKernel

    port = _stale_window_leg(PORT, DripBatchKernel)
    assert port == ref
    assert ref[1] == 1 and ref[2] == 1 and ref[3] == {"stale_window": 1}
    assert [k for k, _n, _f in ref[0]] == [f"default/p-sw{i:02d}" for i in range(12)]


def _exhaustion_leg(pkg, kernel_cls):
    cluster = mk_cluster(pkg, 16, None)
    plane = pkg.plane.ShardedPlacementPlane(cluster, 1)
    sched = plane.add_scheduler(factory(pkg))[0]
    sched.max_window_retries = 2
    extra = iter(range(1000))

    class _AlwaysRival(_InterferingKernel):
        def dispatch(self, *a, **kw):
            out = self._inner.dispatch(*a, **kw)
            p = make_pod(pkg, f"p-x{next(extra):03d}", 1, 1 << 8)
            cluster.add_pod(p)
            assert cluster.bind_pod(p.key(), cluster.list_nodes()[0].name, NOW)
            self.fired += 1
            return out

    sched._batch_kernel = _AlwaysRival(kernel_cls(**pkg.kw), None)
    pods = [make_pod(pkg, f"p-ex{i}", 10, 1 << 10) for i in range(6)]
    cluster.add_pods(pods)
    results = sched.schedule_queue(pods, window=6)
    return ([(r.pod_key, r.node, r.feasible) for r in results],
            sched.drip_stats()["batch"]["conflicts"])


def test_stale_window_retry_exhaustion_falls_back_per_pod():
    with jax_drip_reference() as ref_window:
        ref = _exhaustion_leg(REF, ref_window.DripBatchKernel)
    from crane_scheduler_tpu_torch.scorer.drip_batch import DripBatchKernel

    port = _exhaustion_leg(PORT, DripBatchKernel)
    assert port == ref
    assert ref[1] == 3 and all(node for _k, node, _f in ref[0])


# -- the plane storm --------------------------------------------------------------


def _storm(pkg, count, overlap, ring):
    layout = pkg.shards.HashRing(count, vnodes=16, overlap=overlap) if ring else None
    cluster = mk_cluster(pkg, 60, None, seed=9)
    plane = pkg.plane.ShardedPlacementPlane(cluster, count, overlap=overlap, layout=layout)
    plane.add_scheduler(factory(pkg))
    rng = random.Random(4)
    pod_lists = [[] for _ in range(count)]
    for i in range(48):
        pod = make_pod(pkg, f"p{i:03d}", rng.randrange(50, 900), rng.randrange(1, 4) << 28)
        cluster.add_pod(pod)
        pod_lists[i % count].append(pod)
    results = plane.run_storm(pod_lists, window=8, threaded=False)
    if ring:
        _p, owners = layout.tokens()
        moved = plane.reshard(layout.with_moves([(1, (owners[1] + 1) % count)]))
        more = [[make_pod(pkg, f"q{s}{i}", 200, 1 << 28) for i in range(4)] for s in range(count)]
        for lst in more:
            cluster.add_pods(lst)
        results += plane.run_storm(more, window=4, threaded=False)
    else:
        moved = []
    for shard in range(count):
        observed = {n.name for n in plane.views[shard].list_nodes()}
        for r in results[shard]:
            assert r.node is None or r.node in observed, (shard, r.node)
    return ([[(r.pod_key, r.node, r.feasible, r.reason) for r in res] for res in results],
            plane.conflict_stats(), sorted(moved),
            sorted((p.key(), p.node_name) for p in cluster.list_pods() if p.node_name))


@pytest.mark.parametrize("count,overlap,ring", [(1, 0.0, False), (2, 0.0, False),
                                                (2, 0.25, False), (4, 0.0, True)])
def test_run_storm_placements_equal_reference(count, overlap, ring):
    with jax_drip_reference():
        ref = _storm(REF, count, overlap, ring)
    port = _storm(PORT, count, overlap, ring)
    assert port == ref
    assert sum(1 for res in ref[0] for r in res if r[1]) > 0


def test_threaded_storm_places_in_shard_with_strict_telemetry():
    from crane_scheduler_tpu_torch.telemetry import Telemetry
    from crane_scheduler_tpu_torch.telemetry.expfmt import parse_exposition

    cluster = mk_cluster(PORT, 24, None)
    tel = Telemetry()
    plane = port_plane.ShardedPlacementPlane(cluster, 2, overlap=0.25, telemetry=tel)
    plane.add_scheduler(factory(PORT))
    plane.refresh_node_gauges()
    pod_lists = [[], []]
    for i in range(40):
        pod = make_pod(PORT, f"p{i:03d}", 50, 1 << 20)
        cluster.add_pod(pod)
        pod_lists[i % 2].append(pod)
    results = plane.run_storm(pod_lists, window=8, threaded=True)
    for shard, res in enumerate(results):
        observed = {n.name for n in plane.views[shard].list_nodes()}
        assert all(r.node in observed for r in res)
    assert sum(1 for p in cluster.list_pods() if p.node_name) == 40
    fams = parse_exposition(tel.registry.render())
    for fam in ("crane_shard_conflicts_total", "crane_shard_binds_total",
                "crane_shard_schedulers", "crane_shard_nodes"):
        assert fam in fams
    assert sum(int(v) for _n, _l, v in fams["crane_shard_binds_total"]["samples"]) == 40


# -- resharding ----------------------------------------------------------------------


def _reshard_trace(pkg, vnodes, moves):
    cs = pkg.c.ClusterState()
    ring = pkg.shards.HashRing(4, vnodes=vnodes)
    plane = pkg.plane.ShardedPlacementPlane(cs, 4, layout=ring)
    for i in range(400):
        cs.add_node(pkg.c.Node(name=f"node-{i:03d}", annotations={"a": str(i)}))
    views = plane.views
    for v in views:
        v.list_nodes()
    fences = [cs.shard_versions(i)[2] for i in range(4)]
    _p, owners = ring.tokens()
    target = ring.with_moves([(i, (owners[i] + 1) % 4) for i in moves])
    moved = plane.reshard(target)
    lists = [sorted(n.name for n in v.list_nodes()) for v in views]
    cs.patch_node_annotation("node-005", "a", "patched")
    cs.delete_node("node-006")
    cs.add_node(pkg.c.Node(name="zz-new"))
    lists2 = [sorted(n.name for n in v.list_nodes()) for v in views]
    return (sorted(moved), [cs.dirty_nodes_since(fences[i], i) for i in range(4)], lists, lists2,
            [(v.rehashes, v.incremental_refreshes) for v in views], ring.version)


@pytest.mark.parametrize("vnodes,moves", [(8, [0]), (32, [0, 3, 9, 17, 22, 40, 51, 63])])
def test_reshard_moves_the_reference_names(vnodes, moves):
    ref = _reshard_trace(REF, vnodes, moves)
    port = _reshard_trace(PORT, vnodes, moves)
    assert port == ref
    assert ref[0] and all(r == 1 for r, _i in ref[4])
    # the views hold exactly the names each ring owner observes
    ring = port_shards.HashRing(4, vnodes=vnodes)
    _p, owners = ring.tokens()
    target = ring.with_moves([(i, (owners[i] + 1) % 4) for i in moves])
    names = [f"node-{i:03d}" for i in range(400)]
    assert ref[2] == [sorted(n for n in names if s in target.owners(n)) for s in range(4)]


def test_reshard_without_ring_layout_raises():
    cs = port_cluster.ClusterState()
    cs.configure_shards(2)
    with pytest.raises(ValueError):
        cs.reshard(port_shards.HashRing(2))
    cs.configure_shards(2, layout=port_shards.HashRing(2))
    with pytest.raises(ValueError):
        cs.reshard(port_shards.HashRing(3))


def test_dirty_patched_drip_columns_equal_a_rebuild():
    """After named patches and a ring move, a scheduler's dirty-patched
    drip columns equal a fresh scheduler's from-scratch build over the
    same view."""
    cluster = mk_cluster(PORT, 80, None, seed=3)
    ring = port_shards.HashRing(2, vnodes=16)
    plane = port_plane.ShardedPlacementPlane(cluster, 2, layout=ring)
    scheds = plane.add_scheduler(factory(PORT))
    pods = [make_pod(PORT, f"w{i}", 100, 1 << 20) for i in range(4)]
    cluster.add_pods(pods)
    plane.run_storm([pods[:2], pods[2:]], window=2, threaded=False)
    rng = random.Random(1)
    for step in range(6):
        name = f"node-{rng.randrange(80):03d}"
        cluster.patch_node_annotation(name, METRICS[0], _anno(rng.random(), 20.0))
        if step == 3:
            _p, owners = ring.tokens()
            plane.reshard(ring.with_moves([(2, 1 - owners[2])]))
        extra = [make_pod(PORT, f"x{step}{s}", 50, 1 << 20) for s in range(2)]
        cluster.add_pods(extra)
        plane.run_storm([[extra[0]], [extra[1]]], window=1, threaded=False)
    for view, sched in zip(plane.views, scheds):
        fresh = factory(PORT)(view)
        probe = make_pod(PORT, f"probe{view.spec.index}", 1, 1)
        cluster.add_pod(probe)
        a = sched._ensure_drip(sched._recognition())
        b = fresh._ensure_drip(fresh._recognition())
        a.ensure(NOW)
        b.ensure(NOW)
        assert a.names == b.names
        for col in ("schedulable", "weighted"):
            assert np.array_equal(getattr(a, col), getattr(b, col)), col
