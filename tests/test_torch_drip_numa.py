"""The drip window with ``NodeResourceTopologyMatch`` (the NRT window), on
the CPU: ``Scheduler.schedule_queue`` / ``open_queue`` with Dynamic, Fit
and ``TopologyMatch`` registered take the batched window, which carries
each node's NUMA zone usage across its steps. Held against the port's
scalar loop (``columnar=False``) and the JAX package's scalar loop with
its ``TopologyMatch``, on twin clusters made from one seed (64-512 nodes,
2-4 zones per CR): every pod's node, feasible count and reason, every
result's ``scores`` (Dynamic x3 + NRT x2 of each feasible node, as its pod
saw them), every pod's annotations (the topology results as text), the
assume cache, the cluster's versions.

The worlds hold nodes with no CR, non-Static nodes, node-level awareness,
pods with no guaranteed container, aware, unaware and non-aware pods,
zones overcommitted by background results, and rows of identical nodes
whose scores tie. Tolerance: exact.
"""

import json
import random

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from crane_scheduler_tpu.fit import FitTracker, ResourceFitPlugin
from crane_scheduler_tpu.framework.scheduler import Scheduler
from crane_scheduler_tpu.plugins import DynamicPlugin
from crane_scheduler_tpu.policy import DEFAULT_POLICY
from crane_scheduler_tpu_torch.fit import FitTracker as PortFitTracker
from crane_scheduler_tpu_torch.fit import ResourceFitPlugin as PortFitPlugin
from crane_scheduler_tpu_torch.framework.scheduler import DRIP_STAGES
from crane_scheduler_tpu_torch.framework.scheduler import Scheduler as PortScheduler
from crane_scheduler_tpu_torch.parallel.mesh import make_placement_mesh
from crane_scheduler_tpu_torch.plugins import DynamicPlugin as PortDynamicPlugin
from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY as PORT_POLICY
from crane_scheduler_tpu_torch import telemetry as ptel
from crane_scheduler_tpu_torch.scorer import drip_batch as port_drip
from test_drip_columnar import METRICS, NOW, _anno, fuzz_node_specs
from test_torch_gang_queue import SIDES
from test_torch_topology import SIDES as TOPO, lister_from_crs, zone_wire

RESULT = "topology.crane.io/topology-result"
AWARE = "topology.crane.io/topology-awareness"
CPU_POLICY = "topology.crane.io/cpu-policy"
GiB = 1024**3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- twin worlds -----------------------------------------------------------------


def numa_world(seed: int, n: int, zones=(2, 3, 4), ties: int = 0):
    """Node specs, CRs and background pods. A CR's zones hold whole cores
    (2-8), and a node's allocatable CPU is their sum, so Fit's room is the
    zones' room: the plugin's greedy pack always finds a zone on a node
    Fit admits (its Score would divide by zero otherwise). One node in
    13 has no CR, one in 11 is not Static, one in 4 is single-NUMA. A
    background pod per node uses part of a zone; one node in 17 has zone 0
    overcommitted. The last ``ties`` nodes are identical and the least
    loaded: idle fresh annotations, the same CR, no background."""
    rng = random.Random(seed)
    fuzzed = fuzz_node_specs(rng, n)
    specs, crs, background = [], [], []
    for i, (name, anno, _alloc) in enumerate(fuzzed):
        twin = i >= n - ties
        if twin:
            anno = {m: _anno(0.0, 30.0) for m in METRICS}
        z = 2 if twin else rng.choice(zones)
        cores = [4] * z if twin else [rng.randrange(2, 9) for _ in range(z)]
        alloc = {"cpu": str(sum(cores)), "memory": f"{16 * z}Gi", "pods": "110"}
        specs.append((name, anno, alloc))
        if i % 13 != 7 or twin:
            crs.append({
                "name": name,
                "cpu_manager_policy": "None" if i % 11 == 3 and not twin else "Static",
                "topology_manager_policy": ("SingleNUMANodePodLevel" if i % 4 == 0
                                            and not twin else "None"),
                "zones": [zone_wire(f"numa-{j}", c * 1000, 16 * GiB, 50 * GiB)
                          for j, c in enumerate(cores)],
            })
        if twin:
            continue
        used = 5000 + 1000 * cores[0] if i % 17 == 5 else rng.choice([0, 0, 1000, 2000])
        if used:
            zone = 0 if i % 17 == 5 else rng.randrange(z)
            background.append((name, used, json.dumps(
                [{"name": f"numa-{zone}", "type": "Node",
                  "resources": {"capacity": {"cpu": f"{used}m"}}}], separators=(",", ":"))))
    return specs, crs, background


def pod(side, name, cpu_milli, aware=None, burstable=False, policy=None):
    m = SIDES[side]
    req = {"cpu": f"{cpu_milli}m", "memory": str(GiB)}
    lim = dict(req, cpu=f"{cpu_milli + 500}m") if burstable else dict(req)
    anno = {} if aware is None else {AWARE: aware}
    if policy is not None:
        anno[CPU_POLICY] = policy
    return m["Pod"](name=name, namespace="default", annotations=anno,
                    containers=(m["Container"]("c", m["ResourceRequirements"](
                        requests=req, limits=lim)),))


def pod_shapes(seed: int, count: int):
    """(cpu milli, awareness, burstable, cpu policy) per pod: whole cores
    1-4, a quarter aware, some explicitly not, some with no guaranteed
    container (limits above requests, or the cpu-policy ``none``)."""
    rng = random.Random(seed)
    out = []
    for _ in range(count):
        roll = rng.random()
        out.append((rng.choice([1000, 1000, 2000, 3000, 4000]),
                    rng.choice([None, None, "true", "false"]),
                    roll < 0.1, "none" if 0.1 <= roll < 0.15 else None))
    return out


def build(side, world, columnar=True, tie_seed=None, order=("fit", "dyn", "nrt"),
          telemetry=None):
    """A cluster holding the world and a scheduler with NodeResourcesFit,
    Dynamic x3 and NodeResourceTopologyMatch x2 registered in ``order``."""
    specs, crs, background = world
    m = SIDES[side]
    cluster = m["ClusterState"]()
    for name, anno, alloc in specs:
        cluster.add_node(m["Node"](name=name, annotations=dict(anno), allocatable=alloc))
    for name, used, raw in background:
        p = pod(side, f"bg-{name}", used)
        cluster.add_pod(type(p)(name=p.name, namespace=p.namespace, containers=p.containers,
                                annotations={RESULT: raw}, node_name=name))
    topo = TOPO[side]["plugin"].TopologyMatch(lister_from_crs(side, crs), cluster=cluster)
    if side == "jax":
        sched = Scheduler(cluster, clock=lambda: NOW, tie_break_seed=tie_seed, columnar=False)
        plugins = {"fit": ResourceFitPlugin(FitTracker(cluster)),
                   "dyn": DynamicPlugin(DEFAULT_POLICY, clock=lambda: NOW)}
    else:
        sched = PortScheduler(cluster, clock=lambda: NOW, tie_break_seed=tie_seed,
                              columnar=columnar, device="cpu", telemetry=telemetry)
        plugins = {"fit": PortFitPlugin(PortFitTracker(cluster)),
                   "dyn": PortDynamicPlugin(PORT_POLICY, clock=lambda: NOW)}
    plugins["nrt"] = topo
    weights = {"fit": 1, "dyn": 3, "nrt": 2}
    for kind in order:
        sched.register(plugins[kind], weight=weights[kind])
    return cluster, sched, topo


def observe(cluster, topo, results):
    """What the window must equal: each result's node, feasible count,
    reason and scores; every pod with its node and annotations; the
    assume cache as text; the cluster's and the cache's versions."""
    types = TOPO["port"]["types"]
    return (
        [(r.node, r.feasible, r.reason, r.scores) for r in results],
        sorted((p.key(), p.node_name, sorted(p.annotations.items()))
               for p in cluster.list_pods()),
        {k: types.zones_to_json([types.Zone.from_wire(z.to_wire()) for z in v])
         for k, v in topo.cache._topology.items()},
        (cluster.sched_version, cluster.pod_version, topo.cache.version),
    )


def run(side, world, shapes, window, columnar=True, tie_seed=None, order=("fit", "dyn", "nrt")):
    """Queue the shapes' pods and place them: the JAX package and the
    port's scalar loop one by one, the port's window ``window`` at a time
    (windows of one pod each for 1)."""
    cluster, sched, topo = build(side, world, columnar=columnar, tie_seed=tie_seed,
                                 order=order)
    pods = [pod(side, f"p{i:03d}", *shape) for i, shape in enumerate(shapes)]
    cluster.add_pods(pods)
    results = []
    if side == "jax" or not columnar:
        results = [sched.schedule_one(p) for p in pods]
    elif window == 1:
        for p in pods:
            results += sched.schedule_queue([p], window=2)
    else:
        results = sched.schedule_queue(pods, window=window)
    return observe(cluster, topo, results), sched


def windows_of(sched) -> int:
    return sched.drip_stats()["batch"]["zone_windows"]


# -- the window against both scalar loops ------------------------------------------


@pytest.mark.parametrize("window", [1, 7, 128])
@pytest.mark.parametrize("seed,n,count", [(3, 64, 300), (11, 200, 150)])
def test_numa_window_matches_scalar_and_reference(seed, n, count, window):
    world = numa_world(seed, n)
    shapes = pod_shapes(seed, count)
    want, _ = run("jax", world, shapes, window)
    scalar, _ = run("port", world, shapes, window, columnar=False)
    got, sched = run("port", world, shapes, window)
    assert scalar == want
    assert got == want
    placed = [r[0] for r in got[0]]
    assert sum(node is not None for node in placed) > 100
    stats = sched.drip_stats()
    assert windows_of(sched) == (count if window == 1 else -(-count // window))
    assert stats["batch"]["zone_results"] > 100
    if n == 64:  # the zones fill: pods cross zones, then find no room
        assert stats["batch"]["cross_zone_binds"] > 0
        assert sum(node is None for node in placed) > 10
    assert stats["fallbacks"] == {}


@pytest.mark.parametrize("order", [("nrt", "dyn", "fit"), ("dyn", "nrt")],
                         ids=["nrt_first", "no_fit"])
def test_numa_window_plugin_orders(order):
    """The filter reasons follow the registration order; without Fit the
    zones alone hold the pods back."""
    world = numa_world(5, 96)
    # without Fit a node whose zones are full still passes for a pod that
    # packs greedily (and the plugin's Score divides by zero): aware pods
    shapes = [(cpu, "true", bu, pol) for cpu, _aware, bu, pol in pod_shapes(5, 120)]
    want, _ = run("jax", world, shapes, 16, order=order)
    got, sched = run("port", world, shapes, 16, order=order)
    assert got == want
    assert windows_of(sched) == 8


def test_numa_window_ties_go_to_the_lowest_index():
    """Forty identical nodes at the end of the cluster: each pod's best
    score ties across them until their zones fill, and the window takes
    the lowest index as the scalar loop does."""
    world = numa_world(7, 120, ties=40)
    shapes = [(1000, None, False, None)] * 60 + [(2000, "true", False, None)] * 40
    want, _ = run("jax", world, shapes, 32)
    got, _ = run("port", world, shapes, 32)
    assert got == want


def test_numa_window_seeded_ties_replay_per_pod():
    """Under a seeded tie-break a window whose pods tie replays pod by pod,
    consuming the generator as the scalar loop does."""
    world = numa_world(7, 80, ties=30)
    shapes = [(1000, None, False, None)] * 40
    want, _ = run("jax", world, shapes, 8, tie_seed=42)
    got, sched = run("port", world, shapes, 8, tie_seed=42)
    assert got == want
    assert sched.drip_stats()["batch"]["replays"] > 0


def test_numa_window_fence_sees_a_bind_between_windows():
    """A pod bound outside the window, with its own topology result,
    between two offers: the open window dispatches first, the next one
    reads the node's zones again (the pod journal), as the scalar loop
    reads its snapshot."""
    world = numa_world(13, 96)
    shapes = pod_shapes(13, 60)
    out = {}
    for side, columnar in (("jax", False), ("port", False), ("port", True)):
        cluster, sched, topo = build(side, world, columnar=columnar)
        pods = [pod(side, f"p{i:03d}", *shape) for i, shape in enumerate(shapes)]
        cluster.add_pods(pods)
        names = [node.name for node in cluster.list_nodes()]
        results = []
        queue = sched.open_queue(window=8) if side == "port" and columnar else None
        for i, p in enumerate(pods):
            if queue is None:
                results.append(sched.schedule_one(p))
            else:
                queue.offer(p)
                results += queue.take_results()
            if i % 8 == 7:
                # a window just dispatched: another scheduler binds a pod
                # with its own zone result before the next one opens
                extra = pod(side, f"x{i:03d}", 2000)
                extra = type(extra)(name=extra.name, namespace=extra.namespace,
                                    containers=extra.containers, annotations={RESULT: json.dumps(
                                        [{"name": "numa-0", "type": "Node",
                                          "resources": {"capacity": {"cpu": "2000m"}}}])})
                cluster.add_pod(extra)
                cluster.bind_pod(extra.key(), names[i % len(names)], NOW)
        if queue is not None:
            queue.drain()
            results += queue.take_results()
        out[(side, columnar)] = observe(cluster, topo, results)
    assert out[("port", False)] == out[("jax", False)]
    assert out[("port", True)] == out[("jax", False)]


def test_numa_window_raises_where_the_plugin_divides_by_zero():
    """A Static node whose zones hold fractional cores: Fit admits a pod
    the floored zones cannot pack, and the plugin's Score divides by zero.
    The window replays per pod and raises at the same pod, after placing
    the pods before it as the scalar loop does."""
    crs = [{"name": "n000", "cpu_manager_policy": "Static", "topology_manager_policy": "None",
            "zones": [zone_wire("numa-0", 1500, 16 * GiB), zone_wire("numa-1", 1500, 16 * GiB)]}]
    world = ([("n000", {}, {"cpu": "3", "memory": "32Gi", "pods": "110"})], crs, [])
    shapes = [(1000, None, False, None)] * 3
    out = {}
    for side, columnar in (("jax", False), ("port", False), ("port", True)):
        cluster, sched, topo = build(side, world, columnar=columnar)
        pods = [pod(side, f"p{i}", *s) for i, s in enumerate(shapes)]
        cluster.add_pods(pods)
        with pytest.raises(ZeroDivisionError):
            if columnar:
                sched.schedule_queue(pods, window=8)
            else:
                for p in pods:
                    sched.schedule_one(p)
        out[(side, columnar)] = observe(cluster, topo, [])
    assert out[("port", True)] == out[("port", False)] == out[("jax", False)]
    assert sum(bool(node) for _key, node, _anno in out[("port", True)][1]) == 2


def test_numa_window_is_pure_until_accepted():
    """The window leaves the cluster, the cache and the host columns alone
    until its binds: a window whose pod is already assumed replays per pod
    (Reserve fails there), with the scalar loop's outcome."""
    world = numa_world(17, 64)
    shapes = pod_shapes(17, 24)
    out = {}
    for side, columnar in (("jax", False), ("port", True)):
        cluster, sched, topo = build(side, world, columnar=columnar)
        pods = [pod(side, f"p{i:03d}", *shape) for i, shape in enumerate(shapes)]
        cluster.add_pods(pods)
        z = TOPO[side]["types"].Zone(name="numa-0")
        topo.cache.assume_pod(pods[5], [z], now=NOW)
        if columnar:
            results = sched.schedule_queue(pods, window=8)
        else:
            results = [sched.schedule_one(p) for p in pods]
        out[side] = observe(cluster, topo, results)
    assert out["port"] == out["jax"]


class _ListerWithoutVersion:
    """An NRT lister that keeps no version: nothing fences a window on it."""

    def __init__(self, inner):
        self._inner = inner

    def get(self, name):
        return self._inner.get(name)


class _SubTopologyMatch(TOPO["port"]["plugin"].TopologyMatch):
    """A subclass may override any hook the window models."""


def refused_set(case, cluster, topo):
    """The (plugin, weight) pairs of a plugin set with ``TopologyMatch``
    that the NRT window does not serve, and the scheduler's mesh. The
    variants of the world's ``topo`` share its lister and assume cache."""
    tm = TOPO["port"]["plugin"].TopologyMatch
    lister, cache = topo.lister, topo.cache
    nrt = {
        "two_topology_match": [topo, tm(lister, cluster=cluster)],
        "another_cluster": [tm(lister, cluster=SIDES["port"]["ClusterState"](), cache=cache)],
        "memory_aware": [tm(lister, cluster=cluster, cache=cache,
                            topology_aware_resources=frozenset({"cpu", "memory"}))],
        "lister_without_version": [tm(_ListerWithoutVersion(lister), cluster=cluster,
                                      cache=cache)],
        "subclass": [_SubTopologyMatch(lister, cluster=cluster, cache=cache)],
    }.get(case, [topo])
    plugins = [(PortFitPlugin(PortFitTracker(cluster)), 1)]
    if case != "no_dynamic":
        plugins.append((PortDynamicPlugin(PORT_POLICY, clock=lambda: NOW), 3))
    plugins += [(p, 2) for p in nrt]
    mesh = make_placement_mesh(2, [torch.device("cpu")] * 2) if case == "two_tile_mesh" else None
    return plugins, mesh


@pytest.mark.parametrize("case", ["two_topology_match", "another_cluster", "memory_aware",
                                  "lister_without_version", "subclass", "no_dynamic",
                                  "two_tile_mesh"])
def test_numa_window_refuses_sets_it_does_not_model(case):
    """A plugin set with ``TopologyMatch`` that the window does not model
    dispatches no window: the queue places its pods one by one, as the
    port's scalar loop does."""
    world = numa_world(19, 48)
    shapes = pod_shapes(19, 40)
    out = {}
    for columnar in (False, True):
        cluster, _unused, topo = build("port", world)
        plugins, mesh = refused_set(case, cluster, topo)
        sched = PortScheduler(cluster, clock=lambda: NOW, columnar=columnar, mesh=mesh,
                              device="cpu")
        for plugin, weight in plugins:
            sched.register(plugin, weight=weight)
        pods = [pod("port", f"p{i:03d}", *shape) for i, shape in enumerate(shapes)]
        cluster.add_pods(pods)
        if columnar:
            results = sched.schedule_queue(pods, window=16)
            assert sched.drip_stats()["batch"]["dispatches"] == 0
        else:
            results = [sched.schedule_one(p) for p in pods]
        out[columnar] = observe(cluster, topo, results)
    assert out[True] == out[False]
    assert any(node is not None for node, *_rest in out[True][0])


# -- the plain window is the one it was ----------------------------------------------


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def _window_ops(fn, *args, **kwargs) -> int:
    with _CountOps() as mode:
        fn(*args, **kwargs)
    return mode.ops


def test_plain_window_records_the_same_ops():
    """The Dynamic + Fit window (drip-65k's) dispatches the PyTorch ops it
    did before the NRT window came: 20 a pod and 10 around them unseeded
    (24 and 10 seeded). On the card the unseeded window of 128 is 2,058
    device kernels."""
    n, k = 300, 128
    rng = np.random.default_rng(1)
    cols = (torch.from_numpy(rng.random(n) < 0.9), torch.from_numpy(rng.integers(0, 300, n)),
            torch.ones(n, dtype=torch.bool),
            torch.from_numpy(rng.integers(0, 10**9, (n, 4))))
    vecs = torch.from_numpy(np.tile(np.array([100, 500 << 20, 0, 1]), (k, 1)))
    active = torch.ones(k, dtype=torch.bool)
    assert _window_ops(port_drip._drip_batch, *cols, vecs, active, want_ties=False) == 20 * k + 10
    assert _window_ops(port_drip._drip_batch, *cols, vecs, active, want_ties=True) == 24 * k + 10
    # the graph key of the plain window has no zone count
    kern = port_drip.DripBatchKernel(device="cpu")
    kern.dispatch(*(c.numpy() for c in cols[:2]), cols[2].numpy(), cols[3].numpy(),
                  vecs.numpy()[:4], want_ties=False)
    assert kern.dispatches == kern.eager_windows == 1


def test_plain_window_runs_no_zone_stage():
    world = numa_world(3, 64)
    specs = world[0]
    m = SIDES["port"]
    cluster = m["ClusterState"]()
    for name, anno, alloc in specs:
        cluster.add_node(m["Node"](name=name, annotations=dict(anno), allocatable=alloc))
    sched = PortScheduler(cluster, clock=lambda: NOW, device="cpu")
    sched.register(PortFitPlugin(PortFitTracker(cluster)), weight=1)
    sched.register(PortDynamicPlugin(PORT_POLICY, clock=lambda: NOW), weight=3)
    pods = [pod("port", f"p{i}", 1000) for i in range(20)]
    cluster.add_pods(pods)
    sched.schedule_queue(pods, window=8)
    batch = sched.drip_stats()["batch"]
    assert tuple(batch["stage_seconds"]) == DRIP_STAGES
    assert batch["stage_seconds"]["drip_zone"] == 0.0
    assert (batch["zone_windows"], batch["zone_results"], batch["cross_zone_binds"]) == (0, 0, 0)
    assert batch["dispatches"] == 3


def test_numa_window_stages_spans_and_ranges():
    """The NRT window opens ``drip_zone`` between the fetch and the bind:
    a span of its own with telemetry on, a profiler range under
    ``profiler_ranges()``, and seconds in ``stage_seconds``."""
    world = numa_world(3, 64)
    tel = ptel.Telemetry()
    cluster, sched, _topo = build("port", world, telemetry=tel)
    pods = [pod("port", f"p{i:03d}", *shape) for i, shape in enumerate(pod_shapes(3, 40))]
    cluster.add_pods(pods)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with ptel.profiler_ranges():
            sched.schedule_queue(pods, window=8)
    batch = sched.drip_stats()["batch"]
    windows = batch["dispatches"]
    assert windows == batch["zone_windows"] == 5
    order = ["drip_admit", "drip_prepare", "drip_launch", "drip_wait", "drip_zone",
             "drip_bind", "drip_fold"]
    spans = sorted((e for e in tel.export_chrome_trace()["traceEvents"]
                    if e["ph"] == "X" and e["name"] in DRIP_STAGES), key=lambda e: e["ts"])
    assert [e["name"] for e in spans] == order * windows
    assert all(v > 0 for v in batch["stage_seconds"].values())
    names = [e.name for e in prof.events() if getattr(e, "is_user_annotation", False)]
    assert names.count("drip_zone") == windows
