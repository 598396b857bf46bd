"""The port's ``topology`` package on the CPU against the JAX package's,
case for case on twin inputs made from one seed: the helper's fit and
assign, the plugin's PreFilter, Filter, Score, Reserve, PreBind and
Unreserve, the assume cache's TTL and versions, the result-annotation
JSON, and the batched zone evaluation and copy capacity (the reference's
jitted ``_evaluate`` / ``_copies_capacity`` under the suite's x64) on
randomized zones (1-8 per node, overcommitted zones, allocatable at exact
whole cores, equal free CPU across zones, zero and all-zero requests).

Mirrors ``tests/test_topology.py`` and ``tests/test_topology_batched.py``
on the port's side. Tolerance: exact. Every output is a bool, an integer,
a status code and reason, or a JSON annotation compared as a string.
"""

import json
import random

import numpy as np
import pytest
import torch

import crane_scheduler_tpu.cluster as jc
import crane_scheduler_tpu.framework.types as jft
import crane_scheduler_tpu.topology.batched as jbatched
import crane_scheduler_tpu.topology.cache as jcache
import crane_scheduler_tpu.topology.helper as jhelper
import crane_scheduler_tpu.topology.plugin as jplugin
import crane_scheduler_tpu.topology.types as jtypes
import crane_scheduler_tpu_torch.cluster as pc
import crane_scheduler_tpu_torch.framework.types as pft
import crane_scheduler_tpu_torch.topology.batched as pbatched
import crane_scheduler_tpu_torch.topology.cache as pcache
import crane_scheduler_tpu_torch.topology.helper as phelper
import crane_scheduler_tpu_torch.topology.plugin as pplugin
import crane_scheduler_tpu_torch.topology.types as ptypes
from crane_scheduler_tpu_torch.convert import nrt_lister_from_crs

SIDES = {
    "jax": dict(cluster=jc, ft=jft, batched=jbatched, cache=jcache, helper=jhelper,
                plugin=jplugin, types=jtypes),
    "port": dict(cluster=pc, ft=pft, batched=pbatched, cache=pcache, helper=phelper,
                 plugin=pplugin, types=ptypes),
}
GiB = 1024**3
AWARENESS = (None, None, "true", "false", "1", "F", "bogus")
CPU_POLICIES = (None, None, None, "none", "exclusive", "numa", "bogus")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is faster here and leaves the
    other test workers their cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- twin builders ---------------------------------------------------------------


def lister_from_crs(side, crs):
    """The same CR mappings into either package's ``InMemoryNRTLister``:
    the port through ``convert.nrt_lister_from_crs``, the reference
    through its own types."""
    if side == "port":
        return nrt_lister_from_crs(crs)
    T = jtypes
    lister = T.InMemoryNRTLister()
    for cr in crs:
        lister.upsert(T.NodeResourceTopology(
            name=cr["name"],
            crane_manager_policy=T.CraneManagerPolicy(cr["cpu_manager_policy"],
                                                      cr["topology_manager_policy"]),
            zones=tuple(T.Zone.from_wire(z) for z in cr["zones"]),
        ))
    return lister


def zone_wire(name, cpu_milli, mem, eph=None, capacity=False):
    res = {"cpu": f"{cpu_milli}m", "memory": str(mem)}
    if eph is not None:
        res["ephemeral-storage"] = str(eph)
    return {"name": name, "type": "Node",
            "resources": {("capacity" if capacity else "allocatable"): res}}


def random_cr(rng: random.Random, name: str, z: int):
    zones = []
    for j in range(z):
        cpu = rng.choice([rng.randrange(1, 9) * 1000, rng.randrange(500, 8000)])
        zones.append(zone_wire(f"numa-{j}", cpu, rng.randrange(1, 33) * GiB,
                               rng.choice([None, rng.randrange(1, 100) * GiB])))
    return {
        "name": name,
        "cpu_manager_policy": rng.choice(["Static"] * 5 + ["None"]),
        "topology_manager_policy": rng.choice(["SingleNUMANodePodLevel", "None"]),
        "zones": zones,
    }


def random_result(rng: random.Random, z: int):
    """A topology-result annotation over some of the node's zones (a zone
    name the CR lacks now and then), or malformed JSON."""
    if rng.random() < 0.08:
        return rng.choice(["not json", "{}", "[1]", '[{"name": 3}]'])
    out = []
    for j in sorted(rng.sample(range(z + 1), rng.randrange(1, min(z + 1, 3) + 1))):
        cap = {"cpu": f"{rng.randrange(0, 9) * 1000}m"}
        if rng.random() < 0.5:
            cap["memory"] = str(rng.randrange(0, 8) * GiB)
        out.append({"name": f"numa-{j}", "type": rng.choice(["Node", "Node", "Socket"]),
                    "resources": {"capacity": cap}})
    return json.dumps(out, separators=(",", ":"))


def random_pod_spec(rng: random.Random, name: str):
    containers = []
    for i in range(rng.randrange(1, 4)):
        cpu = rng.choice([1000, 2000, 3000, 4000, 6000, 1500])
        lim = cpu if rng.random() < 0.85 else cpu + 1000
        mem = rng.randrange(1, 5) * GiB
        containers.append((f"c{i}", cpu, lim, mem))
    anno = {}
    aware = rng.choice(AWARENESS)
    if aware is not None:
        anno[jtypes.ANNOTATION_POD_TOPOLOGY_AWARENESS] = aware
    policy = rng.choice(CPU_POLICIES)
    if policy is not None:
        anno[jtypes.ANNOTATION_POD_CPU_POLICY] = policy
    return dict(name=name, containers=containers, anno=anno, ds=rng.random() < 0.08)


def make_pod(side, spec, node_name="", extra_anno=None):
    C = SIDES[side]["cluster"]
    anno = dict(spec["anno"], **(extra_anno or {}))
    kw = {}
    if spec["ds"]:
        kw["owner_references"] = (C.OwnerReference(kind="DaemonSet", name="ds"),)
    return C.Pod(
        name=spec["name"], namespace="default", annotations=anno, node_name=node_name,
        containers=tuple(
            C.Container(n, C.ResourceRequirements(
                requests={"cpu": f"{cpu}m", "memory": str(mem)},
                limits={"cpu": f"{lim}m", "memory": str(mem)}))
            for n, cpu, lim, mem in spec["containers"]),
        **kw,
    )


def status(st):
    return (st.code.name, st.reason)


# -- the plugin, one cycle at a time ----------------------------------------------


def plugin_case(rng: random.Random):
    z = rng.randrange(1, 9)
    return dict(
        z=z,
        cr=random_cr(rng, "n0", z) if rng.random() < 0.92 else None,
        tar=rng.choice([("cpu",), ("cpu", "memory"), ("memory",), ("cpu", "memory",
                                                                   "ephemeral-storage")]),
        placed=[(random_pod_spec(rng, f"placed-{i}"), random_result(rng, z)
                 if rng.random() < 0.8 else None) for i in range(rng.randrange(0, 5))],
        assumed=[rng.random() < 0.5 for _ in range(5)],
        pod=random_pod_spec(rng, "incoming"),
        unreserve=rng.random() < 0.3,
    )


def run_plugin_cycle(side, case):
    m = SIDES[side]
    C, ft, T = m["cluster"], m["ft"], m["types"]
    cluster = C.ClusterState()
    cluster.add_node(C.Node(name="n0"))
    lister = lister_from_crs(side, [case["cr"]] if case["cr"] else [])
    cache = m["cache"].PodTopologyCache(ttl_seconds=60.0)
    plugin = m["plugin"].TopologyMatch(lister, cluster=cluster,
                                       topology_aware_resources=frozenset(case["tar"]),
                                       cache=cache)
    for (spec, result), assumed in zip(case["placed"], case["assumed"]):
        extra = {T.ANNOTATION_POD_TOPOLOGY_RESULT: result} if result else None
        pod = make_pod(side, spec, node_name="n0", extra_anno=extra)
        cluster.add_pod(pod)
        if assumed and result is None:
            zones = [T.Zone("numa-0", resources=T.ZoneResourceInfo(
                capacity={"cpu": "1000m", "memory": str(GiB)}))]
            cache.assume_pod(pod, zones, now=0.0)
    pod = make_pod(side, case["pod"])
    cluster.add_pod(pod)
    state = ft.CycleState()
    out = [status(plugin.pre_filter(state, pod))]
    node_info = ft.NodeInfo(node=cluster.get_node("n0"), pods=cluster.list_pods("n0"))
    out.append(status(plugin.filter(state, pod, node_info)))
    if out[-1][0] == "SUCCESS":
        try:
            score, st = plugin.score(state, pod, "n0")
            out.append((score, status(st)))
        except ZeroDivisionError:
            # an empty greedy result (every zone full or overcommitted):
            # the score divides by len(result) as the Go plugin does, on
            # both sides
            out.append("ZeroDivisionError")
        out.append(status(plugin.reserve(state, pod, "n0")))
        out.append(status(plugin.pre_bind(state, pod, "n0")))
        if case["unreserve"]:
            plugin.unreserve(state, pod, "n0")
    s = plugin._get_state(state)
    nw = s.pod_topology_by_node.get("n0") if s else None
    out.append(None if nw is None else (nw.aware, T.zones_to_json(nw.result),
                                        [z.name for z in (nw.numa_nodes or [])]))
    out.append(dict(cluster.get_pod("default/incoming").annotations))
    out.append({k: T.zones_to_json(v) for k, v in cache._topology.items()})
    out.append((cache.version, cache.shrink_version, cluster.sched_version,
                cluster.pod_version))
    return out


@pytest.mark.parametrize("seed", range(10))
def test_plugin_cycle_matches_reference(seed):
    """PreFilter, Filter, Score, Reserve, PreBind (and now and then
    Unreserve) on one node with random zones, policies, placed pods
    (annotated, assumed or neither) and an incoming pod of random
    awareness, CPU policy and guaranteed-ness: statuses, the score, the
    node wrapper's zone result, the pod's annotations, the assume cache
    and the cluster versions are equal."""
    rng = random.Random(seed)
    for _ in range(12):
        case = plugin_case(rng)
        assert run_plugin_cycle("port", case) == run_plugin_cycle("jax", case), case


def test_prebind_patches_the_pod_and_journals_its_node():
    """``patch_pod_annotation``: a pending pod's patch moves no version; a
    bound pod's bumps ``sched_version`` and journals its node; a burst row
    materializes first; a missing pod reports False. Equal on both sides."""
    out = {}
    for side in SIDES:
        C = SIDES[side]["cluster"]
        cluster = C.ClusterState()
        cluster.add_node(C.Node(name="n0"))
        cluster.add_pod(C.Pod(name="pending"))
        cluster.add_pod(C.Pod(name="bound", node_name="n0"))
        burst = cluster.add_pod_burst("default", ["b0", "b1"])
        cluster.bind_burst(burst, ["n0"], np.array([0, 0], np.int32), now=1.0)
        v0 = cluster.pod_version
        steps = []
        for key in ("default/pending", "default/bound", "default/b1", "default/missing"):
            ok = cluster.patch_pod_annotation(key, "k", key)
            steps.append((ok, cluster.sched_version, cluster.pod_version,
                          sorted(cluster.pod_changes_since(v0) or ())))
        out[side] = (steps, sorted((p.key(), dict(p.annotations), p.node_name)
                                   for p in cluster.list_pods()))
    assert out["port"] == out["jax"]
    assert out["port"][0][1][0] and out["port"][0][3][0] is False


# -- the helper: fit, assign, zone assignment ----------------------------------------


def random_numa_node(side, rng: random.Random, j: int):
    h, T = SIDES[side]["helper"], SIDES[side]["types"]
    alloc = {"cpu": f"{rng.choice([rng.randrange(0, 9) * 1000, rng.randrange(0, 9000)])}m",
             "memory": str(rng.randrange(0, 9) * GiB)}
    if rng.random() < 0.3:
        alloc["example.com/dev"] = str(rng.randrange(0, 4))
    nn = h.NumaNode(T.Zone(f"numa-{j}", resources=T.ZoneResourceInfo(allocatable=alloc)))
    used = {"cpu": f"{rng.randrange(0, 10) * 1000}m", "memory": str(rng.randrange(0, 10) * GiB)}
    if rng.random() < 0.3:
        used["example.com/dev"] = str(rng.randrange(0, 3))
    nn.add_resource(T.ZoneResourceInfo(capacity=used))
    return nn


def random_request(side, rng: random.Random):
    r = SIDES[side]["ft"].Resource()
    if rng.random() < 0.1:
        return r  # all zero
    r.milli_cpu = rng.choice([0, 1000, 2000, 3500, 9000])
    r.memory = rng.choice([0, GiB, 3 * GiB])
    r.ephemeral_storage = rng.choice([0, 0, GiB])
    if rng.random() < 0.3:
        r.scalar_resources["example.com/dev"] = rng.randrange(0, 3)
    return r


def helper_trace(side, seed):
    h, T = SIDES[side]["helper"], SIDES[side]["types"]
    rng = random.Random(seed)
    out = []
    for _ in range(25):
        z = rng.randrange(1, 9)
        nodes = [random_numa_node(side, rng, j) for j in range(z)]
        req = random_request(side, rng)
        out.append([h.fits_request_for_numa_node(req, nn) for nn in nodes])
        rem = req.clone()
        for nn in nodes:
            res, fin = h.assign_request_for_numa_node(rem, nn)
            out.append((h.resource_list_ignore_zero(res), fin,
                        {**vars(rem), "scalar_resources": dict(rem.scalar_resources)}))
        aware = rng.random() < 0.4
        nw = h.NodeWrapper("n", list(nodes), lambda p: [], frozenset({"cpu"}), aware=aware)
        h.assign_topology_result(nw, req.clone())
        out.append((T.zones_to_json(nw.result), [nn.name for nn in nw.numa_nodes]))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_helper_fit_and_assign_match_reference(seed):
    """``fits_request_for_numa_node``, ``assign_request_for_numa_node``
    (the mutated remainder included), ``resource_list_ignore_zero`` and
    ``assign_topology_result`` on random zones with overcommit, scalar
    resources and zero requests."""
    assert helper_trace("port", seed) == helper_trace("jax", seed)


def test_pod_helpers_match_reference():
    rng = random.Random(3)
    specs = [random_pod_spec(rng, f"p{i}") for i in range(40)]
    out = {}
    for side in SIDES:
        h = SIDES[side]["helper"]
        rows = []
        for spec in specs:
            pod = make_pod(side, spec)
            idx = h.get_pod_target_container_indices(pod)
            rows.append((h.is_pod_aware_of_topology(pod.annotations),
                         h.get_pod_cpu_policy(pod.annotations), idx,
                         [h.guaranteed_cpus(c) for c in pod.containers],
                         vars(h.compute_container_specified_resource_request(
                             pod, idx, frozenset({"cpu", "memory"})))))
        out[side] = rows
    assert out["port"] == out["jax"]


# -- result annotations ------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_zones_json_round_trips_match_reference(seed):
    """``zones_to_json`` strings are equal; ``zones_from_json`` of each
    string (and of malformed ones) gives equal zones; the memoized parse
    hands out fresh dicts, so a caller's mutation does not poison the
    next parse."""
    rng = random.Random(seed)
    raws = [random_result(rng, rng.randrange(1, 9)) for _ in range(30)]
    raws += ["", "null", "[", '[{"resources": 5}]', "[[]]"]
    out = {}
    for side in SIDES:
        T = SIDES[side]["types"]
        rows = []
        for raw in raws:
            zones = T.zones_from_json(raw)
            if zones is None:
                rows.append(None)
                continue
            rows.append((T.zones_to_json(zones), [z.to_wire() for z in zones]))
            if zones and zones[0].resources is not None:
                zones[0].resources.capacity["poison"] = "1"
                again = T.zones_from_json(raw)
                assert "poison" not in again[0].resources.capacity
        out[side] = rows
    assert out["port"] == out["jax"]
    assert any(r is None for r in out["port"]) and any(r for r in out["port"])


# -- the assume cache ----------------------------------------------------------------


def test_assume_cache_ttl_and_versions_match_reference():
    """Assume, double-assume, forget (twice), TTL cleanup at explicit
    times: pod counts, ``version``, ``shrink_version`` and lookups."""
    out = {}
    for side in SIDES:
        C, T = SIDES[side]["cluster"], SIDES[side]["types"]
        cache = SIDES[side]["cache"].PodTopologyCache(ttl_seconds=10.0)
        pods = [C.Pod(name=f"p{i}") for i in range(4)]
        zones = [T.Zone("numa-0", resources=T.ZoneResourceInfo(capacity={"cpu": "1"}))]
        trace = []

        def snap():
            trace.append((cache.pod_count(), cache.version, cache.shrink_version))

        for i, pod in enumerate(pods):
            cache.assume_pod(pod, zones, now=100.0 + i)
            snap()
        with pytest.raises(KeyError):
            cache.assume_pod(pods[0], zones, now=100.0)
        snap()
        cache.forget_pod(pods[1])
        cache.forget_pod(pods[1])
        snap()
        cache.cleanup(now=105.0)
        snap()
        cache.cleanup(now=111.5)  # expires p0
        snap()
        trace.append(T.zones_to_json(cache.get_pod_topology(pods[2])))
        with pytest.raises(KeyError):
            cache.get_pod_topology(pods[0])
        cache.cleanup(now=1e9)
        snap()
        out[side] = trace
    assert out["port"] == out["jax"]
    assert out["port"][-1] == (0, 7, 3)


def test_assume_cache_cleaner_thread_stops():
    cache = pcache.PodTopologyCache(ttl_seconds=0.0)
    cache.assume_pod(pc.Pod(name="p"), [], now=0.0)
    cache.start_cleaner()
    thread = cache._cleaner
    cache.start_cleaner()  # idempotent: one thread
    assert cache._cleaner is thread and thread.is_alive() and thread.daemon
    cache.stop_cleaner()
    assert not thread.is_alive() and cache._cleaner is None


# -- the batched evaluation ------------------------------------------------------------


def batch_case(rng: random.Random, z_max: int, n: int):
    """Per node: zone allocatable (whole cores or not), used (overcommitted
    now and then), and a request; some nodes get equal free CPU on every
    zone (idle nodes tie)."""
    nodes = []
    for _ in range(n):
        z = rng.randrange(1, z_max + 1)
        tie = rng.random() < 0.25
        zones = []
        for _j in range(z):
            cpu = rng.choice([8000, 16000]) if tie else rng.choice(
                [rng.randrange(1, 17) * 1000, rng.randrange(500, 16000)])
            mem = rng.randrange(1, 65) * GiB
            eph = rng.choice([0, rng.randrange(1, 100) * GiB])
            if tie:
                used = (0, 0, 0)
            else:
                over = rng.random() < 0.15
                used = (cpu + rng.randrange(1, 3000) if over else rng.randrange(0, cpu + 1),
                        rng.randrange(0, mem + 1), rng.randrange(0, eph + 1))
            zones.append(((cpu, mem, eph), used))
        nodes.append(zones)
    return nodes


def request_case(rng: random.Random):
    kind = rng.random()
    if kind < 0.08:
        return (0, 0, 0)  # all zero: unbounded, nothing packs
    return (rng.choice([0, 1000, 2000, 3000, 5000, 12000]),
            rng.choice([0, GiB, 4 * GiB, 70 * GiB]), rng.choice([0, 0, GiB]))


def wrappers_for(side, nodes):
    h, T = SIDES[side]["helper"], SIDES[side]["types"]
    out = []
    for zones in nodes:
        nw = h.new_node_wrapper("n", frozenset({"cpu"}), [
            T.Zone(f"numa-{j}", resources=T.ZoneResourceInfo(allocatable={
                "cpu": f"{cpu}m", "memory": str(mem), "ephemeral-storage": str(eph)}))
            for j, ((cpu, mem, eph), _) in enumerate(zones)], lambda p: [])
        for nn, (_, (cu, mu, eu)) in zip(nw.numa_nodes, zones):
            nn.requested.milli_cpu, nn.requested.memory, nn.requested.ephemeral_storage = (
                cu, mu, eu)
        out.append(nw)
    return out


def resource(side, req):
    return SIDES[side]["ft"].Resource(milli_cpu=req[0], memory=req[1], ephemeral_storage=req[2])


@pytest.mark.parametrize("z_max", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", range(3))
def test_batched_evaluation_and_copies_match_reference(seed, z_max):
    """``evaluate_topology_batch`` and ``copies_capacity`` (scalar and
    per-node awareness) on 40 nodes per request: every output equals the
    reference's jitted float64 programs."""
    rng = random.Random(100 * seed + z_max)
    nodes = batch_case(rng, z_max, 40)
    aware_mask = np.array([rng.random() < 0.5 for _ in nodes])
    for _ in range(6):
        req = request_case(rng)
        out = {}
        for side in SIDES:
            b = SIDES[side]["batched"]
            kw = {"device": "cpu"} if side == "port" else {}
            ws, r = wrappers_for(side, nodes), resource(side, req)
            ev = b.evaluate_topology_batch(ws, r, **kw)
            out[side] = [np.asarray(ev.aware_fits).tolist(), np.asarray(ev.zones_used).tolist(),
                         np.asarray(ev.finished).tolist(), np.asarray(ev.scores).tolist()]
            for aware in (False, True, aware_mask):
                caps = b.copies_capacity(ws, r, aware=aware, **kw)
                out[side].append((np.asarray(caps).dtype.name, np.asarray(caps).tolist()))
        assert out["port"] == out["jax"], req


@pytest.mark.parametrize("seed", range(3))
def test_batched_evaluation_matches_scalar_helper(seed):
    """Against the port's own scalar helper: the aware fit is any zone
    fitting, zones used and the score follow ``assign_topology_result``
    (an all-zero request differs on overcommitted zones, in both
    packages: see below)."""
    rng = random.Random(7 + seed)
    nodes = batch_case(rng, 8, 30)
    for _ in range(5):
        req = request_case(rng)
        ev = pbatched.evaluate_topology_batch(wrappers_for("port", nodes),
                                              resource("port", req), device="cpu")
        for i, nw in enumerate(wrappers_for("port", nodes)):
            r = resource("port", req)
            if req == (0, 0, 0):
                # the scalar check passes an empty request outright; the
                # batched one (the reference's) still needs a zone whose
                # free is >= 0 everywhere, so overcommitted zones differ
                want_fit = any(
                    min(nn.allocatable.milli_cpu - nn.requested.milli_cpu,
                        nn.allocatable.memory - nn.requested.memory,
                        nn.allocatable.ephemeral_storage - nn.requested.ephemeral_storage) >= 0
                    for nn in nw.numa_nodes)
            else:
                want_fit = any(not phelper.fits_request_for_numa_node(r, nn)
                               for nn in nw.numa_nodes)
            assert bool(ev.aware_fits[i]) == want_fit
            phelper.assign_topology_result(nw, r.clone())
            assert int(ev.zones_used[i]) == len(nw.result)
            assert int(ev.scores[i]) == (100 // len(nw.result) if nw.result else 0)


def test_batched_edges_match_reference():
    """No wrapper, a wrapper with no zones, a one-unit request against
    zones holding billions of units (the aware sum saturates at 2^31-1 as
    XLA's int32 cast does), and whole-core boundaries (7999m and 8000m)."""
    cases = [
        ([], (1000, 0, 0)),
        ([[]], (1000, 0, 0)),
        ([[((8000, 64 * GiB, 0), (0, 0, 0))] * 2], (0, 1, 0)),
        ([[((8000, GiB, 0), (0, 0, 0)), ((7999, GiB, 0), (0, 0, 0))],
          [((16000, GiB, 0), (8000, 0, 0)), ((9000, GiB, 0), (1000, 0, 0))]], (8000, 1, 0)),
    ]
    for nodes, req in cases:
        out = {}
        for side in SIDES:
            b = SIDES[side]["batched"]
            kw = {"device": "cpu"} if side == "port" else {}
            ws = wrappers_for(side, nodes)
            ev = b.evaluate_topology_batch(ws, resource(side, req), **kw)
            out[side] = ([np.asarray(x).tolist() for x in (ev.aware_fits, ev.zones_used,
                                                           ev.finished, ev.scores)],
                         [np.asarray(b.copies_capacity(ws, resource(side, req), aware=a,
                                                       **kw)).tolist()
                          for a in (False, True)])
        assert out["port"] == out["jax"], (nodes, req)
    assert out["port"][1] == [[1, 2], [1, 2]]


def test_stranded_copies_moved_to_topology_batched():
    from crane_scheduler_tpu_torch.scorer import gang_batch

    assert gang_batch.stranded_copies is pbatched.stranded_copies
    assert "stranded_copies" in gang_batch.__all__
    args = ([3, 1, 5, 0], [1, 0, 6, 0], [1, 1, 0, 2])
    np.testing.assert_array_equal(pbatched.stranded_copies(*args),
                                  jbatched.stranded_copies(*args))


def test_entry_points_need_cuda_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ws = wrappers_for("port", [[((8000, GiB, 0), (0, 0, 0))]])
    r = resource("port", (1000, 0, 0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbatched.evaluate_topology_batch(ws, r)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbatched.copies_capacity(ws, r, aware=False)
    assert pbatched.copies_capacity(ws, r, aware=False, device="cpu").tolist() == [8]
