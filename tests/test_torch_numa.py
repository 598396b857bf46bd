"""NUMA on the gang paths, on the CPU: the port's ``BatchScheduler`` with
``topology=`` (``schedule_gang``, ``schedule_gang_queue``,
``schedule_batch_mixed``), its NUMA-vector cache, the grouped bind and its
sequential twin, the over-admission re-solve, and the per-pod
``Scheduler`` built from the NRT profile, each against the JAX package on
twin clusters made from one seed (up to a few hundred nodes, 1-4 NUMA
zones per node, CRs missing on some nodes, non-Static and node-aware
policies on others, background pods holding topology-result annotations,
overcommitted zones).

Mirrors ``tests/test_numa_incremental.py``, ``tests/test_bind_grouped.py``
and the NUMA cases of ``tests/test_framework_e2e.py`` on the port's side.
Tolerance: exact. Placements node for node, unassigned keys, scores and
verdicts, every pod's annotations (the topology results as JSON strings),
the assume cache's contents, cluster versions, NUMA vectors and
``numa_incremental_rows`` are equal.

The JAX ``schedule_gang_queue`` loads its gang window even when every gang
falls back, so its calls run inside this module's ``jax_gang`` fixture
(``tests/test_torch_gang_queue.py``'s scoped ``enable_x64`` shim).
"""

import json
import random
import time

import numpy as np
import pytest
import torch

import crane_scheduler_tpu.topology.batched as jbatched
import crane_scheduler_tpu_torch.topology.batched as pbatched
from crane_scheduler_tpu.config import build_scheduler_from_config as jax_build_from_config
from crane_scheduler_tpu.config import load_scheduler_config as jax_load_config
from crane_scheduler_tpu.policy import DEFAULT_POLICY
from crane_scheduler_tpu_torch.config import build_scheduler_from_config as port_build_from_config
from crane_scheduler_tpu_torch.config import load_scheduler_config as port_load_config
from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY as PORT_POLICY
from test_drip_columnar import METRICS, NOW, _anno, fuzz_node_specs
from test_torch_gang_queue import SIDES, build_twin, jax_gang_reference
from test_torch_gang_queue import _jexp_state, outcomes, stats, versions
from test_torch_topology import SIDES as TOPO, lister_from_crs, zone_wire

RESULT = "topology.crane.io/topology-result"
AWARE = "topology.crane.io/topology-awareness"
GiB = 1024**3
ALLOC = {"cpu": "16", "memory": "64Gi", "ephemeral-storage": "100Gi", "pods": "110"}


@pytest.fixture(scope="module")
def jax_gang():
    state = _jexp_state()
    with jax_gang_reference() as mod:
        yield mod
    assert _jexp_state() == state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- twin worlds -----------------------------------------------------------------


def numa_world(seed: int, n: int, zones=(2,)):
    """Node specs (fuzzed Dynamic annotations, the drip allocatable on most
    nodes), NRT CRs as plain mappings and one bound background pod per
    node whose result annotation uses part of a zone (or overcommits
    zone 0 now and then)."""
    rng = random.Random(seed)
    specs = []
    for i, (name, anno, _alloc) in enumerate(fuzz_node_specs(rng, n)):
        specs.append((name, anno, None if i % 9 == 4 else ALLOC))
    crs, background = [], []
    for i, (name, _, _) in enumerate(specs):
        z = rng.choice(zones)
        if i % 13 != 7:
            crs.append({
                "name": name,
                "cpu_manager_policy": "None" if i % 11 == 3 else "Static",
                "topology_manager_policy": "SingleNUMANodePodLevel" if i % 4 == 0 else "None",
                "zones": [zone_wire(f"numa-{j}", rng.choice([4000, 8000, 8000, 7500]),
                                    rng.choice([16, 32]) * GiB, 50 * GiB) for j in range(z)],
            })
        used = rng.choice([0, 1000, 2000, 4000, 6000]) if i % 17 != 5 else 9000
        if used:
            split = rng.random() < 0.3 and z > 1
            parts = [("numa-0", used // 2), ("numa-1", used - used // 2)] if split else \
                [(f"numa-{rng.randrange(z)}" if used < 9000 else "numa-0", used)]
            background.append((name, used, json.dumps(
                [{"name": zn, "type": "Node", "resources": {"capacity": {"cpu": f"{c}m"}}}
                 for zn, c in parts], separators=(",", ":"))))
    return specs, crs, background


def guaranteed(side, name, cpu_milli, mem=GiB, aware=None, daemonset=False, burstable=False):
    m = SIDES[side]
    req = {"cpu": f"{cpu_milli}m", "memory": str(mem)}
    lim = dict(req, cpu=f"{cpu_milli + 500}m") if burstable else dict(req)
    kw = {}
    if daemonset:
        kw["owner_references"] = (m["OwnerReference"](kind="DaemonSet", name="ds"),)
    return m["Pod"](name=name, namespace="default",
                    annotations={} if aware is None else {AWARE: aware},
                    containers=(m["Container"]("c", m["ResourceRequirements"](
                        requests=req, limits=lim)),), **kw)


def build_numa(side, world, dtype="f64"):
    specs, crs, background = world
    batch = build_twin(side, specs, dtype=dtype)
    for name, used, raw in background:
        pod = guaranteed(side, f"bg-{name}", used)
        batch.cluster.add_pod(type(pod)(
            name=pod.name, namespace=pod.namespace, containers=pod.containers,
            annotations={RESULT: raw}, node_name=name))
    lister = lister_from_crs(side, crs)
    topo = TOPO[side]["plugin"].TopologyMatch(lister, cluster=batch.cluster)
    return batch, topo


def observe(batch, topo):
    """Every pod with its node and annotations, the assume cache as JSON,
    the cluster versions and the incremental row count."""
    pods = sorted((p.key(), p.node_name, sorted(p.annotations.items()))
                  for p in batch.cluster.list_pods())
    assumed = {k: json.dumps([z.to_wire() for z in v], separators=(",", ":"))
               for k, v in topo.cache._topology.items()}
    return pods, assumed, versions(batch.cluster), batch.numa_incremental_rows


# (cpu milli, count, awareness); classes repeat, so later gangs of a class
# take the incremental vector path
GANGS = ((1000, 6, None), (2000, 4, "true"), (3000, 3, None), (4000, 2, "false"),
         (1000, 5, None), (8000, 2, "true"), (2000, 3, "true"), (3000, 3, None))


def gangs_for(side, shapes=GANGS, tag="g"):
    return [(guaranteed(side, f"{tag}{j}", cpu, aware=aware), count)
            for j, (cpu, count, aware) in enumerate(shapes)]


# -- schedule_gang ----------------------------------------------------------------


@pytest.mark.parametrize("bind", [True, False], ids=["bind", "preview"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_schedule_gang_numa_matches_reference(dtype, bind):
    """Eight gangs of guaranteed pods (aware, unaware and node-decided)
    through a sequential ``schedule_gang(topology=)`` loop: assignments,
    unassigned keys, scores and verdicts, every pod's annotations, the
    assume cache, versions and incremental rows equal the JAX package's."""
    world = numa_world(5, 60)
    out = {}
    for side in SIDES:
        batch, topo = build_numa(side, world, dtype=dtype)
        results = [batch.schedule_gang(t, c, topology=topo, bind=bind)
                   for t, c in gangs_for(side)]
        out[side] = ([(r.assignments, r.unassigned, r.scores, r.schedulable)
                      for r in results], observe(batch, topo))
    assert out["port"] == out["jax"]
    placed = sum(len(r[0]) for r in out["port"][0])
    assert placed > 0
    if bind:
        annotated = [p for p in out["port"][1][0] if p[0].startswith("default/g")]
        assert len(annotated) == placed and all(
            any(k == RESULT for k, _ in p[2]) for p in annotated)
        assert out["port"][1][3] > 0  # later gangs took the incremental path


@pytest.mark.parametrize("bind", [True, False], ids=["bind", "preview"])
@pytest.mark.parametrize("window", [1, 8])
def test_gang_queue_numa_matches_reference(jax_gang, window, bind):
    """``schedule_gang_queue(topology=)``: every gang falls back to
    ``schedule_gang`` (the window flushed first), outcomes with source
    ``"fallback"``, ``gang_stats()`` and the cluster equal the reference's
    and the port's own sequential loop."""
    world = numa_world(9, 60)
    out = {}
    for side in SIDES:
        batch, topo = build_numa(side, world)
        outs = batch.schedule_gang_queue(gangs_for(side), topology=topo, window=window,
                                         bind=bind)
        out[side] = (outcomes(outs), stats(batch), observe(batch, topo))
    assert out["port"] == out["jax"]
    assert [o[3] for o in out["port"][0]] == ["fallback"] * len(GANGS)
    assert out["port"][1]["fallbacks"] == len(GANGS) and out["port"][1]["windows"] == 0
    batch, topo = build_numa("port", world)
    seq = [batch.schedule_gang(t, c, topology=topo, bind=bind) for t, c in gangs_for("port")]
    assert [(a, u) for a, u, _, _ in out["port"][0]] == [
        (r.assignments, sorted(r.unassigned)) for r in seq]


def test_gang_queue_mixes_windows_and_numa_fallbacks(jax_gang):
    """Without ``topology`` the queue windows as before; a second queue
    call with it falls back gang by gang, the first call's binds visible
    to the NUMA accounting."""
    world = numa_world(12, 60)
    out = {}
    for side in SIDES:
        batch, topo = build_numa(side, world)
        outs = batch.schedule_gang_queue(gangs_for(side, GANGS[:4], "w"), window=4)
        outs += batch.schedule_gang_queue(gangs_for(side, GANGS[4:], "n"), topology=topo,
                                          window=4)
        out[side] = (outcomes(outs), stats(batch), observe(batch, topo))
    assert out["port"] == out["jax"]
    assert [o[3] for o in out["port"][0]] == ["window"] * 4 + ["fallback"] * 4


# -- the NUMA-vector cache ----------------------------------------------------------


def vectors(batch, topo, template):
    return batch._numa_vectors(template, topo, 2, batch._prepared_names, batch._prepared_n)


def fresh(batch, topo, template):
    return batch._numa_vectors_uncached(template, topo, 2, batch._prepared_names,
                                        batch._prepared_n)


def count_full_builds(batch):
    calls = {"full": 0}
    real = batch._numa_vectors_uncached

    def counting(*a, **k):
        calls["full"] += 1
        return real(*a, **k)

    batch._numa_vectors_uncached = counting
    return calls


def test_numa_vectors_incremental_equal_rebuild_and_reference():
    """A full build, then binds through the plugin path: the next cycles
    re-derive only the journaled rows, and the vectors equal a fresh
    rebuild and the reference's, full and incremental."""
    world = numa_world(31, 60, zones=(1, 2, 4))
    out = {}
    for side in SIDES:
        batch, topo = build_numa(side, world)
        t = guaranteed(side, "v", 2000)
        batch.schedule_gang(t, 4, topology=topo, bind=False)
        assert batch.numa_incremental_rows == 0
        full = vectors(batch, topo, t)
        calls = count_full_builds(batch)
        batch.schedule_gang(t, 9, topology=topo, bind=True)
        batch.schedule_gang(guaranteed(side, "w", 2000), 5, topology=topo, bind=True)
        rows = batch.numa_incremental_rows
        assert 0 < rows < 80 and calls["full"] == 0
        inc = vectors(batch, topo, t)
        want = fresh(batch, topo, t)
        for a, b in zip(inc, want):
            np.testing.assert_array_equal(a, b)
        out[side] = ([v.tolist() for v in full], [v.tolist() for v in inc], rows)
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("trigger", ["expiry", "forget", "overrun", "sweep", "cr"])
def test_numa_cache_invalidation_matches_reference(trigger):
    """Assume-cache removals (TTL expiry, forget) and a pod-change journal
    overrun force one full rebuild; a node-annotation sweep leaves the
    cache alone; a CR change keys a new entry. Vectors equal a fresh
    rebuild and the reference's."""
    world = numa_world(32, 24)
    out = {}
    for side in SIDES:
        C = SIDES[side]
        batch, topo = build_numa(side, world)
        t = guaranteed(side, "v", 1000)
        batch.schedule_gang(t, 3, topology=topo, bind=True)
        batch.schedule_gang(t, 1, topology=topo, bind=False)  # cache warm
        calls = count_full_builds(batch)
        before = batch.numa_incremental_rows
        if trigger == "expiry":
            topo.cache.cleanup(now=time.time() + 10 * 3600)
            assert topo.cache.pod_count() == 0
        elif trigger == "forget":
            key = next(iter(topo.cache._topology))
            topo.cache.forget_pod(batch.cluster.get_pod(key))
        elif trigger == "overrun":
            node = world[0][0][0]
            for i in range(batch.cluster._pod_change_log.maxlen + 10):
                batch.cluster.add_pod(C["Pod"](name=f"filler-{i}", namespace="x",
                                               node_name=node))
            assert batch.cluster.pod_changes_since(0) is None
        elif trigger == "sweep":
            for name, _, _ in world[0][:5]:
                batch.cluster.patch_node_annotation(name, METRICS[0], _anno(0.1, 15.0))
        else:
            topo.lister.upsert(topo.lister.get(world[1][0]["name"]))
        got = vectors(batch, topo, t)
        want_full = 0 if trigger == "sweep" else 1
        assert calls["full"] == want_full
        assert batch.numa_incremental_rows == before
        want = fresh(batch, topo, t)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        out[side] = [v.tolist() for v in got]
    assert out["port"] == out["jax"]


def test_numa_incremental_scales_with_changed_rows():
    """At 300 nodes a bind touches only its nodes' rows: no full rebuild,
    a handful of incremental rows."""
    batch, topo = build_numa("port", numa_world(34, 300))
    t = guaranteed("port", "v", 1000)
    batch.schedule_gang(t, 4, topology=topo, bind=False)
    calls = count_full_builds(batch)
    before = batch.numa_incremental_rows
    batch.schedule_gang(t, 6, topology=topo, bind=True)
    batch.schedule_gang(t, 2, topology=topo, bind=False)
    assert calls["full"] == 0
    assert 0 < batch.numa_incremental_rows - before <= 12


def test_numa_vectors_cache_identity_defeats_id_reuse():
    """A new plugin (a fresh lister at the same version) never hits an
    entry cached for an old one, even if ``id()`` recycles."""
    world = numa_world(35, 20)
    batch, topo = build_numa("port", world)
    t = guaranteed("port", "v", 1000)
    batch.schedule_gang(t, 2, topology=topo, bind=False)
    key, entry = next(iter(batch._numa_cache.items()))
    assert entry["ref"]() is topo
    other = TOPO["port"]["plugin"].TopologyMatch(lister_from_crs("port", world[1]),
                                                 cluster=batch.cluster)
    assert other.lister.version == topo.lister.version
    batch._numa_cache[(id(other),) + key[1:]] = entry  # as if id() were recycled
    calls = count_full_builds(batch)
    vectors(batch, other, t)
    assert calls["full"] == 1
    assert batch._numa_cache[(id(other),) + key[1:]]["ref"]() is other


# -- the mixed batch ----------------------------------------------------------------


@pytest.mark.parametrize("bind", [True, False], ids=["bind", "preview"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_schedule_batch_mixed_numa_matches_reference(dtype, bind):
    """Pending pods of NUMA classes (aware and not, several CPU sizes),
    burstable pods (the plugin's no-op class) and DaemonSet pods, two
    bursts: assignments, unassigned keys, verdicts, annotations patched
    by PreBind, the assume cache and versions equal the reference's."""
    world = numa_world(40, 60)
    rng = random.Random(40)
    shapes = [(rng.choice([1000, 2000, 3000]), rng.choice([None, "true", "false"]),
               rng.random() < 0.1, rng.random() < 0.2) for _ in range(40)]
    out = {}
    for side in SIDES:
        batch, topo = build_numa(side, world, dtype=dtype)
        results = []
        for burst in range(2):
            pods = [guaranteed(side, f"m{burst}-{i}", cpu, aware=aware, daemonset=ds,
                               burstable=bu)
                    for i, (cpu, aware, ds, bu) in enumerate(shapes)]
            batch.cluster.add_pods(pods)
            r = batch.schedule_batch_mixed(pods, topology=topo, bind=bind)
            results.append((r.assignments, r.unassigned, r.scores, r.schedulable))
        out[side] = (results, observe(batch, topo))
    assert out["port"] == out["jax"]
    assert len(out["port"][0][0][0]) > 0
    keys = {k for k, _, anno in out["port"][1][0] if any(a == RESULT for a, _ in anno)}
    assert bool(keys & {f"default/m1-{i}" for i in range(40)}) == bind


def test_class_keys_match_reference():
    world = numa_world(41, 10)
    rng = random.Random(41)
    shapes = [(rng.choice([1000, 1500, 2000]), rng.choice([None, "true", "false", "x"]),
               rng.random() < 0.2, rng.random() < 0.2) for _ in range(30)]
    out = {}
    for side in SIDES:
        batch, topo = build_numa(side, world)
        pods = [guaranteed(side, f"k{i}", cpu, aware=aware, daemonset=ds, burstable=bu)
                for i, (cpu, aware, ds, bu) in enumerate(shapes)]
        out[side] = [(batch._class_key(p, topo), batch._class_key(p, None)) for p in pods]
    assert out["port"] == out["jax"]
    assert {k[0][0] for k in out["port"]} == {"numa", "noop"}


# -- over-admission and the re-solve ----------------------------------------------------


@pytest.mark.parametrize("inflate_every", [False, True], ids=["first_call", "every_call"])
def test_over_admission_recovers_like_reference(monkeypatch, inflate_every):
    """``copies_capacity`` inflated by one in both packages, on its first
    call (one 4-core zone per node) or on every call (two 8-core zones per
    node): the plugin rejects the over-admitted aware copies, the re-solve
    places what truly fits and leaves the rest unassigned, and no copy
    binds zone-less. Results, the number of estimates and the cluster
    equal the reference's."""
    calls = {"jax": 0, "port": 0}

    def inflate(side, real):
        def inflated(wrappers, request, aware, **kw):
            caps = real(wrappers, request, aware, **kw)
            calls[side] += 1
            return caps + 1 if inflate_every or calls[side] == 1 else caps
        return inflated

    monkeypatch.setattr(jbatched, "copies_capacity", inflate("jax", jbatched.copies_capacity))
    monkeypatch.setattr(pbatched, "copies_capacity", inflate("port", pbatched.copies_capacity))
    zones, cpu, count, fits = ([8000, 8000], 5000, 8, 6) if inflate_every else \
        ([4000], 3000, 5, 3)
    specs = [(f"n{i}", {m: _anno(0.1 + 0.1 * i, 30.0) for m in METRICS}, ALLOC)
             for i in range(3)]
    crs = [{"name": f"n{i}", "cpu_manager_policy": "Static", "topology_manager_policy": "None",
            "zones": [zone_wire(f"numa-{j}", c, 64 * GiB) for j, c in enumerate(zones)]}
           for i in range(3)]
    out = {}
    for side in SIDES:
        batch, topo = build_numa(side, (specs, crs, []))
        r = batch.schedule_gang(guaranteed(side, "big", cpu, aware="true"), count,
                                topology=topo)
        out[side] = (r.assignments, r.unassigned, observe(batch, topo))
    assert out["port"] == out["jax"]
    assert calls["port"] == calls["jax"] >= 2
    assignments, unassigned, (pods, _, _, _) = out["port"]
    assert len(assignments) == fits and len(unassigned) == count - fits
    for key, node, anno in pods:
        if key.startswith("default/big"):
            assert key in assignments and node == assignments[key]
            assert len(json.loads(dict(anno)[RESULT])) == 1  # never zone-less


# -- the grouped bind against its sequential twin ------------------------------------------


def grouped_vs_sequential(side, world, shapes, sequential: bool, mixed: bool):
    batch, topo = build_numa(side, world)
    if sequential:
        batch._bind_assignments = batch._bind_assignments_sequential
    if mixed:
        pods = [guaranteed(side, f"x{i}", cpu, aware=aware)
                for i, (cpu, _c, aware) in enumerate(shapes)]
        batch.cluster.add_pods(pods)
        r = batch.schedule_batch_mixed(pods, topology=topo)
        res = [(r.assignments, sorted(r.unassigned))]
    else:
        res = [(r.assignments, sorted(r.unassigned)) for r in (
            batch.schedule_gang(t, c, topology=topo) for t, c in gangs_for(side, shapes))]
    return res, observe(batch, topo)[:3]


@pytest.mark.parametrize("mixed", [False, True], ids=["gang", "pending"])
@pytest.mark.parametrize("seed", range(2))
def test_grouped_bind_equals_sequential_twin_and_reference(seed, mixed):
    """Randomized zones (1-4 per node), loads and gang shapes: the grouped
    bind equals ``_bind_assignments_sequential`` in placements,
    rejections, annotations, assume cache and counts, on both sides; the
    port's grouped bind equals the reference's."""
    rng = random.Random(60 + seed)
    world = numa_world(60 + seed, rng.randrange(6, 20), zones=(1, 2, 3, 4))
    shapes = [(rng.randrange(1, 5) * 1000, rng.randrange(1, 12),
               rng.choice([None, "true"])) for _ in range(4)]
    runs = {(side, seq): grouped_vs_sequential(side, world, shapes, seq, mixed)
            for side in SIDES for seq in (False, True)}
    assert runs[("port", False)] == runs[("port", True)]
    assert runs[("port", False)] == runs[("jax", False)]
    assert runs[("jax", True)] == runs[("jax", False)]


def test_missing_nrt_rejects_the_whole_group():
    """A node without a CR rejects its copies (ERR_FAILED_TO_GET_NRT) on the
    grouped and the sequential bind; the re-solve places them on the node
    that has one."""
    specs = [(f"n{i}", {m: _anno(0.3 + 0.2 * i, 30.0) for m in METRICS}, ALLOC)
             for i in range(2)]
    crs = [{"name": "n1", "cpu_manager_policy": "Static", "topology_manager_policy": "None",
            "zones": [zone_wire("numa-0", 8000, 64 * GiB)]}]
    out = {}
    for side in SIDES:
        for sequential in (False, True):
            batch, topo = build_numa(side, (specs, crs, []))
            if sequential:
                batch._bind_assignments = batch._bind_assignments_sequential
            bound, rejected, rejecting, dropped = batch._bind_gang(
                guaranteed(side, "g", 1000), {"default/g-0": "n0", "default/g-1": "n1"},
                topo, NOW)
            r = batch.schedule_gang(guaranteed(side, "h", 1000), 6, topology=topo)
            out[(side, sequential)] = (bound, rejected, sorted(rejecting), dropped,
                                       r.assignments, r.unassigned)
    first = out[("port", False)]
    assert all(v == first for v in out.values())
    assert first[:4] == ({"default/g-1": "n1"}, ["default/g-0"], ["n0"], [])
    assert set(first[4].values()) == {"n1"}


def test_bind_without_topology_is_unchanged():
    """Without the plugin nothing is rejected and no annotation is
    written: the 4-tuple's middle entries stay empty."""
    batch, topo = build_numa("port", numa_world(70, 6))
    t = guaranteed("port", "p", 1000)
    names = list(batch.cluster.list_nodes())
    bound, rejected, rejecting, dropped = batch._bind_gang(
        t, {"default/p-0": names[0].name, "default/p-1": names[1].name}, None, NOW)
    assert (len(bound), rejected, rejecting, dropped) == (2, [], set(), [])
    assert RESULT not in batch.cluster.get_pod("default/p-0").annotations


# -- the per-pod scheduler from the NRT profile --------------------------------------------


def per_pod_twin(side, world, profile_text, policy):
    specs, crs, background = world
    m = SIDES[side]
    cluster = m["ClusterState"]()
    for name, anno, alloc in specs:
        kw = {"allocatable": alloc} if alloc else {}
        cluster.add_node(m["Node"](name=name, annotations=dict(anno), **kw))
    for name, used, raw in background:
        pod = guaranteed(side, f"bg-{name}", used)
        cluster.add_pod(type(pod)(name=pod.name, namespace=pod.namespace,
                                  containers=pod.containers, annotations={RESULT: raw},
                                  node_name=name))
    lister = lister_from_crs(side, crs)
    if side == "jax":
        cfg = jax_load_config(profile_text)
        sched = jax_build_from_config(cluster, cfg, nrt_lister=lister, clock=lambda: NOW,
                                      policy=policy)
    else:
        cfg = port_load_config(profile_text)
        sched = port_build_from_config(cluster, cfg, nrt_lister=lister, clock=lambda: NOW,
                                       policy=policy, device="cpu")
    return cluster, sched


NRT_AND_DYNAMIC = b"""
apiVersion: kubescheduler.config.k8s.io/v1beta2
kind: KubeSchedulerConfiguration
profiles:
  - schedulerName: default-scheduler
    plugins:
      filter:
        enabled: [{name: Dynamic}, {name: NodeResourceTopologyMatch}]
      score:
        enabled: [{name: Dynamic, weight: 3}, {name: NodeResourceTopologyMatch, weight: 2}]
"""


@pytest.mark.parametrize("profile", ["nrt", "nrt_dynamic"])
def test_per_pod_scheduler_from_nrt_profile_matches_reference(profile):
    """``build_scheduler_from_config`` with the NRT profile (the deploy
    file, and Dynamic x3 + NRT x2): the registered plugins, and 12 pods
    placed one by one through the scalar loop (the columnar path refuses
    the plugin set in both packages), pod for pod, with their zone
    results and the assume cache."""
    from pathlib import Path

    text = (Path(__file__).resolve().parents[1]
            / "deploy/noderesourcetopology/scheduler-config.yaml").read_bytes() \
        if profile == "nrt" else NRT_AND_DYNAMIC
    world = numa_world(80, 30)
    rng = random.Random(80)
    shapes = [(rng.choice([1000, 2000, 4000]), rng.choice([None, "true"]),
               rng.random() < 0.15) for _ in range(12)]
    out = {}
    for side in SIDES:
        cluster, sched = per_pod_twin(side, world, text,
                                      DEFAULT_POLICY if side == "jax" else PORT_POLICY)
        topo = sched._plugins[-1].plugin
        try:
            results = []
            for i, (cpu, aware, bu) in enumerate(shapes):
                pod = guaranteed(side, f"pp{i}", cpu, aware=aware, burstable=bu)
                cluster.add_pod(pod)
                r = sched.schedule_one(pod)
                results.append((r.node, r.feasible, r.reason))
            out[side] = ([(type(wp.plugin).__name__, wp.weight) for wp in sched._plugins],
                         results, sched.drip_stats()["fallbacks"],
                         sorted((p.key(), p.node_name, sorted(p.annotations.items()))
                                for p in cluster.list_pods()),
                         {k: TOPO[side]["types"].zones_to_json(v)
                          for k, v in topo.cache._topology.items()})
        finally:
            topo.cache.stop_cleaner()
    assert out["port"] == out["jax"]
    assert out["port"][0][-1] == ("TopologyMatch", 2)
    assert sum(1 for node, _, _ in out["port"][1] if node) > 0
    assert out["port"][2] == {"unknown_plugin": len(shapes)}


def test_factory_refuses_nrt_without_lister():
    cfg = port_load_config(NRT_AND_DYNAMIC)
    with pytest.raises(ValueError, match="no NRT lister"):
        port_build_from_config(SIDES["port"]["ClusterState"](), cfg, policy=PORT_POLICY,
                               device="cpu")
