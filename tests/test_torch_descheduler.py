"""The port's load-aware descheduler against the JAX package's.

Every scenario runs the same inputs through both packages' cluster
mirror, ``descheduler/`` and fit layer and returns a trace: each cycle's
``CycleReport`` field for field (``hot``, ``actionable``, ``evicted``,
``planned``, ``skipped``, ``suspended``), ``stats()``, the pods left and
the events emitted. The port's trace must equal the reference's exactly
(equality throughout, no tolerance). The thirteen in-memory cases of
``tests/test_descheduler.py`` run here against both packages; its kube
stub round trip waits for the kube mirror. Then a seeded fuzz over many
cycles, ``ClusterState.evict_pod`` on object pods and burst rows, the
degraded interlock, and config 11's closed loop at its own 8 nodes with
the port re-placing through ``schedule_one`` and through the drip window
(``schedule_queue``).
"""

import dataclasses
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import crane_scheduler_tpu.annotator.bindings as ref_bindings
import crane_scheduler_tpu.annotator.events as ref_events
import crane_scheduler_tpu.cluster as ref_cluster
import crane_scheduler_tpu.descheduler as ref_desched
import crane_scheduler_tpu.descheduler.config as ref_desched_config
import crane_scheduler_tpu.fit as ref_fit
import crane_scheduler_tpu.framework.scheduler as ref_framework
import crane_scheduler_tpu.plugins as ref_plugins
import crane_scheduler_tpu.resilience as ref_resilience
import crane_scheduler_tpu_torch.annotator.bindings as port_bindings
import crane_scheduler_tpu_torch.annotator.events as port_events
import crane_scheduler_tpu_torch.cluster as port_cluster
import crane_scheduler_tpu_torch.descheduler as port_desched
import crane_scheduler_tpu_torch.descheduler.config as port_desched_config
import crane_scheduler_tpu_torch.fit as port_fit
import crane_scheduler_tpu_torch.framework.scheduler as port_framework
import crane_scheduler_tpu_torch.plugins as port_plugins
import crane_scheduler_tpu_torch.resilience as port_resilience
from crane_scheduler_tpu.policy import DEFAULT_POLICY as REF_POLICY
from crane_scheduler_tpu.telemetry import Telemetry as RefTelemetry
from crane_scheduler_tpu.utils import format_local_time
from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY
from crane_scheduler_tpu_torch.telemetry import Telemetry

NOW = 1753776000.0
METRICS = (
    "cpu_usage_avg_5m", "cpu_usage_max_avg_1h", "cpu_usage_max_avg_1d",
    "mem_usage_avg_5m", "mem_usage_max_avg_1h", "mem_usage_max_avg_1d",
)


def _ns(cluster, desched, desched_config, fit, framework, plugins, resilience,
        bindings, events, policy, telemetry, sched_kw):
    return SimpleNamespace(
        ClusterState=cluster.ClusterState, Container=cluster.Container,
        Node=cluster.Node, OwnerReference=cluster.OwnerReference, Pod=cluster.Pod,
        ResourceRequirements=cluster.ResourceRequirements,
        DeschedulerConfig=desched.DeschedulerConfig,
        LoadAwareDescheduler=desched.LoadAwareDescheduler,
        WatermarkPolicy=desched.WatermarkPolicy,
        EVICT_ANNOTATION=desched_config.EVICT_ANNOTATION,
        FitTracker=fit.FitTracker, ResourceFitPlugin=fit.ResourceFitPlugin,
        pod_fit_request=fit.pod_fit_request, Scheduler=framework.Scheduler,
        DynamicPlugin=plugins.DynamicPlugin,
        DegradedModeController=resilience.DegradedModeController,
        BindingRecords=bindings.BindingRecords, EventIngestor=events.EventIngestor,
        policy=policy, Telemetry=telemetry, sched_kw=sched_kw,
    )


PKGS = {
    "ref": _ns(ref_cluster, ref_desched, ref_desched_config, ref_fit, ref_framework,
               ref_plugins, ref_resilience, ref_bindings, ref_events, REF_POLICY,
               RefTelemetry, {}),
    "port": _ns(port_cluster, port_desched, port_desched_config, port_fit,
                port_framework, port_plugins, port_resilience, port_bindings,
                port_events, DEFAULT_POLICY, Telemetry, {"device": "cpu"}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def both(scenario, *args):
    """The scenario's trace on the reference and on the port."""
    return scenario(PKGS["ref"], *args), scenario(PKGS["port"], *args)


def report_dict(report) -> dict:
    return dataclasses.asdict(report)


def anno(value, age_seconds=0.0, now=NOW):
    return f"{value:.5f},{format_local_time(now - age_seconds)}"


def usage_annotations(cpu, now=NOW):
    return {"cpu_usage_avg_5m": anno(cpu, now=now)}


def make_pod(p, name, cpu="100m", node_name="", namespace="default", **kwargs):
    return p.Pod(
        name=name,
        namespace=namespace,
        containers=(p.Container("c", p.ResourceRequirements(requests={"cpu": cpu})),),
        node_name=node_name,
        **kwargs,
    )


def make_cluster(p, hot=("hot",), cool=("cool",), hot_cpu=0.9, cool_cpu=0.2, now=NOW):
    cluster = p.ClusterState()
    for names, cpu in ((hot, hot_cpu), (cool, cool_cpu)):
        for name in names:
            cluster.add_node(p.Node(name=name, annotations=usage_annotations(cpu, now)))
    return cluster


WATERMARK = ("cpu_usage_avg_5m", 0.50, 0.70)


def make_descheduler(p, cluster, telemetry=None, **overrides):
    overrides.setdefault(
        "watermarks", (p.WatermarkPolicy(WATERMARK[0], target=WATERMARK[1],
                                         threshold=WATERMARK[2]),))
    overrides.setdefault("consecutive_syncs", 2)
    return p.LoadAwareDescheduler(
        cluster, p.policy, p.DeschedulerConfig(**overrides),
        clock=lambda: NOW, telemetry=telemetry,
    )


def pod_keys(cluster) -> list:
    return sorted(pod.key() for pod in cluster.list_pods())


# -- the thirteen in-memory cases of tests/test_descheduler.py ------------------


def case_one_spike_never_evicts(p):
    cluster = make_cluster(p)
    cluster.add_pod(make_pod(p, "w", node_name="hot"))
    d = make_descheduler(p, cluster, consecutive_syncs=3)
    reports = [d.sync_once(NOW + i) for i in range(3)]
    assert not reports[1].evicted and [e.pod_key for e in reports[2].evicted] == ["default/w"]
    return reports, d, cluster


def case_streak_resets_when_node_cools(p):
    cluster = make_cluster(p)
    cluster.add_pod(make_pod(p, "w", node_name="hot"))
    d = make_descheduler(p, cluster, consecutive_syncs=2)
    reports = [d.sync_once(NOW)]
    cluster.patch_node_annotation("hot", "cpu_usage_avg_5m", anno(0.30))
    reports.append(d.sync_once(NOW + 1))
    cluster.patch_node_annotation("hot", "cpu_usage_avg_5m", anno(0.90))
    reports.append(d.sync_once(NOW + 2))
    assert reports[2].hot["hot"][0] == 1 and not reports[2].evicted
    return reports, d, cluster


def case_stale_annotation_fails_open(p):
    cluster = p.ClusterState()
    cluster.add_node(p.Node(name="hot",
                            annotations={"cpu_usage_avg_5m": anno(0.95, age_seconds=481)}))
    cluster.add_node(p.Node(name="cool", annotations=usage_annotations(0.2)))
    cluster.add_pod(make_pod(p, "w", node_name="hot"))
    d = make_descheduler(p, cluster, consecutive_syncs=1)
    reports = [d.sync_once(NOW)]
    assert not reports[0].hot and not reports[0].evicted
    return reports, d, cluster


def case_malformed_annotation_fails_open(p):
    cluster = p.ClusterState()
    cluster.add_node(p.Node(name="hot", annotations={"cpu_usage_avg_5m": "garbage"}))
    cluster.add_pod(make_pod(p, "w", node_name="hot"))
    d = make_descheduler(p, cluster, consecutive_syncs=1)
    reports = [d.sync_once(NOW)]
    assert not reports[0].hot
    return reports, d, cluster


def case_daemonset_and_system_pods_never_evicted(p):
    cluster = make_cluster(p)
    cluster.add_pod(make_pod(p, "ds", node_name="hot",
                             owner_references=(p.OwnerReference(kind="DaemonSet", name="d"),)))
    cluster.add_pod(make_pod(p, "sys", node_name="hot", namespace="kube-system"))
    cluster.add_pod(make_pod(p, "optout", node_name="hot",
                             annotations={p.EVICT_ANNOTATION: "false"}))
    cluster.add_pod(make_pod(p, "victim", node_name="hot"))
    d = make_descheduler(p, cluster, consecutive_syncs=1, max_evictions_per_node=4)
    reports = [d.sync_once(NOW)]
    assert [e.pod_key for e in reports[0].evicted] == ["default/victim"]
    assert reports[0].skipped == {"daemonset": 1, "protected_namespace": 1, "opt_out": 1}
    return reports, d, cluster


def case_largest_cpu_victim_goes_first(p):
    cluster = make_cluster(p)
    cluster.add_pod(make_pod(p, "small", cpu="100m", node_name="hot"))
    cluster.add_pod(make_pod(p, "big", cpu="2", node_name="hot"))
    d = make_descheduler(p, cluster, consecutive_syncs=1)
    reports = [d.sync_once(NOW)]
    assert [e.pod_key for e in reports[0].evicted] == ["default/big"]
    return reports, d, cluster


def case_per_node_and_per_cycle_budgets(p):
    cluster = make_cluster(p, hot=("hot-a", "hot-b"), cool=("cool",))
    for i in range(3):
        cluster.add_pod(make_pod(p, f"a{i}", node_name="hot-a"))
        cluster.add_pod(make_pod(p, f"b{i}", node_name="hot-b"))
    d = make_descheduler(p, cluster, consecutive_syncs=1, max_evictions_per_node=2,
                         max_evictions_per_cycle=3)
    reports = [d.sync_once(NOW)]
    assert len(reports[0].evicted) == 3
    return reports, d, cluster


def case_node_cooldown_between_evictions(p):
    cluster = make_cluster(p)
    cluster.add_pod(make_pod(p, "w1", node_name="hot"))
    cluster.add_pod(make_pod(p, "w2", node_name="hot"))
    d = make_descheduler(p, cluster, consecutive_syncs=1, node_cooldown_seconds=300.0)
    reports = [d.sync_once(NOW)]
    cluster.patch_node_annotation("hot", "cpu_usage_avg_5m", anno(0.9, now=NOW + 200))
    reports.append(d.sync_once(NOW + 200))
    cluster.patch_node_annotation("hot", "cpu_usage_avg_5m", anno(0.9, now=NOW + 301))
    reports.append(d.sync_once(NOW + 301))
    assert reports[1].skipped["cooldown"] == 1 and len(reports[2].evicted) == 1
    return reports, d, cluster


def case_fit_guard_blocks_eviction_without_landing_capacity(p):
    cluster = p.ClusterState()
    cluster.add_node(p.Node(name="hot", annotations=usage_annotations(0.9)))
    cluster.add_node(p.Node(name="cool", annotations=usage_annotations(0.2),
                            allocatable={"cpu": "1", "pods": "10"}))
    cluster.add_pod(make_pod(p, "giant", cpu="2", node_name="hot"))
    d = make_descheduler(p, cluster, consecutive_syncs=1)
    reports = [d.sync_once(NOW)]
    cluster.add_node(p.Node(name="cool", annotations=usage_annotations(0.2),
                            allocatable={"cpu": "4", "pods": "10"}))
    reports.append(d.sync_once(NOW))
    assert reports[0].skipped["no_fit"] == 1
    assert [e.pod_key for e in reports[1].evicted] == ["default/giant"]
    return reports, d, cluster


def case_hot_and_above_target_nodes_are_not_landing_spots(p):
    cluster = make_cluster(p, cool_cpu=0.6)
    cluster.add_pod(make_pod(p, "w", node_name="hot"))
    d = make_descheduler(p, cluster, consecutive_syncs=1)
    reports = [d.sync_once(NOW)]
    assert reports[0].actionable == ["hot"] and reports[0].skipped["no_fit"] == 1
    return reports, d, cluster


def case_dry_run_plans_but_never_evicts(p):
    cluster = make_cluster(p)
    cluster.add_pod(make_pod(p, "w", node_name="hot"))
    d = make_descheduler(p, cluster, consecutive_syncs=1, dry_run=True)
    reports = [d.sync_once(NOW)]
    assert [e.pod_key for e in reports[0].planned] == ["default/w"]
    assert cluster.get_pod("default/w") is not None
    return reports, d, cluster


def case_telemetry_families_present(p):
    tel = p.Telemetry()
    cluster = make_cluster(p)
    cluster.add_pod(make_pod(p, "w", node_name="hot"))
    d = make_descheduler(p, cluster, consecutive_syncs=1, telemetry=tel)
    reports = [d.sync_once(NOW)]
    text = tel.registry.render()
    # every desched sample but the cycle histogram's timed sum and buckets
    lines = sorted(ln for ln in text.splitlines()
                   if ln.startswith("crane_desched_")
                   and not ln.startswith(("crane_desched_cycle_seconds_sum",
                                          "crane_desched_cycle_seconds_bucket")))
    assert 'crane_desched_evictions_total{reason="cpu_usage_avg_5m"} 1' in lines
    assert "crane_desched_hotspot_nodes 1" in lines
    assert "crane_desched_cycle_seconds_count 1" in lines
    return reports, d, cluster, lines


def case_evicted_pod_replaces_onto_cool_node(p):
    cluster = p.ClusterState()
    for name, u in (("hot", 0.9), ("cool", 0.2)):
        cluster.add_node(p.Node(name=name, annotations={k: anno(u) for k in METRICS},
                                allocatable={"cpu": "8", "pods": "100"}))
    cluster.add_pod(make_pod(p, "w", cpu="1", node_name="hot"))
    d = make_descheduler(p, cluster, consecutive_syncs=1)
    reports = [d.sync_once(NOW)]
    assert cluster.get_pod("default/w") is None
    sched = p.Scheduler(cluster, clock=lambda: NOW, **p.sched_kw)
    sched.register(p.ResourceFitPlugin(p.FitTracker(cluster)), weight=1)
    sched.register(p.DynamicPlugin(p.policy, clock=lambda: NOW), weight=3)
    replacement = make_pod(p, "w", cpu="1")
    cluster.add_pod(replacement)
    result = sched.schedule_one(replacement)
    assert result.node == "cool"
    return reports, d, cluster, result.node


REFERENCE_CASES = [
    case_one_spike_never_evicts,
    case_streak_resets_when_node_cools,
    case_stale_annotation_fails_open,
    case_malformed_annotation_fails_open,
    case_daemonset_and_system_pods_never_evicted,
    case_largest_cpu_victim_goes_first,
    case_per_node_and_per_cycle_budgets,
    case_node_cooldown_between_evictions,
    case_fit_guard_blocks_eviction_without_landing_capacity,
    case_hot_and_above_target_nodes_are_not_landing_spots,
    case_dry_run_plans_but_never_evicts,
    case_telemetry_families_present,
    case_evicted_pod_replaces_onto_cool_node,
]


@pytest.mark.parametrize("case", REFERENCE_CASES,
                         ids=[c.__name__[len("case_"):] for c in REFERENCE_CASES])
def test_reference_case_equal(case):
    def scenario(p):
        reports, d, cluster, *extra = case(p)
        return ([report_dict(r) for r in reports], d.stats(), pod_keys(cluster), extra)

    ref, port = both(scenario)
    assert port == ref


# -- seeded multi-cycle fuzz -----------------------------------------------------

FUZZ_NODES = 64
FUZZ_CYCLES = 6
FUZZ_CPUS = ("100m", "250m", "500m", "1", "1500m", "2")


def fuzz_plan(seed: int) -> dict:
    """Everything a fuzz run does, as plain data, so both packages get the
    same inputs."""
    rng = random.Random(seed)
    names = [f"n{i:02d}" for i in range(FUZZ_NODES)]
    nodes = []
    tight = seed % 3 == 1  # small nodes that all report allocatable: no_fit
    for name in names:
        if tight:
            alloc = {"cpu": str(rng.choice((1, 2, 3))), "pods": "110"}
        elif rng.random() < 0.75:
            alloc = {"cpu": str(rng.choice((4, 8, 16))), "pods": str(rng.choice((6, 20, 110)))}
        else:
            alloc = {}
        cpu_base = rng.uniform(0.45, 0.95) if tight else rng.uniform(0.05, 0.95)
        nodes.append((name, alloc, cpu_base, rng.uniform(0.05, 0.9)))
    pods = []
    for i in range(FUZZ_NODES * 3):
        ns = rng.choices(("default", "kube-system", "crane-system", "team-a"),
                         weights=(80, 6, 4, 10))[0]
        kind = rng.random()
        pods.append({
            "name": f"p{i:03d}", "namespace": ns, "cpu": rng.choice(FUZZ_CPUS),
            "node": rng.choice(names), "daemonset": kind < 0.08,
            "opt_out": 0.08 <= kind < 0.13,
        })
    cycles = []
    for c in range(FUZZ_CYCLES):
        annos = {}
        for name, _, cpu_base, mem_base in nodes:
            roll = rng.random()
            if roll < 0.06:
                annos[name] = None  # no load annotations at all
                continue
            age = rng.choice((500.0, 900.0)) if roll < 0.14 else rng.uniform(0.0, 60.0)
            cpu = min(1.0, max(0.0, cpu_base + rng.uniform(-0.08, 0.08)))
            mem = min(1.0, max(0.0, mem_base + rng.uniform(-0.08, 0.08)))
            doc = {"cpu_usage_avg_5m": (cpu, age), "mem_usage_avg_5m": (mem, age)}
            if roll > 0.96:
                doc["cpu_usage_avg_5m"] = "garbage"
            elif roll > 0.93:
                doc["mem_usage_avg_5m"] = "0.5"  # no timestamp: malformed
            annos[name] = doc
        arrivals = [
            {"name": f"c{c}-{j}", "namespace": "default", "cpu": rng.choice(FUZZ_CPUS),
             "node": rng.choice(names), "daemonset": False, "opt_out": False}
            for j in range(rng.randrange(0, 6))
        ]
        cycles.append({"annos": annos, "arrivals": arrivals})
    config = {
        "consecutive_syncs": rng.choice((1, 2, 3)),
        "max_evictions_per_node": rng.choice((1, 2)),
        "max_evictions_per_cycle": rng.choice((2, 4, 6)),
        "node_cooldown_seconds": rng.choice((0.0, 90.0, 300.0)),
        "dry_run": seed % 4 == 3,
        "target": rng.choice((0.4, 0.5)),
        "threshold": rng.choice((0.6, 0.7)),
    }
    return {"nodes": nodes, "pods": pods, "cycles": cycles, "config": config}


def _fuzz_pod(p, doc):
    kw = {}
    if doc["daemonset"]:
        kw["owner_references"] = (p.OwnerReference(kind="DaemonSet", name="agent"),)
    if doc["opt_out"]:
        kw["annotations"] = {p.EVICT_ANNOTATION: "false"}
    return make_pod(p, doc["name"], cpu=doc["cpu"], node_name=doc["node"],
                    namespace=doc["namespace"], **kw)


def _fuzz_annotations(doc, now):
    if doc is None:
        return {}
    out = {}
    for key, val in doc.items():
        out[key] = val if isinstance(val, str) else anno(val[0], val[1], now=now)
    return out


def fuzz_run(p, plan):
    cfg = plan["config"]
    cluster = p.ClusterState()
    for name, alloc, _, _ in plan["nodes"]:
        cluster.add_node(p.Node(name=name, allocatable=alloc))
    for doc in plan["pods"]:
        cluster.add_pod(_fuzz_pod(p, doc))
    d = p.LoadAwareDescheduler(
        cluster, p.policy,
        p.DeschedulerConfig(
            watermarks=(
                p.WatermarkPolicy("cpu_usage_avg_5m", target=cfg["target"],
                                  threshold=cfg["threshold"]),
                p.WatermarkPolicy("mem_usage_avg_5m", target=cfg["target"],
                                  threshold=cfg["threshold"]),
            ),
            consecutive_syncs=cfg["consecutive_syncs"],
            max_evictions_per_node=cfg["max_evictions_per_node"],
            max_evictions_per_cycle=cfg["max_evictions_per_cycle"],
            node_cooldown_seconds=cfg["node_cooldown_seconds"],
            dry_run=cfg["dry_run"],
        ),
        clock=lambda: NOW,
    )
    trace = []
    for c, cycle in enumerate(plan["cycles"]):
        now = NOW + 60.0 * c
        cluster.patch_node_annotations_bulk({
            name: _fuzz_annotations(doc, now) for name, doc in cycle["annos"].items()
            if doc is not None
        })
        for doc in cycle["arrivals"]:
            cluster.add_pod(_fuzz_pod(p, doc))
        report = d.sync_once(now)
        trace.append(report_dict(report))
        for ev in report.evicted:
            assert ev.pod_key.split("/")[0] not in ("kube-system", "crane-system")
    return trace, d.stats(), pod_keys(cluster)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_cycle_reports_equal_reference(seed):
    plan = fuzz_plan(seed)
    ref, port = both(fuzz_run, plan)
    assert port == ref
    trace = ref[0]
    # the plan exercises what it claims: hot nodes and gates in every run,
    # and evictions (or plans, in dry-run) in most
    assert any(r["hot"] for r in trace)
    assert any(r["skipped"] for r in trace) or any(r["evicted"] or r["planned"] for r in trace)


def test_fuzz_plans_evict_and_gate():
    """Across the fuzz seeds every gate and both outcomes appear."""
    seen, moved = set(), 0
    for seed in range(6):
        trace, _, _ = fuzz_run(PKGS["port"], fuzz_plan(seed))
        for r in trace:
            seen.update(r["skipped"])
            moved += len(r["evicted"]) + len(r["planned"])
    assert moved > 0
    assert {"daemonset", "no_fit", "node_budget"} <= seen


# -- evict_pod: object pods, burst rows, unknown keys, the Evicted event -------


def evict_world(p):
    """8 nodes with allocatable and fresh annotations, an object pod per
    node and a bound 12-row burst; the annotator's event ingestor and a
    drip scheduler (ResourceFit x1, Dynamic x3) watch it."""
    cluster = p.ClusterState()
    names = [f"node-{i}" for i in range(8)]
    for i, name in enumerate(names):
        cluster.add_node(p.Node(
            name=name, annotations={k: anno(0.1 + 0.05 * i) for k in METRICS},
            allocatable={"cpu": "4", "pods": "5"},
        ))
    for i, name in enumerate(names):
        cluster.add_pod(make_pod(p, f"obj-{i}", cpu="1", node_name=name))
    records = p.BindingRecords(1024, 300.0)
    ingestor = p.EventIngestor(cluster, records)
    ingestor.start()
    burst = cluster.add_pod_burst("default", [f"b{i}" for i in range(12)])
    cluster.bind_burst(burst, names, np.array([i % 3 for i in range(12)], dtype=np.int32),
                       now=NOW)
    fit = p.FitTracker(cluster)
    sched = p.Scheduler(cluster, clock=lambda: NOW, **p.sched_kw)
    sched.register(p.ResourceFitPlugin(p.FitTracker(cluster)), weight=1)
    sched.register(p.DynamicPlugin(p.policy, clock=lambda: NOW), weight=3)
    return cluster, names, records, ingestor, fit, sched


def _versions(cluster):
    return (cluster.sched_version, cluster.pod_version, cluster.node_version)


def _events(cluster):
    return [(e.namespace, e.name, e.type, e.reason, e.message, e.count, e.last_timestamp)
            for e in cluster.list_events() if e.reason == "Evicted"]


@pytest.mark.parametrize("key", ["default/obj-0", "default/b1", "default/nope"],
                         ids=["object", "burst_row", "unknown"])
def test_evict_pod_equal_reference(key):
    def scenario(p):
        cluster, names, records, ingestor, fit, sched = evict_world(p)
        small = p.pod_fit_request(make_pod(p, "probe", cpu="500m"))
        fit.refresh()
        t = {"fits_before": fit.fits_mask(names, small).tolist()}
        first = make_pod(p, "first", cpu="1")
        cluster.add_pod(first)
        t["first"] = sched.schedule_one(first).node
        bound_before, v0 = len(records), _versions(cluster)
        t["ok"] = cluster.evict_pod(key, now=NOW + 5)
        t["version_moves"] = [b - a for a, b in zip(v0, _versions(cluster))]
        t["events"] = _events(cluster)
        t["gone"] = cluster.get_pod(key) is None
        t["counts"] = cluster.count_pods_all()
        t["pods"] = pod_keys(cluster)
        # an eviction is no binding: the hot-value heap does not move
        t["bindings_added"] = len(records) - bound_before
        fit.refresh()
        t["fits_after"] = fit.fits_mask(names, small).tolist()
        fresh = p.FitTracker(cluster)
        fresh.refresh()
        t["fits_fresh"] = fresh.fits_mask(names, small).tolist()
        # the next placements see the freed slot as the reference's do
        t["next"] = []
        for j in range(3):
            pod = make_pod(p, f"next-{j}", cpu="1")
            cluster.add_pod(pod)
            t["next"].append(sched.schedule_one(pod).node)
        t["again"] = cluster.evict_pod(key, now=NOW + 6)  # now a 404
        return t

    ref, port = both(scenario)
    assert port == ref
    assert ref["ok"] == (key != "default/nope") and not ref["again"]
    assert ref["bindings_added"] == 0
    if ref["ok"]:
        assert len(ref["events"]) == 1 and ref["events"][0][3] == "Evicted"
    if key == "default/b1":
        # the reference's burst-row delete moves sched_version but no
        # pod_version, so an incremental FitTracker keeps counting the
        # evicted row's pod slot on node-1 until a full recount; the
        # port keeps that (ROADMAP.md Queue 3)
        assert ref["version_moves"] == [1, 0, 0]
        assert ref["fits_after"][1] is False and ref["fits_fresh"][1] is True


def test_evicted_event_is_not_a_binding():
    """The annotator's ingestor takes only Scheduled events: an eviction
    leaves every node's hot value where it was, in both packages."""
    def scenario(p):
        cluster, names, records, ingestor, _, _ = evict_world(p)
        before = [records.get_last_node_binding_count(n, 300.0, NOW + 10) for n in names]
        for key in ("default/obj-1", "default/b0", "default/b4"):
            assert cluster.evict_pod(key, now=NOW + 5)
        after = [records.get_last_node_binding_count(n, 300.0, NOW + 10) for n in names]
        return before, after

    ref, port = both(scenario)
    assert port == ref and ref[0] == ref[1] and sum(ref[0]) == 12


# -- the degraded interlock -----------------------------------------------------


def test_degraded_interlock_suspends_like_reference():
    def scenario(p):
        cluster = p.ClusterState()
        for i in range(10):
            cluster.add_node(p.Node(name=f"n{i}", annotations={
                k: anno(0.9 if i < 2 else 0.2) for k in METRICS}))
            cluster.add_pod(make_pod(p, f"w{i}", node_name=f"n{i}"))
        degraded = p.DegradedModeController(p.policy.spec, enter_fraction=0.5,
                                            exit_fraction=0.25)
        d = p.LoadAwareDescheduler(
            cluster, p.policy,
            p.DeschedulerConfig(watermarks=(p.WatermarkPolicy(
                "cpu_usage_avg_5m", target=0.5, threshold=0.7),), consecutive_syncs=1),
            clock=lambda: NOW, degraded=degraded,
        )
        trace = []
        # fresh: evicts; then most annotations go stale (12 h old, past
        # every active window): suspended; then fresh again: resumes
        for c, stale in enumerate((0, 7, 7, 2, 0)):
            now = NOW + 43_200.0 * c
            cluster.patch_node_annotations_bulk({
                f"n{i}": {k: anno(0.9 if i < 2 else 0.2,
                                  age_seconds=43_200.0 if i >= 10 - stale else 0.0, now=now)
                          for k in METRICS}
                for i in range(10)
            })
            trace.append((report_dict(d.sync_once(now)), degraded.active))
        return trace, d.stats()

    ref, port = both(scenario)
    assert port == ref
    suspended = [r["suspended"] for r, _ in ref[0]]
    assert suspended == [False, True, True, False, False]


# -- config 11's closed loop at its own 8 nodes ---------------------------------

LOOP_HOT, LOOP_COOL, LOOP_CYCLES = 2, 6, 12


def closed_loop(p, mode: str):
    """bench_suite.py config 11 on the in-memory mirror: annotate from pod
    requests, descheduler cycle, re-place each evictee (``none``: no
    descheduler; ``one``: ``schedule_one`` per evictee; ``queue``: the
    cycle's evictees through ``schedule_queue``)."""
    alloc_milli = 16_000
    cluster = p.ClusterState()
    hot = [f"hot-{i}" for i in range(LOOP_HOT)]
    cool = [f"cool-{i}" for i in range(LOOP_COOL)]
    names = hot + cool
    for name in names:
        cluster.add_node(p.Node(name=name, allocatable={"cpu": "16", "pods": "110"}))
    for node in hot:
        for j in range(12):
            cluster.add_pod(make_pod(p, f"{node}-w{j}", cpu="1", node_name=node))
        cluster.add_pod(make_pod(p, f"{node}-ds", cpu="1", node_name=node,
                                 owner_references=(p.OwnerReference(kind="DaemonSet",
                                                                    name="agent"),)))
        cluster.add_pod(make_pod(p, f"{node}-sys", cpu="1", node_name=node,
                                 namespace="kube-system"))
    for node in cool:
        cluster.add_pod(make_pod(p, f"{node}-w0", cpu="1", node_name=node))

    def milli():
        return {n: sum(p.pod_fit_request(q).milli_cpu for q in cluster.list_pods(n))
                for n in names}

    def utilization():
        return {n: m / alloc_milli for n, m in milli().items()}

    clock = [NOW]
    desched = sched = None
    if mode != "none":
        desched = p.LoadAwareDescheduler(
            cluster, p.policy,
            p.DeschedulerConfig(
                watermarks=(p.WatermarkPolicy("cpu_usage_avg_5m", target=0.32,
                                              threshold=0.35),),
                consecutive_syncs=2, max_evictions_per_node=2,
                max_evictions_per_cycle=4, node_cooldown_seconds=0.0,
            ),
            clock=lambda: clock[0],
        )
        sched = p.Scheduler(cluster, clock=lambda: clock[0], **p.sched_kw)
        sched.register(p.ResourceFitPlugin(p.FitTracker(cluster)), weight=1)
        sched.register(p.DynamicPlugin(p.policy, clock=lambda: clock[0]), weight=3)
    reports, placed = [], []
    for cycle in range(LOOP_CYCLES):
        clock[0] = NOW + 60.0 * cycle
        stamp = format_local_time(clock[0])
        cluster.patch_node_annotations_bulk({
            n: {m: f"{u:.5f},{stamp}" for m in METRICS} for n, u in utilization().items()})
        if desched is None:
            continue
        report = desched.sync_once(clock[0])
        reports.append(report_dict(report))
        moved = [make_pod(p, f"moved-{cycle}-{i}", cpu="1")
                 for i in range(len(report.evicted))]
        for pod in moved:
            cluster.add_pod(pod)
        if mode == "queue":
            results = sched.schedule_queue(moved, window=4)
        else:
            results = [sched.schedule_one(pod) for pod in moved]
        placed.append([r.node for r in results])
    util = utilization()
    vals = list(util.values())
    stats = sched.drip_stats() if sched is not None else None
    return {"reports": reports, "placed": placed, "util": util,
            "total_milli": sum(milli().values()),
            "imbalance": max(vals) / (sum(vals) / len(vals)), "stats": stats}


def test_closed_loop_placements_equal_reference():
    ref_none = closed_loop(PKGS["ref"], "none")
    ref = closed_loop(PKGS["ref"], "one")
    port_one = closed_loop(PKGS["port"], "one")
    port_queue = closed_loop(PKGS["port"], "queue")
    for leg in (port_one, port_queue):
        assert leg["reports"] == ref["reports"]
        assert leg["placed"] == ref["placed"]
        assert leg["util"] == ref["util"]
    assert closed_loop(PKGS["port"], "none")["util"] == ref_none["util"]
    # the queue leg really went through the drip window
    assert port_queue["stats"]["batch"]["dispatches"] > 0
    # config 11's gates: every evictee re-placed, no protected victim,
    # requested cpu conserved, imbalance down by at least 2x
    evicted = [e for r in ref["reports"] for e in r["evicted"]]
    assert evicted and all(node is not None for cyc in ref["placed"] for node in cyc)
    assert sum(map(len, ref["placed"])) == len(evicted)
    assert all(e["pod_key"].startswith("default/") and not e["pod_key"].endswith("-ds")
               for e in evicted)
    assert ref["total_milli"] == ref_none["total_milli"] == (LOOP_HOT * 14 + LOOP_COOL) * 1000
    assert ref_none["imbalance"] / ref["imbalance"] >= 2.0
