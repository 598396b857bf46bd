"""The port's fleet plane against the JAX package's.

Socket-free, as ``test_fleet.py`` is: scrape targets fetch exposition
text through callables, and every time-dependent step goes through
``tick(now)``. The same texts and ticks go through both packages'
``telemetry/fleet.py``; the federated renders must be byte-equal, and
the SLO statuses, timelines, anomaly verdicts and role bookkeeping
equal.
"""

import json
from types import SimpleNamespace

import pytest

import crane_scheduler_tpu.telemetry.fleet as ref_fleet
import crane_scheduler_tpu_torch.telemetry.fleet as port_fleet
from crane_scheduler_tpu.policy import DEFAULT_POLICY as REF_POLICY
from crane_scheduler_tpu.service import ScoringService as RefService
from crane_scheduler_tpu.service.http import ServiceRouter as RefRouter
from crane_scheduler_tpu.telemetry import MetricsRegistry as RefRegistry
from crane_scheduler_tpu_torch import __version__
from crane_scheduler_tpu_torch.convert import cluster_from_nodes
from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY
from crane_scheduler_tpu_torch.service import ScoringService
from crane_scheduler_tpu_torch.service.http import ServiceRouter
from crane_scheduler_tpu_torch.telemetry import MetricsRegistry
from crane_scheduler_tpu_torch.telemetry.expfmt import parse_exposition

from test_torch_service import as_port, numpy_nodes, ref_cluster_from

PKGS = {
    "ref": SimpleNamespace(fleet=ref_fleet, Registry=RefRegistry),
    "port": SimpleNamespace(fleet=port_fleet, Registry=MetricsRegistry),
}
SLO_WINDOWS = {"fast_windows": (5.0, 15.0), "slow_windows": (30.0, 60.0)}


def both(scenario):
    return scenario(PKGS["ref"]), scenario(PKGS["port"])


def _no_wall_time(text):
    """Drop the wall-clock scrape duration gauge (the only sample that
    is not a function of the inputs)."""
    return "\n".join(l for l in text.splitlines()
                     if not l.startswith("crane_fleet_scrape_seconds "))


def _no_timing(doc):
    """A JSON status document without its wall-clock scrape timing."""
    if isinstance(doc, dict):
        return {k: _no_timing(v) for k, v in doc.items() if k != "lastScrapeSeconds"}
    if isinstance(doc, list):
        return [_no_timing(v) for v in doc]
    return doc


def _dump(doc):
    return json.dumps(_no_timing(doc), sort_keys=True)


def _process_registry(p, role, scale):
    """A process's registry: counters, gauges, a labeled histogram and
    the build-info gauge, filled from ``scale``."""
    reg = p.Registry()
    p.fleet.register_build_info(reg, role, set_role=False)
    c = reg.counter("crane_service_requests_total", "served", ("endpoint",))
    c.labels(endpoint="/v1/score").inc(3 * scale)
    c.labels(endpoint="/v1/assign").inc(scale)
    reg.gauge("crane_service_inflight", "inflight").set(scale % 4)
    h = reg.histogram("crane_service_request_seconds", "latency",
                      labelnames=("endpoint",), buckets=(0.01, 0.1, 1.0))
    for v in (0.004 * scale, 0.05, 0.5 * scale, 2.0):
        h.labels(endpoint="/v1/score").observe(v)
    reg.counter("crane_service_shed_total", "shed", ("reason",)).labels(
        reason="rate_limit").inc(scale)
    return reg


def test_federated_render_equal_reference():
    texts = {}

    def scenario(p):
        f = p.fleet
        regs = [_process_registry(p, role, s) for role, s in
                (("scorer", 1), ("replica", 2), ("replica", 5))]
        down = {"on": False}
        raw = ["# TYPE t_req_total counter\nt_req_total 10\n"]

        def flaky():
            if down["on"]:
                raise ConnectionRefusedError("down")
            return regs[2].render()

        host = p.Registry()
        fed = f.MetricsFederator([
            f.ScrapeTarget(name="primary", role="scorer", fetch=regs[0].render),
            f.ScrapeTarget(name="replica-0", role=None, fetch=regs[1].render),
            f.ScrapeTarget(name="replica-1", role="replica", fetch=flaky),
            f.ScrapeTarget(name="raw", fetch=lambda: raw[0]),
            f.ScrapeTarget(name="bad", fetch=lambda: "no type decl 1\n"),
        ], registry=host)
        trace = []
        for step in range(4):
            if step == 1:
                raw[0] = "# TYPE t_req_total counter\nt_req_total 3\n"  # a restart
                down["on"] = True
            if step == 2:
                raw[0] = ("# TYPE t_req_total counter\nt_req_total 4\n"
                          "# TYPE crane_service_inflight counter\ncrane_service_inflight 1\n")
                down["on"] = False
            summary = fed.scrape_once()
            trace.append(json.dumps(summary, sort_keys=True))
            trace.append(fed.render())
            trace.append((fed.availability(), fed.reset_count(),
                          fed.counter_total("t_req_total"),
                          fed.counter_total("crane_service_requests_total", role="replica"),
                          fed.histogram_agg("crane_service_request_seconds"),
                          sorted(map(repr, fed.gauge_values("crane_service_inflight")))))
            trace.append(_dump(fed.status()))
        trace.append(_no_wall_time(host.render()))
        texts[p is PKGS["port"]] = fed.render()
        return trace

    ref, port = both(scenario)
    assert port == ref
    assert parse_exposition(texts[True])
    status = json.loads(ref[-2])
    assert status["quarantined"] and "bad" in json.loads(ref[0])["failed"]


def test_slo_ticks_equal_reference():
    def scenario(p):
        f = p.fleet
        events = {"good": 0.0, "bad": 0.0}
        host = p.Registry()
        fed = f.MetricsFederator([])
        eng = f.SLOEngine(
            fed,
            [f.SLOObjective("t_obj", lambda: (events["good"], events["bad"]),
                            objective=0.99, warn_burn=1.0, page_burn=10.0,
                            clear_ticks=3, clear_ratio=0.5)],
            registry=host, **SLO_WINDOWS,
        )
        trace = []
        now = 1000.0
        for phase, n, good, bad in (("warm", 16, 4, 0), ("burn", 17, 0, 4),
                                    ("heal", 40, 4, 0), ("blip", 1, 0, 4)):
            for _ in range(n):
                now += 1.0
                events["good"] += good
                events["bad"] += bad
                status = eng.tick(now)
                trace.append((phase, eng.alert_state("t_obj"),
                              json.dumps(status, sort_keys=True)))
        trace.append(eng.timeline())
        trace.append(json.dumps(eng.status(), sort_keys=True))
        trace.append(host.render())
        trace.append(len(eng._states["t_obj"].history))
        return trace

    ref, port = both(scenario)
    assert port == ref
    assert ref[-4][:4] == [("t_obj", "ok", "warning"), ("t_obj", "warning", "page"),
                           ("t_obj", "page", "warning"), ("t_obj", "warning", "ok")]


def test_fleet_plane_and_anomalies_equal_reference():
    def scenario(p):
        f = p.fleet
        regs = [_process_registry(p, "scorer", 1), _process_registry(p, "replica", 3)]
        text = ["", ""]
        up = {"on": True}

        def replica():
            if not up["on"]:
                raise OSError("down")
            return regs[1].render() + text[0]

        host = p.Registry()
        plane = f.FleetPlane(
            [f.ScrapeTarget(name="replica-0", fetch=replica)],
            registry=host, local_registry=regs[0], local_role="scorer",
            local_name="primary", slo_kwargs=SLO_WINDOWS,
            anomaly_kwargs={"breaker_window_s": 10.0, "breaker_max_flaps": 3,
                            "degraded_max_dwell_s": 5.0, "lag_slope_per_s": 1.0,
                            "lag_min_ticks": 2},
        )
        trace = []
        for i in range(40):
            text[0] = (
                "# TYPE crane_breaker_transitions_total counter\n"
                f"crane_breaker_transitions_total {min(i, 6)}\n"
                "# TYPE crane_degraded_mode gauge\n"
                f"crane_degraded_mode {1 if 10 <= i < 20 else 0}\n"
                "# TYPE crane_replica_lag_versions gauge\n"
                f"crane_replica_lag_versions {10 * max(0, i - 20) if i < 30 else 0}\n"
            )
            up["on"] = not (24 <= i < 30)
            regs[0].counter("crane_service_requests_total", "served",
                            ("endpoint",)).labels(endpoint="/v1/score").inc(2)
            out = plane.tick(now=1000.0 + i)
            trace.append(json.dumps({"slo": out["slo"], "anomalies": out["anomalies"]},
                                    sort_keys=True))
        trace.append(plane.render_metrics())
        trace.append(_dump(plane.slo_status()))
        trace.append(plane.slo.timeline())
        trace.append(_no_wall_time(host.render()))
        return trace

    ref, port = both(scenario)
    assert port == ref
    assert ("scrape_availability", "ok", "warning") in ref[-2]
    fired = [json.loads(t)["anomalies"] for t in ref[:40]]
    assert any(a["breaker_flapping"]["firing"] for a in fired)
    assert any(a["degraded_dwell"]["firing"] for a in fired)
    assert any(a["replication_lag_trend"]["firing"] for a in fired)


def test_build_info_and_process_role_equal_reference():
    def scenario(p):
        f = p.fleet
        old = f.process_role()
        try:
            reg = p.Registry()
            trace = [old]
            child = f.register_build_info(reg, "replica", set_role=False)
            trace.append((f.process_role(), child.value if hasattr(child, "value") else None))
            f.register_build_info(reg, "scorer")
            trace.append(f.process_role())
            f.register_build_info(reg, "router", version="9.9.9", set_role=False)
            trace.append(reg.render())
            f.set_process_role("scheduler")
            trace.append(f.process_role())
            trace.append([(t.name, t.host, t.port, t.path, t.role) for t in f.parse_scrape_flag(
                "scheduler@127.0.0.1:8090,10.0.0.2:9100/custom, ,replica@:7000")])
            return trace
        finally:
            f.set_process_role(old)

    ref, port = both(scenario)
    assert port == ref
    assert f'crane_build_info{{role="scorer",version="{__version__}"}} 1' in port[3]
    assert __version__ == "0.1.0"


def _services():
    now, nodes = numpy_nodes(31, n_nodes=12)
    ref = RefService(ref_cluster_from(nodes), REF_POLICY, clock=lambda: now,
                     snapshot_bucket=128)
    port = ScoringService(cluster_from_nodes(nodes), DEFAULT_POLICY, device="cpu",
                          clock=lambda: now, snapshot_bucket=128)
    ref.refresh()
    port.refresh()
    return now, ref, port


def test_service_router_fleet_endpoints_equal_reference():
    now, ref_svc, svc = _services()
    out = {}
    for key, s, fleet, router_cls in (("ref", ref_svc, ref_fleet, RefRouter),
                                      ("port", svc, port_fleet, ServiceRouter)):
        old = fleet.process_role()
        fleet.register_build_info(s.telemetry.registry, "scorer")
        try:
            bare = router_cls(s)
            missing = [bare.handle("GET", path, {}, b"") for path in ("/fleet/metrics", "/v1/slo")]
            envelopes = [json.loads(bare.handle("GET", path, {}, b"")[2])["role"]
                         for path in ("/debug/lifecycle", "/debug/trace")]
            reg = _process_registry(PKGS[key], "replica", 2)
            plane = fleet.FleetPlane(
                [fleet.ScrapeTarget(name="replica-0", fetch=reg.render)],
                local_registry=reg, local_role="replica", local_name="self",
                slo_kwargs=SLO_WINDOWS,
            )
            router = router_cls(s, fleet=plane)
            score = router.handle("POST", "/v1/score", {}, json.dumps({"now": now}).encode())
            plane.tick(now=1000.0)
            fm = router.handle("GET", "/fleet/metrics", {}, b"")
            slo = router.handle("GET", "/v1/slo", {}, b"")
            out[key] = (missing, envelopes, score[0], score[1],
                        score[2] if key == "port" else as_port(score[2]),
                        fm[0], fm[1], fm[2], slo[0], _dump(json.loads(slo[2])))
        finally:
            fleet.set_process_role(old)
    assert out["port"] == out["ref"]
    missing, envelopes = out["port"][:2]
    assert [m[0] for m in missing] == [404, 404] and envelopes == ["scorer", "scorer"]
    assert json.loads(out["port"][-1])["role"] == "scorer"
    assert json.loads(out["port"][4])["backend"] == "cpu"
    assert parse_exposition(out["port"][7].decode())


@pytest.mark.parametrize("spec", ["", "a@h:1", "h:2/p,b@:3", "x@[::1]:4"])
def test_parse_scrape_flag_equal_reference(spec):
    def scenario(p):
        try:
            return [(t.name, t.host, t.port, t.path, t.role, t.url())
                    for t in p.fleet.parse_scrape_flag(spec)]
        except Exception as e:
            return type(e).__name__, str(e)

    ref, port = both(scenario)
    assert port == ref
