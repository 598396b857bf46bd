"""The port's overload and resilience layers against the JAX package's.

Each scenario runs the same injected-clock call sequence through both
packages' copies of ``service/deadline.py``, ``service/overload.py``,
``resilience/breaker.py``, ``resilience/health.py`` and
``resilience/degraded.py`` and records every decision, retry-after
value, tier, state and exposition line; the port's trace must equal the
reference's exactly. A few absolute checks pin that the scenarios
exercise what they claim to.
"""

import http.client
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import crane_scheduler_tpu.resilience.breaker as ref_breaker
import crane_scheduler_tpu.resilience.degraded as ref_degraded
import crane_scheduler_tpu.resilience.health as ref_health
import crane_scheduler_tpu.service.deadline as ref_deadline
import crane_scheduler_tpu.service.overload as ref_overload
import crane_scheduler_tpu_torch.resilience.breaker as port_breaker
import crane_scheduler_tpu_torch.resilience.degraded as port_degraded
import crane_scheduler_tpu_torch.resilience.health as port_health
import crane_scheduler_tpu_torch.service.deadline as port_deadline
import crane_scheduler_tpu_torch.service.overload as port_overload
from crane_scheduler_tpu.policy import DEFAULT_POLICY as REF_POLICY
from crane_scheduler_tpu.service import ScoringHTTPServer as RefServer
from crane_scheduler_tpu.service import ScoringService as RefService
from crane_scheduler_tpu.telemetry import Telemetry as RefTelemetry
from crane_scheduler_tpu.utils import format_local_time
from crane_scheduler_tpu_torch.convert import cluster_from_nodes
from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY
from crane_scheduler_tpu_torch.service import ScoringHTTPServer, ScoringService
from crane_scheduler_tpu_torch.telemetry import Telemetry

from test_torch_service import as_port, numpy_nodes, ref_cluster_from

PKGS = {
    "ref": SimpleNamespace(
        deadline=ref_deadline, overload=ref_overload, breaker=ref_breaker,
        health=ref_health, degraded=ref_degraded, Telemetry=RefTelemetry,
        policy=REF_POLICY,
    ),
    "port": SimpleNamespace(
        deadline=port_deadline, overload=port_overload, breaker=port_breaker,
        health=port_health, degraded=port_degraded, Telemetry=Telemetry,
        policy=DEFAULT_POLICY,
    ),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def both(scenario):
    """The scenario's trace on the reference and on the port."""
    return scenario(PKGS["ref"]), scenario(PKGS["port"])


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _exposition(tel):
    return tel.registry.render()


# -- deadlines ----------------------------------------------------------------


def test_deadline_parsing_and_expiry_equal_reference():
    def scenario(p):
        d = p.deadline
        trace = [d.parse_budget_ms(v) for v in (
            "250", "  1.5 ", 300, -5.0, None, "", "abc", "nan", "inf",
            "-inf", True, [1], {}, "1e3", " -0 ")]
        dl = d.Deadline.from_budget_ms(250.0, now=100.0)
        for t in (100.0, 100.1, 100.2, 100.25, 100.3, 200.0):
            trace.append((dl.remaining_ms(now=t), dl.expired(now=t), dl.header_value(now=t)))
        try:
            dl.check("dispatch", now=100.4)
        except d.DeadlineExpiredError as e:
            trace.append((type(e).__name__, e.stage, round(e.overrun_ms, 9)))
        dl.check("dispatch", now=100.1)
        headers = {d.HEADER: "50"}
        anchored = d.anchor_headers(headers, now=10.0)
        trace.append((anchored.expired(now=10.01), sorted(headers)))
        later = d.from_headers(headers, now=10.2)
        trace.append((later.expired(now=10.2), round(later.remaining_ms(now=10.2), 9)))
        fresh = d.from_headers({d.HEADER: "50"}, now=10.2)
        trace.append(fresh.expired(now=10.2))
        trace.append((d.from_headers({}), d.from_headers({d.HEADER: "garbage"}),
                      d.anchor_headers({d.HEADER: "inf"})))
        outer = d.Deadline.from_budget_ms(10_000.0, now=0.0)
        trace.append(d.current() is None)
        with d.use(outer):
            with d.use(None):
                trace.append(d.current() is outer)
        trace.append(d.current() is None)
        return trace

    ref, port = both(scenario)
    assert port == ref
    assert ref[3] == -5.0 and ref[4] is None


# -- admission primitives -------------------------------------------------------


def test_token_bucket_decisions_equal_reference():
    def scenario(p):
        trace = []
        for rate, burst in ((10.0, 2.0), (0.5, 1.0), (0.0, 1.0), (3.0, 4.5)):
            b = p.overload.TokenBucket(rate=rate, burst=burst)
            for now in (0.0, 0.0, 0.0, 0.05, 0.11, 0.11, 0.4, 2.0, 2.0, 9.0):
                trace.append((b.try_take(now), round(b.retry_after_s(now), 12)))
        return trace

    ref, port = both(scenario)
    assert port == ref
    assert [t[0] for t in ref[:3]] == [True, True, False]
    assert ref[2][1] == pytest.approx(0.1)


def test_gradient_limiter_limits_equal_reference():
    rng = np.random.default_rng(0)
    lat = np.concatenate([
        np.full(20, 0.01), rng.uniform(0.15, 0.25, 40), rng.uniform(0.005, 0.02, 300),
        rng.uniform(0.01, 0.5, 60),
    ]).tolist()

    def scenario(p):
        lim = p.overload.GradientLimiter(min_limit=1, max_limit=32, initial=32)
        trace = []
        for v in lat:
            lim.observe(v)
            trace.append((lim.limit, lim.baseline_s))
        return trace

    ref, port = both(scenario)
    assert port == ref
    limits = [t[0] for t in ref]
    assert min(limits[20:60]) < 16 and limits[359] == 32


def test_tenant_queues_order_equal_reference():
    rng = np.random.default_rng(1)
    ops = [(int(rng.integers(0, 3)), int(rng.integers(0, 4))) for _ in range(400)]

    def scenario(p):
        q = p.overload.TenantQueues(depth=5, weights={"gold": 2.0, "bronze": 1.0})
        tenants = ("gold", "bronze", "free")
        trace = []
        for i, (tenant, op) in enumerate(ops):
            if op < 3:
                trace.append(("push", q.push(tenants[tenant], i)))
            else:
                trace.append(("pop", q.pop()))
            trace.append(len(q))
        while len(q):
            trace.append(q.pop())
        return trace

    ref, port = both(scenario)
    assert port == ref
    assert ("push", False) in ref  # the per-tenant bound was hit


def test_admission_controller_decisions_equal_reference():
    def scenario(p):
        o, d = p.overload, p.deadline
        clock = Clock(1000.0)
        tel = p.Telemetry()
        brown = o.BrownoutController(telemetry=tel, stale_budget_s=5.0)
        adm = o.AdmissionController(
            limiter=o.GradientLimiter(min_limit=1, max_limit=3, initial=3),
            queues=o.TenantQueues(depth=2, weights={"gold": 2.0}),
            tenant_rate=2.0, tenant_burst=2.0, tenant_rates={"gold": 10.0},
            retry_after_s=0.25, brownout=brown, telemetry=tel, clock=clock,
        )
        trace = []

        def decide(method, target, headers, dt=0.0):
            clock.t += dt
            dec = adm.classify(method, target, headers)
            trace.append(None if dec is None else
                         (dec.status, dec.reason, round(dec.retry_after_s, 12)))

        for dt in (0.0, 0.0, 0.0, 0.1, 0.6):
            decide("POST", "/v1/score", {}, dt)
        decide("GET", "/healthz", {})
        decide("GET", "/metrics?x=1", {})
        decide("POST", "/v1/score", {d.HEADER: "-1", "crane-tenant": "b"})
        decide("POST", "/v1/score", {d.HEADER: "500", "crane-tenant": "b"})
        for _ in range(4):
            decide("POST", "/v1/assign", {"crane-tenant": "gold"}, 0.01)
        # slots: three under the limit, then the queue, then handoff
        trace.append([adm.acquire() for _ in range(4)])
        trace.append([adm.queue(t, f"{t}-{i}") for i, t in
                      enumerate(("gold", "gold", "gold", "b", "b"))])
        trace.append((adm.pressure(), brown.tier))
        trace.append([adm.finish() for _ in range(5)])
        trace.append(adm.abandon())
        # pressure pushes tier 2: background priority sheds 503
        brown.note(3.5, now=clock.t)
        decide("POST", "/v1/score", {"crane-tenant": "c", "crane-priority": "low"}, 5.0)
        decide("POST", "/v1/score", {"crane-tenant": "c", "crane-priority": "1"}, 0.0)
        decide("POST", "/v1/score", {"crane-tenant": "d", "crane-priority": "3"}, 0.0)
        for v in (0.01, 0.01, 0.3, 0.3, 0.3):
            adm.observe(v)
        trace.append((dict(adm.stats), adm.limiter.limit, brown.tier))
        trace.append(_exposition(tel))
        return trace

    ref, port = both(scenario)
    assert port == ref
    assert ref[2] == (429, "rate_limit", 0.5)  # the bucket's wait beats the floor
    assert ref[7] == (504, "deadline_parse", 0.0)
    assert any(isinstance(t, tuple) and t[:2] == (503, "priority") for t in ref)


def test_brownout_tiers_equal_reference():
    pressures = [0.5, 1.3, 1.1, 0.7, 3.2, 2.0, 1.4, 0.9, 0.79, 4.0, 0.5, 0.2]

    def scenario(p):
        tel = p.Telemetry()
        health = p.health.HealthRegistry(telemetry=tel)
        degraded = SimpleNamespace(active=False)
        bo = p.overload.BrownoutController(telemetry=tel, health=health, degraded=degraded)
        trace = []
        for i, pr in enumerate(pressures):
            trace.append((bo.note(pr, now=float(i)), bo.tier, bo.pressure,
                          json.dumps(health.snapshot(), sort_keys=True)))
        degraded.active = True
        trace.append(bo.tier)  # a degraded cluster floors the tier at 1
        try:
            p.overload.BrownoutController(enter1=1.0, exit1=1.2)
        except ValueError as e:
            trace.append(str(e))
        trace.append(_exposition(tel))
        return trace

    ref, port = both(scenario)
    assert port == ref
    assert [t[0] for t in ref[:12]] == [0, 1, 1, 0, 2, 2, 1, 1, 0, 2, 0, 0]
    assert ref[12] == 1


# -- resilience ---------------------------------------------------------------


def test_circuit_breaker_states_equal_reference():
    def scenario(p):
        clock = Clock(0.0)
        tel = p.Telemetry()
        health = p.health.HealthRegistry(telemetry=tel)
        transitions = []
        br = p.breaker.CircuitBreaker(
            "device-dispatch", failure_threshold=3, window_s=10.0,
            reset_timeout_s=5.0, min_calls=2, clock=clock, telemetry=tel,
            on_transition=lambda t, to: transitions.append((t, to)),
        )
        health.watch_breaker(br)
        trace = []
        script = ["ok", "fail", "fail", "ok", "fail", "fail", "fail", "allow",
                  "tick6", "allow", "fail", "tick6", "allow", "ok", "ok",
                  "fail", "tick11", "fail", "fail", "fail", "call_ok", "call_fail"]
        for step in script:
            if step.startswith("tick"):
                clock.t += float(step[4:])
                trace.append(("state", br.state))
                continue
            if step == "allow":
                trace.append(("allow", br.allow(), round(br.retry_after_s(), 12)))
                continue
            if step.startswith("call"):
                def fn():
                    if step == "call_fail":
                        raise RuntimeError("boom")
                    return 7
                try:
                    trace.append(("call", br.call(fn)))
                except Exception as e:
                    trace.append(("call", type(e).__name__))
                continue
            admitted = br.allow()
            if admitted:
                (br.record_success if step == "ok" else br.record_failure)()
            trace.append((step, admitted, br.state))
            clock.t += 0.5
        trace.append(transitions)
        trace.append(json.dumps(health.snapshot(), sort_keys=True))
        trace.append(_exposition(tel))
        return trace

    ref, port = both(scenario)
    assert port == ref
    assert ("state", "half-open") in ref and any(
        isinstance(t, list) and ("device-dispatch", "open") in t for t in ref)


def test_health_registry_equal_reference():
    def scenario(p):
        tel = p.Telemetry()
        h = p.health.HealthRegistry(telemetry=tel)
        S = p.health.HealthState
        trace = [h.overall(), h.snapshot()]
        h.set("kube-read", S.HEALTHY)
        h.set("prometheus", S.DEGRADED, "scrapes failing")
        trace += [h.overall(), h.get("prometheus"), h.snapshot()]
        h.set("device", S.FAILED, "lost")
        trace += [h.overall(), h.snapshot()]
        try:
            h.set("x", "sideways")
        except ValueError as e:
            trace.append(str(e))
        trace.append(_exposition(tel))
        return trace

    ref, port = both(scenario)
    assert port == ref
    assert ref[-3]["status"] == "failed"


def test_degraded_mode_controller_equal_reference():
    now, nodes = numpy_nodes(21, n_nodes=40)
    annos = [n["annotations"] for n in nodes]
    fresh = {m: f"0.3,{format_local_time(now + 15000.0)}"
             for m in ("cpu_usage_avg_5m", "mem_usage_avg_5m")}

    def scenario(p):
        tel = p.Telemetry()
        health = p.health.HealthRegistry(telemetry=tel)
        seen = []
        ctl = p.degraded.DegradedModeController(
            p.policy.spec, enter_fraction=0.5, exit_fraction=0.25,
            min_nodes=4, min_eval_interval_s=5.0, telemetry=tel, health=health,
            on_transition=lambda a, f: seen.append((a, f)),
        )
        trace = [ctl.node_is_stale(None, now), ctl.node_is_stale({}, now),
                 [ctl.node_is_stale(a, now + 600.0) for a in annos]]
        for dt in (0.0, 600.0, 1500.0, 12000.0, 20000.0):
            trace.append((ctl.update(annos, now + dt), ctl.stale_fraction))
        trace.append(ctl.update(annos[:3], now))  # too few nodes: hold
        trace.append(ctl.maybe_update(lambda: annos, now + 20001.0))  # throttled
        half = [fresh if i % 3 else a for i, a in enumerate(annos)]
        trace.append((ctl.update(half, now + 15000.0), ctl.stale_fraction))
        healed = [fresh] * len(annos)
        trace.append(ctl.maybe_update(lambda: healed, now + 15010.0))
        trace.append(seen)
        trace.append(json.dumps(health.snapshot(), sort_keys=True))
        trace.append(_exposition(tel))
        return trace

    ref, port = both(scenario)
    assert port == ref
    assert ref[-3] == [(True, 1.0), (False, 0.0)]
    assert ref[10] == (True, 0.35)  # hysteresis holds the mode above exit


# -- the layers wired into the service ---------------------------------------------


def test_device_breaker_routes_to_oracle_like_reference():
    now, nodes = numpy_nodes(22, n_nodes=24)

    def run(p):
        clock = Clock(0.0)
        br = p.breaker.CircuitBreaker("device-dispatch", failure_threshold=2,
                                      window_s=60.0, reset_timeout_s=10.0, clock=clock)
        if p is PKGS["ref"]:
            svc = RefService(ref_cluster_from(nodes), REF_POLICY, clock=lambda: now,
                             snapshot_bucket=128, device_breaker=br)
        else:
            svc = ScoringService(cluster_from_nodes(nodes), DEFAULT_POLICY, device="cpu",
                                 clock=lambda: now, snapshot_bucket=128, device_breaker=br)
        svc.refresh()
        good = svc.scorer
        calls = [0]

        class Broken:
            def __call__(self, *a, **k):
                calls[0] += 1
                raise RuntimeError("device unavailable")

        svc.scorer = Broken()
        trace = []
        for i in range(4):
            v = svc.score_batch(now=now + i)
            trace.append((v.backend, br.state, calls[0]))
        svc.scorer = good
        clock.t += 11.0  # half-open: one probe wins the traffic back
        for i in range(2):
            v = svc.score_batch(now=now + 10 + i)
            trace.append((v.backend.replace("tpu", "cpu"), br.state))
        trace.append(svc.metrics()["fallbacks"])
        return trace

    ref, port = both(run)
    assert port == ref
    # once open, the broken scorer is not called again
    assert ref[3] == ("oracle-fallback", "open", 2) and ref[-1] == 4


@pytest.mark.parametrize("frontend", ["async", "threaded"])
def test_http_admission_and_health_equal_reference(frontend):
    now, nodes = numpy_nodes(23, n_nodes=16)
    results = {}
    for key in ("ref", "port"):
        p = PKGS[key]
        tel = p.Telemetry()
        health = p.health.HealthRegistry(telemetry=tel)
        if key == "ref":
            svc = RefService(ref_cluster_from(nodes), REF_POLICY, clock=lambda: now,
                             snapshot_bucket=128, telemetry=tel)
            cls = RefServer
        else:
            svc = ScoringService(cluster_from_nodes(nodes), DEFAULT_POLICY, device="cpu",
                                 clock=lambda: now, snapshot_bucket=128, telemetry=tel)
            cls = ScoringHTTPServer
        svc.refresh()
        o = p.overload
        adm = None
        if frontend == "async":  # the admission controller rides the IO thread
            adm = o.AdmissionController(
                tenant_rate=0.001, tenant_burst=2.0, retry_after_s=0.5, telemetry=tel,
                clock=lambda: 0.0,
            )
        srv = cls(svc, port=0, frontend=frontend, admission=adm, health=health)
        srv.start()
        out = []
        try:
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=15)
            body = json.dumps({"now": now, "refresh": False}).encode()
            for hdrs in ({}, {}, {}, {"crane-tenant": "b"}, {"crane-deadline-ms": "-1"}):
                conn.request("POST", "/v1/score", body=body,
                             headers={"Content-Type": "application/json", **hdrs})
                resp = conn.getresponse()
                out.append((resp.status, resp.getheader("Retry-After"),
                            as_port(resp.read()) if key == "ref" else resp.read()))
            S = p.health.HealthState
            for state in (S.DEGRADED, S.FAILED):
                health.set("device", state, "probe")
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                out.append((resp.status, resp.read()))
            conn.close()
        finally:
            srv.stop()
        results[key] = out
    assert results["port"] == results["ref"]
    statuses = [r[0] for r in results["port"]]
    if frontend == "async":
        assert statuses == [200, 200, 429, 200, 504, 200, 503]
        assert results["port"][2][1] is not None  # Retry-After
    else:
        assert statuses == [200, 200, 200, 200, 504, 200, 503]
