"""The port's open-loop storm generator against the JAX package's.

``StormSchedule`` must give the reference's arrivals for the same seed
and shape, and ``replay_admission`` the reference's decision timeline,
each package replaying through its own ``AdmissionController`` (equality
throughout). Then the wire legs on the port alone, as
``tests/test_overload.py`` runs them on the reference: an open-loop
storm against the port's async front end sheds but serves, and
``SlowClientSwarm`` connections are reaped by the idle timeout while a
busy connection is not. Socket cases carry their own timeouts.
"""

import dataclasses
import json
import signal
import socket
import time

import numpy as np
import pytest
import torch

import crane_scheduler_tpu.resilience.loadgen as ref_loadgen
import crane_scheduler_tpu.service.overload as ref_overload
import crane_scheduler_tpu_torch.resilience.loadgen as port_loadgen
import crane_scheduler_tpu_torch.service.overload as port_overload
from crane_scheduler_tpu_torch.convert import cluster_from_nodes
from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY
from crane_scheduler_tpu_torch.resilience import (
    SlowClientSwarm,
    StormSchedule,
    run_open_loop,
)
from crane_scheduler_tpu_torch.service import ScoringHTTPServer, ScoringService
from crane_scheduler_tpu_torch.service.frontend import AsyncHTTPServer
from crane_scheduler_tpu_torch.utils import format_local_time

NOW = 1753776000.0


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        raise TimeoutError("test case exceeded its 120 s limit")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def arrivals(schedule) -> list:
    return [dataclasses.astuple(a) for a in schedule]


STORMS = {
    "canonical": lambda lg: lg.StormSchedule.storm(
        11, baseline_rps=100, storm_x=3.0, warm_s=1.0, storm_s=2.0, cool_s=1.0),
    "bench17": lambda lg: lg.StormSchedule.storm(
        17, baseline_rps=150, storm_x=3.0, warm_s=0.5, storm_s=1.0, cool_s=0.5,
        tenants=("a", "b")),
    "tenants_priority_deadline": lambda lg: lg.StormSchedule(
        23, duration_s=2.0, phases=[(0.0, 80.0), (0.5, 400.0), (1.5, 40.0)],
        tenants=("gold", "silver", "bronze"), low_priority_frac=0.3, deadline_ms=250.0),
    "dead_phase": lambda lg: lg.StormSchedule(
        5, duration_s=3.0, phases=[(0.0, 50.0), (1.0, 0.0), (2.0, 120.0)]),
}


@pytest.mark.parametrize("storm", sorted(STORMS))
def test_storm_schedule_equals_reference(storm):
    ref = STORMS[storm](ref_loadgen)
    port = STORMS[storm](port_loadgen)
    assert arrivals(port) == arrivals(ref) and len(ref) > 50
    assert (port.seed, port.duration_s, port.phases, port.tenants) == \
        (ref.seed, ref.duration_s, ref.phases, ref.tenants)
    headers = [port_loadgen.arrival_headers(a) for a in port]
    assert headers == [ref_loadgen.arrival_headers(a) for a in ref]


def _factory(overload, variant):
    def make(clock):
        o = overload
        if variant == "plain":
            return o.AdmissionController(
                limiter=o.GradientLimiter(min_limit=1, max_limit=4, initial=4),
                queues=o.TenantQueues(depth=8), tenant_rate=0.0, clock=clock)
        if variant == "rates":
            return o.AdmissionController(
                limiter=o.GradientLimiter(min_limit=2, max_limit=4, initial=4),
                queues=o.TenantQueues(depth=2), tenant_rate=60.0, tenant_burst=5.0,
                tenant_rates={"gold": 200.0}, clock=clock)
        return o.AdmissionController(
            limiter=o.GradientLimiter(min_limit=1, max_limit=3, initial=3),
            queues=o.TenantQueues(depth=4), tenant_rate=0.0,
            brownout=o.BrownoutController(), clock=clock)
    return make


@pytest.mark.parametrize("variant", ["plain", "rates", "brownout"])
@pytest.mark.parametrize("storm", ["bench17", "tenants_priority_deadline"])
def test_replay_admission_timeline_equals_reference(storm, variant):
    sched = STORMS[storm](port_loadgen)
    ref = ref_loadgen.replay_admission(
        STORMS[storm](ref_loadgen).arrivals, _factory(ref_overload, variant),
        service_time_s=0.02)
    port = port_loadgen.replay_admission(
        sched.arrivals, _factory(port_overload, variant), service_time_s=0.02)
    assert port == ref
    assert port_loadgen.timeline_counts(port) == ref_loadgen.timeline_counts(ref)
    # same seed, same timeline: the replay is a pure function of its inputs
    again = port_loadgen.replay_admission(
        sched.arrivals, _factory(port_overload, variant), service_time_s=0.02)
    assert again == port
    counts = port_loadgen.timeline_counts(port)
    assert counts.get("admit", 0) + counts.get("dequeue", 0) > 0
    assert any(k.startswith("shed:") for k in counts)


# -- the wire legs on the port ---------------------------------------------------


def _recv_http_responses(sock, count, timeout=15.0):
    """Read ``count`` Content-Length-framed responses off a raw socket."""
    sock.settimeout(timeout)
    buf = bytearray()
    out = []
    while len(out) < count:
        head_end = buf.find(b"\r\n\r\n")
        if head_end < 0:
            chunk = sock.recv(65536)
            assert chunk, "server closed mid-response"
            buf += chunk
            continue
        head = bytes(buf[:head_end]).decode("latin-1")
        length = 0
        for line in head.split("\r\n")[1:]:
            name, _, value = line.partition(":")
            if name.strip().lower() == "content-length":
                length = int(value.strip())
        total = head_end + 4 + length
        while len(buf) < total:
            chunk = sock.recv(65536)
            assert chunk, "server closed mid-body"
            buf += chunk
        out.append((head, bytes(buf[head_end + 4:total])))
        del buf[:total]
    return out


def _get(target):
    return f"GET {target} HTTP/1.1\r\nHost: t\r\n\r\n".encode()


def _post(target, payload):
    body = json.dumps(payload).encode()
    return (
        f"POST {target} HTTP/1.1\r\nHost: t\r\n"
        f"Content-Type: application/json\r\nContent-Length: {len(body)}\r\n\r\n"
    ).encode() + body


def _nodes(n=8, seed=31):
    rng = np.random.default_rng(seed)
    stamp = format_local_time(NOW)
    metrics = [sp.name for sp in DEFAULT_POLICY.spec.sync_period]
    return [{"name": f"node-{i}", "annotations": {
        m: f"{rng.uniform(0.05, 0.6):.5f},{stamp}" for m in metrics}} for i in range(n)]


@pytest.fixture()
def overload_server():
    svc = ScoringService(cluster_from_nodes(_nodes()), DEFAULT_POLICY, device="cpu",
                         clock=lambda: NOW, snapshot_bucket=128)
    svc.refresh()
    o = port_overload
    brownout = o.BrownoutController(telemetry=svc.telemetry)
    admission = o.AdmissionController(
        limiter=o.GradientLimiter(min_limit=1, max_limit=2, initial=2),
        queues=o.TenantQueues(depth=4), tenant_rates={"metered": 1.0}, tenant_burst=1.0,
        brownout=brownout, telemetry=svc.telemetry,
    )
    srv = ScoringHTTPServer(svc, port=0, frontend="async", admission=admission,
                            brownout=brownout, idle_timeout_s=5.0)
    srv.start()
    try:
        yield svc, srv, admission
    finally:
        srv.stop()


def test_open_loop_wire_storm_sheds_but_serves(overload_server):
    svc, srv, admission = overload_server
    sched = StormSchedule(19, duration_s=1.0, phases=[(0.0, 60.0)], tenants=("metered",))
    results = run_open_loop(
        "127.0.0.1", srv.port, sched.arrivals,
        body=json.dumps({"refresh": False}).encode(),
        target="/v1/score", time_scale=1.0, timeout_s=15.0,
    )
    statuses = [r.status for r in results]
    assert len(statuses) == len(sched) and all(r.error is None for r in results)
    assert statuses.count(429) > 0, statuses
    assert statuses.count(200) >= 1, statuses
    assert all(s in (200, 429, 503) for s in statuses), statuses
    with socket.create_connection(("127.0.0.1", srv.port), timeout=10) as sock:
        sock.sendall(_get("/healthz"))
        (head, _), = _recv_http_responses(sock, 1)
    assert head.startswith("HTTP/1.1 200")
    assert admission.stats["shed"] >= statuses.count(429)
    assert svc.metrics()["fallbacks"] == 0


def test_idle_reaper_frees_slowloris_connections():
    def slow_handler(method, target, headers, body):
        time.sleep(0.7)  # far past the idle window, but job-active
        return 200, "application/json", b'{"ok": true}'

    srv = AsyncHTTPServer(slow_handler, workers=2, idle_timeout_s=0.25)
    srv.start()
    try:
        legit = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        legit.sendall(_post("/v1/score", {}))
        with SlowClientSwarm("127.0.0.1", srv.port, count=3) as swarm:
            assert swarm.wait_closed(3, timeout_s=10.0) == 3
        assert srv.idle_closed >= 3
        # the in-flight request rode out a job longer than the idle window
        (head, body), = _recv_http_responses(legit, 1, timeout=10.0)
        assert head.startswith("HTTP/1.1 200") and json.loads(body) == {"ok": True}
        legit.close()
    finally:
        srv.stop()
