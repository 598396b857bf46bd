"""The port's scoring sidecar against the JAX package's, byte for byte.

Each case builds the same cluster twice, once per package (a reference
``Simulator`` after one annotator pass, carried over with
``convert.cluster_from_nodes``, or a seeded numpy cluster with stale,
missing, NaN and hot-valued annotations), runs the same call sequence
through ``crane_scheduler_tpu.service`` and
``crane_scheduler_tpu_torch.service`` (``device="cpu"``), and compares
the rendered bodies as bytes after mapping the reference's
``"backend": "tpu"`` to the port's device type ``"cpu"``. Tolerance:
exact.

The port's float32 service follows ``BatchedScorer(float32)``, so it is
held against the reference's ``backend="xla"`` in float32, not
``"pallas"``: the reference's Pallas body may fold ``w*100`` and come out
one higher at a truncation boundary (see ``test_torch_scorer.py``).

Only a service built on the CPU fails open to the oracle and the host
solver, as the reference does; on the card a broken device path is an
error (a 500 over HTTP).
"""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crane_scheduler_tpu.cluster import ClusterState as RefCluster
from crane_scheduler_tpu.cluster import Node as RefNode
from crane_scheduler_tpu.cluster import Pod as RefPod
from crane_scheduler_tpu.policy import DEFAULT_POLICY as REF_POLICY
from crane_scheduler_tpu.resilience import DegradedModeController as RefDegraded
from crane_scheduler_tpu.service import ScoringHTTPServer as RefServer
from crane_scheduler_tpu.service import ScoringService as RefService
from crane_scheduler_tpu.service import deadline as ref_deadline
from crane_scheduler_tpu.service.overload import BrownoutController as RefBrownout
from crane_scheduler_tpu.sim import SimConfig, Simulator
from crane_scheduler_tpu.telemetry import DecisionTraceBuffer as RefDecisions
from crane_scheduler_tpu.telemetry import Telemetry as RefTelemetry
from crane_scheduler_tpu.utils import format_local_time
from crane_scheduler_tpu_torch.cluster import ClusterState, Pod
from crane_scheduler_tpu_torch.convert import cluster_from_nodes
from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY
from crane_scheduler_tpu_torch.resilience import CircuitBreaker, DegradedModeController
from crane_scheduler_tpu_torch.resilience.breaker import BreakerOpenError
from crane_scheduler_tpu_torch.service import ScoringHTTPServer, ScoringService
from crane_scheduler_tpu_torch.service import deadline as port_deadline
from crane_scheduler_tpu_torch.service.overload import BrownoutController
from crane_scheduler_tpu_torch.telemetry import DecisionTraceBuffer, Telemetry
from crane_scheduler_tpu_torch.telemetry.expfmt import parse_exposition

REPO = Path(__file__).resolve().parents[1]
NOW = 1753776000.0
METRICS = [sp.name for sp in REF_POLICY.spec.sync_period]
BUCKET = 128
TIMING_KEYS = ("last_score_seconds", "score_seconds_total",
               "score_p50_seconds", "score_p99_seconds")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is faster here and leaves the
    other test workers their cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- twin clusters --------------------------------------------------------------


def sim_nodes(seed, n_nodes=64):
    """A reference simulator after one annotator pass: its clock's now
    and its nodes as plain mappings."""
    sim = Simulator(SimConfig(n_nodes=n_nodes, seed=seed))
    sim.sync_metrics()
    nodes = [
        {"name": n.name, "annotations": dict(n.annotations),
         "labels": dict(n.labels), "allocatable": dict(n.allocatable)}
        for n in sim.cluster.list_nodes()
    ]
    return sim.clock.now(), nodes


def numpy_nodes(seed, n_nodes=64, now=NOW):
    """Seeded annotations with stale, missing, NaN, negative, boundary and
    hot values."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n_nodes):
        anno = {}
        for m in METRICS:
            roll = rng.random()
            if roll < 0.06:
                continue  # missing
            age = float(rng.choice([0, 30, 170, 479, 481, 2000]))
            if roll < 0.12:
                val = str(rng.choice(["NaN", "-0.3", "bogus"]))
            elif roll < 0.3:
                val = str(rng.choice(["0.64999", "0.65", "0.65001", "0.75001"]))
            else:
                val = f"{rng.random():.5f}"
            anno[m] = f"{val},{format_local_time(now - age)}"
        if rng.random() < 0.7:
            hv = str(rng.choice(["0", "1", "2", "0.35", "3", "NaN"]))
            age = float(rng.choice([0, 60, 299, 301]))
            anno["node_hot_value"] = f"{hv},{format_local_time(now - age)}"
        nodes.append({"name": f"node-{i:04d}", "annotations": anno})
    return now, nodes


def ref_cluster_from(nodes):
    cluster = RefCluster()
    for n in nodes:
        cluster.add_node(RefNode(name=n["name"], annotations=dict(n["annotations"]),
                                 labels=dict(n.get("labels") or {})))
    return cluster


class Twins:
    """One cluster in both packages, a service on each, one fixed clock."""

    def __init__(self, now, nodes, dtype="f64", **kw):
        self.now = now
        self.clock = lambda: self.now
        self.ref_cluster = ref_cluster_from(nodes)
        self.cluster = cluster_from_nodes(nodes)
        ref_dtype, dt = {"f64": (jnp.float64, torch.float64),
                         "f32": (jnp.float32, torch.float32)}[dtype]
        ref_kw = {k: v for k, v in kw.items() if not k.startswith("port_")}
        port_kw = {k: v for k, v in kw.items() if not k.startswith("ref_")}
        self.ref = RefService(
            self.ref_cluster, REF_POLICY, dtype=ref_dtype, clock=self.clock,
            snapshot_bucket=BUCKET,
            **{k.removeprefix("ref_"): v for k, v in ref_kw.items()},
        )
        self.port = ScoringService(
            self.cluster, DEFAULT_POLICY, dtype=dt, device="cpu",
            clock=self.clock, snapshot_bucket=BUCKET,
            **{k.removeprefix("port_"): v for k, v in port_kw.items()},
        )

    def refresh(self):
        self.ref.refresh()
        self.port.refresh()

    def patch(self, name, key, value):
        self.ref_cluster.patch_node_annotation(name, key, value)
        self.cluster.patch_node_annotation(name, key, value)

    def both(self, fn):
        return fn(self.ref), fn(self.port)


def as_port(body: bytes) -> bytes:
    """The reference body with its device backend named as the port's."""
    return body.replace(b'"backend": "tpu"', b'"backend": "cpu"')


def counters(svc):
    m = svc.metrics()
    return {k: v for k, v in m.items() if k not in TIMING_KEYS}


def storm(fn, n=6):
    """Run ``fn`` from ``n`` threads released together; return results."""
    barrier = threading.Barrier(n)
    results = [None] * n
    errors = []

    def worker(i):
        barrier.wait()
        try:
            results[i] = fn()
        except Exception as e:  # pragma: no cover - surfaced by assert
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    return results


# -- score bodies -------------------------------------------------------------


@pytest.mark.parametrize("source", ["sim", "numpy"])
def test_f64_score_bodies_equal_reference(source):
    now, nodes = sim_nodes(3) if source == "sim" else numpy_nodes(4)
    tw = Twins(now, nodes)
    tw.refresh()
    for dt in (0.0, 1.0, 29.5, 181.0, 481.0, 3600.0):
        ref, port = tw.both(lambda s: s.score_response_bytes(now=now + dt, refresh=False))
        assert port == as_port(ref), dt
    body = json.loads(port)
    assert body["backend"] == "cpu" and len(body["scores"]) == len(nodes)
    assert tw.port.metrics()["fallbacks"] == 0


@pytest.mark.parametrize("source", ["sim", "numpy"])
def test_f32_score_bodies_equal_reference_xla_f32(source):
    now, nodes = sim_nodes(5) if source == "sim" else numpy_nodes(6)
    tw = Twins(now, nodes, dtype="f32", ref_backend="xla")
    assert tw.port.scorer.dtype == torch.float32
    tw.refresh()
    for dt in (0.0, 2.0, 170.5, 479.0, 900.0):
        ref, port = tw.both(lambda s: s.score_response_bytes(now=now + dt, refresh=False))
        assert port == as_port(ref), dt


def test_cold_hit_and_storm_give_one_body():
    now, nodes = sim_nodes(8)
    tw = Twins(now, nodes)
    tw.refresh()
    cold = tw.port.score_response_bytes(now=now, refresh=False)
    hit = tw.port.score_response_bytes(now=now, refresh=False)
    bodies = storm(lambda: tw.port.score_response_bytes(now=now, refresh=False))
    assert {cold, hit, *bodies} == {cold}
    m = tw.port.metrics()
    assert m["score_calls"] == 1 and m["response_cache_hits"] == 7
    # a storm at a new key shares one dispatch among all six
    bodies = storm(lambda: tw.port.score_response_bytes(now=now + 1.0, refresh=False))
    assert len(set(bodies)) == 1
    m2 = tw.port.metrics()
    assert m2["score_calls"] == 2
    assert (m2["coalesced_scores"] + m2["response_cache_hits"]
            - m["coalesced_scores"] - m["response_cache_hits"]) == 5
    assert bodies[0] == as_port(tw.ref.score_response_bytes(now=now + 1.0, refresh=False))


def test_metrics_counters_equal_reference_after_same_sequence():
    now, nodes = sim_nodes(9)
    tw = Twins(now, nodes)
    name = nodes[0]["name"]

    def sequence(svc, cluster):
        svc.refresh()
        svc.score_response_bytes(now=now, refresh=False)
        svc.score_response_bytes(now=now, refresh=False)  # cache hit
        svc.score_response_bytes(refresh=True)  # gated skip; implicit now == now: hit
        svc.refresh_coalesced()  # skip again
        cluster.patch_node_annotation(name, "node_hot_value",
                                      f"2,{format_local_time(now)}")
        svc.score_response_bytes(now=now + 1.0)  # refresh runs, miss
        svc.score_response_bytes(now=now + 1.0)  # skip + hit
        svc.score_batch(now=now + 2.0)
        svc.assign_batch(10, now=now + 2.0)

    sequence(tw.ref, tw.ref_cluster)
    sequence(tw.port, tw.cluster)
    assert counters(tw.port) == counters(tw.ref)
    m = tw.port.metrics()
    assert (m["refreshes"], m["refresh_skips"], m["response_cache_hits"],
            m["fallbacks"]) == (2, 3, 3, 0)
    # the registry families count the same events
    ref_text = tw.ref.render_prometheus()
    port_text = tw.port.render_prometheus()
    for fam in ("crane_scoring_refreshes_total", "crane_scoring_score_calls_total",
                "crane_scoring_assign_calls_total", "crane_service_coalesced_total",
                "crane_service_response_cache_hits_total", "crane_scoring_nodes",
                "crane_scoring_fallbacks_total"):
        assert (parse_exposition(port_text)[fam]["samples"]
                == parse_exposition(ref_text)[fam]["samples"]), fam


def test_store_write_invalidates_cache():
    now, nodes = numpy_nodes(10)
    tw = Twins(now, nodes)
    tw.refresh()
    first = tw.port.score_response_bytes(now=now, refresh=False)
    assert tw.port.score_response_bytes(now=now, refresh=False) == first
    calls = tw.port.metrics()["score_calls"]
    name = nodes[1]["name"]
    for svc in (tw.ref, tw.port):
        svc.store.set_hot_value(name, 5.0, now)
    ref, fresh = tw.both(lambda s: s.score_response_bytes(now=now, refresh=False))
    assert tw.port.metrics()["score_calls"] == calls + 1
    assert fresh == as_port(ref) and fresh != first


class Broken:
    """A device path that fails: a kernel that did not build or launch."""

    def __init__(self):
        self.calls = 0

    def __call__(self, *a, **k):
        self.calls += 1
        raise RuntimeError("device unavailable")


def test_fail_open_oracle_bodies_equal_reference_and_never_cached():
    now, nodes = numpy_nodes(11)
    tw = Twins(now, nodes)
    tw.refresh()
    assert tw.port.fail_open  # built on the CPU
    good = tw.port.scorer, tw.ref.scorer
    tw.port.scorer = tw.ref.scorer = Broken()
    bodies = storm(lambda: tw.port.score_response_bytes(now=now, refresh=False))
    ref = tw.ref.score_response_bytes(now=now, refresh=False)
    assert set(bodies) == {ref}
    assert json.loads(ref)["backend"] == "oracle-fallback"
    assert tw.port.metrics()["fallbacks"] >= 1
    assert tw.port.metrics()["response_cache_hits"] == 0
    tw.port.scorer, tw.ref.scorer = good
    ref, port = tw.both(lambda s: s.score_response_bytes(now=now, refresh=False))
    assert json.loads(port)["backend"] == "cpu" and port == as_port(ref)


def test_degraded_spread_bodies_equal_reference():
    now, nodes = numpy_nodes(12, n_nodes=16)
    late = now + 20000.0  # past every active window: all annotations stale
    tw = Twins(late, nodes,
               ref_degraded=RefDegraded(REF_POLICY.spec),
               port_degraded=DegradedModeController(DEFAULT_POLICY.spec))
    for i, node in enumerate(nodes[:5]):
        for k in range(i + 1):
            tw.ref_cluster.add_pod(RefPod(name=f"p{i}-{k}", node_name=node["name"]))
            tw.cluster.add_pod(Pod(name=f"p{i}-{k}", node_name=node["name"]))
    tw.refresh()
    assert tw.port.degraded.active and tw.ref.degraded.active
    ref, port = tw.both(lambda s: s.score_response_bytes(now=late, refresh=False))
    assert port == ref and json.loads(port)["backend"] == "degraded-spread"
    assert json.loads(port)["scores"][nodes[4]["name"]] == 95
    assert tw.port.render_prometheus().count("crane_scoring_degraded_scores_total 1") == 1


def test_brownout_serves_the_newest_render():
    now, nodes = numpy_nodes(13)
    tw = Twins(now, nodes)
    tw.refresh()
    first_ref, first = tw.both(lambda s: s.score_response_bytes(now=now, refresh=False))
    tw.ref.brownout, tw.port.brownout = RefBrownout(stale_budget_s=60.0), BrownoutController(stale_budget_s=60.0)
    for svc in (tw.ref, tw.port):
        assert svc.brownout.note(2.0) == 1
    ref, stale = tw.both(lambda s: s.score_response_bytes(now=now + 30.0, refresh=False))
    assert stale == first == as_port(first_ref) and ref == first_ref
    assert counters(tw.port) == counters(tw.ref)
    assert tw.port.metrics()["brownout_served"] == 1


@pytest.mark.parametrize("package", ["ref", "port"])
def test_expired_deadline_sheds_before_dispatch(package):
    now, nodes = numpy_nodes(14, n_nodes=8)
    tw = Twins(now, nodes)
    tw.refresh()
    svc, mod = (tw.ref, ref_deadline) if package == "ref" else (tw.port, port_deadline)
    with mod.use(mod.Deadline.from_budget_ms(-1.0)):
        with pytest.raises(mod.DeadlineExpiredError) as exc:
            svc.score_response_bytes(now=now, refresh=False)
    assert exc.value.stage == "dispatch"
    m = svc.metrics()
    assert m["score_calls"] == 0 and m["expired_at_dispatch"] == 0


# -- assign -----------------------------------------------------------------


def _assignment(a):
    return (a.counts, a.unassigned, a.waterline, a.staleness_seconds)


@pytest.mark.parametrize("with_capacity", [False, True], ids=["nocap", "cap"])
def test_assign_batch_equals_reference(with_capacity):
    now, nodes = sim_nodes(15)
    tw = Twins(now, nodes)
    tw.refresh()
    rng = np.random.default_rng(15)
    cap = None
    if with_capacity:
        cap = {n["name"]: int(c) for n, c in zip(nodes, rng.integers(0, 40, len(nodes)))}
        del cap[nodes[0]["name"]]  # absent nodes are unbounded
    for num_pods in (0, 1, 37, 640, 5000, 100000):
        ref, port = tw.both(lambda s: s.assign_batch(num_pods, capacity=cap, now=now))
        assert _assignment(port) == _assignment(ref), num_pods
        assert port.backend == "cpu" and ref.backend == "tpu"
    assert tw.port.metrics()["fallbacks"] == 0
    snap = tw.port.telemetry.decisions.snapshot()
    assert [d["source"] for d in snap] == ["assign_batch"] * 6


def test_assign_batch_host_fallback_equals_reference():
    now, nodes = numpy_nodes(16)
    tw = Twins(now, nodes)
    tw.refresh()

    tw.ref._gang_solver = tw.port._gang_solver = Broken()
    for num_pods in (3, 500):
        ref, port = tw.both(lambda s: s.assign_batch(num_pods, now=now))
        assert _assignment(port) == _assignment(ref)
        assert port.backend == ref.backend == "host-fallback"
    assert tw.port.metrics()["fallbacks"] == tw.ref.metrics()["fallbacks"] == 2


def test_service_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScoringService(ClusterState(), DEFAULT_POLICY)
    svc = ScoringService(ClusterState(), DEFAULT_POLICY, device="cpu", dtype=torch.float32)
    assert svc.scorer.dtype == torch.float32 and svc.device.type == "cpu"
    assert svc._gang.device.type == "cpu" and svc.fail_open


def on_card(svc):
    """A CPU-built service that takes itself for one on the card: its
    device path now fails as a CUDA service's does."""
    svc.device = torch.device("cuda", 0)
    assert not svc.fail_open
    return svc


@pytest.mark.parametrize("leg", ["score", "assign", "breaker", "async", "threaded"])
def test_card_path_failure_is_an_error(leg):
    now, nodes = numpy_nodes(18, n_nodes=16)
    tw = Twins(now, nodes)
    tw.refresh()
    svc = on_card(tw.port)
    if leg == "score":
        svc.scorer = Broken()
        with pytest.raises(RuntimeError, match="device unavailable"):
            svc.score_response_bytes(now=now, refresh=False)
        assert len(svc._resp_cache) == 0
    elif leg == "assign":
        svc._gang_solver = Broken()
        with pytest.raises(RuntimeError, match="device unavailable"):
            svc.assign_batch(10, now=now)
        assert svc._gang_solver.calls == 1
    elif leg == "breaker":
        # the open breaker keeps the card untouched, and still no oracle
        svc.device_breaker = CircuitBreaker("device-dispatch", failure_threshold=1)
        svc.scorer = broken = Broken()
        with pytest.raises(RuntimeError, match="device unavailable"):
            svc.score_batch(now=now)
        assert svc.device_breaker.state == "open"
        with pytest.raises(BreakerOpenError):
            svc.score_batch(now=now + 1.0)
        assert broken.calls == 1
    else:
        svc.scorer = Broken()
        srv = ScoringHTTPServer(svc, port=0, frontend=leg)
        srv.start()
        try:
            out = _drive(srv.port, [
                ("POST", "/v1/score", {"now": now, "refresh": False}, {}),
                ("POST", "/v1/assign", {"numPods": 10, "now": now}, {}),
                ("GET", "/healthz", None, {}),
            ])[0]
        finally:
            srv.stop()
        assert [r[0] for r in out] == [500, 500, 200]
        assert json.loads(out[0][2]) == {"error": "internal error"}
    assert svc.metrics()["fallbacks"] == 0


# -- HTTP -----------------------------------------------------------------------


def _fixed_telemetry(ref: bool):
    if ref:
        return RefTelemetry(decisions=RefDecisions(clock=lambda: NOW))
    return Telemetry(decisions=DecisionTraceBuffer(clock=lambda: NOW))


def _requests(now, names):
    cap = {n: 3 for n in names[:20]}
    return [
        ("GET", "/healthz", None, {}),
        ("POST", "/v1/score", {"now": now, "refresh": False}, {}),
        ("POST", "/v1/score", {"now": now + 60.0}, {}),
        ("POST", "/v1/score", {"now": "soon"}, {}),
        ("POST", "/v1/score", b"{not json", {}),
        ("POST", "/v1/assign", {"numPods": 100, "now": now}, {}),
        ("POST", "/v1/assign", {"numPods": 100, "capacity": cap, "now": now}, {}),
        ("POST", "/v1/assign", {"numPods": "many"}, {}),
        ("POST", "/v1/refresh", {}, {}),
        ("POST", "/v1/nothing", {}, {}),
        ("GET", "/debug/decisions?n=2", None, {}),
        ("GET", "/debug/decisions?n=abc", None, {}),
        ("GET", "/debug/lifecycle?n=-1", None, {}),
        ("GET", "/debug/lifecycle?n=3", None, {}),
        ("GET", "/fleet/metrics", None, {}),
        ("GET", "/v1/replica/status", None, {}),
        ("GET", "/nowhere", None, {}),
        ("POST", "/v1/score", {"now": now}, {"crane-deadline-ms": "-1"}),
    ]


def _drive(port, requests):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=15)
    out = []
    try:
        for method, target, body, headers in requests:
            if isinstance(body, dict):
                body = json.dumps(body).encode()
            hdrs = dict(headers)
            if body is not None:
                hdrs["Content-Type"] = "application/json"
            conn.request(method, target, body=body, headers=hdrs)
            resp = conn.getresponse()
            out.append((resp.status, resp.getheader("Content-Type"), resp.read()))
        conn.request("GET", "/debug/trace")
        resp = conn.getresponse()
        trace = json.loads(resp.read())
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        legacy = json.loads(resp.read())
        conn.request("GET", "/metrics", headers={"Accept": "text/plain"})
        resp = conn.getresponse()
        text = resp.read().decode()
    finally:
        conn.close()
    return out, trace, legacy, text


def _label_sets(text):
    fams = parse_exposition(text)
    return {name: sorted({(s[0], tuple(sorted(dict(s[1]).items()))) for s in doc["samples"]})
            for name, doc in fams.items()}


@pytest.mark.parametrize("frontend", ["async", "threaded"])
def test_http_surfaces_equal_reference(frontend):
    now, nodes = sim_nodes(17)
    tw = Twins(now, nodes, ref_telemetry=_fixed_telemetry(True),
               port_telemetry=_fixed_telemetry(False))
    tw.refresh()
    results = {}
    for key, svc, cls in (("ref", tw.ref, RefServer), ("port", tw.port, ScoringHTTPServer)):
        srv = cls(svc, port=0, frontend=frontend)
        srv.start()
        try:
            results[key] = _drive(srv.port, _requests(now, [n["name"] for n in nodes]))
        finally:
            srv.stop()
    (ref_out, ref_trace, ref_legacy, ref_text) = results["ref"]
    (out, trace, legacy, text) = results["port"]
    assert [r[:2] for r in out] == [r[:2] for r in ref_out]
    assert [r[2] for r in out] == [as_port(r[2]) for r in ref_out]
    statuses = [r[0] for r in out]
    assert statuses == [200, 200, 200, 400, 400, 200, 200, 400, 200, 404,
                        200, 400, 400, 200, 404, 404, 404, 504]
    assert json.loads(out[1][2])["backend"] == "cpu"
    # span names per track, the legacy JSON counters, the families
    names = lambda tr: sorted(e["name"] for e in tr["traceEvents"] if e.get("ph") == "X")
    assert names(trace) == names(ref_trace) and trace["role"] == ref_trace["role"]
    drop = lambda m: {k: v for k, v in m.items() if k not in TIMING_KEYS}
    assert drop(legacy) == drop(ref_legacy)
    assert _label_sets(text) == _label_sets(ref_text)


# -- CLI ------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_env():
    path = os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)
    return dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")


def test_cli_serves_on_cpu():
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "crane_scheduler_tpu_torch.cli.service_main",
         "--device", "cpu", "--f32", "--port", str(port), "--run-seconds", "60"],
        cwd=REPO, env=_cli_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    try:
        deadline = time.monotonic() + 45.0
        while True:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                break
            except OSError:
                assert proc.poll() is None, proc.communicate()
                assert time.monotonic() < deadline, "CLI did not come up"
                time.sleep(0.1)
        assert resp.status == 200 and json.loads(resp.read()) == {"status": "ok"}
        conn.request("POST", "/v1/score", body=b"{}",
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200
        assert body["backend"] == "cpu" and body["scores"] == {}
        conn.request("GET", "/metrics", headers={"Accept": "text/plain"})
        fams = parse_exposition(conn.getresponse().read().decode())
        assert dict(fams["crane_build_info"]["samples"][0][1])["role"] == "scorer"
        conn.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=30)
    assert proc.returncode == 0, err


@pytest.mark.parametrize("flags,item", [
    (["--token-file", "/dev/null"], "item 8"),
    (["--master", "https://apiserver:6443"], "item 8"),
    (["--num-processes", "2"], "item 7"),
    (["--coordinator-address", "127.0.0.1:1234"], "item 7"),
])
def test_cli_refuses_unported_planes(flags, item, capsys):
    from crane_scheduler_tpu_torch.cli import service_main

    if item == "item 8":
        # the kube mirror is ported (item 8.2a): its flags are accepted and
        # the CLI goes on to list the apiserver, a local address with
        # nothing behind it
        import urllib.error

        with pytest.raises(urllib.error.URLError):
            service_main.main(["--device", "cpu", *flags, "--master", "http://127.0.0.1:1"])
        assert "item 8" not in capsys.readouterr().err
        return
    with pytest.raises(SystemExit) as exc:
        service_main.main(["--device", "cpu", *flags])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"ROADMAP.md Queue 1 {item}" in err and flags[0] in err


def _wait_healthz(proc, port, timeout=45.0):
    """Poll ``/healthz`` until the CLI answers; returns (conn, response)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("GET", "/healthz")
            return conn, conn.getresponse()
        except OSError:
            assert proc.poll() is None, proc.communicate()
            assert time.monotonic() < deadline, "CLI did not come up"
            time.sleep(0.1)


@pytest.mark.parametrize("flags", [
    ["--demo-nodes", "24"],
    ["--demo-nodes", "24", "--replicas", "2", "--lag-budget", "8"],
], ids=["demo-nodes", "replicas"])
def test_cli_demo_nodes_and_replicas_serve_on_cpu(flags):
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "crane_scheduler_tpu_torch.cli.service_main",
         "--device", "cpu", "--f32", "--port", str(port), "--now-bucket", "0",
         "--run-seconds", "90", *flags],
        cwd=REPO, env=_cli_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    try:
        conn, resp = _wait_healthz(proc, port)
        resp.read()
        assert resp.status == 200
        if "--replicas" in flags:
            # genesis: wait until the feed published and both replicas
            # applied it
            deadline = time.monotonic() + 45.0
            while True:
                conn.request("GET", "/v1/router/status")
                st = json.loads(conn.getresponse().read())
                reps = st["replicas"]
                if (st["publishedVersion"] >= 0 and len(reps) == 2
                        and all(r["routable"] and r["appliedVersion"] == st["publishedVersion"]
                                for r in reps)):
                    break
                assert time.monotonic() < deadline, st
                time.sleep(0.1)
        conn.request("POST", "/v1/score", body=b'{"now": 1753776000.0}',
                     headers={"Content-Type": "application/json", "crane-tenant": "t1"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200 and body["backend"] == "cpu"
        assert len(body["scores"]) == 24
        if "--replicas" in flags:
            assert body["version"] == st["publishedVersion"]
            conn.request("GET", "/metrics", headers={"Accept": "text/plain"})
            fams = parse_exposition(conn.getresponse().read().decode())
            served = sum(v for _, _, v in fams["crane_router_requests_total"]["samples"])
            assert served == 1
        conn.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=30)
    assert proc.returncode == 0, err
