"""The port's ``KubeClusterClient`` against the JAX package's, over the
wire stub: the list+watch mirror, the annotator and both schedulers
through the API, the NRT CRD informer, the apiserver Lease, event
replays, the write pool's status handling, TLS, bursts and evictions.

Each case runs one scenario per package (``crane_scheduler_tpu`` and
``crane_scheduler_tpu_torch`` with ``device="cpu"``), each on its own
identically seeded ``KubeStubServer``, and compares what the scenario
records: mirrors, placements, annotation strings, ``WriteResult`` fields,
request counts and the stub's final state. Tolerance: exact. Mirrors the
cases of ``tests/test_kube_client.py`` that need no native library. Every
case runs under a 120 s limit.
"""

import importlib.util
import os
import signal
import threading
import time
import types

import numpy as np
import pytest

import crane_scheduler_tpu.cluster as ref_cluster
import crane_scheduler_tpu.cluster.kube as ref_kube
import crane_scheduler_tpu_torch.cluster as port_cluster
import crane_scheduler_tpu_torch.cluster.kube as port_kube
import crane_scheduler_tpu_torch.cluster.kube_wire as port_wire

_STUB = os.path.join(os.path.dirname(__file__), "kube_stub.py")
_spec = importlib.util.spec_from_file_location("kube_stub_torch_kc", _STUB)
kube_stub = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kube_stub)

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


def _pkg(name):
    if name == "ref":
        from crane_scheduler_tpu import annotator, fit, metrics, plugins
        from crane_scheduler_tpu.framework import scheduler
        from crane_scheduler_tpu.policy import DEFAULT_POLICY
        dev = {}
        return types.SimpleNamespace(
            name=name, kube=ref_kube, cluster=ref_cluster, annotator=annotator,
            fit=fit, metrics=metrics, plugins=plugins, policy=DEFAULT_POLICY,
            batch=lambda c, **kw: scheduler.BatchScheduler(c, DEFAULT_POLICY, **kw, **dev),
            sched=lambda c, **kw: scheduler.Scheduler(c, **kw, **dev))
    from crane_scheduler_tpu_torch import annotator, fit, metrics, plugins
    from crane_scheduler_tpu_torch.framework import scheduler
    from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY
    dev = {"device": "cpu"}
    return types.SimpleNamespace(
        name=name, kube=port_kube, cluster=port_cluster, annotator=annotator,
        fit=fit, metrics=metrics, plugins=plugins, policy=DEFAULT_POLICY,
        batch=lambda c, **kw: scheduler.BatchScheduler(c, DEFAULT_POLICY, **kw, **dev),
        sched=lambda c, **kw: scheduler.Scheduler(c, **kw, **dev))


REF, PORT = _pkg("ref"), _pkg("port")


def _wait_until(predicate, timeout=10.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


class World:
    """A fresh in-process stub and the clients made on it for one package."""

    def __init__(self, p, tls=False):
        self.p = p
        self.stub = kube_stub.KubeStubServer(tls=tls).start()
        self.state = self.stub.state
        self.clients = []

    def client(self, **kw):
        if self.stub.tls and "context" not in kw:
            import ssl

            kw["context"] = ssl.create_default_context(cafile=kube_stub.STUB_CERT_PATH)
        c = self.p.kube.KubeClusterClient(self.stub.url, **kw)
        if self.p is REF:
            # the reference's Python write route (its native flush engine
            # off, as without its library): the port's only route
            c._native_flush_disabled = True
        self.clients.append(c)
        return c

    def close(self):
        for c in self.clients:
            c.stop()
        self.stub.stop()


def both(scenario, tls=False):
    """Run ``scenario(p, world)`` for the reference and the port."""
    out = []
    for p in (REF, PORT):
        w = World(p, tls=tls)
        try:
            out.append(scenario(p, w))
        finally:
            w.close()
    return out


def node_t(n):
    return (n.name, dict(n.annotations), dict(n.labels),
            tuple((a.type, a.address) for a in n.addresses), dict(n.allocatable))


def mirror_t(c):
    return (sorted(map(node_t, c.list_nodes())),
            sorted((p.key(), p.node_name, dict(p.annotations)) for p in c.list_pods()))


def stub_bindings(state):
    with state.lock:
        return sorted((k, (p.get("spec") or {}).get("nodeName") or "")
                      for k, p in state.pods.items())


def requests_of(state, method, suffix=""):
    return [p for m, p in list(state.requests) if m == method and p.split("?")[0].endswith(suffix)]


def fake_metrics(p, values):
    fake = p.metrics.FakeMetricsSource()
    for metric in {sp.name for sp in p.policy.spec.sync_period}:
        for ip, v in values.items():
            fake.set(metric, ip, v, by="ip")
    return fake


# -- the mirror -------------------------------------------------------------

def test_initial_list_and_watch_mirror_equal_reference():
    def scenario(p, w):
        w.state.add_node("node-a", "10.0.0.1", {"k": "v"}, allocatable={"cpu": "4"})
        w.state.add_pod("default", "p1", spec={"nodeName": "node-a"})
        c = w.client()
        c.start()
        t = {"boot": mirror_t(c), "count": c.count_pods("node-a")}
        w.state.add_node("node-b", "10.0.0.2")
        assert _wait_until(lambda: c.get_node("node-b") is not None)
        v = c.sched_version
        w.state.delete_node("node-b")
        assert _wait_until(lambda: c.get_node("node-b") is None)
        t["moved"] = c.sched_version > v
        t["live"] = p.kube.KubeClusterClient.get_pod_live(c, "default/p1").node_name
        t["gone"] = c.get_pod_live("default/nope")
        t["final"] = mirror_t(c)
        return t

    ref, port = both(scenario)
    assert port == ref and ref["moved"] and ref["count"] == 1 and ref["live"] == "node-a"


def test_paginated_list_covers_all_items():
    def scenario(p, w):
        for i in range(23):
            w.state.add_node(f"node-{i:03d}", f"10.0.0.{i}")
        c = w.client(list_page_limit=5)
        c.start()
        lists = [x for x in requests_of(w.state, "GET", "/api/v1/nodes") if "watch=1" not in x]
        return mirror_t(c), len(lists), any("continue=" in x for x in lists)

    ref, port = both(scenario)
    assert port == ref and ref[1] >= 5 and ref[2]


def test_watch_reconnect_resumes_without_relist():
    def scenario(p, w):
        w.state.add_node("node-a", "10.0.0.1")
        w.state.add_node("node-b", "10.0.0.2")
        w.state.add_pod("default", "p1")
        c = w.client()
        c.start()
        records = p.annotator.BindingRecords(64, 600.0)
        p.annotator.EventIngestor(c, records).start()
        c.bind_pod("default/p1", "node-a")
        assert _wait_until(
            lambda: records.get_last_node_binding_count("node-a", 600.0, NOW + 10) == 1)
        relists = c.relists
        w.state.close_watches()
        w.state.delete_node("node-b")
        assert _wait_until(lambda: c.get_node("node-b") is None)
        time.sleep(0.3)
        return (records.get_last_node_binding_count("node-a", 600.0, NOW + 10),
                c.relists - relists, mirror_t(c))

    ref, port = both(scenario)
    assert port == ref and ref[:2] == (1, 0)


def test_watch_410_relists_exactly_once():
    def scenario(p, w):
        w.state.add_node("node-a", "10.0.0.1")
        c = w.client()
        c.start()
        relists = c.relists
        w.state.close_watches()
        w.state.delete_node("node-a")
        w.state.add_node("node-c", "10.0.0.3")
        w.state.compact_history()
        assert _wait_until(lambda: c.get_node("node-c") is not None
                           and c.get_node("node-a") is None)
        assert _wait_until(lambda: c.relists > relists)
        lists = [x for x in requests_of(w.state, "GET", "/api/v1/nodes") if "watch=1" not in x]
        return mirror_t(c), len(lists)

    ref, port = both(scenario)
    assert port == ref and ref[1] == 2


def test_idle_watch_expiry_does_not_relist():
    def scenario(p, w):
        w.state.add_node("node-a", "10.0.0.1")
        c = w.client()
        c.start()
        relists = c.relists
        for _ in range(3):
            w.state.close_watches()
            time.sleep(0.1)
        time.sleep(1.2)
        return c.relists - relists, mirror_t(c)

    ref, port = both(scenario)
    assert port == ref and ref[0] == 0


def test_nrt_crd_mirror_equals_reference():
    def scenario(p, w):
        zones = [{"name": "numa-0", "type": "Node",
                  "resources": {"allocatable": {"cpu": "4000m", "memory": "64Gi"}}}]
        w.state.add_node("node-a", "10.0.0.1")
        w.state.add_nrt("node-a", zones=zones)
        c = w.client()
        c.start()
        w.state.add_nrt("node-b", zones=[])
        assert _wait_until(lambda: "node-b" in c.nrt_lister.names())
        out = []
        for name in sorted(c.nrt_lister.names()):
            nrt = c.nrt_lister.get(name)
            out.append((nrt.name, nrt.crane_manager_policy.cpu_manager_policy,
                        nrt.crane_manager_policy.topology_manager_policy,
                        [(z.name, z.type, dict(z.resources.allocatable)) for z in nrt.zones]))
        return out

    ref, port = both(scenario)
    assert port == ref and ref[0][1] == "Static"


def test_nrt_crd_absent_then_installed(monkeypatch):
    monkeypatch.setattr(port_kube, "NRT_RETRY_SECONDS", 0.1)
    w = World(PORT)
    try:
        w.state.serve_nrt = False
        w.state.add_node("node-a", "10.0.0.1")
        c = w.client()
        c.start()
        assert c.nrt_lister.names() == [] and c._nrt_available is False
        assert len(c._threads) == 4 and c.watch_errors == 0
        w.state.serve_nrt = True
        w.state.add_nrt("node-a", zones=[])
        assert _wait_until(lambda: "node-a" in c.nrt_lister.names())
        assert c._nrt_available is True
    finally:
        w.close()


def test_event_replay_larger_than_cap_does_not_double_count():
    def scenario(p, w):
        w.state.add_node("node-a", "10.0.0.1")
        c = w.client(seen_events_cap=8)
        c.start()
        records = p.annotator.BindingRecords(1024, 600.0)
        p.annotator.EventIngestor(c, records).start()
        for i in range(40):
            w.state.add_pod("default", f"p{i}")
            c.bind_pod(f"default/p{i}", "node-a")

        def bound():
            return records.get_last_node_binding_count("node-a", 600.0, NOW + 10)

        assert _wait_until(lambda: bound() == 40)
        w.state.compact_history()
        w.state.close_watches()
        time.sleep(1.5)
        return bound()

    ref, port = both(scenario)
    assert port == ref == 40


def test_non_monotonic_event_rvs_do_not_drop_fresh_events():
    def scenario(p, w):
        w.state.add_node("node-a", "10.0.0.1")
        c = w.client()
        c.start()
        records = p.annotator.BindingRecords(1024, 600.0)
        p.annotator.EventIngestor(c, records).start()

        def ev(pod, rv):
            w.state.emit_event({
                "metadata": {"namespace": "default", "name": f"{pod}.scheduled"},
                "type": "Normal", "reason": "Scheduled",
                "message": f"Successfully assigned default/{pod} to node-a",
                "count": 1, "lastTimestamp": "2026-07-30T00:00:00Z"}, rv=rv)

        def bound():
            return records.get_last_node_binding_count("node-a", 600.0, NOW + 10)

        trace = []
        ev("p1", 100)
        assert _wait_until(lambda: bound() == 1)
        ev("p2", 5)
        ev("p3", 101)
        assert _wait_until(lambda: bound() == 3)
        ev("p2", 6)  # a content replay: dropped
        ev("p4", 7)
        assert _wait_until(lambda: bound() == 4)
        time.sleep(0.2)
        trace.append(bound())
        trace.append(c._event_rv_trusted)
        return trace

    ref, port = both(scenario)
    assert port == ref == [4, False]


# -- the annotator and the schedulers through the API -------------------------

def test_annotator_writes_through_api_and_scheduler_reads():
    def scenario(p, w):
        w.state.add_node("node-hot", "10.0.0.1")
        w.state.add_node("node-cool", "10.0.0.2")
        c = w.client()
        c.start()
        ann = p.annotator.NodeAnnotator(c, fake_metrics(p, {"10.0.0.1": 0.9, "10.0.0.2": 0.1}),
                                        p.policy, p.annotator.AnnotatorConfig())
        ann.event_ingestor.start()
        ann.sync_all_once(NOW)
        with w.state.lock:
            annos = {n: dict(o["metadata"]["annotations"]) for n, o in w.state.nodes.items()}
        sched = p.sched(c, clock=lambda: NOW)
        sched.register(p.plugins.DynamicPlugin(p.policy, clock=lambda: NOW), weight=3)
        w.state.add_pod("default", "web-1")
        assert _wait_until(lambda: c.get_pod("default/web-1") is not None)
        node = sched.schedule_one(c.get_pod("default/web-1")).node
        assert _wait_until(lambda: ann.binding_records.get_last_node_binding_count(
            "node-cool", 300.0, NOW + 1) == 1)
        return annos, node, stub_bindings(w.state), len(requests_of(w.state, "POST", "/binding"))

    ref, port = both(scenario)
    assert port == ref and ref[1] == "node-cool" and ref[3] == 1


def test_batch_scheduler_over_mirror_equals_reference():
    """An annotator sweep over the API, then ``schedule_batch`` and a
    ``schedule_pod_burst`` through the mirror: placements, the stub's
    bindings and the annotation strings equal the reference's."""
    def scenario(p, w):
        for i in range(6):
            w.state.add_node(f"node-{i}", f"10.0.1.{i}", allocatable={"cpu": "8", "pods": "40"})
        c = w.client()
        c.start()
        ann = p.annotator.NodeAnnotator(
            c, fake_metrics(p, {f"10.0.1.{i}": 0.1 + 0.13 * i for i in range(6)}),
            p.policy, p.annotator.AnnotatorConfig())
        ann.sync_all_once(NOW)
        batch = p.batch(c, clock=lambda: NOW + 1, snapshot_bucket=8)
        for i in range(6):
            w.state.add_pod("default", f"obj-{i}")
        assert _wait_until(lambda: c.get_pod("default/obj-5") is not None)
        res = batch.schedule_batch([c.get_pod(f"default/obj-{i}") for i in range(6)], bind=True)
        burst = batch.schedule_pod_burst("bench", [f"kb{i}" for i in range(70)], bind=True)
        with w.state.lock:
            annos = sorted((n, sorted(o["metadata"]["annotations"].items()))
                           for n, o in w.state.nodes.items())
        assert _wait_until(lambda: len([k for k, n in stub_bindings(w.state) if n]) == 76)
        return (sorted(res.assignments.items()), np.asarray(burst.node_idx).tolist(),
                list(burst.node_table), stub_bindings(w.state), annos,
                w.state.duplicate_binds(), sum(w.state.bind_posts.values()))

    ref, port = both(scenario)
    assert port == ref and ref[-2:] == (0, 76)


def test_write_failures_fail_open():
    def scenario(p, w):
        w.state.add_node("node-a", "10.0.0.1")
        c = w.client()
        c.start()
        out = [c.patch_node_annotation("ghost", "k", "v"), c.bind_pod("default/ghost", "node-a")]
        w.stub.stop()
        out += [c.patch_node_annotation("node-a", "k", "v"), c.bind_pod("default/any", "node-a"),
                c.bind_pods([("default/a", "node-a")]), c.evict_pod("default/any")]
        return out

    ref, port = both(scenario)
    assert port == ref == [False, False, False, False, [], False]


def test_annotation_patch_true_despite_mirror_lag():
    def scenario(p, w):
        w.state.add_node("node-a", "10.0.0.1")
        w.state.add_pod("default", "p1")
        c = w.client()  # not started: the mirror is empty
        out = [c.patch_pod_annotation("default/p1", "k", "v"),
               c.patch_node_annotation("node-a", "k", "v")]
        with w.state.lock:
            out.append(w.state.pods["default/p1"]["metadata"]["annotations"]["k"])
            out.append(w.state.nodes["node-a"]["metadata"]["annotations"]["k"])
        return out

    ref, port = both(scenario)
    assert port == ref == [True, True, "v", "v"]


def test_write_pool_keepalive_and_bulk_equal_reference():
    def scenario(p, w):
        for i in range(60):
            w.state.add_node(f"n{i:03d}", f"10.0.0.{i}")
        c = w.client(concurrent_syncs=4)
        c.start()
        time.sleep(1.0)  # the async initial lists open their connections
        with w.state.lock:
            before = w.state.connections
        patched = [c.patch_node_annotations_bulk(
            {f"n{i:03d}": {"cpu_usage_avg_5m": f"0.{s}{i:03d},ts"} for i in range(60)})
            for s in range(3)]
        with w.state.lock:
            conns = w.state.connections - before
            annos = {n: dict(o["metadata"]["annotations"]) for n, o in w.state.nodes.items()}
        return patched, conns <= 4, annos, mirror_t(c)[0]

    ref, port = both(scenario)
    assert port == ref and ref[:2] == ([60, 60, 60], True)


def test_bind_pods_preserves_order_and_events():
    def scenario(p, w):
        w.state.add_node("node-a", "10.0.0.1")
        c = w.client(concurrent_syncs=4)
        c.start()
        keys = []
        for i in range(40):
            w.state.add_pod("default", f"p{i:02d}")
            keys.append(f"default/p{i:02d}")
        assert _wait_until(lambda: len(c.list_pods()) == 40)
        bound = c.bind_pods([(k, "node-a") for k in keys])
        mirror = [c.get_pod(k).node_name for k in keys]
        scheduled = [e["metadata"]["name"] for e in w.state.events if e["reason"] == "Scheduled"]
        return bound == keys, mirror, sorted(scheduled), stub_bindings(w.state)

    ref, port = both(scenario)
    assert port == ref and ref[0] and len(ref[2]) == 40


def test_flush_with_mixed_row_sets_is_one_patch_per_node():
    def scenario(p, w):
        from crane_scheduler_tpu_torch.loadstore import NodeLoadStore as PortStore
        from crane_scheduler_tpu_torch.policy import compile_policy as port_compile

        n = 80
        for i in range(n):
            w.state.add_node(f"node-{i:03d}", f"10.0.9.{i}")
        w.state.add_node("node-bare", "10.99.99.99")
        c = w.client()
        c.start()
        fake = fake_metrics(p, {f"10.0.9.{i}": 0.4 for i in range(n)})
        ann = p.annotator.NodeAnnotator(c, fake, p.policy, p.annotator.AnnotatorConfig(
            bulk_sync=True, direct_store=True))
        if p is PORT:
            store = PortStore(port_compile(p.policy))
        else:
            from crane_scheduler_tpu.loadstore import NodeLoadStore
            from crane_scheduler_tpu.policy import compile_policy

            store = NodeLoadStore(compile_policy(p.policy))
        ann.attach_store(store)
        ann.sync_all_once_bulk(NOW)
        before = len(requests_of(w.state, "PATCH"))
        ann.flush_annotations()
        with w.state.lock:
            annos = {k: dict(o["metadata"]["annotations"]) for k, o in w.state.nodes.items()}
        return len(requests_of(w.state, "PATCH")) - before, annos

    ref, port = both(scenario)
    assert port == ref and ref[0] == 80


# -- the write pool's status handling -------------------------------------------

def _wr(res):
    return (bool(res), res.status, res.retries, res.error[:60])


STATUS_CASES = {
    "429_retried": ((429, {"message": "throttled"}, {"Retry-After": "0.05"}),),
    "429_gives_up": ((429, {"message": "throttled"}, {"Retry-After": "0"}),) * 8,
    "500_patch_vs_bind": ((500, {"message": "boom"}),),
    "409_conflict": ((409, {"kind": "Status", "code": 409,
                            "message": "pod p1 is already assigned to node node-b"}),),
    "301_redirect": ((301, {}, {"Location": "http://127.0.0.1:1/api/v1/nodes/node-a"}),),
    "reset": ((0, {}),),
}


@pytest.mark.parametrize("case", sorted(STATUS_CASES))
def test_status_faults_equal_reference(case):
    """The pooled writer's status-aware retry: 429 honours Retry-After
    and gives up after 3 retries, 5xx retries only the idempotent patch,
    a 409 bind is not retried, a redirect is a failure, a reset POST is
    indeterminate and never re-sent. Compared as ``WriteResult`` fields,
    failure counts, request counts and the stub's final state."""
    faults = STATUS_CASES[case]

    def scenario(p, w):
        w.state.add_node("node-a", "10.0.0.1")
        w.state.add_pod("default", "p1")
        c = w.client()
        c.start()
        w.state.inject_write_faults(*faults)
        patch = c._submit_write("node-a", "PATCH", "/api/v1/nodes/node-a",
                                {"metadata": {"annotations": {"k": "v"}}},
                                "application/merge-patch+json").result()
        w.state.write_faults.clear()
        w.state.inject_write_faults(*faults)
        path, body = c._binding_request("default/p1", "node-a")
        bind = c._write("default/p1", "POST", path, body)
        w.state.write_faults.clear()
        return (_wr(patch), _wr(bind), dict(c.write_failures_by_status),
                len(requests_of(w.state, "PATCH")), len(requests_of(w.state, "POST")),
                stub_bindings(w.state), dict(w.state.bind_posts))

    ref, port = both(scenario)
    assert port == ref
    if case == "429_gives_up":
        assert ref[3] == 4 and ref[0][2] == 3
    if case == "500_patch_vs_bind":
        assert ref[0][0] and not ref[1][0] and ref[4] == 1
    if case == "reset":
        # the stub read the POST and closed unanswered: indeterminate,
        # reported as status 0 and never sent again
        assert not ref[1][0] and ref[1][1] == 0 and ref[4] == 1 and ref[6] == {}


def test_writes_after_stop_fail_fast():
    w = World(PORT)
    try:
        w.state.add_node("node-a", "10.0.0.1")
        c = w.client()
        c.start()
        assert c.patch_node_annotation("node-a", "k", "v")
        c.stop()
        t0 = time.time()
        assert not c.patch_node_annotation("node-a", "k2", "v2")
        assert time.time() - t0 < 1.0
    finally:
        w.close()


def test_pooled_writer_retry_semantics_equal_reference():
    import http.client as hc

    class FakeResp:
        def __init__(self, status=200):
            self.status = status
            self.will_close = False

        def read(self):
            return b"{}"

    class FakeConn:
        def __init__(self, send_fail=False, resp_fail=False, status=200):
            self.send_fail, self.resp_fail, self.status = send_fail, resp_fail, status
            self.requests = 0

        def request(self, *a, **kw):
            if self.send_fail:
                raise ConnectionResetError("stale keep-alive")
            self.requests += 1

        def getresponse(self):
            if self.resp_fail:
                raise hc.BadStatusLine("")
            return FakeResp(self.status)

        def close(self):
            pass

    def run(writer_cls):
        def writer(conns):
            w = writer_cls("http://127.0.0.1:1", None, None, 1.0)
            w._connect = lambda: conns.pop(0)
            return w

        out = [_wr(writer([FakeConn(send_fail=True), FakeConn()])._do(
            "POST", "/x", {}, "application/json"))]
        good = FakeConn()
        out.append(_wr(writer([FakeConn(resp_fail=True), good])._do(
            "POST", "/x", {}, "application/json")))
        out.append(good.requests)
        out.append(_wr(writer([FakeConn(resp_fail=True), FakeConn()])._do(
            "PATCH", "/x", {}, "application/json")))
        out.append(_wr(writer([FakeConn(status=404)])._do("PATCH", "/x", {}, "application/json")))
        return out

    ref, port = run(ref_kube._PooledWriter), run(port_wire._PooledWriter)
    assert port == ref
    assert ref[0][0] and not ref[1][0] and ref[2] == 0 and ref[3][0] and ref[4][1] == 404


def test_raw_connection_chunk_extensions_and_diagnostics():
    import http.client
    import socket

    def run(conn_cls):
        lsock = socket.socket()
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(1)
        port = lsock.getsockname()[1]

        def serve():
            conn, _ = lsock.accept()
            conn.recv(65536)
            conn.sendall(b"HTTP/1.1 503 Unavailable\r\nRetry-After: 1\r\n"
                         b"Transfer-Encoding: chunked\r\n\r\n"
                         b"5;ext=1\r\nhello\r\n0\r\nX-Trailer: 1\r\n\r\n")
            conn.recv(65536)
            conn.sendall(b"GARBAGE NOT HTTP\r\n\r\n")
            conn.close()

        t = threading.Thread(target=serve, daemon=True)
        t.start()
        try:
            c = conn_cls("127.0.0.1", port, 2.0)
            c.request("GET", "/chunked")
            resp = c.getresponse()
            out = (resp.status, resp.read(), resp.retry_after)
            c.request("GET", "/garbage")
            with pytest.raises(http.client.HTTPException):
                c.getresponse()
            c.close()
        finally:
            t.join(timeout=5)
            lsock.close()
        return out

    assert run(port_wire._RawHTTPConnection) == run(ref_kube._RawHTTPConnection) \
        == (503, b"hello", "1")


# -- TLS ------------------------------------------------------------------------

def test_tls_full_loop_and_write_pool_equal_reference():
    def scenario(p, w):
        assert w.stub.url.startswith("https://")
        w.state.add_node("node-a", "10.0.0.1")
        w.state.add_pod("default", "p1")
        c = w.client()
        c.start()
        out = [c.patch_node_annotation("node-a", "k", "v"), c.bind_pod("default/p1", "node-a"),
               c.get_pod("default/p1").node_name]
        w.state.add_node("node-b", "10.0.0.2")
        assert _wait_until(lambda: c.get_node("node-b") is not None)
        stable = w.state.connections
        for _ in range(50):
            time.sleep(0.05)
            if w.state.connections == stable:
                break
            stable = w.state.connections
        before = w.state.connections
        out.append(all(c.patch_node_annotation("node-a", f"k{i}", "v") for i in range(25)))
        out.append(w.state.connections - before <= 1)  # one keep-alive TLS connection
        w.state.inject_write_faults((429, {"message": "throttled"}, {"Retry-After": "0.05"}))
        out.append(c.patch_node_annotation("node-a", "kx", "v"))
        out.append(c.write_failures_by_status.get(429))
        # the pipelined flush over TLS (64 patches or more)
        out.append(c.patch_node_annotations_bulk(
            {"node-a": {"bulk": "1"}, **{f"ghost-{i}": {"x": "1"} for i in range(70)}}))
        out.append(mirror_t(c))
        return out

    ref, port = both(scenario, tls=True)
    assert port == ref and ref[:6] == [True, True, "node-a", True, True, True]


# -- lease election ---------------------------------------------------------------

def test_lease_electors_race_one_lease_single_winner_and_failover():
    """A port and a reference ``KubeLeaderElector`` race one Lease: one
    winner (CAS on resourceVersion), and the other takes over once the
    holder stops renewing; then two port electors do the same."""
    from crane_scheduler_tpu.service.kube_leader import KubeLeaderElector as RefElector
    from crane_scheduler_tpu_torch.service.kube_leader import KubeLeaderElector

    for classes in ((KubeLeaderElector, RefElector), (KubeLeaderElector, KubeLeaderElector)):
        stub = kube_stub.KubeStubServer().start()
        c1 = port_kube.KubeClusterClient(stub.url)
        c2 = ref_kube.KubeClusterClient(stub.url)
        leaders, lock = [], threading.Lock()

        def make(cls, name, client):
            def on_start(stop_event):
                with lock:
                    leaders.append(name)
                stop_event.wait()

            return cls(client, "test-lease", name, on_start, namespace="crane-system",
                       lease_duration=0.6, renew_deadline=0.4, retry_period=0.1)

        e1, e2 = make(classes[0], "a", c1), make(classes[1], "b", c2)
        threads = [threading.Thread(target=e.run, daemon=True) for e in (e1, e2)]
        try:
            for t in threads:
                t.start()
            assert _wait_until(lambda: leaders, timeout=5)
            time.sleep(0.3)  # the loser must not grab a live lease
            assert len(leaders) == 1, leaders
            winner = leaders[0]
            (e1 if winner == "a" else e2).stop()
            assert _wait_until(lambda: len(leaders) == 2, timeout=8)
            assert leaders[1] != winner
            with stub.state.lock:
                lease = stub.state.leases["crane-system/test-lease"]["spec"]
            assert lease["holderIdentity"] == leaders[1]
        finally:
            for e in (e1, e2):
                e.stop()
            for t in threads:
                t.join(timeout=5)
            c1.stop()
            c2.stop()
            stub.stop()


# -- bursts and evictions through the API -------------------------------------------

def test_kube_burst_add_and_bind_equal_reference():
    def scenario(p, w):
        for i in range(5):
            w.state.add_node(f"node-{i}", f"10.0.5.{i}")
        c = w.client()
        c.start()
        records = p.annotator.BindingRecords(1024, 600.0)
        p.annotator.EventIngestor(c, records).start()
        handle = c.add_pod_burst("bench", [f"bp{i}" for i in range(200)])
        table = tuple(f"node-{i}" for i in range(5))
        bound = c.bind_burst(handle, table, [i % 5 for i in range(200)])

        def hot():
            return sum(records.get_last_node_binding_count(n, 600.0, NOW + 10) for n in table)

        assert _wait_until(lambda: hot() == 200)
        time.sleep(0.3)  # a double emission would keep counting
        keys = [p_.key() for p_ in c.list_pods()]
        return (len(bound), hot(), stub_bindings(w.state), sorted(c.count_pods_all().items()),
                len(keys) == len(set(keys)), w.state.duplicate_binds())

    ref, port = both(scenario)
    assert port == ref and ref[0] == ref[1] == 200 and ref[4] and ref[5] == 0


@pytest.mark.parametrize("fault", ["refused_creation", "bind_conflict", "bind_429"])
def test_kube_burst_faults_equal_reference(fault):
    def scenario(p, w):
        w.state.add_node("node-a", "10.0.0.1")
        # one connection: the fault lands on the same row in both runs
        c = w.client(concurrent_syncs=1)
        c.start()
        if fault == "refused_creation":
            w.state.inject_write_faults((422, {"message": "invalid pod"}))
        handle = c.add_pod_burst("bench", [f"rp{i}" for i in range(150)])
        if fault == "bind_conflict":
            w.state.inject_write_faults((409, {"message": "already bound"}))
        elif fault == "bind_429":
            w.state.inject_write_faults((429, {"message": "throttled"}, {"Retry-After": "0.05"}))
        bound = c.bind_burst(handle, ("node-a",), [0] * 150)
        return (sorted(handle.failed), len(bound), dict(c.write_failures_by_status),
                len(requests_of(w.state, "POST", "/binding")), w.state.duplicate_binds())

    ref, port = both(scenario)
    assert port == ref
    assert ref[1] == (150 if fault == "bind_429" else 149)


@pytest.mark.parametrize("started", [True, False], ids=["echoed", "rows"])
@pytest.mark.parametrize("target", ["object", "burst_row"])
def test_evict_pod_equal_reference(target, started):
    """``evict_pod`` through the client on an object pod and on a burst
    row. Started, the watch echoes shadow the burst rows into object pods
    before the eviction, so a ``FitTracker`` over the mirror sees the
    freed slot. Not started (no watch), the row stays a row and its
    eviction moves no ``pod_version``: the incremental tracker keeps the
    row's pod slot counted, as on the in-memory cluster and in the
    reference."""
    def scenario(p, w):
        for i in range(4):
            w.state.add_node(f"node-{i}", f"10.0.0.{i}", allocatable={"cpu": "4", "pods": "3"})
        w.state.add_pod("default", "obj-0", spec={"nodeName": "node-0", "containers": [
            {"name": "c", "resources": {"requests": {"cpu": "1"}}}]})
        c = w.client()
        if started:
            c.start()
        else:
            c._relist_nodes()
            c._relist_pods()
        handle = c.add_pod_burst("default", [f"b{i}" for i in range(6)])
        c.bind_burst(handle, [f"node-{i}" for i in range(4)], [1, 1, 1, 2, 2, 0], now=NOW)
        if started:
            assert _wait_until(lambda: all(
                c.get_pod(f"default/b{i}") is not None for i in range(6))
                and c.count_pods("node-1") == 3)
            time.sleep(0.3)
        fit = p.fit.FitTracker(c)
        fit.refresh()
        names = [f"node-{i}" for i in range(4)]
        probe = p.fit.pod_fit_request(p.cluster.Pod(name="probe"))
        t = {"before": fit.fits_mask(names, probe).tolist()}
        key = "default/obj-0" if target == "object" else "default/b1"
        t["ok"] = c.evict_pod(key, now=NOW + 5)
        t["gone"] = c.get_pod(key) is None
        with w.state.lock:
            t["stub"] = key in w.state.pods
            t["evict_posts"] = dict(w.state.evict_posts)
        fit.refresh()
        t["after"] = fit.fits_mask(names, probe).tolist()
        fresh = p.fit.FitTracker(c)
        fresh.refresh()
        t["fresh"] = fresh.fits_mask(names, probe).tolist()
        t["counts"] = sorted(c.count_pods_all().items())
        t["again"] = c.evict_pod(key, now=NOW + 6)  # the stub answers 404
        return t

    ref, port = both(scenario)
    assert port == ref
    assert ref["ok"] and ref["gone"] and not ref["stub"] and not ref["again"]
    if target == "burst_row":
        # node-1 held three rows at its 3-pod cap; after the eviction a
        # fresh tracker sees a free slot
        assert ref["fresh"][1] is True
        assert ref["after"][1] is (True if started else False)


def test_intent_journal_waits_for_its_item(tmp_path):
    """An attached intent journal: each bind's intent line is on disk
    before its POST reaches the stub (the stub's handler reads the
    journal as the binding arrives), and the lines equal the reference
    client's apart from ``ts``."""
    import json

    import crane_scheduler_tpu.resilience.recovery as ref_rec
    import crane_scheduler_tpu_torch.resilience.recovery as port_rec

    out = []
    for name, kube, rec in (("ref", ref_kube, ref_rec), ("port", port_kube, port_rec)):
        server = kube_stub.KubeStubServer().start()
        jdir = tmp_path / name
        try:
            server.state.add_node("n0", "10.0.0.1")
            for i in range(3):
                server.state.add_pod("default", f"p{i}")
            at_post = []
            posts = server.state.bind_posts

            class Spy(dict):
                def __setitem__(self, key, value):
                    at_post.append((key, [(r["t"], r.get("pod")) for r in rec.IntentJournal.read(
                        str(jdir))]))
                    super().__setitem__(key, value)

            server.state.bind_posts = Spy(posts)
            journal = rec.IntentJournal(str(jdir))
            client = kube.KubeClusterClient(server.url)
            client.attach_intent_journal(journal)
            assert client.bind_pods([(f"default/p{i}", "n0") for i in range(2)]) == \
                ["default/p0", "default/p1"]
            assert client.bind_pod("default/p2", "n0")
            client.stop()
            journal.close()
            lines = []
            for seg in sorted(os.listdir(jdir)):
                for raw in open(jdir / seg).read().splitlines():
                    doc = json.loads(raw)
                    doc.pop("ts", None)
                    lines.append(doc)
            out.append((sorted(at_post), lines))
        finally:
            server.stop()
    ref, port = out
    assert port == ref
    for key, seen in port[0]:
        assert ("intent", key) in seen  # the intent preceded its POST
    assert [r["t"] for r in port[1]] == ["intent", "intent", "ack", "ack", "intent", "ack"]


def test_from_flags_reads_the_token_file(tmp_path):
    """``from_flags`` takes the bearer token from ``--token-file`` (stripped)
    and every request carries it, as the reference's client does."""
    token = tmp_path / "token"
    token.write_text("s3cret-token\n")
    out = []
    for kube in (ref_kube, port_kube):
        c = kube.KubeClusterClient.from_flags("https://127.0.0.1:1", str(token),
                                              concurrent_syncs=2)
        out.append((c._token, c._write_workers, c._scheme,
                    c._render_request("PATCH", "/api/v1/nodes/n", {"a": 1})))
        c.stop()
    assert out[0] == out[1]
    assert out[1][0] == "s3cret-token" and b"Authorization: Bearer s3cret-token\r\n" in out[1][3]
