"""The port's chaos plans and the resilience of its control plane under
them, against the JAX package.

- ``ChaosPlan.generate(...).describe()`` (and the events) equal the
  reference's for a range of seeds, kinds and horizons; the plan
  mechanics (pairing, opt-in kinds, unknown kinds) behave alike.
- A ``ChaosDriver`` (the one of ``tests/test_chaos.py``, over either
  package) runs the port's annotator-shaped Prometheus sweep through a
  breaker, the degraded-mode controller, the descheduler (hard-suspended
  while degraded) and a drip scheduler on the CPU, on a virtual clock,
  while the plan injects faults into the stub apiserver and the chaos
  Prometheus stub. Config 12's invariants hold for the scripted outage
  and for seeded plans: no duplicate bind or eviction POST, zero
  evictions while degraded, the mirror converges after the heal, every
  scheduling attempt returns a verdict; the scripted outage's degraded
  steps, suspensions and breaker states equal the reference driver's.
- Leader loss mid-sync aborts the annotator's flush (file lock and
  apiserver Lease), and SIGTERM during an open bind window drains it
  before the client is torn down.
"""

import importlib.util
import os
import signal
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import crane_scheduler_tpu.resilience.chaos as ref_chaos
import crane_scheduler_tpu_torch.resilience.chaos as port_chaos

REPO = Path(__file__).resolve().parents[1]
T0 = 1753776000.0
STEP_S = 60.0
METRIC = "cpu_usage_avg_5m"


def _load_stub():
    spec = importlib.util.spec_from_file_location("kube_stub_torch_chaos",
                                                  REPO / "tests" / "kube_stub.py")
    stub = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stub)
    return stub


kube_stub = _load_stub()


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        raise TimeoutError("test case exceeded its 120 s limit")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


def _package(name):
    """The modules the driver needs, from one package."""
    import importlib

    m = {k: importlib.import_module(f"{name}.{k}") for k in (
        "annotator", "cluster", "cluster.kube", "descheduler", "fit",
        "framework.scheduler", "metrics", "metrics.source", "plugins", "policy",
        "resilience", "utils")}
    pol = m["policy"]
    policy = pol.DynamicSchedulerPolicy(spec=pol.PolicySpec(
        sync_period=(pol.SyncPolicy(METRIC, 180.0),),
        predicate=(pol.PredicatePolicy(METRIC, 0.65),),
        priority=(pol.PriorityPolicy(METRIC, 1.0),)))
    return SimpleNamespace(m=m, policy=policy,
                           kw={"device": "cpu"} if name.endswith("_torch") else {})


REF = _package("crane_scheduler_tpu")
PORT = _package("crane_scheduler_tpu_torch")


def _wait_until(predicate, timeout=5.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


class ChaosDriver:
    """Steps a ChaosPlan against live stubs on a virtual clock (one step a
    simulated minute), over one package's components."""

    def __init__(self, pkg, plan, n_hot=1, n_cool=3, schedule_every=2):
        m = pkg.m
        res = m["resilience"]
        self.pkg = pkg
        self.plan = plan
        self.now = T0
        self.step = 0
        self.schedule_every = schedule_every
        self.server = kube_stub.KubeStubServer().start()
        self.prom = kube_stub.ChaosPromServer().start()
        hot = [f"hot-{i}" for i in range(n_hot)]
        cool = [f"cool-{i}" for i in range(n_cool)]
        self.names, self.ips = [], {}
        for i, name in enumerate(hot + cool):
            ip = f"10.0.0.{i + 1}"
            self.server.state.add_node(name, ip, allocatable={"cpu": "16", "pods": "110"})
            self.names.append(name)
            self.ips[name] = ip

        def pod_spec(node):
            return {"nodeName": node, "containers": [{"resources": {"requests": {"cpu": "1"}}}]}

        for node in hot:
            for j in range(12):
                self.server.state.add_pod("default", f"{node}-w{j}", spec=pod_spec(node))
        for node in cool:
            self.server.state.add_pod("default", f"{node}-w0", spec=pod_spec(node))
        self.prom.set_all([self.ips[n] for n in hot], 0.90)
        self.prom.set_all([self.ips[n] for n in cool], 0.10)
        self.client = m["cluster.kube"].KubeClusterClient(self.server.url)
        self.client.start()
        assert _wait_until(lambda: len(self.client.list_pods()) == n_hot * 12 + n_cool
                           and len(self.client.list_nodes()) == len(self.names), timeout=10.0)
        self.breaker = res.CircuitBreaker("prometheus", failure_threshold=3,
                                          window_s=10 * STEP_S, reset_timeout_s=1.5 * STEP_S,
                                          clock=lambda: self.now)
        self.health = res.HealthRegistry()
        self.health.watch_breaker(self.breaker)
        self.transport_error = m["metrics.source"].MetricsTransportError
        self.promc = m["metrics"].PrometheusClient(
            self.prom.url, timeout=2.0,
            retry_policy=res.RetryPolicy(max_attempts=2, base_delay_s=0.0, max_delay_s=0.0,
                                         deadline_s=30.0, retryable=(self.transport_error,),
                                         seed=plan.seed, sleep=lambda s: None),
            breaker=self.breaker)
        self.degraded = res.DegradedModeController(pkg.policy.spec, min_eval_interval_s=0.0)
        d = m["descheduler"]
        self.desched = d.LoadAwareDescheduler(
            self.client, pkg.policy,
            d.DeschedulerConfig(watermarks=(d.WatermarkPolicy(METRIC, target=0.32,
                                                              threshold=0.35),),
                                consecutive_syncs=2, max_evictions_per_node=2,
                                max_evictions_per_cycle=4, node_cooldown_seconds=0.0),
            clock=lambda: self.now, degraded=self.degraded)
        self.sched = m["framework.scheduler"].Scheduler(self.client, clock=lambda: self.now,
                                                        **pkg.kw)
        self.sched.register(m["fit"].ResourceFitPlugin(m["fit"].FitTracker(self.client)),
                            weight=1)
        self.sched.register(m["plugins"].DynamicPlugin(pkg.policy, clock=lambda: self.now,
                                                       degraded=self.degraded), weight=3)
        self.breaker_states_seen = set()
        self.sweep_ok = []
        self.sweep_failures = 0
        self.failfast_sweeps = 0
        self.degraded_steps = []
        self.suspended_reports = 0
        self.evictions_while_degraded = 0
        self.evicted_total = 0
        self.schedule_results = []
        self.write_errors = 0
        self._torn_until = None
        self._seq = 0

    def appliers(self):
        st = self.server.state
        fmt = self.pkg.m["utils"].format_local_time

        def prom_outage(e):
            self.prom.outage = True

        def prom_heal(e):
            self.prom.outage = False
            self.prom.delay_s = 0.0

        def prom_storm(e):
            status = e.param("status", 503)
            fault = (status, 0.01) if status == 429 else status
            self.prom.inject_faults(*[fault] * e.param("count", 3))

        def prom_slow(e):
            self.prom.delay_s = e.param("delay_s", 0.1)

        def kube_read_storm(e):
            st.inject_read_faults(*[(e.param("status", 503), {})] * e.param("count", 3))

        def kube_write_storm(e):
            status = e.param("status", 503)
            headers = {"Retry-After": "0.01"} if status == 429 else {}
            st.inject_write_faults(*[(status, {}, headers)] * e.param("count", 3))

        def torn_watch(e):
            st.torn_watch_writes = True
            self._torn_until = self.step + e.param("count", 1)

        def close_watches(e):
            st.close_watches()

        def watch_410(e):
            st.inject_watch_410_after("nodes", e.param("after", 1))
            st.close_watches()

        def skew_annotations(e):
            stamp = fmt(self.now + e.param("offset_s", -3600.0))
            with st.lock:
                for node in st.nodes.values():
                    anno = node["metadata"].setdefault("annotations", {})
                    changed = False
                    for k, v in list(anno.items()):
                        parts = str(v).split(",")
                        if len(parts) == 2:
                            anno[k] = f"{parts[0]},{stamp}"
                            changed = True
                    if changed:
                        st._stamp(node)
                        st._notify("nodes", "MODIFIED", node)

        return {"prom_outage": prom_outage, "prom_heal": prom_heal, "prom_storm": prom_storm,
                "prom_slow": prom_slow, "kube_read_storm": kube_read_storm,
                "kube_write_storm": kube_write_storm,
                "kube_slow": lambda e: setattr(st, "response_delay_s", e.param("delay_s", 0.05)),
                "torn_watch": torn_watch, "close_watches": close_watches,
                "watch_410": watch_410, "skew_annotations": skew_annotations,
                "skew_heal": lambda e: None}

    def run(self):
        appliers = self.appliers()
        for step in range(self.plan.steps):
            self.step = step
            self.now = T0 + step * STEP_S
            if self._torn_until is not None and step >= self._torn_until:
                self.server.state.torn_watch_writes = False
                self._torn_until = None
            self.plan.apply(step, appliers)
            self._sweep()
            self._observe()
            self._desched_cycle()
            if step % self.schedule_every == 0:
                self._schedule_one()

    def _sweep(self):
        hits_before = self.prom.hits
        try:
            by_inst = self.promc.query_all_by_metric(METRIC)
        except self.transport_error:
            self.sweep_failures += 1
            if self.prom.hits == hits_before:
                self.failfast_sweeps += 1
            self.sweep_ok.append(False)
            return
        stamp = self.pkg.m["utils"].format_local_time(self.now)
        per_node = {name: {METRIC: f"{by_inst[self.ips[name]]},{stamp}"}
                    for name in self.names if self.ips[name] in by_inst}
        try:
            if per_node:
                self.client.patch_node_annotations_bulk(per_node)
        except Exception:
            self.write_errors += 1
            self.sweep_ok.append(False)
            return
        want = f",{stamp}"
        _wait_until(lambda: any((n.annotations or {}).get(METRIC, "").endswith(want)
                                for n in self.client.list_nodes()), timeout=2.0, interval=0.01)
        self.sweep_ok.append(True)

    def _observe(self):
        self.degraded.update((dict(n.annotations or {}) for n in self.client.list_nodes()),
                             self.now)
        self.breaker_states_seen.add(self.breaker.state)
        if self.degraded.active:
            self.degraded_steps.append(self.step)

    def _desched_cycle(self):
        report = self.desched.sync_once(self.now)
        if report.suspended:
            self.suspended_reports += 1
        self.evicted_total += len(report.evicted)
        if self.degraded.active and report.evicted:
            self.evictions_while_degraded += len(report.evicted)

    def _schedule_one(self):
        c = self.pkg.m["cluster"]
        pod = c.Pod(name=f"chaos-{self._seq}", namespace="default",
                    containers=(c.Container("c", c.ResourceRequirements(
                        requests={"cpu": "1"})),))
        self._seq += 1
        try:
            self.client.add_pod(pod)
        except Exception:
            self.write_errors += 1
            return
        self.schedule_results.append(self.sched.schedule_one(pod))

    def heal_and_settle(self, settle_steps=4):
        st = self.server.state
        self.prom.outage = False
        self.prom.delay_s = 0.0
        with self.prom.lock:
            self.prom.faults.clear()
        st.torn_watch_writes = False
        st.response_delay_s = 0.0
        with st.lock:
            st.read_faults.clear()
            st.write_faults.clear()
        for _ in range(settle_steps):
            self.step += 1
            self.now += STEP_S
            self._sweep()
            self._observe()
            self._desched_cycle()

    def mirror_converged(self, timeout=10.0):
        st = self.server.state
        deadline = time.time() + timeout
        while time.time() < deadline:
            with st.lock:
                want = {name: dict(obj["metadata"].get("annotations") or {})
                        for name, obj in st.nodes.items()}
            if {n.name: dict(n.annotations or {}) for n in self.client.list_nodes()} == want:
                return True
            time.sleep(0.05)
        return False

    def assert_invariants(self):
        st = self.server.state
        assert st.duplicate_binds() == 0, "duplicate bind POST"
        assert st.duplicate_evictions() == 0, "duplicate eviction POST"
        assert self.evictions_while_degraded == 0, "evicted while degraded"
        assert self.mirror_converged(), "mirror never converged after heal"
        assert all(r is not None for r in self.schedule_results)

    def close(self):
        try:
            self.client.stop()
        finally:
            self.server.stop()
            self.prom.stop()


# -- plan mechanics ------------------------------------------------------------------


@pytest.mark.parametrize("kinds", [None, ("kill_process",), ("request_storm", "slow_client"),
                                   ("prom_outage", "skew_annotations", "kube_write_storm")],
                         ids=["default", "kill", "overload", "mixed"])
def test_generated_plans_equal_reference(kinds):
    for seed in range(40):
        for steps, n_faults, tail in ((24, 3, 8), (40, 5, 10), (60, 8, 10)):
            ref = ref_chaos.ChaosPlan.generate(seed, steps=steps, n_faults=n_faults,
                                               kinds=kinds, quiet_tail=tail)
            port = port_chaos.ChaosPlan.generate(seed, steps=steps, n_faults=n_faults,
                                                 kinds=kinds, quiet_tail=tail)
            assert port.describe() == ref.describe()
            assert [(e.at_step, e.kind, e.params) for e in port.events] == \
                [(e.at_step, e.kind, e.params) for e in ref.events]
            assert port.last_fault_step() == ref.last_fault_step() <= steps - tail + 1


def test_plan_mechanics_equal_reference():
    for mod in (ref_chaos, port_chaos):
        with pytest.raises(ValueError):
            mod.ChaosPlan.generate(seed=0, kinds=("quantum_flap",))
        with pytest.raises(KeyError):
            mod.ChaosPlan(seed=0, steps=2).add(1, "quantum_flap").apply(1, {})
    kills = port_chaos.ChaosPlan.generate(seed=3, steps=32, n_faults=6, kinds=("kill_process",))
    offsets = [e.param("offset") for e in kills.events if e.kind == "kill_process"]
    assert len(offsets) == 6 and all(1 <= o < 4096 for o in offsets)
    assert sum(e.kind == "restart_process" for e in kills.events) == 6
    fired = []
    plan = port_chaos.ChaosPlan(seed=1, steps=4).add(2, "prom_outage").add(2, "torn_watch",
                                                                           count=3)
    assert plan.apply(1, {}) == []
    got = plan.apply(2, {"prom_outage": fired.append, "torn_watch": fired.append})
    assert [e.kind for e in got] == ["prom_outage", "torn_watch"] and fired == got
    assert got[1].param("count") == 3 and got[1].param("missing", 7) == 7


# -- the scripted outage and seeded plans, through the port's components -------------


def _outage_trace(pkg):
    plan = port_chaos.ChaosPlan(seed=1, steps=18).add(2, "prom_outage").add(14, "prom_heal")
    driver = ChaosDriver(pkg, plan)
    try:
        driver.run()
        during = (list(driver.degraded_steps), driver.suspended_reports,
                  sorted(driver.breaker_states_seen), driver.failfast_sweeps > 0,
                  driver.sweep_failures > 0)
        driver.heal_and_settle()
        assert driver.sweep_ok[-1] is True
        assert driver.breaker.state == "closed" and not driver.degraded.active
        assert driver.health.overall() == "healthy"
        driver.assert_invariants()
        return during
    finally:
        driver.close()


def test_prom_outage_degrades_and_recovers_like_reference():
    """Config 12's scripted outage: the breaker opens and fail-fasts,
    degraded mode engages and suspends the descheduler, and everything
    heals without a restart; the same steps as the reference driver."""
    ref = _outage_trace(REF)
    port = _outage_trace(PORT)
    assert port == ref
    assert ref[0] and ref[1] >= len(set(ref[0])) and "open" in ref[2] and ref[3] and ref[4]


def test_evictions_suspended_while_degraded_then_resume():
    plan = port_chaos.ChaosPlan(seed=2, steps=14).add(0, "prom_outage").add(8, "prom_heal")
    driver = ChaosDriver(PORT, plan)
    try:
        driver.run()
        driver.heal_and_settle(settle_steps=3)
        assert driver.evictions_while_degraded == 0 and driver.suspended_reports > 0
        assert driver.evicted_total >= 1 and driver.server.state.evictions
        driver.assert_invariants()
    finally:
        driver.close()


@pytest.mark.parametrize("seed", [3, 11, 17])
def test_seeded_plans_hold_invariants(seed):
    plan = port_chaos.ChaosPlan.generate(seed, steps=24, n_faults=3, quiet_tail=8)
    driver = ChaosDriver(PORT, plan)
    try:
        driver.run()
        driver.heal_and_settle()
        driver.assert_invariants()
        assert len(driver.schedule_results) + driver.write_errors >= \
            plan.steps // driver.schedule_every
    finally:
        driver.close()


# -- leadership and teardown ------------------------------------------------------------


def test_file_lock_leader_loss_mid_sync_aborts_flush(tmp_path, monkeypatch):
    from crane_scheduler_tpu_torch.annotator import AnnotatorConfig, NodeAnnotator
    from crane_scheduler_tpu_torch.cluster import ClusterState, Node, NodeAddress
    from crane_scheduler_tpu_torch.metrics import FakeMetricsSource
    from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY
    from crane_scheduler_tpu_torch.service.leader import LeaderElector

    cluster = ClusterState()
    cluster.add_node(Node(name="n1", addresses=(NodeAddress("InternalIP", "10.0.0.1"),)))
    started = threading.Event()
    elector = LeaderElector(str(tmp_path / "crane.lock"), identity="annotator-a",
                            on_started_leading=lambda stop: started.set(),
                            lease_duration=0.5, renew_deadline=0.2, retry_period=0.05)
    thread = threading.Thread(target=elector.run, daemon=True)
    thread.start()
    assert started.wait(3.0) and elector.is_leader
    annotator = NodeAnnotator(cluster, FakeMetricsSource(), DEFAULT_POLICY, AnnotatorConfig(),
                              leader_check=lambda: elector.is_leader)
    annotator._emit_annotation_column(METRIC, ["n1"], ["0.50000,2026-07-29T00:00:00Z"])
    monkeypatch.setattr(elector, "_write_lease",
                        lambda: (_ for _ in ()).throw(OSError("lock file gone")))
    assert _wait_until(lambda: not elector.is_leader, timeout=5.0)
    assert annotator.flush_annotations() == 0
    assert METRIC not in (cluster.get_node("n1").annotations or {})
    assert annotator._anno_cols == []
    elector.stop()
    thread.join(timeout=2.0)


def test_kube_leader_loss_mid_sync_aborts_flush():
    from crane_scheduler_tpu_torch.annotator import AnnotatorConfig, NodeAnnotator
    from crane_scheduler_tpu_torch.cluster.kube import KubeClusterClient
    from crane_scheduler_tpu_torch.metrics import FakeMetricsSource
    from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY
    from crane_scheduler_tpu_torch.service.kube_leader import KubeLeaderElector

    server = kube_stub.KubeStubServer().start()
    client = elector = None
    try:
        server.state.add_node("n1", "10.0.0.1")
        client = KubeClusterClient(server.url)
        client.start()
        assert _wait_until(lambda: len(client.list_nodes()) == 1)
        started = threading.Event()
        elector = KubeLeaderElector(client, lease_name="crane-chaos-test", identity="annotator-a",
                                    namespace="crane-system",
                                    on_started_leading=lambda stop: started.set(),
                                    lease_duration=5.0, renew_deadline=0.3, retry_period=0.05)
        thread = threading.Thread(target=elector.run, daemon=True)
        thread.start()
        assert started.wait(3.0) and elector.is_leader
        annotator = NodeAnnotator(client, FakeMetricsSource(), DEFAULT_POLICY, AnnotatorConfig(),
                                  leader_check=lambda: elector.is_leader)
        annotator._emit_annotation_column(METRIC, ["n1"], ["0.50000,2026-07-29T00:00:00Z"])
        with server.state.lock:
            lease = server.state.leases["crane-system/crane-chaos-test"]
            lease["spec"]["holderIdentity"] = "annotator-b"
            server.state._lease_rv += 1
            lease["metadata"]["resourceVersion"] = str(server.state._lease_rv)
        assert _wait_until(lambda: not elector.is_leader, timeout=5.0)
        assert annotator.flush_annotations() == 0 and annotator._anno_cols == []
        assert not any(m == "PATCH" and "/api/v1/nodes/" in p for m, p in server.state.requests)
        thread.join(timeout=2.0)
    finally:
        if elector is not None:
            elector.stop()
        if client is not None:
            client.stop()
        server.stop()


def test_sigterm_drains_bind_window_before_client_teardown():
    from crane_scheduler_tpu_torch.cluster.kube import KubeClusterClient
    from crane_scheduler_tpu_torch.framework.scheduler import BatchResult, _BindFlushQueue

    server = kube_stub.KubeStubServer().start()
    old_handler = signal.getsignal(signal.SIGTERM)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    client = None
    try:
        for i in range(3):
            server.state.add_node(f"n{i}", f"10.0.0.{i + 1}")
        for i in range(24):
            server.state.add_pod("default", f"p{i}")
        client = KubeClusterClient(server.url)
        client.start()
        assert _wait_until(lambda: len(client.list_pods()) == 24)
        queue = _BindFlushQueue(SimpleNamespace(_telemetry=None, _lifecycle=None, cluster=client),
                                window_s=0.3)
        queue.submit_batch(BatchResult(assignments={f"default/p{i}": f"n{i % 3}"
                                                    for i in range(24)},
                                       unassigned=[], scores={}, schedulable={}, now=T0), T0)
        # SIGTERM lands while the 300 ms bind window is still open
        os.kill(os.getpid(), signal.SIGTERM)
        assert stop.wait(2.0)
        queue.close()  # the CLI's order: drain the bind queue, then the client
        client.stop()
        client = None
        assert sum(server.state.bind_posts.values()) == 24
        assert server.state.duplicate_binds() == 0
        with server.state.lock:
            assert sum(1 for p in server.state.pods.values() if p["spec"].get("nodeName")) == 24
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        if client is not None:
            client.stop()
        server.stop()
