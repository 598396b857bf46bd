"""The port's annotator, event plane and simulator against the JAX
package's.

Each case builds the same world twice, once per package (a seeded numpy
cluster of at most 64 nodes with addresses, a ``FakeMetricsSource`` with
values served by IP, by name only, or not at all), runs the same call
sequence through ``crane_scheduler_tpu.annotator`` / ``sim`` and
``crane_scheduler_tpu_torch.annotator`` / ``sim`` (``device="cpu"``), and
compares the node annotation strings, the binding-heap counts, the
direct-mode store rows and the placements. Both packages run with their
host libraries (the C++ binding heap, the native value parse, the native
column render); cases with a ``-python`` id run both annotators on the
pure-Python heap (``use_native_bindings=False``). Tolerance: exact.
"""

import signal
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crane_scheduler_tpu.annotator import AnnotatorConfig as RefConfig
from crane_scheduler_tpu.annotator import Binding as RefBinding
from crane_scheduler_tpu.annotator import BindingRecords as RefRecords
from crane_scheduler_tpu.annotator import EventIngestor as RefIngestor
from crane_scheduler_tpu.annotator import NodeAnnotator as RefAnnotator
from crane_scheduler_tpu.annotator import RateLimitedQueue as RefQueue
from crane_scheduler_tpu.annotator.bindings import (
    max_hot_value_time_range as ref_max_range,
)
from crane_scheduler_tpu.annotator.events import (
    translate_event_to_binding as ref_translate,
)
from crane_scheduler_tpu.cluster import ClusterState as RefCluster
from crane_scheduler_tpu.cluster import Event as RefEvent
from crane_scheduler_tpu.cluster import Node as RefNode
from crane_scheduler_tpu.cluster import NodeAddress as RefAddress
from crane_scheduler_tpu.cluster import Pod as RefPod
from crane_scheduler_tpu.loadstore import NodeLoadStore as RefStore
from crane_scheduler_tpu.metrics import FakeMetricsSource as RefFake
from crane_scheduler_tpu.policy import DEFAULT_POLICY as REF_POLICY
from crane_scheduler_tpu.policy import compile_policy as ref_compile
from crane_scheduler_tpu.sim import SimConfig as RefSimConfig
from crane_scheduler_tpu.sim import Simulator as RefSimulator
from crane_scheduler_tpu_torch.annotator import (
    AnnotatorConfig,
    Binding,
    BindingRecords,
    EventIngestor,
    NodeAnnotator,
    RateLimitedQueue,
)
from crane_scheduler_tpu_torch.annotator.bindings import max_hot_value_time_range
from crane_scheduler_tpu_torch.annotator.events import translate_event_to_binding
from crane_scheduler_tpu_torch.cluster import ClusterState, Event, Node, NodeAddress, Pod
from crane_scheduler_tpu_torch.loadstore import NodeLoadStore
from crane_scheduler_tpu_torch.metrics import FakeMetricsSource
from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY, compile_policy
from crane_scheduler_tpu_torch.sim import SimConfig, Simulator

NOW = 1753776000.0
METRICS = [sp.name for sp in REF_POLICY.spec.sync_period]

REF = dict(Cluster=RefCluster, Node=RefNode, Address=RefAddress, Fake=RefFake,
           Annotator=RefAnnotator, Config=RefConfig, Store=RefStore,
           policy=REF_POLICY, compile=ref_compile, Pod=RefPod)
PORT = dict(Cluster=ClusterState, Node=Node, Address=NodeAddress, Fake=FakeMetricsSource,
            Annotator=NodeAnnotator, Config=AnnotatorConfig, Store=NodeLoadStore,
            policy=DEFAULT_POLICY, compile=compile_policy, Pod=Pod)


@pytest.fixture(autouse=True)
def _time_limit():
    """Threaded and closed-loop cases: fail after 120 s instead of
    hanging the suite."""
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


def annos(cluster):
    return {n.name: dict(n.annotations) for n in cluster.list_nodes()}


# -- work queue ----------------------------------------------------------------


def test_workqueue_backoff_10s_to_360s_equals_reference():
    def run(cls):
        clock = [100.0]
        q = cls(clock=lambda: clock[0])
        delays, order = [], []
        for k in range(8):
            q.add_rate_limited("node-a/cpu")
            delays.append(q._delayed[-1][0] - clock[0] if q._delayed else None)
            clock[0] += 400.0
            item = q.get(timeout=0)
            order.append(item)
            q.done(item)
        q.forget("node-a/cpu")
        q.add_rate_limited("node-a/cpu")  # forgotten: back to the base delay
        delays.append(q._delayed[-1][0] - clock[0])
        # dedup and the dirty re-add while processing
        q.add("x")
        q.add("x")
        got = q.get(timeout=0)
        q.add("x")
        q.done(got)
        order.append((got, q.get(timeout=0), len(q)))
        q.shutdown()
        order.append(q.get(timeout=0.1))
        return delays, order

    delays, order = run(RateLimitedQueue)
    assert (delays, order) == run(RefQueue)
    assert delays == [10.0, 20.0, 40.0, 80.0, 160.0, 320.0, 360.0, 360.0, 10.0]


# -- binding records -----------------------------------------------------------


def seeded_bindings(seed, n=300):
    rng = np.random.default_rng(seed)
    return [
        (f"node-{int(rng.integers(0, 40)):02d}", "default", f"p{i}",
         int(NOW) - int(rng.integers(0, 900)))
        for i in range(n)
    ]


@pytest.mark.parametrize(
    "seed,size,native",
    [(0, 64, False), (1, 1024, False), (0, 64, True), (1, 1024, True)],
    ids=["0-64", "1-1024", "0-64-native", "1-1024-native"],
)
def test_binding_records_counts_and_gc_equal_reference(seed, size, native):
    """The port's Python heap against the reference's Python heap, and the
    port's C++ heap against the reference's."""
    rng_range = ref_max_range(REF_POLICY.spec.hot_value)
    assert max_hot_value_time_range(DEFAULT_POLICY.spec.hot_value) == rng_range
    if native:
        from crane_scheduler_tpu.native.bindings import NativeBindingRecords as RefNative
        from crane_scheduler_tpu_torch.native.bindings import NativeBindingRecords

        ref, port = RefNative(size, rng_range), NativeBindingRecords(size, rng_range)
    else:
        ref, port = RefRecords(size, rng_range), BindingRecords(size, rng_range)
    rows = seeded_bindings(seed)
    for i, row in enumerate(rows):
        if i % 3:
            ref.add_binding(RefBinding(*row))
            port.add_binding(Binding(*row))
        else:
            ref.add_binding_batch([RefBinding(*row)])
            port.add_binding_batch([Binding(*row)])
    table = [f"node-{i:02d}" for i in range(40)]
    idx = np.random.default_rng(seed + 9).integers(0, 40, 50)
    ref.add_bind_columns(table, idx, NOW - 30.5)
    port.add_bind_columns(table, idx, NOW - 30.5)
    assert len(port) == len(ref)
    windows = [300.0, 60.0, 900.0]
    names, counts = port.counts_batch(windows, NOW)
    ref_names, ref_counts = ref.counts_batch(windows, NOW)
    assert names == ref_names
    np.testing.assert_array_equal(counts, ref_counts)
    for name in table:
        for w in windows:
            assert (port.get_last_node_binding_count(name, w, NOW)
                    == ref.get_last_node_binding_count(name, w, NOW))
    for now in (NOW, NOW + 200, NOW + 10_000):
        ref.bindings_gc(now)
        port.bindings_gc(now)
        assert len(port) == len(ref)
        names, counts = port.counts_batch(windows, now)
        assert names == ref.counts_batch(windows, now)[0]


def test_binding_records_reference_backend_is_native_where_it_loads():
    # both packages default to their C++ heap; use_native_bindings=False
    # selects the Python heap in both
    from crane_scheduler_tpu.native.codec import load_native
    from crane_scheduler_tpu_torch.native.bindings import NativeBindingRecords

    ann = RefAnnotator(RefCluster(), RefFake(), REF_POLICY)
    want = "NativeBindingRecords" if load_native() is not None else "BindingRecords"
    assert type(ann.binding_records).__name__ == want
    port = NodeAnnotator(ClusterState(), FakeMetricsSource(), DEFAULT_POLICY)
    assert type(port.binding_records) is NativeBindingRecords
    assert AnnotatorConfig().use_native_bindings is RefConfig().use_native_bindings is True
    for pkg in (REF, PORT):
        ann = pkg["Annotator"](pkg["Cluster"](), pkg["Fake"](), pkg["policy"],
                               pkg["Config"](use_native_bindings=False))
        assert type(ann.binding_records).__name__ == "BindingRecords"


# -- events ----------------------------------------------------------------------


@pytest.mark.parametrize("message,count", [
    ("Successfully assigned default/p0 to node-1", 1),
    ("Successfully assigned kube-system/x to n", 0),
    ("Successfully assigned default/p0 to node-1 extra words", 3),
    ("Successfully assigned p0 to node-1", 1),
    ("Successfully assigned a/b/c to node-1", 1),
    ("Assigned default/p0 to node-1", 1),
    ("Successfully assigned default/p0", 1),
    ("", 1),
])
def test_translate_event_equals_reference(message, count):
    kw = dict(namespace="default", name="p0.1", type="Normal", reason="Scheduled",
              message=message, count=count, event_time=NOW - 3.7,
              last_timestamp=NOW - 1.2)

    def run(translate, event_cls):
        try:
            b = translate(event_cls(**kw))
            return ("ok", b.node, b.namespace, b.pod_name, b.timestamp)
        except ValueError as e:
            return ("err", str(e))

    assert run(translate_event_to_binding, Event) == run(ref_translate, RefEvent)


def event_world(pkg, n_nodes=16):
    cluster = pkg["Cluster"]()
    for i in range(n_nodes):
        cluster.add_node(pkg["Node"](name=f"node-{i:02d}"))
    rng_range = 900.0
    records = (RefRecords if pkg is REF else BindingRecords)(256, rng_range)
    ingestor = (RefIngestor if pkg is REF else EventIngestor)(cluster, records)
    ingestor.start()
    return cluster, records, ingestor


@pytest.mark.parametrize("path", ["emit", "bind_pods", "bind_burst"])
def test_event_ingestion_per_event_batched_and_columnar_equal_reference(path):
    rng = np.random.default_rng(5)
    targets = [f"node-{int(i):02d}" for i in rng.integers(0, 16, 120)]
    out = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        cluster, records, ingestor = event_world(pkg)
        event_cls = RefEvent if pkg is REF else Event
        seen = []
        cluster.subscribe_events(lambda e: seen.append((e.name, e.resource_version)))
        if path == "emit":
            for k, node in enumerate(targets):
                cluster.emit_event(event_cls(
                    namespace="default", name=f"p{k}.scheduled", type="Normal",
                    reason="Scheduled" if k % 7 else "Pulled",
                    message=f"Successfully assigned default/p{k} to {node}",
                    last_timestamp=NOW - k))
            cluster.emit_events([event_cls(
                namespace="default", name="bad", type="Normal", reason="Scheduled",
                message="garbage", last_timestamp=NOW)])
        elif path == "bind_pods":
            for k in range(len(targets)):
                cluster.add_pod(pkg["Pod"](name=f"p{k}"))
            cluster.bind_pods({f"default/p{k}": t for k, t in enumerate(targets)}, now=NOW - 4.5)
        else:
            burst = cluster.add_pod_burst("default", [f"b{k}" for k in range(len(targets))])
            table = [f"node-{i:02d}" for i in range(16)]
            idx = np.array([table.index(t) for t in targets], dtype=np.int32)
            idx[::9] = -1
            rows = cluster.bind_burst(burst, table, idx, now=NOW - 2.25)
            assert len(rows) == int((idx >= 0).sum())
        counts = records.counts_batch([300.0, 60.0, 900.0], NOW)
        events = [(e.name, e.message, e.resource_version, e.last_timestamp)
                  for e in cluster.list_events()]
        out[name] = (counts[0], counts[1].tolist(), ingestor.translated,
                     ingestor.rejected, seen, events, cluster.sched_version,
                     cluster.get_event(f"default/{events[-1][0]}").message)
    assert out["port"] == out["ref"]
    assert out["port"][2] > 0


def test_event_handlers_run_outside_the_lock():
    cluster, records, ingestor = event_world(PORT)
    cluster.add_pod(Pod(name="p0"))
    seen = []
    # a handler that re-enters the cluster from another thread would
    # deadlock if delivery held the lock
    import threading

    def handler(batch):
        t = threading.Thread(target=lambda: seen.append(cluster.sched_version))
        t.start()
        t.join(timeout=5)
        assert not t.is_alive()

    cluster.subscribe_events_batch(handler)
    cluster.bind_pods({"default/p0": "node-00"}, now=NOW)
    burst = cluster.add_pod_burst("default", ["b0", "b1"])
    cluster.bind_burst(burst, ["node-01"], np.array([0, 0], dtype=np.int32), now=NOW)
    assert len(seen) == 2


# -- annotator ------------------------------------------------------------------


def world(pkg, seed, n_nodes=48, config=None):
    """Seeded cluster and fake metrics: most nodes answer by IP, some only
    by name, some not at all for one metric; IPs sometimes carry a port
    suffix in the bulk column."""
    rng = np.random.default_rng(seed)
    cluster = pkg["Cluster"]()
    fake = pkg["Fake"]()
    for i in range(n_nodes):
        ip = f"10.0.{i // 256}.{i % 256}"
        cluster.add_node(pkg["Node"](name=f"node-{i:03d}",
                                     addresses=(pkg["Address"]("InternalIP", ip),)))
        for m in METRICS:
            roll = rng.random()
            v = float(rng.choice([rng.random(), 0.65, -0.1, 1.25]))
            if roll < 0.75:
                fake.set(m, ip if roll < 0.7 else f"{ip}:9100", v, by="ip")
            elif roll < 0.9:
                fake.set(m, f"node-{i:03d}", v, by="name")
    ann = pkg["Annotator"](cluster, fake, pkg["policy"], config or pkg["Config"]())
    return cluster, fake, ann


def seed_bindings(ann, seed, binding_cls):
    for node, ns, pod, ts in seeded_bindings(seed, n=200):
        ann.binding_records.add_binding(binding_cls(node.replace("node-", "node-0"), ns, pod, ts))


_MODES = ["sync_node", "sync_all_once", "sync_metric_bulk", "sync_all_once_bulk",
          "backfill_once"]


@pytest.mark.parametrize("mode,native", [(m, True) for m in _MODES] + [(m, False) for m in _MODES],
                         ids=_MODES + [f"{m}-python" for m in _MODES])
def test_annotation_strings_equal_reference(mode, native):
    out = {}
    for name, pkg, binding_cls in (("ref", REF, RefBinding), ("port", PORT, Binding)):
        cluster, fake, ann = world(pkg, seed=2,
                                   config=pkg["Config"](use_native_bindings=native))
        seed_bindings(ann, 2, binding_cls)
        steps = []
        for k, now in enumerate((NOW + 0.7, NOW + 61.2, NOW + 300.9)):
            if mode == "sync_node":
                res = [ann.sync_node(f"node-{i:03d}/{m}", now)
                       for i in range(0, 48, 5) for m in METRICS[k::3]]
                res += [ann.sync_node("ghost/cpu_usage_avg_5m", now), ann.sync_node("bad", now)]
            elif mode == "sync_all_once":
                res = ann.sync_all_once(now)
            elif mode == "sync_metric_bulk":
                res = [ann.sync_metric_bulk(m, now) for m in METRICS[k:k + 2]]
            elif mode == "sync_all_once_bulk":
                res = ann.sync_all_once_bulk(now)
            else:
                offs = {h: 0.1 * (j % 9) for j, h in enumerate(f"10.0.0.{i}" for i in range(48))}
                for m in METRICS[:3]:
                    fake.set_offset_column(m, "180s", offs)
                res = ann.backfill_once(180.0 + k, now)
                ann.sync_node(f"node-00{k}/{METRICS[0]}", now)
            queued = []
            while len(ann.queue):
                item = ann.queue.get(timeout=0)
                if item is None:
                    break
                queued.append(item)
                ann.queue.done(item)
            steps.append((res, annos(cluster), ann.synced, ann.sync_errors, sorted(queued)))
        out[name] = steps
    assert out["port"] == out["ref"]
    assert any(v for v in out["port"][-1][1].values())


@pytest.mark.parametrize(
    "with_hot,native", [(False, True), (True, True), (False, False), (True, False)],
    ids=["False", "True", "False-python", "True-python"],
)
def test_direct_store_rows_equal_reference(with_hot, native):
    out = {}
    for name, pkg, binding_cls in (("ref", REF, RefBinding), ("port", PORT, Binding)):
        cluster, fake, ann = world(
            pkg, seed=4, config=pkg["Config"](direct_store=True, use_native_bindings=native))
        if with_hot:
            seed_bindings(ann, 4, binding_cls)
        tensors = pkg["compile"](pkg["policy"])
        store = ann.attach_store(pkg["Store"](tensors))
        rows = []
        for now in (NOW + 0.7, NOW + 90.3):
            ann.sync_all_once_bulk(now)
            # nodes missing from a bulk column take the queue path, which
            # writes the store too
            while len(ann.queue):
                item = ann.queue.get(timeout=0)
                if item is None:
                    break
                ann.sync_node(item, now)
                ann.queue.done(item)
            flushed = ann.flush_annotations()
            if now > NOW + 1:
                cluster.delete_node("node-047")
            ann.sync_metric_bulk(METRICS[0], now)  # prunes the deleted row
            snap = {n: (store.values[store.node_id(n)].tolist(),
                        store.ts[store.node_id(n)].tolist(),
                        float(store.hot_value[store.node_id(n)]),
                        float(store.hot_ts[store.node_id(n)]))
                    for n in store.node_names}
            # the direct write equals a re-ingest of the emitted strings
            re = pkg["Store"](tensors)
            for node in cluster.list_nodes():
                re.ingest_node_annotations(node.name, node.annotations)
            reing = {n: (re.values[re.node_id(n)].tolist(), re.ts[re.node_id(n)].tolist(),
                         float(re.hot_value[re.node_id(n)]), float(re.hot_ts[re.node_id(n)]))
                     for n in re.node_names}
            rows.append((flushed, sorted(snap), np.array(
                [snap[n][0] + snap[n][1] + [snap[n][2], snap[n][3]] for n in sorted(snap)]),
                annos(cluster)))
            np.testing.assert_array_equal(
                rows[-1][2],
                np.array([reing[n][0] + reing[n][1] + [reing[n][2], reing[n][3]]
                          for n in sorted(snap)]))
        out[name] = rows
    for (pf, pn, pa, pc), (rf, rn, ra, rc) in zip(out["port"], out["ref"]):
        assert (pf, pn, pc) == (rf, rn, rc)
        np.testing.assert_array_equal(pa, ra)


def test_refresh_store_rows_equal_reference():
    out = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        cluster, fake, ann = world(pkg, seed=6)
        ann.sync_all_once(NOW + 3.3)
        store = pkg["Store"](pkg["compile"](pkg["policy"]))
        ann.refresh_store(store)
        cluster.delete_node("node-010")
        ann.refresh_store(store)
        out[name] = (list(store.node_names), store.values[: len(store)].tolist(),
                     store.ts[: len(store)].tolist(), store.hot_value[: len(store)].tolist())
    np.testing.assert_array_equal(np.array(out["port"][1]), np.array(out["ref"][1]))
    assert out["port"][0] == out["ref"][0] and out["port"][2] == out["ref"][2]


def test_threaded_start_stop_equals_reference():
    out = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        cluster, fake, ann = world(pkg, seed=8, n_nodes=12,
                                   config=pkg["Config"](concurrent_syncs=2))
        ann.start()
        deadline = time.monotonic() + 30
        want = sum(1 for n in range(12) for m in METRICS
                   if fake_has(fake, m, n))
        while ann.synced < want and time.monotonic() < deadline:
            time.sleep(0.02)
        threads = list(ann._threads)
        assert threads and all(t.daemon for t in threads)
        ann.stop()
        assert not any(t.is_alive() for t in threads)
        assert ann._threads == []
        # the values (not the wall-clock stamps) are what the threads wrote
        values = {n: {k: v.split(",")[0] for k, v in a.items()}
                  for n, a in annos(cluster).items()}
        out[name] = (ann.synced >= want, values)
    assert out["port"] == out["ref"] and out["port"][0]


def fake_has(fake, metric, i):
    ip = f"10.0.0.{i}"
    return ((metric, ip) in fake._by_ip or (metric, f"node-{i:03d}") in fake._by_name)


# -- simulator --------------------------------------------------------------------


def test_simulator_closed_loop_strings_and_placements_equal_reference():
    ref = RefSimulator(RefSimConfig(n_nodes=64, seed=3))
    port = Simulator(SimConfig(n_nodes=64, seed=3))
    assert [(n.name, n.internal_ip()) for n in port.cluster.list_nodes()] == \
        [(n.name, n.internal_ip()) for n in ref.cluster.list_nodes()]
    ref.sync_metrics()
    port.sync_metrics()
    assert annos(port.cluster) == annos(ref.cluster)
    rb = ref.build_batch_scheduler(dtype=jnp.float64, bucket=128)
    pb = port.build_batch_scheduler(dtype=torch.float64, bucket=128, device="cpu")
    for step in range(4):
        rp = [ref.make_pod() for _ in range(96)]
        pp = [port.make_pod() for _ in range(96)]
        rr, pr = rb.schedule_batch(rp), pb.schedule_batch(pp)
        assert pr.assignments == rr.assignments, step
        assert pr.unassigned == rr.unassigned
        for sim, res, pods in ((ref, rr, rp), (port, pr, pp)):
            for pod in pods:
                sim.record(res.assignments.get(pod.key()))
        for sim in (ref, port):
            sim.clock.advance(45.0)
            sim.annotator.sync_all_once_bulk(sim.clock.now())
        assert annos(port.cluster) == annos(ref.cluster), step
        assert port.annotator.event_ingestor.translated == ref.annotator.event_ingestor.translated
    assert vars(port.stats) == vars(ref.stats)
    # the drip path over the same closed loop
    rs, ps = ref.build_scheduler(), port.build_scheduler(device="cpu")
    placed = []
    for k in range(24):
        r_pod, p_pod = ref.make_pod(), port.make_pod()
        placed.append((rs.schedule_one(r_pod).node, ps.schedule_one(p_pod).node))
        if k % 8 == 7:
            for sim in (ref, port):
                sim.clock.advance(20.0)
                sim.sync_metrics()
            assert annos(port.cluster) == annos(ref.cluster), k
    assert [p for p, _ in placed] == [r for _, r in placed] and placed[0][0]
    with pytest.raises(NotImplementedError, match="item 7"):
        port.build_batch_scheduler(mesh=object(), device="cpu")


def test_simulator_direct_store_rows_equal_reference():
    # both packages' columns come rendered and pre-parsed from their host
    # libraries (strings + floats)
    rows = {}
    for name, sim, pkg in (("ref", RefSimulator(RefSimConfig(n_nodes=64, seed=9)), REF),
                           ("port", Simulator(SimConfig(n_nodes=64, seed=9)), PORT)):
        sim.annotator.config.direct_store = True
        store = sim.annotator.attach_store(pkg["Store"](pkg["compile"](pkg["policy"])))
        for k in range(3):
            sim.clock.advance(33.3)
            sim.annotator.sync_all_once_bulk(sim.clock.now())
        sim.annotator.flush_annotations()
        order = sorted(store.node_names)
        idx = [store.node_id(n) for n in order]
        rows[name] = (order, store.values[idx], store.ts[idx], store.hot_value[idx],
                      store.hot_ts[idx], annos(sim.cluster))
    for p, r in zip(rows["port"], rows["ref"]):
        if isinstance(p, np.ndarray):
            np.testing.assert_array_equal(p, r)
        else:
            assert p == r
