"""The port's kube read path against the JAX package's: the LIST page
decoder, the store's columnar ingest, the mirror's bulk transactions,
event dedup, the watch fault matrix over the wire stub, and the
refresh's columnar branch.

Each case feeds the same bytes, objects or stub to ``crane_scheduler_tpu``
and ``crane_scheduler_tpu_torch`` and compares models as field tuples,
columns, store rows and counters exactly. Each package decodes a page
through its object decoder (``native="pylist"``), its columnar scanner
(``native=True``) and its Python twin (``native=False``); the twin cases
keep their original ids and the native routes add ``-pylist`` and
``-native`` cases. Mirrors cases of ``tests/test_read_path.py``. Every
case that opens sockets or threads runs under a 120 s limit.
"""

import importlib.util
import json
import os
import random
import signal
import threading
import time

import numpy as np
import pytest

import crane_scheduler_tpu.cluster.kube as ref_kube
import crane_scheduler_tpu.native.listdecode as ref_ld
from crane_scheduler_tpu.cluster import state as ref_state
from crane_scheduler_tpu_torch.cluster import kube as port_kube
from crane_scheduler_tpu_torch.cluster import state as port_state
from crane_scheduler_tpu_torch.native import listdecode as port_ld

_STUB = os.path.join(os.path.dirname(__file__), "kube_stub.py")
_spec = importlib.util.spec_from_file_location("kube_stub_torch_rp", _STUB)
kube_stub = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kube_stub)


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        raise TimeoutError("test case exceeded its 120 s limit")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


def _wait_until(predicate, timeout=10.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def node_t(n):
    return (n.name, dict(n.annotations), dict(n.labels),
            tuple((a.type, a.address) for a in n.addresses), dict(n.allocatable))


def _containers_t(items):
    return tuple((c.name, dict(c.resources.requests), dict(c.resources.limits))
                 for c in items)


def pod_t(p):
    return (p.name, p.namespace, dict(p.annotations),
            tuple((r.kind, r.name) for r in p.owner_references),
            _containers_t(p.containers), p.node_name,
            _containers_t(p.init_containers), dict(p.overhead))


def model_t(kind, objs):
    return [(node_t if kind == 0 else pod_t)(o) for o in objs]


def mirror_t(client):
    return (sorted(map(node_t, client.list_nodes()), key=lambda t: t[0]),
            sorted(map(pod_t, client.list_pods()), key=lambda t: (t[1], t[0])))


def stub_t(state):
    with state.lock:
        nodes = [json.loads(json.dumps(o)) for o in state.nodes.values()]
        pods = [json.loads(json.dumps(o)) for o in state.pods.values()]
    return (sorted((node_t(ref_kube.node_from_json(o)) for o in nodes), key=lambda t: t[0]),
            sorted((pod_t(ref_kube.pod_from_json(o)) for o in pods),
                   key=lambda t: (t[1], t[0])))


@pytest.fixture()
def stub():
    server = kube_stub.KubeStubServer().start()
    yield server
    server.stop()


@pytest.fixture()
def clients(stub):
    made = []

    def make(pkg, **kw):
        c = (port_kube if pkg == "port" else ref_kube).KubeClusterClient(stub.url, **kw)
        made.append(c)
        return c

    yield make
    for c in made:
        c.stop()


# -- the LIST page decoder --------------------------------------------------

GOLDEN_NODES = [
    {"metadata": {"name": "n1",
                  "annotations": {"a": "0.5,2026-01-01T00:00:00Z", "b": "x"},
                  "labels": {"zone": "z1"},
                  "managedFields": [{"manager": "kubelet", "seq": 1}]},
     "status": {"addresses": [{"type": "InternalIP", "address": "10.0.0.1", "extra": 5}],
                "capacity": {"cpu": "4", "memory": "16Gi"}}},
    {"metadata": {"name": "n2"}},
    {"metadata": {"name": "esc\"\\\nnode", "annotations": {"k\t": "v\n"}}},
    {"metadata": {"name": "uni-é漢\U0001F600"}},
    {"metadata": {"name": "n-num", "annotations": {"num": 5}}},
    {"metadata": {"name": "n-null-anno", "annotations": None}},
    {"metadata": {"name": "n-addr-missing"}, "status": {"addresses": [{"type": "Hostname"}]}},
    {},
    {"metadata": {"name": "n-empty-maps", "annotations": {}, "labels": {}},
     "status": {"addresses": []}},
    {"metadata": {"name": "n-alloc", "annotations": {"m": "0.1,2026-01-01T00:00:00Z"}},
     "status": {"allocatable": {"cpu": "16", "memory": "64Gi", "pods": "110"}}},
    {"metadata": {"name": "n-list-anno", "annotations": {"l": ["x"], "d": {"y": "z"}}}},
]

GOLDEN_PODS = [
    {"metadata": {"name": "p1", "namespace": "ns1", "annotations": {"k": "v"},
                  "ownerReferences": [{"kind": "DaemonSet", "name": "ds", "uid": "u-1"}]},
     "spec": {"nodeName": "n1"}},
    {"metadata": {"name": "p2"}, "spec": {}},
    {"metadata": {"name": "p3"}, "spec": {"nodeName": None}},
    {"metadata": {"name": "p4", "namespace": "ns"},
     "spec": {"containers": [{"name": "c1", "resources": {"requests": {"cpu": 0.5},
                                                          "limits": {"cpu": "1"}}}]}},
    {"metadata": {"name": "p5"}, "spec": {"containers": []}},
    {"metadata": {"name": "p6", "annotations": {"x": "yé"}}, "spec": {"nodeName": "n\"2"}},
    {"metadata": {"name": "p7"},
     "spec": {"initContainers": [{"name": "i", "resources": {"requests": {"cpu": "2"}}}],
              "overhead": {"cpu": "100m"}}},
]

SURROGATE_BODY = (b'{"metadata":{"resourceVersion":"1"},"items":['
                  b'{"metadata":{"name":"ok\\uD83D\\uDE00"}},'
                  b'{"metadata":{"name":"lone\\uD800x"}},'
                  b'{"metadata":{"name":"lo\\uDC00","annotations":{"a":"\\uDBFF"}}},'
                  b'{"metadata":{"name":"dup","name":"dup2","annotations":{"k":"1","k":"2"}}}]}')


def _body(items, rv="17", cont=None):
    meta = {"resourceVersion": rv}
    if cont is not None:
        meta["continue"] = cont
    return json.dumps({"kind": "List", "apiVersion": "v1", "metadata": meta,
                       "items": items}).encode()


# route -> decode_list_page's ``native`` argument
ROUTES = {"python": False, "pylist": "pylist", "native": True}


def _route_cases(values, ids):
    """``(value, route)`` cases: the twin keeps each original id, the two
    native routes add ``<id>-pylist`` and ``<id>-native``."""
    return pytest.mark.parametrize(
        "case,route",
        [(v, r) for r in ROUTES for v in values],
        ids=[i if r == "python" else f"{i}-{r}" for r in ROUTES for i in ids],
    )


def _same_page(body, kind, route="python"):
    """The port's page on ``route`` equals the reference's page on the
    same route (columns, flags and counts for the columnar routes; row
    resourceVersions for the object decoder), and model for model the
    reference's twin and default route and the per-object path."""
    native = ROUTES[route]
    port = port_ld.decode_list_page(body, kind, native=native)
    same = ref_ld.decode_list_page(body, kind, native=native)
    twin = ref_ld.decode_list_page(body, kind, native=False)
    default = ref_ld.decode_list_page(body, kind)
    assert port.backend == same.backend == {"python": "python", "pylist": "pylist",
                                            "native": "native"}[route]
    if route == "pylist":
        assert port.rvs == same.rvs
    else:
        assert port.strings == same.strings
        np.testing.assert_array_equal(port.flags, same.flags)
        np.testing.assert_array_equal(port.counts, same.counts)
    assert (port.rv, port.cont, port.n) == (twin.rv, twin.cont, twin.n)
    assert port.fallback_rows == same.fallback_rows
    got = model_t(kind, port.materialize())
    assert got == model_t(kind, twin.materialize())
    assert got == model_t(kind, default.materialize())
    loader = ref_kube.node_from_json if kind == 0 else ref_kube.pod_from_json
    assert got == model_t(kind, [loader(o) for o in json.loads(body)["items"]])
    if kind == 0:
        cols = port.node_annotation_columns()
        want = same.node_annotation_columns()
        assert want[:3] == twin.node_annotation_columns()[:3]
        assert cols[:3] == want[:3]
        np.testing.assert_array_equal(cols[3], want[3])
    return port


@_route_cases([0, 1], ["nodes", "pods"])
def test_decode_golden_equals_reference(case, route):
    kind = case
    items = GOLDEN_NODES if kind == 0 else GOLDEN_PODS
    page = _same_page(_body(items, cont="tok-1"), kind, route)
    assert page.cont == "tok-1" and page.rv == "17"
    # non-string annotation values, allocatable, containers and overhead
    # are the fallback rows
    assert page.fallback_rows == ([4, 9, 10] if kind == 0 else [3, 6])


def test_decode_surrogates_and_duplicate_keys_equal_reference():
    for route in ROUTES:
        page = _same_page(SURROGATE_BODY, 0, route)
        # the native scanners also send duplicate metadata keys to the
        # per-object path
        assert page.fallback_rows == ([1, 2] if route == "python" else [1, 2, 3])
        # duplicate keys: the last one wins, as in json.loads
        assert page.materialize()[3].name == "dup2"
        assert dict(page.materialize()[3].annotations) == {"k": "2"}


def _fuzz_string(rng):
    alphabet = "abc-._/\"\\\n\t\ré漢\U0001F600 ,:{}[]0123456789𐏿"
    return "".join(rng.choice(alphabet) for _ in range(rng.randrange(0, 24)))


def _fuzz_node(rng):
    obj = {}
    if rng.random() < 0.95:
        meta = {"name": _fuzz_string(rng)}
        if rng.random() < 0.8:
            meta["annotations"] = {
                _fuzz_string(rng): (_fuzz_string(rng) if rng.random() < 0.9 else
                                    rng.choice([5, 1.5, None, True, ["x"], {"y": "z"}]))
                for _ in range(rng.randrange(0, 5))
            }
        if rng.random() < 0.3:
            meta["labels"] = {_fuzz_string(rng): _fuzz_string(rng)}
        if rng.random() < 0.2:
            meta["managedFields"] = [{"m": [1, {"d": None}]}]
        obj["metadata"] = meta
    if rng.random() < 0.6:
        addrs = []
        for _ in range(rng.randrange(0, 3)):
            a = {}
            if rng.random() < 0.9:
                a["type"] = _fuzz_string(rng)
            if rng.random() < 0.9:
                a["address"] = _fuzz_string(rng)
            if rng.random() < 0.2:
                a["extra"] = 7
            addrs.append(a)
        obj["status"] = {"addresses": addrs}
        if rng.random() < 0.2:
            obj["status"]["allocatable"] = {"cpu": rng.choice(["4", 8, "500m"])}
    return obj


def _fuzz_pod(rng):
    meta = {"name": _fuzz_string(rng)}
    if rng.random() < 0.5:
        meta["namespace"] = _fuzz_string(rng)
    if rng.random() < 0.5:
        meta["annotations"] = {_fuzz_string(rng): (_fuzz_string(rng) if rng.random() < 0.9 else 3)
                               for _ in range(rng.randrange(0, 4))}
    if rng.random() < 0.4:
        meta["ownerReferences"] = [{"kind": rng.choice(["DaemonSet", "ReplicaSet", ""]),
                                    "name": _fuzz_string(rng)}
                                   for _ in range(rng.randrange(0, 3))]
    spec = {}
    if rng.random() < 0.6:
        spec["nodeName"] = rng.choice([_fuzz_string(rng), None])
    if rng.random() < 0.3:
        spec["containers"] = ([{"name": "c", "resources": {"requests": {"cpu": rng.random()}}}]
                              if rng.random() < 0.7 else [])
    return {"metadata": meta, "spec": spec}


@_route_cases([0, 1, 2, 3], ["0", "1", "2", "3"])
def test_decode_fuzzed_equals_reference(case, route):
    rng = random.Random(case)
    for kind, gen in ((0, _fuzz_node), (1, _fuzz_pod)):
        # json.dumps escapes the lone surrogates the alphabet carries
        _same_page(_body([gen(rng) for _ in range(150)]), kind, route)


def test_malformed_body_raises_the_json_error():
    """Both native decoders decline a malformed page (None, in both
    packages); the default route then reaches the twin, whose json.loads
    raises."""
    for body in (b'{"items": [{"metadata": }]}', b"not json"):
        with pytest.raises(json.JSONDecodeError):
            ref_ld.decode_list_page(body, 0, native=False)
        with pytest.raises(json.JSONDecodeError):
            port_ld.decode_list_page(body, 0)
        with pytest.raises(json.JSONDecodeError):
            port_ld.decode_list_page(body, 0, native=False)
        for native in ("pylist", True):
            assert port_ld.decode_list_page(body, 0, native=native) is None
            assert ref_ld.decode_list_page(body, 0, native=native) is None


# -- the store's columnar ingest ----------------------------------------------

def _maps(metric):
    from crane_scheduler_tpu_torch.constants import NODE_HOT_VALUE_KEY

    maps = []
    for i in range(64):
        anno = {metric: f"{i / 64:.5f},2026-01-01T00:00:0{i % 10}Z"}
        if i % 3 == 0:
            anno[NODE_HOT_VALUE_KEY] = f"{i},2026-01-01T00:00:00Z"
        if i % 5 == 0:
            anno["unrelated"] = "junk"
        if i % 11 == 0:
            anno[metric] = 7  # a non-string value: invalid, like the reference
        if i % 7 == 0:
            anno = {}
        maps.append((f"node-{i:03d}", anno))
    return maps


def _columns(maps):
    names = [n for n, _ in maps]
    keys, values = [], []
    offsets = np.zeros(len(maps) + 1, dtype=np.int64)
    for i, (_, anno) in enumerate(maps):
        for k, v in anno.items():
            keys.append(k)
            values.append(v)
        offsets[i + 1] = len(keys)
    return names, keys, values, offsets


def _rows(store):
    n = len(store)
    return (tuple(store.node_names), store.values[:n].copy(), store.ts[:n].copy(),
            store.hot_value[:n].copy(), store.hot_ts[:n].copy())


def _rows_equal(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)


def _stores():
    from crane_scheduler_tpu.loadstore import NodeLoadStore as RefStore
    from crane_scheduler_tpu.policy import DEFAULT_POLICY as REF_POLICY
    from crane_scheduler_tpu.policy import compile_policy as ref_compile
    from crane_scheduler_tpu_torch.loadstore import NodeLoadStore
    from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY, compile_policy

    tensors = compile_policy(DEFAULT_POLICY)
    ref_tensors = ref_compile(REF_POLICY)
    return (lambda: NodeLoadStore(tensors)), (lambda: RefStore(ref_tensors)), tensors


def test_ingest_annotation_columns_equals_bulk_ingest_and_reference():
    port_store, ref_store, tensors = _stores()
    maps = _maps(tensors.metric_names[0])
    cols = _columns(maps)
    a = port_store()
    a.bulk_ingest(maps)
    b = port_store()
    b.ingest_annotation_columns(*cols)
    r = ref_store()
    r.ingest_annotation_columns(*cols)
    _rows_equal(_rows(a), _rows(b))
    _rows_equal(_rows(b), _rows(r))
    assert b.version == r.version


def test_ingest_annotation_columns_only_names_equals_reference():
    port_store, ref_store, tensors = _stores()
    metric = tensors.metric_names[0]
    maps = _maps(metric)
    later = [(n, {metric: f"0.{i:05d},2026-01-02T00:00:00Z"}) for i, (n, _) in enumerate(maps)]
    dirty = {n for i, (n, _) in enumerate(maps) if i % 4 == 1}
    out = []
    for make in (port_store, ref_store):
        store = make()
        store.ingest_annotation_columns(*_columns(maps))
        store.ingest_annotation_columns(*_columns(later), only_names=dirty)
        out.append(_rows(store))
    _rows_equal(*out)
    # the dirty rows moved, the rest did not
    moved = [n for n in out[0][0] if n in dirty]
    assert moved and len(moved) < len(out[0][0])


# -- the mirror's transactions ------------------------------------------------

def _both_states():
    return port_state.ClusterState(), ref_state.ClusterState()


def _state_t(c):
    return (c.sched_version, c.node_version, c.node_set_version, c.pod_version,
            sorted(map(node_t, c.list_nodes())),
            sorted(map(pod_t, c.list_pods()), key=lambda t: (t[1], t[0])),
            sorted(c.count_pods_all().items()),
            [(e.name, e.message, e.resource_version) for e in c.list_events()])


def _apply(fn):
    """Run ``fn(module, cluster)`` on a port and a reference cluster."""
    port, ref = _both_states()
    fn(port_state, port)
    fn(ref_state, ref)
    assert _state_t(port) == _state_t(ref)
    return port, ref


def test_replace_nodes_and_pods_equal_reference():
    def run(m, c):
        c.add_node(m.Node(name="old", annotations={"x": "1"}))
        c.add_pod(m.Pod(name="stale", node_name="n1"))
        c.add_pod_burst("b", ["r0", "r1", "r2"])
        c.replace_nodes([m.Node(name="a", annotations={"k": "1"}),
                         m.Node(name="b", annotations={"k": "2"}), m.Node(name="c")])
        c.replace_nodes([m.Node(name="a", annotations={"k": "1"}),
                         m.Node(name="b", annotations={"k": "2"}), m.Node(name="c")])
        # a relist keeps p1, adds p2, prunes the stale pod and burst rows
        # the server no longer lists
        c.replace_pods([m.Pod(name="p1", node_name="n1"), m.Pod(name="p2"),
                        m.Pod(name="r1", namespace="b")])

    port, _ = _apply(run)
    assert port.count_pods("n1") == 1 and port.get_pod("b/r0") is None
    assert port.get_pod("b/r1") is not None


def test_apply_pod_and_node_changes_equal_reference():
    def run(m, c):
        c.add_node(m.Node(name="a"))
        c.apply_node_changes([("DELETED", m.Node(name="a")),
                              ("ADDED", m.Node(name="a", annotations={"back": "1"})),
                              ("ADDED", m.Node(name="b"))])
        c.apply_pod_changes([("ADDED", m.Pod(name="p1", node_name="n1")),
                             ("MODIFIED", m.Pod(name="p1", node_name="n2")),
                             ("ADDED", m.Pod(name="p2", node_name="n1")),
                             ("DELETED", m.Pod(name="p2", node_name="n1"))])

    port, _ = _apply(run)
    assert port.get_pod("default/p1").node_name == "n2"
    assert port.count_pods("n1") == 0 and port.count_pods("n2") == 1


def test_watch_echo_shadows_burst_rows_equal_reference():
    """``add_pod_burst`` registers rows before the creation POSTs; the
    watch echo of each created pod replaces its row (no duplicate
    object-plus-row entry), bound or not, and refused rows retire."""
    def run(m, c):
        burst = c.add_pod_burst("w", [f"e{i}" for i in range(6)])
        c.bind_burst(burst, ["n0", "n1"], [0, 1, -1, 0, -1, 1], now=5.0, notify=False)
        c.apply_pod_changes([("ADDED", m.Pod(name="e0", namespace="w", node_name="n0")),
                             ("ADDED", m.Pod(name="e2", namespace="w"))])
        c.retire_burst_rows(burst, [4])
        c.add_pod(m.Pod(name="e5", namespace="w", node_name="n1"))

    port, _ = _apply(run)
    keys = [p.key() for p in port.list_pods()]
    assert len(keys) == len(set(keys)) == 5 and "w/e4" not in keys
    assert port.count_pods("n0") == 2 and port.count_pods("n1") == 2


def test_notify_false_binds_record_no_event_equal_reference():
    def run(m, c):
        seen = []
        c.subscribe_events(seen.append)
        c.subscribe_events_batch(seen.extend, columnar=lambda *a: seen.append(a))
        c.add_pod(m.Pod(name="p0"))
        c.add_pod(m.Pod(name="p1"))
        c.bind_pods([("default/p0", "n0")], now=3.0, notify=False)
        burst = c.add_pod_burst("b", ["q0", "q1"])
        c.bind_burst(burst, ["n0", "n1"], [1, 0], now=3.0, notify=False)
        assert seen == []
        c.bind_pods([("default/p1", "n1")], now=4.0)  # notify: one event
        assert len(seen) == 2

    _apply(run)


# -- event dedup --------------------------------------------------------------

def _event_obj(name, rv=None, message="assigned"):
    meta = {"namespace": "d", "name": name}
    if rv is not None:
        meta["resourceVersion"] = str(rv)
    return {"metadata": meta, "type": "Normal", "reason": "Scheduled",
            "message": message, "count": 1, "lastTimestamp": "2026-07-30T00:00:00Z"}


EVENT_SCRIPT = [
    ("restart", None),
    ("batch", [("e1", 5), ("e2", 6), ("e3", 7)]),
    ("restart", None),
    ("batch", [("e1", 5), ("e2", 6), ("e3", 7), ("e4", 8)]),  # replay + one new
    ("batch", [("x", None), ("x", None)]),  # rv-less: content dedup
    ("batch", [("x", None), ("e5", 3)]),  # rv below the watermark on a live stream
    ("batch", [("e5", 3), ("e6", 9)]),  # untrusted rvs: content dedup only
    ("single", ("e6", 9)),
    ("single", ("e7", 10)),
]


def test_event_dedup_equals_reference(clients):
    out = []
    for pkg in ("port", "ref"):
        client = clients(pkg, seen_events_cap=4)
        got = []
        client.subscribe_events(got.append)
        for op, arg in EVENT_SCRIPT:
            if op == "restart":
                client._mark_event_stream_restart()
            elif op == "batch":
                client._apply_event_batch([("ADDED", _event_obj(n, rv)) for n, rv in arg])
            else:
                client._apply_event("ADDED", _event_obj(*arg))
        client._apply_event_batch([("DELETED", _event_obj("e8", 11))])
        out.append(([e.name for e in got], client._event_rv_watermark,
                    client._event_rv_trusted, list(client._seen_events)))
    assert out[0] == out[1]
    assert out[0][0][:4] == ["e1", "e2", "e3", "e4"] and out[0][2] is False


# -- the watch over the wire --------------------------------------------------

def test_reconnect_policy_equals_reference():
    cases = [(d, f, lived, idle) for d in (False, True) for f in (0, 1, 3)
             for lived in (0.5, 2.0, 300.0) for idle in (False, True)]
    port = [port_kube.KubeClusterClient._reconnect_immediately(*c) for c in cases]
    ref = [ref_kube.KubeClusterClient._reconnect_immediately(*c) for c in cases]
    assert port == ref and any(port) and not all(port)


def test_mirrors_equal_reference_through_storm_410_and_relist_race(stub, clients):
    """Port and reference clients on one stub hold node-for-node and
    pod-for-pod equal mirrors, equal to the stub: after bootstrap, a
    watch storm, a mid-stream 410 and a relist racing a storm."""
    st = stub.state
    for i in range(24):
        st.add_node(f"node-{i:03d}", f"10.0.0.{i}",
                    annotations={"m": f"0.{i},2026-01-01T00:00:00Z"},
                    allocatable={"cpu": "16", "pods": "110"} if i % 2 else None)
    for i in range(10):
        st.add_pod("default", f"p{i}", spec={"nodeName": f"node-{i:03d}"} if i % 3 else {})
    port, ref = clients("port", list_page_limit=7), clients("ref", list_page_limit=7)
    port.start()
    ref.start()

    def converged():
        want = stub_t(st)
        return mirror_t(port) == want and mirror_t(ref) == want

    assert _wait_until(converged)
    st.storm_nodes(300)
    assert _wait_until(converged, timeout=30.0)
    assert port.watch_coalesced >= 1 and port.watch_batches < port.watch_applied
    # a 410 lands mid-stream on the next node stream
    relists = port.relists + ref.relists
    st.inject_watch_410_after("nodes", 2)
    st.close_watches()
    assert _wait_until(lambda: len(st.watchers) >= 6)
    st.storm_nodes(12, key="storm")
    assert _wait_until(lambda: port.relists + ref.relists > relists, timeout=20.0)
    assert _wait_until(converged, timeout=30.0)
    # the resume window expires mid-storm: both relist and converge
    storm = threading.Thread(target=st.storm_nodes, args=(200,), daemon=True)
    storm.start()
    time.sleep(0.02)
    st.compact_history()
    st.close_watches()
    storm.join(timeout=30.0)
    st.add_pod("default", "late", spec={"nodeName": "node-001"})
    assert _wait_until(converged, timeout=30.0)
    assert port.watch_errors == 0


def test_torn_watch_lines_reassemble(stub, clients):
    stub.state.torn_watch_writes = True
    stub.state.add_node("node-a", "10.0.0.1")
    client = clients("port")
    client.start()
    for i in range(8):
        stub.state.add_node(f"torn-{i}", f"10.0.1.{i}")
    assert _wait_until(lambda: mirror_t(client) == stub_t(stub.state))
    assert client.watch_errors == 0


def test_bookmark_only_stream_reconnects_cleanly(stub, clients):
    stub.state.watch_bookmark_interval = 0.05
    stub.state.add_node("node-a", "10.0.0.1")
    client = clients("port")
    client.start()
    time.sleep(0.6)  # several bookmark-only stream generations
    assert client.watch_errors == 0
    assert _wait_until(lambda: client._rvs.get("nodes") == str(stub.state.resource_version))
    stub.state.add_node("node-late", "10.0.9.9")
    assert _wait_until(lambda: client.get_node("node-late") is not None)


def test_410_mid_stream_relists_once(stub, clients):
    for i in range(6):
        stub.state.add_node(f"node-{i}", f"10.0.0.{i}")
    client = clients("port")
    client.start()
    relists0 = client.relists
    stub.state.inject_watch_410_after("nodes", 2)
    stub.state.close_watches()
    assert _wait_until(lambda: len(stub.state.watchers) >= 3)
    stub.state.storm_nodes(6, key="storm")
    assert _wait_until(lambda: client.relists > relists0, timeout=15.0)
    assert _wait_until(lambda: all(
        (client.get_node(f"node-{i}") or port_state.Node(name="x")).annotations.get("storm")
        == str(i) for i in range(6)), timeout=15.0)
    assert client.relists == relists0 + 1


def test_idle_expired_watch_reconnects_immediately(stub, clients):
    stub.state.add_node("node-a", "10.0.0.1")
    stub.state.watch_bookmark_interval = 60.0
    client = clients("port")
    client._watch_timeout = 0.25
    client.start()
    time.sleep(1.3)
    connects = sum(1 for m, p in list(stub.state.requests)
                   if m == "GET" and p.startswith("/api/v1/nodes?watch=1"))
    assert connects >= 3 and client.watch_errors == 0


def test_stop_joins_every_thread(stub):
    """``stop`` ends the watch threads, the NRT prober and the write
    workers and waits for them: nothing of the client outlives it."""
    stub.state.serve_nrt = False  # the prober runs too
    stub.state.add_node("node-a", "10.0.0.1")
    stub.state.add_pod("default", "p0")
    client = port_kube.KubeClusterClient(stub.url)
    client.start()
    assert client.patch_node_annotation("node-a", "k", "v")
    threads = list(client._threads) + list(client._pool)
    assert len(threads) == 4 + 4
    t0 = time.monotonic()
    client.stop()
    assert time.monotonic() - t0 < 5.0
    assert not any(t.is_alive() for t in threads)
    assert client._threads == []


# -- the refresh's columnar branch --------------------------------------------

def _annotated_stub(stub, n, metrics, now_str="2026-01-01T00:00:00Z"):
    for i in range(n):
        stub.state.add_node(f"node-{i:03d}", f"10.0.0.{i}",
                            {m: f"{(i * 7 + j) % 16 / 16:.5f},{now_str}"
                             for j, m in enumerate(metrics)})


def test_columnar_refresh_equals_reference_and_sweep(stub, clients):
    from crane_scheduler_tpu.framework.scheduler import BatchScheduler as RefBatch
    from crane_scheduler_tpu.policy import DEFAULT_POLICY as REF_POLICY
    from crane_scheduler_tpu_torch.framework.scheduler import BatchScheduler
    from crane_scheduler_tpu_torch.loadstore import NodeLoadStore
    from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY, compile_policy

    tensors = compile_policy(DEFAULT_POLICY)
    _annotated_stub(stub, 16, tensors.metric_names)
    port, ref = clients("port", list_page_limit=5), clients("ref", list_page_limit=5)
    port.start()
    ref.start()
    batch = BatchScheduler(port, DEFAULT_POLICY, snapshot_bucket=32, device="cpu")
    ref_batch = RefBatch(ref, REF_POLICY, snapshot_bucket=32)

    def sweep_rows():
        twin = NodeLoadStore(tensors)
        twin.bulk_ingest((n.name, n.annotations) for n in port.list_nodes())
        order = [twin.node_id(n) for n in batch.store.node_names]
        n = len(batch.store)
        np.testing.assert_array_equal(batch.store.values[:n], twin.values[order])
        np.testing.assert_array_equal(batch.store.ts[:n], twin.ts[order])
        np.testing.assert_array_equal(batch.store.hot_value[:n], twin.hot_value[order])

    batch.refresh()
    ref_batch.refresh()
    assert batch.refresh_stats["columnar_ingest"] == ref_batch.refresh_stats["columnar_ingest"] == 1
    _rows_equal(_rows(batch.store), _rows(ref_batch.store))
    sweep_rows()
    # an unchanged mirror: the version gate skips the ingest
    v = batch.store.version
    batch.refresh()
    assert batch.refresh_stats["columnar_ingest"] == 1 and batch.store.version == v
    # a named annotation patch over the wire: the port patches its columns
    # from the journal and ingests only the dirty rows
    metric = tensors.metric_names[0]
    patch = {f"node-{i:03d}": {metric: f"0.99000,2026-01-01T00:00:0{i % 10}Z"}
             for i in (1, 5, 9)}
    assert port.patch_node_annotations_bulk(patch) == 3
    assert ref.patch_node_annotations_bulk(patch) == 3
    want = stub_t(stub.state)
    assert _wait_until(lambda: mirror_t(port) == want and mirror_t(ref) == want)
    batch.refresh()
    ref_batch.refresh()
    assert batch.refresh_stats["dirty_ingest"] >= 1
    assert batch.refresh_stats["columnar_ingest"] >= 2
    _rows_equal(_rows(batch.store), _rows(ref_batch.store))
    sweep_rows()
    # a new node changes membership: the columns drop, the sweep serves
    dirty = batch.refresh_stats["dirty_ingest"]
    stub.state.add_node("node-new", "10.0.9.9", {metric: "0.99900,2026-01-01T00:00:00Z"})
    assert _wait_until(lambda: port.get_node("node-new") is not None
                       and ref.get_node("node-new") is not None)
    assert port.node_annotation_columns() is None
    batch.refresh()
    ref_batch.refresh()
    assert batch.refresh_stats["dirty_ingest"] == dirty
    _rows_equal(_rows(batch.store), _rows(ref_batch.store))
    # a relist brings the columns back, equal to the sweep
    port._relist_nodes()
    batch.refresh()
    sweep_rows()


def test_node_annotation_columns_follow_the_mirror(stub, clients):
    """After annotation-only writes (patches, watch deliveries) the
    re-keyed columns equal a fresh relist's, row for row."""
    _annotated_stub(stub, 12, ["m0", "m1"])
    client = clients("port", list_page_limit=4)
    client.start()
    v0 = client.node_annotation_columns()[0]
    assert client.patch_node_annotation("node-003", "m0", "x")
    stub.state.storm_nodes(30)
    assert _wait_until(lambda: mirror_t(client) == stub_t(stub.state))
    version, names, keys, values, offsets = client.node_annotation_columns()
    assert version == client.node_version > v0
    got = {names[i]: dict(zip(keys[offsets[i]:offsets[i + 1]], values[offsets[i]:offsets[i + 1]]))
           for i in range(len(names))}
    assert got == {n.name: dict(n.annotations) for n in client.list_nodes()}


def test_read_path_metrics_populate(stub):
    from crane_scheduler_tpu_torch.telemetry import Telemetry
    from crane_scheduler_tpu_torch.telemetry.expfmt import parse_exposition

    tel = Telemetry()
    for i in range(8):
        stub.state.add_node(f"node-{i}", f"10.0.0.{i}")
    client = port_kube.KubeClusterClient(stub.url, telemetry=tel)
    try:
        client.start()
        for i in range(20):
            stub.state.add_pod("d", f"p{i}", spec={"nodeName": "node-0"})
        assert _wait_until(lambda: client.get_pod("d/p19") is not None)
        families = parse_exposition(tel.registry.render())
        assert "crane_kube_watch_apply_batch_pods" in families
        counts = [v for name, _labels, v in
                  families["crane_kube_list_decode_seconds"]["samples"]
                  if name.endswith("_count")]
        assert sum(counts) >= 2
    finally:
        client.stop()
