"""The port's pipelined kube write paths against the JAX package's,
through the wire stub's fault classes: a 409 bind conflict, a 429 with
Retry-After, a mid-pipeline connection reset and a wedged server. Cases
run both packages on their Python pipelined route (the native flush
engine disabled); cases with a ``-native`` id run both on the host
library's flush engine.

POST safety is the contract: a response-phase transport failure marks
the awaited request and everything pipelined behind it on that connection
indeterminate (status 0), never re-POSTed, while idempotent merge-patches
retry on a fresh connection. Each case runs once per package on its own
identically seeded stub and compares per-request statuses, the public
write results and the stub's oracle (``bind_posts``, ``duplicate_binds``)
exactly. Mirrors the Python cases of ``tests/test_write_pipeline.py``.
Every case runs under a 120 s limit.
"""

import copy
import importlib.util
import os
import signal
import time

import numpy as np
import pytest

import crane_scheduler_tpu.cluster.kube as ref_kube
import crane_scheduler_tpu_torch.cluster.kube as port_kube

_STUB = os.path.join(os.path.dirname(__file__), "kube_stub.py")
_spec = importlib.util.spec_from_file_location("kube_stub_torch_wp", _STUB)
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


def _seed(state, nodes=4, pods=8, ns="t"):
    for i in range(nodes):
        state.add_node(f"node-{i}", f"10.0.0.{i}")
    for i in range(pods):
        state.add_pod(ns, f"p{i}")


def _bind_requests(client, n=8, ns="t"):
    return [client._render_request("POST", f"/api/v1/namespaces/{ns}/pods/p{i}/binding",
                                   client._render_binding_body(ns, f"p{i}", f"node-{i % 4}"))
            for i in range(n)]


def _patch_requests(client, n=8):
    return [client._render_request("PATCH", f"/api/v1/nodes/node-{i % 4}",
                                   {"metadata": {"annotations": {f"k{i}": "v"}}},
                                   "application/merge-patch+json")
            for i in range(n)]


def _oracle(state):
    with state.lock:
        return (dict(state.bind_posts), state.duplicate_binds(),
                sorted((k, (p.get("spec") or {}).get("nodeName") or "")
                       for k, p in state.pods.items()),
                sorted((n, sorted(o["metadata"]["annotations"].items()))
                       for n, o in state.nodes.items()))


class _RefPythonClient(ref_kube.KubeClusterClient):
    """The reference client on its Python write route: the native flush
    engine disabled, as when its library is absent."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._native_flush_disabled = True


class _PortPythonClient(port_kube.KubeClusterClient):
    """The port client on its Python write route."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._native_flush_disabled = True


KUBES = {"ref": type("ref_kube", (), {"KubeClusterClient": _RefPythonClient}),
         "port": type("port_kube", (), {"KubeClusterClient": _PortPythonClient})}
NATIVE_KUBES = {"ref": ref_kube, "port": port_kube}


def both(scenario, native=False):
    out = []
    kubes = NATIVE_KUBES if native else KUBES
    for name in ("ref", "port"):
        stub = kube_stub.KubeStubServer().start()
        try:
            out.append(scenario(kubes[name], stub))
        finally:
            stub.stop()
    return out


def _route_cases(names):
    """``(case, native)`` cases: the Python route keeps each original id,
    the flush engine adds ``<id>-native``."""
    return pytest.mark.parametrize(
        "case,native", [(c, False) for c in names] + [(c, True) for c in names],
        ids=list(names) + [f"{c}-native" for c in names])


FLUSH_CASES = {
    # name: (faults, requests, idempotent, client kwargs)
    "clean_binds": ((), "bind", False, {}),
    "bind_409_not_retried": (((409, {"message": "conflict", "_skip": 1}),), "bind", False, {}),
    "reset_posts_indeterminate": (((0, {"_skip": 3}),), "bind", False, {}),
    "reset_retries_patches": (((0, {"_skip": 3}),), "patch", True, {}),
    "wedged_server_times_out": (((-1, {"seconds": 30.0}),), "bind4", False, {"timeout": 1.0}),
    # two connections: which one the reset lands on depends on timing, the
    # idempotent outcome does not
    "two_connections_reset_patches": (((0, {"_skip": 2}),), "patch", True,
                                      {"concurrent_syncs": 2}),
}


@_route_cases(sorted(FLUSH_CASES))
def test_pipelined_flush_equals_reference(case, native):
    faults, kind, idempotent, kw = FLUSH_CASES[case]

    def scenario(kube, stub):
        _seed(stub.state)
        # the stub counts a fault's _skip down in place: a copy per run
        stub.state.inject_write_faults(*copy.deepcopy(faults))
        client = kube.KubeClusterClient(stub.url, **{"concurrent_syncs": 1, **kw})
        if kind == "patch":
            reqs = _patch_requests(client)
        else:
            reqs = _bind_requests(client, n=4 if kind == "bind4" else 8)
        t0 = time.perf_counter()
        if native:
            statuses = client._get_native_flusher().flush_pipelined(
                reqs, idempotent=idempotent).tolist()
        else:
            statuses = client._pipelined_flush(reqs, idempotent=idempotent)
        elapsed = time.perf_counter() - t0
        client.stop()
        return list(statuses), _oracle(stub.state), elapsed < 10.0

    ref, port = both(scenario, native)
    assert port == ref
    statuses, (posts, dups, _, _), fast = ref
    assert dups == 0 and fast
    if case == "clean_binds":
        assert statuses == [201] * 8 and sum(posts.values()) == 8
    if case == "bind_409_not_retried":
        assert statuses[1] == 409 and "t/p1" not in posts
    if case == "reset_posts_indeterminate":
        assert statuses == [201] * 3 + [0] * 5 and sum(posts.values()) == 3
    if case.startswith("reset_retries") or case.startswith("two_connections"):
        assert statuses == [200] * 8
    if case == "wedged_server_times_out":
        assert statuses == [0] * 4 and not posts


PUBLIC_CASES = {
    "bind_pods_429_redriven": (429, {"message": "throttled", "_skip": 5},
                               {"Retry-After": "0.05"}),
    "bind_pods_409_dropped": (409, {"message": "conflict", "_skip": 7}, {}),
    "bind_pods_reset_indeterminate": (0, {"_skip": 20}, {}),
    "annotations_500_redriven": (500, {"message": "boom", "_skip": 3}, {}),
}


@_route_cases(sorted(PUBLIC_CASES))
def test_public_batch_writes_equal_reference(case, native):
    """``bind_pods`` and ``patch_node_annotations_bulk`` over 130 objects
    ride the pipelined flush (the engine in the ``-native`` cases); a 429
    re-drives through the pool (bound exactly once), a 409 is dropped, a
    reset leaves its POSTs indeterminate, a 500 on a merge-patch
    re-drives."""
    fault = PUBLIC_CASES[case]

    def scenario(kube, stub):
        _seed(stub.state, pods=0)
        client = kube.KubeClusterClient(stub.url, concurrent_syncs=1)
        client.start()
        handle = client.add_pod_burst("t", [f"q{i}" for i in range(130)])
        assert not handle.failed
        stub.state.inject_write_faults(copy.deepcopy(fault))
        if case.startswith("annotations"):
            res = client.patch_node_annotations_bulk(
                {f"node-{i % 4}" if i < 4 else f"ghost-{i}": {"k": str(i)} for i in range(130)})
        else:
            res = client.bind_pods([(f"t/q{i}", f"node-{i % 4}") for i in range(130)])
        failures = dict(client.write_failures_by_status)
        client.stop()
        return res, failures, _oracle(stub.state)

    ref, port = both(scenario, native)
    assert port == ref
    res, failures, (posts, dups, _, _) = ref
    assert dups == 0
    if case == "bind_pods_429_redriven":
        assert len(res) == 130 and sum(posts.values()) == 130
    if case == "bind_pods_409_dropped":
        assert len(res) == 129 and failures == {409: 1}
    if case == "annotations_500_redriven":
        assert res == 4


def test_bind_pods_mirror_apply_is_batched_and_eventless():
    def scenario(kube, stub):
        _seed(stub.state, pods=0)
        client = kube.KubeClusterClient(stub.url, concurrent_syncs=1)
        client.start()
        seen = []
        client.subscribe_events(seen.append)
        handle = client.add_pod_burst("t", [f"e{i}" for i in range(10)])
        assert not handle.failed
        v = client.pod_version
        bound = client.bind_pods([(f"t/e{i}", f"node-{i % 4}") for i in range(10)])
        mirror = [client.get_pod(f"t/e{i}").node_name for i in range(10)]
        deadline = time.time() + 5.0
        while len(seen) < 10 and time.time() < deadline:
            time.sleep(0.02)
        time.sleep(0.2)
        client.stop()
        return (bound, mirror, sorted(e.name for e in seen), client.pod_version - v >= 10,
                _oracle(stub.state))

    ref, port = both(scenario)
    assert port == ref and len(ref[2]) == 10


def test_overlap_bind_over_kube_boundary_equals_reference():
    """The pipelined burst loop with ``overlap_bind`` over the client:
    every result's binds settle by generator exhaustion, placements and
    the stub's bindings equal the reference's, no duplicate bind."""
    def scenario(kube, stub):
        if kube is KUBES["ref"]:
            from crane_scheduler_tpu.annotator import AnnotatorConfig, NodeAnnotator
            from crane_scheduler_tpu.framework.scheduler import BatchScheduler
            from crane_scheduler_tpu.metrics import FakeMetricsSource
            from crane_scheduler_tpu.policy import DEFAULT_POLICY
            dev = {}
        else:
            from crane_scheduler_tpu_torch.annotator import AnnotatorConfig, NodeAnnotator
            from crane_scheduler_tpu_torch.framework.scheduler import BatchScheduler
            from crane_scheduler_tpu_torch.metrics import FakeMetricsSource
            from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY
            dev = {"device": "cpu"}
        for i in range(8):
            stub.state.add_node(f"node-{i}", f"10.0.1.{i}")
        client = kube.KubeClusterClient(stub.url, concurrent_syncs=1)
        client.start()
        fake = FakeMetricsSource()
        for i in range(8):
            for sp in DEFAULT_POLICY.spec.sync_period:
                fake.set(sp.name, f"10.0.1.{i}", 0.1 + 0.05 * i, by="ip")
        ann = NodeAnnotator(client, fake, DEFAULT_POLICY,
                            AnnotatorConfig(bulk_sync=True, direct_store=True))
        batch = BatchScheduler(client, DEFAULT_POLICY, snapshot_bucket=16,
                               refresh_from_cluster=False, clock=lambda: 1753776000.0, **dev)
        ann.attach_store(batch.store)
        ann.sync_all_once_bulk(1753776000.0)
        streams = [("w", [f"c{c}x{i}" for i in range(40)]) for c in range(4)]
        results = list(batch.schedule_bursts_pipelined(
            streams, bind=True, overlap_bind=True, bind_window_s=0.05))
        client.stop()
        return ([len(r.bound_rows) for r in results],
                [np.asarray(r.node_idx).tolist() for r in results], _oracle(stub.state)[:3])

    ref, port = both(scenario)
    assert port == ref
    assert ref[0] == [40] * 4 and ref[2][1] == 0 and sum(ref[2][0].values()) == 160
