"""The port's replicated tier against the JAX package's: delta frames,
the publisher and its mirror, the cluster's bulk transactions, the
serving replica's bodies and the router.

Each case runs one scenario through ``crane_scheduler_tpu`` and
``crane_scheduler_tpu_torch`` (``device="cpu"``) on the same seeded
inputs (numpy, or a reference ``Simulator`` carried over with
``convert.cluster_from_nodes``) and compares frames and bodies as bytes,
and fences, journals, stats and routes as values. A replica body's
``"backend"`` names the device type (``"cpu"``) where the reference's
says ``"tpu"``; the comparison maps that one field. Tolerance: exact.
Every case that opens sockets or threads runs under a 120 s limit.
"""

import http.client
import json
import signal
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crane_scheduler_tpu.cluster as ref_cluster_mod
import crane_scheduler_tpu.cluster.replication as ref_repl
import crane_scheduler_tpu.service as ref_service
import crane_scheduler_tpu_torch.cluster as port_cluster_mod
import crane_scheduler_tpu_torch.cluster.replication as port_repl
import crane_scheduler_tpu_torch.service as port_service
from crane_scheduler_tpu.policy import DEFAULT_POLICY as REF_POLICY
from crane_scheduler_tpu.sim import SimConfig, Simulator
from crane_scheduler_tpu_torch.convert import cluster_from_nodes
from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY

REF = dict(cluster=ref_cluster_mod, repl=ref_repl, service=ref_service,
           policy=REF_POLICY, f32=jnp.float32, f64=jnp.float64)
PORT = dict(cluster=port_cluster_mod, repl=port_repl, service=port_service,
            policy=DEFAULT_POLICY, f32=torch.float32, f64=torch.float64)


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


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` once per package."""
    return scenario(REF, *args), scenario(PORT, *args)


def as_port(body: bytes) -> bytes:
    return body.replace(b'"backend":"tpu"', b'"backend":"cpu"')


def seeded_payload(rng, n=12):
    nodes = {}
    for i in range(n):
        if rng.random() < 0.15:
            nodes[f"n{i:03d}"] = None
        else:
            nodes[f"n{i:03d}"] = {f"k{j}": f"{rng.random():.5f},2025-07-29T08:00:0{j}Z"
                                  for j in range(int(rng.integers(0, 4)))}
    return {"from": int(rng.integers(-1, 50)), "v": int(rng.integers(50, 99)),
            "nodes": nodes, **({"snap": True} if rng.random() < 0.3 else {})}


# -- frames ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frames_byte_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        payload = seeded_payload(rng)
        frame = port_repl.encode_frame(payload)
        assert frame == ref_repl.encode_frame(payload)
        assert port_repl.DeltaDecoder().feed(frame) == [payload]


@pytest.mark.parametrize("seed", [3, 4])
def test_torn_tail_and_corruption_equal_reference(seed):
    rng = np.random.default_rng(seed)
    blob = b"".join(port_repl.encode_frame(seeded_payload(rng)) for _ in range(5))
    cuts = sorted(set(rng.integers(1, len(blob), 30).tolist()))

    def run(pkg):
        dec = pkg["repl"].DeltaDecoder()
        out, prev = [], 0
        for c in cuts + [len(blob)]:
            frames = dec.feed(blob[prev:c])
            out.append((len(frames), dec.pending_bytes, frames))
            prev = c
        # a torn tail stays buffered; corruption and bad magic poison
        dec.feed(blob[:17])
        tail = dec.pending_bytes
        bad = bytearray(port_repl.encode_frame({"v": 1}))
        bad[-1] ^= 1
        errs = []
        for data in (bytes(bad), b"XXXX" + bytes(12)):
            try:
                pkg["repl"].DeltaDecoder().feed(data)
                errs.append(None)
            except pkg["repl"].FrameError as e:
                errs.append(str(e))
        return out, tail, errs

    ref, port = both(run)
    assert port == ref and port[2] == ["frame crc mismatch", "bad frame magic"]


# -- publisher, mirror ---------------------------------------------------------


def edit_world(pkg, seed, n=40):
    rng = np.random.default_rng(seed)
    cm = pkg["cluster"]
    cluster = cm.ClusterState()
    for i in range(n):
        cluster.add_node(cm.Node(name=f"n{i:03d}", annotations={"cpu": f"0.{i % 10}"}))
    return rng, cluster


def edit(pkg, cluster, rng, step):
    cm = pkg["cluster"]
    names = cluster.node_names()
    kind = step % 5
    if kind == 0:
        for name in rng.choice(names, 4, replace=False):
            cluster.patch_node_annotation(str(name), "cpu", f"{rng.random():.5f}")
    elif kind == 1:
        cluster.patch_node_annotations_bulk(
            {str(n): {"mem": f"{rng.random():.5f}"} for n in rng.choice(names, 6, replace=False)})
    elif kind == 2:
        cluster.add_node(cm.Node(name=f"x{step:03d}", annotations={"cpu": "0.5"}))
        cluster.delete_node(str(rng.choice(names)))
    elif kind == 3:
        cluster.patch_node_annotations_columns(
            list(names), {"hot": [f"{rng.random():.2f}" for _ in names]})
    # kind 4: a quiet window


def test_publisher_windows_equal_reference():
    def run(pkg):
        rng, cluster = edit_world(pkg, 7)
        frames = []
        pub = pkg["repl"].DeltaPublisher(cluster, ring_frames=8)
        pub.subscribe(lambda b: frames.append(b) or True, -1, name="c0")
        shipped = []
        for step in range(24):
            edit(pkg, cluster, rng, step)
            shipped.append((pub.publish_window(), pub.published_version))
        late = []
        pub.subscribe(lambda b: late.append(b) or True, shipped[-5][1], name="late")
        snap = []
        pub.subscribe(lambda b: snap.append(b) or True, 0, name="old")
        return shipped, frames, late, snap, pub.status(), pub.stats

    ref, port = both(run)
    assert port == ref
    shipped, frames, late, snap, status, _ = port
    assert any(n == 0 for n, _ in shipped[1:]) and len(late) == 4 and len(snap) == 1
    assert status["snapshotsSent"] == 1


def test_mirror_gaps_ring_replay_and_snapshot_equal_reference():
    def run(pkg):
        rng, cluster = edit_world(pkg, 8)
        repl = pkg["repl"]
        pub = repl.DeltaPublisher(cluster, ring_frames=4)
        mirror = repl.ReplicaMirror()
        log = []

        def send(b):
            for frame in repl.DeltaDecoder().feed(b):
                try:
                    log.append(("applied", mirror.apply_frame(frame)))
                except repl.VersionGapError as e:
                    log.append(("gap", e.expected, e.got))
            return True

        pub.subscribe(send, mirror.applied_version)
        for step in range(6):
            edit(pkg, cluster, rng, step)
            pub.publish_window()
        pub.unsubscribe(send)
        cursor = mirror.applied_version
        for step in range(6, 8):  # inside the ring
            edit(pkg, cluster, rng, step)
            pub.publish_window()
        pub.subscribe(send, cursor)  # ring replay
        pub.unsubscribe(send)
        # a frame from a foreign fence is a gap and leaves the mirror
        send(repl.encode_frame({"from": cursor - 1, "v": 10**6, "nodes": {}}))
        for step in range(8, 20):  # past the ring
            edit(pkg, cluster, rng, step)
            pub.publish_window()
        pub.subscribe(send, mirror.applied_version)  # snapshot
        mirror_annos = {n.name: dict(n.annotations) for n in mirror.cluster.list_nodes()}
        live = {n.name: dict(n.annotations) for n in cluster.list_nodes()}
        return (log, mirror.status(), pub.status(), mirror_annos == live,
                mirror.applied_version == pub.published_version,
                mirror.cluster.dirty_nodes_since(0), mirror.cluster.node_version)

    ref, port = both(run)
    assert port == ref
    assert port[1]["gaps"] == 1 and port[1]["snapshotsApplied"] == 1 and port[3] and port[4]


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_node_changes_and_replace_nodes_journal_equal_reference(seed):
    def run(pkg):
        rng = np.random.default_rng(seed)
        cm = pkg["cluster"]
        cluster = cm.ClusterState()
        addr = lambda i, k=0: (cm.NodeAddress("InternalIP", f"10.0.{k}.{i}"),)  # noqa: E731
        for i in range(20):
            cluster.add_node(cm.Node(name=f"n{i:02d}", addresses=addr(i)))
        marks = []

        def mark():
            marks.append((cluster.sched_version, cluster.node_version,
                          cluster.node_set_version, cluster.pod_version))

        mark()
        for step in range(6):
            changes = []
            for i in rng.choice(24, 5, replace=False):
                name = f"n{int(i):02d}"
                if rng.random() < 0.3:
                    changes.append(("DELETED", cm.Node(name=name)))
                else:
                    changes.append(("MODIFIED", cm.Node(
                        name=name, annotations={"cpu": f"{rng.random():.3f}"},
                        addresses=addr(int(i), int(rng.random() < 0.2)))))
            cluster.apply_node_changes(changes)
            mark()
        cluster.apply_node_changes([])
        mark()
        v_before = cluster.node_version
        cluster.replace_nodes([cm.Node(name=f"n{i:02d}", annotations={"r": str(i)},
                                       addresses=addr(i)) for i in range(3, 22)])
        mark()
        cluster.replace_nodes(cluster.list_nodes())  # same set and addresses
        mark()
        cluster.patch_node_annotation("n05", "cpu", "0.9")
        mark()
        journal = [cluster.dirty_nodes_since(v) for v in range(0, cluster.node_version + 1)]
        return (marks, journal, cluster.node_names(), v_before,
                cluster.pod_changes_since(0), cluster.dirty_journal_stats())

    ref, port = both(run)
    assert port == ref
    journal = port[1]
    assert journal[-2] == ({"n05"}, False) and journal[0] is None


def test_bound_counts_and_node_names_equal_reference():
    def run(pkg):
        cm = pkg["cluster"]
        cluster = cm.ClusterState()
        names = [f"n{i}" for i in range(10)]
        for n in names:
            cluster.add_node(cm.Node(name=n))
        for k in range(7):
            cluster.add_pod(cm.Pod(name=f"p{k}", node_name=names[k % 3]))
        burst = cluster.add_pod_burst("default", [f"b{k}" for k in range(30)])
        cluster.bind_burst(burst, names, np.arange(30, dtype=np.int32) % 10 // 2, now=1.0)
        return cluster.bound_counts_for(names).tolist(), cluster.node_names()

    ref, port = both(run)
    assert port == ref and sum(port[0]) == 37


# -- serving replicas ------------------------------------------------------------


def sim_frames(seed, n_nodes=48):
    """Publisher frames over a reference simulator after one annotator
    pass and one churn window: the snapshot-then-delta stream a replica
    sees, plus the sim's now."""
    sim = Simulator(SimConfig(n_nodes=n_nodes, seed=seed))
    sim.sync_metrics()
    frames = []
    pub = ref_repl.DeltaPublisher(sim.cluster)
    pub.publish_window()
    pub.subscribe(lambda b: frames.append(b) or True, -1)
    sim.clock.advance(60.0)
    for name in [n.name for n in sim.cluster.list_nodes()][::7]:
        sim.cluster.patch_node_annotation(name, "cpu_usage_avg_5m", "0.91000," +
                                          sim.cluster.get_node(name).annotations[
                                              "cpu_usage_avg_5m"].split(",")[1])
    pub.publish_window()
    return sim.clock.now(), frames


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_replica_bodies_byte_equal_reference(dtype):
    now, frames = sim_frames(5)

    def run(pkg):
        kw = {"device": "cpu"} if pkg is PORT else {}
        replica = pkg["service"].ServingReplica(
            pkg["policy"], name="r0", dtype=pkg[dtype], now_bucket_s=0.0,
            clock=lambda: now, **kw)
        try:
            bodies = []
            for k, blob in enumerate(frames):
                for frame in pkg["repl"].DeltaDecoder().feed(blob):
                    replica.mirror.apply_frame(frame)
                for dt in (0.0, 30.5, 200.0, 900.0):
                    bodies.append(replica.service.score_response_bytes(
                        now=now + dt, refresh=True))
            bodies.append(replica.service.score_response_bytes(now=now, refresh=False))
            status = replica.status()
            return bodies, status, replica.service.metrics()["fallbacks"]
        finally:
            replica.stop()

    ref, port = both(run)
    assert port[0] == [as_port(b) for b in ref[0]]
    assert port[1] == ref[1] and port[2] == 0
    doc = json.loads(port[0][-1])
    assert doc["backend"] == "cpu" and doc["version"] == port[1]["appliedVersion"]
    assert list(doc) == sorted(doc) and len(doc["scores"]) == 48


def test_route_for_1000_tenants_equal_reference():
    def run(pkg):
        names = [(f"replica-{i}", "127.0.0.1", 1 + i) for i in range(4)]
        out = {}
        for mode in ("hash", "rr"):
            router = pkg["service"].ReplicaRouter(names, mode=mode)
            try:
                for b in router._backends:
                    b.routable = True
                routes = [router.route_for(f"tenant-{k}") for k in range(1000)]
                router._backends[1].routable = False  # ejected
                after = [router.route_for(f"tenant-{k}") for k in range(1000)]
                order = [b.name for b in router._pick({"crane-tenant": "tenant-3"})]
                out[mode] = (routes, after, order)
            finally:
                router.stop()
        return out

    ref, port = both(run)
    assert port == ref
    assert len(set(port["hash"][0])) == 4 and "replica-1" not in port["hash"][1]


def _post(port, path, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not met in time"
        time.sleep(0.01)


def test_probe_eject_and_lag_gate_equal_reference():
    sim = Simulator(SimConfig(n_nodes=24, seed=2))
    sim.sync_metrics()
    nodes = [{"name": n.name, "annotations": dict(n.annotations)}
             for n in sim.cluster.list_nodes()]
    now = sim.clock.now()

    def run(pkg):
        svc_mod = pkg["service"]
        cluster = (ref_cluster_mod.ClusterState() if pkg is REF else cluster_from_nodes(nodes))
        if pkg is REF:
            for n in nodes:
                cluster.add_node(ref_cluster_mod.Node(name=n["name"],
                                                      annotations=n["annotations"]))
        kw = {"device": "cpu"} if pkg is PORT else {}
        svc = svc_mod.ScoringService(cluster, pkg["policy"], now_bucket_s=0.0, **kw)
        pub = pkg["repl"].DeltaPublisher(cluster)
        server = svc_mod.ScoringHTTPServer(svc, port=0, frontend="async", replication=pub)
        server.start()
        pub.publish_window()
        replicas, router = [], None
        try:
            for i in range(2):
                r = svc_mod.ServingReplica(pkg["policy"], name=f"replica-{i}",
                                           feed=("127.0.0.1", server.port),
                                           now_bucket_s=0.0, **kw)
                r.start()
                replicas.append(r)
            for r in replicas:
                assert r.wait_caught_up(pub.published_version, timeout_s=30)
            router = svc_mod.ReplicaRouter(
                [(r.name, "127.0.0.1", r.port) for r in replicas],
                primary=("127.0.0.1", server.port), lag_budget_versions=0,
                probe_interval_s=3600.0)
            router.start()
            seen = []

            def snap():
                st = router.status()
                seen.append([(b["name"], b["healthy"], b["routable"], b["lagVersions"])
                             for b in st["replicas"]])

            snap()
            tenant = next(t for t in (f"t{k}" for k in range(100))
                          if router.route_for(t) == "replica-1")
            body = json.dumps({"now": now, "refresh": True}).encode()
            status, payload = _post(router.port, "/v1/score", body, {"crane-tenant": tenant})
            direct = _post(replicas[1].port, "/v1/score", body)[1]
            # lag gate: replica-0's feed stops, the primary publishes
            replicas[0].feed_client.stop()
            name0 = nodes[0]["name"]
            cluster.patch_node_annotation(name0, "crane.io/churn", "1")
            pub.publish_window()
            _wait(lambda: replicas[1].applied_version == pub.published_version)
            router.probe_once()
            snap()
            # eject: replica-1 dies; its tenant fails over (score is idempotent)
            replicas[1].stop()
            status2, _ = _post(router.port, "/v1/score", body, {"crane-tenant": tenant})
            snap()
            router.probe_once()
            snap()
            return (seen, status, payload == direct, status2, router.stats,
                    json.loads(payload)["version"] == replicas[1].applied_version - 1)
        finally:
            if router is not None:
                router.stop()
            for r in replicas:
                r.stop()
            pub.stop()
            server.stop()

    ref, port = both(run)
    assert port == ref
    seen = port[0]
    assert seen[0] == [("replica-0", True, True, 0), ("replica-1", True, True, 0)]
    assert seen[1][0] == ("replica-0", True, False, 1)  # lag gated
    assert port[1] == 200 and port[2] and port[3] == 503
    assert seen[-1][1] == ("replica-1", False, False, 0)
