"""The port's crash-safe placement plane against the JAX package's.

``crane_scheduler_tpu_torch.resilience.recovery`` (intent journal,
replay, reconciliation, warm standby, kill switch) and the kube mirror's
journal hooks, held to ``crane_scheduler_tpu``'s on the same inputs:

- the unit cases of ``tests/test_recovery.py``, run on both packages;
- the journal lines each package writes, directly and through the kube
  mirror's bind/eviction POSTs over the wire stub, are equal apart from
  ``ts``;
- either package replays the other's journal directory to the same
  classification;
- every ``Reconciler`` outcome and report equals the reference's;
- the kill-at-every-byte-offset sweep over the stub, through the port's
  client, gives zero duplicate and zero lost binds;
- ``WarmStandby`` reconciles before it reports ready.

Equality throughout, no tolerance. Wall-clock budgets stay out (time
belongs to ``chip_smoke.py``).
"""

import importlib.util
import json
import os
import signal
import types
from pathlib import Path

import pytest

import crane_scheduler_tpu.cluster.kube as ref_kube
import crane_scheduler_tpu.resilience.recovery as ref_rec
import crane_scheduler_tpu_torch.cluster.kube as port_kube
import crane_scheduler_tpu_torch.resilience.recovery as port_rec

REPO = Path(__file__).resolve().parents[1]
PACKAGES = {"ref": (ref_rec, ref_kube), "port": (port_rec, port_kube)}


def _load_stub():
    spec = importlib.util.spec_from_file_location("kube_stub_torch_recovery",
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


@pytest.fixture()
def stub():
    server = kube_stub.KubeStubServer().start()
    yield server
    server.stop()


def _lookup(table):
    """A reconciler lookup over ``{pod_key: node_name | None}``; missing
    keys read as deleted pods."""
    def lookup(key):
        if key not in table:
            return None
        return types.SimpleNamespace(node_name=table[key])
    return lookup


def _lines(directory) -> list[dict]:
    """Every journal record, oldest first, with ``ts`` taken out."""
    out = []
    for rec in port_rec.IntentJournal.read(str(directory)):
        rec.pop("ts", None)
        out.append(rec)
    return out


def _raw_lines(directory) -> list[bytes]:
    out = []
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            out.extend(f.read().splitlines())
    return out


def _strip_ts(raw: bytes) -> bytes:
    """A journal line's bytes with its ``,"ts":<float>`` field cut out."""
    i = raw.find(b',"ts":')
    if i < 0:
        return raw
    j = raw.index(b"}", i)
    return raw[:i] + raw[j:]


# -- the unit layer, on both packages ---------------------------------------


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_journal_roundtrip_and_resolution_kinds(pkg, tmp_path):
    rec = PACKAGES[pkg][0]
    j = rec.IntentJournal(str(tmp_path))
    i1 = j.intent("bind", "ns/p1", "node-1", trace="00-aa-bb-01")
    i2 = j.intent("bind", "ns/p2", "node-2")
    i3 = j.intent("evict", "ns/p3", "node-3")
    i4 = j.intent("bind", "ns/p4", "node-4")
    j.ack(i1)
    j.nack(i2, 409)
    j.unresolved(i3)
    replay = rec.replay_journal(str(tmp_path))
    assert set(replay.intents) == {i1, i2, i3, i4}
    assert [r["id"] for r in replay.unresolved()] == [i3, i4]
    assert replay.intents[i1]["trace"] == "00-aa-bb-01"
    assert replay.intents[i3]["op"] == "evict"


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_journal_ids_continue_across_reopen(pkg, tmp_path):
    rec = PACKAGES[pkg][0]
    j1 = rec.IntentJournal(str(tmp_path))
    last = [j1.intent("bind", f"ns/p{i}", "n") for i in range(5)][-1]
    j1.close()
    assert rec.IntentJournal(str(tmp_path)).intent("bind", "ns/q", "n") > last


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_journal_rotation_keeps_ring_bounded(pkg, tmp_path):
    rec = PACKAGES[pkg][0]
    j = rec.IntentJournal(str(tmp_path), max_segment_bytes=512, max_segments=3)
    for i in range(200):
        j.intent("bind", f"ns/p{i:04d}", "node-x")
    assert len([n for n in os.listdir(tmp_path) if n.startswith("intent-")]) <= 3
    pods = [r["pod"] for r in rec.IntentJournal.read(str(tmp_path)) if r.get("t") == "intent"]
    assert "ns/p0199" in pods


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_torn_final_line_is_skipped(pkg, tmp_path):
    rec = PACKAGES[pkg][0]
    j = rec.IntentJournal(str(tmp_path))
    ids = [j.intent("bind", f"ns/p{i}", "node-1") for i in range(3)]
    j.ack(ids[0])
    with open(tmp_path / "intent-000001.jsonl", "a") as f:
        f.write('{"v":1,"t":"intent","id":99,"pod":"ns/to')
    replay = rec.replay_journal(str(tmp_path))
    assert set(replay.intents) == set(ids)
    assert [r["id"] for r in replay.unresolved()] == ids[1:]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_orphans_and_newer_schema_are_counted(pkg, tmp_path):
    rec = PACKAGES[pkg][0]
    j = rec.IntentJournal(str(tmp_path))
    j.ack(777)  # the intent line rotated away
    j.intent("bind", "ns/old", "node-1")
    with open(tmp_path / "intent-000001.jsonl", "a") as f:
        f.write(json.dumps({"v": 99, "t": "intent", "id": 500, "op": "bind",
                            "pod": "ns/future", "node": "node-9"}) + "\n")
    replay = rec.replay_journal(str(tmp_path))
    assert replay.orphan_resolutions == 1 and replay.skipped_newer_schema == 1
    assert [r["pod"] for r in replay.unresolved()] == ["ns/old"]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_tombstones_resolve_bind_and_evict_intents(pkg, tmp_path):
    rec = PACKAGES[pkg][0]
    j = rec.IntentJournal(str(tmp_path))
    j.intent("bind", "ns/p0", "node-1")
    j.intent("evict", "ns/v0", "node-2")
    assert j.tombstone_batch([("ns/p0", "node-1"), ("ns/other", "node-3")]) == 1
    j.tombstone_deleted("ns/v0")
    j.tombstone_deleted("ns/v0")  # a second DELETED finds nothing open
    assert rec.replay_journal(str(tmp_path)).unresolved() == []
    assert [r["t"] for r in _lines(tmp_path)] == ["intent", "intent", "tombstone", "tombstone"]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_fsync_mode_fsyncs_every_line(pkg, tmp_path, monkeypatch):
    rec = PACKAGES[pkg][0]
    calls = []
    monkeypatch.setattr(rec.os, "fsync", lambda fd: calls.append(fd))
    j = rec.IntentJournal(str(tmp_path), fsync=True)
    iid = j.intent("bind", "ns/p", "n")
    j.ack(iid)
    assert len(calls) == 2


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_kill_switch_cuts_mid_line_and_fires(pkg, tmp_path):
    rec = PACKAGES[pkg][0]
    fired = []
    j = rec.IntentJournal(str(tmp_path))
    j.kill_switch = rec.KillSwitch(at_bytes=40, action=lambda: fired.append(1))
    j.intent("bind", "ns/a-pod-with-a-long-key", "node-1")
    assert fired == [1]
    assert os.path.getsize(tmp_path / "intent-000001.jsonl") == 40
    j.intent("bind", "ns/p1", "node-1")  # a dead process writes nothing
    assert j.bytes_written == 40
    assert rec.replay_journal(str(tmp_path)).intents == {}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_kill_switch_raising_simulated_crash_propagates(pkg, tmp_path):
    rec = PACKAGES[pkg][0]
    j = rec.IntentJournal(str(tmp_path))

    def die():
        raise rec.SimulatedCrash("killed at offset")

    j.intent("bind", "ns/p0", "node-1")
    j.kill_switch = rec.KillSwitch(at_bytes=j.bytes_written + 10, action=die)
    with pytest.raises(rec.SimulatedCrash):
        j.intent("bind", "ns/p1", "node-2")
    assert [r["pod"] for r in rec.replay_journal(str(tmp_path)).unresolved()] == ["ns/p0"]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_kill_switch_every_offset_leaves_parseable_prefix(pkg, tmp_path):
    rec = PACKAGES[pkg][0]
    probe = rec.IntentJournal(str(tmp_path / "probe"))
    for i in range(4):
        probe.intent("bind", f"ns/p{i}", f"node-{i}")
    for off in range(1, probe.bytes_written + 2):
        d = str(tmp_path / f"k{off}")
        j = rec.IntentJournal(d)
        j.kill_switch = rec.KillSwitch(at_bytes=off, action=lambda: None)
        for i in range(4):
            j.intent("bind", f"ns/p{i}", f"node-{i}")
        j.close()
        pods = [r["pod"] for r in rec.replay_journal(d).unresolved()]
        assert pods == [f"ns/p{i}" for i in range(len(pods))]


def test_journal_lines_equal_reference(tmp_path):
    """The same calls on both journals write the same bytes apart from
    ``ts``, in the same segments, with the same ids and windows."""
    def drive(rec, d):
        j = rec.IntentJournal(str(d), max_segment_bytes=600, max_segments=4)
        w = j.begin_window()
        ids = [j.intent("bind", f"ns/p{i}", f"node-{i % 3}", trace="00-ab-cd-01" if i % 2 else None,
                        window=w) for i in range(6)]
        j.ack(ids[0])
        j.nack(ids[1], 409)
        j.unresolved(ids[2])
        e = j.intent("evict", "ns/v", "node-9")
        j.tombstone_batch([("ns/p3", "node-0"), ("ns/p9", "node-0")])
        j.tombstone_deleted("ns/v")
        j.resolved(ids[4], "pod_gone")
        j.resolved(e, "evicted")
        j.close()
        return sorted(os.listdir(d)), [_strip_ts(x) for x in _raw_lines(d)]

    ref = drive(ref_rec, tmp_path / "ref")
    port = drive(port_rec, tmp_path / "port")
    assert port == ref and len(ref[0]) > 1


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_replay_either_way_between_packages(direction, tmp_path):
    """One package writes, the other replays and reconciles: the same
    classification and report as the writer's own."""
    writer, reader = (ref_rec, port_rec) if direction == "ref_to_port" else (port_rec, ref_rec)
    j = writer.IntentJournal(str(tmp_path))
    for i in range(8):
        iid = j.intent("bind" if i % 3 else "evict", f"ns/p{i}", f"node-{i}")
        if i % 4 == 0:
            j.ack(iid)
    j.close()
    a, b = writer.replay_journal(str(tmp_path)), reader.replay_journal(str(tmp_path))
    assert (a.intents, a.resolved_ids, a.records_replayed) == \
        (b.intents, b.resolved_ids, b.records_replayed)
    table = {"ns/p1": None, "ns/p2": "node-2", "ns/p3": "node-0", "ns/p6": "node-6"}
    report = reader.Reconciler(reader.IntentJournal(str(tmp_path)), _lookup(table)).reconcile()
    again = writer.replay_journal(str(tmp_path))
    assert again.unresolved() == [] and report.total() == 6


def test_reconciler_outcomes_equal_reference(tmp_path):
    """Every outcome (bound as intended, elsewhere, unbound, pod gone,
    evicted, eviction unapplied) on one journal, through both packages'
    reconcilers: the same reports and the same resolved lines."""
    def drive(rec, d):
        j = rec.IntentJournal(str(d))
        j.intent("bind", "ns/as-intended", "node-1", trace="00-t1-s1-01")
        j.intent("bind", "ns/elsewhere", "node-1")
        j.intent("bind", "ns/unbound", "node-2", trace="00-t2-s2-01")
        j.intent("bind", "ns/gone", "node-3")
        j.ack(j.intent("bind", "ns/acked", "node-4"))
        j.intent("evict", "ns/evicted", "node-5")
        j.intent("evict", "ns/alive", None)
        report = rec.Reconciler(j, _lookup({
            "ns/as-intended": "node-1", "ns/elsewhere": "node-7",
            "ns/unbound": None, "ns/alive": "node-6"})).reconcile()
        second = rec.Reconciler(j, _lookup({})).reconcile()
        out = report.as_dict()
        out.pop("elapsed_s")
        return out, second.total(), _lines(d)

    ref = drive(ref_rec, tmp_path / "ref")
    port = drive(port_rec, tmp_path / "port")
    assert port == ref
    assert ref[0]["outcomes"] == {
        "bound_as_intended": 1, "bound_elsewhere": 1, "unbound_reschedulable": 1,
        "pod_gone": 1, "evicted": 1, "evict_unapplied": 1}
    assert ref[0]["reschedule"] == [["ns/unbound", "node-2", "t2", 1]]
    assert ref[0]["rearm_cooldowns"] == ["node-6"] and ref[1] == 0


def test_reconcile_rearms_lifecycle_trace_attempt(tmp_path):
    from crane_scheduler_tpu_torch.telemetry.lifecycle import PodLifecycleTracker

    tracker = PodLifecycleTracker()
    j = port_rec.IntentJournal(str(tmp_path))
    j.intent("bind", "ns/lost", "node-1", trace="00-deadbeefdeadbeef-aaaa-01")
    port_rec.Reconciler(j, _lookup({"ns/lost": None}), lifecycle=tracker).reconcile()
    assert tracker.seen("ns/lost").trace_id == "deadbeefdeadbeef"
    assert tracker._live["ns/lost"]["attempt"] == 2


def test_reconcile_metrics_families(tmp_path):
    from crane_scheduler_tpu_torch.telemetry import Telemetry

    tel = Telemetry()
    j = port_rec.IntentJournal(str(tmp_path), telemetry=tel)
    j.intent("bind", "ns/p0", "node-1")
    port_rec.Reconciler(j, _lookup({}), telemetry=tel).reconcile()
    text = tel.render_prometheus()
    assert "crane_recovery_intents_replayed" in text
    assert 'crane_recovery_reconciled_total{outcome="pod_gone"} 1' in text
    assert "crane_recovery_journal_bytes" in text


# -- the kube mirror's journal hooks, over the wire stub ----------------------


def _seed_nodes(stub, n=4):
    for i in range(n):
        stub.state.add_node(f"node-{i}", f"10.0.0.{i}")


@pytest.mark.parametrize("n_pods", [6, 80])
def test_mirror_journal_lines_equal_reference(n_pods, tmp_path):
    """``bind_pods`` (pooled below 64 POSTs, pipelined from 64), then
    ``bind_pod`` and ``evict_pod``, against two identically seeded stubs,
    one client per package with a journal attached: the journal lines are
    equal apart from ``ts``, every intent of a batch precedes its outcomes,
    and the stubs saw the same POSTs. A refused bind journals a ``nack``."""
    out = []
    for name, (rec, kube) in sorted(PACKAGES.items()):
        server = kube_stub.KubeStubServer().start()
        try:
            _seed_nodes(server)
            for i in range(n_pods):
                server.state.add_pod("t", f"p{i:03d}")
            server.state.add_pod("t", "victim", spec={"nodeName": "node-0"})
            jdir = tmp_path / name
            journal = rec.IntentJournal(str(jdir))
            client = kube.KubeClusterClient(server.url)
            client._native_flush_disabled = True  # the port's one route
            client.attach_intent_journal(journal)
            pairs = [(f"t/p{i:03d}", f"node-{i % 4}") for i in range(n_pods)]
            pairs.append(("t/missing", "node-1"))  # the stub answers 404
            bound = client.bind_pods(pairs)
            single = client.bind_pod("t/p000", "node-3")
            evicted = client.evict_pod("t/victim")
            client.stop()
            journal.close()
            with server.state.lock:
                posts = (dict(server.state.bind_posts), dict(server.state.evict_posts))
            out.append((bound, single, evicted, [_strip_ts(x) for x in _raw_lines(jdir)],
                        posts))
        finally:
            server.stop()
    ref, port = out
    assert port == ref
    kinds = [json.loads(x)["t"] for x in ref[3]]
    assert kinds[: n_pods + 1] == ["intent"] * (n_pods + 1)
    assert kinds.count("ack") == n_pods + 2 and kinds.count("nack") == 1  # the 404


def test_attached_journal_precedes_the_posts(stub, tmp_path):
    """The intent line is on disk before the POST reaches the stub: the
    stub's handler reads the journal when the binding arrives."""
    _seed_nodes(stub)
    stub.state.add_pod("t", "p0")
    journal = port_rec.IntentJournal(str(tmp_path))
    seen = []
    orig = stub.state.bind_posts.__class__

    class Spy(orig):
        def __setitem__(self, key, value):
            seen.append([r["t"] for r in port_rec.IntentJournal.read(str(tmp_path))])
            super().__setitem__(key, value)

    stub.state.bind_posts = Spy(stub.state.bind_posts)
    client = port_kube.KubeClusterClient(stub.url)
    client.attach_intent_journal(journal)
    assert client.bind_pods([("t/p0", "node-1")]) == ["t/p0"]
    client.stop()
    journal.close()
    assert seen == [["intent"]]
    assert [r["t"] for r in _lines(tmp_path)] == ["intent", "ack"]


def _die():
    raise port_rec.SimulatedCrash("SIGKILL at journal offset")


def _crash_bind_recover(stub, jdir, ns, offset):
    """One life binds a batch with a kill switch armed at ``offset``
    journal bytes; a second life reconciles and binds whatever provably
    needs it. Returns the (key, node) pairs attempted."""
    n = 6
    for i in range(n):
        stub.state.add_pod(ns, f"p{i}")
    pairs = [(f"{ns}/p{i}", f"node-{i % 4}") for i in range(n)]
    journal = port_rec.IntentJournal(str(jdir))
    if offset is not None:
        journal.kill_switch = port_rec.KillSwitch(offset, action=_die)
    client = port_kube.KubeClusterClient(stub.url)
    client.attach_intent_journal(journal)
    try:
        client.bind_pods(pairs)
    except port_rec.SimulatedCrash:
        pass  # the first life ends here, at exactly `offset` bytes
    client.stop()
    journal.close()

    journal2 = port_rec.IntentJournal(str(jdir))
    client2 = port_kube.KubeClusterClient(stub.url)
    client2.attach_intent_journal(journal2)
    report = port_rec.Reconciler(journal2, client2.get_pod_live).reconcile()
    redo = {key: node for key, node, _t, _a in report.reschedule}
    if redo:
        client2.bind_pods(list(redo.items()))
    pending = [(key, node) for key, node in pairs
               if key not in redo and not client2.get_pod_live(key).node_name]
    if pending:
        client2.bind_pods(pending)
    client2.stop()
    journal2.close()
    return pairs


def test_kill_at_any_byte_offset_zero_dup_zero_lost(stub, tmp_path):
    """The kill offset swept across the whole journal stream, through the
    port's client: the intent phase (nothing on the wire) and the outcome
    phase (POSTs landed, acks lost). Every pod is bound exactly once, to
    its intended node."""
    _seed_nodes(stub)
    pairs = _crash_bind_recover(stub, tmp_path / "warm", "warm", None)
    probe = os.path.getsize(tmp_path / "warm" / "intent-000001.jsonl")
    assert probe > 0
    for key, _node in pairs:
        assert stub.state.bind_posts.get(key, 0) == 1
    for off in range(1, probe + 40, 37):
        ns = f"k{off}"
        for key, node in _crash_bind_recover(stub, tmp_path / ns, ns, off):
            assert stub.state.bind_posts.get(key, 0) == 1, (off, key)
            assert stub.state.pods[key]["spec"].get("nodeName") == node, (off, key)
    assert stub.state.duplicate_binds() == 0


def test_outcome_phase_crash_classifies_bound_as_intended(stub, tmp_path):
    _seed_nodes(stub)
    for i in range(4):
        stub.state.add_pod("t", f"p{i}")
    pairs = [(f"t/p{i}", f"node-{i}") for i in range(4)]
    probe = port_rec.IntentJournal(str(tmp_path / "probe"))
    for key, node in pairs:
        probe.intent("bind", key, node)
    journal = port_rec.IntentJournal(str(tmp_path / "j"))
    journal.kill_switch = port_rec.KillSwitch(probe.bytes_written + 10, action=_die)
    client = port_kube.KubeClusterClient(stub.url)
    client.attach_intent_journal(journal)
    with pytest.raises(port_rec.SimulatedCrash):
        client.bind_pods(pairs)
    client.stop()
    journal.close()
    assert sum(stub.state.bind_posts.values()) == 4
    client2 = port_kube.KubeClusterClient(stub.url)
    report = port_rec.Reconciler(port_rec.IntentJournal(str(tmp_path / "j")),
                                 client2.get_pod_live).reconcile()
    client2.stop()
    assert report.outcomes.get("bound_as_intended", 0) >= 3 and report.reschedule == []
    assert sum(stub.state.bind_posts.values()) == 4 and stub.state.duplicate_binds() == 0


def test_watch_confirm_tombstones_bind_intent(stub, tmp_path):
    import time

    _seed_nodes(stub)
    stub.state.add_pod("t", "p0")
    journal = port_rec.IntentJournal(str(tmp_path))
    client = port_kube.KubeClusterClient(stub.url)
    client.attach_intent_journal(journal)
    client.start()
    try:
        assert client.bind_pods([("t/p0", "node-1")]) == ["t/p0"]
        deadline = time.monotonic() + 5.0
        while not any(r.get("t") == "tombstone" for r in port_rec.IntentJournal.read(str(tmp_path))):
            assert time.monotonic() < deadline, "the watch echo never tombstoned the intent"
            time.sleep(0.05)
    finally:
        client.stop()
        journal.close()
    assert port_rec.replay_journal(str(tmp_path)).unresolved() == []


def test_indeterminate_eviction_never_reposts(stub, tmp_path):
    """An eviction whose response is lost journals ``unresolved``; the
    reconciler finds the pod alive, re-arms its node's cooldown and never
    POSTs a second eviction."""
    _seed_nodes(stub)
    stub.state.add_pod("t", "victim", spec={"nodeName": "node-0"})
    stub.state.inject_write_faults((0, {}))
    journal = port_rec.IntentJournal(str(tmp_path))
    client = port_kube.KubeClusterClient(stub.url)
    client.attach_intent_journal(journal)
    assert client.evict_pod("t/victim") is False
    client.stop()
    journal.close()
    assert sum(stub.state.evict_posts.values()) == 0
    assert [r["t"] for r in _lines(tmp_path)] == ["intent", "unresolved"]
    client2 = port_kube.KubeClusterClient(stub.url)
    report = port_rec.Reconciler(port_rec.IntentJournal(str(tmp_path)),
                                 client2.get_pod_live).reconcile()
    client2.stop()
    assert report.outcomes == {"evict_unapplied": 1} and report.rearm_cooldowns == ["node-0"]
    assert sum(stub.state.evict_posts.values()) == 0 and stub.state.duplicate_evictions() == 0


def test_eviction_landed_but_ack_lost_reconciles_to_evicted(stub, tmp_path):
    _seed_nodes(stub)
    stub.state.add_pod("t", "v2", spec={"nodeName": "node-0"})
    client = port_kube.KubeClusterClient(stub.url)
    assert client.evict_pod("t/v2") is True
    client.stop()
    journal = port_rec.IntentJournal(str(tmp_path))
    journal.intent("evict", "t/v2", "node-0")
    client2 = port_kube.KubeClusterClient(stub.url)
    report = port_rec.Reconciler(journal, client2.get_pod_live).reconcile()
    client2.stop()
    assert report.outcomes == {"evicted": 1} and report.rearm_cooldowns == []
    assert sum(stub.state.evict_posts.values()) == 1


def test_cooldown_rearm_blocks_next_sweep():
    from crane_scheduler_tpu_torch.cluster import ClusterState, Node
    from crane_scheduler_tpu_torch.descheduler import (
        DeschedulerConfig,
        LoadAwareDescheduler,
        WatermarkPolicy,
    )
    from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY

    cluster = ClusterState()
    cluster.add_node(Node(name="node-0"))
    d = LoadAwareDescheduler(cluster, DEFAULT_POLICY, DeschedulerConfig(
        watermarks=(WatermarkPolicy("cpu_usage_avg_5m", 0.5, 0.7),),
        node_cooldown_seconds=300.0))
    d.rearm_cooldown("node-0", now=1000.0)
    assert d._last_evict["node-0"] == 1000.0


# -- warm standby --------------------------------------------------------------


def test_warm_standby_reconciles_before_ready(tmp_path):
    """A leads, B holds warm standby on the same lock; when A releases, B
    reconciles the shared journal directory before it flips ready, and
    ``on_promote`` runs before ``wait_ready`` returns."""
    lock = str(tmp_path / "leader.lock")
    jdir = str(tmp_path / "intents")
    j = port_rec.IntentJournal(jdir)
    j.intent("bind", "ns/orphan", "node-1")
    j.close()
    lookup = _lookup({"ns/orphan": None})
    fast = dict(lease_duration=1.0, renew_deadline=0.6, retry_period=0.1)
    a = port_rec.WarmStandby(lock, "sched-a", jdir, lookup, **fast).start()
    assert a.wait_ready(5.0)
    assert a.report.outcomes == {"unbound_reschedulable": 1}
    promoted = []
    b = port_rec.WarmStandby(lock, "sched-b", jdir, lookup,
                             on_promote=lambda rep: promoted.append(
                                 port_rec.replay_journal(jdir).unresolved()), **fast).start()
    assert not b.wait_ready(0.5)  # standby while A holds the lock
    a.stop()
    assert b.wait_ready(5.0), "standby never took over"
    assert promoted == [[]]  # reconciled before promotion
    assert b.report.total() == 0 and b.failover_seconds is not None
    assert b.journal is not None
    b.stop()
