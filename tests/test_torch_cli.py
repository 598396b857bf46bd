"""The port's crane-scheduler and crane-descheduler against the JAX
package's.

crane-scheduler runs in-process in both packages (its sim mode installs
no signal handler); its result line must equal the reference's, apart
from ``wall_seconds``, and so must every (pod, node) placement of the
simulation it built: batch mode, plugin mode, and the NUMA
profile in plugin mode, at 32-64 demo nodes. crane-descheduler installs
SIGTERM/SIGINT handlers, so it runs as a subprocess of each package; its
stats line must have the reference's keys and the same ``evictions`` and
``hot_streaks`` (``cycles`` depends on timing). Demo nodes carry no
annotations, so that run suspends every cycle; the mapping from its flags
to the ``DeschedulerConfig`` is held to the reference's in-process, up to
the descheduler's construction. The flags of the kube
mirror run against the wire stub (``tests/kube_stub.py``): crane-scheduler
``--master`` in-process (result line and the stub's bindings),
crane-annotator and crane-scorer as subprocesses (annotation strings,
``/v1/score`` bytes); the control plane and the shard plane on the mirror
as subprocesses of each package over identically seeded stubs
(crane-scheduler one-shot ``--journal-dir`` with an orphan bind intent,
``--serve``, ``--shards 2`` with and without ``--shard-ring``, and
crane-descheduler ``--master`` with its two-life indeterminate eviction),
result lines equal apart from ``wall_seconds`` and the stub's URL; the
reference's drip window imports only with the ``enable_x64`` shim, which
its subprocess sets in a ``-c`` wrapper. The multi-GPU flags:
``--placement-mesh`` under ``--master`` (one tile equals the reference;
more tiles than the host has devices fail with the reference's error),
crane-sim ``--mode sharded`` and crane-scorer's three distributed flags
(the ``/v1/score`` body equals the non-distributed run's). The config
loaders give
the reference's configuration from every committed deploy document
(PyYAML is on the card, so they read YAML there too).
Equality throughout.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from crane_scheduler_tpu import sim as ref_sim
from crane_scheduler_tpu.cli import scheduler_main as ref_scheduler_main
from crane_scheduler_tpu.config.scheme import (
    load_scheduler_config_from_file as ref_load_config,
)
from crane_scheduler_tpu.policy import load_policy_from_file as ref_load_policy
from crane_scheduler_tpu.sim import SimConfig as RefSimConfig
from crane_scheduler_tpu.sim import Simulator as RefSimulator
from crane_scheduler_tpu_torch import sim as port_sim
from crane_scheduler_tpu_torch.cli import descheduler_main, scheduler_main
from crane_scheduler_tpu_torch.config.scheme import load_scheduler_config_from_file
from crane_scheduler_tpu_torch.policy import load_policy_from_file
from crane_scheduler_tpu_torch.sim import SimConfig, Simulator

REPO = Path(__file__).resolve().parents[1]
NUMA_CONFIG = "deploy/noderesourcetopology/scheduler-config.yaml"


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        raise TimeoutError("test case exceeded its 120 s limit")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


@pytest.fixture(autouse=True)
def _repo_cwd(monkeypatch):
    """The default --config and the policy path inside it are relative to
    the repo root, as for an operator running from a checkout."""
    monkeypatch.chdir(REPO)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _result_line(main, argv, capsys) -> dict:
    assert main(argv) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    out = json.loads(lines[-1])
    assert out.pop("wall_seconds") >= 0
    return out


SCHEDULER_CASES = {
    "batch": ["--demo-nodes", "48", "--pods", "300", "--batch-size", "128", "--seed", "3"],
    "batch_one_burst": ["--demo-nodes", "32", "--pods", "20", "--batch-size", "64"],
    "plugin": ["--demo-nodes", "64", "--pods", "40", "--seed", "5"],
    "plugin_tie_seed": ["--demo-nodes", "32", "--pods", "24", "--tie-break-seed", "7"],
    "numa_plugin": ["--config", NUMA_CONFIG, "--demo-nodes", "32", "--pods", "16"],
}


def _run_and_placements(sim_module, main, argv, capsys, monkeypatch):
    """``main``'s result line, and the sorted (pod, node) placements of the
    simulation it built (``sim_module.Simulator`` wrapped to keep it)."""
    built = []

    class Recorded(sim_module.Simulator):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    with monkeypatch.context() as patch:
        patch.setattr(sim_module, "Simulator", Recorded)
        line = _result_line(main, argv, capsys)
    (sim,) = built
    return line, sorted((p.key(), p.node_name) for p in sim.cluster.list_pods() if p.node_name)


@pytest.mark.parametrize("case", sorted(SCHEDULER_CASES))
def test_crane_scheduler_result_line_equals_reference(case, capsys, monkeypatch):
    """The result line and every (pod, node) placement equal the
    reference's: equal counts alone could hide a different placement."""
    argv = SCHEDULER_CASES[case]
    ref, ref_placed = _run_and_placements(ref_sim, ref_scheduler_main.main, argv, capsys,
                                          monkeypatch)
    port, placed = _run_and_placements(port_sim, scheduler_main.main, [*argv, "--device", "cpu"],
                                       capsys, monkeypatch)
    assert port == ref
    assert placed == ref_placed
    assert len(placed) == ref["scheduled"]
    assert ref["scheduled"] + ref["unschedulable"] == int(argv[argv.index("--pods") + 1])
    if case.startswith("batch"):
        assert ref["distinct_nodes_used"] > 1


def test_crane_scheduler_master_only_flags_do_nothing_in_sim_mode(capsys):
    argv = ["--demo-nodes", "32", "--pods", "20", "--device", "cpu"]
    plain = _result_line(scheduler_main.main, argv, capsys)
    flagged = _result_line(scheduler_main.main, [
        *argv, "--serve", "--journal-dir", "/nonexistent", "--lock-file", "/nonexistent/l",
        "--window", "8", "--bind-watermark-pods", "4", "--run-seconds", "9",
        "--placement-mesh", "2", "--shards", "2", "--shard-index", "1",
        "--shard-overlap", "0.5", "--shard-ring", "/nonexistent/ring.json"], capsys)
    assert flagged == plain


@pytest.mark.parametrize("flags", [
    ["--master", "https://apiserver:6443"],
    ["--token-file", "/dev/null"],
    ["--concurrent-syncs", "4"],
])
def test_crane_scheduler_refuses_kube_mirror_flags(flags, capsys):
    """Every flag of the kube mirror and its planes runs now, with
    ``--placement-mesh 1`` too (the last multi-GPU refusal is gone): a
    one-shot plugin pass over two identically seeded stubs, in-process,
    the port's drip window on a one-tile placement mesh of the CPU and the
    reference's on its first virtual device. Result lines and bindings
    equal."""
    import time as _time

    now = _time.time()
    out = []
    for main, extra in ((ref_scheduler_main.main, []),
                        (scheduler_main.main, ["--device", "cpu"])):
        server = _master_stub(now)
        try:
            line = _result_line(main, [*flags, "--master", server.url, "--placement-mesh", "1",
                                       "--pods", "12", *extra], capsys)
            assert line.pop("master") == server.url
            out.append((line, _bindings(server.state)))
        finally:
            server.stop()
    assert out[1] == out[0] and out[0][0]["scheduled"] > 0


def test_crane_scheduler_placement_mesh_above_device_count_fails_like_reference():
    """``--placement-mesh 2`` on a host with one device (the reference's CPU
    platform, the port's ``--device cpu``): both processes fail with the
    reference's device-count error once the mirror is up."""
    import time as _time

    errs = []
    for pkg in ("ref", "port"):
        server = _master_stub(_time.time())
        try:
            proc = _scheduler_proc(pkg, ["--master", server.url, "--placement-mesh", "2"])
            _out, err = proc.communicate(timeout=120)
        finally:
            server.stop()
        assert proc.returncode == 1, err[-1500:]
        errs.append(err.strip().splitlines()[-1])
    assert errs[0] == errs[1] == "ValueError: requested 2 devices, only 1 available"


@pytest.mark.parametrize("devices", ["1", "0"])
def test_crane_sim_sharded_mode_equals_reference(devices, capsys):
    """crane-sim ``--mode sharded`` in both packages, in-process: the
    reference on its first virtual device (``--devices 1``; ``0`` means
    all, so the port's one CPU device against the reference's eight),
    the result lines equal apart from the latencies and the port's device
    and launch keys."""
    from crane_scheduler_tpu.cli import sim_main as ref_sim_main
    from crane_scheduler_tpu_torch.cli import sim_main

    def line(main, args):
        assert main(args) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    argv = ["--nodes", "48", "--pods", "96", "--mode", "sharded", "--devices", devices]
    want = line(ref_sim_main.main, argv)
    got = line(sim_main.main, [*argv, "--device", "cpu"])
    for line in (want, got):
        line.pop("latency_ms")
    assert got.pop("device") == "cpu" and got.pop("kernel_launches")
    assert got == want and got["scheduled"] == 96


def test_crane_scorer_distributed_flags_serve_the_same_body(tmp_path):
    """crane-scorer ``--coordinator-address`` / ``--num-processes`` /
    ``--process-id`` (a one-process gloo group on the CPU): the process
    line, then one ``/v1/score`` whose body is byte-equal to a
    non-distributed run's (apart from the staleness, which is each
    process's own refresh time)."""
    import http.client
    import socket
    import time as _time

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    bodies, lines = [], []
    for dist in (False, True):
        port = free_port()
        argv = [sys.executable, "-m", "crane_scheduler_tpu_torch.cli.service_main",
                "--device", "cpu", "--demo-nodes", "16", "--port", str(port),
                "--run-seconds", "60", "--now-bucket", "0"]
        if dist:
            argv += ["--coordinator-address", f"127.0.0.1:{free_port()}",
                     "--num-processes", "1", "--process-id", "0"]
        proc = subprocess.Popen(argv, cwd=REPO, env=_cli_env(), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            deadline = _time.monotonic() + 60.0
            while True:
                try:
                    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
                    conn.request("POST", "/v1/score", body=b'{"now": 1753776000.0}',
                                 headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    break
                except OSError:
                    assert proc.poll() is None, proc.communicate()
                    assert _time.monotonic() < deadline, "CLI did not come up"
                    _time.sleep(0.1)
            assert resp.status == 200
            bodies.append(resp.read())
            conn.close()
        finally:
            proc.send_signal(signal.SIGTERM)
            out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err[-1500:]
        lines.append([ln for ln in out.splitlines() if ln.startswith("torch.distributed")])
    # the staleness is the request's `now` minus each process's refresh
    # time; every other byte is equal
    import re

    same = [re.sub(rb'"stalenessSeconds": [-0-9.e]+', b"", b) for b in bodies]
    assert same[0] == same[1] and b'"backend": "cpu"' in bodies[0]
    assert lines == [[], ["torch.distributed: process 0/1, 1 global devices"]]


def test_batch_mode_sweep_caches_follow_binds():
    """Batch mode's per-node sweeps read bound counts and hot values from
    caches keyed on the port's ``bound_version`` and the binding heap's
    version: after a burst, and after more binds at the same ``now``,
    they equal the reference's uncached reads, and so does every
    annotation the next sweep writes."""
    def run(sim, batch):
        sim.sync_metrics()
        batch.schedule_batch([sim.make_pod() for _ in range(40)])
        now = sim.clock.now()
        names = sim.cluster.node_names()
        trace = [[sim.annotator.hot_value(n, now) for n in names], sim._bound_counts()]
        for _ in range(6):  # crosses both hot-value divisors (5 and 2)
            pod = sim.make_pod()
            sim.cluster.add_pod(pod)
            sim.cluster.bind_pod(pod.key(), names[0], now=now)
        trace += [[sim.annotator.hot_value(n, now) for n in names], sim._bound_counts()]
        sim.clock.advance(1.0)
        sim.sync_metrics()
        trace.append({n.name: dict(n.annotations) for n in sim.cluster.list_nodes()})
        return trace

    ref_sim = RefSimulator(RefSimConfig(n_nodes=16, seed=2))
    ref = run(ref_sim, ref_sim.build_batch_scheduler())
    sim = Simulator(SimConfig(n_nodes=16, seed=2))
    port = run(sim, sim.build_batch_scheduler(device="cpu"))
    assert port == ref
    assert ref[2][0] >= ref[0][0] + 4
    assert ref[3]["node-00000"] == ref[1].get("node-00000", 0) + 6


# -- crane-descheduler ----------------------------------------------------------


def _cli_env():
    path = os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)
    return dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")


def _start(module, argv):
    return subprocess.Popen(
        [sys.executable, "-m", module, *argv], cwd=REPO, env=_cli_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def _stats(proc, timeout=120):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


DESCHED_ARGV = ["--demo-nodes", "16", "--sync-period-seconds", "0.5", "--run-seconds", "2",
                "--health-port", "0"]


@pytest.mark.parametrize("extra", [[], ["--dry-run", "--consecutive-syncs", "1",
                                        "--journal-dir", "/nonexistent"]],
                         ids=["default", "dry_run"])
def test_crane_descheduler_stats_line_equals_reference(extra):
    procs = [_start(m, DESCHED_ARGV + extra) for m in (
        "crane_scheduler_tpu.cli.descheduler_main",
        "crane_scheduler_tpu_torch.cli.descheduler_main")]
    try:
        ref, port = (_stats(p) for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert sorted(port) == sorted(ref) == ["cycles", "evictions", "hot_streaks"]
    assert port["evictions"] == ref["evictions"] and port["hot_streaks"] == ref["hot_streaks"]
    assert port["cycles"] >= 1 and ref["cycles"] >= 1


class _Built(Exception):
    """Raised by the capturing descheduler once ``main`` has built it."""


def _descheduler_built(pkg, argv, monkeypatch, clusters=None) -> dict:
    """What ``pkg``'s crane-descheduler ``main`` hands its
    ``LoadAwareDescheduler`` for ``argv``: the config, the degraded
    interlock's fractions, the policy and the node names. The capture
    raises before the health server, the signal handlers and the loop
    start, so ``main`` runs in this thread; the process-global telemetry
    it enables is restored afterwards. With ``clusters``, the cluster is
    appended to it (a kube mirror the caller must stop)."""
    import importlib

    desched = importlib.import_module(f"{pkg}.descheduler")
    cli = importlib.import_module(f"{pkg}.cli.descheduler_main")
    telemetry = importlib.import_module(f"{pkg}.telemetry")
    seen = {}

    def capture(cluster, policy, config, *, telemetry=None, degraded=None):
        if clusters is not None:
            clusters.append(cluster)
        seen.update(
            config=dataclasses.asdict(config), policy=dataclasses.asdict(policy),
            degraded=(degraded.enter_fraction, degraded.exit_fraction),
            nodes=[n.name for n in cluster.list_nodes()])
        raise _Built

    with monkeypatch.context() as patch:
        patch.setattr(desched, "LoadAwareDescheduler", capture)
        patch.setattr(telemetry, "_active", telemetry._active)
        with pytest.raises(_Built):
            cli.main(argv)
    return seen


DESCHED_FLAG_SETS = {
    "defaults": ["--demo-nodes", "4"],
    "watermarks": ["--demo-nodes", "3", "--cpu-target", "0.4", "--cpu-threshold", "0.6"],
    "budgets": ["--demo-nodes", "2", "--max-evictions-per-node", "3",
                "--max-evictions-per-cycle", "7", "--node-cooldown-seconds", "12.5",
                "--consecutive-syncs", "4"],
    "dry_run": ["--demo-nodes", "5", "--dry-run", "--sync-period-seconds", "2.5",
                "--degraded-enter-fraction", "0.3", "--degraded-exit-fraction", "0.1",
                "--policy-config-path", "deploy/dynamic/policy-12metrics.yaml"],
}


@pytest.mark.parametrize("case", sorted(DESCHED_FLAG_SETS))
def test_crane_descheduler_flags_build_reference_config(case, monkeypatch):
    """crane-descheduler maps its flags (the cpu and mem watermarks from
    --cpu-target/--cpu-threshold, budgets, cooldown, consecutive syncs,
    dry-run, sync period, degraded fractions, policy file) to the same
    ``DeschedulerConfig`` and interlock as the reference's CLI."""
    argv = DESCHED_FLAG_SETS[case]
    ref = _descheduler_built("crane_scheduler_tpu", argv, monkeypatch)
    port = _descheduler_built("crane_scheduler_tpu_torch", argv, monkeypatch)
    assert port == ref
    assert len(ref["config"]["watermarks"]) == 2 and ref["nodes"]


@pytest.mark.parametrize("flags", [
    ["--master", "https://apiserver:6443"],
    ["--token-file", "/dev/null"],
])
def test_crane_descheduler_refuses_kube_mirror_flags(flags, monkeypatch, tmp_path):
    """``--master`` (and ``--token-file``) now run the descheduler on the
    kube mirror: over a stub apiserver they build the reference's
    ``DeschedulerConfig`` and interlock, over the mirror's nodes, and the
    token reaches every request."""
    server = kube_stub.KubeStubServer().start()
    for i in range(3):
        server.state.add_node(f"node-{i}", f"10.9.0.{i}")
    argv = ["--master", server.url, "--consecutive-syncs", "2"]
    if flags[0] == "--token-file":
        token = tmp_path / "token"
        token.write_text("desched-token\n")
        argv += ["--token-file", str(token)]
    clusters = []
    try:
        ref = _descheduler_built("crane_scheduler_tpu", argv, monkeypatch, clusters)
        port = _descheduler_built("crane_scheduler_tpu_torch", argv, monkeypatch, clusters)
    finally:
        for c in clusters:
            c.stop()
        server.stop()
    assert port == ref
    assert ref["nodes"] == ["node-0", "node-1", "node-2"]
    assert ref["config"]["consecutive_syncs"] == 2
    want = "desched-token" if flags[0] == "--token-file" else None
    assert [c._token for c in clusters] == [want, want]


# -- the config loaders on the committed deploy documents -----------------------


@pytest.mark.parametrize("path", [
    "deploy/dynamic/scheduler-config.yaml",
    NUMA_CONFIG,
])
def test_scheduler_config_equals_reference(path):
    port = load_scheduler_config_from_file(path)
    ref = ref_load_config(path)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("path", [
    "deploy/dynamic/policy.yaml",
    "deploy/dynamic/policy-12metrics.yaml",
])
def test_policy_document_equals_reference(path):
    assert dataclasses.asdict(load_policy_from_file(path)) == \
        dataclasses.asdict(ref_load_policy(path))


# -- --master: the front doors on the kube mirror, over the wire stub ---------------

def _load_stub():
    import importlib.util

    spec = importlib.util.spec_from_file_location("kube_stub_torch_cli", REPO / "tests" / "kube_stub.py")
    stub = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stub)
    return stub


kube_stub = _load_stub()
MASTER_NODES = 24
MASTER_PODS = 40


def _master_stub(now, numa=False):
    """A stub apiserver with annotated nodes (fresh at ``now``),
    allocatable, and pending pods; with ``numa``, NRT CRs on half the
    nodes and guaranteed pods among the pending ones."""
    from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY
    from crane_scheduler_tpu_torch.utils import format_local_time

    server = kube_stub.KubeStubServer().start()
    st = server.state
    stamp = format_local_time(now)
    metrics = [sp.name for sp in DEFAULT_POLICY.spec.sync_period]
    for i in range(MASTER_NODES):
        st.add_node(f"node-{i:03d}", f"10.4.0.{i}",
                    annotations={m: f"{((i * 7 + j) % 10) / 10:.5f},{stamp}"
                                 for j, m in enumerate(metrics)},
                    allocatable={"cpu": "8", "memory": "32Gi", "pods": "30"})
        if numa and i % 2 == 0:
            st.add_nrt(f"node-{i:03d}", zones=[
                {"name": f"node{z}", "type": "Node",
                 "resources": {"allocatable": {"cpu": "4", "memory": "16Gi"}}}
                for z in range(2)])
    for i in range(MASTER_PODS):
        guaranteed = numa and i % 4 == 0
        res = {"requests": {"cpu": "2" if guaranteed else "500m", "memory": "1Gi"}}
        if guaranteed:
            res["limits"] = dict(res["requests"])
        st.add_pod("default", f"pend-{i:03d}",
                   spec={"containers": [{"name": "c", "resources": res}]})
    return server


def _bindings(state):
    with state.lock:
        return sorted((k, (p.get("spec") or {}).get("nodeName") or "")
                      for k, p in state.pods.items())


MASTER_CASES = {
    "batch": (["--batch-size", "16"], False),
    "plugin": ([], False),
    "batch_numa": (["--config", NUMA_CONFIG, "--batch-size", "16"], True),
    "first_pods": (["--batch-size", "8", "--pods", "20"], False),
}


@pytest.mark.parametrize("case", sorted(MASTER_CASES))
def test_crane_scheduler_master_equals_reference(case, capsys):
    """crane-scheduler ``--master`` (one shot) on two identically seeded
    stubs, in-process: the result lines equal (apart from
    ``wall_seconds`` and the stub's URL), and so do the stubs' bindings,
    with no pod bound twice."""
    import time as _time

    flags, numa = MASTER_CASES[case]
    now = _time.time()
    out = []
    for main, extra in ((ref_scheduler_main.main, []),
                        (scheduler_main.main, ["--device", "cpu"])):
        server = _master_stub(now, numa)
        try:
            line = _result_line(main, ["--master", server.url, *flags, *extra], capsys)
            assert line.pop("master") == server.url
            out.append((line, _bindings(server.state), server.state.duplicate_binds()))
        finally:
            server.stop()
    ref, port = out
    assert port == ref
    assert ref[0]["nodes"] == MASTER_NODES and ref[2] == 0
    want = 20 if case == "first_pods" else MASTER_PODS
    assert ref[0]["scheduled"] + ref[0]["unschedulable"] == want
    assert sum(1 for _, node in ref[1] if node) == ref[0]["scheduled"] > 0


def _annotations(state):
    with state.lock:
        return {n: dict(o["metadata"]["annotations"]) for n, o in state.nodes.items()}


def test_crane_annotator_master_equals_reference():
    """crane-annotator ``--master --leader-elect`` as a subprocess of each
    package, each on its own stub: it takes the apiserver Lease, syncs
    every node through merge-patches, and writes the reference's
    annotation strings (the timestamp is the wall clock of each run, so
    it is compared as a parseable stamp)."""
    from crane_scheduler_tpu_torch.utils import parse_local_time

    servers = [kube_stub.KubeStubServer().start() for _ in range(2)]
    for server in servers:
        for i in range(8):
            server.state.add_node(f"node-{i}", f"10.3.0.{i}")
    procs = [_start(module, ["--master", server.url, "--leader-elect", "--run-seconds", "3",
                             "--health-port", "0", *extra])
             for server, (module, extra) in zip(servers, (
                 ("crane_scheduler_tpu.cli.annotator_main", []),
                 ("crane_scheduler_tpu_torch.cli.annotator_main", ["--device", "cpu"])))]
    try:
        stats = [_stats(p) for p in procs]
        written = []
        for server in servers:
            annos = _annotations(server.state)
            for node in annos.values():
                for k, v in list(node.items()):
                    value, stamp = v.split(",")
                    assert parse_local_time(stamp) is not None
                    node[k] = value
            with server.state.lock:
                lease = server.state.leases["crane-system/crane-scheduler-tpu-annotator"]
            written.append((annos, lease["spec"]["holderIdentity"].startswith("crane-annotator-")))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        for server in servers:
            server.stop()
    ref, port = written
    assert port == ref and ref[1]
    from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY

    metrics = {sp.name for sp in DEFAULT_POLICY.spec.sync_period}
    assert all(metrics <= set(a) for a in ref[0].values())  # every metric, every node
    assert stats[0]["synced"] > 0 and stats[1]["synced"] > 0 and stats[1]["device"] == "cpu"


def test_crane_scorer_master_equals_reference():
    """crane-scorer ``--master --f32`` as a subprocess of each package on
    one stub: ``POST /v1/score`` at an explicit ``now`` answers the same
    bytes (the reference says ``"backend": "tpu"`` where the port names
    its device; ``stalenessSeconds``, the age of each process's refresh,
    is taken out)."""
    import http.client
    import socket
    import time as _time

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    now = _time.time()
    server = _master_stub(now)
    ports = [free_port(), free_port()]
    procs = [_start(module, ["--master", server.url, "--f32", "--port", str(port),
                             "--now-bucket", "0", "--run-seconds", "90", *extra])
             for port, (module, extra) in zip(ports, (
                 ("crane_scheduler_tpu.cli.service_main", []),
                 ("crane_scheduler_tpu_torch.cli.service_main", ["--device", "cpu"])))]
    bodies = []
    try:
        for proc, port in zip(procs, ports):
            deadline = _time.monotonic() + 90.0
            while True:
                try:
                    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
                    conn.request("GET", "/healthz")
                    conn.getresponse().read()
                    break
                except OSError:
                    assert proc.poll() is None, proc.communicate()
                    assert _time.monotonic() < deadline, "CLI did not come up"
                    _time.sleep(0.1)
            conn.request("POST", "/v1/score", body=json.dumps({"now": now + 5.0}).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            bodies.append(resp.read())
            conn.close()
    finally:
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
        outs = [proc.communicate(timeout=60) for proc in procs]
        server.stop()
    assert all(proc.returncode == 0 for proc in procs), [o[1][-400:] for o in outs]
    # stalenessSeconds is each process's own age of its refresh
    import re

    ref, port = (re.sub(rb'"stalenessSeconds": [0-9.e-]+, ', b"", b) for b in bodies)
    assert port == ref.replace(b'"backend": "tpu"', b'"backend": "cpu"')
    assert len(json.loads(port)["scores"]) == MASTER_NODES
    assert "kube mirror: 24 nodes" in outs[1][0]


# -- the control plane and the shard plane on the mirror ----------------------------

# the reference's drip window imports ``jax.experimental.enable_x64``; its
# CLI runs under this shim, in its own process only
_REF_SCHEDULER = (
    "import jax, jax.experimental as e; e.enable_x64 = jax.enable_x64; "
    "import runpy, sys; sys.argv[0] = 'crane-scheduler'; "
    "runpy.run_module('crane_scheduler_tpu.cli.scheduler_main', run_name='__main__')"
)


def _scheduler_proc(pkg, argv):
    if pkg == "ref":
        cmd = [sys.executable, "-c", _REF_SCHEDULER, *argv]
        env = dict(_cli_env(), JAX_ENABLE_X64="1")
    else:
        cmd = [sys.executable, "-m", "crane_scheduler_tpu_torch.cli.scheduler_main",
               "--device", "cpu", *argv]
        env = _cli_env()
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _line(out: str) -> dict:
    """A CLI's last JSON line, without the fields that differ between two
    runs of one package (the wall clock, the stub's URL, the reconcile
    time)."""
    line = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
    assert line.pop("wall_seconds", 0) >= 0
    line.pop("master", None)
    if "recovery" in line:
        assert line["recovery"].pop("elapsed_s") >= 0
    return line


def _journal(jdir) -> tuple[list, list]:
    """(every record but the watch's tombstones, in order; the tombstoned
    ids), ``ts`` taken out. Tombstones are appended by the watch thread,
    so only their set is deterministic."""
    from crane_scheduler_tpu_torch.resilience.recovery import IntentJournal

    lines, tombs = [], []
    for rec in IntentJournal.read(str(jdir)):
        rec.pop("ts", None)
        if rec["t"] == "tombstone":
            tombs.append(rec["id"])
        else:
            lines.append(rec)
    return lines, sorted(tombs)


def _write_orphan(jdir, pod, node):
    """The journal a crashed scheduler left: one bind intent, no outcome."""
    os.makedirs(jdir, exist_ok=True)
    with open(os.path.join(jdir, "intent-000001.jsonl"), "w") as f:
        f.write(json.dumps({"v": 1, "t": "intent", "id": 1, "op": "bind", "pod": pod,
                            "node": node, "window": 0, "trace": None, "ts": 1.0},
                           separators=(",", ":")) + "\n")


def _wait_bound(state, n, proc, timeout=90.0):
    import time as _time

    deadline = _time.monotonic() + timeout
    while True:
        with state.lock:
            bound = sum(1 for p in state.pods.values() if (p.get("spec") or {}).get("nodeName"))
        if bound >= n:
            return
        assert proc.poll() is None, proc.communicate()
        assert _time.monotonic() < deadline, f"{bound} of {n} pods bound"
        _time.sleep(0.05)


def test_crane_scheduler_master_journal_equals_reference(tmp_path):
    """One-shot ``--master --journal-dir --batch-size 16`` as a subprocess
    of each package, each over its own identically seeded stub, with the
    orphan bind intent a crashed scheduler left for ``pend-000``: the
    reconciler finds it unbound before scheduling opens, every pending pod
    is bound exactly once, and the result lines (with the recovery
    report), the stubs' bindings and the journals equal the reference's."""
    import time as _time

    now = _time.time()
    out = []
    for pkg in ("ref", "port"):
        server = _master_stub(now)
        jdir = tmp_path / pkg
        _write_orphan(jdir, "default/pend-000", "node-001")
        try:
            proc = _scheduler_proc(pkg, ["--master", server.url, "--journal-dir", str(jdir),
                                         "--batch-size", "16"])
            stdout, stderr = proc.communicate(timeout=120)
            assert proc.returncode == 0, stderr[-2000:]
            with server.state.lock:
                posts = dict(server.state.bind_posts)
            out.append((_line(stdout), _bindings(server.state), posts, _journal(jdir)[0]))
        finally:
            server.stop()
    ref, port = out
    assert port == ref
    assert ref[0]["recovery"]["outcomes"] == {"unbound_reschedulable": 1}
    assert ref[0]["scheduled"] == MASTER_PODS and set(ref[2].values()) == {1}
    assert ref[3][-1]["t"] == "ack" and ref[3][1] == {"v": 1, "t": "resolved", "id": 1,
                                                      "outcome": "unbound_reschedulable"}


@pytest.mark.parametrize("case", ["serve", "serve_lock_file", "serve_watermark"])
def test_crane_scheduler_serve_equals_reference(case, tmp_path):
    """``--master --serve --window 8 --journal-dir`` (as a warm standby on
    ``--lock-file``, which wins the free lease and reconciles the orphan
    first; and with ``--bind-watermark-pods 2 --run-seconds 300``, which
    pauses windows on the write plane's queue) as a subprocess of each
    package: SIGTERM once every pod is bound; the result lines, bindings
    and journals equal, every pod is bound once and every intent is
    acked."""
    import time as _time

    now = _time.time()
    out = []
    for pkg in ("ref", "port"):
        server = _master_stub(now)
        jdir = tmp_path / pkg / "intents"
        _write_orphan(jdir, "default/pend-003", "node-002")
        argv = ["--master", server.url, "--serve", "--window", "8", "--journal-dir", str(jdir)]
        if case == "serve_lock_file":
            argv += ["--lock-file", str(tmp_path / pkg / "leader.lock")]
        if case == "serve_watermark":
            argv += ["--bind-watermark-pods", "2", "--run-seconds", "300"]
        try:
            proc = _scheduler_proc(pkg, argv)
            try:
                _wait_bound(server.state, MASTER_PODS, proc)
            finally:
                proc.send_signal(signal.SIGTERM)
                stdout, stderr = proc.communicate(timeout=60)
            assert proc.returncode == 0, stderr[-2000:]
            line = _line(stdout)
            if case == "serve_lock_file":
                assert line.pop("failover_seconds") >= 0
            with server.state.lock:
                posts = dict(server.state.bind_posts)
            out.append((line, _bindings(server.state), posts, _journal(jdir)))
        finally:
            server.stop()
    ref, port = out
    assert port[:3] == ref[:3] and port[3][0] == ref[3][0]
    assert ref[0]["mode"] == "serve" and ref[0]["scheduled"] == MASTER_PODS
    assert ref[0]["drained_at_exit"] == 0
    assert ref[0]["recovery"]["outcomes"] == {"unbound_reschedulable": 1}
    assert set(ref[2].values()) == {1} and len(ref[2]) == MASTER_PODS
    intents = {r["id"] for r in port[3][0] if r["t"] == "intent"}
    acked = {r["id"] for r in port[3][0] if r["t"] in ("ack", "resolved")}
    assert intents <= acked | set(port[3][1])


def _shard_check(bindings, shards):
    from crane_scheduler_tpu_torch.cluster.shards import shard_of, shard_owners

    for key, node in bindings:
        assert node, key
        assert shard_of(key, shards) in shard_owners(node, shards, 0.0), (key, node)


@pytest.mark.parametrize("case", ["oneshot", "serve_ring"])
def test_crane_scheduler_shards_equal_reference(case, tmp_path):
    """``--shards 2 --shard-index {0,1}``: two cooperating processes per
    package over one stub (one-shot in plugin mode, or ``--serve`` over a
    ``--shard-ring`` file). Each binds only the pods whose key hashes to
    its shard, onto its shard's nodes; every pod is bound once; the result
    lines and the bindings equal the reference's."""
    import time as _time

    from crane_scheduler_tpu_torch.cluster.shards import HashRing

    now = _time.time()
    ring = tmp_path / "ring.json"
    ring.write_text(json.dumps(HashRing(2, vnodes=16).spec_dict()))
    out = []
    for pkg in ("ref", "port"):
        server = _master_stub(now)
        try:
            procs = []
            for idx in range(2):
                argv = ["--master", server.url, "--shards", "2", "--shard-index", str(idx)]
                if case == "serve_ring":
                    argv += ["--serve", "--window", "8", "--shard-ring", str(ring)]
                procs.append(_scheduler_proc(pkg, argv))
            try:
                if case == "serve_ring":
                    _wait_bound(server.state, MASTER_PODS, procs[0])
            finally:
                if case == "serve_ring":
                    for proc in procs:
                        proc.send_signal(signal.SIGTERM)
                results = [proc.communicate(timeout=120) for proc in procs]
            for proc, (_o, err) in zip(procs, results):
                assert proc.returncode == 0, err[-2000:]
            with server.state.lock:
                dup = server.state.duplicate_binds()
            out.append(([_line(o) for o, _e in results], _bindings(server.state), dup))
        finally:
            server.stop()
    ref, port = out
    assert port == ref
    assert sum(line["scheduled"] for line in ref[0]) == MASTER_PODS and ref[2] == 0
    assert all(line["scheduled"] > 0 for line in ref[0])
    if case == "oneshot":
        _shard_check(ref[1], 2)
    else:
        layout = HashRing.from_spec(json.loads(ring.read_text()))
        from crane_scheduler_tpu_torch.cluster.shards import shard_of

        for key, node in ref[1]:
            assert shard_of(key, 2) in layout.owners(node), (key, node)


def _desched_stub(faults=False):
    """The hot/cool pair of the descheduler drive: one victim on the hot
    node, a DaemonSet decoy beside it."""
    import time as _time

    from crane_scheduler_tpu_torch.utils import format_local_time

    server = kube_stub.KubeStubServer().start()
    now = _time.time()

    def anno(v):
        return {"cpu_usage_avg_5m": f"{v:.5f},{format_local_time(now)}"}

    st = server.state
    st.add_node("hot", "10.0.0.1", annotations=anno(0.92), allocatable={"cpu": "8", "pods": "100"})
    st.add_node("cool", "10.0.0.2", annotations=anno(0.15), allocatable={"cpu": "8", "pods": "100"})
    spec = {"nodeName": "hot", "containers": [{"resources": {"requests": {"cpu": "1"}}}]}
    st.add_pod("default", "victim", spec=spec)
    st.add_pod("default", "ds", spec=spec, owner_references=[{"kind": "DaemonSet", "name": "d"}])
    if faults:
        st.inject_write_faults((0, {}))  # the eviction's response is lost
    return server


DESCHED_MASTER = ["--health-port", "0", "--sync-period-seconds", "5", "--consecutive-syncs", "1",
                  "--run-seconds", "2"]


def test_crane_descheduler_master_equals_reference(tmp_path):
    """crane-descheduler ``--master --journal-dir --leader-elect`` as a
    subprocess of each package on its own stub: it takes the descheduler
    Lease, evicts the victim (never the DaemonSet pod) once through the
    eviction subresource, journals the intent and its ack, and prints the
    reference's stats and recovery report."""
    servers = [_desched_stub(), _desched_stub()]
    procs = [_start(module, ["--master", server.url, "--journal-dir", str(tmp_path / pkg),
                             "--leader-elect", *DESCHED_MASTER])
             for server, (pkg, module) in zip(servers, (
                 ("ref", "crane_scheduler_tpu.cli.descheduler_main"),
                 ("port", "crane_scheduler_tpu_torch.cli.descheduler_main")))]
    out = []
    try:
        for proc, server, pkg in zip(procs, servers, ("ref", "port")):
            stats = _stats(proc)
            stats.pop("cycles")
            assert stats["recovery"].pop("elapsed_s") >= 0
            with server.state.lock:
                evicted = [e["key"] for e in server.state.evictions]
                lease = server.state.leases["crane-system/crane-scheduler-tpu-descheduler"]
                out.append((stats, evicted, server.state.duplicate_evictions(),
                            lease["spec"]["holderIdentity"].startswith("crane-descheduler-"),
                            [r["t"] for r in _journal(tmp_path / pkg)[0]]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        for server in servers:
            server.stop()
    ref, port = out
    assert port == ref
    assert ref[1] == ["default/victim"] and ref[2] == 0 and ref[3]
    assert ref[0]["evictions"] == 1 and ref[4] == ["intent", "ack"]


def test_crane_descheduler_two_life_indeterminate_eviction(tmp_path):
    """Life 1 loses the eviction's response (transport loss): no eviction
    is counted, the pod lives, the journal ends ``unresolved``. Life 2
    reconciles it to ``evict_unapplied``, re-arms the hot node's cooldown
    and POSTs no second eviction. Both lives equal the reference's."""
    out = []
    for pkg, module in (("ref", "crane_scheduler_tpu.cli.descheduler_main"),
                        ("port", "crane_scheduler_tpu_torch.cli.descheduler_main")):
        server = _desched_stub(faults=True)
        jdir = tmp_path / pkg
        try:
            lives = []
            for _life in range(2):
                stats = _stats(_start(module, ["--master", server.url, "--journal-dir", str(jdir),
                                               *DESCHED_MASTER]))
                stats.pop("cycles")
                assert stats["recovery"].pop("elapsed_s") >= 0
                with server.state.lock:
                    lives.append((stats, sum(server.state.evict_posts.values()),
                                  "default/victim" in server.state.pods,
                                  [r["t"] for r in _journal(jdir)[0]]))
            out.append((lives, server.state.duplicate_evictions()))
        finally:
            server.stop()
    ref, port = out
    assert port == ref
    (life1, life2), dup = ref
    assert life1[1] == 0 and life1[2] and life1[3] == ["intent", "unresolved"]
    assert life2[0]["recovery"]["outcomes"] == {"evict_unapplied": 1}
    assert life2[0]["recovery"]["rearm_cooldowns"] == ["hot"]
    assert life2[1] == 0 and life2[2] and dup == 0
