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
``/v1/score`` bytes); the master-mode planes not ported yet exit with a
usage error naming their ``ROADMAP.md`` item. The config loaders give
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
    """The kube mirror's flags are accepted (item 8.2a); with ``--master``
    the serving plane that stands on it is still refused at parse time,
    naming its item (8.2b). The apiserver is a local address with nothing
    behind it: the refusal comes before any connection."""
    with pytest.raises(SystemExit) as exc:
        scheduler_main.main(["--device", "cpu", *flags, "--master", "http://127.0.0.1:1",
                             "--serve"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md Queue 1 item 8.2b" in err and flags[0] in err


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


def _descheduler_built(pkg, argv, monkeypatch) -> dict:
    """What ``pkg``'s crane-descheduler ``main`` hands its
    ``LoadAwareDescheduler`` for ``argv``: the config, the degraded
    interlock's fractions, the policy and the node names. The capture
    raises before the health server, the signal handlers and the loop
    start, so ``main`` runs in this thread; the process-global telemetry
    it enables is restored afterwards."""
    import importlib

    desched = importlib.import_module(f"{pkg}.descheduler")
    cli = importlib.import_module(f"{pkg}.cli.descheduler_main")
    telemetry = importlib.import_module(f"{pkg}.telemetry")
    seen = {}

    def capture(cluster, policy, config, *, telemetry=None, degraded=None):
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
def test_crane_descheduler_refuses_kube_mirror_flags(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        descheduler_main.main(flags)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md Queue 1 item 8" in err and flags[0] in err


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
