"""The PyTorch port stands alone: it imports without JAX, without the JAX
package and without PyYAML, and its entry points never move to the CPU
on their own."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "crane_scheduler_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
for name in {blocked!r}:
    sys.modules[name] = None
import crane_scheduler_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
assert not any(k == "jax" or k.startswith(("jax.", "crane_scheduler_tpu."))
               for k, v in sys.modules.items() if v is not None)
print(len(mods))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is faster here and leaves the
    other test workers their cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run_blocked(blocked):
    path = os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(blocked=blocked)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return int(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize(
    "blocked",
    [("jax", "crane_scheduler_tpu"), ("jax", "crane_scheduler_tpu", "yaml")],
    ids=["no-jax", "no-jax-no-yaml"],
)
def test_port_and_chip_smoke_import_without_jax(blocked):
    # every module of the port (and chip_smoke) imports with these blocked
    assert _run_blocked(blocked) >= 20


def test_no_jax_or_reference_imports_in_port_sources():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax\b|crane_scheduler_tpu\b(?!_torch))", re.M
    )
    # _build/ holds build outputs, not sources
    files = [f for f in sorted(PORT.rglob("*.py")) if "_build" not in f.parts]
    files.append(REPO / "chip_smoke.py")
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_batch_scheduler_without_device_needs_cuda(monkeypatch):
    from crane_scheduler_tpu_torch.cluster import ClusterState
    from crane_scheduler_tpu_torch.framework.scheduler import BatchScheduler
    from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchScheduler(ClusterState(), DEFAULT_POLICY)
    with pytest.raises(ValueError, match="unsupported device"):
        BatchScheduler(ClusterState(), DEFAULT_POLICY, device="meta")
    # the CPU is used only when asked for, with telemetry too
    sched = BatchScheduler(ClusterState(), DEFAULT_POLICY, device="cpu")
    assert sched.device.type == "cpu" and sched.gang.device.type == "cpu"
    from crane_scheduler_tpu_torch.telemetry import Telemetry

    tel = Telemetry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchScheduler(ClusterState(), DEFAULT_POLICY, telemetry=tel)
    sched = BatchScheduler(ClusterState(), DEFAULT_POLICY, telemetry=tel, device="cpu")
    assert sched._telemetry is tel and sched.device.type == "cpu"


def test_kernel_wrappers_take_plain_version_only_on_cpu():
    """CPU tensors run the plain versions and count no launch."""
    from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY, compile_policy
    from crane_scheduler_tpu_torch.scorer import gang_kernel, score_kernel
    from crane_scheduler_tpu_torch.scorer.batched import PolicyConstants

    t = compile_policy(DEFAULT_POLICY)
    consts = PolicyConstants(t, torch.float32, "cpu")
    n = 16
    rng = np.random.default_rng(0)
    values = torch.from_numpy(rng.uniform(0, 1, (n, t.num_metrics)).astype(np.float32))
    ts = torch.zeros((n, t.num_metrics), dtype=torch.float32)
    before = (score_kernel.KERNEL.launches, gang_kernel.KERNEL.launches)
    sched, scores = score_kernel.fused_score(
        values, ts, torch.zeros(n), torch.zeros(n),
        torch.ones(n, dtype=torch.bool), 0.0, consts,
    )
    assert sched.dtype == torch.bool and scores.dtype == torch.int32
    g = torch.tensor([2, 4, 5, 6, 8, 9, 10, 12, 14, 15, 16], dtype=torch.int32)
    z = torch.zeros(n, dtype=torch.int32)
    totals = gang_kernel.gang_totals(scores, z, z + 3, z, g, 1, 102)
    assert totals.shape == (102,) and int(totals[0]) == 3 * n
    assert (score_kernel.KERNEL.launches, gang_kernel.KERNEL.launches) == before


def test_drip_entry_points_without_device_need_cuda(monkeypatch):
    from crane_scheduler_tpu_torch.cluster import ClusterState
    from crane_scheduler_tpu_torch.config import (
        SchedulerConfiguration,
        SchedulerProfile,
        build_scheduler_from_config,
    )
    from crane_scheduler_tpu_torch.framework.scheduler import Scheduler
    from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY
    from crane_scheduler_tpu_torch.scorer.drip_batch import DripBatchKernel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = SchedulerConfiguration(profiles=(SchedulerProfile(),))
    for make in (lambda: Scheduler(ClusterState()), DripBatchKernel,
                 lambda: build_scheduler_from_config(ClusterState(), config,
                                                     policy=DEFAULT_POLICY)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # the port's Telemetry is accepted, and still only the CPU asked for
    # runs without a GPU
    from crane_scheduler_tpu_torch.telemetry import Telemetry

    tel = Telemetry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scheduler(ClusterState(), telemetry=tel)
    assert Scheduler(ClusterState(), telemetry=tel, device="cpu")._telemetry is tel
    with pytest.raises(NotImplementedError, match="mesh"):
        Scheduler(ClusterState(), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        DripBatchKernel(mesh=object(), device="cpu")
    # the CPU is used only when asked for
    assert Scheduler(ClusterState(), device="cpu").device.type == "cpu"
    assert DripBatchKernel(device="cpu").device.type == "cpu"


def test_metrics_sync_plane_entry_points_default_to_cuda(monkeypatch, capsys):
    from crane_scheduler_tpu_torch.cli import annotator_main, sim_main
    from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY
    from crane_scheduler_tpu_torch.service import ServingReplica
    from crane_scheduler_tpu_torch.sim import SimConfig, Simulator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim = Simulator(SimConfig(n_nodes=4))
    for make in (sim.build_batch_scheduler, sim.build_scheduler,
                 lambda: ServingReplica(DEFAULT_POLICY),
                 lambda: sim_main.main(["--nodes", "4", "--pods", "2"]),
                 lambda: annotator_main.main(["--demo-nodes", "2", "--health-port", "0"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # the CPU only when asked for
    assert sim.build_batch_scheduler(device="cpu").device.type == "cpu"
    replica = ServingReplica(DEFAULT_POLICY, device="cpu")
    assert replica.service.device.type == "cpu"
    replica.stop()
    # the kube mirror's flags: without --device the card is needed before
    # the mirror connects; with --device cpu the CLI goes on to list the
    # apiserver (a local address with nothing behind it)
    import urllib.error

    for argv in (["--master", "http://127.0.0.1:1"],
                 ["--token-file", "/dev/null", "--master", "http://127.0.0.1:1"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            annotator_main.main(["--health-port", "0", *argv])
        with pytest.raises(urllib.error.URLError):
            annotator_main.main(["--device", "cpu", "--health-port", "0", *argv])
        assert "ROADMAP" not in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        sim_main.main(["--device", "cpu", "--mode", "sharded"])
    assert exc.value.code == 2 and "Queue 1 item 7" in capsys.readouterr().err


def test_front_doors_default_to_cuda(monkeypatch, capsys):
    """crane-scheduler without --device needs the card, before it builds
    its simulation; only --device cpu runs on the CPU. The descheduler,
    the storm generator and the new modules import without JAX (above)."""
    from crane_scheduler_tpu_torch.cli import scheduler_main

    monkeypatch.chdir(REPO)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--demo-nodes", "4", "--pods", "2"],
                 ["--demo-nodes", "4", "--pods", "2", "--batch-size", "2"],
                 ["--demo-nodes", "4", "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            scheduler_main.main(argv)
    assert capsys.readouterr().out == ""
    assert scheduler_main.main(["--demo-nodes", "4", "--pods", "2", "--device", "cpu"]) == 0
    assert '"scheduled": 2' in capsys.readouterr().out
    for name in ("descheduler", "descheduler.config", "descheduler.descheduler",
                 "cli.descheduler_main", "cli.scheduler_main", "resilience.loadgen",
                 "utils.system"):
        assert (PORT / (name.replace(".", "/") + ".py")).exists() or \
            (PORT / name.replace(".", "/") / "__init__.py").exists()


_KUBE_MIRROR = """
import sys
for name in ("jax", "crane_scheduler_tpu", "yaml"):
    sys.modules[name] = None
from crane_scheduler_tpu_torch.cluster import kube, kube_wire
from crane_scheduler_tpu_torch.native import listdecode
from crane_scheduler_tpu_torch.service import kube_leader
from crane_scheduler_tpu_torch.cli import annotator_main, scheduler_main, service_main
body = b'{"metadata": {"resourceVersion": "3"}, "items": [{"metadata": {"name": "n"}}]}'
page = listdecode.decode_list_page(body, 0)
assert [n.name for n in page.materialize()] == ["n"] and page.backend == "pylist"
for native, backend in ((True, "native"), (False, "python")):
    page = listdecode.decode_list_page(body, 0, native=native)
    assert [n.name for n in page.materialize()] == ["n"] and page.backend == backend
client = kube.KubeClusterClient("http://127.0.0.1:1")
assert client.node_annotation_columns() is None
client.stop()
assert not any(k == "jax" or k.startswith(("jax.", "crane_scheduler_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("ok")
"""


def test_kube_mirror_modules_stand_alone():
    """The kube mirror's modules (the client, its wire layer, the LIST
    decoder, the apiserver Lease) and the three ``--master`` CLIs import
    and run with JAX, the JAX package and PyYAML blocked; the decoder's
    default route is the port's own object decoder, and its columnar
    scanner and Python twin answer when asked."""
    for name in ("cluster/kube.py", "cluster/kube_wire.py", "native/listdecode.py",
                 "service/kube_leader.py"):
        assert (PORT / name).exists()
    source = (PORT / "native/listdecode.py").read_text()
    assert "crane_scheduler_tpu." not in source
    path = os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)
    out = subprocess.run([sys.executable, "-c", _KUBE_MIRROR], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


_HOST_LIBRARY = """
import sys
for name in ("jax", "crane_scheduler_tpu", "yaml"):
    sys.modules[name] = None
from crane_scheduler_tpu_torch.native import codec, lib, listdecode
from crane_scheduler_tpu_torch.native.bindings import NativeBindingRecords
assert len(NativeBindingRecords(8, 60)) == 0
assert codec.bulk_render_f5([0.5]) == ["0.50000"]
assert listdecode.decode_watch_lines(b"", 0) is not None
with open("/proc/self/maps") as f:
    maps = {line.split()[-1] for line in f if "libcrane_" in line}
print(sorted(maps))
print(sorted(lib.library_paths().values()))
"""


def test_host_library_loads_only_from_the_port_build_dir():
    """The port builds its host library from its own ``csrc/`` into
    ``crane_scheduler_tpu_torch/_build/`` and loads it from there: every
    ``libcrane_*`` mapped into the process lies there, none under the
    JAX package's ``native/``."""
    for name in ("crane_native.cpp", "crane_pylist.cpp", "listscan.h"):
        copy = (PORT / "csrc" / name).read_text()
        assert (REPO / "native" / name).read_text() in copy
    path = os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)
    out = subprocess.run([sys.executable, "-c", _HOST_LIBRARY], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mapped, loaded = (ast.literal_eval(line) for line in out.stdout.strip().splitlines()[-2:])
    assert len(mapped) == 2 and mapped == loaded
    for p in mapped:
        assert Path(p).parent == PORT / "_build"
        assert not Path(p).is_relative_to(REPO / "native")


_CONTROL_AND_SHARDS = """
import sys, tempfile
for name in ("jax", "crane_scheduler_tpu", "yaml"):
    sys.modules[name] = None
from crane_scheduler_tpu_torch.resilience import (
    ChaosPlan, IntentJournal, Reconciler, WarmStandby, replay_journal)
from crane_scheduler_tpu_torch.cluster import ClusterState, Node
from crane_scheduler_tpu_torch.cluster.shards import HashRing, shard_of
from crane_scheduler_tpu_torch.framework.shardplane import ShardedPlacementPlane
from crane_scheduler_tpu_torch.cli import descheduler_main, scheduler_main
with tempfile.TemporaryDirectory() as d:
    j = IntentJournal(d)
    j.intent("bind", "ns/p", "n0")
    assert Reconciler(j, lambda key: None).reconcile().outcomes == {"pod_gone": 1}
    assert replay_journal(d).unresolved() == []
assert ChaosPlan.generate(5, steps=20).describe().startswith("ChaosPlan(seed=5")
cs = ClusterState()
for i in range(16):
    cs.add_node(Node(name=f"n{i}"))
ring = HashRing(2, vnodes=8)
plane = ShardedPlacementPlane(cs, 2, layout=ring)
_p, owners = ring.tokens()
assert isinstance(plane.reshard(ring.with_moves([(0, 1 - owners[0])])), list)
assert sum(len(v.list_nodes()) for v in plane.views) == 16 and shard_of("x", 2) in (0, 1)
assert not any(k == "jax" or k.startswith(("jax.", "crane_scheduler_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("ok")
"""


def test_control_and_shard_planes_stand_alone():
    """The intent journal, reconciler, warm standby, chaos plans, the
    shard keyspace and the shard plane import and run with JAX, the JAX
    package and PyYAML blocked, and are the port's own files."""
    for name in ("resilience/recovery.py", "resilience/chaos.py", "cluster/shards.py",
                 "framework/shardplane.py"):
        assert (PORT / name).exists()
    path = os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)
    out = subprocess.run([sys.executable, "-c", _CONTROL_AND_SHARDS], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


@pytest.mark.parametrize("flags", [["--serve"], ["--journal-dir", "/nonexistent"],
                                   ["--shards", "2", "--serve", "--lock-file", "/nonexistent/l"]],
                         ids=["serve", "journal", "shards"])
def test_master_planes_without_device_need_cuda(flags, monkeypatch, capsys):
    """crane-scheduler ``--master`` with the serving, journal or shard
    plane and no ``--device`` needs the card: it raises the no-CUDA error
    before it contacts the apiserver (nothing listens at the address)."""
    from crane_scheduler_tpu_torch.cli import scheduler_main

    monkeypatch.chdir(REPO)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scheduler_main.main(["--master", "http://127.0.0.1:1", *flags])
    assert capsys.readouterr().out == ""
