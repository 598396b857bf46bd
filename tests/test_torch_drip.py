"""The per-pod drip path on the CPU: the port's ``Scheduler`` (scalar loop,
columnar ``schedule_one``, ``schedule_queue``, ``DripQueue``), its cluster
versions, ``FitTracker``, the drip columns, ``SegMaxTree`` and the batched
window ``_drip_batch`` against the JAX package on twin inputs made from
one seed (a few dozen to a few hundred nodes, dozens of pods).

Tolerance: exact. Placements, feasible counts, failure reasons, fallback
and fold/drop/replay counters, RNG states, versions, free matrices, masks,
fail codes, column values and every int64 output of the window are equal.

The JAX drip window (``crane_scheduler_tpu/scorer/drip_batch.py``) does not
import under jax 0.9 without ``jax.experimental.enable_x64``. The
``jax_drip`` fixture sets that name for this module only and, on teardown,
restores ``jax.experimental`` and removes every ``crane_scheduler_tpu``
module it loaded, so no other test file sees the reference window import.
"""

import contextlib
import importlib
import random
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from crane_scheduler_tpu.cluster import ClusterState, Container, Node, OwnerReference, Pod
from crane_scheduler_tpu.cluster import ResourceRequirements
from crane_scheduler_tpu.config import build_scheduler_from_config as jax_build_from_config
from crane_scheduler_tpu.config import load_scheduler_config as jax_load_config
from crane_scheduler_tpu.fit import FitTracker, ResourceFitPlugin
from crane_scheduler_tpu.fit import tracker as jax_tracker
# what the reference window and the reference store import lazily, loaded
# here so that the fixture below loads (and later removes) the window alone
from crane_scheduler_tpu.native import codec as _jax_native_codec  # noqa: F401
from crane_scheduler_tpu.parallel import sharded as _jax_sharded  # noqa: F401
from crane_scheduler_tpu.framework import drip as _jax_drip_columns  # noqa: F401
from crane_scheduler_tpu.framework.scheduler import Scheduler
from crane_scheduler_tpu.framework.types import Status
from crane_scheduler_tpu.plugins import DynamicPlugin
from crane_scheduler_tpu.policy import DEFAULT_POLICY, compile_policy
from crane_scheduler_tpu.policy import load_policy_from_file as jax_load_policy
from crane_scheduler_tpu.scorer.columns import drip_filter_score_columns
from crane_scheduler_tpu.scorer.topk import SegMaxTree
from crane_scheduler_tpu.telemetry import Telemetry as JaxTelemetry
from crane_scheduler_tpu_torch import cluster as pc
from crane_scheduler_tpu_torch.config import SchedulerConfiguration, SchedulerProfile
from crane_scheduler_tpu_torch.config import PluginWeight
from crane_scheduler_tpu_torch.config import build_scheduler_from_config as port_build_from_config
from crane_scheduler_tpu_torch.config import load_scheduler_config as port_load_config
from crane_scheduler_tpu_torch.fit import FitTracker as PortFitTracker
from crane_scheduler_tpu_torch.fit import ResourceFitPlugin as PortFitPlugin
from crane_scheduler_tpu_torch.fit import tracker as port_tracker
from crane_scheduler_tpu_torch.framework.scheduler import Scheduler as PortScheduler
from crane_scheduler_tpu_torch.framework.types import Status as PortStatus
from crane_scheduler_tpu_torch.plugins import DynamicPlugin as PortDynamicPlugin
from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY as PORT_POLICY
from crane_scheduler_tpu_torch.policy import compile_policy as port_compile_policy
from crane_scheduler_tpu_torch.policy import load_policy_from_file as port_load_policy
from crane_scheduler_tpu_torch.scorer import drip_batch as port_drip
from crane_scheduler_tpu_torch.scorer.columns import (
    drip_filter_score_columns as port_drip_columns,
)
from crane_scheduler_tpu_torch.scorer.topk import SegMaxTree as PortSegMaxTree
from crane_scheduler_tpu_torch.telemetry import Telemetry as PortTelemetry
from test_drip_columnar import METRICS, NOW, _anno, fuzz_node_specs, fuzz_pod_specs

REPO = Path(__file__).resolve().parents[1]
I64_MIN = np.iinfo(np.int64).min
REF_WINDOW = "crane_scheduler_tpu.scorer.drip_batch"


@contextlib.contextmanager
def jax_drip_reference():
    """Import the JAX drip window with the ``enable_x64`` shim; on exit
    restore ``jax.experimental`` and drop every ``crane_scheduler_tpu``
    module loaded meanwhile, with its attribute on the parent package."""
    import jax
    import jax.experimental as jexp

    missing = object()
    prev = vars(jexp).get("enable_x64", missing)
    before = set(sys.modules)
    jexp.enable_x64 = jax.enable_x64
    try:
        yield importlib.import_module(REF_WINDOW)
    finally:
        if prev is missing:
            vars(jexp).pop("enable_x64", None)
        else:
            jexp.enable_x64 = prev
        loaded = [m for m in sys.modules if m not in before
                  and (m == "crane_scheduler_tpu" or m.startswith("crane_scheduler_tpu."))]
        for name in loaded:
            mod = sys.modules.pop(name)
            parent, _, child = name.rpartition(".")
            pmod = sys.modules.get(parent)
            if pmod is not None and getattr(pmod, child, None) is mod:
                delattr(pmod, child)


def _jexp_state():
    import jax.experimental as jexp

    return "enable_x64" in vars(jexp), vars(jexp).get("enable_x64")


def test_reference_shim_leaves_nothing_behind():
    """Runs before any test takes the ``jax_drip`` fixture (file order)."""
    assert REF_WINDOW not in sys.modules
    state = _jexp_state()
    loaded = {m for m in sys.modules if m.startswith("crane_scheduler_tpu.")}
    with jax_drip_reference() as mod:
        assert mod.__name__ == REF_WINDOW and REF_WINDOW in sys.modules
    assert REF_WINDOW not in sys.modules
    assert {m for m in sys.modules if m.startswith("crane_scheduler_tpu.")} == loaded
    assert not hasattr(sys.modules["crane_scheduler_tpu.scorer"], "drip_batch")
    assert _jexp_state() == state
    with pytest.raises(ImportError, match="enable_x64"):
        importlib.import_module(REF_WINDOW)
    assert REF_WINDOW not in sys.modules


@pytest.fixture(scope="module")
def jax_drip():
    state = _jexp_state()
    with jax_drip_reference() as mod:
        yield mod
    assert REF_WINDOW not in sys.modules
    assert _jexp_state() == state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is faster here and leaves the
    other test workers their cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- twin builders -------------------------------------------------------------

MODULES = {
    "jax": dict(ClusterState=ClusterState, Node=Node, Pod=Pod, Container=Container,
                ResourceRequirements=ResourceRequirements, OwnerReference=OwnerReference),
    "port": dict(ClusterState=pc.ClusterState, Node=pc.Node, Pod=pc.Pod, Container=pc.Container,
                 ResourceRequirements=pc.ResourceRequirements,
                 OwnerReference=pc.OwnerReference),
}


def build_cluster(side, specs):
    m = MODULES[side]
    cluster = m["ClusterState"]()
    for name, anno, allocatable in specs:
        kwargs = {"allocatable": allocatable} if allocatable else {}
        cluster.add_node(m["Node"](name=name, annotations=dict(anno), **kwargs))
    return cluster


def make_pod(side, name, cpu_milli, mem, daemonset=False, extra=None, node_name=""):
    m = MODULES[side]
    kwargs = {}
    if daemonset:
        kwargs["owner_references"] = (m["OwnerReference"](kind="DaemonSet", name="ds"),)
    requests = {"cpu": f"{cpu_milli}m", "memory": str(mem), **(extra or {})}
    return m["Pod"](
        name=name, namespace="default", node_name=node_name,
        containers=(m["Container"]("c", m["ResourceRequirements"](requests=requests)),),
        **kwargs,
    )


class Degraded:
    """Duck-typed degraded-mode controller: only ``active`` is read."""

    active = True


def build_scheduler(side, cluster, columnar=True, seed=None, fit=True, degraded=None,
                    telemetry=None):
    clock = lambda: NOW  # noqa: E731
    if side == "jax":
        sched = Scheduler(cluster, clock=clock, columnar=columnar, tie_break_seed=seed,
                          telemetry=telemetry)
        if fit:
            sched.register(ResourceFitPlugin(FitTracker(cluster, telemetry=telemetry)),
                           weight=1)
        sched.register(DynamicPlugin(DEFAULT_POLICY, clock=clock, degraded=degraded), weight=3)
    else:
        sched = PortScheduler(cluster, clock=clock, columnar=columnar, tie_break_seed=seed,
                              device="cpu", telemetry=telemetry)
        if fit:
            sched.register(PortFitPlugin(PortFitTracker(cluster, telemetry=telemetry)),
                           weight=1)
        sched.register(PortDynamicPlugin(PORT_POLICY, clock=clock, degraded=degraded),
                       weight=3)
    return sched


def outcome(results):
    return [(r.pod_key, r.node, r.feasible, r.reason) for r in results]


STAT_KEYS = ("hits", "rebuilds", "folds", "drops", "topk_builds", "topk_updates", "fallbacks")
JOURNAL_KEYS = ("full_sweeps", "dirty_patches", "dirty_rows")
BATCH_KEYS = ("dispatches", "pods", "replays", "conflicts", "batch_sizes")


def assert_same_stats(js, ps, keys=STAT_KEYS):
    a, b = js.drip_stats(), ps.drip_stats()
    assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
    assert {k: a["batch"][k] for k in BATCH_KEYS} == {k: b["batch"][k] for k in BATCH_KEYS}
    rj, rp = js._tie_rng, ps._tie_rng
    assert (rj is None) == (rp is None)
    if rj is not None:
        assert rj.getstate() == rp.getstate()


def versions(cluster):
    return (cluster.sched_version, cluster.pod_version, cluster.node_version,
            cluster.node_set_version)


def run_mode(side, mode, cluster, sched, pods):
    """Schedule ``pods`` (already added) through one path of ``sched``."""
    if mode in ("scalar", "perpod"):
        return [sched.schedule_one(p) for p in pods]
    if mode.startswith("queue"):
        return sched.schedule_queue(pods, window=int(mode[5:]))
    queue = sched.open_queue(window=int(mode[4:]))
    for pod in pods:
        queue.offer(pod)
    queue.drain()
    return queue.take_results()


def twin_run(jax_drip, mode, node_specs, pod_specs, seed=None, feed=None, tels=None,
             **sched_kw):
    """One path on both packages over twin clusters; returns both sides'
    (cluster, scheduler, results). ``tels`` maps a side to its
    ``Telemetry``."""
    out = {}
    for side in ("jax", "port"):
        cluster = build_cluster(side, node_specs)
        sched = build_scheduler(side, cluster, columnar=mode != "scalar", seed=seed,
                                telemetry=(tels or {}).get(side), **sched_kw)
        pods = [make_pod(side, *spec) for spec in pod_specs]
        for pod in pods:
            cluster.add_pod(pod)
        stream = pods if feed is None else feed(side, cluster, pods)
        out[side] = (cluster, sched, run_mode(side, mode, cluster, sched, stream))
    return out


def assert_twins_equal(out, keys=STAT_KEYS):
    (jc, js, jr), (pc_, ps, pr) = out["jax"], out["port"]
    assert outcome(pr) == outcome(jr)
    assert_same_stats(js, ps, keys)
    assert versions(pc_) == versions(jc)
    # the lazy views read the same columns
    for a, b in zip(jr[:8], pr[:8]):
        assert b.scores == a.scores and b.top_scores(3) == a.top_scores(3)
        if a._reasons_fn is not None:
            assert b.filter_reasons() == a._reasons_fn()


# -- cluster versions and the pod-change journal -------------------------------


def test_cluster_versions_and_pod_journal_match():
    specs = [(f"n{i}", {"cpu_usage_avg_5m": _anno(0.2, 30.0)},
              {"cpu": "4", "memory": "8Gi", "pods": "10"}) for i in range(4)]
    clusters = {side: build_cluster(side, specs) for side in ("jax", "port")}

    def step(fn):
        for side, cluster in clusters.items():
            fn(side, cluster)
        j, p = clusters["jax"], clusters["port"]
        assert versions(p) == versions(j)
        for v in range(0, j.pod_version + 1):
            assert p.pod_changes_since(v) == j.pod_changes_since(v)
        assert sorted(x.key() for x in p.list_pods()) == sorted(x.key() for x in j.list_pods())
        for node in ("n0", "n1", "n3"):
            assert ([x.key() for x in p.list_pods(node)]
                    == [x.key() for x in j.list_pods(node)])

    step(lambda s, c: c.add_pod(make_pod(s, "a", 100, 1 << 20)))  # unbound
    step(lambda s, c: c.add_pod(make_pod(s, "b", 100, 1 << 20, node_name="n0")))  # bound
    step(lambda s, c: c.add_pod(make_pod(s, "b", 100, 1 << 20, node_name="n0")))  # same again
    step(lambda s, c: c.bind_pods([("default/a", "n1"), ("default/zz", "n1")], NOW))
    step(lambda s, c: c.bind_pods({"default/a": "n2"}, NOW))  # a rebind
    step(lambda s, c: c.bind_pod("default/b", "n3", NOW))
    step(lambda s, c: c.add_pod(make_pod(s, "b", 200, 1 << 20, node_name="n3")))  # new request
    step(lambda s, c: c.delete_pod("default/a"))
    step(lambda s, c: c.delete_pod("default/missing"))
    step(lambda s, c: c.add_node(MODULES[s]["Node"](name="n9")))
    step(lambda s, c: c.add_node(MODULES[s]["Node"](name="n9", labels={"z": "1"})))
    step(lambda s, c: c.delete_node("n2"))
    step(lambda s, c: c.delete_node("n2"))
    step(lambda s, c: c.patch_node_annotation("n0", "cpu_usage_avg_5m", _anno(0.5, 1.0)))
    # a columnar patch lands in the overlay; get_node folds it for one node
    step(lambda s, c: c.patch_node_annotations_columns(["n1", "n3"], {"x": ["1", "2"]}))
    for side, c in clusters.items():
        assert c.get_node("n3").annotations["x"] == "2" and c.get_node("n2") is None
        assert dict(c.get_node("n1").allocatable) == {"cpu": "4", "memory": "8Gi", "pods": "10"}

    def burst(side, c):
        handle = c.add_pod_burst("bursty", [f"r{i}" for i in range(5)])
        c.bind_burst(handle, ["n0", "n1"], np.array([0, 1, -1, 1, 0]), NOW)

    step(burst)  # columnar binds move sched_version only
    for side, c in clusters.items():
        pod = c.get_pod("bursty/r1")
        assert (pod.name, pod.namespace, pod.node_name) == ("r1", "bursty", "n1")
        assert pod.containers == ()
        assert c.get_pod("bursty/r2").node_name == ""
    step(lambda s, c: c.delete_pod("bursty/r1"))  # a bound burst row
    step(lambda s, c: c.bind_pods([("bursty/r2", "n3")], NOW))  # a pending burst row
    # an object pod over a bound burst row replaces it
    step(lambda s, c: c.add_pod(MODULES[s]["Pod"](name="r0", namespace="bursty", node_name="n1")))


# -- ResourceFit -----------------------------------------------------------------


def fit_cluster(side, rng_seed):
    """Nodes with and without allocatable (one with a scalar resource),
    bound pods with init containers, overhead and scalar requests."""
    rng = random.Random(rng_seed)
    m = MODULES[side]
    cluster = m["ClusterState"]()
    for i in range(40):
        alloc = None
        roll = rng.random()
        if roll < 0.6:
            alloc = {"cpu": str(rng.randrange(1, 9)), "memory": f"{rng.randrange(1, 33)}Gi",
                     "pods": str(rng.randrange(1, 12))}
            if rng.random() < 0.3:
                alloc["ephemeral-storage"] = f"{rng.randrange(1, 50)}Gi"
            if rng.random() < 0.2:
                alloc["example.com/gpu"] = str(rng.randrange(0, 4))
        elif roll < 0.7:
            alloc = {"cpu": "2"}  # no pods entry: that dimension fails open
        kwargs = {"allocatable": alloc} if alloc else {}
        cluster.add_node(m["Node"](name=f"n{i:02d}", **kwargs))
    for j in range(90):
        req = {"cpu": f"{rng.randrange(0, 1500)}m", "memory": f"{rng.randrange(0, 3000)}Mi"}
        if rng.random() < 0.2:
            req["ephemeral-storage"] = f"{rng.randrange(1, 5)}Gi"
        if rng.random() < 0.1:
            req["example.com/gpu"] = "1"
        init = ()
        if rng.random() < 0.3:
            init = (m["Container"]("init", m["ResourceRequirements"](
                requests={"cpu": f"{rng.randrange(0, 4000)}m", "memory": "2Gi"})),)
        overhead = {"cpu": "50m", "memory": "64Mi"} if rng.random() < 0.2 else {}
        kw = {"overhead": overhead} if overhead else {}
        node = f"n{rng.randrange(0, 40):02d}" if rng.random() < 0.8 else ""
        cluster.add_pod(m["Pod"](
            name=f"p{j}", node_name=node, init_containers=init,
            containers=(m["Container"]("c", m["ResourceRequirements"](requests=req)),), **kw))
    return cluster


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_tracker_matches(seed):
    jc, pcl = fit_cluster("jax", seed), fit_cluster("port", seed)
    jt, pt = FitTracker(jc), PortFitTracker(pcl)
    rng = random.Random(100 + seed)
    for round_ in range(3):
        jt.refresh()
        pt.refresh()
        names = [n.name for n in jc.list_nodes()] + ["ghost"]
        jb, jf = jt.free_matrix(names)
        pb, pf = pt.free_matrix(names)
        assert np.array_equal(pb, jb) and np.array_equal(pf, jf)
        assert pt.alloc_version == jt.alloc_version
        for k in range(6):
            spec = (f"q{k}", rng.randrange(0, 3000), rng.randrange(0, 8 << 30))
            extra = {"example.com/gpu": "1"} if k == 5 else None
            jp, pp = make_pod("jax", *spec, extra=extra), make_pod("port", *spec, extra=extra)
            jr, pr = jax_tracker.pod_fit_request(jp), port_tracker.pod_fit_request(pp)
            assert (pr.milli_cpu, pr.memory, pr.ephemeral_storage, pr.scalar_resources) == (
                jr.milli_cpu, jr.memory, jr.ephemeral_storage, jr.scalar_resources)
            assert np.array_equal(pt.fits_mask(names, pr), jt.fits_mask(names, jr))
            vec = jax_tracker.request_vec(jr)
            assert np.array_equal(port_tracker.request_vec(pr), vec)
            assert np.array_equal(port_tracker.rows_fail_codes(pf, vec),
                                  jax_tracker.rows_fail_codes(jf, vec))
            for name in names[::7]:
                assert pt.fits(pp, name) == jt.fits(jp, name)
            for row in range(0, len(names), 5):
                assert (port_tracker.row_fail_reason(pf[row], vec)
                        == jax_tracker.row_fail_reason(jf[row], vec))
        for c in range(4):
            assert port_tracker.fail_code_reason(c) == jax_tracker.fail_code_reason(c)
        # move some bound pods: incremental recounts through the journal
        moves = [(f"default/p{rng.randrange(90)}", f"n{rng.randrange(40):02d}") for _ in range(5)]
        jc.bind_pods(moves, NOW)
        pcl.bind_pods(moves, NOW)
        if round_ == 1:
            jc.delete_node("n03")
            pcl.delete_node("n03")
    assert pt.stats()["full_recounts"] == jt.stats()["full_recounts"]
    assert pt.stats()["incremental_recounts"] == jt.stats()["incremental_recounts"]


# -- drip columns and SegMaxTree -------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 37, 256, 300])
def test_segmax_tree_matches(n):
    rng = np.random.default_rng(n)
    feas = rng.random(n) < 0.7
    values = np.where(feas, rng.integers(0, 6, n) * 3, I64_MIN).astype(np.int64)
    jt, pt = SegMaxTree(values, feas), PortSegMaxTree(values, feas)

    def same():
        assert (pt.feasible_count, pt.max_value, pt.tie_count) == (
            jt.feasible_count, jt.max_value, jt.tie_count)
        if jt.feasible_count:
            assert pt.argmax_first() == jt.argmax_first()
            for r in range(jt.tie_count):
                assert pt.select_tie(r) == jt.select_tie(r)

    same()
    for _ in range(40):
        i, v, f = int(rng.integers(0, n)), int(rng.integers(0, 6)) * 3, bool(rng.random() < 0.6)
        jt.update(i, v, f)
        pt.update(i, v, f)
        same()


def test_drip_filter_score_columns_match():
    rng = np.random.default_rng(5)
    jt, pt = compile_policy(DEFAULT_POLICY), port_compile_policy(PORT_POLICY)
    n, m = 500, jt.num_metrics
    values = rng.choice([0.1, 0.5, 0.65, 0.65001, 0.75, 0.9, -0.2, np.nan], (n, m))
    ts = NOW - rng.choice([0.0, 30.0, 179.0, 181.0, 479.0, 481.0, 5000.0, np.inf], (n, m))
    hot = rng.choice([0.0, 1.0, 2.5, np.nan], n)
    hot_ts = NOW - rng.choice([0.0, 100.0, 301.0, np.inf], n)
    got = port_drip_columns(pt, values, ts, hot, hot_ts, NOW)
    want = drip_filter_score_columns(jt, values, ts, hot, hot_ts, NOW)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# -- the batched window ------------------------------------------------------------


def window_inputs(seed, n, k, case):
    rng = np.random.default_rng(seed)
    schedulable = rng.random(n) < 0.8
    weighted = rng.integers(-(2**33), 2**33, n).astype(np.int64)
    if case == "equal":
        weighted[:] = 300
        schedulable[:] = True
    bounded = rng.random(n) < 0.7
    free = np.stack([rng.integers(0, 4000, n), rng.integers(0, 2 << 30, n),
                     rng.integers(0, 1 << 20, n), rng.integers(0, 20, n)], axis=1)
    vecs = np.stack([rng.integers(0, 3000, k), rng.integers(0, 1 << 30, k),
                     np.zeros(k, np.int64), np.ones(k, np.int64)], axis=1)
    if case == "infeasible":
        schedulable[:] = False
    return schedulable, weighted, bounded, free.astype(np.int64), vecs.astype(np.int64)


@pytest.mark.parametrize("case", ["random", "equal", "infeasible", "padded"])
@pytest.mark.parametrize("want_ties", [True, False])
def test_drip_batch_window_matches(jax_drip, case, want_ties):
    """``_drip_batch`` on CPU tensors equals the JAX program: every int64
    output and the folded carry. "padded" pads the nodes with infeasible
    rows and the pods with inactive ones, as the reference's buckets do."""
    import jax.numpy as jnp

    n, k = (300, 24) if case != "equal" else (64, 40)
    sched, weighted, bounded, free, vecs = window_inputs(len(case), n, k, case)
    active = np.ones(k, dtype=bool)
    if case == "padded":
        npad, kpad = 512, 32
        sched = np.concatenate([sched, np.zeros(npad - n, bool)])
        weighted = np.concatenate([weighted, np.full(npad - n, I64_MIN, np.int64)])
        bounded = np.concatenate([bounded, np.zeros(npad - n, bool)])
        free = np.concatenate([free, np.zeros((npad - n, 4), np.int64)])
        vecs = np.concatenate([vecs, vecs[: kpad - k]])
        active = np.concatenate([active, np.zeros(kpad - k, bool)])
    args = (sched, weighted, bounded, free, vecs, active)
    with jax_drip.enable_x64():
        j_outs, j_free = jax_drip._drip_batch(*(jnp.asarray(a) for a in args),
                                              want_ties=want_ties)
        j_outs, j_free = np.asarray(j_outs), np.asarray(j_free)
    t_args = [torch.from_numpy(a.copy()) for a in args]
    p_outs, p_free = port_drip._drip_batch(*t_args, want_ties=want_ties)
    assert p_outs.dtype == torch.int64 and p_free.dtype == torch.int64
    assert np.array_equal(p_outs.numpy(), j_outs)
    assert np.array_equal(p_free.numpy(), j_free)
    assert np.array_equal(t_args[3].numpy(), free)  # the input carry is not written
    if case == "infeasible":
        assert (j_outs[:, 0] == -1).all() and (j_outs[:, 1] == 0).all()
    if case == "equal" and want_ties:
        assert (j_outs[:, 2] > 1).any()


def test_drip_batch_kernel_dispatch_and_carry(jax_drip):
    """``DripBatchKernel.dispatch`` over three windows with the carry kept
    (``mark_synced``) equals the JAX wrapper; a rejected window drops it."""
    sched, weighted, bounded, free, vecs = window_inputs(3, 200, 30, "random")
    jk, pk = jax_drip.DripBatchKernel(), port_drip.DripBatchKernel(device="cpu")
    host_j, host_p = free.copy(), free.copy()
    for w in range(3):
        window = vecs[w * 10:(w + 1) * 10]
        j = jk.dispatch(sched, weighted, bounded, host_j, window, want_ties=True)
        p = pk.dispatch(sched, weighted, bounded, host_p, window, want_ties=True)
        for a, b in zip(p, j):
            assert np.array_equal(a, b)
        for side, host, kern in (("jax", host_j, jk), ("port", host_p, pk)):
            for i, c in enumerate(j[0]):
                if c >= 0:
                    host[c] -= window[i]
            kern.mark_synced(host)
    assert pk.free_uploads == jk.free_uploads == 1
    assert np.array_equal(pk._free_dev.numpy(), np.asarray(jk._free_dev)[:200])
    pk.mark_desynced()
    pk.dispatch(sched, weighted, bounded, host_p, vecs[:3])
    assert pk.free_uploads == 2
    # one-shot entry, no tracker: fit never fails
    got = port_drip.drip_batch_dispatch(sched, weighted, None, None, vecs[:5], device="cpu")
    want = jax_drip.drip_batch_dispatch(sched, weighted, None, None, vecs[:5])
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


# -- the Scheduler, every path ------------------------------------------------------


@pytest.mark.parametrize("tie_seed", [None, 7])
@pytest.mark.parametrize("mode", ["scalar", "perpod", "queue4", "queue32", "drip8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_paths_match(jax_drip, seed, mode, tie_seed):
    """Fuzzed annotations (missing, stale, negative, hot) and allocatable
    (tight, unreported), mixed requests and interleaved daemonset pods."""
    rng = random.Random(seed)
    node_specs = fuzz_node_specs(rng, rng.choice([13, 37, 61]))
    pod_specs = fuzz_pod_specs(rng, 40)
    out = twin_run(jax_drip, mode, node_specs, pod_specs, seed=tie_seed)
    assert_twins_equal(out)
    if mode != "scalar" and any(spec[3] for spec in pod_specs):
        assert out["port"][1].drip_stats()["fallbacks"]["daemonset"] > 0


@pytest.mark.parametrize("mode", ["perpod", "queue16", "drip16"])
def test_seeded_ties_replay_and_consume_rng_identically(jax_drip, mode):
    """Ten equal nodes: every window holds real ties, so a seeded window
    replays per-pod; placements and the RNG stream equal the scalar loop
    and the JAX package."""
    specs = [(f"node-{i:02d}", {m: _anno(0.30, 30.0) for m in METRICS}, None)
             for i in range(10)]
    pods = [(f"p{i:03d}", 0, 0, False) for i in range(64)]
    out = twin_run(jax_drip, mode, specs, pods, seed=21)
    assert_twins_equal(out)
    scalar = twin_run(jax_drip, "scalar", specs, pods, seed=21)
    assert [r.node for r in out["port"][2]] == [r.node for r in scalar["port"][2]]
    assert out["port"][1]._tie_rng.getstate() == scalar["port"][1]._tie_rng.getstate()
    assert len({r.node for r in out["port"][2]}) > 1
    if mode != "perpod":
        assert out["port"][1].drip_stats()["batch"]["replays"] > 0


@pytest.mark.parametrize("mode", ["perpod", "queue32", "drip32"])
def test_concurrent_writer_mid_stream(jax_drip, mode):
    """Cluster writes between queue items (an annotation patch, a foreign
    bind, a new node) flush the open window; decisions still use columns
    valid at their enqueue point."""
    rng = random.Random(13)
    node_specs = fuzz_node_specs(rng, 17)
    pod_specs = fuzz_pod_specs(rng, 30)

    def feed(side, cluster, pods):
        m = MODULES[side]
        for i, pod in enumerate(pods):
            if i == 6:
                cluster.patch_node_annotation(node_specs[0][0], METRICS[0], _anno(0.95, 1.0))
            elif i == 13:
                cluster.add_pod(make_pod(side, "foreign", 100, 1 << 20,
                                         node_name=node_specs[1][0]))
            elif i == 20:
                cluster.add_node(m["Node"](
                    name="late", annotations={mm: _anno(0.05, 1.0) for mm in METRICS},
                    allocatable={"cpu": "2", "memory": "4Gi", "pods": "3"}))
            yield pod

    tels = {"jax": JaxTelemetry(), "port": PortTelemetry()}
    out = twin_run(jax_drip, mode, node_specs, pod_specs, feed=feed, tels=tels)
    # Both packages journal the annotation patch and the new node by name:
    # the patched row is re-read into the cached columns and trees, the new
    # node spliced in. Every column counter agrees, and so do both
    # consumers' crane_dirty_rows_total.
    assert_twins_equal(out, keys=STAT_KEYS + JOURNAL_KEYS)
    jst = out["jax"][1].drip_stats()
    assert jst["dirty_rows"] > 0 and jst["dirty_patches"] > 0
    reg = {s: t.registry.snapshot() for s, t in tels.items()}
    for consumer in ("drip", "fit"):
        key = f'crane_dirty_rows_total{{consumer="{consumer}"}}'
        assert reg["port"].get(key) == reg["jax"].get(key)
        assert reg["port"].get(key, 0) > 0
    if mode == "perpod":
        assert jst["topk_updates"] > 0  # the patched row re-read into the trees
    else:
        assert out["port"][1].drip_stats()["batch"]["dispatches"] >= 4


@pytest.mark.parametrize("mode", ["perpod", "queue8", "drip8"])
def test_rebind_routes_per_pod(jax_drip, mode):
    """The re-placed pod drops the fit column; its result's views still
    read the columns its decision was made on (tight nodes fail fit)."""
    specs = [(f"n{i:02d}", {m: _anno(0.1 + 0.05 * i, 30.0) for m in METRICS},
              {"cpu": "64", "memory": "256Gi", "pods": "500" if i % 2 else "1"})
             for i in range(6)]
    out = {}
    for side in ("jax", "port"):
        cluster = build_cluster(side, specs)
        sched = build_scheduler(side, cluster)
        mover = make_pod(side, "mover", 500, 1 << 20)
        cluster.add_pod(mover)
        first = sched.schedule_one(mover)
        rest = [make_pod(side, f"p{i}", 100, 1 << 20) for i in range(5)]
        for pod in rest:
            cluster.add_pod(pod)
        queue = rest[:2] + [cluster.get_pod(mover.key())] + rest[2:]
        out[side] = (cluster, sched, [first] + run_mode(side, mode, cluster, sched, queue))
    assert_twins_equal(out)
    assert out["port"][1].drip_stats()["drops"] == 1


@pytest.mark.parametrize("retries", [4, 0])
def test_conflict_retry_and_backpressure(jax_drip, retries):
    """Under ``conflict_retry`` a competing bind that lands while a window
    runs (here: inside the first two dispatches) drops the window and
    retries it at queue position; with no retries left it goes per-pod.
    ``bind_backpressure`` runs before every window."""
    rng = random.Random(6)
    node_specs = fuzz_node_specs(rng, 24)
    pod_specs = [spec[:3] + (False,) for spec in fuzz_pod_specs(rng, 20)]
    out, calls = {}, {}
    for side in ("jax", "port"):
        cluster = build_cluster(side, node_specs)
        sched = build_scheduler(side, cluster)
        sched.conflict_retry = True
        sched.max_window_retries = retries
        calls[side] = {"bp": 0, "cb": []}
        sched.bind_backpressure = lambda c=calls[side]: c.__setitem__("bp", c["bp"] + 1)
        sched.conflict_cb = calls[side]["cb"].append
        kern = (jax_drip.DripBatchKernel() if side == "jax"
                else port_drip.DripBatchKernel(device="cpu"))
        inner = kern.dispatch
        foreign = iter([make_pod(side, f"rival{i}", 1, 1, node_name=node_specs[i][0])
                        for i in range(2)])

        def dispatch(*args, inner=inner, foreign=foreign, cluster=cluster, **kw):
            result = inner(*args, **kw)
            pod = next(foreign, None)
            if pod is not None:
                cluster.add_pod(pod)  # a competing binder's bind
            return result

        kern.dispatch = dispatch
        sched._batch_kernel = kern
        pods = [make_pod(side, *spec) for spec in pod_specs]
        for pod in pods:
            cluster.add_pod(pod)
        out[side] = (cluster, sched, sched.schedule_queue(pods, window=8))
    assert_twins_equal(out)
    assert calls["port"]["bp"] == calls["jax"]["bp"] > 0
    assert calls["port"]["cb"] == calls["jax"]["cb"] == ["stale_window"] * 2
    batch = out["port"][1].drip_stats()["batch"]
    assert batch["conflicts"] == 2
    # with no retries left both conflicted windows went per-pod
    assert batch["pods"] == len(pod_specs) + (16 if retries else 0)


class NoopPlugin:
    name = "noop"

    def __init__(self, status):
        self._status = status

    def filter(self, state, pod, node_info):
        return self._status.success()


@pytest.mark.parametrize("mode", ["perpod", "queue8", "drip8"])
@pytest.mark.parametrize("kind", ["unknown_plugin", "daemonset", "scalar_request", "degraded",
                                  "no_fit"])
def test_fallbacks_match(jax_drip, kind, mode):
    rng = random.Random(3)
    node_specs = fuzz_node_specs(rng, 12)
    node_specs[0] = (node_specs[0][0], node_specs[0][1],
                     {"cpu": "8", "pods": "10", "example.com/gpu": "2"})
    pod_specs = [(f"p{i}", 10 * i, 1 << 20, kind == "daemonset" and i % 3 == 0)
                 for i in range(10)]
    extra = {"example.com/gpu": "1"} if kind == "scalar_request" else None

    def feed(side, cluster, pods):
        for i, pod in enumerate(pods):
            if extra and i % 4 == 1:
                pod = make_pod(side, f"gpu{i}", 100, 0, extra=extra)
                cluster.add_pod(pod)
            yield pod

    out = {}
    for side in ("jax", "port"):
        cluster = build_cluster(side, node_specs)
        sched = build_scheduler(side, cluster, degraded=Degraded() if kind == "degraded" else None,
                                fit=kind != "no_fit")
        if kind == "unknown_plugin":
            sched.register(NoopPlugin(Status if side == "jax" else PortStatus))
        pods = [make_pod(side, *spec) for spec in pod_specs]
        for pod in pods:
            cluster.add_pod(pod)
        out[side] = (cluster, sched, run_mode(side, mode, cluster, sched,
                                              list(feed(side, cluster, pods))))
    assert_twins_equal(out)
    stats = out["port"][1].drip_stats()
    if kind != "no_fit":
        assert stats["fallbacks"].get(kind, 0) > 0


@pytest.mark.parametrize("mode", ["perpod", "queue128", "queue32", "drip32"])
def test_pod_cap_fills_nodes(jax_drip, mode):
    """The chip run's traffic at small size: every node holds three pods,
    so the best nodes fill and later pods fold onto the next ones until
    the cluster is full and the rest are infeasible ("Too many pods")."""
    allocatable = {"cpu": "16", "memory": "64Gi", "ephemeral-storage": "100Gi", "pods": "3"}
    rng = random.Random(4)
    specs = [(f"node-{i:03d}", {m: _anno(round(rng.uniform(0, 0.6), 2), 30.0) for m in METRICS},
              allocatable) for i in range(120)]
    pods = [(f"p{i:04d}", 100, 128 << 20, False) for i in range(400)]
    out = twin_run(jax_drip, mode, specs, pods)
    assert_twins_equal(out)
    results = out["port"][2]
    assert sum(r.node is not None for r in results) == 360
    assert results[-1].reason.endswith("fit failure: Too many pods")
    stats = out["port"][1].drip_stats()
    assert stats["folds"] == 360 and not stats["fallbacks"]


@pytest.mark.parametrize("mode", ["scalar", "perpod", "queue8", "drip8"])
def test_empty_cluster(jax_drip, mode):
    out = twin_run(jax_drip, mode, [], [(f"p{i}", 100, 0, False) for i in range(5)], seed=3)
    assert_twins_equal(out)
    assert {r.reason for r in out["port"][2]} == {"no feasible nodes"}


def test_scores_views_match(jax_drip):
    rng = random.Random(9)
    node_specs = fuzz_node_specs(rng, 19)
    out = twin_run(jax_drip, "perpod", node_specs, [("solo", 100, 64 << 20, False)])
    j, p = out["jax"][2][0], out["port"][2][0]
    assert p.scores == j.scores and p.top_scores(50) == j.top_scores(50)
    scalar = twin_run(jax_drip, "scalar", node_specs, [("solo", 100, 64 << 20, False)])
    assert scalar["port"][2][0].scores == j.scores


# -- configuration ---------------------------------------------------------------


def test_build_scheduler_from_config_matches():
    text = (REPO / "deploy/dynamic/scheduler-config.yaml").read_bytes()
    policy_path = str(REPO / "deploy/dynamic/policy.yaml")
    jcfg, pcfg = jax_load_config(text), port_load_config(text)
    assert pcfg.api_version == jcfg.api_version
    jc, pcl = ClusterState(), pc.ClusterState()
    js = jax_build_from_config(jc, jcfg, policy=jax_load_policy(policy_path))
    ps = port_build_from_config(pcl, pcfg, policy=port_load_policy(policy_path), device="cpu")
    plugins = [(type(wp.plugin).__name__, wp.weight) for wp in js._plugins]
    assert [(type(wp.plugin).__name__, wp.weight) for wp in ps._plugins] == plugins
    assert plugins == [("ResourceFitPlugin", 1), ("DynamicPlugin", 3)]
    assert repr(ps._plugins[1].plugin.policy) == repr(js._plugins[1].plugin.policy)


def test_config_built_in_python_and_nrt_refused():
    profile = SchedulerProfile(filter_enabled=("Dynamic",),
                               score_enabled=(PluginWeight("Dynamic", 3),))
    sched = port_build_from_config(pc.ClusterState(), SchedulerConfiguration(profiles=(profile,)),
                                   policy=PORT_POLICY, device="cpu")
    assert [wp.weight for wp in sched._plugins] == [1, 3]
    assert sched._recognition() is not None
    # the NRT plugin is ported: refused only without a lister
    nrt = SchedulerProfile(score_enabled=(PluginWeight("NodeResourceTopologyMatch", 2),))
    config = SchedulerConfiguration(profiles=(nrt,))
    with pytest.raises(ValueError, match="no NRT lister"):
        port_build_from_config(pc.ClusterState(), config, policy=PORT_POLICY, device="cpu")
    from crane_scheduler_tpu_torch.topology import TopologyMatch
    from crane_scheduler_tpu_torch.topology.types import InMemoryNRTLister

    sched = port_build_from_config(pc.ClusterState(), config, nrt_lister=InMemoryNRTLister(),
                                   policy=PORT_POLICY, device="cpu")
    topo = sched._plugins[-1].plugin
    try:
        assert isinstance(topo, TopologyMatch) and sched._plugins[-1].weight == 2
        assert topo.cache._cleaner is not None and sched._recognition() is None
    finally:
        topo.cache.stop_cleaner()
