"""The overlapped pipelined loops: ``schedule_batches_pipelined`` and
``schedule_bursts_pipelined`` with ``overlap_refresh`` (background
double-buffered ingest) and ``overlap_bind`` (coalescing background bind
flush), and ``bind=False``, against the JAX package's loops on twin
clusters made from one seed.

Tolerance: identical assignments, ``node_idx``, bound counts and
scheduling versions; worker errors surface in the scheduling thread.
"""

import random
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crane_scheduler_tpu.cluster import ClusterState, Node, Pod
from crane_scheduler_tpu.framework.scheduler import BatchScheduler
from crane_scheduler_tpu.policy import DEFAULT_POLICY
from crane_scheduler_tpu.utils import format_local_time
from crane_scheduler_tpu_torch import cluster as port_cluster
from crane_scheduler_tpu_torch.framework.scheduler import BatchScheduler as PortScheduler
from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY as PORT_POLICY

NOW = 1753776000.0
METRICS = [sp.name for sp in DEFAULT_POLICY.spec.sync_period]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is faster here and leaves the
    other test workers their cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Clock:
    def __init__(self):
        self.t = NOW

    def __call__(self):
        return self.t


def annotations(n_nodes, seed):
    rng = random.Random(seed)
    out = []
    for i in range(n_nodes):
        anno = {m: f"{rng.random():.5f},{format_local_time(NOW - rng.choice([0, 30, 481]))}"
                for m in METRICS}
        anno["node_hot_value"] = f"{rng.choice(['0', '1', '2', '0.35'])},{format_local_time(NOW)}"
        out.append((f"node-{i:03d}", anno))
    return out


def port_twin(n_nodes, seed, dtype="f32"):
    cluster = port_cluster.ClusterState()
    for name, anno in annotations(n_nodes, seed):
        cluster.add_node(port_cluster.Node(name=name, annotations=dict(anno)))
    return PortScheduler(cluster, PORT_POLICY, clock=Clock(), snapshot_bucket=64, device="cpu",
                         dtype={"f32": torch.float32, "f64": torch.float64}[dtype])


def jax_twin(n_nodes, seed, dtype="f32"):
    cluster = ClusterState()
    for name, anno in annotations(n_nodes, seed):
        cluster.add_node(Node(name=name, annotations=dict(anno)))
    return BatchScheduler(cluster, DEFAULT_POLICY, clock=Clock(), snapshot_bucket=64,
                          dtype={"f32": jnp.float32, "f64": jnp.float64}[dtype])


def bursts(tag, k=5, size=40):
    return [("ns", [f"{tag}{c}-{i}" for i in range(size + 7 * c)]) for c in range(k)]


def pod_batches(pod_cls, tag, k=5, size=40):
    return [[pod_cls(name=f"{tag}{c}-{i}", namespace="ns") for i in range(size + 7 * c)]
            for c in range(k)]


def run(sched, loop, tag, **kw):
    """One pipelined run; a batch loop's pods are added to the cluster
    first, as a real caller's pending pods are."""
    if loop == "bursts":
        return [np.asarray(r.node_idx).tolist()
                for r in sched.schedule_bursts_pipelined(bursts(tag), **kw)]
    pod_cls = Pod if isinstance(sched, BatchScheduler) else port_cluster.Pod
    batches = pod_batches(pod_cls, tag)
    for b in batches:
        sched.cluster.add_pods(b)
    return [(r.assignments, r.unassigned)
            for r in sched.schedule_batches_pipelined(batches, **kw)]


def slow_listing(sched, seconds=0.05):
    real = sched.cluster.list_nodes

    def slow(*a, **k):
        time.sleep(seconds)
        return real(*a, **k)

    sched.cluster.list_nodes = slow


@pytest.mark.parametrize("loop", ["bursts", "batches"])
def test_overlap_refresh_matches_blocking_loop_and_counts_hits(loop):
    """With a slow cluster listing, the overlapped loop does not wait on
    the in-flight refresh (``overlap_hits`` > 0) and places exactly as
    the blocking loop and the JAX package's loop do while annotations
    stay static."""
    p = port_twin(48, seed=1)
    slow_listing(p)
    got = run(p, loop, "o", depth=2, overlap_refresh=True)
    assert p.refresh_stats["overlap_hits"] > 0
    blocking = port_twin(48, seed=1)
    assert got == run(blocking, loop, "o", depth=2)
    assert blocking.refresh_stats["overlap_hits"] == 0
    j = jax_twin(48, seed=1)
    assert got == run(j, loop, "o", depth=2)
    assert p.cluster.count_pods_all() == j.cluster.count_pods_all()
    assert p.cluster.sched_version == j.cluster.sched_version


@pytest.mark.parametrize("loop", ["bursts", "batches"])
def test_overlap_refresh_surfaces_worker_errors(loop):
    p = port_twin(16, seed=2)
    calls = {"n": 0}

    def boom():
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("ingest exploded")

    p.refresh = boom
    with pytest.raises(RuntimeError, match="ingest exploded"):
        # the error lands on a tick after the failing background refresh
        if loop == "bursts":
            list(p.schedule_bursts_pipelined(
                [("ns", [f"p{k}"]) for k in range(8)], depth=1, overlap_refresh=True,
                bind=False))
        else:
            list(p.schedule_batches_pipelined(
                [[port_cluster.Pod(name=f"p{k}")] for k in range(8)], depth=1,
                overlap_refresh=True, bind=False))


@pytest.mark.parametrize("loop", ["bursts", "batches"])
def test_overlap_bind_matches_synchronous_flush_and_jax(loop):
    """``overlap_bind`` moves only the flush timing: placements, bound
    rows and counts equal the synchronous flush and the JAX package's,
    and every result has settled once the generator is consumed."""
    p = port_twin(64, seed=3)
    got = run(p, loop, "b", depth=2, overlap_bind=True, bind_window_s=0.02)
    stats = p.bind_flush_stats
    assert stats["windows"] >= 1 and stats["flushed_pods"] == sum(
        len(n) for _, n in bursts("b"))
    sync = port_twin(64, seed=3)
    assert got == run(sync, loop, "b", depth=2)
    assert sync.bind_flush_stats is None
    j = jax_twin(64, seed=3)
    assert got == run(j, loop, "b", depth=2, overlap_bind=True, bind_window_s=0.02)
    for sched in (p, sync):
        assert sched.cluster.count_pods_all() == j.cluster.count_pods_all()
        assert sched.cluster.sched_version == j.cluster.sched_version
    if loop == "bursts":
        results = list(p.schedule_bursts_pipelined(bursts("s"), depth=3, overlap_bind=True))
        for r in results:  # settled: every placed row bound
            assert r.bound_rows is not None
            assert len(r.bound_rows) == int((np.asarray(r.node_idx) >= 0).sum()) > 0


def test_overlap_bind_with_watermark_and_both_overlaps():
    p = port_twin(64, seed=4)
    slow_listing(p, 0.02)
    got = run(p, "bursts", "w", depth=4, overlap_refresh=True, overlap_bind=True,
              bind_watermark_pods=30)
    j = jax_twin(64, seed=4)
    assert got == run(j, "bursts", "w", depth=4)
    assert p.cluster.count_pods_all() == j.cluster.count_pods_all()


def test_overlap_bind_surfaces_flush_errors():
    p = port_twin(16, seed=5)

    def refuse(*a, **k):
        raise RuntimeError("bind refused")

    p.cluster.bind_burst = refuse
    with pytest.raises(RuntimeError, match="bind refused"):
        list(p.schedule_bursts_pipelined(bursts("e", k=3, size=5), depth=2, overlap_bind=True))


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_schedule_batches_pipelined_matches_jax(dtype, depth):
    p, j = port_twin(80, seed=6, dtype=dtype), jax_twin(80, seed=6, dtype=dtype)
    for k in range(2):
        got = run(p, "batches", f"q{k}", depth=depth)
        assert got == run(j, "batches", f"q{k}", depth=depth)
        p._clock.t += 17.0
        j._clock.t += 17.0
    assert p.cluster.count_pods_all() == j.cluster.count_pods_all()
    assert [e.message for e in p.cluster.list_events()] == [
        e.message for e in j.cluster.list_events()]


def test_bind_false_leaves_the_cluster_unchanged():
    """``bind=False`` scores and places without binding, in all four
    entry points, exactly as the JAX package does."""
    p, j = port_twin(40, seed=7), jax_twin(40, seed=7)
    v0 = p.cluster.sched_version
    names = [f"n-{i}" for i in range(70)]
    got = p.schedule_pod_burst("ns", names, bind=False)
    want = j.schedule_pod_burst("ns", names, bind=False)
    np.testing.assert_array_equal(got.node_idx, np.asarray(want.node_idx))
    assert got.bound_rows is None and want.bound_rows is None
    pods = [port_cluster.Pod(name=n, namespace="ns") for n in names]
    got_b = p.schedule_batch(pods, bind=False)
    want_b = j.schedule_batch([Pod(name=n, namespace="ns") for n in names], bind=False)
    assert got_b.assignments == want_b.assignments and len(got_b.assignments) == 70
    assert run(p, "bursts", "nb", bind=False) == run(j, "bursts", "nb", bind=False)
    assert run(p, "batches", "nb", bind=False) == run(j, "batches", "nb", bind=False)
    assert p.cluster.sched_version == v0
    assert p.cluster.count_pods_all() == {}
