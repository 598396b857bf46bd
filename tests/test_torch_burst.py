"""The slice end to end on the CPU: the port's ``BatchScheduler`` against
the JAX package's on twin clusters.

Both clusters are built from one seed (about 300 nodes with fresh,
stale, missing, negative, NaN and near-threshold annotations) and take
the same bursts (about 600 pods) at the same clock readings. Tolerance:
identical assignments, node indices, verdicts and scores.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crane_scheduler_tpu.cluster import ClusterState, Node, Pod
from crane_scheduler_tpu.framework.scheduler import BatchScheduler
from crane_scheduler_tpu.policy import DEFAULT_POLICY
from crane_scheduler_tpu.utils import format_local_time
from crane_scheduler_tpu_torch import cluster as port_cluster
from crane_scheduler_tpu_torch.convert import policy_tensors_from_numpy, snapshot_from_numpy
from crane_scheduler_tpu_torch.framework.scheduler import BatchScheduler as PortScheduler
from crane_scheduler_tpu_torch.parallel.step import COMPACT_MAX_PODS, ScheduleStep
from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY as PORT_POLICY
from crane_scheduler_tpu_torch.policy import compile_policy as port_compile_policy
from crane_scheduler_tpu_torch.scorer.parity import check_placement_parity

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


def annotations(n_nodes, seed):
    rng = random.Random(seed)
    out = []
    for i in range(n_nodes):
        anno = {}
        for m in METRICS:
            roll = rng.random()
            if roll < 0.05:
                continue
            age = rng.choice([0, 30, 30, 30, 170, 479, 481, 2000])
            if roll < 0.08:
                val = rng.choice(["NaN", "-0.3", "bogus"])
            elif roll < 0.3:
                val = rng.choice(["0.64999", "0.65", "0.65001", "0.74999", "0.75001"])
            else:
                val = f"{rng.random():.5f}"
            anno[m] = f"{val},{format_local_time(NOW - age)}"
        if rng.random() < 0.8:
            hv = rng.choice(["0", "1", "2", "0.1", "0.35", "3"])
            anno["node_hot_value"] = f"{hv},{format_local_time(NOW - rng.choice([0, 60, 299, 301]))}"
        out.append((f"node-{i:04d}", anno))
    return out


class Clock:
    def __init__(self):
        self.t = NOW

    def __call__(self):
        return self.t


def twins(n_nodes, seed, dtype):
    jax_dtype, port_dtype = {"f64": (jnp.float64, torch.float64),
                             "f32": (jnp.float32, torch.float32)}[dtype]
    annos = annotations(n_nodes, seed)
    jc, pc = ClusterState(), port_cluster.ClusterState()
    for name, anno in annos:
        jc.add_node(Node(name=name, annotations=dict(anno)))
        pc.add_node(port_cluster.Node(name=name, annotations=dict(anno)))
    clock = Clock()
    j = BatchScheduler(jc, DEFAULT_POLICY, dtype=jax_dtype, clock=clock, snapshot_bucket=128)
    p = PortScheduler(pc, PORT_POLICY, dtype=port_dtype, clock=clock,
                      snapshot_bucket=128, device="cpu")
    return j, p, clock


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_schedule_batch_matches_jax(dtype):
    j, p, clock = twins(300, seed=21, dtype=dtype)
    for cycle, count in enumerate((600, 250)):
        names = [f"c{cycle}-p{i}" for i in range(count)]
        jp = [Pod(name=n, namespace="ns") for n in names]
        pp = [port_cluster.Pod(name=n, namespace="ns") for n in names]
        j.cluster.add_pods(jp)
        p.cluster.add_pods(pp)
        want = j.schedule_batch(jp)
        got = p.schedule_batch(pp)
        assert got.assignments == want.assignments
        assert got.unassigned == want.unassigned
        assert got.scores == want.scores
        assert got.schedulable == want.schedulable
        assert p.cluster.count_pods_all() == j.cluster.count_pods_all()
        clock.t += 7.0


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_schedule_pod_burst_matches_jax(dtype):
    """Three bursts with the clock advancing between them (the hybrid hit
    path refreshes its rescue rows), each checked against the JAX package
    and against the exact f64 placement gate."""
    j, p, clock = twins(300, seed=22, dtype=dtype)
    for cycle, count in enumerate((600, 600, 90)):
        names = [f"b{cycle}-{i}" for i in range(count)]
        want = j.schedule_pod_burst("ns", names)
        got = p.schedule_pod_burst("ns", names)
        np.testing.assert_array_equal(got.node_idx, want.node_idx)
        np.testing.assert_array_equal(got.scores_row, np.asarray(want.scores_row))
        np.testing.assert_array_equal(got.schedulable_row, np.asarray(want.schedulable_row))
        assert got.node_table == want.node_table
        assert got.assignments == want.assignments
        assert p.cluster.sched_version == j.cluster.sched_version
        snap = p.store.snapshot(bucket=128)
        n = snap.n_nodes
        idx = got.node_idx
        check_placement_parity(
            values=snap.values[:n], ts=snap.ts[:n], hot_value=snap.hot_value[:n],
            hot_ts=snap.hot_ts[:n], node_valid=snap.node_valid[:n], now=got.now,
            tensors=p.tensors, schedulable=got.schedulable_row,
            scores=got.scores_row, counts=np.bincount(idx[idx >= 0], minlength=n),
            num_pods=count, unassigned=int((idx < 0).sum()),
        )
        clock.t += 11.0
    if dtype == "f32":
        assert p.refresh_stats["hit"] == 2 and p.refresh_stats["full"] == 1
        assert p.refresh_stats["risk_rescan_rows"] > 0


def test_pipelined_bursts_match_jax_at_depth_4():
    j, p, clock = twins(200, seed=23, dtype="f32")
    bursts = [("ns", [f"q{k}-{i}" for i in range(120 + 40 * k)]) for k in range(5)]

    def run(sched):
        out = []
        for r in sched.schedule_bursts_pipelined(list(bursts), depth=4):
            out.append(r.node_idx.copy())
        return out

    for a, b in zip(run(j), run(p)):
        np.testing.assert_array_equal(a, b)
    assert p.cluster.count_pods_all() == j.cluster.count_pods_all()


def test_node_removal_between_bursts_matches_jax():
    """Deleting nodes between bursts takes the store's prune (swap-remove)
    and a full re-upload; placements, node tables and bound counts stay
    identical to the JAX package's."""
    j, p, clock = twins(160, seed=27, dtype="f32")
    for cycle, gone in enumerate(((), ("node-0003", "node-0150"), ("node-0159",))):
        for name in gone:
            j.cluster.delete_node(name)
            p.cluster.delete_node(name)
        names = [f"r{cycle}-{i}" for i in range(300)]
        want = j.schedule_pod_burst("ns", names)
        got = p.schedule_pod_burst("ns", names)
        assert got.node_table == want.node_table
        assert not set(gone) & set(got.node_table)
        np.testing.assert_array_equal(got.node_idx, want.node_idx)
        assert p.cluster.sched_version == j.cluster.sched_version
        clock.t += 5.0
    assert p.refresh_stats["full"] == 3
    assert p.cluster.count_pods_all() == j.cluster.count_pods_all()


def test_bind_events_match_jax():
    """Both bind paths stamp the same ``Scheduled`` events (message,
    resourceVersion, time) as the JAX package, the contract the reference
    annotator parses."""
    j, p, clock = twins(120, seed=28, dtype="f64")
    names = [f"e-{i}" for i in range(90)]
    j.cluster.add_pods([Pod(name=n, namespace="ns") for n in names])
    p.cluster.add_pods([port_cluster.Pod(name=n, namespace="ns") for n in names])
    j.schedule_batch([Pod(name=n, namespace="ns") for n in names])
    p.schedule_batch([port_cluster.Pod(name=n, namespace="ns") for n in names])
    clock.t += 3.0
    burst = [f"eb-{i}" for i in range(250)]
    j.schedule_pod_burst("ns", burst)
    p.schedule_pod_burst("ns", burst)

    def fields(events):
        return [(e.namespace, e.name, e.reason, e.message, e.count,
                 e.last_timestamp, e.resource_version) for e in events]

    got = fields(p.cluster.list_events())
    assert got == fields(j.cluster.list_events())
    assert len(got) == 340 and got[-1][-1] == 340


def test_compact_packed_layout_matches_wide():
    _, p, clock = twins(97, seed=24, dtype="f32")
    p.refresh()
    prepared = p._prepare(clock())
    step = p._step
    vecs = step._args(prepared, clock())
    num_pods = 513
    wide = step._step_packed(vecs, num_pods).numpy()
    compact = step._step_packed_compact(vecs, num_pods).numpy().view(np.uint32)
    assert wide.dtype == np.int32 and compact.dtype == np.uint32
    assert compact.nbytes * 3 < wide.nbytes + 24
    n = p._prepared_n
    for a, b in zip(step.unpack(wide, n), step.unpack(compact, n)):
        np.testing.assert_array_equal(a, b)
    assert step.packed(prepared, num_pods, now=clock()).result().dtype == np.uint32
    assert step.packed(prepared, COMPACT_MAX_PODS, now=clock()).result().dtype == np.int32
    # bit-field extremes survive the int64 build and the int32 storage
    words = np.array([(COMPACT_MAX_PODS - 1) | (100 << 18) | (1 << 31), 0, 5, 0xFFFFFFFF],
                     dtype=np.uint32)
    sched, scores, counts, unassigned, waterline = ScheduleStep.unpack(words, 2)
    assert counts.tolist() == [COMPACT_MAX_PODS - 1, 0] and scores.tolist() == [100, 0]
    assert sched.tolist() == [True, False] and unassigned == 5 and waterline == -1


def test_with_overrides_incremental_equals_full_rescan():
    """The hit path's incremental rescue-row refresh (index_copy into the
    device vectors) equals a full f64 risk scan at every later time."""
    from crane_scheduler_tpu_torch.scorer.hybrid import compute_overrides

    _, p, clock = twins(150, seed=25, dtype="f32")
    p.refresh()
    prepared = p._prepare(clock())
    snap = p._prepared_snap
    step = p._step
    for dt in (1.0, 60.0, 200.0, 400.0):
        inc = step.with_overrides(prepared, snap, NOW + dt)
        full = compute_overrides(
            p.tensors, snap.values, snap.ts, snap.hot_value, snap.hot_ts,
            snap.node_valid, NOW + dt, rebase_age=dt,
        )
        for dev, host in zip((inc.ovr_mask, inc.ovr_sched, inc.ovr_score), full[:3]):
            np.testing.assert_array_equal(dev.numpy(), host)
        assert inc.ovr_rescan_rows < snap.values.shape[0]
        prepared = inc
    with pytest.raises(ValueError, match="stale"):
        step(prepared, 10, now=NOW + 999.0)


def test_convert_round_trips_policy_and_snapshot():
    j, p, _ = twins(40, seed=26, dtype="f64")
    j.refresh()
    jsnap = j.store.snapshot(bucket=64)
    psnap = snapshot_from_numpy({k: getattr(jsnap, k) for k in (
        "values", "ts", "hot_value", "hot_ts", "node_valid", "n_nodes", "node_names")})
    p.refresh()
    own = p.store.snapshot(bucket=64)
    for k in ("values", "ts", "hot_value", "hot_ts", "node_valid"):
        np.testing.assert_array_equal(getattr(psnap, k), getattr(own, k))
    assert psnap.node_names == own.node_names and psnap.n_nodes == own.n_nodes
    converted = policy_tensors_from_numpy(vars(j.tensors))
    native = port_compile_policy(PORT_POLICY)
    assert converted.metric_names == native.metric_names
    np.testing.assert_array_equal(converted.prio_weight, native.prio_weight)
    with pytest.raises(KeyError):
        snapshot_from_numpy({"values": jsnap.values})
