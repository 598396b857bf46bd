"""The node mesh and the tiled scheduling step against the JAX package.

The reference runs on the suite's 8 virtual CPU devices (``conftest``);
the port tiles the node axis over the same number of CPU tiles
(``make_node_mesh(S, [cpu] * S)``). Inputs are one seed's annotations
(fresh, stale, missing, near-threshold values, hot values) in both
packages' stores. Tolerance: identical packed words (compact and wide),
unpacked verdicts, scores, counts, unassigned count and waterline, and
identical placements from ``BatchScheduler(mesh=)``.
"""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crane_scheduler_tpu.cluster import ClusterState, Node, Pod
from crane_scheduler_tpu.framework.scheduler import BatchScheduler
from crane_scheduler_tpu.loadstore import NodeLoadStore
from crane_scheduler_tpu.parallel import ShardedScheduleStep as RefStep
from crane_scheduler_tpu.parallel import make_node_mesh as ref_mesh
from crane_scheduler_tpu.parallel import mesh_shape as ref_mesh_shape
from crane_scheduler_tpu.parallel import round_up_to_shards as ref_round_up
from crane_scheduler_tpu.policy import DEFAULT_POLICY, compile_policy
from crane_scheduler_tpu.utils import format_local_time
from crane_scheduler_tpu_torch import cluster as pc
from crane_scheduler_tpu_torch.convert import tiled_snapshot_from_shards
from crane_scheduler_tpu_torch.framework.scheduler import BatchScheduler as PortBatch
from crane_scheduler_tpu_torch.loadstore import NodeLoadStore as PortStore
from crane_scheduler_tpu_torch.parallel import (
    ScheduleStep,
    ShardedScheduleStep,
    TiledSnapshot,
    make_node_mesh,
    make_placement_mesh,
    mesh_shape,
    node_tiles,
    round_up_to_shards,
)
from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY as PORT_POLICY
from crane_scheduler_tpu_torch.policy import compile_policy as port_compile
from crane_scheduler_tpu_torch.scorer.batched import BatchedScorer
from crane_scheduler_tpu_torch.scorer.hybrid import score_rows_f64

NOW = 1753776000.0
TENSORS = compile_policy(DEFAULT_POLICY)
PORT_TENSORS = port_compile(PORT_POLICY)
CPU = torch.device("cpu")
DTYPES = {"f64": (jnp.float64, torch.float64), "f32h": (jnp.float32, torch.float32)}
MODES = {"plain": {}, "combined": {"dynamic_weight": 3, "max_offset": 200}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def cpu_mesh(s):
    return make_node_mesh(s, [CPU] * s)


def annotations(n, seed, boundary=False):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        anno = {}
        for m in TENSORS.metric_names:
            if rng.random() < 0.1:
                continue
            if boundary:
                v = rng.choice([0.65, 0.6500001, 0.6499999, 0.7499999, 0.31, 0.9])
                anno[m] = f"{v:.7f},{format_local_time(NOW)}"
            else:
                v = rng.choice([0.1, 0.3, 0.5, 0.64, 0.66, 0.9])
                age = rng.choice([0, 100, 600])
                anno[m] = f"{v:.5f},{format_local_time(NOW - age)}"
        if rng.random() < 0.5:
            hv = rng.choice(["0", "1", "2", "0.1", "0.19999", "4"])
            anno["node_hot_value"] = f"{hv},{format_local_time(NOW)}"
        out.append((f"node-{i:04d}", anno))
    return out


def twin_snaps(annos, bucket=64):
    ref, port = NodeLoadStore(TENSORS), PortStore(PORT_TENSORS)
    for name, anno in annos:
        ref.ingest_node_annotations(name, dict(anno))
        port.ingest_node_annotations(name, dict(anno))
    return ref.snapshot(bucket=bucket), port.snapshot(bucket=bucket)


def gang_vectors(n):
    gidx = np.arange(n)
    return 1 + (gidx % 5).astype(np.int64), ((gidx * 37) % 201).astype(np.int32)


def steps(s, dtype, mode):
    jdt, pdt = DTYPES[dtype]
    kw = MODES[mode]
    ref = RefStep(TENSORS, ref_mesh(s), dtype=jdt, hybrid=dtype == "f32h", **kw)
    port = ShardedScheduleStep(PORT_TENSORS, cpu_mesh(s), dtype=pdt, **kw)
    return ref, port


def assert_results(got, want, n=None):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        if n is not None and g.ndim:
            g, w = g[:n], w[:n]
        np.testing.assert_array_equal(g, w)


# -- mesh helpers ------------------------------------------------------------------


def test_mesh_helpers_match_reference(monkeypatch):
    for s in (1, 2, 4, 8):
        mesh = cpu_mesh(s)
        assert mesh_shape(mesh) == ref_mesh_shape(ref_mesh(s))
        for n in (0, 1, 7, 64, 100, 51_200):
            assert round_up_to_shards(n, mesh) == ref_round_up(n, ref_mesh(s))
        tiles = node_tiles(mesh, 64)
        assert [(a, b) for _, a, b in tiles] == [(t * 64 // s, (t + 1) * 64 // s)
                                                 for t in range(s)]
    assert make_placement_mesh(2, [CPU] * 8).devices == (CPU, CPU)
    with pytest.raises(ValueError) as want:
        ref_mesh(9)
    with pytest.raises(ValueError) as got:
        make_node_mesh(9, [CPU] * 8)
    assert str(got.value) == str(want.value) == "requested 9 devices, only 8 available"
    with pytest.raises(ValueError, match="multiple of the mesh size 4"):
        node_tiles(cpu_mesh(4), 10)
    # no GPU: the default mesh never turns into CPU tiles
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_node_mesh()
    with pytest.raises(ValueError, match="requested 2 devices, only 0 available"):
        make_node_mesh(2)


def test_indivisible_node_axis_raises_like_reference():
    ref_snap, port_snap = twin_snaps(annotations(10, 1), bucket=10)
    ref, port = steps(4, "f64", "plain")
    with pytest.raises(ValueError, match="divisible by 4"):
        ref.prepare(ref_snap, NOW)
    with pytest.raises(ValueError, match="multiple of the mesh size 4"):
        port.prepare(port_snap, NOW)


# -- the tiled step ------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_step_matches_reference(s, dtype, mode):
    """Packed (compact and wide) and unpacked results equal the reference's
    ``ShardedScheduleStep`` on as many devices, and the port's one-device
    ``ScheduleStep``."""
    ref_snap, port_snap = twin_snaps(annotations(100, 7 + s), bucket=64)
    ref, port = steps(s, dtype, mode)
    n = port_snap.values.shape[0]
    cap, off = gang_vectors(n)
    kw = {} if mode == "plain" else {"capacity": cap, "offsets": off}
    rp, pp = ref.prepare(ref_snap, NOW, **kw), port.prepare(port_snap, NOW, **kw)
    assert isinstance(pp, TiledSnapshot) == (s > 1)
    assert pp.rows() == n
    single = ScheduleStep(PORT_TENSORS, dtype=DTYPES[dtype][1], device="cpu",
                          **MODES[mode])
    sp = single.prepare(port_snap, NOW, **kw)
    for pods in (0, 300, 1 << 18):
        want = np.asarray(ref.packed(rp, pods))
        got = port.packed(pp, pods).result()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(single.packed(sp, pods).result(), want)
    res = port(pp, 123)
    want = ref(rp, 123)
    assert_results([res.schedulable, res.scores, res.counts],
                   [want.schedulable, want.scores, want.counts])
    assert int(res.unassigned) == int(want.unassigned)
    assert int(res.waterline) == int(want.waterline)
    unpacked = port.unpack(port.packed(pp, 123).result(), port_snap.n_nodes)
    assert_results(unpacked[:3], [np.asarray(x) for x in
                                  (want.schedulable, want.scores, want.counts)],
                   n=port_snap.n_nodes)


def test_global_n_token_clip_binds():
    """``(2^31-1) // N`` with the global ``N``: at ``2^31-1`` pods every
    schedulable node takes the clip, which a tile's own length would set
    eight times higher."""
    ref_snap, port_snap = twin_snaps(annotations(64, 3), bucket=64)
    ref, port = steps(8, "f64", "plain")
    pods = 2**31 - 1
    want = np.asarray(ref.packed(ref.prepare(ref_snap, NOW), pods))
    got = port.packed(port.prepare(port_snap, NOW), pods).result()
    np.testing.assert_array_equal(got, want)
    sched, _scores, counts, unassigned, _ = port.unpack(got, 64)
    clip = (2**31 - 1) // 64
    assert counts[sched].max() == clip and (counts[sched] == clip).all()
    assert unassigned == pods - clip * int(sched.sum())


@pytest.mark.parametrize("n_nodes,num_pods", [(16, 10), (100, 333), (256, 0)])
def test_sharded_matches_single_device(n_nodes, num_pods):
    """``test_sharded.py``'s case on eight tiles: equal to the one-device
    step and to the reference."""
    ref_snap, port_snap = twin_snaps(annotations(n_nodes, n_nodes), bucket=64)
    ref, port = steps(8, "f64", "plain")
    res = port(port.prepare(port_snap, NOW), num_pods)
    single = ScheduleStep(PORT_TENSORS, dtype=torch.float64, device="cpu")
    one = single(single.prepare(port_snap, NOW), num_pods)
    want = ref(ref.prepare(ref_snap, NOW), num_pods)
    for r in (one, want):
        assert_results([res.schedulable, res.scores, res.counts],
                       [r.schedulable, r.scores, r.counts])
        assert int(res.unassigned) == int(r.unassigned)


def test_now_override_rescores_cached_snapshot():
    ref_snap, port_snap = twin_snaps(annotations(64, 8), bucket=64)
    later = NOW + 240.0
    for dtype in DTYPES:
        _, port = steps(8, dtype, "plain")
        cached = port.prepare(port_snap, NOW)
        if port.hybrid:
            cached = port.with_overrides(cached, port_snap, later)
        fresh = port.prepare(port_snap, later)
        a, b = port(cached, 10, now=later), port(fresh, 10)
        assert_results([a.scores, a.schedulable], [b.scores, b.schedulable])


# -- hybrid (the ports of test_hybrid_sharded.py) -------------------------------------


def f64_reference(snap, now=NOW):
    sched64, score64 = score_rows_f64(snap.values, snap.ts, snap.hot_value, snap.hot_ts,
                                      now, PORT_TENSORS)
    valid = np.asarray(snap.node_valid)
    return sched64 & valid, np.where(valid, score64, 0)


@pytest.mark.parametrize("seed", range(3))
def test_hybrid_step_bit_parity(seed):
    ref_snap, port_snap = twin_snaps(annotations(400, seed, boundary=True), bucket=128)
    ref, port = steps(8, "f32h", "plain")
    got = port(port.prepare(port_snap, NOW), 900)
    sched64, score64 = f64_reference(port_snap)
    assert_results([got.schedulable, got.scores], [sched64, score64])
    want = ref(ref.prepare(ref_snap, NOW), 900)
    assert_results([got.counts], [want.counts])
    assert int(got.waterline) == int(want.waterline)


def test_plain_f32_step_diverges_hybrid_does_not():
    store = PortStore(PORT_TENSORS)
    fresh = format_local_time(NOW)
    store.ingest_node_annotations("edge", {"cpu_usage_avg_5m": f"0.6500000001,{fresh}"})
    store.ingest_node_annotations("ok", {m: f"0.30000,{fresh}" for m in TENSORS.metric_names})
    snap = store.snapshot(bucket=8)
    plain = BatchedScorer(PORT_TENSORS, dtype=torch.float32, device=CPU)
    got = plain(snap.values, snap.ts, snap.hot_value, snap.hot_ts, snap.node_valid, NOW)
    assert bool(got.schedulable[0])  # plain f32 wrongly passes
    for s in (1, 4):
        hybrid = ShardedScheduleStep(PORT_TENSORS, cpu_mesh(s), dtype=torch.float32)
        res = hybrid(hybrid.prepare(snap, NOW), 4)
        sched64, score64 = f64_reference(snap)
        assert not sched64[0]
        assert_results([res.schedulable, res.scores], [sched64, score64])
        assert int(res.counts[0]) == 0


def test_hybrid_now_override_requires_refresh():
    _, port_snap = twin_snaps(annotations(50, 2, boundary=True), bucket=64)
    _, port = steps(4, "f32h", "plain")
    prepared = port.prepare(port_snap, NOW)
    with pytest.raises(ValueError, match="stale"):
        port(prepared, 10, now=NOW + 120.0)
    refreshed = port.with_overrides(prepared, port_snap, NOW + 120.0)
    res = port(refreshed, 10, now=NOW + 120.0)
    sched64, score64 = f64_reference(port_snap, NOW + 120.0)
    assert_results([res.schedulable, res.scores], [sched64, score64])
    assert refreshed.values is prepared.values  # only the rescue vectors moved


@pytest.mark.parametrize("age", [4 * 3600.0, 7 * 3600.0])
def test_hybrid_parity_survives_cached_snapshot_aging(age):
    later = NOW + age
    annos = [(f"n{i}", {"cpu_usage_avg_5m": f"0.9,{format_local_time(later - 480.0 + d)}"})
             for i, d in enumerate([-1.0, -1e-4, 0.0, 1e-4, 1.0, -0.5e-3, 0.5e-3, 123.4])]
    ref_snap, port_snap = twin_snaps(annos, bucket=16)
    ref, port = steps(4, "f32h", "plain")
    prepared = port.prepare(port_snap, NOW)
    refreshed = port.with_overrides(prepared, port_snap, later)
    res = port(refreshed, 8, now=later)
    assert_results([res.schedulable, res.scores], f64_reference(port_snap, later))
    rp = ref.with_overrides(ref.prepare(ref_snap, NOW), ref_snap, later)
    np.testing.assert_array_equal(port.packed(refreshed, 8, now=later).result(),
                                  np.asarray(ref.packed(rp, 8, now=later)))
    if age > 6 * 3600.0:
        assert refreshed.epoch == later
    else:
        assert refreshed.epoch == NOW and refreshed.ts is prepared.ts


def test_incremental_overrides_scatter_into_tiles():
    """A changed row lands in its own tile: the incremental rescan's
    scatter equals a full prepare at the same ``now``."""
    annos = annotations(128, 5, boundary=True)
    _, port_snap = twin_snaps(annos, bucket=128)
    _, port = steps(4, "f32h", "plain")
    prepared = port.prepare(port_snap, NOW)
    rows = np.array([0, 31, 32, 77, 127])
    for r in rows:
        port_snap.values[r, 0] = 0.6500001
    got = port.with_overrides(prepared, port_snap, NOW + 1.0, force=True, dirty_rows=rows)
    full = port.prepare(port_snap, NOW)
    full = port.with_overrides(full, port_snap, NOW + 1.0)
    # the device matrices of `got` are the old ones: compare verdicts only
    # on the rescued rows, where the f64 vectors decide
    for name in ("ovr_mask", "ovr_sched", "ovr_score"):
        for a, b in zip(getattr(got, name), getattr(full, name)):
            assert torch.equal(a, b), name


# -- resident updates --------------------------------------------------------------


def copied(snap):
    """A snapshot with private copies of its four load arrays."""
    return dataclasses.replace(snap, values=snap.values.copy(), ts=snap.ts.copy(),
                               hot_value=snap.hot_value.copy(), hot_ts=snap.hot_ts.copy())


def test_apply_delta_and_columns_equal_full_prepare():
    annos = annotations(128, 11)
    _, port_snap = twin_snaps(annos, bucket=128)
    for dtype in DTYPES:
        _, port = steps(4, dtype, "combined")
        prepared = port.prepare(port_snap, NOW)
        snap = port_snap
        rng = np.random.default_rng(0)
        rows = np.array([1, 40, 64, 65, 126])
        vals = rng.random((rows.size, snap.values.shape[1]))
        ts = np.full((rows.size, snap.values.shape[1]), NOW - 5.0)
        hot = rng.integers(0, 3, rows.size).astype(np.float64)
        hts = np.full(rows.size, NOW - 1.0)
        got = port.apply_delta(prepared, rows, vals, ts, hot, hts)
        snap2 = copied(snap)
        snap2.values[rows], snap2.ts[rows] = vals, ts
        snap2.hot_value[rows], snap2.hot_ts[rows] = hot, hts
        if port.hybrid:
            got = port.with_overrides(got, snap2, NOW, force=True, dirty_rows=rows)
        want = port.prepare(snap2, NOW)
        np.testing.assert_array_equal(port.packed(got, 200).result(),
                                      port.packed(want, 200).result())
        # a whole column (uniform stamp), a partial one and a partial hot write
        n = snap.n_nodes
        col = rng.random(n)
        part = np.array([3, 64, 100])
        entries = [
            (0, np.arange(n), col, np.full(n, NOW - 2.0), None, None),
            (1, part, np.array([0.1, 0.9, 0.5]), np.full(3, NOW - 3.0), None, None),
            (None, part, None, None, np.array([1.0, 2.0, 0.0]), np.full(3, NOW)),
        ]
        got = port.apply_columns(want, entries, n)
        snap3 = copied(snap2)
        snap3.values[:n, 0], snap3.ts[:n, 0] = col, NOW - 2.0
        snap3.values[part, 1], snap3.ts[part, 1] = [0.1, 0.9, 0.5], NOW - 3.0
        snap3.hot_value[part], snap3.hot_ts[part] = [1.0, 2.0, 0.0], NOW
        if port.hybrid:
            got = port.with_overrides(got, snap3, NOW, force=True)
        full = port.prepare(snap3, NOW)
        np.testing.assert_array_equal(port.packed(got, 200).result(),
                                      port.packed(full, 200).result())


def test_tiles_from_reference_shards():
    """``convert.tiled_snapshot_from_shards``: the reference's per-device
    shards, fed to the port as its tiles, give the reference's packed
    result."""
    ref_snap, _ = twin_snaps(annotations(96, 4, boundary=True), bucket=32)
    ref, port = steps(4, "f32h", "combined")
    cap, off = gang_vectors(96)
    rp = ref.prepare(ref_snap, NOW, capacity=cap, offsets=off)
    shards = {name: [np.asarray(s.data) for s in getattr(rp, name).addressable_shards]
              for name in ("values", "ts", "hot_value", "hot_ts", "node_valid", "capacity",
                           "offsets", "ovr_mask", "ovr_sched", "ovr_score")}
    pp = tiled_snapshot_from_shards(port, shards, float(rp.now), rp.epoch, rp.ovr_now)
    np.testing.assert_array_equal(port.packed(pp, 250).result(),
                                  np.asarray(ref.packed(rp, 250)))


# -- BatchScheduler(mesh=) ------------------------------------------------------------


class Clock:
    def __init__(self):
        self.t = NOW

    def __call__(self):
        return self.t


def batch_twins(s, n, seed, dtype):
    jdt, pdt = DTYPES[dtype]
    annos = annotations(n, seed)
    jc, pcl = ClusterState(), pc.ClusterState()
    for name, anno in annos:
        jc.add_node(Node(name=name, annotations=dict(anno)))
        pcl.add_node(pc.Node(name=name, annotations=dict(anno)))
    clock = Clock()
    j = BatchScheduler(jc, DEFAULT_POLICY, dtype=jdt, clock=clock, snapshot_bucket=64,
                       mesh=ref_mesh(s))
    p = PortBatch(pcl, PORT_POLICY, dtype=pdt, clock=clock, snapshot_bucket=64,
                  mesh=cpu_mesh(s))
    return j, p, clock


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s", [2, 4])
def test_batch_scheduler_mesh_bursts_match_reference(s, dtype):
    """A cold burst, hit bursts, a delta burst (a few nodes re-annotated)
    and ``schedule_batch``: placements and ``refresh_stats`` paths equal
    the reference's on as many devices, and a mesh-free port twin's."""
    j, p, clock = batch_twins(s, 120, 30 + s, dtype)
    _, flat, _ = batch_twins(1, 120, 30 + s, dtype)
    flat = PortBatch(flat.cluster, PORT_POLICY, dtype=DTYPES[dtype][1], clock=clock,
                     snapshot_bucket=64, device="cpu")
    assert p.device == CPU and isinstance(p._step, ShardedScheduleStep)
    for cycle in range(4):
        if cycle == 3:
            for c in (j.cluster, p.cluster, flat.cluster):
                for i in (2, 70):
                    c.patch_node_annotation(f"node-{i:04d}", TENSORS.metric_names[0],
                                            f"0.91000,{format_local_time(clock.t)}")
        names = [f"b{cycle}-{i}" for i in range(150)]
        want = j.schedule_pod_burst("ns", names)
        got = p.schedule_pod_burst("ns", names)
        other = flat.schedule_pod_burst("ns", names)
        np.testing.assert_array_equal(got.node_idx, want.node_idx)
        np.testing.assert_array_equal(other.node_idx, want.node_idx)
        assert got.assignments == want.assignments
        clock.t += 9.0
    pods = [f"s-{i}" for i in range(90)]
    j.cluster.add_pods([Pod(name=x, namespace="ns") for x in pods])
    p.cluster.add_pods([pc.Pod(name=x, namespace="ns") for x in pods])
    want = j.schedule_batch([Pod(name=x, namespace="ns") for x in pods])
    got = p.schedule_batch([pc.Pod(name=x, namespace="ns") for x in pods])
    assert got.assignments == want.assignments and got.scores == want.scores
    keys = ("hit", "columns", "delta", "full")
    assert {k: p.refresh_stats[k] for k in keys} == {k: j.refresh_stats[k] for k in keys}
    assert p.refresh_stats["delta"] >= 1


def test_batch_scheduler_mesh_device_rules():
    cl = pc.ClusterState()
    assert PortBatch(cl, PORT_POLICY, mesh=cpu_mesh(2)).device == CPU
    assert PortBatch(cl, PORT_POLICY, mesh=cpu_mesh(2), device="cpu").device == CPU


def test_batch_scheduler_mesh_gangs_match_reference():
    """Sequential gangs, the gang window and a mixed burst on a 4-tile mesh
    (the combined step runs on the mesh too)."""
    from test_torch_gang_queue import SIDES, gang_specs, outcomes, requests_for, template

    specs = gang_specs(3, 96)
    out = {}
    for side, mesh in (("jax", ref_mesh(4)), ("port", cpu_mesh(4))):
        m = SIDES[side]
        cluster = m["ClusterState"]()
        for name, anno, alloc in specs:
            kw = {"allocatable": alloc} if alloc else {}
            cluster.add_node(m["Node"](name=name, annotations=dict(anno), **kw))
        if side == "jax":
            batch = BatchScheduler(cluster, DEFAULT_POLICY, dtype=jnp.float64,
                                   clock=lambda: NOW, snapshot_bucket=64, mesh=mesh)
        else:
            batch = PortBatch(cluster, PORT_POLICY, dtype=torch.float64,
                              clock=lambda: NOW, snapshot_bucket=64, mesh=mesh)
        seq = [batch.schedule_gang(t, c) for t, c in
               requests_for(side, ((500, 6), (1000, 4), (2000, 3)))]
        mixed = batch.schedule_batch_mixed(
            [template(side, f"m{i}", 250) for i in range(12)])
        out[side] = ([(r.assignments, r.unassigned, r.scores) for r in seq],
                     (mixed.assignments, mixed.unassigned))
    assert out["port"] == out["jax"]
    assert sum(len(r[0]) for r in out["port"][0]) > 0


def test_numa_gang_on_mesh_matches_reference():
    from test_torch_numa import RESULT, TOPO, gangs_for, guaranteed, lister_from_crs, numa_world

    from test_torch_gang_queue import SIDES

    world = numa_world(5, 64)
    specs, crs, background = world
    out = {}
    for side, mesh in (("jax", ref_mesh(2)), ("port", cpu_mesh(2))):
        m = SIDES[side]
        cluster = m["ClusterState"]()
        for name, anno, alloc in specs:
            kw = {"allocatable": alloc} if alloc else {}
            cluster.add_node(m["Node"](name=name, annotations=dict(anno), **kw))
        if side == "jax":
            batch = BatchScheduler(cluster, DEFAULT_POLICY, dtype=jnp.float64,
                                   clock=lambda: NOW, snapshot_bucket=64, mesh=mesh)
        else:
            batch = PortBatch(cluster, PORT_POLICY, dtype=torch.float64,
                              clock=lambda: NOW, snapshot_bucket=64, mesh=mesh)
        for name, used, raw in background:
            pod = guaranteed(side, f"bg-{name}", used)
            cluster.add_pod(type(pod)(name=pod.name, namespace=pod.namespace,
                                      containers=pod.containers,
                                      annotations={RESULT: raw}, node_name=name))
        topo = TOPO[side]["plugin"].TopologyMatch(lister_from_crs(side, crs), cluster=cluster)
        res = [batch.schedule_gang(t, c, topology=topo) for t, c in gangs_for(side)[:3]]
        out[side] = [(r.assignments, r.unassigned, r.scores) for r in res]
    assert out["port"] == out["jax"]
    assert sum(len(r[0]) for r in out["port"]) > 0


def test_gang_queue_on_mesh_matches_reference():
    """``schedule_gang_queue`` reads its scores from the mesh step's packed
    result; the windows' outcomes equal the reference's on 4 devices (its
    gang window under the scoped ``enable_x64`` shim)."""
    from test_torch_gang_queue import (
        SIDES,
        gang_specs,
        jax_gang_reference,
        outcomes,
        requests_for,
    )

    specs = gang_specs(9, 96)
    shapes = ((500, 6), (1000, 4), (250, 9), (1500, 3), (750, 5))
    out = {}
    for side, mesh in (("jax", ref_mesh(4)), ("port", cpu_mesh(4))):
        m = SIDES[side]
        cluster = m["ClusterState"]()
        for name, anno, alloc in specs:
            kw = {"allocatable": alloc} if alloc else {}
            cluster.add_node(m["Node"](name=name, annotations=dict(anno), **kw))
        if side == "jax":
            batch = BatchScheduler(cluster, DEFAULT_POLICY, dtype=jnp.float64,
                                   clock=lambda: NOW, snapshot_bucket=64, mesh=mesh)
            with jax_gang_reference():
                outs = batch.schedule_gang_queue(requests_for(side, shapes), window=4)
        else:
            batch = PortBatch(cluster, PORT_POLICY, dtype=torch.float64,
                              clock=lambda: NOW, snapshot_bucket=64, mesh=mesh)
            outs = batch.schedule_gang_queue(requests_for(side, shapes), window=4)
        out[side] = outcomes(outs)
    assert out["port"] == out["jax"]
    assert any(o[0] for o in out["port"])
