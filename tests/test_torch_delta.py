"""Keeping the resident snapshot current: the port's store bookkeeping,
``apply_delta`` / ``apply_columns``, the incremental override rescan,
``HybridScorer`` and ``BatchScheduler._prepare``'s delta and column paths,
each against the JAX package on twin inputs made from one seed.

Tolerance: identical versions, delta and column-log results, scores,
verdicts, counts, ``node_idx`` and ``refresh_stats`` path counters.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crane_scheduler_tpu.cluster import ClusterState, Node
from crane_scheduler_tpu.framework.scheduler import BatchScheduler
from crane_scheduler_tpu.loadstore import NodeLoadStore
from crane_scheduler_tpu.parallel import ShardedScheduleStep, make_node_mesh
from crane_scheduler_tpu.parallel.sharded import EPOCH_REBASE_SECONDS
from crane_scheduler_tpu.policy import DEFAULT_POLICY, compile_policy
from crane_scheduler_tpu.scorer import hybrid as jax_hybrid
from crane_scheduler_tpu.utils import format_local_time
from crane_scheduler_tpu_torch import cluster as port_cluster
from crane_scheduler_tpu_torch.framework.scheduler import BatchScheduler as PortScheduler
from crane_scheduler_tpu_torch.loadstore import NodeLoadStore as PortStore
from crane_scheduler_tpu_torch.parallel.step import ScheduleStep
from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY as PORT_POLICY
from crane_scheduler_tpu_torch.policy import compile_policy as port_compile_policy
from crane_scheduler_tpu_torch.scorer import hybrid as port_hybrid

NOW = 1753776000.0
METRICS = [sp.name for sp in DEFAULT_POLICY.spec.sync_period]
TENSORS = compile_policy(DEFAULT_POLICY)
PORT_TENSORS = port_compile_policy(PORT_POLICY)
BUCKET = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is faster here and leaves the
    other test workers their cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def anno(rng: random.Random, t: float) -> dict:
    """One node's annotation map: mostly fresh values, some stale,
    missing, negative, NaN and near-threshold entries."""
    out = {}
    for m in METRICS:
        roll = rng.random()
        if roll < 0.05:
            continue
        age = rng.choice([0, 30, 30, 30, 170, 479, 481, 2000])
        if roll < 0.08:
            val = rng.choice(["NaN", "-0.3"])
        elif roll < 0.25:
            val = rng.choice(["0.64999", "0.65", "0.65001", "0.74999", "0.75001"])
        else:
            val = f"{rng.random():.5f}"
        out[m] = f"{val},{format_local_time(t - age)}"
    if rng.random() < 0.8:
        hv = rng.choice(["0", "1", "2", "0.1", "0.35", "3"])
        out["node_hot_value"] = f"{hv},{format_local_time(t - rng.choice([0, 60, 299, 301]))}"
    return out


class Clock:
    def __init__(self):
        self.t = NOW

    def __call__(self):
        return self.t


# -- the store ---------------------------------------------------------------


def assert_same_delta(got, want):
    assert got[:2] == want[:2]
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a, b)


def assert_same_columns(got, want):
    if want is None:
        assert got is None
        return
    assert got is not None and got[:2] == want[:2] and len(got[2]) == len(want[2])
    for ge, we in zip(got[2], want[2]):
        assert ge[0] == we[0]
        for a, b in zip(ge[1:], we[1:]):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


def twin_store_ops(stores, rng: random.Random, n_ops: int):
    """Apply one seeded mutation sequence to every store in ``stores``;
    yields after each op."""
    names = [f"node-{i:03d}" for i in range(40)]
    for name in names:
        a = anno(rng, NOW)
        for s in stores:
            s.ingest_node_annotations(name, a)
    sweep_names = list(names)  # one cached list object, as the annotator's
    maps = {}
    extra = 0
    t = NOW
    for step in range(n_ops):
        t += 5.0
        op = rng.choice(["ingest", "bulk", "col", "col", "partial", "hot", "newcol",
                         "set", "sethot", "add", "remove", "prune", "missing"])
        live = list(stores[0].node_names)
        if op == "ingest":
            name, a = rng.choice(live), anno(rng, t)
            for s in stores:
                s.ingest_node_annotations(name, a)
        elif op == "bulk":
            # some maps are the same objects as last time (identity skip)
            batch = []
            for name in rng.sample(live, min(6, len(live))):
                if name not in maps or rng.random() < 0.5:
                    maps[name] = anno(rng, t)
                batch.append((name, maps[name]))
            if rng.random() < 0.3:
                extra += 1
                batch.append((f"bulk-new-{extra}", anno(rng, t)))
            for s in stores:
                s.bulk_ingest(list(batch))
        elif op in ("col", "partial", "newcol"):
            if op == "col":
                sweep_names = sweep_names if set(sweep_names) == set(live) else live
                cols_names = sweep_names
            elif op == "partial":
                cols_names = rng.sample(live, max(1, len(live) // 3))
            else:
                extra += 1
                cols_names = live[:5] + [f"col-new-{extra}"]
            k = len(cols_names)
            metric = rng.choice(METRICS)
            vals = np.array([rng.random() for _ in range(k)])
            ts = t if rng.random() < 0.5 else np.array([t - rng.choice([0, 9]) for _ in range(k)])
            hot = rng.random() < 0.5
            hv = np.array([float(rng.randint(0, 3)) for _ in range(k)]) if hot else None
            for s in stores:
                s.bulk_set_by_name(metric, cols_names, vals, ts, hv, t if hot else None)
        elif op == "hot":
            hv = np.array([float(rng.randint(0, 4)) for _ in live])
            for s in stores:
                s.bulk_set_by_name(None, live, None, None, hv, t)
        elif op == "set":
            name, metric, v = rng.choice(live), rng.choice(METRICS + ["not-a-metric"]), rng.random()
            for s in stores:
                s.set_metric(name, metric, v, t)
        elif op == "sethot":
            name, v = rng.choice(live), float(rng.randint(0, 3))
            for s in stores:
                s.set_hot_value(name, v, t)
        elif op == "missing":
            for s in stores:
                s.set_metric("ghost", METRICS[0], 0.5, t, create=False)
                s.set_hot_value("ghost", 1.0, t, create=False)
        elif op == "add":
            extra += 1
            for s in stores:
                s.add_node(f"added-{extra}")
        elif op == "remove":
            name = rng.choice(live)
            for s in stores:
                s.remove_node(name)
        else:
            keep = [n for n in live if rng.random() < 0.95]
            for s in stores:
                assert s.prune_absent(keep) == len(live) - len(keep)
        yield step, op


@pytest.mark.parametrize("seed", range(3))
def test_store_versions_deltas_and_column_log_match_jax(seed):
    """One mutation sequence on both packages' stores: equal versions,
    layout versions, ``delta_since`` and ``column_delta_since`` results
    from every earlier version, ``None`` exactly where the reference's
    column chain breaks."""
    tensors = TENSORS
    ref, port = NodeLoadStore(tensors), PortStore(PORT_TENSORS)
    rng = random.Random(seed)
    history = [ref.version]
    replayable = 0
    for step, op in twin_store_ops([ref, port], rng, 60):
        assert (port.version, port.layout_version) == (ref.version, ref.layout_version), (step, op)
        assert port.node_names == ref.node_names
        for v in history[-12:]:
            assert_same_delta(port.delta_since(v), ref.delta_since(v))
            want = ref.column_delta_since(v)
            replayable += want is not None and v != ref.version
            assert_same_columns(port.column_delta_since(v), want)
        snap_p, snap_r = port.snapshot(bucket=BUCKET), ref.snapshot(bucket=BUCKET)
        assert snap_p.version == snap_r.version and snap_p.layout_version == port.layout_version
        for f in ("values", "ts", "hot_value", "hot_ts", "node_valid"):
            np.testing.assert_array_equal(getattr(snap_p, f), getattr(snap_r, f))
        history.append(ref.version)
    assert replayable > 0  # the column chain was exercised, not only broken


def test_column_log_chain_breaks_where_jax_does():
    """A foreign write inside the interval breaks the chain, a fresh
    interval after it replays again, and a write that adds a node is not
    replayable (the layout moved)."""
    stores = [NodeLoadStore(TENSORS), PortStore(PORT_TENSORS)]
    rng = random.Random(5)
    names = [f"n{i}" for i in range(8)]
    for name in names:
        a = anno(rng, NOW)
        for s in stores:
            s.ingest_node_annotations(name, a)

    def sweep(t):
        for k, metric in enumerate(METRICS):
            vals = np.linspace(0.1, 0.9, len(names)) + 0.01 * k
            hot = (np.arange(len(names)) % 3).astype(float) if k == 0 else None
            for s in stores:
                s.bulk_set_by_name(metric, names, vals, t, hot, t if k == 0 else None)

    outcomes = []
    v0 = stores[0].version
    sweep(NOW + 5.0)
    outcomes.append([s.column_delta_since(v0) is not None for s in stores])
    for s in stores:
        s.set_metric("n0", METRICS[0], 0.5, NOW + 6.0)
    outcomes.append([s.column_delta_since(v0) is not None for s in stores])
    v1 = stores[0].version
    sweep(NOW + 7.0)
    outcomes.append([s.column_delta_since(v1) is not None for s in stores])
    outcomes.append([s.column_delta_since(s.version)[2] == [] for s in stores])
    v2 = stores[0].version
    for s in stores:
        s.bulk_set_by_name(METRICS[0], names + ["n-new"], np.full(9, 0.3), NOW + 8.0)
    outcomes.append([s.column_delta_since(v2) is not None for s in stores])
    assert outcomes == [[True, True], [False, False], [True, True], [True, True], [False, False]]
    assert_same_columns(stores[1].column_delta_since(v1), stores[0].column_delta_since(v1))


# -- the step ----------------------------------------------------------------


def twin_stores(n, seed):
    rng = random.Random(seed)
    ref, port = NodeLoadStore(TENSORS), PortStore(PORT_TENSORS)
    for i in range(n):
        a = anno(rng, NOW)
        ref.ingest_node_annotations(f"node-{i:03d}", a)
        port.ingest_node_annotations(f"node-{i:03d}", a)
    return ref, port


def steps(mode):
    if mode == "f64":
        return (ShardedScheduleStep(TENSORS, make_node_mesh(1), dtype=jnp.float64),
                ScheduleStep(PORT_TENSORS, dtype=torch.float64, device="cpu"))
    return (ShardedScheduleStep(TENSORS, make_node_mesh(1), dtype=jnp.float32, hybrid=True),
            ScheduleStep(PORT_TENSORS, dtype=torch.float32, device="cpu"))


def port_outputs(step, prepared, n, num_pods=150):
    return ScheduleStep.unpack(step.packed(prepared, num_pods).result(), n)


def jax_outputs(step, prepared, n, num_pods=150):
    return ScheduleStep.unpack(np.asarray(step.packed(prepared, num_pods)), n)


def assert_outputs_equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def assert_live_rows_equal(got, want, n):
    for f in ("values", "ts", "hot_value", "hot_ts"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[:n], getattr(want, f).numpy()[:n],
                                      err_msg=f)


def sweep_columns(stores, n_rows, rng, t, partial, uniform):
    """An annotator-shaped sweep over every metric, hot values on the
    first; ``partial`` skips two nodes on the second metric; ``uniform``
    stamps one timestamp, else each row its own."""
    names = list(stores[0].node_names)
    for k, metric in enumerate(METRICS):
        cols = names[:-2] if partial and k == 1 else names
        m = len(cols)
        vals = rng.uniform(0, 1, m).round(5)
        ts = t if uniform else t - rng.choice([0.0, 3.0, 479.5, 480.5], m)
        hv = rng.integers(0, 3, m).astype(float) if k == 0 else None
        for s in stores:
            s.bulk_set_by_name(metric, cols, vals, ts, hv, t if k == 0 else None)


@pytest.mark.parametrize("uniform", [True, False], ids=["uniform-ts", "varied-ts"])
@pytest.mark.parametrize("partial", [False, True], ids=["full", "partial"])
@pytest.mark.parametrize("mode", ["f64", "f32-hybrid"])
def test_apply_columns_equals_full_prepare_and_jax(mode, partial, uniform):
    ref, port = twin_stores(60, seed=31)
    jstep, pstep = steps(mode)
    n = len(port)
    v0 = port.version
    p_prep = pstep.prepare(port.snapshot(bucket=BUCKET), NOW)
    j_prep = jstep.prepare(ref.snapshot(bucket=BUCKET), NOW)
    sweep_columns([ref, port], n, np.random.default_rng(7), NOW + 5.0, partial, uniform)
    entries = port.column_delta_since(v0)[2]
    assert len(entries) == len(METRICS)

    updated = pstep.apply_columns(p_prep, entries, n)
    j_updated = jstep.apply_columns(j_prep, ref.column_delta_since(v0)[2], n)
    snap = port.snapshot(bucket=BUCKET)
    updated = pstep.with_overrides(updated, snap, NOW, force=True)
    j_updated = jstep.with_overrides(j_updated, ref.snapshot(bucket=BUCKET), NOW, force=True)
    want = pstep.prepare(snap, NOW)
    assert_live_rows_equal(updated, want, n)
    got = port_outputs(pstep, updated, n)
    assert_outputs_equal(got, port_outputs(pstep, want, n))
    assert_outputs_equal(got, jax_outputs(jstep, j_updated, n))
    if mode != "f64":
        for f in ("ovr_mask", "ovr_sched", "ovr_score"):
            np.testing.assert_array_equal(getattr(updated, f).numpy(), getattr(want, f).numpy())
    # the snapshot it was given still scores its own (older) data
    assert_outputs_equal(port_outputs(pstep, p_prep, n), jax_outputs(jstep, j_prep, n))


@pytest.mark.parametrize("mode", ["f64", "f32-hybrid"])
def test_apply_delta_equals_full_prepare_and_keeps_old_snapshot(mode):
    """Changed rows scatter into new tensors: the result equals a full
    prepare at the same epoch and the JAX step's ``apply_delta``, and the
    snapshot taken before the delta still scores its old data."""
    ref, port = twin_stores(60, seed=32)
    jstep, pstep = steps(mode)
    n = len(port)
    v0 = port.version
    p_prep = pstep.prepare(port.snapshot(bucket=BUCKET), NOW)
    j_prep = jstep.prepare(ref.snapshot(bucket=BUCKET), NOW)
    before = port_outputs(pstep, p_prep, n)
    rng = random.Random(3)
    for name in rng.sample(list(port.node_names), 7):
        a = anno(rng, NOW + 20.0)
        ref.ingest_node_annotations(name, a)
        port.ingest_node_annotations(name, a)
    port.set_metric("node-001", METRICS[2], 0.65, NOW + 21.0)
    ref.set_metric("node-001", METRICS[2], 0.65, NOW + 21.0)

    delta = port.delta_since(v0)
    assert_same_delta(delta, ref.delta_since(v0))
    _, _, rows, vals, ts, hot, hot_ts = delta
    updated = pstep.apply_delta(p_prep, rows, vals, ts, hot, hot_ts)
    j_updated = jstep.apply_delta(j_prep, *ref.delta_since(v0)[2:])
    snap = port.snapshot(bucket=BUCKET)
    updated = pstep.with_overrides(updated, snap, NOW, force=True, dirty_rows=rows)
    j_updated = jstep.with_overrides(j_updated, ref.snapshot(bucket=BUCKET), NOW, force=True)
    want = pstep.prepare(snap, NOW)
    for f in ("values", "ts", "hot_value", "hot_ts"):
        np.testing.assert_array_equal(getattr(updated, f).numpy(), getattr(want, f).numpy())
    got = port_outputs(pstep, updated, n)
    assert_outputs_equal(got, port_outputs(pstep, want, n))
    assert_outputs_equal(got, jax_outputs(jstep, j_updated, n))
    assert any(not np.array_equal(a, b) for a, b in zip(got, before))
    assert_outputs_equal(port_outputs(pstep, p_prep, n), before)
    assert pstep.apply_delta(updated, [], vals[:0], ts[:0], hot[:0], hot_ts[:0]) is updated


# -- the incremental override rescan -----------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_incremental_overrides_with_dirty_rows_match_jax(seed):
    """Across advancing clocks, sparse dirty rows and a validity flip the
    port's ``compute_overrides_incremental(dirty_rows=)`` returns what the
    reference's does, and both equal a full scan."""
    ref, _ = twin_stores(200, seed=40 + seed)
    rng = np.random.default_rng(seed)
    n = len(ref)
    values, ts = ref.values[:n].copy(), ref.ts[:n].copy()
    hot, hot_ts = ref.hot_value[:n].copy(), ref.hot_ts[:n].copy()
    valid = np.ones((n,), dtype=bool)
    valid[rng.integers(0, n, 5)] = False
    pcache = jcache = None
    for tick in range(12):
        now = NOW + tick * 19.0
        dirty = None
        if tick:
            dirty = rng.integers(0, n, rng.integers(0, 8))
            values[dirty] = rng.uniform(0, 1, (dirty.size, values.shape[1]))
            ts[dirty] = now - rng.uniform(0, 400, (dirty.size, ts.shape[1]))
            if tick == 7:
                valid[rng.integers(0, n)] ^= True
        args = (values, ts, hot, hot_ts, valid, now)
        got = port_hybrid.compute_overrides_incremental(
            PORT_TENSORS, *args, cache=pcache, dirty_rows=dirty, rebase_age=tick * 19.0)
        want = jax_hybrid.compute_overrides_incremental(
            TENSORS, *args, cache=jcache, dirty_rows=dirty, rebase_age=tick * 19.0)
        pcache, jcache = got[4], want[4]
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
        assert (got[3] is None) == (want[3] is None)
        if got[3] is not None:
            np.testing.assert_array_equal(got[3], want[3])
        assert got[5] == want[5]
        full = port_hybrid.compute_overrides(PORT_TENSORS, *args, rebase_age=tick * 19.0)
        for a, b in zip(got[:3], full[:3]):
            np.testing.assert_array_equal(a, b)


# -- HybridScorer -------------------------------------------------------------


@pytest.mark.parametrize("seed", range(2))
def test_hybrid_scorer_matches_jax(seed):
    ref, port = twin_stores(300, seed=50 + seed)
    snap = port.snapshot(bucket=BUCKET)
    jsnap = ref.snapshot(bucket=BUCKET)
    now = NOW + 13.0
    got = port_hybrid.HybridScorer(PORT_TENSORS, device="cpu")(
        snap.values, snap.ts, snap.hot_value, snap.hot_ts, snap.node_valid, now)
    want = jax_hybrid.HybridScorer(TENSORS)(
        jsnap.values, jsnap.ts, jsnap.hot_value, jsnap.hot_ts, jsnap.node_valid, now)
    np.testing.assert_array_equal(got.schedulable, np.asarray(want.schedulable))
    np.testing.assert_array_equal(got.scores, np.asarray(want.scores))
    assert got.rescored == want.rescored > 0


# -- the scheduler -------------------------------------------------------------


def twin_schedulers(n_nodes, seed, dtype, direct=False):
    """Twin clusters (and, in direct mode, twin stores the test writes)
    with the JAX ``BatchScheduler`` and the port's."""
    jax_dtype, port_dtype = {"f64": (jnp.float64, torch.float64),
                             "f32": (jnp.float32, torch.float32)}[dtype]
    rng = random.Random(seed)
    jc, pc = ClusterState(), port_cluster.ClusterState()
    for i in range(n_nodes):
        a = anno(rng, NOW)
        jc.add_node(Node(name=f"node-{i:03d}", annotations=dict(a)))
        pc.add_node(port_cluster.Node(name=f"node-{i:03d}", annotations=dict(a)))
    clock = Clock()
    jkw, pkw = {}, {}
    if direct:
        jkw = dict(store=NodeLoadStore(TENSORS), refresh_from_cluster=False)
        pkw = dict(store=PortStore(PORT_TENSORS), refresh_from_cluster=False)
        for node in pc.list_nodes():
            jkw["store"].ingest_node_annotations(node.name, node.annotations)
            pkw["store"].ingest_node_annotations(node.name, node.annotations)
    j = BatchScheduler(jc, DEFAULT_POLICY, dtype=jax_dtype, clock=clock,
                       snapshot_bucket=BUCKET, **jkw)
    p = PortScheduler(pc, PORT_POLICY, dtype=port_dtype, clock=clock,
                      snapshot_bucket=BUCKET, device="cpu", **pkw)
    return j, p, clock


PATHS = ("hit", "columns", "delta", "full")


def burst_both(j, p, tag, count):
    names = [f"{tag}-{i}" for i in range(count)]
    want = j.schedule_pod_burst("ns", names)
    got = p.schedule_pod_burst("ns", names)
    assert got.node_table == want.node_table
    np.testing.assert_array_equal(got.node_idx, want.node_idx)
    np.testing.assert_array_equal(got.scores_row, np.asarray(want.scores_row))
    np.testing.assert_array_equal(got.schedulable_row, np.asarray(want.schedulable_row))
    assert {k: p.refresh_stats[k] for k in PATHS} == {k: j.refresh_stats[k] for k in PATHS}
    assert p.refresh_stats["risk_rescan_rows"] == j.refresh_stats["risk_rescan_rows"]
    return got


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_cluster_patches_between_bursts_match_jax(dtype, seed):
    """A seeded interleaving of single, bulk and columnar annotation
    patches, node adds and deletes, and bursts at advancing clocks (one
    past ``EPOCH_REBASE_SECONDS``): placements, scores, verdicts and the
    hit/delta/columns/full counts equal the JAX package's."""
    j, p, clock = twin_schedulers(120, seed=60 + seed, dtype=dtype)
    rng = random.Random(seed)
    clusters = (j.cluster, p.cluster)
    node_cls = (Node, port_cluster.Node)
    extra = 0
    for cycle in range(16):
        op = "none" if cycle % 5 == 4 else rng.choice(
            ["one", "bulk", "bulk", "columns", "columns-wide", "add", "delete"])
        live = sorted(n.name for n in p.cluster.list_nodes())
        t = clock.t
        if op == "one":
            name, key = rng.choice(live), rng.choice(METRICS + ["node_hot_value"])
            val = f"{rng.random():.5f},{format_local_time(t)}"
            assert [c.patch_node_annotation(name, key, val) for c in clusters] == [True] * 2
        elif op == "bulk":
            per = {name: anno(rng, t) for name in rng.sample(live, 6)}
            assert [c.patch_node_annotations_bulk(per) for c in clusters] == [6, 6]
        elif op.startswith("columns"):
            names = rng.sample(live, 5 if op == "columns" else len(live) // 2)
            cols = {m: [f"{rng.random():.5f},{format_local_time(t)}" for _ in names]
                    for m in rng.sample(METRICS, 2)}
            if rng.random() < 0.5:
                for c in clusters:
                    c.patch_node_annotations_columns(names, cols)
            else:
                groups = [(names[:2], cols), (names[2:], {m: v[2:] for m, v in cols.items()})]
                for c in clusters:
                    c.patch_node_annotation_groups(groups)
        elif op == "add":
            extra += 1
            a = anno(rng, t)
            for c, cls in zip(clusters, node_cls):
                c.add_node(cls(name=f"extra-{extra}", annotations=dict(a)))
        elif op == "delete":
            name = rng.choice(live)
            for c in clusters:
                c.delete_node(name)
        assert p.cluster.node_version == j.cluster.node_version
        assert p.cluster.node_set_version == j.cluster.node_set_version
        burst_both(j, p, f"c{cycle}", 150)
        clock.t += EPOCH_REBASE_SECONDS + 60.0 if cycle == 10 else rng.choice([0.0, 7.0, 31.0])
    assert p.cluster.sched_version == j.cluster.sched_version
    assert p.cluster.count_pods_all() == j.cluster.count_pods_all()
    counts = p.refresh_stats
    if dtype == "f32":
        assert counts["delta"] > 0 and counts["hit"] > 0 and counts["full"] > 1


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_direct_mode_store_writes_match_jax(dtype, seed):
    """Direct mode (``store=``, ``refresh_from_cluster=False``): annotator
    sweeps (``bulk_set_by_name``, one partial), single ``set_metric``
    writes and a membership change between bursts take the columns,
    delta and full paths exactly as in the JAX package."""
    j, p, clock = twin_schedulers(96, seed=70 + seed, dtype=dtype, direct=True)
    rng = np.random.default_rng(seed)
    stores = (j.store, p.store)
    names = list(p.store.node_names)
    burst_both(j, p, "cold", 120)
    for cycle in range(9):
        clock.t += 30.0
        op = cycle % 4
        if op in (0, 1):  # annotator sweep; cycle 1 leaves two rows out of one metric
            sweep_columns(stores, len(names), rng, clock.t, partial=op == 1, uniform=True)
        elif op == 2:
            for _ in range(3):
                name = names[int(rng.integers(0, len(names)))]
                v, metric = float(rng.uniform(0, 1)), METRICS[int(rng.integers(0, len(METRICS)))]
                for s in stores:
                    s.set_metric(name, metric, v, clock.t)
        elif cycle == 7:
            for s in stores:
                s.add_node(f"late-{cycle}")
        burst_both(j, p, f"d{cycle}", 120)
    counts = {k: p.refresh_stats[k] for k in PATHS}
    assert counts["columns"] >= 4 and counts["delta"] >= 2 and counts["full"] == 2


def test_wide_patch_takes_full_path_and_sparse_write_rescan_is_dirty_bounded():
    """Patching more than a quarter of the nodes takes the full path; one
    sparse write takes the delta path and rescans only its row."""
    j, p, clock = twin_schedulers(64, seed=80, dtype="f32")
    burst_both(j, p, "a", 100)
    fresh = format_local_time(clock.t)
    per = {f"node-{i:03d}": {METRICS[0]: f"0.2,{fresh}"} for i in range(17)}
    for c in (j.cluster, p.cluster):
        c.patch_node_annotations_bulk(per)
    burst_both(j, p, "b", 100)
    assert p.refresh_stats["full"] == 2 and p.refresh_stats["delta"] == 0
    for c in (j.cluster, p.cluster):
        c.patch_node_annotation("node-004", METRICS[1], f"0.42,{fresh}")
    before = p.refresh_stats["risk_rescan_rows"]
    burst_both(j, p, "c", 100)
    assert p.refresh_stats["delta"] == 1
    assert p.refresh_stats["risk_rescan_rows"] - before <= 2


def test_direct_store_for_another_policy_is_refused():
    from crane_scheduler_tpu_torch.policy.types import (
        DynamicSchedulerPolicy,
        PolicySpec,
        SyncPolicy,
    )

    other = PortStore(port_compile_policy(DynamicSchedulerPolicy(
        spec=PolicySpec(sync_period=(SyncPolicy("a", 60.0),)))))
    with pytest.raises(ValueError, match="different policy"):
        PortScheduler(port_cluster.ClusterState(), PORT_POLICY, store=other,
                      refresh_from_cluster=False, device="cpu")
