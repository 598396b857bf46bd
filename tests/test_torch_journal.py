"""The dirty-name journal and its in-memory consumers on the CPU: the port's
``ClusterState`` journal (``dirty_nodes_since``, ``dirty_journal_stats``,
``forget_dirty_names``), ``FitTracker``'s journal-patched rows and
``free_copy_counts``, ``DeviceColumnCache`` row scatters, and
``DripColumns`` / ``GangColumns`` O(dirty) patches, each against the JAX
package on twin inputs made from one seed (dozens of nodes, a few dozen
writes).

Tolerance: exact. Journal replays and stats, tracker rows, counts and
stats, column values, epochs, scatter-log replays, cache counters and
``crane_dirty_rows_total`` are equal.
"""

import random

import numpy as np
import pytest
import torch

from crane_scheduler_tpu.cluster import ClusterState, Container, Node, Pod
from crane_scheduler_tpu.cluster import ResourceRequirements
from crane_scheduler_tpu.fit import FitTracker
from crane_scheduler_tpu.fit import tracker as jax_tracker
from crane_scheduler_tpu.framework.drip import DripColumns, GangColumns
from crane_scheduler_tpu.parallel.sharded import DeviceColumnCache
from crane_scheduler_tpu.policy import DEFAULT_POLICY
from crane_scheduler_tpu.telemetry import Telemetry
from crane_scheduler_tpu_torch import cluster as pc
from crane_scheduler_tpu_torch.fit import FitTracker as PortFitTracker
from crane_scheduler_tpu_torch.fit import tracker as port_tracker
from crane_scheduler_tpu_torch.framework.drip import DripColumns as PortDripColumns
from crane_scheduler_tpu_torch.framework.drip import GangColumns as PortGangColumns
from crane_scheduler_tpu_torch.parallel.column_cache import DeviceColumnCache as PortCache
from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY as PORT_POLICY
from crane_scheduler_tpu_torch.telemetry import Telemetry as PortTelemetry
from test_drip_columnar import METRICS, NOW, _anno, fuzz_node_specs

SIDES = {
    "jax": dict(ClusterState=ClusterState, Node=Node, Pod=Pod, Container=Container,
                ResourceRequirements=ResourceRequirements, FitTracker=FitTracker,
                DripColumns=DripColumns, GangColumns=GangColumns, Telemetry=Telemetry,
                policy=DEFAULT_POLICY),
    "port": dict(ClusterState=pc.ClusterState, Node=pc.Node, Pod=pc.Pod,
                 Container=pc.Container, ResourceRequirements=pc.ResourceRequirements,
                 FitTracker=PortFitTracker, DripColumns=PortDripColumns,
                 GangColumns=PortGangColumns, Telemetry=PortTelemetry, policy=PORT_POLICY),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is faster here and leaves the
    other test workers their cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def twin_clusters(specs, cap=4096, labels=None):
    out = {}
    for side, m in SIDES.items():
        cluster = m["ClusterState"](dirty_journal_cap=cap)
        for i, (name, anno, allocatable) in enumerate(specs):
            kwargs = {"allocatable": allocatable} if allocatable else {}
            if labels is not None:
                kwargs["labels"] = labels[i]
            cluster.add_node(m["Node"](name=name, annotations=dict(anno), **kwargs))
        out[side] = cluster
    return out


def random_write(rng: random.Random, names: list, step: int):
    """One seeded cluster write as ``fn(side, cluster)``: every named and
    name-less node write the journal sees, plus bound pods (which it
    does not)."""
    kind = rng.choice(["patch", "patch", "bulk", "add", "replace", "delete",
                       "missing", "columns", "groups", "forget", "pod"])
    name = rng.choice(names)
    val = _anno(rng.uniform(0.0, 1.0), rng.choice([10.0, 400.0]))
    if kind == "patch":
        return lambda s, c: c.patch_node_annotation(name, rng_metric(step), val)
    if kind == "missing":
        return lambda s, c: c.patch_node_annotation(f"ghost{step}", METRICS[0], val)
    if kind == "bulk":
        picked = rng.sample(names, min(3, len(names))) + [f"ghost{step}"]
        return lambda s, c: c.patch_node_annotations_bulk(
            {nm: {rng_metric(step): val} for nm in picked})
    if kind == "add":
        new = f"late{step}"
        names.append(new)
        return lambda s, c: c.add_node(SIDES[s]["Node"](
            name=new, annotations={METRICS[0]: val},
            allocatable={"cpu": "4", "memory": "8Gi", "pods": "9"}))
    if kind == "replace":
        alloc = {"cpu": str(rng.randrange(1, 9)), "memory": "16Gi", "pods": "7"}
        return lambda s, c: c.add_node(SIDES[s]["Node"](
            name=name, annotations={METRICS[1]: val}, allocatable=alloc))
    if kind == "delete":
        if len(names) > 4:
            names.remove(name)
        return lambda s, c: c.delete_node(name)
    if kind == "columns":
        picked = sorted(rng.sample(names, min(4, len(names))))
        return lambda s, c: c.patch_node_annotations_columns(
            picked, {METRICS[2]: [val] * len(picked)})
    if kind == "groups":
        picked = sorted(rng.sample(names, min(2, len(names))))
        return lambda s, c: c.patch_node_annotation_groups(
            [(picked, {METRICS[3]: [val] * len(picked)})])
    if kind == "forget":
        return lambda s, c: c.forget_dirty_names()
    pod_name = f"bound{step}"
    return lambda s, c: c.add_pod(SIDES[s]["Pod"](
        name=pod_name, namespace="default", node_name=name if c.has_node(name) else "",
        containers=(SIDES[s]["Container"]("c", SIDES[s]["ResourceRequirements"](
            requests={"cpu": "250m", "memory": "256Mi"})),)))


def rng_metric(step: int) -> str:
    return METRICS[step % len(METRICS)]


def assert_journals_equal(clusters):
    j, p = clusters["jax"], clusters["port"]
    assert p.node_version == j.node_version
    assert p.dirty_journal_stats() == j.dirty_journal_stats()
    for v in range(-1, j.node_version + 2):
        assert p.dirty_nodes_since(v) == j.dirty_nodes_since(v), v


# -- the journal ---------------------------------------------------------------


@pytest.mark.parametrize("cap", [3, 16, 4096])
@pytest.mark.parametrize("seed", range(6))
def test_journal_replays_and_stats_match(seed, cap):
    """Every write kind, then every fence replayed on both sides; a cap of
    3 overruns, the columnar and group patches and ``forget_dirty_names``
    reset the floor, adds and deletes carry the membership flag."""
    rng = random.Random(seed)
    specs = fuzz_node_specs(rng, 12)
    clusters = twin_clusters(specs, cap=cap)
    names = [s[0] for s in specs]
    assert_journals_equal(clusters)
    for step in range(30):
        fn = random_write(rng, names, step)
        for side, c in clusters.items():
            fn(side, c)
        assert_journals_equal(clusters)
    stats = clusters["port"].dirty_journal_stats()
    if cap == 3:
        assert stats["overruns"] > 0


def test_cluster_build_overruns_the_default_cap_like_the_reference():
    """A 5,000-node build by ``add_node`` overruns a cap of 1,024: the
    floor moves and the interval from before the build is uncovered."""
    clusters = {side: m["ClusterState"](dirty_journal_cap=1024) for side, m in SIDES.items()}
    for side, c in clusters.items():
        for i in range(5000):
            c.add_node(SIDES[side]["Node"](name=f"n{i:05d}"))
    j, p = clusters["jax"], clusters["port"]
    assert p.dirty_journal_stats() == j.dirty_journal_stats()
    assert p.dirty_journal_stats()["overruns"] == 5000 - 1024
    for v in (0, 3975, 3976, 3977, 4999, 5000):
        assert p.dirty_nodes_since(v) == j.dirty_nodes_since(v)
    assert p.dirty_nodes_since(0) is None
    assert p.dirty_nodes_since(4999) == ({"n04999"}, True)


# -- FitTracker ------------------------------------------------------------------


def tracker_requests(side):
    m = SIDES[side]
    shapes = [{"cpu": "500m", "memory": "1Gi"}, {"cpu": "2"}, {"memory": "3Gi"},
              {"cpu": "250m", "example.com/gpu": "1"}, {}]
    return [m["Pod"](name=f"t{i}", namespace="default", containers=(
        m["Container"]("c", m["ResourceRequirements"](requests=req)),)) for i, req in
        enumerate(shapes)]


@pytest.mark.parametrize("seed", range(6))
def test_fit_tracker_patches_journal_rows_like_the_reference(seed):
    """Annotation patches and allocatable replacements of known nodes
    identity-check only the journal's names (``node_patches``); adds,
    deletes and sweeps take the full rebuild. Rows, copy counts, per-node
    free amounts, stats and the ``consumer="fit"`` counter agree."""
    rng = random.Random(100 + seed)
    specs = fuzz_node_specs(rng, 20)
    specs = [(n, a, al or ({"cpu": "6", "memory": "12Gi", "pods": "5",
                            "example.com/gpu": "2"} if i % 3 == 0 else None))
             for i, (n, a, al) in enumerate(specs)]
    clusters = twin_clusters(specs)
    tels = {side: m["Telemetry"]() for side, m in SIDES.items()}
    trackers = {side: SIDES[side]["FitTracker"](c, telemetry=tels[side])
                for side, c in clusters.items()}
    names = [s[0] for s in specs]
    reqs = {side: tracker_requests(side) for side in SIDES}
    pfr = {"jax": jax_tracker.pod_fit_request, "port": port_tracker.pod_fit_request}
    for step in range(25):
        fn = random_write(rng, names, step)
        for side, c in clusters.items():
            fn(side, c)
            trackers[side].refresh()
        tj, tp = trackers["jax"], trackers["port"]
        assert tp.stats() == tj.stats()
        listed = [n.name for n in clusters["jax"].list_nodes()] + ["ghost"]
        for a, b in zip(tj.free_matrix(listed), tp.free_matrix(listed)):
            np.testing.assert_array_equal(b, a)
        for rj, rp in zip(reqs["jax"], reqs["port"]):
            np.testing.assert_array_equal(
                tp.free_copy_counts(listed, pfr["port"](rp)),
                tj.free_copy_counts(listed, pfr["jax"](rj)))
        for nm in listed:
            assert tp.free_for(nm) == tj.free_for(nm)
    assert trackers["port"].stats()["node_patches"] > 0
    key = 'crane_dirty_rows_total{consumer="fit"}'
    assert tels["port"].registry.snapshot().get(key) == tels["jax"].registry.snapshot().get(key)


@pytest.mark.parametrize("seed", range(3))
def test_copy_counts_rows_matches_reference(seed):
    rng = np.random.default_rng(seed)
    free = rng.integers(-500, 1 << 34, size=(64, 4), dtype=np.int64)
    bounded = rng.random(64) < 0.7
    for vec in ([0, 0, 0, 1], [250, 1 << 28, 0, 1], [3000, 0, 1 << 20, 1], [0, 0, 0, 0]):
        vec = np.asarray(vec, np.int64)
        np.testing.assert_array_equal(port_tracker.copy_counts_rows(free, bounded, vec),
                                      jax_tracker.copy_counts_rows(free, bounded, vec))
    assert port_tracker.UNBOUNDED == jax_tracker.UNBOUNDED == 1 << 30


# -- DeviceColumnCache row scatters ---------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_column_cache_delta_scatters_match_reference(seed):
    """In-place patches announced as ``delta_rows`` scatter on both sides;
    an empty delta keeps the held tensor; a new array object, a held
    version past the log or no delta uploads. Counters and device values
    agree, and an earlier tensor is never written."""
    rng = np.random.default_rng(seed)
    n = 50
    arr = rng.integers(0, 100, size=n).astype(np.int64)
    flags = rng.random(n) < 0.5
    jc, pcache = DeviceColumnCache(), PortCache(torch.device("cpu"))
    held = []
    for version in range(12):
        roll = rng.random()
        delta = None
        if roll < 0.15:
            arr = arr.copy()  # a rebuild: new identity
        elif roll < 0.8 and version:
            rows = np.unique(rng.integers(0, n, size=int(rng.integers(0, 4))))
            arr[rows] = rng.integers(0, 100, size=len(rows))
            flags[rows] = ~flags[rows]
            delta = rows
        for name, col, prep in (("w", arr, lambda a: a.astype(np.int32)), ("f", flags, None)):
            hv = pcache.held_version(name, col)
            assert hv == jc.held_version(name, col)
            kw = dict(version=version, prepare=prep, delta_rows=delta,
                      row_prepare=prep)
            got = pcache.put(name, col, **kw)
            want = jc.put(name, col, **kw)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            expect = col if prep is None else prep(col)
            np.testing.assert_array_equal(got.numpy(), expect)
            held.append((got, got.clone()))
        assert (pcache.uploads, pcache.scatters) == (jc.uploads, jc.scatters)
    assert pcache.scatters > 0
    for t, snapshot in held:
        assert torch.equal(t, snapshot)


# -- DripColumns / GangColumns ----------------------------------------------------


def twin_columns(clusters, kind="drip", **kw):
    out, tels = {}, {}
    for side, c in clusters.items():
        m = SIDES[side]
        tels[side] = m["Telemetry"]()
        tracker = m["FitTracker"](c, telemetry=tels[side])
        cls = m["DripColumns"] if kind == "drip" else m["GangColumns"]
        out[side] = cls(c, dyn_weight=3, order=("dyn", "fit"), fit_tracker=tracker,
                        telemetry=tels[side], policy=m["policy"], **kw)
    return out, tels


COLUMN_ATTRS = ("schedulable", "fail_entry", "score", "weighted", "bounded", "free")


def assert_columns_equal(cols):
    j, p = cols["jax"], cols["port"]
    assert p.names == j.names
    for attr in COLUMN_ATTRS:
        np.testing.assert_array_equal(getattr(p, attr), getattr(j, attr), err_msg=attr)
    assert p.stats == j.stats
    assert p.col_epoch == j.col_epoch
    for a in range(max(0, j.col_epoch - 5), j.col_epoch + 1):
        for b in range(a, j.col_epoch + 1):
            want, got = j.dirty_rows_between(a, b), p.dirty_rows_between(a, b)
            assert (got is None) == (want is None)
            if want is not None:
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_drip_columns_patch_dirty_rows_like_the_reference(seed):
    """Seeded writes between ``ensure`` calls, with a top-k tree and a fold
    in between: journal-covered patches re-read only dirty rows
    (``dirty_patches``/``dirty_rows``, the scatter log, tree updates),
    membership changes splice, uncovered intervals sweep once."""
    rng = random.Random(200 + seed)
    specs = fuzz_node_specs(rng, 24)
    clusters = twin_clusters(specs)
    cols, tels = twin_columns(clusters)
    names = [s[0] for s in specs]
    vec = np.array([500, 1 << 28, 0, 1], np.int64)
    for step in range(20):
        for side, c in cols.items():
            c.ensure(NOW)
            tree = c.topk_for(vec)
            if tree.feasible_count and step % 3 == 0:
                c.fold_row(tree.argmax_first(), vec)
        assert_columns_equal(cols)
        fn = random_write(rng, names, step)
        for side, c in clusters.items():
            fn(side, c)
    st = cols["port"].stats
    assert st["dirty_patches"] > 0 and st["dirty_rows"] > 0 and st["full_sweeps"] > 1
    key = 'crane_dirty_rows_total{consumer="drip"}'
    assert tels["port"].registry.snapshot().get(key) == tels["jax"].registry.snapshot().get(key)


@pytest.mark.parametrize("seed", range(3))
def test_gang_columns_accel_column_matches_reference(seed):
    """The interned accelerator column: label changes on known nodes patch
    O(dirty) rows, a new node rebuilds; ids, type table, epochs and the
    ``crane_gang_column_*`` / ``consumer="gang"`` families agree."""
    rng = random.Random(300 + seed)
    specs = fuzz_node_specs(rng, 16)
    accels = ["a100", "v100", "", "h100"]
    labels = [{"accel": rng.choice(accels)} for _ in specs]
    clusters = twin_clusters(specs, labels=labels)
    cols, tels = twin_columns(clusters, kind="gang", accel_label="accel")
    for step in range(10):
        for c in cols.values():
            c.ensure(NOW)
            c.ensure_accel()
        j, p = cols["jax"], cols["port"]
        np.testing.assert_array_equal(p.accel, j.accel)
        assert (p.accel_types, p.accel_epoch) == (j.accel_types, j.accel_epoch)
        assert_columns_equal(cols)
        i = rng.randrange(len(specs))
        name, anno, alloc = specs[i]
        label = {"accel": rng.choice(accels)}
        kind = rng.choice(["label", "patch", "new"])
        for side, c in clusters.items():
            node_cls = SIDES[side]["Node"]
            if kind == "label":
                node = c.get_node(name)
                c.add_node(node_cls(name=name, annotations=dict(node.annotations),
                                    labels=label, allocatable=node.allocatable))
            elif kind == "patch":
                c.patch_node_annotation(name, METRICS[0], _anno(0.4, 20.0))
            else:
                c.add_node(node_cls(name=f"new{step}", labels=label))
    snaps = {side: t.registry.snapshot() for side, t in tels.items()}
    fams = {k for k in snaps["jax"] if k.startswith("crane_gang_column")
            or k.startswith("crane_dirty_rows_total")}
    assert fams and {k: snaps["port"].get(k) for k in fams} == {
        k: snaps["jax"][k] for k in fams}
