"""The gang queue on the CPU: the port's ``GangBatchKernel``,
``gang_window_host``, ``BatchScheduler.schedule_gang``,
``schedule_gang_queue`` and ``schedule_batch_mixed`` against the JAX
package and the sequential ``gang_assign_oracle``, on twin inputs made
from one seed (up to a few hundred nodes, up to 12 gangs).

Tolerance: exact. Counts, unassigned counts, waterlines, placements node
for node, unassigned keys, outcome sources, ``gang_stats()`` counters,
cluster versions, RNG states and the ``crane_gang_*`` registry entries are
equal.

The JAX window (``crane_scheduler_tpu/scorer/gang_batch.py``) and the drip
window it imports do not import under jax 0.9 without
``jax.experimental.enable_x64``. The ``jax_gang`` fixture sets that name
for this module only and, on teardown, restores ``jax.experimental`` and
removes every ``crane_scheduler_tpu`` module it loaded; the modules those
two windows load lazily are imported at the top of this file, so the
fixture loads the two windows alone.
"""

import contextlib
import importlib
import random
import sys

import numpy as np
import pytest
import torch

from crane_scheduler_tpu.cluster import ClusterState, Container, Node, OwnerReference, Pod
from crane_scheduler_tpu.cluster import ResourceRequirements
from crane_scheduler_tpu.fit.tracker import copy_counts_rows
from crane_scheduler_tpu.framework import drip as _jax_drip_columns  # noqa: F401
from crane_scheduler_tpu.framework.scheduler import BatchScheduler
# what the reference windows import lazily, loaded here so that the
# fixture below loads (and later removes) the two windows alone
from crane_scheduler_tpu.native import codec as _jax_native_codec  # noqa: F401
from crane_scheduler_tpu.parallel import sharded as _jax_sharded  # noqa: F401
from crane_scheduler_tpu.policy import DEFAULT_POLICY
from crane_scheduler_tpu.scorer.topk import gang_assign_oracle
from crane_scheduler_tpu.telemetry import Telemetry
from crane_scheduler_tpu.topology import batched as _jax_topology_batched  # noqa: F401
from crane_scheduler_tpu_torch import cluster as pc
from crane_scheduler_tpu_torch.framework.scheduler import BatchScheduler as PortScheduler
from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY as PORT_POLICY
from crane_scheduler_tpu_torch.scorer import gang_batch as port_gang
from crane_scheduler_tpu_torch.telemetry import Telemetry as PortTelemetry
from test_drip_columnar import METRICS, NOW, _anno, fuzz_node_specs

REF_WINDOWS = ("crane_scheduler_tpu.scorer.gang_batch", "crane_scheduler_tpu.scorer.drip_batch")
DEFAULT_HV = [5, 2]
SIDES = {
    "jax": dict(ClusterState=ClusterState, Node=Node, Pod=Pod, Container=Container,
                ResourceRequirements=ResourceRequirements, OwnerReference=OwnerReference,
                Telemetry=Telemetry),
    "port": dict(ClusterState=pc.ClusterState, Node=pc.Node, Pod=pc.Pod,
                 Container=pc.Container, ResourceRequirements=pc.ResourceRequirements,
                 OwnerReference=pc.OwnerReference, Telemetry=PortTelemetry),
}
SHAPES = ((500, 6), (1000, 4), (250, 9), (1500, 3), (500, 5), (2000, 2), (750, 7),
          (500, 4), (1000, 3), (250, 5), (1500, 2), (750, 3))


@contextlib.contextmanager
def jax_gang_reference():
    """Import the JAX gang window with the ``enable_x64`` shim; on exit
    restore ``jax.experimental`` and drop every ``crane_scheduler_tpu``
    module loaded meanwhile, with its attribute on the parent package."""
    import jax
    import jax.experimental as jexp

    missing = object()
    prev = vars(jexp).get("enable_x64", missing)
    before = set(sys.modules)
    jexp.enable_x64 = jax.enable_x64
    try:
        yield importlib.import_module(REF_WINDOWS[0])
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


def test_reference_shim_loads_the_two_windows_alone():
    """Runs before any test takes the ``jax_gang`` fixture (file order)."""
    assert not any(m in sys.modules for m in REF_WINDOWS)
    state = _jexp_state()
    loaded = {m for m in sys.modules if m.startswith("crane_scheduler_tpu.")}
    with jax_gang_reference() as mod:
        assert mod.__name__ == REF_WINDOWS[0]
        new = {m for m in sys.modules if m.startswith("crane_scheduler_tpu.")} - loaded
        assert new == set(REF_WINDOWS)
    assert {m for m in sys.modules if m.startswith("crane_scheduler_tpu.")} == loaded
    assert _jexp_state() == state
    with pytest.raises(ImportError, match="enable_x64"):
        importlib.import_module(REF_WINDOWS[0])
    assert not any(m in sys.modules for m in REF_WINDOWS)


@pytest.fixture(scope="module")
def jax_gang():
    state = _jexp_state()
    with jax_gang_reference() as mod:
        yield mod
    assert not any(m in sys.modules for m in REF_WINDOWS)
    assert _jexp_state() == state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is faster here and leaves the
    other test workers their cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- the window: device twin vs reference vs host twin vs oracle ---------------


def fuzz_window(rng: random.Random, with_offsets: bool):
    n = rng.randrange(3, 60)
    k = rng.randrange(1, 8)
    w = rng.choice([1, 3])
    mo = 200 if with_offsets else rng.choice([0, 200])
    hv = rng.choice([DEFAULT_HV, []])
    scores = np.array([rng.randrange(0, 101) for _ in range(n)], np.int64)
    sched = np.array([rng.random() < 0.85 for _ in range(n)])
    bounded = np.array([rng.random() < 0.7 for _ in range(n)])
    free = np.array([[rng.randrange(-500, 8000), rng.randrange(0, 1 << 34),
                      rng.randrange(0, 1 << 20), rng.randrange(0, 30)] for _ in range(n)],
                    np.int64)
    n_classes = rng.randrange(1, 4)
    vecs = np.array([[rng.choice([0, 250, 1000, 3000]), rng.choice([0, 1 << 28]), 0, 1]
                     for _ in range(n_classes)], np.int64)
    offs = None
    if with_offsets:
        offs = [np.array([rng.randrange(0, mo + 1) for _ in range(n)], np.int32)
                for _ in range(n_classes)]
    class_id = np.array([rng.randrange(n_classes) for _ in range(k)], np.int32)
    pods = np.array([rng.randrange(0, 30) for _ in range(k)], np.int64)
    return dict(n=n, k=k, w=w, mo=mo, hv=hv, scores=scores, sched=sched, bounded=bounded,
                free=free, vecs=vecs, offs=offs, class_id=class_id, pods=pods)


@pytest.mark.parametrize("with_offsets", [False, True], ids=["plain", "offsets"])
@pytest.mark.parametrize("seed", range(6))
def test_window_matches_reference_host_twin_and_oracle(jax_gang, seed, with_offsets):
    """Two windows in a row on one kernel (the second reuses the folded
    carry, as after an accepted window): counts, unassigned and waterline
    equal the JAX window, ``gang_window_host`` and the per-gang oracle
    with the folds replayed by hand; the carry equals the host fold."""
    rng = random.Random(1000 * seed + with_offsets)
    c = fuzz_window(rng, with_offsets)
    port = port_gang.GangBatchKernel(c["hv"], dynamic_weight=c["w"], max_offset=c["mo"],
                                     device="cpu")
    ref = jax_gang.GangBatchKernel(c["hv"], dynamic_weight=c["w"], max_offset=c["mo"])
    free = c["free"]
    for window in range(2):
        args = (c["scores"], c["sched"], c["bounded"], free, c["vecs"], c["offs"],
                c["class_id"], c["pods"])
        got = port.dispatch(*args)
        want = ref.dispatch(*args)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, np.asarray(a))
        gangs = [(int(c["pods"][j]), c["vecs"][c["class_id"][j]],
                  None if c["offs"] is None else c["offs"][c["class_id"][j]])
                 for j in range(c["k"])]
        host, free_after = port_gang.gang_window_host(
            c["scores"], c["sched"], c["bounded"], free, gangs, c["hv"],
            dynamic_weight=c["w"], max_offset=c["mo"])
        free_c = free.copy()
        for j, (num, vec, off) in enumerate(gangs):
            assert np.array_equal(got[0][j], host[j].counts)
            assert (int(got[1][j]), int(got[2][j])) == (host[j].unassigned, host[j].waterline)
            cap = copy_counts_rows(free_c, c["bounded"], vec)
            o = gang_assign_oracle(c["scores"], c["sched"], num, c["hv"], capacity=cap,
                                   offsets=off, dynamic_weight=c["w"], max_offset=c["mo"])
            assert np.array_equal(got[0][j], o.counts) and int(got[1][j]) == o.unassigned
            free_c -= np.asarray(o.counts, np.int64)[:, None] * vec[None, :]
        np.testing.assert_array_equal(free_after, free_c)
        np.testing.assert_array_equal(port._free_dev.numpy(), free_c)
        port.mark_synced(free_c)
        ref.mark_synced(free_c)
        free = free_c
    assert (port.dispatches, port.free_uploads) == (ref.dispatches, ref.free_uploads) == (2, 1)


@pytest.mark.parametrize("fold", [True, False], ids=["fold", "nofold"])
@pytest.mark.parametrize("policy", [None, "fragmentation", "seeded"])
@pytest.mark.parametrize("seed", range(2))
def test_host_window_matches_reference(jax_gang, seed, policy, fold):
    """``gang_window_host`` under each tie policy, folding or not: results,
    the folded free matrix and the seeded generator's state agree."""
    rng = random.Random(50 + seed)
    c = fuzz_window(rng, with_offsets=seed == 1)
    gangs = [(int(c["pods"][j]), c["vecs"][c["class_id"][j]],
              None if c["offs"] is None else c["offs"][c["class_id"][j]])
             for j in range(c["k"])]
    out = {}
    for side, fn in (("jax", jax_gang.gang_window_host), ("port", port_gang.gang_window_host)):
        tie_rng = np.random.default_rng(seed) if policy == "seeded" else None
        res, free_after = fn(c["scores"], c["sched"], c["bounded"], c["free"], gangs, c["hv"],
                             dynamic_weight=c["w"], max_offset=c["mo"], tie_policy=policy,
                             tie_rng=tie_rng, fold=fold)
        out[side] = ([(r.counts.tolist(), int(r.unassigned), int(r.waterline)) for r in res],
                     free_after.tolist(),
                     None if tie_rng is None else tie_rng.bit_generator.state)
    assert out["port"] == out["jax"]
    frag = port_gang.stranded_copies([3, 1, 5], [1, 0, 6], [1, 1, 0])
    np.testing.assert_array_equal(frag, _jax_topology_batched.stranded_copies(
        [3, 1, 5], [1, 0, 6], [1, 1, 0]))


# -- the scheduler entry points on twin clusters --------------------------------


def gang_specs(seed: int, n: int):
    """Fuzzed annotations (missing, stale, negative, hot values) with
    bounded allocatable on most nodes, a few left unbounded."""
    rng = random.Random(seed)
    specs = fuzz_node_specs(rng, n)
    out = []
    for i, (name, anno, _alloc) in enumerate(specs):
        alloc = None if i % 7 == 3 else {"cpu": str(4 + (i % 3) * 2), "memory": "64Gi",
                                          "pods": "100"}
        out.append((name, anno, alloc))
    return out


def build_twin(side, specs, labels=None, dtype="f64", telemetry=None):
    m = SIDES[side]
    cluster = m["ClusterState"]()
    for i, (name, anno, alloc) in enumerate(specs):
        kw = {"allocatable": alloc} if alloc else {}
        if labels is not None:
            kw["labels"] = labels[i]
        cluster.add_node(m["Node"](name=name, annotations=dict(anno), **kw))
    clock = lambda: NOW  # noqa: E731
    if side == "jax":
        import jax.numpy as jnp

        dt = jnp.float64 if dtype == "f64" else jnp.float32
        return BatchScheduler(cluster, DEFAULT_POLICY, dtype=dt, clock=clock,
                              snapshot_bucket=64, telemetry=telemetry)
    dt = torch.float64 if dtype == "f64" else torch.float32
    return PortScheduler(cluster, PORT_POLICY, dtype=dt, clock=clock, snapshot_bucket=64,
                         telemetry=telemetry, device="cpu")


def template(side, name, cpu_milli, extra=None, daemonset=False):
    m = SIDES[side]
    kw = {}
    if daemonset:
        kw["owner_references"] = (m["OwnerReference"](kind="DaemonSet", name="ds"),)
    requests = {"cpu": f"{cpu_milli}m", "memory": "256Mi", **(extra or {})}
    return m["Pod"](name=name, namespace="default", containers=(
        m["Container"]("c", m["ResourceRequirements"](requests=requests)),), **kw)


def requests_for(side, shapes):
    return [(template(side, f"g{i}", cpu), count) for i, (cpu, count) in enumerate(shapes)]


def outcomes(outs):
    return [(dict(o.assignments), sorted(o.unassigned), o.waterline, o.source) for o in outs]


def stats(batch):
    st = batch.gang_stats()
    st.pop("kernel_seconds")
    return st


def versions(cluster):
    return (cluster.sched_version, cluster.pod_version, cluster.node_version)


@pytest.mark.parametrize("bind", [True, False], ids=["bind", "preview"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_schedule_gang_matches_reference(dtype, bind):
    """A sequential ``schedule_gang`` loop (K1 and K2 on the card; their
    plain versions here): assignments, unassigned keys, scores, verdicts
    and cluster versions equal the JAX package's."""
    specs = gang_specs(7, 90)
    out = {}
    for side in SIDES:
        batch = build_twin(side, specs, dtype=dtype)
        results = [batch.schedule_gang(t, c, bind=bind)
                   for t, c in requests_for(side, SHAPES[:6])]
        out[side] = ([(r.assignments, r.unassigned, r.scores, r.schedulable)
                      for r in results], versions(batch.cluster))
    assert out["port"] == out["jax"]
    assert sum(len(r[0]) for r in out["port"][0]) > 0


def oracle_window(batch, reqs):
    """The first window through ``gang_assign_oracle`` over a fresh engine's
    own columns, the folds replayed by hand, expanded in stable
    score-descending order."""
    from crane_scheduler_tpu_torch.fit.tracker import pod_fit_request, request_vec

    cols = batch._ensure_gang(3, 2, None)["cols"]
    cols.ensure(NOW)
    free = cols.free.copy()
    by_score = np.argsort(-cols.score, kind="stable")
    out = []
    for t, count in reqs:
        vec = request_vec(pod_fit_request(t))
        o = gang_assign_oracle(cols.score, cols.schedulable, count, batch.tensors.hv_count,
                               capacity=copy_counts_rows(free, cols.bounded, vec),
                               dynamic_weight=3, max_offset=200)
        free -= np.asarray(o.counts, np.int64)[:, None] * vec[None, :]
        order = np.repeat(by_score, np.asarray(o.counts)[by_score])
        keys = [f"{t.namespace}/{t.name}-{i}" for i in range(count)]
        out.append({k: cols.names[int(i)] for k, i in zip(keys, order)})
    return out


@pytest.mark.parametrize("bind", [True, False], ids=["bind", "preview"])
@pytest.mark.parametrize("window", [1, 3, 8])
def test_gang_queue_matches_reference_loop_and_oracle(jax_gang, window, bind):
    """``schedule_gang_queue`` over 12 heterogeneous gangs: outcomes and
    ``gang_stats()`` equal the JAX queue's, placements equal the port's
    sequential ``schedule_gang`` loop and, for the first window, the
    oracle."""
    specs = gang_specs(11, 120)
    out = {}
    for side in SIDES:
        batch = build_twin(side, specs)
        outs = batch.schedule_gang_queue(requests_for(side, SHAPES), window=window, bind=bind)
        out[side] = (outcomes(outs), stats(batch), versions(batch.cluster))
    assert out["port"] == out["jax"]
    st = out["port"][1]
    assert st["windows"] == -(-len(SHAPES) // window) and st["fallbacks"] == 0
    if bind:
        assert st["kernel_dispatches"] == st["windows"] and st["free_uploads"] == 1
    seq_batch = build_twin("port", specs)
    seq = [seq_batch.schedule_gang(t, c, bind=bind)
           for t, c in requests_for("port", SHAPES)]
    assert [(a, u) for a, u, _, _ in out["port"][0]] == [
        (r.assignments, sorted(r.unassigned)) for r in seq]
    if bind:
        first = requests_for("port", SHAPES[:window])
        assert oracle_window(build_twin("port", specs), first) == [
            a for a, _, _, _ in out["port"][0][:window]]
    assert sum(len(a) for a, _, _, _ in out["port"][0]) > 0


def test_scalar_resource_gang_falls_back_in_queue_order(jax_gang):
    out = {}
    for side in SIDES:
        batch = build_twin(side, gang_specs(3, 60))
        reqs = requests_for(side, SHAPES[:3])
        reqs.insert(1, (template(side, "gpu", 250, extra={"example.com/gpu": "1"}), 2))
        outs = batch.schedule_gang_queue(reqs, window=8)
        out[side] = (outcomes(outs), stats(batch), versions(batch.cluster))
    assert out["port"] == out["jax"]
    assert [o[3] for o in out["port"][0]] == ["window", "fallback", "window", "window"]
    assert out["port"][1]["fallbacks"] == 1


@pytest.mark.parametrize("forget", [False, True], ids=["journal", "swept"])
def test_named_patch_between_windows(jax_gang, forget):
    """A named annotation patch between two queue calls rides the journal
    (one dirty row, a device scatter, no new upload); after
    ``forget_dirty_names`` the same patch takes one identity sweep. Both
    equal the reference and the sequential loop."""
    specs = gang_specs(23, 80)
    out = {}
    for side in SIDES:
        batch = build_twin(side, specs)
        reqs = requests_for(side, SHAPES[:8])
        outs = batch.schedule_gang_queue(reqs[:4], window=2)
        victim = specs[5][0]
        batch.cluster.patch_node_annotation(victim, METRICS[0], _anno(0.12, 15.0))
        if forget:
            batch.cluster.forget_dirty_names()
        outs += batch.schedule_gang_queue(reqs[4:], window=2)
        kern = batch._gang_engine["kern"]
        out[side] = (outcomes(outs), stats(batch), versions(batch.cluster),
                     (kern._cols.uploads, kern._cols.scatters))
    assert out["port"] == out["jax"]
    cols = out["port"][1]["columns"]
    if forget:
        assert cols["dirty_patches"] == 0 and cols["full_sweeps"] == 2
    else:
        assert cols["dirty_patches"] == 1 and cols["dirty_rows"] == 1
        assert cols["full_sweeps"] == 1 and out["port"][3][1] > 0
    seq_batch = build_twin("port", specs)
    seq = []
    for j, (t, c) in enumerate(requests_for("port", SHAPES[:8])):
        if j == 4:
            seq_batch.cluster.patch_node_annotation(specs[5][0], METRICS[0], _anno(0.12, 15.0))
        r = seq_batch.schedule_gang(t, c)
        seq.append((r.assignments, sorted(r.unassigned)))
    assert [(a, u) for a, u, _, _ in out["port"][0]] == seq


def test_throughput_offsets_and_accel_label_match_reference(jax_gang):
    """Per-accelerator throughput weights steer gangs to labeled nodes; a
    label change between calls patches the accel column. Outcomes, stats,
    accel columns and epochs equal the reference's."""
    specs = gang_specs(31, 60)
    rng = random.Random(31)
    labels = [{"accel": rng.choice(["a100", "v100", ""])} for _ in specs]
    tput = {"g0": {"a100": 100, "v100": 30}, "g2": {"v100": 200}}
    out = {}
    for side in SIDES:
        batch = build_twin(side, specs, labels=labels)
        reqs = requests_for(side, SHAPES[:6])
        outs = batch.schedule_gang_queue(reqs[:3], window=3, throughput=tput,
                                         accel_label="accel")
        node = batch.cluster.get_node(specs[1][0])
        batch.cluster.add_node(SIDES[side]["Node"](
            name=node.name, annotations=dict(node.annotations), labels={"accel": "a100"},
            allocatable=node.allocatable))
        outs += batch.schedule_gang_queue(reqs[3:] + reqs[:1], window=4, throughput=tput,
                                          accel_label="accel")
        cols = batch._gang_engine["cols"]
        out[side] = (outcomes(outs), stats(batch), cols.accel.tolist(), cols.accel_types,
                     cols.accel_epoch)
    assert out["port"] == out["jax"]
    a100 = {specs[i][0] for i, lab in enumerate(labels) if lab["accel"] == "a100"}
    assert set(out["port"][0][0][0].values()) <= a100 | {specs[1][0]}


@pytest.mark.parametrize("policy", ["fragmentation", "seeded"])
def test_tie_policies_in_the_queue_match_reference(jax_gang, policy):
    """Flat scores make real ties: the host window reorders the waterline
    take; window 1 and window 4 agree, and both equal the reference, RNG
    state included."""
    flat = {m: _anno(0.3, 30.0) for m in METRICS}
    specs = [(f"n{i:02d}", flat, {"cpu": "8", "memory": "64Gi", "pods": "100"})
             for i in range(12)]
    out = {}
    for side in SIDES:
        runs = []
        for window in (1, 4):
            batch = build_twin(side, specs)
            tie_rng = np.random.default_rng(7) if policy == "seeded" else None
            outs = batch.schedule_gang_queue(requests_for(side, SHAPES[:5]), window=window,
                                             tie_policy=policy, tie_rng=tie_rng)
            runs.append((outcomes(outs), stats(batch)["kernel_dispatches"],
                         None if tie_rng is None else tie_rng.bit_generator.state))
        out[side] = runs
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == out["port"][1][0]


@pytest.mark.parametrize("bind", [True, False], ids=["bind", "preview"])
@pytest.mark.parametrize("seed", range(2))
def test_schedule_batch_mixed_matches_reference(seed, bind):
    """Pending pods of three request shapes and a DaemonSet class, solved
    class by class with the hot-penalty staircase carried across classes:
    assignments, unassigned keys, verdicts and versions equal the
    reference's, and a second burst sees the first one's binds."""
    specs = gang_specs(40 + seed, 70)
    rng = random.Random(seed)
    shapes = [(rng.choice([100, 300, 700]), rng.random() < 0.15) for _ in range(60)]
    out = {}
    for side in SIDES:
        batch = build_twin(side, specs)
        results = []
        for burst in range(2):
            pods = [template(side, f"m{burst}-{i}", cpu, daemonset=ds)
                    for i, (cpu, ds) in enumerate(shapes)]
            batch.cluster.add_pods(pods)
            r = batch.schedule_batch_mixed(pods, bind=bind)
            results.append((r.assignments, r.unassigned, r.scores, r.schedulable))
        out[side] = (results, versions(batch.cluster))
    assert out["port"] == out["jax"]
    assert len(out["port"][0][0][0]) > 0


@pytest.mark.parametrize("entry", ["schedule_gang", "schedule_gang_queue",
                                   "schedule_batch_mixed"])
def test_topology_raises_naming_the_numa_slice(entry):
    """``topology=`` is ported: no entry point raises ``NotImplementedError``
    naming the NUMA slice any more. With a ``TopologyMatch`` over an empty
    lister, these burstable pods (no guaranteed CPU) are the plugin's
    no-op class, so each call places and binds exactly as without it."""
    from crane_scheduler_tpu_torch.topology import TopologyMatch
    from crane_scheduler_tpu_torch.topology.types import InMemoryNRTLister

    out = []
    for with_topology in (False, True):
        batch = build_twin("port", gang_specs(1, 8))
        topo = TopologyMatch(InMemoryNRTLister(), cluster=batch.cluster) \
            if with_topology else None
        t = template("port", "g", 100)
        if entry == "schedule_batch_mixed":
            batch.cluster.add_pod(t)
        call = {
            "schedule_gang": lambda: batch.schedule_gang(t, 2, topology=topo).assignments,
            "schedule_gang_queue": lambda: [o.assignments for o in batch.schedule_gang_queue(
                [(t, 2)], topology=topo)],
            "schedule_batch_mixed": lambda: batch.schedule_batch_mixed(
                [t], topology=topo).assignments,
        }[entry]
        out.append((call(), batch.cluster.pod_version))
    assert out[0] == out[1] and out[1][1] > 8


def test_gang_telemetry_families_match_reference(jax_gang):
    """The ``crane_gang_*`` histograms and column counters, both
    ``crane_dirty_rows_total`` consumers and the ``gang_dispatch`` spans."""
    specs = gang_specs(4, 50)
    out = {}
    for side in SIDES:
        tel = SIDES[side]["Telemetry"]()
        batch = build_twin(side, specs, telemetry=tel)
        reqs = requests_for(side, SHAPES[:5])
        batch.schedule_gang_queue(reqs[:2], window=2)
        batch.cluster.patch_node_annotation(specs[0][0], METRICS[1], _anno(0.2, 5.0))
        batch.schedule_gang_queue(reqs[2:], window=2)
        snap = tel.registry.snapshot()
        fams = {k: v for k, v in snap.items()
                if (k.startswith("crane_gang_") or k.startswith("crane_dirty_rows_total"))
                and "_seconds" not in k}
        spans, _ = tel.spans.drain_since(0)
        out[side] = (fams, sorted(s["name"] for s in spans if s["name"] == "gang_dispatch"))
    assert out["port"] == out["jax"]
    assert out["port"][1] == ["gang_dispatch"] * 3
    assert out["port"][0]['crane_dirty_rows_total{consumer="gang"}'] == 1
