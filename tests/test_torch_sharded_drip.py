"""The shard-parallel drip window against the JAX package's ``_sharded_drip_fn``.

The reference window runs on the suite's 8 virtual CPU devices
(``conftest``), inside the scoped ``enable_x64`` shim of
``test_torch_drip.jax_drip_reference()``; the port's over as many CPU
tiles. The legs are those of ``test_sharded_drip.py``'s worker: the
kernel fuzz (tie-heavy and wide score spans), the fold carry across two
windows, repartitioning mid-stream, a node count below the tile count and
the seeded tie replay at the scheduler level; then ``Scheduler``, the
config factory and ``ShardedPlacementPlane`` with ``mesh=``. Tolerance:
identical ``(chosen, feasible, ties)``, placements, RNG streams and the
column and carry counters.
"""

import random

import numpy as np
import pytest
import torch

from crane_scheduler_tpu.framework.shardplane import ShardedPlacementPlane as RefPlane
from crane_scheduler_tpu.parallel.mesh import make_placement_mesh as ref_placement_mesh
from crane_scheduler_tpu_torch.config import SchedulerConfiguration, SchedulerProfile
from crane_scheduler_tpu_torch.config import build_scheduler_from_config
from crane_scheduler_tpu_torch.framework.shardplane import ShardedPlacementPlane
from crane_scheduler_tpu_torch.parallel.mesh import make_placement_mesh
from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY as PORT_POLICY
from crane_scheduler_tpu_torch.scorer.drip_batch import DripBatchKernel
from test_drip_columnar import METRICS, _anno, fuzz_node_specs, fuzz_pod_specs
from test_torch_drip import (
    build_cluster,
    build_scheduler,
    jax_drip_reference,
    make_pod,
    outcome,
    run_mode,
)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref_kernel():
    """The reference's ``DripBatchKernel`` class, under the shim."""
    with jax_drip_reference() as mod:
        yield mod.DripBatchKernel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def mesh(s):
    return make_placement_mesh(s, [CPU] * s)


def fuzz_inputs(rng, n, k, score_span):
    schedulable = np.array([rng.random() < 0.8 for _ in range(n)])
    weighted = np.array([rng.randrange(0, score_span) for _ in range(n)], dtype=np.int64)
    bounded = np.array([rng.random() < 0.7 for _ in range(n)])
    free = np.array([[rng.randrange(0, 4000), rng.randrange(0, 2 << 30),
                      rng.randrange(0, 1 << 20), rng.randrange(0, 20)]
                     for _ in range(n)], dtype=np.int64)
    vecs = np.array([[rng.randrange(0, 3000), rng.randrange(0, 1 << 30), 0, 1]
                     for _ in range(k)], dtype=np.int64)
    return schedulable, weighted, bounded, free, vecs


def assert_same(got, want):
    for name, g, w in zip(("chosen", "feasible", "ties"), got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


def counters(kern):
    return (kern.dispatches, kern.free_uploads, kern.repartitions, kern._cols.uploads,
            kern._cols.scatters, kern._cols.repartitions)


@pytest.mark.parametrize("want_ties", [True, False], ids=["ties", "noties"])
@pytest.mark.parametrize("seed", range(6))
def test_kernel_fuzz_matches_reference(ref_kernel, seed, want_ties):
    rng = random.Random(seed)
    n = rng.randrange(5, 700)
    k = rng.randrange(1, 40)
    inputs = fuzz_inputs(rng, n, k, 5 if seed % 2 == 0 else 2**33)
    want = ref_kernel(mesh=ref_placement_mesh(8)).dispatch(*inputs, want_ties=want_ties)
    got = DripBatchKernel(mesh=mesh(8)).dispatch(*inputs, want_ties=want_ties)
    assert_same(got, want)
    assert_same(DripBatchKernel(device="cpu").dispatch(*inputs, want_ties=want_ties), want)


def test_carry_and_repartition_match_reference(ref_kernel):
    rng = random.Random(99)
    schedulable, weighted, bounded, free, vecs1 = fuzz_inputs(rng, 300, 16, 4)
    vecs2 = fuzz_inputs(rng, 1, 16, 4)[4]

    def host_fold(free, outs, vecs):
        free = free.copy()
        chosen, feasible, _ties = outs
        for i in range(len(vecs)):
            if int(feasible[i]) > 0 and int(chosen[i]) >= 0:
                free[int(chosen[i])] -= vecs[i]
        return free

    legs = {}
    for side, kern, m4 in (("ref", ref_kernel(mesh=ref_placement_mesh(8)), ref_placement_mesh(4)),
                           ("port", DripBatchKernel(mesh=mesh(8)), mesh(4))):
        out1 = kern.dispatch(schedulable, weighted, bounded, free, vecs1)
        free2 = host_fold(free, out1, vecs1)
        kern.mark_synced(free2)
        out2 = kern.dispatch(schedulable, weighted, bounded, free2, vecs2)
        after_carry = counters(kern)
        changed = [kern.repartition(m4), kern.repartition(m4)]
        desynced = kern._free_dev is None and not kern._free_synced
        out3 = kern.dispatch(schedulable, weighted, bounded, free2, vecs2)
        legs[side] = (out1, out2, out3, after_carry, changed, desynced, counters(kern))
    ref, port = legs["ref"], legs["port"]
    for g, w in zip(port[:3], ref[:3]):
        assert_same(g, w)
    assert port[3:] == ref[3:]
    assert port[3][1] == 1 and port[4] == [True, False] and port[5]
    assert port[6][1:3] == (2, 1)  # a fresh carry upload, one repartition


def test_versioned_columns_reupload_never_scatter(ref_kernel):
    """A dynamic-column version change with a row delta: the tiled window
    re-uploads (the reference's sharded path has no scatter), the
    single-device window scatters; counters equal the reference's."""
    rng = random.Random(4)
    schedulable, weighted, bounded, free, vecs = fuzz_inputs(rng, 200, 8, 9)
    for s in (1, 4):
        kerns = {"ref": ref_kernel(mesh=ref_placement_mesh(s)),
                 "port": DripBatchKernel(mesh=mesh(s))}
        outs = {}
        for side, kern in kerns.items():
            w = weighted.copy()
            outs[side] = [kern.dispatch(schedulable, w, bounded, free, vecs, col_version=1)]
            w[[3, 150]] += 7
            outs[side].append(kern.dispatch(schedulable, w, bounded, free, vecs,
                                            col_version=2,
                                            col_delta=lambda a, b: np.array([3, 150])))
        for g, w in zip(outs["port"], outs["ref"]):
            assert_same(g, w)
        assert counters(kerns["port"]) == counters(kerns["ref"])
        assert kerns["port"]._cols.scatters == (2 if s == 1 else 0)


def test_fewer_nodes_than_tiles(ref_kernel):
    tiny = fuzz_inputs(random.Random(5), 3, 4, 3)
    want = ref_kernel(mesh=ref_placement_mesh(8)).dispatch(*tiny)
    assert_same(DripBatchKernel(mesh=mesh(8)).dispatch(*tiny), want)


def test_single_tile_mesh_is_plain_window(ref_kernel):
    inputs = fuzz_inputs(random.Random(3), 37, 9, 9)
    kern = DripBatchKernel(mesh=mesh(1))
    got = kern.dispatch(*inputs)
    assert_same(got, DripBatchKernel(device="cpu").dispatch(*inputs))
    assert_same(got, ref_kernel(mesh=ref_placement_mesh(1)).dispatch(*inputs))
    assert kern.mesh.size == 1 and not isinstance(kern._free_dev, tuple)


# -- schedulers ---------------------------------------------------------------------


def queue_leg(side, node_specs, pods, window, seed=None, tiles=8):
    cluster = build_cluster(side, node_specs)
    sched = build_scheduler(side, cluster, seed=seed)
    sched._kernel_mesh = ref_placement_mesh(tiles) if side == "jax" else mesh(tiles)
    pod_objs = [make_pod(side, *spec) for spec in pods]
    for pod in pod_objs:
        cluster.add_pod(pod)
    return sched, run_mode(side, f"queue{window}", cluster, sched, pod_objs)


@pytest.mark.parametrize("seed", [0, 11])
def test_scheduler_queue_on_mesh_matches_reference_and_oracles(seed):
    rng = random.Random(seed)
    node_specs = fuzz_node_specs(rng, 60)
    pod_specs = fuzz_pod_specs(rng, 90)
    with jax_drip_reference():
        rs, want = queue_leg("jax", node_specs, pod_specs, 24)
    ps, got = queue_leg("port", node_specs, pod_specs, 24)
    assert outcome(got) == outcome(want)
    assert ps._batch_kernel.mesh.size == 8 and ps._batch_kernel.dispatches > 0
    for mode in ("perpod", "scalar"):
        cluster = build_cluster("port", node_specs)
        sched = build_scheduler("port", cluster, columnar=mode != "scalar")
        pods = [make_pod("port", *spec) for spec in pod_specs]
        for pod in pods:
            cluster.add_pod(pod)
        assert [r.node for r in run_mode("port", mode, cluster, sched, pods)] == \
            [r.node for r in got]
    assert counters(ps._batch_kernel)[:2] == counters(rs._batch_kernel)[:2]


def test_seeded_tie_replay_on_mesh_matches_reference():
    """Ten identical nodes: every window ties, the seeded window replays
    per pod, and the RNG stream equals the reference's and the per-pod
    paths'."""
    specs = [(f"node-{i:02d}", {m: _anno(0.30, 30.0) for m in METRICS}, None)
             for i in range(10)]
    pods = [(f"p{i:03d}", 0, 0, False) for i in range(100)]
    with jax_drip_reference():
        rs, want = queue_leg("jax", specs, pods, 16, seed=7)
    ps, got = queue_leg("port", specs, pods, 16, seed=7)
    assert outcome(got) == outcome(want)
    assert len({r.node for r in got}) > 1
    assert ps.drip_stats()["batch"]["replays"] == rs.drip_stats()["batch"]["replays"] > 0
    assert ps._tie_rng.getstate() == rs._tie_rng.getstate()


def test_scheduler_and_factory_take_the_mesh():
    from crane_scheduler_tpu_torch.cluster import ClusterState
    from crane_scheduler_tpu_torch.framework.scheduler import Scheduler

    m = mesh(2)
    assert Scheduler(ClusterState(), mesh=m).device == CPU
    config = SchedulerConfiguration(profiles=(SchedulerProfile(),))
    sched = build_scheduler_from_config(ClusterState(), config, policy=PORT_POLICY,
                                        device="cpu", mesh=m)
    assert sched._kernel_mesh is m


def plane_storm(side, specs, mesh_, threaded=False):
    cluster = build_cluster(side, specs)
    plane_cls = RefPlane if side == "jax" else ShardedPlacementPlane
    plane = plane_cls(cluster, 2, mesh=mesh_)
    plane.add_scheduler(lambda view: build_scheduler(side, view))
    lists = [[make_pod(side, f"s{j}-{i}", 100 + 50 * (i % 3), 1 << 20)
              for i in range(24)] for j in range(2)]
    for pods in lists:
        for pod in pods:
            cluster.add_pod(pod)
    plane.run_storm(lists, window=8, threaded=threaded)
    placed = sorted((p.key(), p.node_name) for p in cluster.list_pods())
    return plane, placed


def test_shard_plane_on_mesh_matches_plane_without_and_reference():
    rng = random.Random(8)
    specs = fuzz_node_specs(rng, 48)
    with jax_drip_reference():
        _, want = plane_storm("jax", specs, ref_placement_mesh(4))
    plane, got = plane_storm("port", specs, mesh(4))
    _, flat = plane_storm("port", specs, None)
    assert got == want == flat
    assert all(s._batch_kernel.mesh.size == 4 for s in plane.schedulers
               if s._batch_kernel is not None)
    assert any(s._batch_kernel is not None for s in plane.schedulers)
