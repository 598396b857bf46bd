"""Two processes on ``torch.distributed`` (gloo over localhost) against the
JAX package's single-process step on its 8 virtual CPU devices.

Each process owns half the node axis (``partition_nodes``) on four CPU
tiles, builds its own store shard (``tests/distributed_worker.py``'s
annotations, capacities and offsets), uploads it with
``prepare_from_local_shard`` and runs the combined-score step; the packed
result is replicated, so both ranks print the whole vector. The same
processes also run a drip window over a mesh spanning both. The full loop
shares one stub apiserver (``tests/kube_stub.py``) between two processes:
rank 0 annotates and binds, both mirror and solve. This file doubles as
the worker (``python test_torch_distributed.py <rank> <port> <mode>``).
Tolerance: identical packed words on both ranks, equal to the reference's
step; drip verdicts identical to the reference's shard-parallel window.
"""

import importlib.util
import json
import os
import random
import socket
import subprocess
import sys

_TESTS = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_TESTS)
_REF_WORKER = os.path.join(_TESTS, "distributed_worker.py")
LOCAL_TILES = 4
DRIP_NODES, DRIP_PODS = 300, 24


def _reference_worker():
    spec = importlib.util.spec_from_file_location("distributed_worker", _REF_WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def drip_inputs():
    import numpy as np

    rng = random.Random(17)
    n, k = DRIP_NODES, DRIP_PODS
    schedulable = np.array([rng.random() < 0.8 for _ in range(n)])
    weighted = np.array([rng.randrange(0, 6) for _ in range(n)], dtype=np.int64)
    bounded = np.array([rng.random() < 0.7 for _ in range(n)])
    free = np.array([[rng.randrange(0, 4000), rng.randrange(0, 2 << 30),
                      rng.randrange(0, 1 << 20), rng.randrange(0, 20)]
                     for _ in range(n)], dtype=np.int64)
    vecs = np.array([[rng.randrange(0, 3000), rng.randrange(0, 1 << 30), 0, 1]
                     for _ in range(k)], dtype=np.int64)
    return schedulable, weighted, bounded, free, vecs


# -- worker side (port only) --------------------------------------------------------


def _port_shard(store, names, now):
    from crane_scheduler_tpu_torch.loadstore import encode_annotation

    for name in names:
        gidx = int(name.split("-")[1])
        anno = {}
        for j, m in enumerate(store.tensors.metric_names):
            usage = ((gidx * 7 + j * 13) % 97) / 100.0
            age = 600.0 if (gidx + j) % 11 == 0 else 30.0
            anno[m] = encode_annotation(usage, now - age)
        if gidx % 3 == 0:
            anno["node_hot_value"] = encode_annotation(float(gidx % 4), now - 10.0)
        store.ingest_node_annotations(name, anno)


def _init(rank, port):
    import torch

    from crane_scheduler_tpu_torch.parallel import initialize

    torch.set_num_threads(1)
    initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")


def worker_step(rank, port):
    import numpy as np
    import torch

    from crane_scheduler_tpu_torch.loadstore import NodeLoadStore
    from crane_scheduler_tpu_torch.parallel import (
        ShardedScheduleStep,
        global_node_mesh,
        partition_nodes,
        prepare_from_local_shard,
    )
    from crane_scheduler_tpu_torch.parallel.distributed import shutdown
    from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY, compile_policy
    from crane_scheduler_tpu_torch.scorer.drip_batch import DripBatchKernel

    w = _reference_worker()
    _init(rank, port)
    cpu = torch.device("cpu")
    mesh = global_node_mesh([cpu] * LOCAL_TILES)
    assert mesh.size == 2 * LOCAL_TILES and mesh.first_tile == rank * LOCAL_TILES
    names = [f"node-{i:04d}" for i in range(w.N_NODES)]
    mine = partition_nodes(names, 2, rank)
    tensors = compile_policy(DEFAULT_POLICY)
    store = NodeLoadStore(tensors)
    _port_shard(store, mine, w.NOW)
    snap = store.snapshot(bucket=len(mine))
    capacity, offsets = w.gang_vectors(mine)
    out = {"process": rank}
    for key, dtype in (("packed", torch.float64), ("packed_hybrid", torch.float32)):
        step = ShardedScheduleStep(tensors, mesh, dtype=dtype, dynamic_weight=3,
                                   max_offset=200)
        prepared = prepare_from_local_shard(step, snap, w.NOW, capacity=capacity,
                                            offsets=offsets)
        out[key] = step.packed(prepared, w.NUM_PODS).result().tolist()
        res = step(prepared, w.NUM_PODS)
        out[key + "_counts"] = res.counts.tolist()
    drip = DripBatchKernel(mesh=global_node_mesh([cpu] * 2))
    out["drip"] = [np.asarray(a).tolist() for a in drip.dispatch(*drip_inputs())]
    shutdown()
    print(json.dumps(out), flush=True)
    return 0


def _wait(predicate, timeout=30.0):
    import time

    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


def worker_full_loop(rank, port, stub_url):
    """``distributed_worker.full_loop`` on the port: rank 0 runs the
    annotator and binds; both ranks mirror the stub, ingest their own node
    shard and solve over the global mesh. Rank 0 also records every
    node's annotations each cycle (``annotations``), from which the test
    solves the whole cluster with the reference."""
    import numpy as np
    import torch

    from crane_scheduler_tpu_torch.annotator import AnnotatorConfig, NodeAnnotator
    from crane_scheduler_tpu_torch.cluster.kube import KubeClusterClient
    from crane_scheduler_tpu_torch.framework.scheduler import BatchScheduler
    from crane_scheduler_tpu_torch.loadstore import NodeLoadStore
    from crane_scheduler_tpu_torch.metrics import FakeMetricsSource
    from crane_scheduler_tpu_torch.parallel import (
        ShardedScheduleStep,
        global_node_mesh,
        partition_nodes,
        prepare_from_local_shard,
    )
    from crane_scheduler_tpu_torch.parallel.distributed import shutdown
    from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY, compile_policy
    from crane_scheduler_tpu_torch.utils import format_local_time

    w = _reference_worker()
    _init(rank, port)
    client = KubeClusterClient(stub_url)
    client.start()
    all_names = sorted(n.name for n in client.list_nodes())
    assert len(all_names) == w.LOOP_NODES
    mine = partition_nodes(all_names, 2, rank)
    tensors = compile_policy(DEFAULT_POLICY)
    leader = rank == 0
    annotator = None
    if leader:
        fake = FakeMetricsSource()
        for name in all_names:
            gidx = int(name.split("-")[1])
            node = client.get_node(name)
            for j, m in enumerate(tensors.metric_names):
                fake.set(m, node.internal_ip(), ((gidx * 7 + j * 13) % 80) / 100.0, by="ip")
        annotator = NodeAnnotator(client, fake, DEFAULT_POLICY, AnnotatorConfig(bulk_sync=True))
        annotator.event_ingestor.start()
    cpu = torch.device("cpu")
    step = ShardedScheduleStep(tensors, global_node_mesh([cpu] * LOCAL_TILES),
                               dtype=torch.float64, dynamic_weight=3)
    store = NodeLoadStore(tensors)
    cycles, annotations, bound = [], [], 0
    for cycle in range(w.LOOP_CYCLES):
        cycle_now = w.NOW + 100.0 * cycle
        if leader:
            annotator.sync_all_once_bulk(cycle_now)
        ts_str = format_local_time(cycle_now)
        wanted = list(tensors.metric_names) + ["node_hot_value"]

        def swept(names=all_names):
            return all((client.get_node(n).annotations or {}).get(k, "").endswith(ts_str)
                       for n in names for k in wanted)

        assert _wait(swept), f"p{rank}: sweep did not propagate"
        store.bulk_ingest((name, client.get_node(name).annotations) for name in mine)
        snap = store.snapshot(bucket=len(mine))
        prepared = prepare_from_local_shard(step, snap, cycle_now + 1.0)
        packed = step.packed(prepared, w.LOOP_PODS).result()
        cycles.append(packed.tolist())
        if leader:
            annotations.append({n: dict(client.get_node(n).annotations or {})
                                for n in all_names})
        _sched, scores, counts, _un, _ = step.unpack(packed, w.LOOP_NODES)
        if leader:
            keys = [f"default/p{cycle}-{k}" for k in range(int(np.asarray(counts).sum()))]
            assignments, _ = BatchScheduler._expand_counts(scores, counts, all_names, keys)
            for key, node_name in assignments.items():
                assert client.bind_pod(key, node_name)
            bound += len(assignments)
            assert _wait(lambda: annotator.event_ingestor.translated >= bound), \
                "events did not reach the binding heap"
    print(json.dumps({"process": rank, "cycles": cycles, "annotations": annotations}),
          flush=True)
    client.stop()
    shutdown()
    return 0


# -- pytest side ---------------------------------------------------------------------


def _spawn(mode, extra=(), timeout=240):
    """Two workers on a fresh port; a survivor of a failed peer (blocked in
    a gloo collective) is killed."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([_REPO, _TESTS, env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(rank), str(port),
                               mode, *extra], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=env, text=True, cwd=_REPO)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_partition_nodes_matches_reference():
    from crane_scheduler_tpu.parallel import partition_nodes as ref_partition
    from crane_scheduler_tpu_torch.parallel import partition_nodes

    for n, procs in ((10, 3), (7, 7), (3, 5), (128, 2), (0, 2)):
        names = [f"n{i}" for i in range(n)]
        shards = [partition_nodes(names, procs, p) for p in range(procs)]
        assert shards == [ref_partition(names, procs, p) for p in range(procs)]
        assert sum(shards, []) == names


def test_two_process_step_matches_reference_single_process():
    import jax.numpy as jnp
    import numpy as np

    from crane_scheduler_tpu.loadstore import NodeLoadStore
    from crane_scheduler_tpu.parallel import ShardedScheduleStep, make_node_mesh
    from crane_scheduler_tpu.parallel.mesh import make_placement_mesh
    from crane_scheduler_tpu.policy import DEFAULT_POLICY, compile_policy
    from test_torch_drip import jax_drip_reference

    w = _reference_worker()
    tensors = compile_policy(DEFAULT_POLICY)
    store = NodeLoadStore(tensors)
    names = [f"node-{i:04d}" for i in range(w.N_NODES)]
    w.build_shard(store, names)
    snap = store.snapshot(bucket=w.N_NODES)
    step = ShardedScheduleStep(tensors, make_node_mesh(8), dtype=jnp.float64,
                               dynamic_weight=3, max_offset=200)
    capacity, offsets = w.gang_vectors(names)
    prepared = step.prepare(snap, w.NOW, capacity=capacity, offsets=offsets)
    want = np.asarray(step.packed(prepared, w.NUM_PODS))
    want_counts = np.asarray(step(prepared, w.NUM_PODS).counts)
    # the reference's shard-parallel window over as many tiles as the two
    # workers' mesh spans
    with jax_drip_reference() as ref_window:
        kern = ref_window.DripBatchKernel(mesh=make_placement_mesh(2 * 2))
        drip = [np.asarray(a) for a in kern.dispatch(*drip_inputs())]

    outs = _spawn("step")
    assert [o["process"] for o in outs] == [0, 1]
    for out in outs:
        for key in ("packed", "packed_hybrid"):
            got = np.asarray(out[key], dtype=np.uint32)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(out[key + "_counts"], want_counts)
        for g, d in zip(out["drip"], drip):
            np.testing.assert_array_equal(g, d)


def test_two_process_full_loop_over_kube_stub():
    """Both ranks see identical packed results every cycle, equal to the
    reference's step over 8 devices solving the whole cluster from the
    same annotations; the binds land; the second cycle sees the first
    one's feedback."""
    import jax.numpy as jnp
    import numpy as np

    from crane_scheduler_tpu.loadstore import NodeLoadStore
    from crane_scheduler_tpu.parallel import ShardedScheduleStep, make_node_mesh
    from crane_scheduler_tpu.policy import DEFAULT_POLICY, compile_policy

    spec = importlib.util.spec_from_file_location("kube_stub_torch_dist",
                                                  os.path.join(_TESTS, "kube_stub.py"))
    kube_stub = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kube_stub)
    w = _reference_worker()
    server = kube_stub.KubeStubServer().start()
    try:
        for i in range(w.LOOP_NODES):
            server.state.add_node(f"node-{i:04d}", f"10.8.0.{i}")
        for cycle in range(w.LOOP_CYCLES):
            for k in range(w.LOOP_PODS):
                server.state.add_pod("default", f"p{cycle}-{k}")
        a, b = _spawn("full_loop", (server.url,))
        assert a["cycles"] == b["cycles"]
        assert len(a["cycles"]) == len(a["annotations"]) == w.LOOP_CYCLES
        tensors = compile_policy(DEFAULT_POLICY)
        step = ShardedScheduleStep(tensors, make_node_mesh(8), dtype=jnp.float64,
                                   dynamic_weight=3)
        for cycle, (words, annos) in enumerate(zip(a["cycles"], a["annotations"])):
            store = NodeLoadStore(tensors)
            store.bulk_ingest(sorted(annos.items()))
            prepared = step.prepare(store.snapshot(bucket=w.LOOP_NODES),
                                    w.NOW + 100.0 * cycle + 1.0)
            want = np.asarray(step.packed(prepared, w.LOOP_PODS))
            np.testing.assert_array_equal(np.asarray(words, dtype=want.dtype), want)
        assert a["cycles"][0] != a["cycles"][1]
        bound = [key for key, pod in server.state.pods.items() if pod["spec"].get("nodeName")]
        assert len(bound) == w.LOOP_CYCLES * w.LOOP_PODS
    finally:
        server.stop()


if __name__ == "__main__":
    rank, port, mode = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    if mode == "step":
        raise SystemExit(worker_step(rank, port))
    raise SystemExit(worker_full_loop(rank, port, sys.argv[4]))
