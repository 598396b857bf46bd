"""crane-annotator: the node-annotator controller entry point.

Counterpart of ``crane_scheduler_tpu/cli/annotator_main.py``. Flags
mirror the reference controller
(ref: cmd/controller/app/options/options.go:61-76): policy file,
Prometheus address, binding heap size, concurrent syncs, health port and
leader election. Nodes come from a live apiserver through the kube
mirror (``--master URL``, ``--token-file``; election then takes the
apiserver Lease, ``service/kube_leader.py``), a JSON file
(``--nodes-file``: [{"name": ..., "ip": ...}]) or a demo cluster
(``--demo-nodes N`` with synthetic metrics); without ``--master`` the
election is a file lock. The metrics come from Prometheus
(``--prometheus-address``) or a fake source at 0.25 per metric.

``--device`` (default ``cuda``, which needs a GPU; or ``cpu``) is where
the closing check scores what the annotator wrote: on exit the cluster's
annotations are ingested into a ``NodeLoadStore`` and scored once with
the float32 ``BatchedScorer`` (the fused score kernel on the card), and
the stats line reports the schedulable count beside ``synced`` and
``sync_errors``.

Usage:
  python -m crane_scheduler_tpu_torch.cli.annotator_main \
      --policy-config-path policy.yaml --prometheus-address http://prom:9090 \
      --nodes-file nodes.json [--leader-elect --lock-file /tmp/crane.lock]
  python -m crane_scheduler_tpu_torch.cli.annotator_main \
      --master https://apiserver:6443 --token-file /path/to/token \
      --prometheus-address http://prom:9090 --leader-elect
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="crane-annotator")
    parser.add_argument("--master", default=None,
                        help="kube-apiserver URL: annotate the live "
                             "cluster through the kube mirror")
    parser.add_argument("--token-file", default=None)
    parser.add_argument("--policy-config-path", default=None)
    parser.add_argument("--prometheus-address", default="")
    parser.add_argument("--binding-heap-size", type=int, default=1024)
    parser.add_argument("--concurrent-syncs", type=int, default=1)
    parser.add_argument("--health-port", type=int, default=8090)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the closing score check: "
                             "cuda (default; needs a GPU) or cpu")
    parser.add_argument("--nodes-file", default=None)
    parser.add_argument("--demo-nodes", type=int, default=0)
    parser.add_argument("--leader-elect", action="store_true")
    parser.add_argument("--lock-file", default="/tmp/crane-annotator.lock")
    parser.add_argument("--backfill-offset", default=None,
                        help="cold-start: seed missing annotations from a "
                             "historical offset query, e.g. 3m (wires the "
                             "reference's unused offset API)")
    parser.add_argument("--run-seconds", type=float, default=0.0,
                        help="exit after N seconds (0 = run forever)")
    parser.add_argument("--flight-dir", default=None,
                        help="directory for the crash-safe flight recorder "
                             "(lifecycle records + spans as a bounded JSONL "
                             "ring); implies telemetry")
    parser.add_argument("-v", "--verbose", action="count", default=0,
                        help="raise [crane] log verbosity (-v sweeps/"
                             "windows, -vv cycles, -vvv per-pod); "
                             "default run is quiet")
    args = parser.parse_args(argv)

    if args.flight_dir:
        os.environ["CRANE_FLIGHT_DIR"] = args.flight_dir
        os.environ.setdefault("CRANE_TELEMETRY", "1")

    from ..utils.logging import set_verbosity

    if args.verbose:
        set_verbosity(args.verbose)

    from ..device import resolve_device

    device = resolve_device(args.device)

    from ..annotator import AnnotatorConfig, NodeAnnotator
    from ..cluster import ClusterState, Node, NodeAddress
    from ..policy import DEFAULT_POLICY, load_policy_from_file
    from ..resilience import CircuitBreaker, HealthRegistry
    from ..service.http import HealthServer
    from ..service.leader import LeaderElector
    from ..telemetry import active as active_telemetry

    policy = (
        load_policy_from_file(args.policy_config_path)
        if args.policy_config_path
        else DEFAULT_POLICY
    )

    # resilience spine: per-fault-domain breakers feeding one
    # health registry; /healthz serves its aggregated snapshot
    tel = active_telemetry()
    if tel is not None:
        from ..telemetry.fleet import register_build_info

        register_build_info(tel.registry, "annotator")
    health_reg = HealthRegistry(telemetry=tel)
    prom_breaker = CircuitBreaker("prometheus", telemetry=tel)
    health_reg.watch_breaker(prom_breaker)

    mirror = None
    if args.master:
        from ..cluster.kube import KubeClusterClient

        cluster = mirror = KubeClusterClient.from_flags(
            args.master, args.token_file,
            concurrent_syncs=args.concurrent_syncs,
        )
        cluster.read_breaker = CircuitBreaker("kube-read", telemetry=tel)
        cluster.write_breaker = CircuitBreaker("kube-write", telemetry=tel)
        health_reg.watch_breaker(cluster.read_breaker)
        health_reg.watch_breaker(cluster.write_breaker)
        cluster.start()
        print(f"kube mirror: {len(cluster.list_nodes())} nodes from {args.master}",
              flush=True)
    else:
        cluster = ClusterState()
        if args.nodes_file:
            with open(args.nodes_file) as f:
                for doc in json.load(f):
                    cluster.add_node(
                        Node(
                            name=doc["name"],
                            addresses=(NodeAddress("InternalIP", doc.get("ip", doc["name"])),),
                        )
                    )
        elif args.demo_nodes:
            for i in range(args.demo_nodes):
                cluster.add_node(
                    Node(name=f"node-{i}", addresses=(NodeAddress("InternalIP", f"10.0.0.{i}"),))
                )

    if args.prometheus_address:
        from ..metrics import PrometheusClient

        metrics = PrometheusClient(args.prometheus_address, breaker=prom_breaker)
    else:
        from ..metrics import FakeMetricsSource

        metrics = FakeMetricsSource()
        for node in cluster.list_nodes():
            for sp in policy.spec.sync_period:
                metrics.set(sp.name, node.internal_ip(), 0.25, by="ip")

    # the elector is constructed after the annotator, so the leadership
    # gate late-binds through this holder; before election starts (or
    # without --leader-elect) the annotator is considered leading
    elector_box = []

    def leader_check() -> bool:
        return not elector_box or bool(elector_box[0].is_leader)

    annotator = NodeAnnotator(
        cluster,
        metrics,
        policy,
        AnnotatorConfig(
            binding_heap_size=args.binding_heap_size,
            concurrent_syncs=args.concurrent_syncs,
        ),
        leader_check=leader_check if args.leader_elect else None,
        health=health_reg,
    )

    health = HealthServer(port=args.health_port, telemetry=tel,
                          health=health_reg)
    health.start()
    print(f"healthz on :{health.port}", flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())

    def run_annotator(stop_event):
        # backfill runs ONLY on the elected leader (standbys must not
        # patch annotations — the active/passive contract), and before
        # the sync tickers so live data immediately overwrites it
        if args.backfill_offset:
            from ..utils import parse_go_duration

            seeded = annotator.backfill_once(
                parse_go_duration(args.backfill_offset)
            )
            print(f"backfill: seeded {seeded} annotations "
                  f"from offset {args.backfill_offset}", flush=True)
        annotator.start()
        stop_event.wait()
        annotator.stop()

    def lost_lease():
        # Reference contract: panic on lost lease so kubelet restarts the
        # pod and it re-enters the election (ref: server.go:119-121).
        # Without this a replica that loses its lease (e.g. a transient
        # apiserver outage past the renew deadline) would park forever as
        # a passive zombie with a healthy /healthz.
        print("lost leader lease; exiting for restart", flush=True)
        os._exit(1)

    if args.leader_elect:
        if args.master:
            # lease-based election against the apiserver (ref:
            # server.go:86-126): works across pods, unlike a file lock
            import socket

            from ..service.kube_leader import KubeLeaderElector

            elector = KubeLeaderElector(
                cluster,
                lease_name="crane-scheduler-tpu-annotator",
                # the hostname (the pod name in k8s) must be in the
                # identity: every container's entrypoint is PID 1
                identity=f"crane-annotator-{socket.gethostname()}-{os.getpid()}",
                on_started_leading=run_annotator,
                on_stopped_leading=lost_lease,
            )
            print("leader election on lease crane-scheduler-tpu-annotator",
                  flush=True)
        else:
            elector = LeaderElector(
                args.lock_file,
                identity=f"crane-annotator-{os.getpid()}",
                on_started_leading=run_annotator,
                on_stopped_leading=lost_lease,
            )
            print(f"leader election on {args.lock_file}", flush=True)
        elector_box.append(elector)
        thread = threading.Thread(target=elector.run, daemon=True)
        thread.start()
    else:
        threading.Thread(target=run_annotator, args=(stop,), daemon=True).start()

    stop.wait(timeout=args.run_seconds or None)
    stop.set()
    health.stop()
    print(
        json.dumps(
            {"synced": annotator.synced, "sync_errors": annotator.sync_errors,
             **_score_check(cluster, policy, device)}
        ),
        flush=True,
    )
    if mirror is not None:
        mirror.stop()
    return 0


def _score_check(cluster, policy, device) -> dict:
    """Score the annotations the annotator wrote, once, on ``device``."""
    import time

    import torch

    from ..loadstore.store import NodeLoadStore
    from ..policy import compile_policy
    from ..scorer.batched import BatchedScorer

    tensors = compile_policy(policy)
    store = NodeLoadStore(tensors)
    store.bulk_ingest((n.name, n.annotations) for n in cluster.list_nodes())
    snap = store.snapshot()
    result = BatchedScorer(tensors, torch.float32, device)(
        snap.values, snap.ts, snap.hot_value, snap.hot_ts, snap.node_valid,
        time.time(),
    )
    schedulable = result.schedulable[: snap.n_nodes].cpu()
    return {"device": device.type, "nodes": snap.n_nodes,
            "schedulable": int(schedulable.sum())}


if __name__ == "__main__":
    raise SystemExit(main())
