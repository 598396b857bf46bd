"""crane-scorer: the scoring sidecar entry point, on PyTorch.

Counterpart of ``crane_scheduler_tpu/cli/service_main.py``. Serves the
scoring API (POST /v1/score, POST /v1/assign, POST /v1/refresh, GET
/metrics, GET /healthz) over the port's ``ClusterState``: float64 plain
PyTorch by default, or float32 through the fused score kernel with
``--f32``. ``--device`` picks the device (default ``cuda``, which needs a
GPU; ``cpu`` runs every kernel's plain version).

On exit (``--run-seconds`` or SIGTERM) the process prints one JSON line,
``{"kernel_launches": {"score": n, "gang": m}}``: its launches of the two
hand-written kernels, so a caller can see that the card served.

``GET /metrics`` content-negotiates (Prometheus text exposition for
scrapers, legacy JSON otherwise); ``GET /debug/decisions`` serves
sampled decision traces and ``GET /debug/trace`` the Chrome
trace-event spans.

The cluster is a live apiserver mirror (``--master URL``, with
``--token-file`` and ``--concurrent-syncs``: the port's
``KubeClusterClient``), a simulated one after one annotator pass
(``--demo-nodes N``, through the port's ``Simulator``), or an empty
``ClusterState``. The replicated tier runs as in the reference:
``--publish-feed`` publishes the delta feed (``GET
/v1/replication/feed``, one window per ``--replication-window``
seconds); ``--replica-feed HOST:PORT`` runs this process as a serving
replica of that primary; ``--replicas N`` runs N in-process replicas fed
by this primary behind a router on ``--port`` (``--router hash|rr``,
catch-up gate ``--lag-budget``), with the fleet plane federating them.

Multi-process: with ``--coordinator-address HOST:PORT``,
``--num-processes`` and ``--process-id`` the process first joins a
``torch.distributed`` group (``parallel.initialize``: NCCL on the GPU,
gloo with ``--device cpu``) and prints its process line, as the reference
does for ``jax.distributed``; scoring is unchanged.

Usage:
  python -m crane_scheduler_tpu_torch.cli.service_main --port 8080 --f32
  python -m crane_scheduler_tpu_torch.cli.service_main --port 8080 --device cpu
  python -m crane_scheduler_tpu_torch.cli.service_main --port 8080 --f32 \
      --master https://apiserver:6443 --token-file /path/to/token
  python -m crane_scheduler_tpu_torch.cli.service_main --port 8080 --f32 \
      --demo-nodes 2000 --replicas 2 --router hash --lag-budget 8
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="crane-scorer")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--master", default=None,
                        help="kube-apiserver URL: score the live cluster "
                             "through the kube mirror")
    parser.add_argument("--token-file", default=None)
    parser.add_argument("--concurrent-syncs", type=int, default=4,
                        help="--master: keep-alive write workers")
    parser.add_argument("--policy-config-path", default=None)
    parser.add_argument("--demo-nodes", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device to score on: cuda (default; "
                             "needs a GPU) or cpu")
    parser.add_argument("--f32", action="store_true")
    parser.add_argument("--run-seconds", type=float, default=0.0)
    parser.add_argument("--frontend", choices=["async", "threaded"],
                        default=None,
                        help="HTTP front end: the selectors-based "
                             "keep-alive server (async, default) or the "
                             "stdlib ThreadingHTTPServer fallback")
    parser.add_argument("--http-workers", type=int, default=8,
                        help="request-handler threads behind the async "
                             "front end")
    parser.add_argument("--now-bucket", type=float, default=0.25,
                        help="seconds to quantize implicit `now` to: the "
                             "coalescing/response-cache key quantum for "
                             "concurrent /v1/score requests (0 disables)")
    # overload protection: IO-thread admission control, brownout tiers,
    # and the slowloris idle reaper
    parser.add_argument("--admission-limit", type=int, default=0,
                        help="adaptive concurrency cap (gradient limiter "
                             "max); 0 disables admission control")
    parser.add_argument("--queue-depth", type=int, default=64,
                        help="per-tenant admission queue depth (excess "
                             "sheds 503 + Retry-After)")
    parser.add_argument("--tenant-rate", type=float, default=0.0,
                        help="per-tenant request rate limit in req/s "
                             "(token bucket; 0 = unlimited)")
    parser.add_argument("--tenant-burst", type=float, default=10.0,
                        help="token-bucket burst per tenant")
    parser.add_argument("--idle-timeout", type=float, default=30.0,
                        help="seconds before an idle/half-sent connection "
                             "is reaped (slowloris defense; 0 disables)")
    parser.add_argument("--stale-budget", type=float, default=30.0,
                        help="brownout tier 1: max age of the cached "
                             "pre-rendered response served under pressure")
    # replicated serving tier: delta-stream mirror replication +
    # shared-nothing replicas + consistent-hash router
    parser.add_argument("--publish-feed", action="store_true",
                        help="publish the delta-stream replication feed "
                             "(GET /v1/replication/feed) from this "
                             "process's cluster state")
    parser.add_argument("--replication-window", type=float, default=0.05,
                        help="seconds per published delta window")
    parser.add_argument("--replica-feed", default=None, metavar="HOST:PORT",
                        help="run as a serving replica: mirror the "
                             "primary's delta feed instead of any local "
                             "cluster source")
    parser.add_argument("--replicas", type=int, default=0,
                        help="one-command replicated topology: run N "
                             "in-process replicas fed by this primary "
                             "plus a router on --port")
    parser.add_argument("--router", choices=["hash", "rr"], default="hash",
                        help="router replica selection: consistent-hash "
                             "tenant affinity (hash, default) or "
                             "round-robin (rr)")
    parser.add_argument("--lag-budget", type=int, default=8,
                        help="router catch-up gate: a replica behind the "
                             "published version by more than this many "
                             "versions is not routable")
    # fleet observability plane: federate every process's /metrics
    # under role/process labels on /fleet/metrics, burn-rate SLO
    # alerting on /v1/slo
    parser.add_argument("--fleet-scrape", default=None,
                        metavar="[ROLE@]HOST:PORT[/PATH],...",
                        help="extra fleet scrape targets to federate "
                             "(e.g. scheduler@127.0.0.1:8090); the "
                             "--replicas/--router topology is federated "
                             "automatically")
    parser.add_argument("--fleet-interval", type=float, default=1.0,
                        help="federation scrape/SLO-tick interval in "
                             "seconds")
    parser.add_argument("--flight-dir", default=None,
                        help="directory for the crash-safe flight recorder "
                             "(lifecycle records + spans as a bounded JSONL "
                             "ring); implies telemetry")
    parser.add_argument("-v", "--verbose", action="count", default=0,
                        help="raise [crane] log verbosity (-v sweeps/"
                             "windows, -vv cycles, -vvv per-pod); "
                             "default run is quiet")
    # multi-process: every process serves; all three flags set =>
    # distributed (parallel.distributed)
    parser.add_argument("--coordinator-address", default=None,
                        help="host:port of process 0 (torch.distributed)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    args = parser.parse_args(argv)

    if args.flight_dir:
        os.environ["CRANE_FLIGHT_DIR"] = args.flight_dir
        os.environ.setdefault("CRANE_TELEMETRY", "1")

    from ..utils.logging import set_verbosity

    if args.verbose:
        set_verbosity(args.verbose)

    import torch

    if args.coordinator_address is not None:
        import torch.distributed as dist

        from ..parallel import distributed

        distributed.initialize(args.coordinator_address, args.num_processes,
                               args.process_id, device=args.device)
        print(
            f"torch.distributed: process {dist.get_rank()}/"
            f"{dist.get_world_size()}, {distributed.global_node_mesh().size} "
            f"global devices",
            flush=True,
        )

    from ..policy import DEFAULT_POLICY, load_policy_from_file
    from ..service import ScoringHTTPServer, ScoringService
    from ..telemetry.fleet import register_build_info

    policy = (
        load_policy_from_file(args.policy_config_path)
        if args.policy_config_path
        else DEFAULT_POLICY
    )
    dtype = torch.float32 if args.f32 else torch.float64

    if args.replica_feed:
        # replica mode: no local cluster source — the mirror IS the
        # cluster, fed by the primary's delta stream
        from ..service import ServingReplica

        feed_host, _, feed_port = args.replica_feed.rpartition(":")
        replica = ServingReplica(
            policy,
            feed=(feed_host or "127.0.0.1", int(feed_port)),
            port=args.port,
            workers=args.http_workers,
            dtype=dtype,
            device=args.device,
            now_bucket_s=args.now_bucket,
            idle_timeout_s=args.idle_timeout or None,
        )
        register_build_info(replica.telemetry.registry, "replica")
        replica.start()
        print(
            f"serving replica on :{replica.port} device "
            f"{replica.service.device} "
            f"(feed {args.replica_feed}; /v1/score /v1/replica/status)",
            flush=True,
        )
        stop = threading.Event()
        signal.signal(signal.SIGTERM, lambda *a: stop.set())
        signal.signal(signal.SIGINT, lambda *a: stop.set())
        stop.wait(timeout=args.run_seconds or None)
        replica.stop()
        print(json.dumps({"kernel_launches": kernel_launches()}), flush=True)
        _leave_group()
        return 0

    mirror = None
    if args.master:
        from ..cluster.kube import KubeClusterClient

        cluster = mirror = KubeClusterClient.from_flags(
            args.master, args.token_file,
            concurrent_syncs=args.concurrent_syncs,
        )
        cluster.start()
        print(f"kube mirror: {len(cluster.list_nodes())} nodes", flush=True)
    elif args.demo_nodes:
        from ..sim import SimConfig, Simulator

        sim = Simulator(SimConfig(n_nodes=args.demo_nodes), policy=policy)
        sim.sync_metrics()
        cluster = sim.cluster
    else:
        from ..cluster import ClusterState

        cluster = ClusterState()

    service = ScoringService(
        cluster, policy, dtype=dtype, device=args.device,
        now_bucket_s=args.now_bucket,
    )
    register_build_info(service.telemetry.registry, "scorer")
    service.refresh()
    admission = brownout = None
    if args.admission_limit > 0:
        from ..service import AdmissionController, BrownoutController
        from ..service.overload import GradientLimiter, TenantQueues

        brownout = BrownoutController(
            stale_budget_s=args.stale_budget,
            telemetry=service.telemetry,
        )
        admission = AdmissionController(
            limiter=GradientLimiter(max_limit=args.admission_limit),
            queues=TenantQueues(depth=args.queue_depth),
            tenant_rate=args.tenant_rate,
            tenant_burst=args.tenant_burst,
            brownout=brownout,
            telemetry=service.telemetry,
        )
    publisher = None
    if args.publish_feed or args.replicas > 0:
        from ..cluster.replication import DeltaPublisher

        publisher = DeltaPublisher(
            cluster, window_s=args.replication_window,
            telemetry=service.telemetry,
        )
    # fleet plane: federate the local registry plus the replica/router
    # topology below plus any explicit --fleet-scrape targets;
    # /fleet/metrics and /v1/slo serve from this primary
    fleet = None
    if args.fleet_scrape or args.replicas > 0:
        from ..telemetry.fleet import FleetPlane, parse_scrape_flag

        fleet = FleetPlane(
            parse_scrape_flag(args.fleet_scrape)
            if args.fleet_scrape else (),
            registry=service.telemetry.registry,
            local_registry=service.telemetry.registry,
            local_role="scorer",
            local_name="primary",
            interval_s=args.fleet_interval,
        )
    # primary port: --port unless the router takes it (replica topology)
    primary_port = 0 if args.replicas > 0 else args.port
    server = ScoringHTTPServer(
        service, port=primary_port, frontend=args.frontend,
        workers=args.http_workers,
        admission=admission, brownout=brownout,
        idle_timeout_s=args.idle_timeout or None,
        replication=publisher,
        fleet=fleet,
    )
    server.start()
    if publisher is not None:
        publisher.start()
        print(
            f"delta feed on :{server.port}/v1/replication/feed "
            f"(window {args.replication_window}s)",
            flush=True,
        )
    print(
        f"scoring service on :{server.port} [{server.frontend}] "
        f"device {service.device} "
        "(/v1/score /v1/assign /metrics /debug/decisions /debug/trace)",
        flush=True,
    )

    replicas = []
    router = None
    if args.replicas > 0:
        from ..service import ReplicaRouter, ServingReplica

        for i in range(args.replicas):
            replica = ServingReplica(
                policy,
                name=f"replica-{i}",
                feed=("127.0.0.1", server.port),
                dtype=dtype,
                device=args.device,
                now_bucket_s=args.now_bucket,
                idle_timeout_s=args.idle_timeout or None,
            )
            register_build_info(
                replica.telemetry.registry, "replica", set_role=False
            )
            replica.start()
            replicas.append(replica)
        router = ReplicaRouter(
            [(r.name, "127.0.0.1", r.port) for r in replicas],
            primary=("127.0.0.1", server.port),
            mode=args.router,
            lag_budget_versions=args.lag_budget,
            port=args.port,
        )
        register_build_info(
            router.telemetry.registry, "router", set_role=False
        )
        router.start()
        print(
            f"router on :{router.port} [{args.router}] -> "
            + ", ".join(f"{r.name}@:{r.port}" for r in replicas),
            flush=True,
        )

    if fleet is not None:
        from ..telemetry.fleet import ScrapeTarget

        for r in replicas:
            fleet.federator.add_target(ScrapeTarget(
                name=r.name, port=r.port, role="replica",
            ))
        if router is not None:
            fleet.federator.add_target(ScrapeTarget(
                name="router", port=router.port, role="router",
            ))
        fleet.start()
        print(
            f"fleet plane: federating "
            f"{len(fleet.federator.targets)} targets every "
            f"{args.fleet_interval:g}s (/fleet/metrics /v1/slo)",
            flush=True,
        )

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait(timeout=args.run_seconds or None)
    if fleet is not None:
        fleet.stop()
    if router is not None:
        router.stop()
    for replica in replicas:
        replica.stop()
    if publisher is not None:
        publisher.stop()
    server.stop()
    if mirror is not None:
        mirror.stop()
    print(json.dumps({"kernel_launches": kernel_launches()}), flush=True)
    _leave_group()
    return 0


def _leave_group() -> None:
    """Leave the process group ``--coordinator-address`` joined, if any."""
    from ..parallel.distributed import shutdown

    shutdown()


def kernel_launches() -> dict:
    """This process's launches of each hand-written kernel (the wrappers'
    counters; a CPU service launches none)."""
    from ..scorer import gang_kernel, score_kernel

    return {"score": score_kernel.KERNEL.launches, "gang": gang_kernel.KERNEL.launches}


if __name__ == "__main__":
    raise SystemExit(main())
