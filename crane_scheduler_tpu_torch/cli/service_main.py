"""crane-scorer: the scoring sidecar entry point, on PyTorch.

Counterpart of ``crane_scheduler_tpu/cli/service_main.py``. Serves the
scoring API (POST /v1/score, POST /v1/assign, POST /v1/refresh, GET
/metrics, GET /healthz) over the port's ``ClusterState``: float64 plain
PyTorch by default, or float32 through the fused score kernel with
``--f32``. ``--device`` picks the device (default ``cuda``, which needs a
GPU; ``cpu`` runs every kernel's plain version).

``GET /metrics`` content-negotiates (Prometheus text exposition for
scrapers, legacy JSON otherwise); ``GET /debug/decisions`` serves
sampled decision traces and ``GET /debug/trace`` the Chrome
trace-event spans.

The reference's cluster sources and multi-process planes are not ported
yet, and their flags exit with a usage error naming the ``ROADMAP.md``
Queue 1 item that brings them: ``--master``, ``--token-file``,
``--concurrent-syncs`` (the kube mirror) and ``--demo-nodes`` (the
simulator and annotator), item 8; ``--coordinator-address``,
``--num-processes``, ``--process-id``, item 7; ``--publish-feed``,
``--replication-window``, ``--replica-feed``, ``--replicas``,
``--router``, ``--lag-budget`` (the replicated tier), item 6b. Without
them the service scores an empty ``ClusterState``, as the reference does
without ``--demo-nodes`` or ``--master``.

Usage:
  python -m crane_scheduler_tpu_torch.cli.service_main --port 8080 --f32
  python -m crane_scheduler_tpu_torch.cli.service_main --port 8080 --device cpu
"""

from __future__ import annotations

import argparse
import os
import signal
import threading

# flag -> the ROADMAP.md Queue 1 item that brings its plane
_UNPORTED = (
    ("master", "--master", "the kube mirror", "item 8"),
    ("token_file", "--token-file", "the kube mirror", "item 8"),
    ("concurrent_syncs", "--concurrent-syncs", "the kube mirror", "item 8"),
    ("demo_nodes", "--demo-nodes", "the simulator and annotator", "item 8"),
    ("coordinator_address", "--coordinator-address", "multi-GPU serving", "item 7"),
    ("num_processes", "--num-processes", "multi-GPU serving", "item 7"),
    ("process_id", "--process-id", "multi-GPU serving", "item 7"),
    ("publish_feed", "--publish-feed", "the replicated tier", "item 6b"),
    ("replication_window", "--replication-window", "the replicated tier", "item 6b"),
    ("replica_feed", "--replica-feed", "the replicated tier", "item 6b"),
    ("replicas", "--replicas", "the replicated tier", "item 6b"),
    ("router", "--router", "the replicated tier", "item 6b"),
    ("lag_budget", "--lag-budget", "the replicated tier", "item 6b"),
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="crane-scorer")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--policy-config-path", default=None)
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
    # fleet observability plane: federate every process's /metrics
    # under role/process labels on /fleet/metrics, burn-rate SLO
    # alerting on /v1/slo
    parser.add_argument("--fleet-scrape", default=None,
                        metavar="[ROLE@]HOST:PORT[/PATH],...",
                        help="fleet scrape targets to federate with this "
                             "process (e.g. scheduler@127.0.0.1:8090)")
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
    # the reference's flags whose planes are not ported: accepted by the
    # parser only to refuse them by name
    unported = parser.add_argument_group("not ported yet")
    unported.add_argument("--master", default=None)
    unported.add_argument("--token-file", default=None)
    unported.add_argument("--concurrent-syncs", type=int, default=None)
    unported.add_argument("--demo-nodes", type=int, default=None)
    unported.add_argument("--coordinator-address", default=None)
    unported.add_argument("--num-processes", type=int, default=None)
    unported.add_argument("--process-id", type=int, default=None)
    unported.add_argument("--publish-feed", action="store_true", default=None)
    unported.add_argument("--replication-window", type=float, default=None)
    unported.add_argument("--replica-feed", default=None)
    unported.add_argument("--replicas", type=int, default=None)
    unported.add_argument("--router", default=None)
    unported.add_argument("--lag-budget", type=int, default=None)
    args = parser.parse_args(argv)
    for dest, flag, plane, item in _UNPORTED:
        if getattr(args, dest) is not None:
            parser.error(
                f"{flag} needs {plane}, which the PyTorch port does not "
                f"have yet (ROADMAP.md Queue 1 {item})"
            )

    if args.flight_dir:
        os.environ["CRANE_FLIGHT_DIR"] = args.flight_dir
        os.environ.setdefault("CRANE_TELEMETRY", "1")

    from ..utils.logging import set_verbosity

    if args.verbose:
        set_verbosity(args.verbose)

    import torch

    from ..cluster import ClusterState
    from ..policy import DEFAULT_POLICY, load_policy_from_file
    from ..service import ScoringHTTPServer, ScoringService
    from ..telemetry.fleet import register_build_info

    policy = (
        load_policy_from_file(args.policy_config_path)
        if args.policy_config_path
        else DEFAULT_POLICY
    )
    cluster = ClusterState()
    service = ScoringService(
        cluster, policy,
        dtype=torch.float32 if args.f32 else torch.float64,
        device=args.device,
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
    # fleet plane: federate the local registry plus the --fleet-scrape
    # targets; /fleet/metrics and /v1/slo serve from this process
    fleet = None
    if args.fleet_scrape:
        from ..telemetry.fleet import FleetPlane, parse_scrape_flag

        fleet = FleetPlane(
            parse_scrape_flag(args.fleet_scrape),
            registry=service.telemetry.registry,
            local_registry=service.telemetry.registry,
            local_role="scorer",
            local_name="primary",
            interval_s=args.fleet_interval,
        )
    server = ScoringHTTPServer(
        service, port=args.port, frontend=args.frontend,
        workers=args.http_workers,
        admission=admission, brownout=brownout,
        idle_timeout_s=args.idle_timeout or None,
        fleet=fleet,
    )
    server.start()
    print(
        f"scoring service on :{server.port} [{server.frontend}] "
        f"device {service.device} "
        "(/v1/score /v1/assign /metrics /debug/decisions /debug/trace)",
        flush=True,
    )
    if fleet is not None:
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
    server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
