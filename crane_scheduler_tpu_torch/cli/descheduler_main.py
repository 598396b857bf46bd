"""crane-descheduler: the load-aware rebalancer entry point.

Counterpart of ``crane_scheduler_tpu/cli/descheduler_main.py``. The
correcting half of the placement loop (doc/descheduler.md): reads the
same ``value,timestamp`` node annotations the Dynamic plugin schedules
against, detects sustained hotspots, and evicts budgeted victims that
provably fit elsewhere. Nodes come from ``--nodes-file`` or
``--demo-nodes`` on the port's in-memory ``ClusterState``; leader
election (``--leader-elect``) is the file lock, so only one replica
evicts; a health + metrics port; ``--dry-run`` plans without evicting.
The descheduler is host Python: it has no device work, so this entry
point takes no ``--device``.

The descheduler on the kube mirror (eviction POSTs, the apiserver lease
and the intent journal) is not ported yet: ``--master`` and
``--token-file`` exit with a usage error naming ``ROADMAP.md`` Queue 1
item 8.2b.
``--journal-dir`` acts only with ``--master`` in the reference, so here
it parses and does nothing.

Usage:
  python -m crane_scheduler_tpu_torch.cli.descheduler_main \
      --policy-config-path policy.yaml --demo-nodes 8 \
      [--dry-run] [--leader-elect --lock-file /tmp/crane-desched.lock]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import threading

# flag -> the ROADMAP.md Queue 1 item that brings its plane
_UNPORTED = (
    ("master", "--master", "the descheduler on the kube mirror", "item 8.2b"),
    ("token_file", "--token-file", "the descheduler on the kube mirror", "item 8.2b"),
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="crane-descheduler")
    parser.add_argument("--policy-config-path", default=None)
    parser.add_argument("--health-port", type=int, default=8091)
    parser.add_argument("--nodes-file", default=None)
    parser.add_argument("--demo-nodes", type=int, default=0)
    parser.add_argument("--sync-period-seconds", type=float, default=60.0)
    parser.add_argument("--consecutive-syncs", type=int, default=3,
                        help="over-threshold syncs before a node is "
                             "actionable (one spike never evicts)")
    parser.add_argument("--max-evictions-per-node", type=int, default=1)
    parser.add_argument("--max-evictions-per-cycle", type=int, default=4)
    parser.add_argument("--node-cooldown-seconds", type=float, default=300.0)
    parser.add_argument("--cpu-threshold", type=float, default=0.70,
                        help="cpu_usage_avg_5m hotspot watermark")
    parser.add_argument("--cpu-target", type=float, default=0.50,
                        help="cpu_usage_avg_5m safe-landing watermark")
    parser.add_argument("--dry-run", action="store_true",
                        help="plan and count, never evict")
    parser.add_argument("--degraded-enter-fraction", type=float, default=0.5,
                        help="suspend evictions when more than this "
                             "fraction of nodes has stale annotations")
    parser.add_argument("--degraded-exit-fraction", type=float, default=0.25,
                        help="resume evictions once the stale fraction "
                             "falls back below this (hysteresis)")
    parser.add_argument("--leader-elect", action="store_true")
    parser.add_argument("--lock-file", default="/tmp/crane-descheduler.lock")
    parser.add_argument("--run-seconds", type=float, default=0.0,
                        help="exit after N seconds (0 = run forever)")
    parser.add_argument("--flight-dir", default=None,
                        help="directory for the crash-safe flight recorder "
                             "(lifecycle records + spans as a bounded JSONL "
                             "ring); implies telemetry")
    parser.add_argument("--flight-fsync", action="store_true",
                        help="fsync every flight-recorder and intent-"
                             "journal line")
    parser.add_argument("--journal-dir", default=None,
                        help="master mode only (the reference's crash-safe "
                             "eviction-intent journal); without --master it "
                             "is parsed and does nothing, as in the "
                             "reference")
    parser.add_argument("-v", "--verbose", action="count", default=0)
    # the kube mirror's flags: accepted by the parser only to refuse them
    unported = parser.add_argument_group("not ported yet")
    unported.add_argument("--master", default=None)
    unported.add_argument("--token-file", default=None)
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
    if args.flight_fsync:
        os.environ["CRANE_FLIGHT_FSYNC"] = "1"

    from ..utils.logging import set_verbosity

    if args.verbose:
        set_verbosity(args.verbose)

    from .. import telemetry as telemetry_mod
    from ..cluster import ClusterState, Node, NodeAddress
    from ..descheduler import (
        DeschedulerConfig,
        LoadAwareDescheduler,
        WatermarkPolicy,
    )
    from ..policy import DEFAULT_POLICY, load_policy_from_file
    from ..resilience import DegradedModeController, HealthRegistry
    from ..service.http import HealthServer
    from ..service.leader import LeaderElector

    policy = (
        load_policy_from_file(args.policy_config_path)
        if args.policy_config_path
        else DEFAULT_POLICY
    )
    telemetry = telemetry_mod.enable()
    from ..telemetry.fleet import register_build_info

    register_build_info(telemetry.registry, "descheduler")
    health_reg = HealthRegistry(telemetry=telemetry)

    cluster = ClusterState()
    if args.nodes_file:
        with open(args.nodes_file) as f:
            for doc in json.load(f):
                cluster.add_node(
                    Node(
                        name=doc["name"],
                        addresses=(NodeAddress("InternalIP",
                                               doc.get("ip", doc["name"])),),
                    )
                )
    elif args.demo_nodes:
        for i in range(args.demo_nodes):
            cluster.add_node(
                Node(name=f"node-{i}",
                     addresses=(NodeAddress("InternalIP", f"10.0.0.{i}"),))
            )

    config = DeschedulerConfig(
        watermarks=(
            WatermarkPolicy("cpu_usage_avg_5m",
                            target=args.cpu_target,
                            threshold=args.cpu_threshold),
            WatermarkPolicy("mem_usage_avg_5m",
                            target=args.cpu_target,
                            threshold=args.cpu_threshold),
        ),
        consecutive_syncs=args.consecutive_syncs,
        max_evictions_per_node=args.max_evictions_per_node,
        max_evictions_per_cycle=args.max_evictions_per_cycle,
        node_cooldown_seconds=args.node_cooldown_seconds,
        sync_period_seconds=args.sync_period_seconds,
        dry_run=args.dry_run,
    )
    # evictions are hard-suspended while the annotation fabric
    # is degraded — evicting on stale load data makes outages worse
    degraded = DegradedModeController(
        policy.spec,
        enter_fraction=args.degraded_enter_fraction,
        exit_fraction=args.degraded_exit_fraction,
        telemetry=telemetry,
        health=health_reg,
    )
    descheduler = LoadAwareDescheduler(
        cluster, policy, config, telemetry=telemetry, degraded=degraded
    )

    health = HealthServer(port=args.health_port, telemetry=telemetry,
                          health=health_reg)
    health.start()
    print(f"healthz+metrics on :{health.port}"
          f"{' (dry-run)' if args.dry_run else ''}", flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    # chained after the stop handler: SIGTERM flushes flight spans
    # first, then stops (atexit alone misses signal deaths)
    telemetry_mod.flush_on_signal(telemetry)

    def run_descheduler(stop_event):
        descheduler.start()
        stop_event.wait()
        descheduler.stop()

    def lost_lease():
        # same contract as the annotator: exit so the pod restarts and
        # re-enters the election — never evict without the lease
        print("lost leader lease; exiting for restart", flush=True)
        os._exit(1)

    if args.leader_elect:
        elector = LeaderElector(
            args.lock_file,
            identity=f"crane-descheduler-{os.getpid()}",
            on_started_leading=run_descheduler,
            on_stopped_leading=lost_lease,
        )
        print(f"leader election on {args.lock_file}", flush=True)
        thread = threading.Thread(target=elector.run, daemon=True)
        thread.start()
    else:
        threading.Thread(
            target=run_descheduler, args=(stop,), daemon=True
        ).start()

    stop.wait(timeout=args.run_seconds or None)
    stop.set()
    health.stop()
    print(json.dumps(descheduler.stats()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
