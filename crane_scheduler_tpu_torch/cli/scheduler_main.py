"""crane-scheduler: the scheduler entry point, on PyTorch.

Counterpart of ``crane_scheduler_tpu/cli/scheduler_main.py``, and like it
the equivalent of ``cmd/scheduler/main.go``: a scheduler assembled from a
``KubeSchedulerConfiguration`` document (``--config``) with the crane
plugins registered. The cluster is a simulation (``--demo-nodes``, the
port's ``Simulator``) fed by the in-process annotator; pending pods are
scheduled one by one through the configured plugins (plugin mode), or in
batched bursts through the ``BatchScheduler`` (``--batch-size``).

``--device`` picks the device (default ``cuda``, which needs a GPU;
``cpu`` runs every kernel's plain version). Batch mode scores (float64)
and sums the water-filling level totals (one K2 launch per burst) there.
Plugin mode's ``schedule_one`` is host Python, as in the reference; its
scheduler is built for the device all the same, which holds only the
batched drip window that this mode never dispatches.

With ``--master`` (``--token-file``, ``--concurrent-syncs``) the
scheduler runs once against a live kube-apiserver through the kube mirror
(``cluster/kube.py``): it schedules the cluster's pending pods (all of
them, or the first ``--pods``), reading the annotator's node annotations
from the mirror, and binds through the ``binding`` subresource. Batch
mode runs ``schedule_batch_mixed`` bursts with NUMA enforcement from the
mirror's NodeResourceTopology CRs when the profile enables it; plugin
mode runs ``schedule_one`` per pod.

The result is one JSON line with the reference's keys.

The reference's master-mode serving plane is not ported yet: with
``--master``, ``--serve``, ``--journal-dir`` and ``--lock-file`` exit with
a usage error naming ``ROADMAP.md`` Queue 1 item 8.2b, ``--shards`` above
1 item 8.3, ``--placement-mesh`` item 7. Without ``--master`` these flags
and ``--window``, ``--bind-watermark-pods``, ``--run-seconds`` and
``--shard-*`` parse and do nothing, exactly as in the reference's sim
mode.

Usage:
  python -m crane_scheduler_tpu_torch.cli.scheduler_main \\
      --config deploy/dynamic/scheduler-config.yaml --demo-nodes 20 \\
      --pods 100 [--batch-size 25] [--device cpu]
  python -m crane_scheduler_tpu_torch.cli.scheduler_main \\
      --config deploy/dynamic/scheduler-config.yaml \\
      --master https://apiserver:6443 [--batch-size 256]
"""

from __future__ import annotations

import argparse
import json
import os
import time

# --master flags whose plane is not ported: (dest, flag, plane, ROADMAP.md
# Queue 1 item, whether the parsed value asks for it)
_UNPORTED_MASTER = (
    ("serve", "--serve", "the master-mode serving loop", "item 8.2b", bool),
    ("journal_dir", "--journal-dir", "the placement-intent journal", "item 8.2b",
     lambda v: v is not None),
    ("lock_file", "--lock-file", "the warm-standby failover", "item 8.2b",
     lambda v: v is not None),
    ("shards", "--shards", "the shard plane", "item 8.3", lambda v: v > 1),
    ("placement_mesh", "--placement-mesh", "multi-GPU placement", "item 7",
     lambda v: v > 0),
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="crane-scheduler")
    parser.add_argument("--config", default="deploy/dynamic/scheduler-config.yaml")
    parser.add_argument("--master", default=None,
                        help="kube-apiserver URL: schedule the live "
                             "cluster's pending pods once")
    parser.add_argument("--token-file", default=None)
    parser.add_argument("--concurrent-syncs", type=int, default=4,
                        help="--master: keep-alive write workers")
    parser.add_argument("--demo-nodes", type=int, default=16)
    parser.add_argument("--pods", type=int, default=None,
                        help="pods to generate (default 50)")
    parser.add_argument("--batch-size", type=int, default=0,
                        help="> 0: use the batch scheduler in bursts")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device to schedule on: cuda (default; "
                             "needs a GPU) or cpu")
    parser.add_argument("--tie-break-seed", type=int, default=None,
                        help="drip mode: seeded RANDOM choice among "
                             "equal-score feasible nodes (the stock "
                             "framework's dispersion behavior); default "
                             "off = lowest node index, deterministic")
    parser.add_argument("--flight-dir", default=None,
                        help="directory for the crash-safe flight recorder "
                             "(lifecycle records + spans as a bounded JSONL "
                             "ring); implies telemetry")
    parser.add_argument("--flight-fsync", action="store_true",
                        help="fsync every flight-recorder line")
    parser.add_argument("-v", "--verbose", action="count", default=0,
                        help="raise [crane] log verbosity (-v sweeps/"
                             "windows, -vv cycles, -vvv per-pod); "
                             "default run is quiet")
    # flags of the reference's --master serving plane: parsed, and
    # without --master they do nothing, as in the reference's sim mode
    master_only = parser.add_argument_group("--master mode only")
    master_only.add_argument("--journal-dir", default=None)
    master_only.add_argument("--serve", action="store_true")
    master_only.add_argument("--run-seconds", type=float, default=0.0)
    master_only.add_argument("--placement-mesh", type=int, default=0)
    master_only.add_argument("--shards", type=int, default=1)
    master_only.add_argument("--shard-index", type=int, default=0)
    master_only.add_argument("--shard-overlap", type=float, default=0.0)
    master_only.add_argument("--shard-ring", default=None)
    master_only.add_argument("--window", type=int, default=32)
    master_only.add_argument("--bind-watermark-pods", type=int, default=0)
    master_only.add_argument("--lock-file", default=None)
    args = parser.parse_args(argv)
    if args.master:
        for dest, flag, plane, item, asks in _UNPORTED_MASTER:
            if asks(getattr(args, dest)):
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

    from ..device import resolve_device

    # before the simulation is built: no CUDA means an error, not a run
    # on the CPU
    device = resolve_device(args.device)

    from ..config import build_scheduler_from_config
    from ..config.scheme import load_scheduler_config_from_file
    from ..policy import DEFAULT_POLICY, load_policy_from_file
    from ..sim import SimConfig, Simulator
    from ..topology.types import InMemoryNRTLister

    config = load_scheduler_config_from_file(args.config)
    profile = config.profiles[0]
    dynamic_args = profile.plugin_config.get("Dynamic")
    policy = (
        load_policy_from_file(dynamic_args.policy_config_path)
        if dynamic_args is not None
        else None
    )

    if args.master:
        return _master_once(args, config, profile, policy or DEFAULT_POLICY, device)

    sim = Simulator(SimConfig(n_nodes=args.demo_nodes, seed=args.seed),
                    policy=policy or DEFAULT_POLICY)
    sim.sync_metrics()

    n_pods = 50 if args.pods is None else args.pods
    stats = {"scheduled": 0, "unschedulable": 0}
    t0 = time.perf_counter()
    if args.batch_size > 0:
        batch = sim.build_batch_scheduler(device=device)
        remaining = n_pods
        while remaining > 0:
            burst = [sim.make_pod() for _ in range(min(args.batch_size, remaining))]
            result = batch.schedule_batch(burst)
            stats["scheduled"] += len(result.assignments)
            stats["unschedulable"] += len(result.unassigned)
            remaining -= len(burst)
            sim.clock.advance(1.0)
            sim.sync_metrics()  # hot values flow between bursts
    else:
        sched = build_scheduler_from_config(
            sim.cluster, config,
            nrt_lister=InMemoryNRTLister(),
            clock=sim.clock, policy=sim.policy,
            tie_break_seed=args.tie_break_seed,
            device=device,
        )
        for _ in range(n_pods):
            result = sched.schedule_one(sim.make_pod())
            stats["scheduled" if result.node else "unschedulable"] += 1
            sim.clock.advance(1.0)
    elapsed = time.perf_counter() - t0

    placements = {}
    for pod in sim.cluster.list_pods():
        if pod.node_name:
            placements[pod.node_name] = placements.get(pod.node_name, 0) + 1
    print(json.dumps({
        "config": args.config,
        "profile": profile.scheduler_name,
        "plugins": sorted({pw.name for pw in profile.score_enabled}
                          | set(profile.filter_enabled)),
        **stats,
        "distinct_nodes_used": len(placements),
        "wall_seconds": round(elapsed, 3),
    }))
    return 0


def _master_once(args, config, profile, policy, device) -> int:
    """One pass over the live cluster's pending pods through the kube
    mirror (the reference's one-shot ``--master`` branch)."""
    from ..cluster.kube import KubeClusterClient
    from ..config import build_scheduler_from_config
    from ..framework.scheduler import BatchScheduler

    cluster = KubeClusterClient.from_flags(
        args.master, args.token_file, concurrent_syncs=args.concurrent_syncs,
    )
    cluster.start()
    try:
        telemetry = None
        if os.environ.get("CRANE_TELEMETRY"):
            from .. import telemetry as _tel

            telemetry = _tel.active()
        if telemetry is not None:
            from ..telemetry.fleet import register_build_info

            register_build_info(telemetry.registry, "scheduler")
            _tel.flush_on_signal(telemetry)

        pending = [p for p in cluster.list_pods() if not p.node_name]
        if args.pods is not None:  # unset means ALL pending, never 50
            pending = pending[: args.pods]
        stats = {"scheduled": 0, "unschedulable": 0}
        t0 = time.perf_counter()
        if args.batch_size > 0:
            from ..topology import TopologyMatch

            # NUMA enforcement follows the scheduler config, as in plugin
            # mode (an enabled plugin with no CRs marks guaranteed-CPU
            # pods unschedulable in both paths, filter.go:56-58)
            topology = (
                TopologyMatch(cluster.nrt_lister, cluster=cluster)
                if "NodeResourceTopologyMatch" in set(profile.filter_enabled)
                else None
            )
            batch = BatchScheduler(cluster, policy, device=device)
            for i in range(0, len(pending), args.batch_size):
                result = batch.schedule_batch_mixed(
                    pending[i : i + args.batch_size], topology=topology
                )
                stats["scheduled"] += len(result.assignments)
                stats["unschedulable"] += len(result.unassigned)
        else:
            sched = build_scheduler_from_config(
                # the mirror holds the NodeResourceTopology CRs when the
                # CRD is installed, an empty lister otherwise
                cluster, config, nrt_lister=cluster.nrt_lister,
                policy=policy, tie_break_seed=args.tie_break_seed,
                device=device,
            )
            for pod in pending:
                result = sched.schedule_one(pod)
                stats["scheduled" if result.node else "unschedulable"] += 1
        print(json.dumps({
            "config": args.config,
            "master": args.master,
            "nodes": len(cluster.list_nodes()),
            **stats,
            "wall_seconds": round(time.perf_counter() - t0, 3),
        }))
    finally:
        cluster.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
