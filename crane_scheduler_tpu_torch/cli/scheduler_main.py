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
scheduler runs against a live kube-apiserver through the kube mirror
(``cluster/kube.py``), reading the annotator's node annotations from the
mirror and binding through the ``binding`` subresource:

- one shot (the default): the cluster's pending pods (all of them, or
  the first ``--pods``), in ``schedule_batch_mixed`` bursts
  (``--batch-size``, NUMA enforcement from the mirror's
  NodeResourceTopology CRs when the profile enables it) or per pod
  through the configured plugins;
- ``--serve``: the long-running drip loop (``Scheduler.open_queue``):
  pending pods stream into dispatch windows of ``--window`` pods, a
  half-filled window flushes on the next quiet poll, ``--run-seconds``
  bounds the run, ``--bind-watermark-pods`` pauses dispatch while the
  kube write plane holds that many unsent writes, and SIGTERM/SIGINT
  drain the open window before the client is torn down;
- ``--journal-dir``: the crash-safe placement-intent journal
  (``resilience/recovery.py``); startup replays it and reconciles every
  unresolved bind against the live apiserver before scheduling opens;
- ``--lock-file`` (with ``--serve``): a warm standby on the file lock
  that reconciles the dead leader's journal before its first bind;
- ``--shards N --shard-index i [--shard-overlap f] [--shard-ring R]``:
  this process schedules only shard ``i`` of the node keyspace (a
  ``ShardView`` over the mirror) and only the pending pods whose key
  hashes to ``i``; ``--serve`` polls the ring file and adopts a
  higher-versioned ring live.

- ``--placement-mesh N``: the drip window (plugin mode, one shot and
  ``--serve``) tiles its columns over a placement mesh of N distinct GPUs
  (with ``--device cpu`` the host is one device); more than the host has
  raises the reference's ``requested N devices, only K available``.

Without ``--master`` the master-mode flags parse and do nothing, exactly
as in the reference's sim mode.

The result is one JSON line with the reference's keys.

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



def _shard_mode(args, cluster):
    """``--shards`` wiring shared by the serve and one-shot modes: wrap the
    mirror in this process's ``ShardView`` and return a pod filter, so N
    cooperating processes partition the pending queue by pod-key hash
    (nodes shard by name, pods by key, both deterministic: no two
    processes ever POST the same bind)."""
    if args.shards <= 1:
        return cluster, None
    from ..cluster.shards import HashRing, ShardSpec, shard_of
    from ..framework.shardplane import ShardView

    layout = None
    if args.shard_ring:
        with open(args.shard_ring) as f:
            layout = HashRing.from_spec(json.load(f))
        if layout.count != args.shards:
            raise SystemExit(
                f"--shard-ring has {layout.count} shards, --shards says {args.shards}"
            )
    cluster.configure_shards(args.shards, args.shard_overlap, layout=layout)
    view = ShardView(cluster, ShardSpec(args.shard_index, args.shards,
                                        args.shard_overlap, layout=layout))

    def pod_filter(key: str) -> bool:
        return shard_of(key, args.shards) == args.shard_index

    return view, pod_filter


def _ring_sync(args, cluster):
    """Serve-loop hook for ``--shard-ring``: re-read the ring file when it
    changes and adopt a higher-versioned layout through
    ``cluster.reshard`` (the mirror journals every moved name, so the view
    and its columns patch O(moved) rows mid-storm). All cooperating
    processes poll the same file; the version check makes adoption
    idempotent."""
    if not args.shard_ring or args.shards <= 1:
        return None
    from ..cluster.shards import HashRing

    last = {"mtime": os.path.getmtime(args.shard_ring)}

    def sync():
        try:
            mtime = os.path.getmtime(args.shard_ring)
        except OSError:
            return  # mid-rename; the next poll sees the new file
        if mtime == last["mtime"]:
            return
        last["mtime"] = mtime
        try:
            with open(args.shard_ring) as f:
                target = HashRing.from_spec(json.load(f))
        except (OSError, ValueError, KeyError):
            return
        live = cluster.shard_keyspace()
        if live is not None and target.version > live.version:
            moved = cluster.reshard(target)
            print(json.dumps({"event": "reshard", "ring_version": target.version,
                              "moved_nodes": len(moved)}), flush=True)

    return sync


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
    # the master-mode planes: without --master they do nothing, as in the
    # reference's sim mode
    master_only = parser.add_argument_group("--master mode only")
    master_only.add_argument("--journal-dir", default=None,
                             help="crash-safe placement-intent journal "
                                  "directory: startup replays it and reconciles "
                                  "every unresolved bind against the live "
                                  "apiserver before scheduling opens")
    master_only.add_argument("--serve", action="store_true",
                             help="long-running drip serving loop instead of "
                                  "one shot; SIGTERM drains the open window "
                                  "before teardown")
    master_only.add_argument("--run-seconds", type=float, default=0.0,
                             help="--serve: exit after this long (0 = until "
                                  "SIGTERM/SIGINT)")
    master_only.add_argument("--placement-mesh", type=int, default=0,
                             help="shard the drip window's columns over the "
                                  "first N local devices; 0 = single-device "
                                  "window")
    master_only.add_argument("--shards", type=int, default=1,
                             help="partition the node keyspace into N shards "
                                  "and schedule only this process's shard")
    master_only.add_argument("--shard-index", type=int, default=0,
                             help="which shard this process owns (0..shards-1)")
    master_only.add_argument("--shard-overlap", type=float, default=0.0,
                             help="fraction of the keyspace co-owned with the "
                                  "ring-successor shard (0 = disjoint)")
    master_only.add_argument("--shard-ring", default=None,
                             help="consistent-hash ring spec (JSON, "
                                  "HashRing.spec_dict); --serve adopts "
                                  "higher-versioned rings live")
    master_only.add_argument("--window", type=int, default=32,
                             help="--serve: drip dispatch window size")
    master_only.add_argument("--bind-watermark-pods", type=int, default=0,
                             help="--serve: pause dispatch windows while the "
                                  "kube write plane holds this many unsent "
                                  "writes (0 disables)")
    master_only.add_argument("--lock-file", default=None,
                             help="--serve: leader-election lock path; the "
                                  "process is a warm standby until it holds "
                                  "the lease and has reconciled the journal")
    args = parser.parse_args(argv)

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
        return _master(args, config, profile, policy or DEFAULT_POLICY, device)

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


def _master(args, config, profile, policy, device) -> int:
    """The reference's ``--master`` branch: the kube mirror, the intent
    journal and its reconciliation, then the serving loop or one pass over
    the pending pods."""
    from ..cluster.kube import KubeClusterClient

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
        lifecycle = telemetry.lifecycle if telemetry is not None else None

        journal = None
        recovery = None
        if args.journal_dir:
            from ..resilience.recovery import IntentJournal, Reconciler

            journal = IntentJournal(args.journal_dir, fsync=args.flight_fsync,
                                    telemetry=telemetry)
            if not args.lock_file:
                # crash recovery: replay and reconcile the journal tail
                # against the live apiserver before any scheduling (a
                # lock-file serve defers this to lease acquisition)
                recovery = Reconciler(journal, cluster.get_pod_live, lifecycle=lifecycle,
                                      telemetry=telemetry).reconcile()
            cluster.attach_intent_journal(journal)

        if args.serve:
            return _serve(args, cluster, config, policy, device, journal, recovery,
                          telemetry)
        if telemetry is not None:
            _tel.flush_on_signal(telemetry)
        _master_once(args, cluster, config, profile, policy, device, recovery)
        # the watch thread tombstones into the journal: stop it first
        cluster.stop()
        if journal is not None:
            journal.close()
    finally:
        cluster.stop()
    return 0


def _placement_mesh(args, device):
    """``--placement-mesh N``: the drip window's placement mesh, or None."""
    if args.placement_mesh <= 0:
        return None
    from ..parallel.mesh import local_mesh

    return local_mesh(args.placement_mesh, device)


def _master_once(args, cluster, config, profile, policy, device, recovery) -> None:
    """One pass over the live cluster's pending pods (the reference's
    one-shot ``--master`` branch); prints the result line."""
    from ..config import build_scheduler_from_config
    from ..framework.scheduler import BatchScheduler

    sched_cluster, pod_filter = _shard_mode(args, cluster)
    pending = [p for p in cluster.list_pods() if not p.node_name]
    if pod_filter is not None:
        pending = [p for p in pending if pod_filter(p.key())]
    if args.pods is not None:  # unset means ALL pending, never 50
        pending = pending[: args.pods]
    stats = {"scheduled": 0, "unschedulable": 0}
    t0 = time.perf_counter()
    if args.batch_size > 0:
        from ..topology import TopologyMatch

        # NUMA enforcement follows the scheduler config, as in plugin
        # mode (an enabled plugin with no CRs marks guaranteed-CPU pods
        # unschedulable in both paths, filter.go:56-58)
        topology = (
            TopologyMatch(cluster.nrt_lister, cluster=cluster)
            if "NodeResourceTopologyMatch" in set(profile.filter_enabled)
            else None
        )
        batch = BatchScheduler(cluster, policy, device=device)
        for i in range(0, len(pending), args.batch_size):
            result = batch.schedule_batch_mixed(pending[i : i + args.batch_size],
                                                topology=topology)
            stats["scheduled"] += len(result.assignments)
            stats["unschedulable"] += len(result.unassigned)
    else:
        sched = build_scheduler_from_config(
            # the mirror holds the NodeResourceTopology CRs when the CRD
            # is installed, an empty lister otherwise
            sched_cluster, config, nrt_lister=cluster.nrt_lister,
            policy=policy, tie_break_seed=args.tie_break_seed, device=device,
            mesh=_placement_mesh(args, device),
        )
        if pod_filter is not None:
            sched.conflict_retry = True
        for pod in pending:
            result = sched.schedule_one(pod)
            stats["scheduled" if result.node else "unschedulable"] += 1
    out = {
        "config": args.config,
        "master": args.master,
        "nodes": len(cluster.list_nodes()),
        **stats,
        "wall_seconds": round(time.perf_counter() - t0, 3),
    }
    if recovery is not None:
        out["recovery"] = recovery.as_dict()
    print(json.dumps(out))


def _serve(args, cluster, config, policy, device, journal, recovery, telemetry) -> int:
    """Long-running drip serving: pending pods stream into an incremental
    dispatch window (``Scheduler.open_queue``). SIGTERM/SIGINT drain the
    open, possibly half-filled, window before the client is torn down, so
    an orderly kill never loses buffered pods; with ``--lock-file`` the
    process is a warm standby that reconciles the journal directory the
    moment it wins the lease, before its first bind."""
    import signal
    import threading

    from ..config import build_scheduler_from_config

    stop = threading.Event()

    def _on_signal(*_a):
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    if telemetry is not None:
        from .. import telemetry as _tel

        # chained after the stop handler: a SIGTERM flushes the flight
        # spans, then sets stop
        _tel.flush_on_signal(telemetry)

    standby = None
    if args.lock_file:
        from ..resilience.recovery import WarmStandby

        journal_dir = args.journal_dir or os.path.join(
            os.path.dirname(os.path.abspath(args.lock_file)), "intents")
        standby = WarmStandby(
            args.lock_file,
            identity=f"scheduler-{os.getpid()}",
            journal_dir=journal_dir,
            lookup=cluster.get_pod_live,
            lifecycle=telemetry.lifecycle if telemetry is not None else None,
            telemetry=telemetry,
            journal=journal,
        ).start()
        # warm standby: the mirror watch-follows the live cluster while we
        # wait; binding opens only once the lease is ours and the dead
        # leader's journal is reconciled
        while not standby.wait_ready(0.2):
            if stop.is_set():
                standby.stop()
                return 0
        recovery = standby.report
        journal = standby.journal
        cluster.attach_intent_journal(journal)

    sched_cluster, pod_filter = _shard_mode(args, cluster)
    ring_sync = _ring_sync(args, cluster)
    sched = build_scheduler_from_config(
        sched_cluster, config, nrt_lister=cluster.nrt_lister,
        policy=policy, tie_break_seed=args.tie_break_seed, device=device,
        mesh=_placement_mesh(args, device),
    )
    if pod_filter is not None:
        sched.conflict_retry = True
    if args.bind_watermark_pods > 0:
        # overload backpressure: pause dispatch windows while the kube
        # write plane holds >= watermark unsent writes
        watermark = args.bind_watermark_pods

        def _bind_backpressure():
            while cluster.pending_writes() >= watermark and not stop.is_set():
                time.sleep(0.01)

        sched.bind_backpressure = _bind_backpressure
    queue = sched.open_queue(window=args.window)
    deadline = time.monotonic() + args.run_seconds if args.run_seconds > 0 else None
    offered: set = set()
    stats = {"scheduled": 0, "unschedulable": 0}

    def _harvest():
        for r in queue.take_results():
            stats["scheduled" if r.node else "unschedulable"] += 1

    t0 = time.perf_counter()
    while not stop.is_set():
        if deadline is not None and time.monotonic() >= deadline:
            break
        if ring_sync is not None:
            ring_sync()
        live = cluster.list_pods()
        offered &= {p.key() for p in live}  # deleted pods may return
        progressed = 0
        for pod in live:
            if pod.node_name or pod.key() in offered:
                continue
            if pod_filter is not None and not pod_filter(pod.key()):
                continue  # another shard's process owns this pod
            offered.add(pod.key())
            queue.offer(pod)
            progressed += 1
        _harvest()
        if not progressed:
            if len(queue):
                # idle flush: a half-filled window must not wait for more
                # arrivals (or SIGTERM)
                queue.drain()
                _harvest()
            stop.wait(0.05)
    # the drain: dispatch or flush whatever the signal interrupted
    drained = queue.drain()
    _harvest()
    out = {
        "config": args.config,
        "master": args.master,
        "mode": "serve",
        **stats,
        "drained_at_exit": drained,
        "wall_seconds": round(time.perf_counter() - t0, 3),
    }
    if recovery is not None:
        out["recovery"] = recovery.as_dict()
    if standby is not None and standby.failover_seconds is not None:
        out["failover_seconds"] = round(standby.failover_seconds, 4)
    print(json.dumps(out), flush=True)
    # the watch thread tombstones into the journal: stop it first
    cluster.stop()
    if standby is not None:
        standby.stop()
    elif journal is not None:
        journal.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
