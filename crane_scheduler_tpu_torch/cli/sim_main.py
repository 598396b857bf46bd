"""crane-sim: end-to-end simulated cluster scheduling.

Counterpart of ``crane_scheduler_tpu/cli/sim_main.py``, on PyTorch:
``--device`` (default ``cuda``, which needs a GPU; or ``cpu``) is where
the scheduler runs. ``--mode sharded`` tiles the batch step's node axis
over a node mesh of ``--devices`` distinct GPUs (0 = all of them); with
``--device cpu`` the host is one device, as JAX's CPU platform is, and
asking for more raises the reference's device-count error.

Runs the full loop (synthetic metrics -> annotator -> scorer -> binding
feedback) in one of three scorer modes and reports placement + latency
stats as JSON. The reference's equivalent "e2e" is manually applying
examples/cpu_stress.yaml and watching for the Scheduled event
(ref: README.md:155-197); this is that check, automated and at scale.

Usage:
  python -m crane_scheduler_tpu_torch.cli.sim_main --nodes 100 --pods 200 \
      --mode batch [--policy-file policy.yaml] [--sync-every 50]
"""

from __future__ import annotations

import argparse
import json
import time as _time

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="crane-sim")
    parser.add_argument("--nodes", type=int, default=16)
    parser.add_argument("--pods", type=int, default=64)
    parser.add_argument("--mode", choices=["plugin", "batch", "sharded"], default="batch")
    parser.add_argument("--policy-file", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sync-every", type=int, default=0,
                        help="re-run the annotator every K pods (plugin mode)")
    parser.add_argument("--devices", type=int, default=0,
                        help="sharded mode: mesh size (0 = all)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to schedule on: cuda (default; "
                             "needs a GPU) or cpu")
    parser.add_argument("--f32", action="store_true", help="float32 fast path")
    parser.add_argument("-v", "--verbose", action="count", default=0,
                        help="raise [crane] log verbosity (-v sweeps/"
                             "windows, -vv cycles, -vvv per-pod); "
                             "default run is quiet")
    args = parser.parse_args(argv)

    from ..utils.logging import set_verbosity

    if args.verbose:
        set_verbosity(args.verbose)

    import torch

    from ..parallel.mesh import local_mesh
    from ..policy import DEFAULT_POLICY, load_policy_from_file
    from ..scorer import gang_kernel, score_kernel
    from ..sim import SimConfig, Simulator

    policy = (
        load_policy_from_file(args.policy_file) if args.policy_file else DEFAULT_POLICY
    )
    sim = Simulator(SimConfig(n_nodes=args.nodes, seed=args.seed), policy=policy)
    sim.sync_metrics()

    from .. import telemetry as telemetry_mod

    tel = telemetry_mod.active()
    if tel is not None:
        from ..telemetry.fleet import register_build_info

        register_build_info(tel.registry, "sim")

    dtype = torch.float32 if args.f32 else torch.float64
    latencies = []

    if args.mode == "plugin":
        sched = sim.build_scheduler(device=args.device)
        for i in range(args.pods):
            pod = sim.make_pod()
            t0 = _time.perf_counter()
            result = sched.schedule_one(pod)
            latencies.append(_time.perf_counter() - t0)
            sim.record(result.node)
            sim.clock.advance(1.0)
            if args.sync_every and (i + 1) % args.sync_every == 0:
                sim.sync_metrics()
    else:
        mesh = None
        if args.mode == "sharded":
            mesh = local_mesh(args.devices or None, args.device)
        sched = sim.build_batch_scheduler(dtype=dtype, device=args.device, mesh=mesh)
        pods = [sim.make_pod() for _ in range(args.pods)]
        t0 = _time.perf_counter()
        result = sched.schedule_batch(pods)
        latencies.append(_time.perf_counter() - t0)
        for pod in pods:
            sim.record(result.assignments.get(pod.key()))

    lat = np.array(latencies) if latencies else np.array([0.0])
    top = sorted(sim.stats.placements.items(), key=lambda kv: -kv[1])[:5]
    print(
        json.dumps(
            {
                "mode": args.mode,
                "device": str(sched.device),
                "nodes": args.nodes,
                "pods": args.pods,
                "scheduled": sim.stats.scheduled,
                "unschedulable": sim.stats.unschedulable,
                "distinct_nodes_used": len(sim.stats.placements),
                "top_nodes": dict(top),
                "kernel_launches": {"score": score_kernel.KERNEL.launches,
                                    "gang": gang_kernel.KERNEL.launches},
                "latency_ms": {
                    "mean": float(lat.mean() * 1e3),
                    "p50": float(np.percentile(lat, 50) * 1e3),
                    "p99": float(np.percentile(lat, 99) * 1e3),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
