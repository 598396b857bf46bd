"""Where a drip window's time goes, on the port's own stage clock.

    python3 tools/drip_stages.py --seed 17 --seconds 30 [--mode plain|gc|telemetry]
        [--profile 8] [--nodes N] [--device cuda:0]

Builds the benchmark's ``drip-65k`` cell (``portbench``'s driver, cluster
and traffic, same seed rules) and drives ``Scheduler.schedule_queue`` for
``--seconds`` of 128-pod windows, as ``portbench/run.py`` does; then prints
one JSON line:

- ``call_ms_mean`` / ``call_ms_median``: each call's host wall time;
- ``stage_ms``: ``drip_stats()["batch"]["stage_seconds"]`` over the timed
  window per dispatched window, and their sum against the mean call;
- ``graph``: the batch kernel's ``graph_captures``, ``graph_replays`` and
  ``eager_windows`` since set-up (``total``) and over the timed window
  (``timed``), and the timed windows' replay share;
- ``gc``: pause ms per window and collections per generation while the
  GC pause counter was installed (``--mode gc`` or ``--mode telemetry``);
  with ``--mode gc`` also the median call with the counter on and off;
- with ``--profile N``: N more windows under ``torch.profiler`` with the
  port's ranges on (``telemetry.profiler_ranges``): device ms and kernels
  per window, and the device's idle ms per window by the innermost stage
  or span (``utils.profiling.device_idle_by_range``).

``--mode``: ``plain`` (telemetry off, as the benchmark runs), ``gc`` (the
GC pause counter installed in alternate sixths of the timed window: off,
on, on, off, off, on, so its cost is read on one heap), ``telemetry``
(``telemetry.enable(Telemetry(decision_sample_every=N))``, N from
``--decision-every``: spans, registry, lifecycle, sampled decisions and
the GC counter). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

GRAPH_COUNTERS = ("graph_captures", "graph_replays", "eager_windows")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--mode", choices=("plain", "gc", "telemetry"), default="plain")
    p.add_argument("--decision-every", type=int, default=128,
                   help="decision-trace stride in --mode telemetry")
    p.add_argument("--profile", type=int, default=0, help="profiled windows after the window")
    p.add_argument("--nodes", type=int, default=None, help="shrink the cluster (CPU rehearsal)")
    p.add_argument("--device", default="cuda:0")
    a = p.parse_args()

    from portbench.env import configure

    configure(ROOT)
    import torch

    from crane_scheduler_tpu_torch import telemetry
    from crane_scheduler_tpu_torch.utils.profiling import device_idle_by_range
    from portbench.cluster import load_config
    from portbench.drivers import sync
    from portbench.harness import load_manifest
    from portbench.kinds.drip_backlog import Driver
    from portbench.traffic import load_traffic

    if a.device.startswith("cuda") and not torch.cuda.is_available():
        print("drip_stages: no CUDA device", file=sys.stderr)
        return 2
    manifest = load_manifest(ROOT)
    cell = next(w for w in manifest["workloads"] if w["name"] == "drip-65k")
    cfg = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    traffic = load_traffic(ROOT, cell["traffic"])
    if a.mode == "telemetry":
        telemetry.enable(telemetry.Telemetry(decision_sample_every=a.decision_every))
    gc.disable()
    try:
        driver = Driver(load_config(ROOT, cfg["file"]), traffic, a.seed, a.device, a.nodes)
        driver.setup(a.profile)
    finally:
        gc.enable()
    driver.warm()
    sched = driver.sched
    counter = telemetry.GC_PAUSES
    pre = sched.drip_stats()["batch"]
    gc_pre = (list(counter.seconds), list(counter.collections))
    start = len(driver.results)
    if a.mode == "gc":
        # one collection first, as the benchmark's window makes; then the
        # sixths back to back
        by_on, on_windows = {True: [], False: []}, 0
        gc.collect()
        sync(a.device)
        t_start = time.perf_counter()
        for on in (False, True, True, False, False, True):
            if on:
                counter.install()
            d0 = sched.drip_stats()["batch"]["dispatches"]
            t_end = time.perf_counter() + a.seconds / 6
            while time.perf_counter() < t_end:
                t0 = time.perf_counter()
                driver.step()
                by_on[on].append(time.perf_counter() - t0)
            counter.uninstall()
            if on:
                on_windows += sched.drip_stats()["batch"]["dispatches"] - d0
        pods_per_s = (sum(n is not None for n in driver.results[start:])
                      / (time.perf_counter() - t_start))
        calls = by_on[False] + by_on[True]
    else:
        driver.window(a.seconds)
        pods_per_s = driver.end_to_end()["drip_pods_per_s"]
        calls = driver.call_s
    post = sched.drip_stats()["batch"]
    gc_post = (list(counter.seconds), list(counter.collections))
    windows = post["dispatches"] - pre["dispatches"]
    stage_ms = {k: (post["stage_seconds"][k] - pre["stage_seconds"][k]) * 1e3 / windows
                for k in post["stage_seconds"]}
    mean_ms = 1e3 * sum(calls) / len(calls)
    out = {
        "mode": a.mode, "seed": a.seed, "device": torch.cuda.get_device_name()
        if a.device.startswith("cuda") else "cpu",
        "nodes": driver.inputs["n"], "calls": len(calls), "windows": windows,
        "pods_per_s": pods_per_s,
        "call_ms_mean": mean_ms, "call_ms_median": 1e3 * statistics.median(calls),
        "stage_ms": stage_ms, "stage_sum_ms": sum(stage_ms.values()),
        "stage_share_of_call": sum(stage_ms.values()) / mean_ms,
        "graph": {
            "total": {k: post[k] for k in GRAPH_COUNTERS},
            "timed": {k: post[k] - pre[k] for k in GRAPH_COUNTERS},
            "replay_share": (post["graph_replays"] - pre["graph_replays"]) / windows,
        },
    }
    if a.mode != "plain":
        counted = on_windows if a.mode == "gc" else windows
        out["gc"] = {
            "pause_ms_per_window": 1e3 * (sum(gc_post[0]) - sum(gc_pre[0])) / counted,
            "pause_ms": [1e3 * (y - x) for x, y in zip(gc_pre[0], gc_post[0])],
            "collections": [y - x for x, y in zip(gc_pre[1], gc_post[1])],
        }
        if a.mode == "gc":
            out["gc"].update({f"call_ms_median_{'on' if on else 'off'}":
                              1e3 * statistics.median(c) for on, c in by_on.items()})
    if a.profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if a.device.startswith("cuda"):
            activities.append(ProfilerActivity.CUDA)
        pre = sched.drip_stats()["batch"]["dispatches"]
        sync(a.device)
        with profile(activities=activities) as prof:
            with telemetry.profiler_ranges():
                for _ in range(a.profile):
                    driver.step()
                sync(a.device)
        n = sched.drip_stats()["batch"]["dispatches"] - pre
        events = list(prof.events())
        ranges = {e.name for e in events if e.device_type == DeviceType.CPU
                  and getattr(e, "is_user_annotation", False)}
        dev = [e for e in events if e.device_type != DeviceType.CPU and e.name not in ranges
               and e.time_range.end > e.time_range.start]
        idle = device_idle_by_range(events)
        total = sum(idle.values())
        # device time: its first to its last operation, less the idle
        busy = (max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)
                - 1e6 * total if dev else 0.0)
        out["profile"] = {
            "windows": n,
            "device_ms_per_window": busy * 1e-3 / n,
            "kernels_per_window": sum(1 for e in dev if not e.name.startswith(
                ("Memcpy", "Memset"))) / n,
            "idle_ms_per_window": {str(k): 1e3 * v / n for k, v in
                                   sorted(idle.items(), key=lambda kv: -kv[1])},
            "idle_in_launch_share": idle.get("drip_launch", 0.0) / total if total else None,
            "device_idle_share_of_call": 1.0 - busy * 1e-3 / n / mean_ms if n else None,
        }
    telemetry.disable()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
