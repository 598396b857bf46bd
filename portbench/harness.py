"""Run one cell of ``BENCHMARK.json`` once and print its result line.

``main`` refuses to measure without the CUDA devices the cell asks for;
``run_cell`` is the whole run behind it (the tests drive it on the CPU at a
small size). A run: set-up (cluster, scheduler, traffic, warm-up) ->
measured window -> with ``--trace 1`` a profiled stretch -> the check
against the reference -> the line. ``correct`` holds when every number
compared is within its limit. What differs between traffic kinds (the
numbers compared, the controls, what the readers read) is the kind's own
(``drivers.py``); this file names none of it.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "crane_scheduler_tpu")


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _reader(root: Path, name: str):
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def resolve(manifest: dict, workload: str, root: Path = ROOT) -> tuple:
    """The cell, its configuration, its traffic mix and the module of the
    mix's kind (``portbench.kinds.<kind>``)."""
    from .cluster import load_config
    from .traffic import load_traffic

    cell = next(w for w in manifest["workloads"] if w["name"] == workload)
    cfg = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    traffic = load_traffic(root, cell["traffic"])
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    return cell, load_config(root, cfg["file"]), traffic, kind


def cell_metrics(manifest: dict, workload: str) -> tuple[list, list]:
    """The end-to-end and per-layer metrics this cell reports."""
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def run_cell(manifest: dict, workload: str, seed: int, seconds: float, trace: bool,
             device, t0: float, root: Path = ROOT, nodes: int | None = None,
             controls: bool = False) -> dict:
    """One run of ``workload``; returns the result line as a dict (with
    ``checks`` last). ``nodes`` shrinks the cluster (tests only);
    ``controls`` also judges each of the driver's controls in the port's
    place on the same work (``control.py``; never in a benchmark run)."""
    import torch

    # the driver of the mix's kind, and the entry calls it profiles in a
    # traced run
    cell, config, traffic, kind = resolve(manifest, workload, root)
    profile_calls = int(traffic["profile_calls"])
    # the cluster and the backlog are built in bulk with the collector off
    # (it would walk the growing heap again and again); the window's
    # ``gc.collect()`` starts it from one state
    gc.disable()
    try:
        driver = kind.Driver(config, traffic, seed, device, nodes)
        driver.setup(profile_calls if trace else 0)
    finally:
        gc.enable()
    driver.warm()
    setup_s = time.perf_counter() - t0
    driver.window(seconds)
    cuda = str(device).startswith("cuda")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rates = driver.end_to_end()
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    e2e, layer = cell_metrics(manifest, workload)
    out_metrics = {}
    summary = None
    if trace:
        from .trace import Session, breakdown

        session = Session()
        with session.run():
            driver.profile(session, profile_calls)
        summary = session.summary()
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        obs = {"call_s": driver.call_s, "profile": summary,
               "profiled_calls": driver.profiled_calls, **driver.observations()}
        for m in layer:
            value = _reader(root, m["name"])(obs)
            if value is not None:
                out_metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(rates, setup_s=setup_s)
        for m in e2e:
            out_metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    # every number compared is an exact count of disagreements with the
    # reference: its limit is 0
    limits = dict.fromkeys(driver.checks, 0)
    checks = driver.check()
    result = {
        "correct": all(checks[k] <= limits[k] for k in checks),
        "attempted": int(driver.attempted), "failed": int(driver.failed),
        "metrics": out_metrics, "device": dev,
    }
    if summary is not None:
        result["breakdown"] = breakdown(summary)
    calls = driver.call_s
    tenth = max(1, len(calls) // 10)
    # how the window's calls moved from its first tenth to its last (a
    # state that drifts with the window's length shows here)
    result["window"] = {"calls": len(calls), "wall_s": driver.wall_s,
                        "mean_ms": 1e3 * sum(calls) / len(calls) if calls else None,
                        "first_tenth_ms": 1e3 * sum(calls[:tenth]) / tenth if calls else None,
                        "last_tenth_ms": 1e3 * sum(calls[-tenth:]) / tenth if calls else None}
    if controls:
        result["controls"] = {c: driver.check(c) for c in driver.controls}
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    return result


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    import torch

    manifest = load_manifest()
    cell = next((w for w in manifest["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark never measures on the CPU",
              file=sys.stderr)
        return 2
    count = torch.cuda.device_count()
    print(f"portbench: {count} x {torch.cuda.get_device_name(0)}", file=sys.stderr)
    if count < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} devices, {count} present",
              file=sys.stderr)
        return 2
    result = run_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {found}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
