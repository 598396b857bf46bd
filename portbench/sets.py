"""Run one cell several times, one process per run as the check does, and
summarise each metric's spread. Not part of a benchmark run.

    python3 portbench/sets.py --workload drip-65k --seconds 30 --seeds 11,12,13 \
        [--trace 1] [--out chiprun_out/drip.jsonl]

Each run's result line (with its seed, exit code and the end of its
standard error) is appended to ``--out``. The summary gives, per metric,
the median and the spread: the distance between the first and third
quartiles (``statistics.quantiles(values, n=4)``) as a share of the
median, of all runs and, as the check computes it for tightness, without
the run farthest from the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / abs(med) if med else None


def trimmed(values: list) -> list:
    """Without the value farthest from the median."""
    if len(values) < 4:
        return values
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def summarise(lines: list) -> dict:
    out = {}
    names = sorted({k for r in lines for k in r.get("metrics", {})})
    for name in names:
        vals = [r["metrics"][name]["value"] for r in lines if name in r.get("metrics", {})]
        out[name] = {"n": len(vals), "median": statistics.median(vals), "min": min(vals),
                     "max": max(vals), "spread": spread(vals),
                     "spread_trimmed": spread(trimmed(vals)), "values": vals}
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--trace", default="0")
    p.add_argument("--out", default=None)
    p.add_argument("--timeout", type=float, default=1200)
    a = p.parse_args()
    lines = []
    for seed in a.seeds.split(","):
        cmd = [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", a.workload,
               "--seed", seed, "--seconds", a.seconds, "--trace", a.trace]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                              timeout=a.timeout)
        wall = time.perf_counter() - t0
        last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
        try:
            result = json.loads(last)
        except json.JSONDecodeError:
            result = {}
        rec = {"workload": a.workload, "seed": seed, "trace": a.trace, "rc": proc.returncode,
               "process_s": wall, "result": result, "stderr_tail": proc.stderr[-3000:]}
        if a.out:
            with open(ROOT / a.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        short = {k: round(v["value"], 4) for k, v in result.get("metrics", {}).items()}
        print(json.dumps({"seed": seed, "rc": proc.returncode, "s": round(wall, 1),
                          "correct": result.get("correct"), "metrics": short,
                          "checks": {k: v["value"] for k, v in result.get("checks", {}).items()}}),
              flush=True)
        if result:
            lines.append(result)
        elif proc.returncode:
            print(proc.stderr[-2000:], flush=True)
    print(json.dumps({"summary": summarise(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
