"""Readings of the controls at a cell's own size, on the card. Not part of
a benchmark run.

    python3 portbench/control.py --workload drip-65k --seconds 30 --seed 17 \
        [--out chiprun_out/controls.jsonl]

One run of the cell as the benchmark makes it; then, on the same work,
each control's outputs take the port's place and are judged by the same
comparison: the reference in float32 (the precision below the plugin's
float64) and the cell's guarantee broken (``no_fold``: a drip window whose
pods all see its start). Prints one JSON line with the port's numbers (the lower
readings) and each control's (the upper readings).
"""

import json
import sys
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.env import configure  # noqa: E402

configure(ROOT)

from portbench.harness import load_manifest, run_cell  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None)
    a = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    r = run_cell(load_manifest(ROOT), a.workload, a.seed, a.seconds, False, "cuda:0", T0,
                 controls=True)
    line = {"workload": a.workload, "seed": a.seed, "correct": r["correct"],
            "port": {k: v["value"] for k, v in r["checks"].items()},
            "controls": r["controls"], "metrics": r["metrics"]}
    if a.out:
        with open(ROOT / a.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
