"""A configuration's cluster, made from ``--seed``.

The configuration file (``configs/<name>.json``) gives the node count, the
Dynamic policy, how annotations are drawn and what allocatable each node
reports. ``node_inputs`` draws the raw inputs once; the port gets them as
``Node`` objects through ``ClusterState.replace_nodes`` and the reference
reads the same arrays.
"""

from __future__ import annotations

import json
import re
from datetime import datetime, timezone
from pathlib import Path
from zoneinfo import ZoneInfo

import numpy as np

HOT_KEY = "node_hot_value"
# the annotation timestamps' zone: the wire format is local time with a
# literal "Z" (crane-scheduler pkg/utils); run.py sets TZ to the same zone
ZONE = "Asia/Shanghai"
TIME_FORMAT = "%Y-%m-%dT%H:%M:%SZ"
_SUFFIX = {"": 1, "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12,
           "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40}


def load_config(root: Path, file: str) -> dict:
    return json.loads((root / file).read_text())


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per use of the seed (nodes, traffic, the
    check's sample); any whole number is a valid seed."""
    return np.random.default_rng([int(seed) % 2**63, stream])


def quantity(text, milli: bool = False) -> int:
    """A Kubernetes quantity (``100m``, ``16``, ``64Gi``) as an integer;
    ``milli`` gives thousandths (CPU)."""
    m = re.fullmatch(r"(\d+)(m|k|M|G|T|Ki|Mi|Gi|Ti)?", str(text))
    if not m:
        raise ValueError(f"unsupported quantity {text!r}")
    num, suf = int(m.group(1)), m.group(2) or ""
    if suf == "m":
        if not milli:
            raise ValueError(f"fractional quantity {text!r}")
        return num
    return num * _SUFFIX[suf] * (1000 if milli else 1)


def request_vec(req: dict) -> np.ndarray:
    """int64 [milli-cpu, memory, ephemeral-storage, pod slots]."""
    return np.array([quantity(req.get("cpu", "0"), milli=True), quantity(req.get("memory", "0")),
                     quantity(req.get("ephemeral-storage", "0")), 1], dtype=np.int64)


def allocatable_vec(alloc: dict | None) -> tuple[np.ndarray, bool]:
    if not alloc:
        return np.zeros(4, np.int64), False
    return np.array([quantity(alloc["cpu"], milli=True), quantity(alloc["memory"]),
                     quantity(alloc.get("ephemeral-storage", "0")), int(alloc["pods"])], np.int64), True


def metric_names(config: dict) -> list:
    """Every metric the policy reads, in first-mention order."""
    spec = config["policy"]["spec"]
    out = []
    for group in ("syncPolicy", "predicate", "priority"):
        for entry in spec.get(group, []):
            if entry["name"] not in out:
                out.append(entry["name"])
    return out


def wire_time(epoch: int) -> str:
    return datetime.fromtimestamp(epoch, tz=timezone.utc).astimezone(ZoneInfo(ZONE)) \
        .strftime(TIME_FORMAT)


def node_inputs(config: dict, seed: int, nodes: int | None = None) -> dict:
    """The raw node inputs: names, annotation value strings and their
    parsed values, timestamps, hot values and allocatable."""
    n = int(nodes or config["nodes"])
    anno = config["annotations"]
    metrics = metric_names(config)
    rng = rng_for(seed, 1)
    lo, hi = anno["usage_range"]
    raw = rng.uniform(lo, hi, (n, len(metrics)))
    text = np.char.mod(f"%.{int(anno['decimals'])}f", raw)
    values = text.astype(np.float64)  # what a reader of the strings gets
    hot = rng.choice(np.asarray(anno["hot_values"], np.int64), n)
    now = float(config["clock"])
    ts = int(now) - int(anno["age_s"])
    width = max(5, len(str(n - 1)))
    alloc, bounded = allocatable_vec(config.get("allocatable"))
    return {
        "n": n, "metrics": metrics, "now": now,
        "names": [f"node-{i:0{width}d}" for i in range(n)],
        "text": text, "values": values, "ts": np.full((n, len(metrics)), float(ts)),
        "hot": hot.astype(np.float64), "hot_ts": np.full(n, float(ts)),
        "ts_wire": wire_time(ts),
        "free": np.tile(alloc, (n, 1)), "bounded": np.full(n, bounded),
    }


def annotations(inputs: dict) -> list:
    """One annotation dict per node, as the annotator writes them."""
    stamp = "," + inputs["ts_wire"]
    metrics = inputs["metrics"]
    hot = [f"{int(h)}{stamp}" for h in inputs["hot"]]
    rows = np.char.add(inputs["text"], stamp).tolist()
    return [dict(zip(metrics, row), **{HOT_KEY: hv}) for row, hv in zip(rows, hot)]


def build_cluster(config: dict, inputs: dict):
    """The port's ``ClusterState`` holding the configuration's nodes."""
    from crane_scheduler_tpu_torch.cluster import ClusterState, Node

    alloc = config.get("allocatable") or {}
    cluster = ClusterState()
    cluster.replace_nodes(Node(name=name, annotations=a, allocatable=alloc)
                          for name, a in zip(inputs["names"], annotations(inputs)))
    return cluster


def policy(config: dict):
    """The port's ``DynamicSchedulerPolicy`` decoded from the file's
    document (JSON is YAML)."""
    from crane_scheduler_tpu_torch.policy import load_policy

    return load_policy(json.dumps(config["policy"]))
