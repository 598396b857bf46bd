"""The one traffic generator: it reads a mix's parameters from
``traffic/<name>.json`` and draws the cell's work from ``--seed``.

A mix's ``kind`` names the driver (``kinds/<kind>.py``) that feeds it to
the port's entry. ``drip_requests`` draws pods from the mix's
``requests``: each entry's share of the pods is fixed, their order is
drawn from the seed, so every seed gets the same multiset of sizes.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .cluster import request_vec, rng_for


def load_traffic(root: Path, name: str) -> dict:
    doc = json.loads((root / "portbench" / "traffic" / f"{name}.json").read_text())
    doc["name"] = name
    return doc


def drip_requests(traffic: dict, seed: int, count: int) -> tuple[list, np.ndarray]:
    """``count`` pod requests (the request dicts and their int64 [count,
    4] rows): each entry of ``requests`` takes its ``share`` of the pods,
    in an order drawn from the seed."""
    reqs = traffic["requests"]
    shares = np.array([r.get("share", 1.0) for r in reqs], np.float64)
    n_each = np.floor(shares / shares.sum() * count).astype(np.int64)
    n_each[0] += count - n_each.sum()
    kind = np.repeat(np.arange(len(reqs)), n_each)
    if len(reqs) > 1:
        rng_for(seed, 2).shuffle(kind)
    vecs = np.stack([request_vec(r["resources"]) for r in reqs])[kind]
    return [reqs[k]["resources"] for k in kind], vecs
