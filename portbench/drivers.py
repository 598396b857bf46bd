"""What every driver shares. A driver (``kinds/<traffic kind>.py``, found by
the ``kind`` in a traffic mix's file) builds the cell's scheduler on the
configuration's cluster, warms the shapes the cell uses, drives the entry
for the measured window, and after the window compares what the entry
produced with the plain reference.

A driver's life: ``setup`` -> ``warm`` -> ``window`` -> (``profile``) ->
``check``. ``end_to_end`` gives the cell's rate; ``observations`` what the
per-layer readers read. Only the entry calls are the port's work: the
work is made before the window, and nothing the benchmark does for itself
runs inside it.

The kind owns everything that differs between kinds, so a cell of a new
kind joins the benchmark through new files alone. Its ``Driver``
declares:

- ``checks``: the names of the numbers ``compare`` returns, each an exact
  count of disagreements with the plain reference; the harness gives each
  the limit 0, and ``check`` raises when ``compare`` returns a name not
  declared or leaves one out;
- ``controls``: what ``check(control)`` can put in the port's place, and
  ``breaks``: the one of them that breaks the cell's guarantee, which
  must come out not correct;
- ``span``: the benchmark's span around each profiled entry call;

and implements ``setup(profile_calls)``, ``warm()``, ``step()``,
``window(seconds)``, ``end_to_end()``, ``reference(control)``, ``port()``,
``compare(got, want)`` and ``observations()``. The faults its timed path
can have are planted by ``portbench/tests/kinds/<kind>.py``.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from . import cluster as cl


def sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


class Driver:
    span = "bench.call"
    checks: tuple = ()  # the names of the numbers ``compare`` returns
    controls: tuple = ()  # what ``check(control)`` can put in the port's place
    breaks: str | None = None  # the control that breaks the cell's guarantee

    def __init__(self, config: dict, traffic: dict, seed: int, device, nodes=None):
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = device
        self.inputs = cl.node_inputs(config, seed, nodes)
        self.now = float(config["clock"])
        self.call_s: list = []  # wall seconds of each timed entry call
        self.wall_s = 0.0  # the window's wall seconds
        self.profiled_calls = 0
        self.attempted = self.failed = 0

    def positions(self, names) -> np.ndarray:
        """Reference row of each of the port's node names."""
        pos = {n: k for k, n in enumerate(self.inputs["names"])}
        return np.fromiter((pos[n] for n in names), dtype=np.int64, count=len(names))

    def timed_loop(self, seconds: float, step) -> None:
        """Call ``step()`` until ``seconds`` of wall time have passed or it
        finds its backlog empty (returns False); every call's wall time is
        kept."""
        gc.collect()
        sync(self.device)
        start = time.perf_counter()
        t = start
        while t - start < seconds:
            t0 = time.perf_counter()
            if not step():
                break
            t = time.perf_counter()
            self.call_s.append(t - t0)
        self.wall_s = t - start

    def check(self, control: str | None = None) -> dict:
        """The numbers compared, each a count of disagreements with the
        reference, in the order of ``checks``; ``control`` puts one of
        ``controls`` in the port's place on the same work."""
        if not self.checks:
            raise TypeError(f"{type(self).__module__}.Driver declares no checks")
        want = self.reference(None)
        got = self.reference(control) if control else self.port()
        out = self.compare(got, want)
        undeclared = sorted(set(out) - set(self.checks))
        missing = sorted(set(self.checks) - set(out))
        if undeclared or missing:
            raise ValueError(f"{type(self).__module__}.Driver.compare returned undeclared "
                             f"checks {undeclared} and left out declared ones {missing}")
        return {k: out[k] for k in self.checks}

    def profile(self, session, calls: int) -> None:
        for _ in range(calls):
            with session.span(self.span):
                if not self.step():
                    break
            self.profiled_calls += 1
