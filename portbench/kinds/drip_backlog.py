"""``Scheduler.schedule_queue(window=W)`` over a closed backlog of bare
pods, one window per call: every pod of the run is made and queued in
set-up, as a scheduler's queue holds them, and the window drains it.

The pods of a run, in queue order: one warm window of pods that fit
nowhere, ``warm_windows`` windows, the backlog proper (``backlog_pods``),
and in a traced run ``profile_calls`` windows set apart for the profiled
stretch. The measured window stops at the end of the backlog proper, so a
run that drains it early still profiles every one of its windows."""

from __future__ import annotations

import sys

import numpy as np

from .. import cluster as cl
from .. import traffic as tr
from ..drivers import Driver as Base
from ..drivers import sync
from ..reference import dynamic as ref_dyn
from ..reference import place as ref_place


class Driver(Base):
    span = "bench.drip.schedule_queue"
    checks = ("placement_mismatch", "score_mismatch", "count_mismatch")
    # ``float32``: the reference a precision below the plugin's float64;
    # ``no_fold``: a window whose pods all see the free state at its start
    controls = ("float32", "no_fold")
    breaks = "no_fold"
    # the batch counters of ``drip_stats()`` whose deltas over the measured
    # window the readers read, beside the stage clock's seconds
    COUNTERS = ("dispatches", "graph_captures", "graph_replays", "eager_windows")

    def setup(self, profile_calls: int) -> None:
        from crane_scheduler_tpu_torch.cluster import Container, Pod, ResourceRequirements
        from crane_scheduler_tpu_torch.fit import FitTracker, ResourceFitPlugin
        from crane_scheduler_tpu_torch.framework.scheduler import Scheduler
        from crane_scheduler_tpu_torch.plugins import DynamicPlugin

        t = self.traffic
        self.window_k = int(t["window"])
        self.cluster = cl.build_cluster(self.config, self.inputs)
        clock = lambda: self.now  # noqa: E731
        self.sched = Scheduler(self.cluster, clock=clock, device=self.device)
        pol = cl.policy(self.config)
        for name, weight in self.config["plugins"]:
            if name == "NodeResourcesFit":
                self.sched.register(ResourceFitPlugin(FitTracker(self.cluster)), weight=weight)
            elif name == "Dynamic":
                self.sched.register(DynamicPlugin(pol, clock=clock), weight=weight)
                self.dyn_weight = int(weight)
            else:
                raise ValueError(f"unknown plugin {name}")
        # a fixed backlog, whatever the window's length: the heap the
        # window works over is the same in every run
        count = int(t["backlog_pods"]) + self.window_k * (int(t["warm_windows"])
                                                          + profile_calls)
        reqs, self.vecs = tr.drip_requests(t, self.seed, count)
        containers = {}
        pods = []
        for k, req in enumerate(reqs):
            key = tuple(sorted(req.items()))
            c = containers.get(key)
            if c is None:
                c = containers[key] = (Container("c", ResourceRequirements(requests=dict(req))),)
            pods.append(Pod(name=f"drip-{k:07d}", containers=c))
        # the first window warms the window on pods that fit nowhere
        infeasible = (Container("c", ResourceRequirements(requests=dict(t["warm_infeasible"]))),)
        self.pods = [Pod(name=f"warm-{k:04d}", containers=infeasible)
                     for k in range(self.window_k)] + pods
        self.vecs = np.concatenate([np.tile(cl.request_vec(t["warm_infeasible"]),
                                            (self.window_k, 1)), self.vecs])
        self.cluster.add_pods(self.pods)
        # where the measured window stops: the profiled windows' pods follow
        self.backlog_end = self.window_k * (1 + int(t["warm_windows"])) + int(t["backlog_pods"])
        self.stop = self.backlog_end
        # each backlog pod's node (None: not placed), in order; the results
        # are dropped at once, as a serving loop would, but for the last
        self.results = []
        self.last = None
        self.window_from = self.window_to = 0
        self.next = 0

    def step(self) -> bool:
        if self.next >= self.stop:
            return False
        chunk = self.pods[self.next:min(self.next + self.window_k, self.stop)]
        self.next += len(chunk)
        out = self.sched.schedule_queue(chunk, window=self.window_k)
        self.results.extend(r.node for r in out)
        self.last = out[-1]
        return True

    def warm(self) -> None:
        for _ in range(1 + int(self.traffic["warm_windows"])):
            self.step()
        sync(self.device)

    def window(self, seconds: float) -> None:
        self.window_from = len(self.results)
        # the scheduler's counters are read outside the measured window
        before = self.sched.drip_stats()["batch"]
        self.timed_loop(seconds, self.step)
        after = self.sched.drip_stats()["batch"]
        self.window_to = len(self.results)
        self.batch = {k: after[k] - before[k] for k in self.COUNTERS}
        self.batch["stage_seconds"] = {k: after["stage_seconds"][k] - before["stage_seconds"][k]
                                       for k in after["stage_seconds"]}
        if self.next >= self.backlog_end:
            print(f"portbench: the backlog ran out after {self.wall_s:.3f} s; the window "
                  "ended early", flush=True, file=sys.stderr)
        self.stop = len(self.pods)  # the profiled stretch takes the pods set apart

    def end_to_end(self) -> dict:
        win = self.results[self.window_from:self.window_to]
        bound = sum(node is not None for node in win)
        self.attempted, self.failed = len(win), len(win) - bound
        return {"drip_pods_per_s": bound / self.wall_s}

    def reference(self, control=None) -> dict:
        i = self.inputs
        sched, score = ref_dyn.filter_score(
            self.config["policy"]["spec"], i["metrics"], i["values"], i["ts"], i["hot"],
            i["hot_ts"], self.now, dtype=np.float32 if control == "float32" else np.float64)
        vecs = self.vecs[:len(self.results)]
        nodes, free = ref_place.drip(sched, score, self.dyn_weight, i["free"], i["bounded"],
                                     vecs, fold=control != "no_fold", window=self.window_k)
        # the last pod's feasible nodes and weighted scores, over the free
        # state after every bind of the run
        fits = ref_place.copies_that_fit(free, i["bounded"], vecs[-1]) > 0
        feasible = np.flatnonzero(sched & fits)
        return {"placed": nodes,
                "scores": dict(zip(feasible.tolist(),
                                   (score[feasible] * self.dyn_weight).tolist())),
                "counts": np.bincount(nodes[nodes >= 0], minlength=i["n"])}

    def port(self) -> dict:
        """What the timed path produced: each pod's node, the last result's
        scores (``ScheduleResult.scores``: weighted score of every feasible
        node) and the cluster's bound-pod counts."""
        pos = {n: k for k, n in enumerate(self.inputs["names"])}
        nodes = np.fromiter((pos[n] if n is not None else -1 for n in self.results),
                            dtype=np.int64, count=len(self.results))
        scores = self.last.scores if self.last is not None else {}
        return {"placed": nodes,
                "scores": {pos[n]: int(s) for n, s in scores.items()},
                "counts": np.asarray(self.cluster.bound_counts_for(self.inputs["names"]),
                                     np.int64)}

    @staticmethod
    def compare(got: dict, want: dict) -> dict:
        g, w = got["scores"], want["scores"]
        return {
            "placement_mismatch": int((got["placed"] != want["placed"]).sum()),
            # a node feasible on one side only, or scored differently
            "score_mismatch": len(g.keys() ^ w.keys())
            + sum(g[k] != w[k] for k in g.keys() & w.keys()),
            "count_mismatch": int((got["counts"] != want["counts"]).sum()),
        }

    def observations(self) -> dict:
        """The shapes, and the measured window's deltas of the scheduler's
        batch counters and stage seconds (``drip_stats()["batch"]``)."""
        return {"n": self.inputs["n"], "window_k": self.window_k, "batch": self.batch}
