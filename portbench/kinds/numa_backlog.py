"""``Scheduler.schedule_queue(window=W)`` over a closed backlog of
Guaranteed pods with ``NodeResourceTopologyMatch`` registered beside
Dynamic and NodeResourcesFit: the drip backlog (``drip_backlog``) on
nodes with NUMA zones, each pod's whole CPU pinned, a share of the pods
annotated topology-aware.

Set-up adds each node's NodeResourceTopology CR (the configuration's
``numa``) and the plugin, and sends one pod that fits nowhere through
``schedule_queue``: a port that does not take the batched window with the
plugin registered (it has no ``drip_zone`` stage, or the window did not
run) fails there, in seconds, instead of placing the backlog one pod at a
time over every node in Python.

Compared with the plain reference (``reference/numa.py``): each pod's
node, the last result's scores, the bound pods per node, and each bound
pod's topology result (its zones and their CPU)."""

from __future__ import annotations

import json

import numpy as np

from .. import cluster as cl
from .. import traffic as tr
from ..reference import dynamic as ref_dyn
from ..reference import numa as ref_numa
from .drip_backlog import Driver as Drip

RESULT = "topology.crane.io/topology-result"
AWARE = "topology.crane.io/topology-awareness"


class Driver(Drip):
    checks = Drip.checks + ("zone_mismatch",)
    # ``float32``: the Dynamic scores a precision below the plugin's
    # float64; ``no_fold``: a window whose pods all see the free rows and
    # zones at its start; ``no_zone_fold``: a window whose pods see the
    # zones at its start, the free rows folded
    controls = ("float32", "no_fold", "no_zone_fold")
    breaks = "no_zone_fold"
    COUNTERS = Drip.COUNTERS + ("zone_windows", "zone_results", "cross_zone_binds")

    def setup(self, profile_calls: int) -> None:
        from crane_scheduler_tpu_torch.cluster import Container, Pod, ResourceRequirements
        from crane_scheduler_tpu_torch.fit import FitTracker, ResourceFitPlugin
        from crane_scheduler_tpu_torch.framework.scheduler import Scheduler
        from crane_scheduler_tpu_torch.plugins import DynamicPlugin
        from crane_scheduler_tpu_torch.topology import TopologyMatch

        t = self.traffic
        self.window_k = int(t["window"])
        self.cluster = cl.build_cluster(self.config, self.inputs)
        clock = lambda: self.now  # noqa: E731
        self.sched = Scheduler(self.cluster, clock=clock, device=self.device)
        numa = self.config["numa"]
        self.zone_names = [zone["name"] for zone in numa["zones"]]
        self.zone_alloc = [cl.quantity(zone["cpu"], milli=True) for zone in numa["zones"]]
        pol = cl.policy(self.config)
        for name, weight in self.config["plugins"]:
            if name == "NodeResourcesFit":
                self.sched.register(ResourceFitPlugin(FitTracker(self.cluster)), weight=weight)
            elif name == "Dynamic":
                self.sched.register(DynamicPlugin(pol, clock=clock), weight=weight)
                self.dyn_weight = int(weight)
            elif name == "NodeResourceTopologyMatch":
                self.topo = TopologyMatch(self._lister(numa), cluster=self.cluster)
                self.sched.register(self.topo, weight=weight)
                self.nrt_weight = int(weight)
            else:
                raise ValueError(f"unknown plugin {name}")
        self._probe(Pod, Container, ResourceRequirements)
        count = int(t["backlog_pods"]) + self.window_k * (int(t["warm_windows"])
                                                          + profile_calls)
        reqs, vecs = tr.drip_requests(t, self.seed, count)
        aware = cl.rng_for(self.seed, 3).random(count) < float(t["aware_share"])
        containers = {}
        pods = []
        for k, req in enumerate(reqs):
            key = tuple(sorted(req.items()))
            c = containers.get(key)
            if c is None:
                c = containers[key] = (Container("c", ResourceRequirements(
                    requests=dict(req), limits=dict(req))),)
            pods.append(Pod(name=f"numa-{k:07d}", containers=c,
                            annotations={AWARE: "true"} if aware[k] else {}))
        warm = t["warm_infeasible"]
        infeasible = (Container("c", ResourceRequirements(requests=dict(warm),
                                                          limits=dict(warm))),)
        self.pods = [Pod(name=f"warm-{k:04d}", containers=infeasible)
                     for k in range(self.window_k)] + pods
        self.vecs = np.concatenate([np.tile(cl.request_vec(warm), (self.window_k, 1)), vecs])
        self.aware = np.concatenate([np.zeros(self.window_k, bool), aware])
        self.cluster.add_pods(self.pods)
        self.backlog_end = self.window_k * (1 + int(t["warm_windows"])) + int(t["backlog_pods"])
        self.stop = self.backlog_end
        self.results = []
        self.last = None
        self.window_from = self.window_to = 0
        self.next = 0

    def _lister(self, numa: dict):
        from crane_scheduler_tpu_torch.topology.types import (
            CraneManagerPolicy,
            InMemoryNRTLister,
            NodeResourceTopology,
            Zone,
            ZoneResourceInfo,
        )

        zones = tuple(Zone(name=zone["name"], resources=ZoneResourceInfo(
            allocatable={"cpu": zone["cpu"], "memory": zone["memory"]}))
            for zone in numa["zones"])
        policy = CraneManagerPolicy(numa["cpu_manager_policy"], numa["topology_manager_policy"])
        lister = InMemoryNRTLister()
        for name in self.inputs["names"]:
            lister.upsert(NodeResourceTopology(name=name, crane_manager_policy=policy,
                                               zones=zones))
        return lister

    def _probe(self, Pod, Container, ResourceRequirements) -> None:
        """One pod that fits nowhere through ``schedule_queue``: the port
        must run it as an NRT window (``drip_zone`` stage, a zone window
        counted), else the cell cannot run."""
        warm = self.traffic["warm_infeasible"]
        probe = Pod(name="probe", containers=(Container("c", ResourceRequirements(
            requests=dict(warm), limits=dict(warm))),))
        out = self.sched.schedule_queue([probe], window=self.window_k)
        batch = self.sched.drip_stats()["batch"]
        if (out[0].node is not None or "drip_zone" not in batch["stage_seconds"]
                or batch.get("zone_windows") != 1):
            raise RuntimeError("the port does not run the drip window with "
                               "NodeResourceTopologyMatch registered; this cell needs it")

    def reference(self, control=None) -> dict:
        i = self.inputs
        sched, score = ref_dyn.filter_score(
            self.config["policy"]["spec"], i["metrics"], i["values"], i["ts"], i["hot"],
            i["hot_ts"], self.now, dtype=np.float32 if control == "float32" else np.float64)
        vecs = self.vecs[:len(self.results)]
        pods = list(zip(vecs, vecs[:, 0], self.aware[:len(self.results)]))
        nodes, takes, counts, scores = ref_numa.drip(
            sched, score * self.dyn_weight, self.nrt_weight, i["free"][0], self.zone_alloc,
            pods, window=self.window_k, fold_free=control != "no_fold",
            fold_zones=control not in ("no_fold", "no_zone_fold"))
        return {"placed": nodes, "scores": scores, "counts": counts, "takes": takes}

    def port(self) -> dict:
        """``drip_backlog``'s, and each placed pod's topology result as
        milli-CPU per zone in the CR's order."""
        out = super().port()
        index = {name: j for j, name in enumerate(self.zone_names)}
        parsed: dict = {}
        takes = np.zeros((len(self.results), len(self.zone_names)), np.int64)
        get_pod = self.cluster.get_pod
        for p, node in enumerate(self.results):
            if node is None:
                continue
            raw = get_pod(self.pods[p].key()).annotations.get(RESULT)
            row = parsed.get(raw)
            if row is None:
                row = np.zeros(len(self.zone_names), np.int64)
                for zone in json.loads(raw) if raw else ():
                    cpu = zone.get("resources", {}).get("capacity", {}).get("cpu", "0")
                    row[index[zone["name"]]] += cl.quantity(cpu, milli=True)
                parsed[raw] = row
            takes[p] = row
        out["takes"] = takes
        return out

    def observations(self) -> dict:
        """``drip_backlog``'s, and the zones per node."""
        return dict(super().observations(), zones=len(self.zone_names))

    @staticmethod
    def compare(got: dict, want: dict) -> dict:
        return dict(Drip.compare(got, want),
                    zone_mismatch=int((got["takes"] != want["takes"]).any(axis=1).sum()))
