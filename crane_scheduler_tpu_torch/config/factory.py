"""Scheduler assembly from configuration.

Counterpart of ``crane_scheduler_tpu/config/factory.py``, the equivalent of
``cmd/scheduler/main.go:20-23``: the stock scheduler with the crane plugins
registered — here a ``Scheduler`` built from a decoded
``SchedulerConfiguration``, with ``ResourceFitPlugin`` always on and
``DynamicPlugin`` and ``TopologyMatch`` (``NodeResourceTopologyMatch``)
at their configured score weights. With ``TopologyMatch`` registered the
per-pod ``Scheduler`` takes its scalar plugin loop: the columnar path
recognizes only ``DynamicPlugin`` plus one ``ResourceFitPlugin``, as in
the reference.
"""

from __future__ import annotations

import time

from ..cluster.state import ClusterState
from ..fit import FitTracker, ResourceFitPlugin
from ..framework.scheduler import Scheduler
from ..plugins.dynamic import DynamicPlugin
from ..policy.v1alpha1 import load_policy_from_file
from ..topology.plugin import TopologyMatch
from .types import DynamicArgs, NodeResourceTopologyMatchArgs, SchedulerConfiguration


def build_scheduler_from_config(
    cluster: ClusterState,
    config: SchedulerConfiguration,
    nrt_lister=None,
    clock=None,
    policy=None,
    tie_break_seed=None,
    device=None,
    mesh=None,
) -> Scheduler:
    """Build a Scheduler for the first profile.

    ``policy`` overrides reading DynamicArgs.policy_config_path from disk;
    ``nrt_lister`` (an ``NRTLister``, e.g. ``InMemoryNRTLister``) is
    required when the NRT plugin is enabled;
    ``tie_break_seed`` opts into the stock framework's random-among-ties
    host selection (seeded; default off = lowest snapshot index);
    ``device`` is where the batched drip window runs (``None`` means the
    GPU and raises without one; ``"cpu"`` for the CPU); ``mesh`` tiles that
    window over a placement mesh (``parallel.mesh.make_placement_mesh``)."""
    if not config.profiles:
        raise ValueError("scheduler configuration has no profiles")
    profile = config.profiles[0]
    weights = {pw.name: pw.weight for pw in profile.score_enabled}
    enabled = set(profile.filter_enabled) | set(weights)
    sched = Scheduler(cluster, clock=clock or time.time, tie_break_seed=tie_break_seed,
                      device=device, mesh=mesh)

    # allocatable-fit predicate: always on, like the stock scheduler's
    # default-enabled NodeResourcesFit. Fails open on nodes that never
    # reported status.allocatable.
    sched.register(ResourceFitPlugin(FitTracker(cluster)))

    if "Dynamic" in enabled:
        args = profile.plugin_config.get("Dynamic", DynamicArgs())
        if policy is None:
            policy = load_policy_from_file(args.policy_config_path)
        plugin = DynamicPlugin(policy, clock=clock or time.time)
        sched.register(plugin, weight=weights.get("Dynamic", 1))

    if "NodeResourceTopologyMatch" in enabled:
        if nrt_lister is None:
            raise ValueError("NodeResourceTopologyMatch enabled but no NRT lister")
        args = profile.plugin_config.get(
            "NodeResourceTopologyMatch", NodeResourceTopologyMatchArgs()
        )
        plugin = TopologyMatch(
            nrt_lister,
            cluster=cluster,
            topology_aware_resources=frozenset(args.topology_aware_resources),
        )
        # the reference starts the assumed-pod cleaner with the cache
        # (ref: cache.go:111-117); callers stop it with
        # ``plugin.cache.stop_cleaner()``
        plugin.cache.start_cleaner()
        sched.register(plugin, weight=weights.get("NodeResourceTopologyMatch", 1))
    return sched
