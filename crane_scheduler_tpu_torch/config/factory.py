"""Scheduler assembly from configuration.

Counterpart of ``crane_scheduler_tpu/config/factory.py``, the equivalent of
``cmd/scheduler/main.go:20-23``: the stock scheduler with the crane plugins
registered — here a ``Scheduler`` built from a decoded
``SchedulerConfiguration``, with ``ResourceFitPlugin`` always on and
``DynamicPlugin`` at its configured score weight. The NUMA plugin
(``NodeResourceTopologyMatch``) is not ported yet and raises.
"""

from __future__ import annotations

import time

from ..cluster.state import ClusterState
from ..fit import FitTracker, ResourceFitPlugin
from ..framework.scheduler import Scheduler
from ..plugins.dynamic import DynamicPlugin
from ..policy.v1alpha1 import load_policy_from_file
from .types import DynamicArgs, SchedulerConfiguration


def build_scheduler_from_config(
    cluster: ClusterState,
    config: SchedulerConfiguration,
    clock=None,
    policy=None,
    tie_break_seed=None,
    device=None,
) -> Scheduler:
    """Build a Scheduler for the first profile.

    ``policy`` overrides reading DynamicArgs.policy_config_path from disk;
    ``tie_break_seed`` opts into the stock framework's random-among-ties
    host selection (seeded; default off = lowest snapshot index);
    ``device`` is where the batched drip window runs (``None`` means the
    GPU and raises without one; ``"cpu"`` for the CPU)."""
    if not config.profiles:
        raise ValueError("scheduler configuration has no profiles")
    profile = config.profiles[0]
    weights = {pw.name: pw.weight for pw in profile.score_enabled}
    enabled = set(profile.filter_enabled) | set(weights)
    if "NodeResourceTopologyMatch" in enabled:
        raise NotImplementedError(
            "NodeResourceTopologyMatch is not ported yet (ROADMAP Queue 1 "
            "item 5, NUMA); disable it in the profile"
        )
    sched = Scheduler(cluster, clock=clock or time.time, tie_break_seed=tie_break_seed,
                      device=device)

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
    return sched
