"""Sustained-hotspot detection and gated eviction.

Copy of ``crane_scheduler_tpu/descheduler/descheduler.py``.

The cycle: read every node's load annotations with the parity oracle's
exact staleness/fail-open semantics (scorer.oracle — stale or
malformed reads never mark a node hot), require ``consecutive_syncs``
over-threshold observations before a node becomes actionable, then
evict at most a budgeted handful of pods whose removal provably helps:
every victim passes the safety gates (daemonset / protected namespace /
opt-out annotation / budgets / per-node cooldown) AND a fit-guard check
that it lands on some non-hot, below-target node with free allocatable.

Evictions go through ``cluster.evict_pod`` — on a kube mirror that is
the eviction-subresource POST through the pipelined write path, which
never blindly re-drives a non-idempotent POST (the indeterminate-
response discipline): a lost response surfaces as a failed eviction
here rather than a duplicate one at the apiserver. The port has the
in-memory mirror's ``ClusterState.evict_pod``, and the kube mirror's
``KubeClusterClient.evict_pod`` with that POST discipline; the descheduler
runs on the kube mirror with ``ROADMAP.md`` Queue 1 item 8.2b.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..scorer import oracle
from ..telemetry import Telemetry, maybe_span
from ..telemetry import active as active_telemetry
from ..utils.logging import vlog
from .config import DeschedulerConfig

_SKIP_REASONS = (
    "daemonset",
    "protected_namespace",
    "opt_out",
    "cooldown",
    "node_budget",
    "cycle_budget",
    "no_fit",
    "evict_failed",
    "degraded_suspended",
)


@dataclass(frozen=True)
class Eviction:
    pod_key: str
    node: str
    reason: str  # the watermark metric that triggered the hotspot


@dataclass
class CycleReport:
    now: float
    # node -> (streak, worst failing metric) for nodes over threshold
    hot: dict[str, tuple[int, str]] = field(default_factory=dict)
    # nodes whose streak reached consecutive_syncs this cycle
    actionable: list[str] = field(default_factory=list)
    evicted: list[Eviction] = field(default_factory=list)
    # dry-run: what WOULD have been evicted
    planned: list[Eviction] = field(default_factory=list)
    skipped: dict[str, int] = field(default_factory=dict)
    dry_run: bool = False
    # cluster-wide degraded mode: the whole cycle was suspended because
    # most load annotations are stale (evicting on them is unsafe)
    suspended: bool = False


class LoadAwareDescheduler:
    """One instance per control loop (leader-elected in the CLI).

    ``cluster`` is anything with the ClusterState read surface plus
    ``evict_pod`` — the in-memory mirror and ``KubeClusterClient``
    both qualify. ``fit_tracker`` defaults to a fresh tracker over the
    same cluster; pass the scheduler's to share accounting.
    """

    def __init__(
        self,
        cluster,
        policy,
        config: DeschedulerConfig | None = None,
        fit_tracker=None,
        clock=time.time,
        telemetry: Telemetry | None = None,
        degraded=None,
    ):
        self.cluster = cluster
        self.policy = policy
        self.degraded = degraded  # DegradedModeController | None
        self.config = config if config is not None else DeschedulerConfig()
        if fit_tracker is None:
            from ..fit import FitTracker

            fit_tracker = FitTracker(cluster, telemetry=telemetry)
        self.fit = fit_tracker
        self._clock = clock
        self._streak: dict[str, int] = {}
        self._last_evict: dict[str, float] = {}
        self.cycles = 0
        self.evictions = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._telemetry = (
            telemetry if telemetry is not None else active_telemetry()
        )
        self._m_evictions = None
        if self._telemetry is not None:
            reg = self._telemetry.registry
            self._m_evictions = reg.counter(
                "crane_desched_evictions_total",
                "Pods evicted (or planned, in dry-run) by trigger metric.",
                ("reason",),
            )
            self._m_hotspots = reg.gauge(
                "crane_desched_hotspot_nodes",
                "Nodes whose hotspot streak reached consecutive_syncs.",
            )
            self._m_skips = reg.counter(
                "crane_desched_skips_total",
                "Eviction candidates rejected by a safety gate.",
                ("reason",),
            )
            self._m_cycle = reg.histogram(
                "crane_desched_cycle_seconds",
                "Wall-clock seconds per descheduler sync cycle.",
            )

    # -- hotspot detection -------------------------------------------------

    def _node_usage(self, anno: dict, name: str, now: float):
        """Annotation read with the oracle's exact semantics: None on
        any fail-open condition (missing, malformed, stale)."""
        active = oracle.get_active_duration(self.policy.spec.sync_period, name)
        if active == 0:
            return None
        try:
            return oracle.get_resource_usage(anno, name, active, now)
        except oracle.UsageError:
            return None

    def _classify(self, node, now: float):
        """(is_hot, worst_metric, below_target) for one node. Fail-open
        on every unreadable metric: it neither marks hot nor blocks the
        below-target landing check."""
        anno = dict(node.annotations or {})
        worst = ""
        worst_excess = 0.0
        below_target = True
        for wm in self.config.watermarks:
            usage = self._node_usage(anno, wm.name, now)
            if usage is None:
                continue
            if wm.threshold > 0 and usage > wm.threshold:
                excess = usage - wm.threshold
                if excess > worst_excess or not worst:
                    worst = wm.name
                    worst_excess = excess
            if usage > wm.target:
                below_target = False
        return bool(worst), worst, below_target

    # -- victim gates ------------------------------------------------------

    def _pod_evictable(self, pod, skipped) -> bool:
        if pod.is_daemonset_pod():
            self._skip(skipped, "daemonset")
            return False
        if pod.namespace in self.config.protected_namespaces:
            self._skip(skipped, "protected_namespace")
            return False
        anno = pod.annotations or {}
        if anno.get(self.config.evict_annotation) == "false":
            self._skip(skipped, "opt_out")
            return False
        return True

    def _skip(self, skipped: dict, reason: str) -> None:
        skipped[reason] = skipped.get(reason, 0) + 1
        if self._telemetry is not None:
            self._m_skips.labels(reason=reason).inc()

    # -- the cycle ---------------------------------------------------------

    def sync_once(self, now: float | None = None) -> CycleReport:
        if now is None:
            now = self._clock()
        t0 = time.perf_counter()
        with maybe_span(self._telemetry, "desched_cycle"):
            report = self._sync_once(now)
        if self._telemetry is not None:
            self._m_cycle.observe(time.perf_counter() - t0)
        self.cycles += 1
        return report

    def _sync_once(self, now: float) -> CycleReport:
        cfg = self.config
        report = CycleReport(now=now, dry_run=cfg.dry_run)
        nodes = self.cluster.list_nodes()
        if self.degraded is not None:
            # hard interlock: evicting on stale load data is the one
            # unsafe action in the system — suspend the whole cycle
            # while the cluster-wide staleness tracker says degraded
            self.degraded.update(
                (dict(n.annotations or {}) for n in nodes), now
            )
            if self.degraded.active:
                report.suspended = True
                self._skip(report.skipped, "degraded_suspended")
                return report
        live = {n.name for n in nodes}
        for gone in set(self._streak) - live:
            del self._streak[gone]

        hot_now: dict[str, str] = {}
        landing: list[str] = []  # non-hot, below-target candidate targets
        for node in nodes:
            is_hot, metric, below_target = self._classify(node, now)
            if is_hot:
                streak = self._streak.get(node.name, 0) + 1
                self._streak[node.name] = streak
                hot_now[node.name] = metric
                report.hot[node.name] = (streak, metric)
            else:
                self._streak[node.name] = 0
                if below_target:
                    landing.append(node.name)

        actionable = [
            name
            for name, metric in hot_now.items()
            if self._streak[name] >= cfg.consecutive_syncs
        ]
        # hottest-streak first, name as the deterministic tie-break
        actionable.sort(key=lambda n: (-self._streak[n], n))
        report.actionable = actionable
        if self._telemetry is not None:
            self._m_hotspots.set(len(actionable))
        if not actionable:
            return report

        self.fit.refresh()
        from ..fit import pod_fit_request

        cycle_budget = cfg.max_evictions_per_cycle
        for node_name in actionable:
            if cycle_budget <= 0:
                self._skip(report.skipped, "cycle_budget")
                break
            last = self._last_evict.get(node_name)
            if last is not None and now - last < cfg.node_cooldown_seconds:
                self._skip(report.skipped, "cooldown")
                continue
            node_budget = cfg.max_evictions_per_node
            pods = self.cluster.list_pods(node_name)
            # move the largest contributor first; key breaks ties so a
            # re-run of the same state picks the same victims
            pods.sort(
                key=lambda p: (-pod_fit_request(p).milli_cpu, p.key())
            )
            for pod in pods:
                if node_budget <= 0:
                    self._skip(report.skipped, "node_budget")
                    break
                if cycle_budget <= 0:
                    self._skip(report.skipped, "cycle_budget")
                    break
                if not self._pod_evictable(pod, report.skipped):
                    continue
                request = pod_fit_request(pod)
                # one vectorized verdict over the landing set (the same
                # free columns the drip path caches) instead of a
                # per-target fits() walk per victim
                if not self.fit.fits_mask(landing, request).any():
                    self._skip(report.skipped, "no_fit")
                    continue
                ev = Eviction(pod.key(), node_name, hot_now[node_name])
                if cfg.dry_run:
                    report.planned.append(ev)
                    node_budget -= 1
                    cycle_budget -= 1
                    if self._m_evictions is not None:
                        self._m_evictions.labels(reason=ev.reason).inc()
                    continue
                if not self.cluster.evict_pod(pod.key(), now=now):
                    # non-idempotent POST discipline: an indeterminate
                    # or failed eviction is NEVER re-driven this cycle
                    self._skip(report.skipped, "evict_failed")
                    continue
                report.evicted.append(ev)
                lc = getattr(self._telemetry, "lifecycle", None)
                if lc is not None:
                    # finalize this placement attempt as evicted; a
                    # re-placement of the same key continues the trace
                    lc.evicted(pod.key(), reason=ev.reason)
                self.evictions += 1
                node_budget -= 1
                cycle_budget -= 1
                self._last_evict[node_name] = now
                if self._m_evictions is not None:
                    self._m_evictions.labels(reason=ev.reason).inc()
                vlog(2, f"desched: evicted {ev.pod_key} from "
                        f"{node_name} ({ev.reason})")
        return report

    def rearm_cooldown(self, node_name: str, now: float | None = None) -> None:
        """Restart-reconciliation hook: an eviction intent left
        unresolved by a crash (pod still present) re-arms the node's
        cooldown — the next sweep re-evaluates the node from scratch
        instead of racing a possibly-in-flight eviction POST with a
        second one."""
        self._last_evict[node_name] = self._clock() if now is None else now

    # -- control loop ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.sync_once()
                except Exception as exc:  # keep the loop alive
                    vlog(1, f"desched: cycle error: {exc!r}")
                self._stop.wait(self.config.sync_period_seconds)

        self._thread = threading.Thread(
            target=loop, name="crane-descheduler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def stats(self) -> dict:
        return {
            "cycles": self.cycles,
            "evictions": self.evictions,
            "hot_streaks": {k: v for k, v in self._streak.items() if v > 0},
        }
