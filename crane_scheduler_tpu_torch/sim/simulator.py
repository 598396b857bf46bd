"""Cluster simulator: the test/benchmark harness the reference lacks.

Copy of ``crane_scheduler_tpu/sim/simulator.py``. ``build_scheduler`` and
``build_batch_scheduler`` take ``device=`` (``None`` means the GPU and
raises without one); ``build_batch_scheduler(mesh=)`` tiles the step over
a node mesh. A metric column renders in one host-library
call (``native.codec.bulk_render_f5``) and is served in the aligned
three-column form ``(hosts, strings, floats)``, as in the reference. The
base loads come from ``random.Random(seed)`` in node order, exactly as in
the reference.

SURVEY §4: the reference has no integration tests and no benchmarks — its
only documented e2e check is manually scheduling a cpu-stress deployment.
This simulator closes that gap: N synthetic nodes with per-metric load
streams, a pod arrival process, the real annotator syncing real
annotations through the real metrics interface, the real scheduler
binding pods, and binding feedback looping into both node load and hot
values — all on a virtual clock for determinism.

Load model: each node's utilization for a metric is
``base + per_pod_load * bound_pods``, clipped to [0, 1] — binding pods to
a node pushes its future metrics up, which the annotator's next sync
turns into lower scores (the closed loop from SURVEY §3.4).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from ..annotator.controller import AnnotatorConfig, NodeAnnotator
from ..cluster.state import ClusterState, Container, Node, NodeAddress, Pod, ResourceRequirements
from ..framework.scheduler import BatchScheduler, Scheduler
from ..metrics.fake import FakeMetricsSource
from ..plugins.dynamic import DynamicPlugin
from ..policy.types import DEFAULT_POLICY, DynamicSchedulerPolicy


class SimClock:
    """Virtual wall clock (epoch seconds)."""

    def __init__(self, start: float = 1_753_776_000.0):
        self._now = start

    def now(self) -> float:
        return self._now

    def advance(self, seconds: float) -> float:
        self._now += seconds
        return self._now

    def __call__(self) -> float:
        return self.now()


@dataclass
class SimConfig:
    n_nodes: int = 16
    seed: int = 0
    base_load_range: tuple = (0.05, 0.6)
    per_pod_load: float = 0.02
    cpu_mem_correlation: float = 0.7


@dataclass
class SimStats:
    scheduled: int = 0
    unschedulable: int = 0
    placements: dict = field(default_factory=dict)  # node -> count


class Simulator:
    def __init__(
        self,
        config: SimConfig = SimConfig(),
        policy: DynamicSchedulerPolicy = DEFAULT_POLICY,
        clock: SimClock | None = None,
    ):
        self.config = config
        self.policy = policy
        self.clock = clock or SimClock()
        self.rng = random.Random(config.seed)
        self.cluster = ClusterState()
        self.metrics = FakeMetricsSource()
        self.stats = SimStats()
        self._base: dict[tuple[str, str], float] = {}
        self._pod_seq = 0
        # (bound_version, counts) — a metric sweep reads bound-pod counts
        # for |nodes| x |metrics| streams; one count_pods_all per bound-pod
        # generation replaces that many per-node lock hits. The reference
        # keys these caches on sched_version, which each annotation patch
        # of a per-node sweep moves, so its sweep recounts every node's
        # pods once per (node, metric): O(nodes x nodes with pods). The
        # counts are the same either way.
        self._counts_cache: tuple[int, dict[str, int]] | None = None
        self._counts_vec_cache: tuple | None = None

        metric_names = {sp.name for sp in policy.spec.sync_period}
        self._pairs: list[tuple[str, str]] = []  # (name, ip), node order
        for i in range(config.n_nodes):
            name = f"node-{i:05d}"
            ip = f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}"
            self.cluster.add_node(
                Node(name=name, addresses=(NodeAddress("InternalIP", ip),))
            )
            self._pairs.append((name, ip))
            cpu_base = self.rng.uniform(*config.base_load_range)
            corr = config.cpu_mem_correlation
            mem_base = max(
                0.0,
                min(1.0, corr * cpu_base + (1 - corr) * self.rng.uniform(*config.base_load_range)),
            )
            for m in metric_names:
                base = cpu_base if m.startswith("cpu") else mem_base
                self._base[(name, m)] = base
                self.metrics.set(m, ip, self._stream(name, m), by="ip")
        self._ips = [ip for _, ip in self._pairs]
        self._names = [name for name, _ in self._pairs]
        for m in metric_names:
            # bulk sweeps read the whole column in one call instead of
            # |nodes| per-instance closures
            self.metrics.set_column(m, self._column(m))

        self.annotator = NodeAnnotator(
            self.cluster, self.metrics, policy, AnnotatorConfig()
        )
        self.annotator.event_ingestor.start()

    # -- load streams ------------------------------------------------------

    def _bound_counts(self) -> dict[str, int]:
        version = self.cluster.bound_version
        cache = self._counts_cache
        if cache is None or cache[0] != version:
            cache = (version, self.cluster.count_pods_all())
            self._counts_cache = cache
        return cache[1]

    def _stream(self, node_name: str, metric: str):
        base = self._base  # bind once; read per call for live updates
        per_pod = self.config.per_pod_load

        def current() -> float:
            bound = self._bound_counts().get(node_name, 0)
            load = base[(node_name, metric)] + per_pod * bound
            return max(0.0, min(1.0, load))

        return current

    def _counts_vector(self):
        """Bound-pod counts aligned with ``self._pairs`` (cached on the
        cluster's bound-pod generation alongside ``_bound_counts``)."""
        import numpy as np

        version = self.cluster.bound_version
        cache = self._counts_vec_cache
        if cache is None or cache[0] != version:
            bc_for = getattr(self.cluster, "bound_counts_for", None)
            if bc_for is not None:
                # vectorized: one gather through the cluster's slot
                # array (self._names is the stable key object)
                vec = bc_for(self._names).astype(np.float64)
            else:
                counts = self._bound_counts()
                get = counts.get
                vec = np.fromiter(
                    (get(name, 0) for name, _ in self._pairs),
                    dtype=np.float64,
                    count=len(self._pairs),
                )
            cache = (version, vec)
            self._counts_vec_cache = cache
        return cache[1]

    def _column(self, metric: str):
        """Whole-column load stream: numpy load model + one host-library
        render call (Prometheus contract: values clamp to [0, 1] like
        ``_render``/``_stream``, 5-decimal fixed rendering identical to
        ``format_metric_value``). Served in the aligned-columns form
        ``(hosts, strings, floats)``: no 50k-entry dict per metric, and
        ``floats`` is the Go parse of the rendered strings (NaN where
        unparseable), so a direct-store consumer writes exactly what a
        re-parse of the strings would give."""
        import numpy as np

        from ..native.codec import bulk_render_f5

        base_vec = np.asarray(
            [self._base[(name, metric)] for name, _ in self._pairs]
        )

        def column():
            loads = base_vec + self.config.per_pod_load * self._counts_vector()
            np.clip(loads, 0.0, 1.0, out=loads)
            rendered, parsed, ok = bulk_render_f5(loads, with_parse=True)
            return (self._ips, rendered, np.where(ok, parsed, np.nan))

        return column

    # -- drivers -----------------------------------------------------------

    def sync_metrics(self) -> None:
        """One full annotator pass at the current virtual time."""
        self.annotator.sync_all_once(self.clock.now())

    def make_pod(self, cpu_milli: int = 100, mem: int = 128 << 20) -> Pod:
        self._pod_seq += 1
        pod = Pod(
            name=f"pod-{self._pod_seq:06d}",
            namespace="default",
            containers=(
                Container(
                    "main",
                    ResourceRequirements(
                        requests={"cpu": f"{cpu_milli}m", "memory": str(mem)},
                        limits={"cpu": f"{cpu_milli}m", "memory": str(mem)},
                    ),
                ),
            ),
        )
        self.cluster.add_pod(pod)
        return pod

    def build_scheduler(
        self, columnar: bool = True, device=None, **kwargs
    ) -> Scheduler:
        """``columnar=False`` pins the scalar plugin loop — the parity
        leg of the drip fuzz suite; extra kwargs (``tie_break_seed``,
        ``telemetry``) pass through to ``Scheduler``. ``device``: where
        the batched drip window runs (``None`` = the GPU)."""
        from ..fit import FitTracker, ResourceFitPlugin

        sched = Scheduler(
            self.cluster, clock=self.clock, columnar=columnar,
            device=device, **kwargs
        )
        # fit predicate first (cheap reject), then load-aware Dynamic —
        # sim nodes carry no allocatable unless a scenario sets it, so
        # the fit Filter fails open and existing runs are unchanged
        sched.register(ResourceFitPlugin(FitTracker(self.cluster)), weight=1)
        sched.register(DynamicPlugin(self.policy, clock=self.clock), weight=3)
        return sched

    def build_batch_scheduler(
        self, dtype=None, mesh=None, bucket=2048, device=None
    ) -> BatchScheduler:
        return BatchScheduler(
            self.cluster,
            self.policy,
            dtype=dtype,
            clock=self.clock,
            snapshot_bucket=bucket,
            device=device,
            mesh=mesh,
        )

    def record(self, node: str | None) -> None:
        if node is None:
            self.stats.unschedulable += 1
        else:
            self.stats.scheduled += 1
            self.stats.placements[node] = self.stats.placements.get(node, 0) + 1
