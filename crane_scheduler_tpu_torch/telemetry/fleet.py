"""Fleet observability plane: federation, SLOs, anomalies.

Copy of ``crane_scheduler_tpu/telemetry/fleet.py``.

The crane fleet is N cooperating processes (annotator, sharded
schedulers, scoring primary, serving replicas, router, descheduler)
that talk only through the apiserver — and, until this module, each
exposed an isolated ``/metrics``. Nobody could answer "is the *fleet*
meeting its placement SLO" without hand-stitching ten scrapes. Three
layers, one module:

- **MetricsFederator** — scrapes every fleet process's ``/metrics``
  with the strict expfmt parser, merges the families into one union
  under injected ``role``/``process`` labels, and re-exposes it on
  ``/fleet/metrics``. Merge semantics: counter-family samples (and
  histogram ``_bucket``/``_sum``/``_count``, which are counters too)
  are reset-adjusted via per-series monotonicity tracking, so a
  restarted replica never produces a negative rate downstream; gauges
  are last-scraped-wins; a family whose declared TYPE conflicts across
  processes is **quarantined** — removed from the union, counted in
  ``crane_fleet_quarantined_families`` and listed in ``status()``,
  never dropped silently.

- **SLOEngine** — multi-window burn rates (5m/1h fast, 6h/3d slow by
  default) over good/bad event counts derived from the federated
  families: placement e2e latency (the lifecycle histograms), serving
  goodput vs shed ratio, replication lag vs budget, shard conflict
  rate, and fleet scrape availability. Per-objective
  alert state machines (ok -> warning -> page, hysteresis on clear)
  exported as ``crane_slo_burn_rate{objective,window}``,
  ``crane_slo_budget_remaining{objective}`` and
  ``crane_slo_alert_state{objective}``, served as JSON at ``/v1/slo``.
  The engine is driven by an injected clock: seeded tests and bench
  config 20 tick it deterministically.

- **Anomaly detectors** — breaker flapping (transition rate over a
  sliding tick window), degraded-mode dwell (consecutive seconds with
  ``crane_degraded_mode`` raised anywhere in the fleet), and
  replication-lag trend (EWMA of the lag plus an EWMA'd slope over the
  injected clock). Exported as ``crane_fleet_anomaly{kind}`` and
  listed in the ``/v1/slo`` payload.

``FleetPlane`` bundles the three behind one ``tick()`` plus an
optional wall-clock pump thread, and is what ``service.http`` wires
behind ``/fleet/metrics`` and ``/v1/slo``. Stdlib-only, no sockets in
the core: the fetch function is injected (tests pass canned text, the
plane passes an HTTP fetcher).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from .expfmt import ExpositionError, parse_exposition
from .registry import MetricsRegistry, format_value

# ---------------------------------------------------------------------------
# process identity (satellite: crane_build_info)
# ---------------------------------------------------------------------------

_role_lock = threading.Lock()
_process_role = "unknown"


def set_process_role(role: str) -> None:
    """Record this process's fleet role (scorer, scheduler, annotator,
    descheduler, replica, router, sim...). Read back by the /debug
    envelopes and by ``register_build_info``."""
    global _process_role
    with _role_lock:
        _process_role = str(role)


def process_role() -> str:
    with _role_lock:
        return _process_role


def register_build_info(registry: MetricsRegistry, role: str,
                        version: str | None = None, *,
                        set_role: bool = True):
    """Register the ``crane_build_info{role,version}`` identity gauge
    every CLI entrypoint exports, so federated scrapes and crane-top
    can label processes without out-of-band config. Also records the
    role process-globally unless ``set_role=False`` (in-process
    replicas/routers riding inside another role's process). Returns the
    gauge child (value pinned 1)."""
    if version is None:
        from .. import __version__ as version
    if set_role:
        set_process_role(role)
    gauge = registry.gauge(
        "crane_build_info",
        "Process identity: constant 1, labeled with fleet role and "
        "build version",
        labelnames=("role", "version"),
    )
    child = gauge.labels(role=role, version=version)
    child.set(1)
    return child


# ---------------------------------------------------------------------------
# federation
# ---------------------------------------------------------------------------


@dataclass
class ScrapeTarget:
    """One fleet process's scrape endpoint. ``role=None`` means "learn
    it from the process's own crane_build_info gauge" (falling back to
    the target name)."""

    name: str
    host: str = "127.0.0.1"
    port: int = 0
    path: str = "/metrics"
    role: str | None = None
    # tests / in-process targets: fetch() -> exposition text overrides
    # the HTTP scrape entirely
    fetch: object | None = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}{self.path}"


# labels the federator owns on every sample it re-exposes
_META_LABELS = ("role", "process")


def _http_fetch(target: ScrapeTarget, timeout_s: float) -> str:
    from http.client import HTTPConnection

    conn = HTTPConnection(target.host, target.port, timeout=timeout_s)
    try:
        conn.request(
            "GET", target.path,
            headers={"Accept": "text/plain;version=0.0.4"},
        )
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise OSError(f"{target.url}: HTTP {resp.status}")
        return body.decode("utf-8", "replace")
    finally:
        conn.close()


class _SeriesState:
    """Reset-adjusted cumulative value for one counter-kind series."""

    __slots__ = ("last_raw", "offset", "resets")

    def __init__(self):
        self.last_raw = 0.0
        self.offset = 0.0
        self.resets = 0

    def update(self, raw: float) -> float:
        if raw < self.last_raw:
            # the process restarted (or the family was re-created):
            # fold the pre-reset total into the offset so the adjusted
            # series stays monotone and rates never go negative
            self.offset += self.last_raw
            self.resets += 1
        self.last_raw = raw
        return self.offset + raw


class MetricsFederator:
    """Scrape + merge + re-expose. All methods are safe to call from
    one pump thread plus any number of render/aggregate readers."""

    def __init__(
        self,
        targets=(),
        *,
        timeout_s: float = 5.0,
        registry: MetricsRegistry | None = None,
    ):
        self.targets: list[ScrapeTarget] = list(targets)
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        # family -> {"type", "help"}
        self._families: dict[str, dict] = {}
        # family -> {(name, labels): value} (labels include role/process)
        self._values: dict[str, dict] = {}
        # counter adjustment state: (family, name, labels) -> _SeriesState
        self._series: dict[tuple, _SeriesState] = {}
        # family -> reason, counted and listed, never silent
        self.quarantined: dict[str, str] = {}
        self._last_outcome: dict[str, str] = {}
        self._scrapes = {"ok": 0, "error": 0, "invalid": 0}
        self._last_scrape_s = 0.0
        self._roles: dict[str, str] = {}
        # optional self-metrics in a host registry (the primary's)
        self._m_scrapes = self._m_quarantined = self._m_duration = None
        self._m_targets = None
        if registry is not None:
            self._m_scrapes = registry.counter(
                "crane_fleet_scrapes_total",
                "Federated scrape attempts by process and outcome",
                labelnames=("process", "outcome"),
            )
            self._m_quarantined = registry.gauge(
                "crane_fleet_quarantined_families",
                "Families excluded from /fleet/metrics because their "
                "declared TYPE conflicts across processes",
            )
            self._m_duration = registry.gauge(
                "crane_fleet_scrape_seconds",
                "Wall seconds the last full federation pass took",
            )
            self._m_targets = registry.gauge(
                "crane_fleet_targets", "Configured scrape targets"
            )
            self._m_targets.set(len(self.targets))

    def add_target(self, target: ScrapeTarget) -> None:
        with self._lock:
            self.targets.append(target)
            if self._m_targets is not None:
                self._m_targets.set(len(self.targets))

    # -- scraping -----------------------------------------------------------

    def scrape_once(self) -> dict:
        """One federation pass over every target. Returns a summary:
        ``{"ok": [...], "failed": {name: reason}, "quarantined": [...]}``.
        A target that fails to scrape or strict-parse keeps its previous
        samples (stale beats absent for cumulative series) but is
        reported failed — the availability objective counts it bad."""
        t0 = time.perf_counter()
        ok: list[str] = []
        failed: dict[str, str] = {}
        for target in list(self.targets):
            try:
                if target.fetch is not None:
                    text = target.fetch()
                else:
                    text = _http_fetch(target, self.timeout_s)
            except Exception as exc:
                failed[target.name] = f"scrape: {type(exc).__name__}"
                self._record_outcome(target.name, "error")
                continue
            try:
                families = parse_exposition(text)
            except ExpositionError as exc:
                failed[target.name] = f"parse: {exc}"
                self._record_outcome(target.name, "invalid")
                continue
            self._merge(target, families)
            ok.append(target.name)
            self._record_outcome(target.name, "ok")
        with self._lock:
            self._last_scrape_s = time.perf_counter() - t0
            if self._m_duration is not None:
                self._m_duration.set(self._last_scrape_s)
            if self._m_quarantined is not None:
                self._m_quarantined.set(len(self.quarantined))
        return {
            "ok": ok,
            "failed": failed,
            "quarantined": sorted(self.quarantined),
        }

    def _record_outcome(self, name: str, outcome: str) -> None:
        with self._lock:
            self._last_outcome[name] = outcome
            self._scrapes[outcome if outcome in self._scrapes else "error"] \
                = self._scrapes.get(outcome, 0) + 1
        if self._m_scrapes is not None:
            self._m_scrapes.labels(process=name, outcome=outcome).inc()

    def _merge(self, target: ScrapeTarget, families: dict) -> None:
        role = target.role
        if role is None:
            # satellite: learn the role from the process's own
            # crane_build_info gauge; fall back to the target name
            info = families.get("crane_build_info")
            if info:
                for _, labels, value in info["samples"]:
                    if value:
                        role = dict(labels).get("role")
                        break
            role = role or target.name
        with self._lock:
            self._roles[target.name] = role
            for fam, doc in families.items():
                kind = doc["type"]
                known = self._families.get(fam)
                if fam in self.quarantined:
                    continue
                if known is None:
                    self._families[fam] = {"type": kind, "help": doc["help"]}
                    self._values[fam] = {}
                elif known["type"] != kind:
                    # conflicting declared types: quarantine the whole
                    # family (both sides) — counted, listed, never silent
                    self.quarantined[fam] = (
                        f"type conflict: {known['type']} vs {kind} "
                        f"(from {target.name})"
                    )
                    self._values.pop(fam, None)
                    continue
                counterish = kind in ("counter", "histogram", "summary")
                out = self._values[fam]
                # drop this process's previous samples for the family:
                # a label set that disappears upstream must not linger
                stale = [
                    key for key in out
                    if dict(key[1]).get("process") == target.name
                ]
                for key in stale:
                    del out[key]
                for name, labels, value in doc["samples"]:
                    merged = tuple(
                        lv for lv in labels if lv[0] not in _META_LABELS
                    ) + (("role", role), ("process", target.name))
                    if counterish:
                        skey = (fam, name, merged)
                        state = self._series.get(skey)
                        if state is None:
                            state = self._series[skey] = _SeriesState()
                        value = state.update(value)
                    out[(name, merged)] = value

    # -- re-exposure --------------------------------------------------------

    def render(self) -> str:
        """The union exposition: every process's families under
        ``role``/``process`` labels, deterministically ordered, valid
        under the strict parser (histogram series keep their buckets
        numerically le-sorted with ``_sum``/``_count`` trailing — the
        order ``_validate_histograms`` requires)."""
        with self._lock:
            out: list[str] = []
            for fam in sorted(self._families):
                if fam in self.quarantined:
                    continue
                meta = self._families[fam]
                if meta["help"]:
                    out.append(f"# HELP {fam} {meta['help']}")
                out.append(f"# TYPE {fam} {meta['type']}")
                values = self._values.get(fam, {})
                if meta["type"] == "histogram":
                    out.extend(self._render_histogram_locked(fam, values))
                    continue
                for (name, labels), value in sorted(values.items()):
                    out.append(
                        f"{name}{_render_labels(labels)} "
                        f"{format_value(value)}"
                    )
            return "\n".join(out) + "\n" if out else ""

    @staticmethod
    def _render_histogram_locked(fam: str, values: dict) -> list[str]:
        # group by the non-le label set, emit numerically-sorted
        # buckets then _sum then _count per group
        groups: dict[tuple, dict] = {}
        for (name, labels), value in values.items():
            base = tuple(lv for lv in labels if lv[0] != "le")
            entry = groups.setdefault(
                base, {"buckets": [], "sum": None, "count": None}
            )
            if name == fam + "_bucket":
                le = dict(labels).get("le", "+Inf")
                bound = float("inf") if le in ("+Inf", "Inf") else float(le)
                entry["buckets"].append((bound, le, value))
            elif name == fam + "_sum":
                entry["sum"] = value
            elif name == fam + "_count":
                entry["count"] = value
        out = []
        for base in sorted(groups):
            entry = groups[base]
            for _, le, value in sorted(
                entry["buckets"], key=lambda b: b[0]
            ):
                labels = base + (("le", le),)
                out.append(
                    f"{fam}_bucket{_render_labels(labels)} "
                    f"{format_value(value)}"
                )
            if entry["sum"] is not None:
                out.append(
                    f"{fam}_sum{_render_labels(base)} "
                    f"{format_value(entry['sum'])}"
                )
            if entry["count"] is not None:
                out.append(
                    f"{fam}_count{_render_labels(base)} "
                    f"{format_value(entry['count'])}"
                )
        return out

    # -- aggregate readers (the SLO engine's diet) --------------------------

    def counter_total(self, name: str, **label_filter) -> float:
        """Sum of a counter-kind sample's reset-adjusted values across
        the fleet, optionally filtered by label equality. ``name`` may
        be a plain counter family (``crane_shard_binds_total``) or a
        histogram child (``crane_service_request_seconds_count``, whose
        family is the suffix-stripped base name)."""
        candidates = [name]
        for suffix in ("_count", "_sum", "_bucket"):
            if name.endswith(suffix):
                candidates.append(name[: -len(suffix)])
        with self._lock:
            total = 0.0
            for fam in candidates:
                values = self._values.get(fam)
                if values is None:
                    continue
                for (sname, labels), value in values.items():
                    if sname != name:
                        continue
                    if _matches(labels, label_filter):
                        total += value
                break
            return total

    def histogram_agg(self, family: str, **label_filter):
        """Bucket-wise merge of a histogram family across processes:
        ``(sorted [(le, cumulative_count)], sum, count)`` — the
        fleet-level distribution the latency SLO burns against. Returns
        None when no process exposes the family yet."""
        with self._lock:
            if self._families.get(family, {}).get("type") != "histogram":
                return None
            buckets: dict[float, float] = {}
            total_sum = 0.0
            total_count = 0.0
            seen = False
            for (name, labels), value in self._values.get(family, {}).items():
                if not _matches(labels, label_filter):
                    continue
                if name == family + "_bucket":
                    le = dict(labels).get("le")
                    if le is None:
                        continue
                    bound = float("inf") if le in ("+Inf", "Inf") else float(le)
                    buckets[bound] = buckets.get(bound, 0.0) + value
                    seen = True
                elif name == family + "_sum":
                    total_sum += value
                elif name == family + "_count":
                    total_count += value
            if not seen:
                return None
            return sorted(buckets.items()), total_sum, total_count

    def gauge_values(self, family: str, **label_filter) -> list[tuple[dict, float]]:
        """Every (labels-dict, value) sample of a gauge family."""
        with self._lock:
            out = []
            for (name, labels), value in self._values.get(family, {}).items():
                if name == family and _matches(labels, label_filter):
                    out.append((dict(labels), value))
            return out

    def availability(self) -> tuple[int, int]:
        """(targets whose last scrape succeeded, configured targets)."""
        with self._lock:
            ok = sum(
                1 for t in self.targets
                if self._last_outcome.get(t.name) == "ok"
            )
            return ok, len(self.targets)

    def reset_count(self) -> int:
        with self._lock:
            return sum(s.resets for s in self._series.values())

    def status(self) -> dict:
        with self._lock:
            return {
                "targets": [
                    {
                        "name": t.name,
                        "role": self._roles.get(t.name, t.role),
                        "url": None if t.fetch is not None else t.url,
                        "lastOutcome": self._last_outcome.get(t.name),
                    }
                    for t in self.targets
                ],
                "scrapes": dict(self._scrapes),
                "families": len(self._families) - len(self.quarantined),
                "quarantined": dict(self.quarantined),
                "counterResets": sum(
                    s.resets for s in self._series.values()
                ),
                "lastScrapeSeconds": self._last_scrape_s,
            }


def _render_labels(labels: tuple) -> str:
    if not labels:
        return ""
    parts = []
    for k, v in labels:
        v = str(v).replace("\\", "\\\\").replace('"', '\\"')
        v = v.replace("\n", "\\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


def _matches(labels: tuple, label_filter: dict) -> bool:
    if not label_filter:
        return True
    have = dict(labels)
    return all(have.get(k) == v for k, v in label_filter.items())


# ---------------------------------------------------------------------------
# SLO engine
# ---------------------------------------------------------------------------

ALERT_OK, ALERT_WARNING, ALERT_PAGE = 0, 1, 2
_ALERT_NAMES = {ALERT_OK: "ok", ALERT_WARNING: "warning", ALERT_PAGE: "page"}

# the classic multi-window pairs (seconds): both windows of a pair must
# burn hot before the state machine moves, so a blip can't page
DEFAULT_FAST_WINDOWS = (300.0, 3600.0)      # 5m / 1h
DEFAULT_SLOW_WINDOWS = (21600.0, 259200.0)  # 6h / 3d


@dataclass
class SLOObjective:
    """One objective: a ``sample()`` closure returning cumulative
    ``(good, bad)`` event counts (monotone; the engine differences them
    over windows), the objective fraction, and alert thresholds."""

    name: str
    sample: object
    objective: float = 0.999
    warn_burn: float = 2.0
    page_burn: float = 14.4
    # hysteresis: this many consecutive ticks below clear_ratio * the
    # threshold before the state steps DOWN one level
    clear_ticks: int = 3
    clear_ratio: float = 0.5
    description: str = ""


class _ObjectiveState:
    __slots__ = ("history", "state", "clear_streak", "transitions")

    def __init__(self):
        self.history: list[tuple[float, float, float]] = []  # (t, good, bad)
        self.state = ALERT_OK
        self.clear_streak = 0
        self.transitions: list[dict] = []


class SLOEngine:
    """Burn-rate computation + alert state machines over federated
    counts. Fully deterministic: every time-dependent step goes through
    ``tick(now)`` with an injected ``now``."""

    def __init__(
        self,
        federator: MetricsFederator,
        objectives=None,
        *,
        registry: MetricsRegistry | None = None,
        fast_windows=DEFAULT_FAST_WINDOWS,
        slow_windows=DEFAULT_SLOW_WINDOWS,
        placement_target_s: float = 5.0,
        lag_budget_versions: int = 8,
    ):
        self.federator = federator
        self.fast_windows = tuple(float(w) for w in fast_windows)
        self.slow_windows = tuple(float(w) for w in slow_windows)
        self.placement_target_s = float(placement_target_s)
        self.lag_budget_versions = int(lag_budget_versions)
        self.objectives: list[SLOObjective] = (
            list(objectives) if objectives is not None
            else self._default_objectives()
        )
        self._states = {o.name: _ObjectiveState() for o in self.objectives}
        self._tick = 0
        self._last_now: float | None = None
        self._lock = threading.Lock()
        self._m_burn = self._m_budget = self._m_state = None
        if registry is not None:
            self._m_burn = registry.gauge(
                "crane_slo_burn_rate",
                "Error-budget burn rate per objective and window "
                "(1.0 = consuming the budget exactly)",
                labelnames=("objective", "window"),
            )
            self._m_budget = registry.gauge(
                "crane_slo_budget_remaining",
                "Fraction of the error budget left over the longest "
                "window (negative = overspent)",
                labelnames=("objective",),
            )
            self._m_state = registry.gauge(
                "crane_slo_alert_state",
                "Alert state per objective (0 ok, 1 warning, 2 page)",
                labelnames=("objective",),
            )

    # -- default objective set ---------------------------------------------

    def _default_objectives(self) -> list[SLOObjective]:
        fed = self.federator
        target = self.placement_target_s
        lag_budget = self.lag_budget_versions

        def placement():
            agg = fed.histogram_agg("crane_placement_e2e_seconds")
            if agg is None:
                return 0.0, 0.0
            buckets, _, count = agg
            good = 0.0
            for le, cum in buckets:
                if le <= target:
                    good = cum  # cumulative: the largest qualifying bound
            return good, max(0.0, count - good)

        def goodput():
            served = fed.counter_total("crane_service_request_seconds_count")
            shed = fed.counter_total("crane_service_shed_total")
            return served, shed

        # replication lag and availability are gauge/target-state
        # derived: each tick contributes one good-or-bad event per
        # replica / target, so the burn windows see a rate
        lag_events = {"good": 0.0, "bad": 0.0}

        def replication():
            for family in ("crane_replica_lag_versions",
                           "crane_router_replica_lag_versions"):
                samples = fed.gauge_values(family)
                if samples:
                    for _, lag in samples:
                        if lag > lag_budget:
                            lag_events["bad"] += 1
                        else:
                            lag_events["good"] += 1
                    break
            return lag_events["good"], lag_events["bad"]

        def shards():
            conflicts = fed.counter_total("crane_shard_conflicts_total")
            binds = fed.counter_total("crane_shard_binds_total")
            return binds, conflicts

        avail_events = {"good": 0.0, "bad": 0.0}

        def availability():
            ok, total = fed.availability()
            avail_events["good"] += ok
            avail_events["bad"] += total - ok
            return avail_events["good"], avail_events["bad"]

        return [
            SLOObjective(
                "placement_latency", placement, objective=0.99,
                description=f"pod e2e placement <= {target:g}s "
                            "(crane_placement_e2e_seconds)",
            ),
            SLOObjective(
                "serving_goodput", goodput, objective=0.999,
                description="served vs shed requests "
                            "(crane_service_shed_total)",
            ),
            SLOObjective(
                "replication_lag", replication, objective=0.99,
                description=f"replica lag <= {lag_budget} versions "
                            "per probe tick",
            ),
            SLOObjective(
                "shard_conflicts", shards, objective=0.95,
                description="optimistic shard binds vs conflicts "
                            "(crane_shard_conflicts_total)",
            ),
            SLOObjective(
                "scrape_availability", availability, objective=0.99,
                warn_burn=1.0, page_burn=10.0,
                description="fleet processes answering their scrape",
            ),
        ]

    # -- the tick -----------------------------------------------------------

    def tick(self, now: float | None = None) -> dict:
        """Sample every objective, recompute burns, advance the alert
        state machines. Returns the same payload ``status()`` serves."""
        if now is None:
            now = time.time()
        with self._lock:
            self._tick += 1
            self._last_now = float(now)
            horizon = max(self.slow_windows) if self.slow_windows else 0.0
            for obj in self.objectives:
                st = self._states[obj.name]
                good, bad = obj.sample()
                st.history.append((float(now), float(good), float(bad)))
                # bound memory: one sample older than the horizon is
                # kept as the window anchor
                cutoff = float(now) - horizon
                while len(st.history) > 2 and st.history[1][0] <= cutoff:
                    st.history.pop(0)
                self._advance(obj, st)
            return self._status_locked()

    def _burn_over(self, st: _ObjectiveState, window: float,
                   objective: float) -> float | None:
        """bad-fraction over ``window`` divided by the error budget;
        None while the window has no events yet."""
        if not st.history:
            return None
        now, good_now, bad_now = st.history[-1]
        anchor = st.history[0]
        for sample in st.history:
            if sample[0] >= now - window:
                break
            anchor = sample
        d_good = good_now - anchor[1]
        d_bad = bad_now - anchor[2]
        total = d_good + d_bad
        if total <= 0:
            return None
        budget = max(1e-9, 1.0 - objective)
        return (d_bad / total) / budget

    def _advance(self, obj: SLOObjective, st: _ObjectiveState) -> None:
        fast = [
            self._burn_over(st, w, obj.objective) for w in self.fast_windows
        ]
        slow = [
            self._burn_over(st, w, obj.objective) for w in self.slow_windows
        ]

        def hot(burns, threshold):
            return (
                bool(burns)
                and all(b is not None and b > threshold for b in burns)
            )

        target_state = st.state
        if hot(fast, obj.page_burn):
            target_state = ALERT_PAGE
        elif hot(fast, obj.warn_burn) or hot(slow, obj.warn_burn):
            target_state = max(st.state, ALERT_WARNING) \
                if st.state == ALERT_PAGE else ALERT_WARNING
        if target_state > st.state:
            self._transition(obj, st, target_state)
            st.clear_streak = 0
            return
        # hysteresis on clear: step DOWN one level only after
        # clear_ticks consecutive quiet ticks
        if st.state > ALERT_OK:
            threshold = (
                obj.page_burn if st.state == ALERT_PAGE else obj.warn_burn
            )
            quiet = all(
                b is None or b < threshold * obj.clear_ratio for b in fast
            )
            if quiet:
                st.clear_streak += 1
                if st.clear_streak >= obj.clear_ticks:
                    self._transition(obj, st, st.state - 1)
                    st.clear_streak = 0
            else:
                st.clear_streak = 0

    def _transition(self, obj: SLOObjective, st: _ObjectiveState,
                    to: int) -> None:
        st.transitions.append({
            "objective": obj.name,
            "from": _ALERT_NAMES[st.state],
            "to": _ALERT_NAMES[to],
            "tick": self._tick,
            "at": self._last_now,
        })
        st.state = to

    # -- export -------------------------------------------------------------

    def _window_name(self, seconds: float) -> str:
        if seconds % 3600 == 0:
            return f"{int(seconds // 3600)}h"
        if seconds % 60 == 0:
            return f"{int(seconds // 60)}m"
        return f"{seconds:g}s"

    def _status_locked(self) -> dict:
        objectives = {}
        for obj in self.objectives:
            st = self._states[obj.name]
            burns = {}
            for w in self.fast_windows + self.slow_windows:
                burns[self._window_name(w)] = self._burn_over(
                    st, w, obj.objective
                )
            longest = max(self.slow_windows) if self.slow_windows else None
            budget_remaining = None
            if longest is not None:
                burn = self._burn_over(st, longest, obj.objective)
                if burn is not None:
                    budget_remaining = 1.0 - burn
            objectives[obj.name] = {
                "objective": obj.objective,
                "description": obj.description,
                "state": _ALERT_NAMES[st.state],
                "burnRates": burns,
                "budgetRemaining": budget_remaining,
                "transitions": list(st.transitions),
            }
            if self._m_state is not None:
                self._m_state.labels(objective=obj.name).set(st.state)
                for wname, burn in burns.items():
                    if burn is not None:
                        self._m_burn.labels(
                            objective=obj.name, window=wname
                        ).set(burn)
                if budget_remaining is not None:
                    self._m_budget.labels(objective=obj.name).set(
                        budget_remaining
                    )
        return {
            "tick": self._tick,
            "now": self._last_now,
            "fastWindows": [self._window_name(w) for w in self.fast_windows],
            "slowWindows": [self._window_name(w) for w in self.slow_windows],
            "objectives": objectives,
        }

    def status(self) -> dict:
        with self._lock:
            return self._status_locked()

    def alert_state(self, objective: str) -> str:
        with self._lock:
            return _ALERT_NAMES[self._states[objective].state]

    def timeline(self) -> list[tuple[str, str, str]]:
        """The deterministic transition sequence — ``(objective, from,
        to)`` in occurrence order, timestamps stripped. Bench config 20
        compares this across same-seed runs."""
        with self._lock:
            events = []
            for obj in self.objectives:
                for tr in self._states[obj.name].transitions:
                    events.append(
                        (tr["tick"], tr["objective"], tr["from"], tr["to"])
                    )
            events.sort()
            return [(o, f, t) for _, o, f, t in events]


# ---------------------------------------------------------------------------
# anomaly detectors
# ---------------------------------------------------------------------------


class TrendDetector:
    """EWMA level + EWMA slope over an injected clock. Anomalous after
    ``min_ticks`` consecutive ticks with the smoothed slope above
    ``slope_per_s`` — the replication-lag trend detector ("lag is not
    just high, it is *growing*")."""

    def __init__(self, *, alpha: float = 0.3, slope_per_s: float = 1.0,
                 min_ticks: int = 3):
        self.alpha = float(alpha)
        self.slope_per_s = float(slope_per_s)
        self.min_ticks = int(min_ticks)
        self.level: float | None = None
        self.slope = 0.0
        self._last: tuple[float, float] | None = None
        self.streak = 0
        self.anomalous = False

    def update(self, now: float, value: float) -> bool:
        if self.level is None:
            self.level = value
        else:
            self.level += self.alpha * (value - self.level)
        if self._last is not None:
            dt = now - self._last[0]
            if dt > 0:
                inst = (value - self._last[1]) / dt
                self.slope += self.alpha * (inst - self.slope)
        self._last = (now, value)
        if self.slope > self.slope_per_s:
            self.streak += 1
        else:
            self.streak = 0
        self.anomalous = self.streak >= self.min_ticks
        return self.anomalous


class FlapDetector:
    """Transition-rate window over a cumulative transitions counter:
    anomalous when more than ``max_flaps`` transitions land inside
    ``window_s`` — the breaker-flapping detector."""

    def __init__(self, *, window_s: float = 60.0, max_flaps: int = 4):
        self.window_s = float(window_s)
        self.max_flaps = int(max_flaps)
        self._events: list[tuple[float, float]] = []  # (t, cumulative)
        self.anomalous = False
        self.flaps_in_window = 0.0

    def update(self, now: float, cumulative: float) -> bool:
        self._events.append((now, cumulative))
        while (
            len(self._events) > 2
            and self._events[1][0] <= now - self.window_s
        ):
            self._events.pop(0)
        anchor = self._events[0]
        for ev in self._events:
            if ev[0] >= now - self.window_s:
                break
            anchor = ev
        self.flaps_in_window = max(0.0, cumulative - anchor[1])
        self.anomalous = self.flaps_in_window > self.max_flaps
        return self.anomalous


class DwellDetector:
    """Consecutive-seconds-in-state accumulator: anomalous once the
    fleet has dwelt in the raised state longer than ``max_dwell_s`` —
    degraded mode is designed to be transient; an hour of it is an
    incident even if no single tick looks alarming."""

    def __init__(self, *, max_dwell_s: float = 300.0):
        self.max_dwell_s = float(max_dwell_s)
        self._raised_at: float | None = None
        self.dwell_s = 0.0
        self.anomalous = False

    def update(self, now: float, raised: bool) -> bool:
        if not raised:
            self._raised_at = None
            self.dwell_s = 0.0
        else:
            if self._raised_at is None:
                self._raised_at = now
            self.dwell_s = now - self._raised_at
        self.anomalous = self.dwell_s > self.max_dwell_s
        return self.anomalous


class FleetAnomalies:
    """The fleet's detector set, fed from federated families each
    ``tick(now)``; exported as ``crane_fleet_anomaly{kind}``."""

    KINDS = ("breaker_flapping", "degraded_dwell", "replication_lag_trend")

    def __init__(
        self,
        federator: MetricsFederator,
        *,
        registry: MetricsRegistry | None = None,
        breaker_window_s: float = 60.0,
        breaker_max_flaps: int = 4,
        degraded_max_dwell_s: float = 300.0,
        lag_slope_per_s: float = 1.0,
        lag_min_ticks: int = 3,
    ):
        self.federator = federator
        self.flap = FlapDetector(
            window_s=breaker_window_s, max_flaps=breaker_max_flaps
        )
        self.dwell = DwellDetector(max_dwell_s=degraded_max_dwell_s)
        self.trend = TrendDetector(
            slope_per_s=lag_slope_per_s, min_ticks=lag_min_ticks
        )
        self._m_anomaly = None
        if registry is not None:
            self._m_anomaly = registry.gauge(
                "crane_fleet_anomaly",
                "Fleet anomaly detectors (1 = firing)",
                labelnames=("kind",),
            )

    def tick(self, now: float | None = None) -> dict:
        if now is None:
            now = time.time()
        fed = self.federator
        transitions = fed.counter_total("crane_breaker_transitions_total")
        self.flap.update(now, transitions)
        degraded = any(
            v > 0 for _, v in fed.gauge_values("crane_degraded_mode")
        )
        self.dwell.update(now, degraded)
        lags = [
            v for _, v in fed.gauge_values("crane_replica_lag_versions")
        ] or [
            v for _, v in fed.gauge_values("crane_router_replica_lag_versions")
        ]
        self.trend.update(now, max(lags) if lags else 0.0)
        return self.status()

    def status(self) -> dict:
        out = {
            "breaker_flapping": {
                "firing": self.flap.anomalous,
                "flapsInWindow": self.flap.flaps_in_window,
                "windowSeconds": self.flap.window_s,
            },
            "degraded_dwell": {
                "firing": self.dwell.anomalous,
                "dwellSeconds": self.dwell.dwell_s,
                "maxDwellSeconds": self.dwell.max_dwell_s,
            },
            "replication_lag_trend": {
                "firing": self.trend.anomalous,
                "ewmaLag": self.trend.level,
                "ewmaSlopePerS": self.trend.slope,
            },
        }
        if self._m_anomaly is not None:
            for kind in self.KINDS:
                self._m_anomaly.labels(kind=kind).set(
                    1 if out[kind]["firing"] else 0
                )
        return out


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------


class FleetPlane:
    """Federator + SLO engine + anomaly detectors behind one ``tick()``,
    plus an optional wall-clock pump thread (``interval_s``, 1 Hz by
    default). ``registry`` is the HOST process's registry — the plane's
    own health (scrape outcomes, quarantines, burn rates, alert states,
    anomalies) lands there so the primary's plain ``/metrics`` carries
    the fleet verdict too. ``local_registry`` adds an in-process target
    (no socket) rendering that registry under ``local_role``."""

    def __init__(
        self,
        targets=(),
        *,
        registry: MetricsRegistry | None = None,
        local_registry: MetricsRegistry | None = None,
        local_role: str | None = None,
        local_name: str = "self",
        interval_s: float = 1.0,
        clock=time.time,
        slo_kwargs: dict | None = None,
        anomaly_kwargs: dict | None = None,
    ):
        self.interval_s = float(interval_s)
        self.clock = clock
        self.federator = MetricsFederator(targets, registry=registry)
        if local_registry is not None:
            self.federator.add_target(ScrapeTarget(
                name=local_name,
                role=local_role or process_role(),
                fetch=local_registry.render,
            ))
        self.slo = SLOEngine(
            self.federator, registry=registry, **(slo_kwargs or {})
        )
        self.anomalies = FleetAnomalies(
            self.federator, registry=registry, **(anomaly_kwargs or {})
        )
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def tick(self, now: float | None = None) -> dict:
        """One full pass: scrape -> burn -> detect. Deterministic when
        ``now`` is supplied and the targets' fetchers are injected."""
        if now is None:
            now = self.clock()
        scrape = self.federator.scrape_once()
        slo = self.slo.tick(now)
        anomalies = self.anomalies.tick(now)
        return {"scrape": scrape, "slo": slo, "anomalies": anomalies}

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._pump, name="crane-fleet-pump", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _pump(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # pragma: no cover - the pump must survive
                pass

    # -- the HTTP surfaces (service.http wires these) -----------------------

    def render_metrics(self) -> str:
        return self.federator.render()

    def slo_status(self) -> dict:
        return {
            "role": process_role(),
            "slo": self.slo.status(),
            "anomalies": self.anomalies.status(),
            "federation": self.federator.status(),
        }


def parse_scrape_flag(spec: str) -> list[ScrapeTarget]:
    """Parse the ``--fleet-scrape`` CLI flag: a comma list of
    ``[role@]host:port[/path]`` entries (``scheduler@127.0.0.1:8090``).
    Names are derived ``role-N`` / ``target-N`` by position."""
    targets = []
    for i, entry in enumerate(x.strip() for x in spec.split(",")):
        if not entry:
            continue
        role = None
        if "@" in entry:
            role, _, entry = entry.partition("@")
        path = "/metrics"
        hostport = entry
        slash = entry.find("/")
        if slash >= 0:
            hostport, path = entry[:slash], entry[slash:]
        host, _, port = hostport.rpartition(":")
        targets.append(ScrapeTarget(
            name=f"{role or 'target'}-{i}",
            host=host or "127.0.0.1",
            port=int(port),
            path=path,
            role=role,
        ))
    return targets
