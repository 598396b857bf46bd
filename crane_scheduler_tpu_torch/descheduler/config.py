"""Descheduler configuration: watermarks and safety knobs.

Copy of ``crane_scheduler_tpu/descheduler/config.py``.

Shaped like gocrane's load-aware descheduler profile: per-metric
``target``/``threshold`` watermark pairs over the SAME metric names the
annotator syncs (``cpu_usage_avg_5m``, ...), so the eviction trigger
reads exactly the annotations the scheduler places against — one
telemetry pipeline, two consumers.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.system import system_namespace

# Opt-out annotation: a pod carrying this with value "false" is never
# evicted (the descheduler analogue of the reference's
# descheduler.alpha.kubernetes.io/evict override).
EVICT_ANNOTATION = "descheduler.crane.io/evict"


@dataclass(frozen=True)
class WatermarkPolicy:
    """Per-metric watermark pair, usage fractions in [0, 1] like the
    annotation values:

    - ``threshold``: sustained usage ABOVE this marks the node hot
      (eviction source);
    - ``target``: a node is a safe landing spot only while usage stays
      AT OR BELOW this (eviction destination) — the gap between the two
      is the hysteresis band that keeps evictions from ping-ponging.
    """

    name: str
    target: float
    threshold: float


# Default watermarks over the 5m-average metrics of the canonical policy
# (policy/types.py DEFAULT_POLICY): trigger slightly above the Dynamic
# predicate's 0.65 filter limit so the scheduler stops ADDING load to a
# node well before the descheduler starts REMOVING it.
DEFAULT_WATERMARKS = (
    WatermarkPolicy("cpu_usage_avg_5m", target=0.50, threshold=0.70),
    WatermarkPolicy("mem_usage_avg_5m", target=0.50, threshold=0.70),
)


def _default_protected_namespaces() -> frozenset[str]:
    return frozenset({"kube-system", system_namespace()})


@dataclass(frozen=True)
class DeschedulerConfig:
    watermarks: tuple[WatermarkPolicy, ...] = DEFAULT_WATERMARKS
    # a node must be over threshold for this many CONSECUTIVE syncs
    # before it is actionable — one annotation spike never evicts
    consecutive_syncs: int = 3
    # eviction budgets: per node per cycle, and per cycle overall
    max_evictions_per_node: int = 1
    max_evictions_per_cycle: int = 4
    # a node that had an eviction rests this long before the next one —
    # long enough for the annotator to re-observe the lowered load
    node_cooldown_seconds: float = 300.0
    sync_period_seconds: float = 60.0
    dry_run: bool = False
    evict_annotation: str = EVICT_ANNOTATION
    protected_namespaces: frozenset[str] = field(
        default_factory=_default_protected_namespaces
    )
