"""Strict v1alpha1 YAML decoding for DynamicSchedulerPolicy.

Copy of ``crane_scheduler_tpu/policy/v1alpha1.py`` with PyYAML imported
lazily inside ``load_policy``.

Equivalent of the reference's policy scheme + UniversalDecoder path
(ref: pkg/plugins/dynamic/policyfile.go:11-33,
pkg/plugins/apis/policy/scheme/scheme.go:13-29): the decoder is *strict* —
unknown fields, wrong GVK, or malformed durations are errors, matching the
strict codec factory the reference builds its scheme with. Wire field names
follow pkg/plugins/apis/policy/v1alpha1/types.go:14-39, including the
``maxLimitPecent`` typo.
"""

from __future__ import annotations

from typing import Any, Mapping

from ..utils.duration import DurationError, parse_go_duration
from .types import (
    DynamicSchedulerPolicy,
    HotValuePolicy,
    PolicySpec,
    PredicatePolicy,
    PriorityPolicy,
    SyncPolicy,
)

GROUP_VERSION = "scheduler.policy.crane.io/v1alpha1"
KIND = "DynamicSchedulerPolicy"


class PolicyDecodeError(ValueError):
    pass


def _require_mapping(obj: Any, where: str) -> Mapping:
    if not isinstance(obj, Mapping):
        raise PolicyDecodeError(f"{where}: expected a mapping, got {type(obj).__name__}")
    return obj


def _check_fields(obj: Mapping, allowed: set[str], where: str) -> None:
    unknown = set(obj) - allowed
    if unknown:
        raise PolicyDecodeError(f"{where}: unknown field(s) {sorted(unknown)}")


def _decode_duration(val: Any, where: str) -> float:
    if not isinstance(val, str):
        raise PolicyDecodeError(f"{where}: duration must be a string, got {val!r}")
    try:
        return parse_go_duration(val)
    except DurationError as e:
        raise PolicyDecodeError(f"{where}: {e}") from e


def _decode_float(val: Any, where: str) -> float:
    if isinstance(val, bool) or not isinstance(val, (int, float)):
        raise PolicyDecodeError(f"{where}: expected a number, got {val!r}")
    return float(val)


def load_policy(data: str | bytes) -> DynamicSchedulerPolicy:
    """Decode a v1alpha1 DynamicSchedulerPolicy YAML/JSON document.

    PyYAML is imported here, not at module level, so the package imports
    on hosts without it (the scheduling path uses ``DEFAULT_POLICY``)."""
    import yaml

    try:
        doc = yaml.safe_load(data)
    except yaml.YAMLError as e:
        raise PolicyDecodeError(f"invalid YAML: {e}") from e
    doc = _require_mapping(doc, "document")
    _check_fields(doc, {"apiVersion", "kind", "spec", "metadata"}, "document")

    api_version = doc.get("apiVersion")
    kind = doc.get("kind")
    if api_version != GROUP_VERSION:
        raise PolicyDecodeError(
            f"unsupported apiVersion {api_version!r}, want {GROUP_VERSION!r}"
        )
    if kind != KIND:
        raise PolicyDecodeError(f"unsupported kind {kind!r}, want {KIND!r}")

    spec_doc = _require_mapping(doc.get("spec", {}), "spec")
    _check_fields(spec_doc, {"syncPolicy", "predicate", "priority", "hotValue"}, "spec")

    sync: list[SyncPolicy] = []
    for i, item in enumerate(spec_doc.get("syncPolicy") or []):
        item = _require_mapping(item, f"spec.syncPolicy[{i}]")
        _check_fields(item, {"name", "period"}, f"spec.syncPolicy[{i}]")
        sync.append(
            SyncPolicy(
                name=str(item.get("name", "")),
                period_seconds=_decode_duration(
                    item.get("period", "0"), f"spec.syncPolicy[{i}].period"
                ),
            )
        )

    predicate: list[PredicatePolicy] = []
    for i, item in enumerate(spec_doc.get("predicate") or []):
        item = _require_mapping(item, f"spec.predicate[{i}]")
        _check_fields(item, {"name", "maxLimitPecent"}, f"spec.predicate[{i}]")
        predicate.append(
            PredicatePolicy(
                name=str(item.get("name", "")),
                max_limit_percent=_decode_float(
                    item.get("maxLimitPecent", 0), f"spec.predicate[{i}].maxLimitPecent"
                ),
            )
        )

    priority: list[PriorityPolicy] = []
    for i, item in enumerate(spec_doc.get("priority") or []):
        item = _require_mapping(item, f"spec.priority[{i}]")
        _check_fields(item, {"name", "weight"}, f"spec.priority[{i}]")
        priority.append(
            PriorityPolicy(
                name=str(item.get("name", "")),
                weight=_decode_float(item.get("weight", 0), f"spec.priority[{i}].weight"),
            )
        )

    hot_value: list[HotValuePolicy] = []
    for i, item in enumerate(spec_doc.get("hotValue") or []):
        item = _require_mapping(item, f"spec.hotValue[{i}]")
        _check_fields(item, {"timeRange", "count"}, f"spec.hotValue[{i}]")
        count = item.get("count", 0)
        if isinstance(count, bool) or not isinstance(count, int):
            raise PolicyDecodeError(f"spec.hotValue[{i}].count: expected int, got {count!r}")
        hot_value.append(
            HotValuePolicy(
                time_range_seconds=_decode_duration(
                    item.get("timeRange", "0"), f"spec.hotValue[{i}].timeRange"
                ),
                count=count,
            )
        )

    return DynamicSchedulerPolicy(
        spec=PolicySpec(
            sync_period=tuple(sync),
            predicate=tuple(predicate),
            priority=tuple(priority),
            hot_value=tuple(hot_value),
        ),
        api_version=api_version,
        kind=kind,
    )


def load_policy_from_file(path: str) -> DynamicSchedulerPolicy:
    """ref: pkg/plugins/dynamic/policyfile.go:11-18."""
    with open(path, "rb") as f:
        return load_policy(f.read())
