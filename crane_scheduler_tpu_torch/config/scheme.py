"""Versioned decode of scheduler-configuration documents.

Strict decoding of the ``KubeSchedulerConfiguration``-shaped YAML the
reference ships (ref: deploy/manifests/dynamic/scheduler-config.yaml,
deploy/manifests/noderesourcetopology/scheduler-config.yaml), supporting
both args versions registered by the reference scheme
(ref: pkg/plugins/apis/config/scheme/scheme.go:14-31):

- ``kubescheduler.config.k8s.io/v1beta2``: ``policyConfigPath`` is a
  plain string; absent => default path (v1beta2/defaults.go).
- ``kubescheduler.config.k8s.io/v1beta3``: pointer defaulting — an absent
  field gets the default, an explicitly empty string is preserved
  (v1beta3/defaults.go:8-12).

Only the fields the crane plugins consume are modeled; unknown plugin
args names are rejected (the reference's scheme would fail decoding too).

Copy of ``crane_scheduler_tpu/config/scheme.py``; PyYAML is imported only
when a document is decoded, so the package imports without it.
"""

from __future__ import annotations

from typing import Any, Mapping

from .types import (
    DEFAULT_DYNAMIC_POLICY_CONFIG_PATH,
    DEFAULT_TOPOLOGY_AWARE_RESOURCES,
    DynamicArgs,
    NodeResourceTopologyMatchArgs,
    PluginWeight,
    SchedulerConfiguration,
    SchedulerProfile,
)

SUPPORTED_VERSIONS = (
    "kubescheduler.config.k8s.io/v1beta2",
    "kubescheduler.config.k8s.io/v1beta3",
)

DYNAMIC_ARGS_KIND = "DynamicArgs"
NRT_ARGS_KIND = "NodeResourceTopologyMatchArgs"


class ConfigDecodeError(ValueError):
    pass


def _require_mapping(obj: Any, where: str) -> Mapping:
    if not isinstance(obj, Mapping):
        raise ConfigDecodeError(f"{where}: expected a mapping, got {type(obj).__name__}")
    return obj


def _decode_dynamic_args(doc: Mapping, version: str) -> DynamicArgs:
    unknown = set(doc) - {"apiVersion", "kind", "policyConfigPath"}
    if unknown:
        raise ConfigDecodeError(f"DynamicArgs: unknown field(s) {sorted(unknown)}")
    if version.endswith("v1beta3"):
        # pointer defaulting: absent -> default; empty string preserved
        if "policyConfigPath" in doc:
            path = doc["policyConfigPath"]
            if path is None:
                path = DEFAULT_DYNAMIC_POLICY_CONFIG_PATH
        else:
            path = DEFAULT_DYNAMIC_POLICY_CONFIG_PATH
    else:
        path = doc.get("policyConfigPath") or DEFAULT_DYNAMIC_POLICY_CONFIG_PATH
    if not isinstance(path, str):
        raise ConfigDecodeError(f"DynamicArgs.policyConfigPath: expected string, got {path!r}")
    return DynamicArgs(policy_config_path=path)


def _decode_nrt_args(doc: Mapping) -> NodeResourceTopologyMatchArgs:
    unknown = set(doc) - {"apiVersion", "kind", "topologyAwareResources"}
    if unknown:
        raise ConfigDecodeError(
            f"NodeResourceTopologyMatchArgs: unknown field(s) {sorted(unknown)}"
        )
    resources = doc.get("topologyAwareResources")
    if resources is None:
        resources = list(DEFAULT_TOPOLOGY_AWARE_RESOURCES)
    if not isinstance(resources, list) or not all(isinstance(r, str) for r in resources):
        raise ConfigDecodeError(
            f"topologyAwareResources: expected string list, got {resources!r}"
        )
    return NodeResourceTopologyMatchArgs(topology_aware_resources=tuple(resources))


def _decode_plugin_set(doc: Mapping, point: str) -> tuple:
    section = _require_mapping(doc.get(point, {}) or {}, f"plugins.{point}")
    enabled = section.get("enabled") or []
    out = []
    for i, item in enumerate(enabled):
        item = _require_mapping(item, f"plugins.{point}.enabled[{i}]")
        name = item.get("name")
        if not isinstance(name, str) or not name:
            raise ConfigDecodeError(f"plugins.{point}.enabled[{i}]: missing name")
        weight = item.get("weight", 1)
        if not isinstance(weight, int):
            raise ConfigDecodeError(f"plugins.{point}.enabled[{i}]: bad weight {weight!r}")
        out.append(PluginWeight(name=name, weight=weight))
    return tuple(out)


def load_scheduler_config(data: str | bytes) -> SchedulerConfiguration:
    import yaml

    try:
        doc = yaml.safe_load(data)
    except yaml.YAMLError as e:
        raise ConfigDecodeError(f"invalid YAML: {e}") from e
    doc = _require_mapping(doc, "document")
    version = doc.get("apiVersion")
    if version not in SUPPORTED_VERSIONS:
        raise ConfigDecodeError(
            f"unsupported apiVersion {version!r}, want one of {SUPPORTED_VERSIONS}"
        )
    if doc.get("kind") != "KubeSchedulerConfiguration":
        raise ConfigDecodeError(f"unsupported kind {doc.get('kind')!r}")

    profiles = []
    for i, profile_doc in enumerate(doc.get("profiles") or []):
        profile_doc = _require_mapping(profile_doc, f"profiles[{i}]")
        plugins_doc = _require_mapping(profile_doc.get("plugins", {}) or {}, "plugins")
        filter_enabled = tuple(
            pw.name for pw in _decode_plugin_set(plugins_doc, "filter")
        )
        score_enabled = _decode_plugin_set(plugins_doc, "score")
        # the NRT plugin registers 5 extension points from one entry
        for point in ("preFilter", "reserve", "preBind"):
            _decode_plugin_set(plugins_doc, point)  # validated, implied by plugin

        plugin_config: dict[str, object] = {}
        for j, pc in enumerate(profile_doc.get("pluginConfig") or []):
            pc = _require_mapping(pc, f"profiles[{i}].pluginConfig[{j}]")
            name = pc.get("name")
            args_doc = _require_mapping(pc.get("args", {}) or {}, "args")
            if name == "Dynamic":
                plugin_config[name] = _decode_dynamic_args(args_doc, version)
            elif name == "NodeResourceTopologyMatch":
                plugin_config[name] = _decode_nrt_args(args_doc)
            else:
                raise ConfigDecodeError(f"unknown pluginConfig name {name!r}")
        # defaulting: enabled plugins without explicit args get defaults
        # (the reference's defaulter runs for every registered type)
        mentioned = {pw.name for pw in score_enabled} | set(filter_enabled)
        if "Dynamic" in mentioned and "Dynamic" not in plugin_config:
            plugin_config["Dynamic"] = DynamicArgs()
        if (
            "NodeResourceTopologyMatch" in mentioned
            and "NodeResourceTopologyMatch" not in plugin_config
        ):
            plugin_config["NodeResourceTopologyMatch"] = NodeResourceTopologyMatchArgs()

        profiles.append(
            SchedulerProfile(
                scheduler_name=profile_doc.get("schedulerName", "default-scheduler"),
                filter_enabled=filter_enabled,
                score_enabled=score_enabled,
                plugin_config=plugin_config,
            )
        )

    return SchedulerConfiguration(api_version=version, profiles=tuple(profiles))


def load_scheduler_config_from_file(path: str) -> SchedulerConfiguration:
    with open(path, "rb") as f:
        return load_scheduler_config(f.read())
