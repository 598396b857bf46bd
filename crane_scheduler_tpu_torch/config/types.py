"""Plugin-args configuration API.

Equivalent of the reference's kube-scheduler plugin-args machinery
(ref: pkg/plugins/apis/config): internal ``DynamicArgs`` /
``NodeResourceTopologyMatchArgs`` types (types.go:10-23) decoded from a
scheduler-configuration document's ``pluginConfig`` section, with
versioned defaulting:

- v1beta2: plain string ``policyConfigPath`` defaulting to
  ``/etc/kubernetes/dynamic-scheduler-policy.yaml``; topology-aware
  resources default ["cpu"] (ref: v1beta2/defaults.go:4-19)
- v1beta3: pointer field with pointer defaulting — absent means default,
  empty string stays empty (ref: v1beta3/types.go:13, defaults.go:8-12)

Copy of ``crane_scheduler_tpu/config/types.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

DEFAULT_DYNAMIC_POLICY_CONFIG_PATH = "/etc/kubernetes/dynamic-scheduler-policy.yaml"
DEFAULT_TOPOLOGY_AWARE_RESOURCES = ("cpu",)


@dataclass(frozen=True)
class DynamicArgs:
    """ref: config/types.go:10-16."""

    policy_config_path: str = DEFAULT_DYNAMIC_POLICY_CONFIG_PATH


@dataclass(frozen=True)
class NodeResourceTopologyMatchArgs:
    """ref: config/types.go:18-23."""

    topology_aware_resources: tuple[str, ...] = DEFAULT_TOPOLOGY_AWARE_RESOURCES


@dataclass(frozen=True)
class PluginWeight:
    name: str
    weight: int = 1


@dataclass(frozen=True)
class SchedulerProfile:
    """One scheduler profile: enabled plugins per extension point plus
    decoded plugin args (the subset of KubeSchedulerConfiguration the
    crane plugins use; ref: deploy/manifests/*/scheduler-config.yaml)."""

    scheduler_name: str = "default-scheduler"
    filter_enabled: tuple[str, ...] = ()
    score_enabled: tuple[PluginWeight, ...] = ()
    # other extension points follow the plugin's own declaration
    plugin_config: dict = field(default_factory=dict)  # plugin name -> args


@dataclass(frozen=True)
class SchedulerConfiguration:
    api_version: str = "kubescheduler.config.k8s.io/v1beta2"
    profiles: tuple[SchedulerProfile, ...] = ()
