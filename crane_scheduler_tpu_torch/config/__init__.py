from .types import (
    DynamicArgs,
    NodeResourceTopologyMatchArgs,
    PluginWeight,
    SchedulerConfiguration,
    SchedulerProfile,
)
from .scheme import load_scheduler_config, ConfigDecodeError
from .factory import build_scheduler_from_config

__all__ = [
    "DynamicArgs",
    "NodeResourceTopologyMatchArgs",
    "PluginWeight",
    "SchedulerConfiguration",
    "SchedulerProfile",
    "load_scheduler_config",
    "ConfigDecodeError",
    "build_scheduler_from_config",
]
