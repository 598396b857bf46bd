from .types import (
    SyncPolicy,
    PredicatePolicy,
    PriorityPolicy,
    HotValuePolicy,
    PolicySpec,
    DynamicSchedulerPolicy,
    DEFAULT_POLICY,
)
from .v1alpha1 import load_policy, load_policy_from_file, PolicyDecodeError
from .compile import PolicyTensors, compile_policy

__all__ = [
    "SyncPolicy",
    "PredicatePolicy",
    "PriorityPolicy",
    "HotValuePolicy",
    "PolicySpec",
    "DynamicSchedulerPolicy",
    "DEFAULT_POLICY",
    "load_policy",
    "load_policy_from_file",
    "PolicyDecodeError",
    "PolicyTensors",
    "compile_policy",
]
