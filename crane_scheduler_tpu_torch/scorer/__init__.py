from .oracle import (
    UsageError,
    get_resource_usage,
    get_active_duration,
    is_overload,
    get_node_score,
    get_node_hot_value,
    filter_node,
    score_node,
)
from .batched import BatchedScorer, ScoreResult
from .hybrid import (
    HybridResult,
    HybridScorer,
    OverrideCache,
    compute_overrides,
    compute_overrides_incremental,
    score_rows_f64,
)
from .topk import GangScheduler, gang_assign_host, gang_assign_oracle
from .parity import ParityError, check_placement_parity

__all__ = [
    "HybridResult",
    "HybridScorer",
    "OverrideCache",
    "compute_overrides",
    "compute_overrides_incremental",
    "score_rows_f64",
    "GangScheduler",
    "gang_assign_host",
    "gang_assign_oracle",
    "ParityError",
    "check_placement_parity",
    "UsageError",
    "get_resource_usage",
    "get_active_duration",
    "is_overload",
    "get_node_score",
    "get_node_hot_value",
    "filter_node",
    "score_node",
    "BatchedScorer",
    "ScoreResult",
]
