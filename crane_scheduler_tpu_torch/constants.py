"""Shared reference constants — single source of truth.

Copy of ``crane_scheduler_tpu/constants.py``.

The oracle and the batched scorer must agree on these by construction
(the parity tests assume it), so every module imports from here.
"""

MAX_NODE_SCORE = 100  # ref: k8s framework.MaxNodeScore
MIN_NODE_SCORE = 0  # ref: k8s framework.MinNodeScore

# ref: pkg/plugins/dynamic/stats.go:18-27
NODE_HOT_VALUE_KEY = "node_hot_value"
EXTRA_ACTIVE_PERIOD_SECONDS = 300.0
HOT_VALUE_ACTIVE_PERIOD_SECONDS = 300.0

# ref: pkg/controller/annotator/node.go:24-27
DEFAULT_BACKOFF_SECONDS = 10.0
MAX_BACKOFF_SECONDS = 360.0

# ref: cmd/controller/app/options/options.go:38-58
DEFAULT_BINDING_HEAP_SIZE = 1024
DEFAULT_CONCURRENT_SYNCS = 1
