"""System-namespace resolution (ref: pkg/utils/utils.go:47-55).

Copy of ``crane_scheduler_tpu/utils/system.py``.

The reference reads the ``CRANE_SYSTEM_NAMESPACE`` environment variable
(consumed at cmd/controller/app/options/options.go:52 for the leader-
election lease namespace) and falls back to ``crane-system`` when the
variable is unset or empty.
"""

from __future__ import annotations

import os

DEFAULT_SYSTEM_NAMESPACE = "crane-system"
SYSTEM_NAMESPACE_ENV = "CRANE_SYSTEM_NAMESPACE"


def system_namespace(default: str = DEFAULT_SYSTEM_NAMESPACE) -> str:
    """The namespace system objects (the leader-election Lease) live in:
    ``$CRANE_SYSTEM_NAMESPACE`` when set and non-empty, else
    ``crane-system`` — exactly the reference's GetSystemNamespace."""
    ns = os.environ.get(SYSTEM_NAMESPACE_ENV, "")
    return ns if ns != "" else default
