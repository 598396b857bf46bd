"""Deadline propagation for the serving and bind paths.

Copy of ``crane_scheduler_tpu/service/deadline.py``.

A caller that has, say, 250ms of budget left says so in a
``crane-deadline-ms`` header minted beside ``traceparent``. The value
is the REMAINING budget in milliseconds at send time (gRPC style:
relative budgets survive cross-process clock skew, absolute wall-clock
deadlines don't); each receiving hop re-anchors it against its own
monotonic clock at parse and re-checks the remaining budget at every
expensive boundary:

- **IO-thread parse** (``service.frontend``): a request that arrives
  already expired is shed with 504 before a worker ever sees it;
- **queue dequeue** (``ServiceRouter.handle``): budget burned waiting
  for a worker slot counts — the async front end stamps the absolute
  anchor into the parsed header dict (``_ANCHOR_KEY``) so the check at
  dequeue charges the queue wait, not just the wire;
- **device dispatch** (``ScoringService``): the last gate before the
  expensive step — an expired request must never cost a device
  round-trip (the bench-17 invariant).

Within a process the active deadline rides a thread-local exactly like
``telemetry.tracing``; ``cluster.kube`` forwards the remaining budget
on kube-bound POSTs so the apiserver (stub) sees the same header.

Malformed values are ignored (a bad header must never break request
handling); a parseable budget <= 0 IS a deadline — already expired.
Stdlib-only.
"""

from __future__ import annotations

import contextlib
import threading
import time

HEADER = "crane-deadline-ms"
# internal header key the async front end uses to carry the parse-time
# monotonic anchor to the worker (never sent on the wire)
_ANCHOR_KEY = "x-crane-deadline-anchor"

_MAX_BUDGET_MS = 24 * 3600 * 1000.0  # clamp absurd budgets to a day


class DeadlineExpiredError(Exception):
    """Raised at a deadline checkpoint when the budget is gone.

    ``stage`` names the checkpoint (``queue``/``dispatch``/...), so the
    shed counter can attribute where the budget died."""

    def __init__(self, stage: str, overrun_ms: float = 0.0):
        super().__init__(f"deadline expired at {stage} "
                         f"(+{overrun_ms:.1f}ms over)")
        self.stage = stage
        self.overrun_ms = overrun_ms


class Deadline:
    """An absolute expiry on the process's monotonic clock."""

    __slots__ = ("expires_at",)

    def __init__(self, expires_at: float):
        self.expires_at = float(expires_at)

    @staticmethod
    def from_budget_ms(budget_ms: float, now: float | None = None) -> "Deadline":
        if now is None:
            now = time.monotonic()
        budget_ms = min(float(budget_ms), _MAX_BUDGET_MS)
        return Deadline(now + budget_ms / 1000.0)

    def remaining_ms(self, now: float | None = None) -> float:
        if now is None:
            now = time.monotonic()
        return (self.expires_at - now) * 1000.0

    def expired(self, now: float | None = None) -> bool:
        return self.remaining_ms(now) <= 0.0

    def header_value(self, now: float | None = None) -> str:
        """The remaining budget, re-minted for the next hop (floored at
        0 so a just-expired deadline propagates as expired, not as a
        negative number a strict receiver might reject)."""
        return f"{max(0.0, self.remaining_ms(now)):.3f}"

    def check(self, stage: str, now: float | None = None) -> None:
        """Raise ``DeadlineExpiredError`` if the budget is gone."""
        rem = self.remaining_ms(now)
        if rem <= 0.0:
            raise DeadlineExpiredError(stage, overrun_ms=-rem)

    def __repr__(self):
        return f"Deadline(remaining_ms={self.remaining_ms():.1f})"


def parse_budget_ms(value) -> float | None:
    """Strict parse of a ``crane-deadline-ms`` value: a finite number,
    else None (malformed headers are ignored, never an error)."""
    if value is None or isinstance(value, bool):
        return None
    if isinstance(value, (int, float)):
        budget = float(value)
    elif isinstance(value, str):
        try:
            budget = float(value.strip())
        except ValueError:
            return None
    else:
        return None
    if budget != budget or budget in (float("inf"), float("-inf")):
        return None
    return budget


def from_headers(headers, now: float | None = None) -> Deadline | None:
    """The request's deadline, re-anchored at ``now``. Prefers the
    front end's parse-time anchor (so queue wait is charged against the
    budget); falls back to the wire header anchored here."""
    if not headers:
        return None
    anchor = headers.get(_ANCHOR_KEY)
    if anchor is not None:
        try:
            return Deadline(float(anchor))
        except (TypeError, ValueError):
            pass
    budget = parse_budget_ms(headers.get(HEADER))
    if budget is None:
        return None
    return Deadline.from_budget_ms(budget, now)


def anchor_headers(headers: dict, now: float | None = None) -> Deadline | None:
    """Parse-time anchoring (async front end, IO thread): resolve the
    wire budget against ``now`` once and stamp the absolute anchor into
    the header dict, so the worker-side check charges queue wait."""
    budget = parse_budget_ms(headers.get(HEADER))
    if budget is None:
        return None
    dl = Deadline.from_budget_ms(budget, now)
    headers[_ANCHOR_KEY] = repr(dl.expires_at)
    return dl


# -- thread-local propagation (mirrors telemetry.tracing) ----------------

_tls = threading.local()


def current() -> Deadline | None:
    """The thread's active deadline (None when unbounded — the disabled
    hot path is one ``getattr``)."""
    return getattr(_tls, "deadline", None)


@contextlib.contextmanager
def use(dl: Deadline | None):
    """Install ``dl`` as the thread's active deadline for the block;
    ``use(None)`` is a no-op passthrough (keeps call sites branch-free)."""
    if dl is None:
        yield None
        return
    prev = getattr(_tls, "deadline", None)
    _tls.deadline = dl
    try:
        yield dl
    finally:
        _tls.deadline = prev


def check(stage: str, now: float | None = None) -> None:
    """Checkpoint the thread's active deadline (no-op when unbounded)."""
    dl = current()
    if dl is not None:
        dl.check(stage, now)
