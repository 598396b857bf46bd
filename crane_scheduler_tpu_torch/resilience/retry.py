"""Bounded retries: full-jitter exponential backoff under a deadline.

Copy of ``crane_scheduler_tpu/resilience/retry.py``.

Replaces ad-hoc single-attempt call sites (one ``urllib`` attempt in
``PrometheusClient`` used to fail an entire annotator sync cycle).
Design points:

- **Full jitter** (AWS architecture-blog style): sleep is uniform in
  ``[0, min(max_delay, base * 2**attempt))`` — decorrelates retry
  storms from many annotator replicas hitting the same Prometheus.
- **Deadline budget**: the whole call (attempts + sleeps) must fit in
  ``deadline_s``; a retry that could not complete before the deadline
  is not attempted. Keeps sync cycles bounded during outages.
- **Retry-After awareness**: if the raised exception carries a
  ``retry_after_s`` attribute (429/503 with a Retry-After header, or a
  ``BreakerOpenError``), it floors the next sleep.
- Deterministic under test: RNG is a seeded ``random.Random`` and both
  ``sleep`` and ``clock`` are injectable.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type


class RetryBudgetExceeded(Exception):
    """All attempts failed (or the deadline expired). ``last`` holds the
    final underlying exception."""

    def __init__(self, attempts: int, last: Exception):
        super().__init__(
            f"retries exhausted after {attempts} attempt(s): {last!r}"
        )
        self.attempts = attempts
        self.last = last


class RetryPolicy:
    def __init__(
        self,
        *,
        max_attempts: int = 3,
        base_delay_s: float = 0.1,
        max_delay_s: float = 5.0,
        deadline_s: float = 30.0,
        retryable: Tuple[Type[BaseException], ...] = (Exception,),
        seed: Optional[int] = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.deadline_s = float(deadline_s)
        self.retryable = retryable
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._clock = clock

    def backoff_s(self, attempt: int, retry_after_s: float = 0.0) -> float:
        """Sleep before attempt ``attempt+1`` (attempt is 0-based).

        A server Retry-After is a FLOOR, not a schedule: sleeping
        exactly the advertised value re-synchronizes every client a
        mass-shed event turned away — they all come back in the same
        instant and shed again. The jitter is added ON TOP
        of the floor, so the server's minimum is always honored and
        the retry wave spreads across a full jitter window."""
        cap = min(self.max_delay_s, self.base_delay_s * (2.0**attempt))
        jittered = self._rng.uniform(0.0, cap)
        if retry_after_s > 0.0:
            return retry_after_s + jittered
        return jittered

    def call(self, fn, *args, on_retry=None, **kwargs):
        """Run ``fn`` with bounded retries. Non-retryable exceptions
        propagate immediately; exhaustion raises ``RetryBudgetExceeded``."""
        start = self._clock()
        last: Optional[Exception] = None
        for attempt in range(self.max_attempts):
            try:
                return fn(*args, **kwargs)
            except self.retryable as exc:  # noqa: PERF203
                last = exc
                if attempt + 1 >= self.max_attempts:
                    break
                retry_after = float(getattr(exc, "retry_after_s", 0.0) or 0.0)
                delay = self.backoff_s(attempt, retry_after)
                elapsed = self._clock() - start
                if elapsed + delay >= self.deadline_s:
                    break
                if on_retry is not None:
                    try:
                        on_retry(attempt, exc, delay)
                    except Exception:
                        pass
                if delay > 0:
                    self._sleep(delay)
        raise RetryBudgetExceeded(
            min(attempt + 1, self.max_attempts), last  # noqa: F821
        )
