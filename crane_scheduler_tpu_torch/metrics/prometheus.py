"""Prometheus HTTP API client with the reference's query quirks.

Copy of ``crane_scheduler_tpu/metrics/prometheus.py``.

Reproduces ``promClient`` (ref: pkg/controller/prometheus/prometheus.go):

- instant vector queries with a 10s timeout (``prometheus.go:17``);
- query templates ``metric{instance=~"IP"} /100`` with a fallback to
  ``metric{instance=~"IP:.+"} /100`` (``:50-67``) — usage values are
  fractions in [0,1] because of the ``/100``;
- the same two-step by node name has only the exact-match form (``:69-80``);
- an ``offset``-variant exists for parity but, like the reference's, has no
  callers (``:82-98``);
- result handling (``:100-128``): vector-typed results only; warnings are
  errors; negative/NaN samples clamp to 0; the *last* vector element wins;
  the value re-serialized with 5-decimal fixed formatting.

Beyond the reference:

- node IPs/names are ``re.escape``\\ d before interpolation into the
  ``instance=~"..."`` matcher — PromQL regexes are fully anchored, but a
  dotted IP like ``10.0.0.1`` would otherwise also match the lookalike
  instance ``10a0b0c1``;
- transport/server failures (connection refused, timeout, 429/5xx,
  malformed body) raise ``MetricsTransportError`` instead of being
  swallowed into "no data" — an outage must surface, not masquerade as a
  missing metric;
- each logical query runs under an optional ``RetryPolicy`` (bounded
  full-jitter backoff honoring Retry-After) and ``CircuitBreaker``
  (target ``prometheus``): the breaker sees one outcome per query, and
  while open the client fails fast without touching the network.

Uses only the stdlib (urllib) so the framework has no HTTP dependency.
"""

from __future__ import annotations

import json
import math
import re
import urllib.error
import urllib.parse
import urllib.request

from ..loadstore.codec import format_metric_value
from ..resilience.retry import RetryBudgetExceeded, RetryPolicy
from .source import MetricsQueryError, MetricsTransportError

DEFAULT_QUERY_TIMEOUT_SECONDS = 10.0  # ref: prometheus.go:17

_DEFAULT_RETRY = object()  # sentinel: build the standard policy


def _parse_retry_after(headers) -> float:
    try:
        raw = headers.get("Retry-After") if headers is not None else None
        return max(0.0, float(raw)) if raw else 0.0
    except (TypeError, ValueError):
        return 0.0


class PrometheusClient:
    def __init__(
        self,
        address: str,
        timeout: float = DEFAULT_QUERY_TIMEOUT_SECONDS,
        *,
        retry_policy=_DEFAULT_RETRY,
        breaker=None,
    ):
        self.address = address.rstrip("/")
        self.timeout = timeout
        if retry_policy is _DEFAULT_RETRY:
            retry_policy = RetryPolicy(
                max_attempts=3,
                base_delay_s=0.2,
                max_delay_s=2.0,
                deadline_s=8.0,
                retryable=(MetricsTransportError,),
            )
        self.retry_policy = retry_policy
        self.breaker = breaker

    # -- public interface (ref: prometheus.go:21-28) -----------------------

    def query_by_node_ip(self, metric_name: str, ip: str) -> str:
        pat = re.escape(ip)
        result = self._try_query(f'{metric_name}{{instance=~"{pat}"}} /100')
        if result:
            return result
        result = self._try_query(f'{metric_name}{{instance=~"{pat}:.+"}} /100')
        if result:
            return result
        raise MetricsQueryError(f"no data for {metric_name}{{instance=~{ip}}}")

    def query_by_node_name(self, metric_name: str, name: str) -> str:
        pat = re.escape(name)
        result = self._try_query(f'{metric_name}{{instance=~"{pat}"}} /100')
        if result:
            return result
        raise MetricsQueryError(f"no data for {metric_name}{{instance=~{name}}}")

    def query_all_by_metric(self, metric_name: str, offset: str | None = None) -> dict:
        """One unfiltered instant query: every instance's value at once.

        The bulk-refresh path the reference lacks — it issues
        |nodes| x |metrics| filtered queries per sync cycle
        (ref: node.go:148-177); this issues |metrics|. Returns
        {instance_label: value_string} with the same clamping and
        5-decimal rendering; the instance label may carry a port suffix
        (callers strip it when matching node IPs).

        ``offset``: PromQL offset modifier (e.g. ``"3m"``) — the bulk
        form of the reference's defined-but-never-called offset query
        (prometheus.go:82-98), used by the annotator's cold-start
        backfill.
        """
        promql = f"{metric_name} /100"
        if offset:
            promql = f"{metric_name} offset {offset} /100"
        payload = self._fetch(promql)
        if payload.get("status") != "success":
            raise MetricsQueryError(f"query error: {payload.get('error')}")
        data = payload.get("data", {})
        if data.get("resultType") != "vector":
            raise MetricsQueryError(f"illegal result type: {data.get('resultType')}")
        out: dict[str, str] = {}
        for elem in data.get("result", []):
            try:
                instance = elem["metric"].get("instance", "")
                value = float(elem["value"][1])
            except (KeyError, IndexError, TypeError, ValueError):
                continue
            if value < 0 or math.isnan(value):
                value = 0.0
            out[instance] = format_metric_value(value)  # last sample wins per instance
        return out

    def query_by_node_ip_with_offset(self, metric_name: str, ip: str, offset: str) -> str:
        pat = re.escape(ip)
        result = self._try_query(
            f'{metric_name}{{instance=~"{pat}"}} offset {offset} /100'
        )
        if result:
            return result
        result = self._try_query(
            f'{metric_name}{{instance=~"{pat}:.+"}} offset {offset} /100'
        )
        if result:
            return result
        raise MetricsQueryError(f"no data for {metric_name} offset {offset}")

    # -- internals ---------------------------------------------------------

    def _try_query(self, promql: str) -> str:
        """"" when the query answered with no data; protocol anomalies on
        a *healthy* server also fall through to the fallback query —
        but transport/server failures propagate (an
        outage must not masquerade as a missing metric)."""
        try:
            return self._query(promql)
        except MetricsTransportError:
            raise
        except MetricsQueryError:
            return ""

    def _query(self, promql: str) -> str:
        payload = self._fetch(promql)
        if payload.get("status") != "success":
            raise MetricsQueryError(f"query error: {payload.get('error')}")
        if payload.get("warnings"):
            raise MetricsQueryError(f"unexpected warnings: {payload['warnings']}")
        data = payload.get("data", {})
        if data.get("resultType") != "vector":
            raise MetricsQueryError(f"illegal result type: {data.get('resultType')}")

        metric_value = ""
        for elem in data.get("result", []):
            try:
                value = float(elem["value"][1])
            except (KeyError, IndexError, TypeError, ValueError):
                continue
            if value < 0 or math.isnan(value):
                value = 0.0
            metric_value = format_metric_value(value)  # last element wins
        return metric_value

    def _fetch(self, promql: str) -> dict:
        """One logical query = one breaker outcome; the retry policy runs
        *inside* the breaker so a query that eventually succeeds counts
        as a success."""
        breaker = self.breaker
        if breaker is not None and not breaker.allow():
            raise MetricsTransportError(
                f"prometheus breaker open ({promql})",
                retry_after_s=breaker.retry_after_s(),
            )
        try:
            if self.retry_policy is None:
                payload = self._fetch_once(promql)
            else:
                try:
                    payload = self.retry_policy.call(self._fetch_once, promql)
                except RetryBudgetExceeded as e:
                    raise e.last from e
        except MetricsTransportError:
            if breaker is not None:
                breaker.record_failure()
            raise
        if breaker is not None:
            breaker.record_success()
        return payload

    def _fetch_once(self, promql: str) -> dict:
        url = f"{self.address}/api/v1/query?" + urllib.parse.urlencode({"query": promql})
        try:
            with urllib.request.urlopen(url, timeout=self.timeout) as resp:
                return json.load(resp)
        except urllib.error.HTTPError as e:
            raise MetricsTransportError(
                f"query failed: HTTP {e.code}",
                retry_after_s=_parse_retry_after(e.headers),
            ) from e
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise MetricsTransportError(f"query failed: {e}") from e
