"""The port's metrics sources and retry policy against the JAX package's.

Each case runs the same call sequence through
``crane_scheduler_tpu.metrics`` / ``resilience.retry`` and
``crane_scheduler_tpu_torch.metrics`` / ``resilience.retry`` on inputs
seeded with numpy, and compares every answer, exception, query string and
backoff sleep. The Prometheus client runs against an in-process stub HTTP
server, as ``tests/test_prometheus.py`` does. Tolerance: exact.
"""

import json
import signal
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import pytest

from crane_scheduler_tpu.metrics import FakeMetricsSource as RefFake
from crane_scheduler_tpu.metrics import PrometheusClient as RefProm
from crane_scheduler_tpu.metrics.source import MetricsTransportError as RefTransport
from crane_scheduler_tpu.resilience import CircuitBreaker as RefBreaker
from crane_scheduler_tpu.resilience import RetryPolicy as RefRetry
from crane_scheduler_tpu.resilience.retry import RetryBudgetExceeded as RefBudget
from crane_scheduler_tpu_torch.metrics import (
    FakeMetricsSource,
    MetricsQueryError,
    MetricsSource,
    MetricsTransportError,
    PrometheusClient,
)
from crane_scheduler_tpu_torch.resilience import CircuitBreaker, RetryPolicy
from crane_scheduler_tpu_torch.resilience.retry import RetryBudgetExceeded

METRICS = ("cpu_usage_avg_5m", "mem_usage_avg_5m")


@pytest.fixture(autouse=True)
def _time_limit():
    """Every case here talks to a socket: fail it after 60 s instead of
    hanging the suite."""
    def expire(signum, frame):
        raise TimeoutError("test case exceeded its 60 s limit")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(60)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


def outcome(fn, *args, **kw):
    """``("ok", value)`` or ``("err", exception class name, message)``."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 - the class is compared
        return ("err", type(e).__name__, str(e))


# -- FakeMetricsSource ---------------------------------------------------------


def fill_fake(src, seed):
    rng = np.random.default_rng(seed)
    hosts = [f"10.0.0.{i}" for i in range(12)]
    for m in METRICS:
        for i, h in enumerate(hosts):
            v = float(rng.choice([rng.random(), -0.2, float("nan"), 1.7]))
            src.set(m, h, v, by="ip")
            src.set(m, f"node-{i}", v + 0.5, by="name")
    # a synthetic stream and per-key faults
    calls = [0]

    def stream():
        calls[0] += 1
        return 0.125 * calls[0]

    src.set(METRICS[0], "10.0.0.99", stream, by="both")
    src.fail(METRICS[0], hosts[3], by="ip")
    src.fail(METRICS[1], "node-5", by="name")
    src.set_offset_column(METRICS[1], "180s", {h: rng.random() for h in hosts})
    return hosts


@pytest.mark.parametrize("seed", [0, 1])
def test_fake_source_answers_equal_reference(seed):
    ref, port = RefFake(), FakeMetricsSource()
    hosts = fill_fake(ref, seed)
    assert fill_fake(port, seed) == hosts
    assert isinstance(port, MetricsSource)
    for m in METRICS:
        for h in hosts + ["10.0.0.99", "missing"]:
            r, p = (outcome(s.query_by_node_ip, m, h) for s in (ref, port))
            assert p == r, (m, h)
        for i in range(13):
            r, p = (outcome(s.query_by_node_name, m, f"node-{i}") for s in (ref, port))
            assert p == r, (m, i)
        assert port.query_all_by_metric(m) == ref.query_all_by_metric(m)
        r, p = (outcome(s.query_all_by_metric, m, offset="180s") for s in (ref, port))
        assert p == r and p[0] == ("ok" if m == METRICS[1] else "err")
    assert (port.ip_queries, port.name_queries) == (ref.ip_queries, ref.name_queries)
    ref.clear_failures()
    port.clear_failures()
    assert port.query_all_by_metric(METRICS[0]) == ref.query_all_by_metric(METRICS[0])


@pytest.mark.parametrize("form", ["dict", "aligned"])
def test_fake_source_column_provider_and_faults(form):
    rng = np.random.default_rng(7)
    hosts = [f"10.1.0.{i}" for i in range(20)]
    vals = [f"{v:.5f}" for v in rng.random(20)]

    def column():
        return dict(zip(hosts, vals)) if form == "dict" else (list(hosts), list(vals))

    ref, port = RefFake(), FakeMetricsSource()
    for s in (ref, port):
        s.set_column(METRICS[0], column)
    out = port.query_all_by_metric(METRICS[0])
    assert out == ref.query_all_by_metric(METRICS[0])
    for s in (ref, port):
        s.fail(METRICS[0], hosts[4], by="ip")
    # with a fault the aligned form comes back as a mapping without the row
    out = port.query_all_by_metric(METRICS[0])
    assert out == ref.query_all_by_metric(METRICS[0]) and hosts[4] not in out
    # a per-instance set after the column drops the provider
    for s in (ref, port):
        s.set(METRICS[0], hosts[0], 0.5, by="ip")
    assert port.query_all_by_metric(METRICS[0]) == ref.query_all_by_metric(METRICS[0])


# -- RetryPolicy ---------------------------------------------------------------


@pytest.mark.parametrize("retry_after", [0.0, 0.75])
def test_retry_backoff_sequence_equals_reference(retry_after):
    ref = RefRetry(seed=11, base_delay_s=0.1, max_delay_s=2.0)
    port = RetryPolicy(seed=11, base_delay_s=0.1, max_delay_s=2.0)
    for attempt in range(10):
        assert port.backoff_s(attempt, retry_after) == ref.backoff_s(attempt, retry_after)


@pytest.mark.parametrize("fail_times,deadline", [(2, 30.0), (9, 30.0), (9, 0.5)])
def test_retry_call_sleeps_and_budget_equal_reference(fail_times, deadline):
    def run(policy_cls, budget_cls):
        sleeps, retries = [], []
        clock = [0.0]

        def sleep(s):
            sleeps.append(s)
            clock[0] += s

        policy = policy_cls(max_attempts=5, base_delay_s=0.2, max_delay_s=1.0,
                            deadline_s=deadline, retryable=(ValueError,),
                            seed=3, sleep=sleep, clock=lambda: clock[0])
        calls = [0]

        def fn():
            calls[0] += 1
            if calls[0] <= fail_times:
                err = ValueError(f"attempt {calls[0]}")
                err.retry_after_s = 0.1 * calls[0]
                raise err
            return calls[0]

        try:
            res = ("ok", policy.call(fn, on_retry=lambda a, e, d: retries.append((a, d))))
        except budget_cls as e:
            res = ("budget", e.attempts, str(e.last))
        return res, sleeps, retries, calls[0]

    assert run(RetryPolicy, RetryBudgetExceeded) == run(RefRetry, RefBudget)


def test_retry_does_not_retry_other_errors():
    for cls in (RetryPolicy, RefRetry):
        policy = cls(retryable=(ValueError,), sleep=lambda s: None)
        with pytest.raises(KeyError):
            policy.call(lambda: {}["x"])


# -- PrometheusClient ----------------------------------------------------------


class StubProm(BaseHTTPRequestHandler):
    """Scripted Prometheus: ``responses`` maps PromQL to a payload, and
    ``faults`` is a queue of ``(status, retry_after)`` answered first."""

    responses: dict = {}
    faults: list = []
    queries: list = []

    def do_GET(self):
        cls = type(self)
        q = parse_qs(urlparse(self.path).query).get("query", [""])[0]
        cls.queries.append(q)
        if cls.faults:
            status, retry_after = cls.faults.pop(0)
            body = b"{}"
            self.send_response(status)
            if retry_after is not None:
                self.send_header("Retry-After", str(retry_after))
        else:
            payload = cls.responses.get(q, vector())
            body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
            self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def vector(*samples):
    """Samples are ``(instance, value)`` pairs or bare values."""
    result = []
    for s in samples:
        inst, v = s if isinstance(s, tuple) else ("", s)
        result.append({"metric": {"instance": inst} if inst else {}, "value": [0, str(v)]})
    return {"status": "success", "data": {"resultType": "vector", "result": result}}


@pytest.fixture()
def stub():
    StubProm.responses, StubProm.faults, StubProm.queries = {}, [], []
    server = HTTPServer(("127.0.0.1", 0), StubProm)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()
    t.join(timeout=10)


def seeded_responses(seed):
    rng = np.random.default_rng(seed)
    m = METRICS[0]
    return {
        f'{m}{{instance=~"10\\.0\\.0\\.1"}} /100': vector(rng.random(), -0.5),
        f'{m}{{instance=~"10\\.0\\.0\\.2:.+"}} /100': vector(float("nan")),
        f'{m}{{instance=~"node\\-3"}} /100': vector(rng.random()),
        f'{m}{{instance=~"10\\.0\\.0\\.4"}} /100': {
            "status": "success", "warnings": ["w"], "data": {"resultType": "vector", "result": []}},
        f'{m}{{instance=~"10\\.0\\.0\\.5"}} /100': {
            "status": "success", "data": {"resultType": "matrix", "result": []}},
        f'{m}{{instance=~"10\\.0\\.0\\.6"}} /100': {"status": "error", "error": "bad"},
        f"{m} /100": vector(("10.0.0.1", rng.random()), ("10.0.0.2:9100", -1),
                            ("10.0.0.1", rng.random()), ("node-3", rng.random())),
        f"{m} offset 3m /100": vector(("10.0.0.1", rng.random())),
        f'{m}{{instance=~"10\\.0\\.0\\.1"}} offset 3m /100': vector(rng.random()),
    }


SCRIPT = (
    ("query_by_node_ip", ("10.0.0.1",)),
    ("query_by_node_ip", ("10.0.0.2",)),
    ("query_by_node_ip", ("10.0.0.4",)),
    ("query_by_node_ip", ("10.0.0.5",)),
    ("query_by_node_ip", ("10.0.0.6",)),
    ("query_by_node_ip", ("10a0b0c1",)),
    ("query_by_node_name", ("node-3",)),
    ("query_by_node_name", ("node-9",)),
    ("query_all_by_metric", ()),
    ("query_all_by_metric", ("3m",)),
    ("query_by_node_ip_with_offset", ("10.0.0.1", "3m")),
)


@pytest.mark.parametrize("seed", [0, 1])
def test_prometheus_answers_and_queries_equal_reference(stub, seed):
    outs, queries = {}, {}
    for name, cls in (("ref", RefProm), ("port", PrometheusClient)):
        StubProm.responses = seeded_responses(seed)
        StubProm.queries = []
        client = cls(stub, retry_policy=None)
        outs[name] = [outcome(getattr(client, fn), METRICS[0], *args) for fn, args in SCRIPT]
        queries[name] = list(StubProm.queries)
    assert outs["port"] == outs["ref"]
    assert queries["port"] == queries["ref"]
    kinds = [o[0] if o[0] == "ok" else o[1] for o in outs["port"]]
    assert kinds.count("ok") >= 5 and "MetricsQueryError" in kinds


@pytest.mark.parametrize("faults,attempts", [
    ([(503, None), (500, None)], 3),    # two transient 5xx, then success
    ([(429, 2)], 2),                    # Retry-After floors the sleep
    ([(500, None)] * 5, 3),             # exhausted: the last error surfaces
])
def test_prometheus_retry_equal_reference(stub, faults, attempts):
    results = {}
    for name, cls, retry_cls, transport in (
        ("ref", RefProm, RefRetry, RefTransport),
        ("port", PrometheusClient, RetryPolicy, MetricsTransportError),
    ):
        StubProm.responses = {f'{METRICS[0]}{{instance=~"ip"}} /100': vector(0.5)}
        StubProm.faults = list(faults)
        StubProm.queries = []
        sleeps = []
        policy = retry_cls(max_attempts=attempts, base_delay_s=0.001, max_delay_s=0.002,
                           deadline_s=30.0, retryable=(transport,), seed=7,
                           sleep=sleeps.append)
        client = cls(stub, retry_policy=policy)
        results[name] = (outcome(client.query_by_node_ip, METRICS[0], "ip"), sleeps,
                         len(StubProm.queries))
    assert results["port"] == results["ref"]
    (out, sleeps, hits) = results["port"]
    if faults[0] == (429, 2):
        assert out == ("ok", "0.50000") and 2.0 <= sleeps[0] <= 2.002
    if len(faults) == 5:
        assert out[1] == "MetricsTransportError" and hits == 3


def test_prometheus_breaker_opens_and_fails_fast_as_reference(stub):
    hits = {}
    for name, cls, breaker_cls in (("ref", RefProm, RefBreaker),
                                   ("port", PrometheusClient, CircuitBreaker)):
        clock = [0.0]
        breaker = breaker_cls("prometheus", failure_threshold=3, window_s=60.0,
                              reset_timeout_s=30.0, clock=lambda: clock[0])
        client = cls(stub, retry_policy=None, breaker=breaker)
        StubProm.faults = [(500, None)] * 3
        StubProm.queries = []
        seen = [outcome(client.query_by_node_ip, METRICS[0], "ip")[1] for _ in range(4)]
        state = breaker.state
        clock[0] = 31.0  # half-open: one probe goes through and heals
        healed = outcome(client.query_all_by_metric, METRICS[0])
        hits[name] = (seen, str(state), len(StubProm.queries), healed, str(breaker.state))
    assert hits["port"] == hits["ref"]
    assert hits["port"][1] == "open" and hits["port"][2] == 4


def test_connection_refused_is_transport_error():
    client = PrometheusClient("http://127.0.0.1:1", retry_policy=None, timeout=0.5)
    with pytest.raises(MetricsTransportError) as exc:
        client.query_by_node_ip("m", "ip")
    assert isinstance(exc.value, MetricsQueryError)
