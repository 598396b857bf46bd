"""The telemetry layer of the PyTorch port against the JAX package's
(``crane_scheduler_tpu.telemetry``) on the CPU: the registry's exposition,
the strict parser, spans, decision traces, the pod lifecycle and the
flight recorder on identical event sequences with injected clocks; then
both scheduler paths with telemetry on (``BatchScheduler``: ``schedule_batch``,
``schedule_pod_burst`` and both pipelined loops at depth 2 with
``overlap_refresh``; ``Scheduler``: the scalar loop, columnar
``schedule_one``, ``schedule_queue`` and ``open_queue``) against the JAX
schedulers on twin clusters made from one seed.

Tolerance: exact. Renders are byte-identical; spans, records and flight
segments are equal once trace and span ids (random per process) are
renumbered in order of first appearance. On the scheduler paths,
placements, the multiset of span names per track, every counter and
histogram count of ``registry.snapshot()`` and each decision entry are
equal, except host-time quantities: ``*_ms_total`` counters, the sums of
the seconds histograms, a decision's ``ts`` and ``staleness_seconds``.
"""

import json
import os
import random
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crane_scheduler_tpu import telemetry as jtel
from crane_scheduler_tpu.cluster import ClusterState, Node, Pod
from crane_scheduler_tpu.framework.scheduler import BatchScheduler
from crane_scheduler_tpu.policy import DEFAULT_POLICY
from crane_scheduler_tpu.telemetry import expfmt as jexpfmt
from crane_scheduler_tpu.telemetry import lifecycle as jlifecycle
from crane_scheduler_tpu_torch import cluster as pc
from crane_scheduler_tpu_torch import telemetry as ptel
from crane_scheduler_tpu_torch.framework.scheduler import BatchScheduler as PortBatchScheduler
from crane_scheduler_tpu_torch.framework.scheduler import DRIP_STAGES
from crane_scheduler_tpu_torch.framework.scheduler import Scheduler as PortScheduler
from crane_scheduler_tpu_torch.policy import DEFAULT_POLICY as PORT_POLICY
from crane_scheduler_tpu_torch.policy import compile_policy
from crane_scheduler_tpu_torch.telemetry import expfmt as pexpfmt
from crane_scheduler_tpu_torch.telemetry import lifecycle as plifecycle
from crane_scheduler_tpu_torch.utils.profiling import chrome_trace, torch_trace
from test_drip_columnar import NOW, fuzz_node_specs, fuzz_pod_specs
from test_telemetry import GOLDEN
from test_torch_delta import BUCKET, TENSORS, anno, sweep_columns
from test_torch_drip import (
    STAT_KEYS,
    assert_same_stats,
    build_cluster,
    jax_drip_reference,
    make_pod,
    outcome,
    run_mode,
)
from test_torch_overlap import Clock, annotations, bursts, pod_batches

SIDES = {"jax": jtel, "port": ptel}
TENSORS_PORT = compile_policy(PORT_POLICY)
METRICS_PORT = TENSORS_PORT.metric_names


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is faster here and leaves the
    other test workers their cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class FakeClock:
    """A clock that advances by a fixed step at every read."""

    def __init__(self, start: float = 100.0, step: float = 0.25):
        self.t = start - step
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def normalise_ids(obj):
    """Renumber every trace/span id (32 or 16 lowercase hex chars, or a
    flow id derived from one) in order of first appearance."""
    seen: dict = {}

    def walk(x, key=None):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if isinstance(x, str) and len(x) in (16, 32) and all(c in "0123456789abcdef" for c in x):
            return seen.setdefault(x, f"id{len(seen)}")
        if key == "id" and isinstance(x, int):
            return seen.setdefault(("flow", x), f"flow{len(seen)}")
        if isinstance(x, str) and x.startswith("00-") and len(x) == 55:
            return "-".join(walk(p) for p in x.split("-"))
        return x

    return walk(obj)


# -- registry and exposition ---------------------------------------------------


def golden_registry(tel):
    """``tests/test_telemetry.py``'s golden registry, on either package."""
    reg = tel.MetricsRegistry()
    c = reg.counter("crane_demo_requests_total", "Requests served", ("code",))
    c.labels(code="200").inc(41)
    c.labels(code="500").inc()
    g = reg.gauge("crane_demo_nodes", "Rows in the store")
    g.set(12)
    h = reg.histogram("crane_demo_latency_seconds", "Request latency",
                      buckets=(0.001, 0.01, 0.1, 1.0))
    for v in (0.0005, 0.0005, 0.05, 0.5, 2.0):
        h.observe(v)
    esc = reg.gauge("crane_demo_escapes", 'Help with \\ and "quotes"', ("path",))
    esc.labels(path='with"quote\nand\\slash').set(1)
    return reg


def test_golden_render_is_byte_identical():
    with open(GOLDEN) as f:
        golden = f.read()
    port, ref = golden_registry(ptel), golden_registry(jtel)
    assert port.render() == golden
    assert port.render(openmetrics=True) == ref.render(openmetrics=True)
    assert port.snapshot() == ref.snapshot()


LABEL_VALUES = ["a", "", 'q"uote', "back\\slash", "new\nline", "ünï", "  spaced  ", "x" * 40]
AMOUNTS = [0, 1, 2.5, 1e-3, 7.0, 123456.789, 2.5e16, 1 / 3]
GAUGE_VALUES = [-4, 0, 3.25, float("inf"), float("-inf"), float("nan"), 1e20, -0.0]


def random_registry_ops(seed: int) -> list:
    """A seeded sequence of counter/gauge/histogram operations over a few
    families with escaped label values, exemplars included."""
    rng = random.Random(seed)
    families = []
    for i in range(rng.randrange(3, 7)):
        kind = rng.choice(["counter", "gauge", "histogram"])
        labels = tuple(f"l{j}" for j in range(rng.randrange(0, 3)))
        buckets = None
        if kind == "histogram" and rng.random() < 0.5:
            buckets = tuple(sorted(rng.sample([0.001, 0.01, 0.1, 0.5, 1, 10, 100], 4)))
        families.append((kind, f"crane_fuzz_{kind}_{i}", f"help {i} \\ with\nnewline",
                         labels, buckets))
    ops = []
    for _ in range(rng.randrange(20, 60)):
        kind, name, help_, labels, buckets = rng.choice(families)
        values = tuple(rng.choice(LABEL_VALUES) for _ in labels)
        if kind == "counter":
            ops.append((kind, name, help_, labels, buckets, values, "inc", rng.choice(AMOUNTS)))
        elif kind == "gauge":
            op = rng.choice(["set", "inc", "dec"])
            amount = rng.choice(GAUGE_VALUES) if op == "set" else rng.choice(AMOUNTS)
            ops.append((kind, name, help_, labels, buckets, values, op, amount))
        else:
            ex = {"trace_id": f"t{rng.randrange(9)}"} if rng.random() < 0.3 else None
            ops.append((kind, name, help_, labels, buckets, values, "observe",
                        (rng.choice([1e-5, 0.003, 0.2, 0.7, 5.0, 1e4]), ex)))
    return ops


def apply_ops(tel, ops):
    reg = tel.MetricsRegistry()
    for kind, name, help_, labels, buckets, values, op, arg in ops:
        if kind == "histogram":
            fam = reg.histogram(name, help_, labels, buckets=buckets)
            value, ex = arg
            fam.labels(*values).observe(value, exemplar=ex)
        else:
            fam = getattr(reg, kind)(name, help_, labels)
            getattr(fam.labels(*values), op)(arg)
    return reg


@pytest.mark.parametrize("seed", range(6))
def test_random_registry_ops_render_identically(seed, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_753_776_000.125)  # exemplar stamps
    ops = random_registry_ops(seed)
    port, ref = apply_ops(ptel, ops), apply_ops(jtel, ops)
    for openmetrics in (False, True):
        text = port.render(openmetrics=openmetrics)
        assert text == ref.render(openmetrics=openmetrics)
    assert repr(port.snapshot()) == repr(ref.snapshot())
    text = port.render()
    assert repr(pexpfmt.parse_exposition(text)) == repr(jexpfmt.parse_exposition(text))


def test_parser_agrees_on_golden_and_render_round_trips():
    with open(GOLDEN) as f:
        golden = f.read()
    assert pexpfmt.parse_exposition(golden) == jexpfmt.parse_exposition(golden)
    text = golden_registry(ptel).render(openmetrics=True)
    assert repr(pexpfmt.parse_exposition(text)) == repr(jexpfmt.parse_exposition(text))


_GOOD = golden_registry(jtel).render()
MALFORMED = [
    _GOOD + "no_type_declared 1\n",
    _GOOD.rstrip("\n"),
    "# TYPE x counter\nx 1\nx 1\n",
    "# TYPE x counter\nx -1\n",
    '# TYPE h histogram\nh_bucket{le="0.1"} 5\nh_bucket{le="1"} 3\n'
    'h_bucket{le="+Inf"} 3\nh_sum 1\nh_count 3\n',
    '# TYPE h histogram\nh_bucket{le="0.1"} 1\nh_sum 1\nh_count 1\n',
    '# TYPE t gauge\nt{p="a\\tb"} 1\n',
    '# TYPE t gauge\nt{p="a\\\n',
    "# TYPE c counter\nc +Inf\n",
    "# TYPE c counter\nc -Inf\n",
    "# TYPE c counter\nc NaN\n",
    '# TYPE c_total counter\nc_total 3 # {trace_id="abc"} 1\n',
    '# TYPE h histogram\nh_bucket{le="+Inf"} 1 # {t="x"} +Inf\nh_sum 1\nh_count 1\n',
    "# TYPE t counter\nt 1\n# TYPE t counter\n",
    "t_other 2\n# TYPE t_other gauge\n",
]


@pytest.mark.parametrize("payload", MALFORMED, ids=[f"m{i}" for i in range(len(MALFORMED))])
def test_parser_rejects_what_the_reference_rejects(payload):
    with pytest.raises(jexpfmt.ExpositionError) as want:
        jexpfmt.parse_exposition(payload)
    with pytest.raises(pexpfmt.ExpositionError) as got:
        pexpfmt.parse_exposition(payload)
    assert str(got.value) == str(want.value) and got.value.lineno == want.value.lineno


# -- tracing, spans, decisions -------------------------------------------------

TRACEPARENTS = [
    None, "", "garbage", "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "ab" * 16 + "-" + "cd" * 8, "00-" + "0" * 32 + "-" + "cd" * 8 + "-01",
    "00-" + "ab" * 16 + "-" + "0" * 16 + "-01", "ff-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01-extra", "01-" + "ab" * 16 + "-" + "cd" * 8 + "-01-x",
    "00-" + "AB" * 16 + "-" + "cd" * 8 + "-01", " 00-" + "ab" * 16 + "-" + "cd" * 8 + "-0f ",
]


def test_traceparent_parse_and_format_match():
    for value in TRACEPARENTS:
        want = jtel.tracing.parse_traceparent(value)
        got = ptel.tracing.parse_traceparent(value)
        assert (got is None) == (want is None), value
        if want is not None:
            assert (got.trace_id, got.span_id) == (want.trace_id, want.span_id)
            assert (ptel.tracing.format_traceparent(got)
                    == jtel.tracing.format_traceparent(want))
    ctx = ptel.tracing.new_context()
    assert ptel.tracing.current() is None
    with ptel.tracing.use(ctx):
        with ptel.tracing.use(None):
            assert ptel.tracing.current() is ctx
        child = ctx.child()
        assert child.trace_id == ctx.trace_id and child.span_id != ctx.span_id
    assert ptel.tracing.current() is None


def span_scenario(tel, tmp_path, side):
    rec = tel.SpanRecorder(capacity=64, clock=FakeClock())
    with rec.span("outer", track="loop"):
        with rec.span("inner", track="loop", rows=7):
            pass
    rec.record("explicit", 101.0, 102.5, track="t2", args={"a": 1})
    ctx = tel.tracing.new_context()
    with tel.tracing.use(ctx):
        with rec.span("traced_a", track="x"):
            with rec.span("traced_b", track="y", k="v"):
                pass
        rec.record("traced_record", 103.0, 103.5, track="z")
    with rec.span("explicit_ctx", track="x", ctx=ctx):
        pass
    with rec.span("default_track"):
        pass
    drained, cursor = rec.drain_since(2)
    path = tmp_path / f"{side}.json"
    n = rec.dump(str(path))
    small = tel.SpanRecorder(capacity=3, clock=FakeClock())
    for i in range(7):
        small.record(f"s{i}", 100.0 + i, 100.5 + i)
    return {
        "trace": rec.export_chrome_trace(), "drained": drained, "cursor": cursor,
        "dumped": json.loads(path.read_text()), "n": n, "len": len(rec),
        "recorded": rec.recorded, "ring": small.export_chrome_trace(),
        "ring_len": len(small), "ring_recorded": small.recorded,
        "ring_drain": small.drain_since(0),
    }


def test_span_recorder_matches(tmp_path):
    want = normalise_ids(span_scenario(jtel, tmp_path, "jax"))
    got = normalise_ids(span_scenario(ptel, tmp_path, "port"))
    assert got == want
    assert any(e["ph"] == "s" for e in got["trace"]["traceEvents"])  # flows present
    assert not list(tmp_path.glob(".spans-*"))  # dump left no temp file


def decision_scenario(tel):
    buf = tel.DecisionTraceBuffer(capacity=3, sample_every=2, clock=FakeClock())
    kept = []
    builds = []
    for i in range(9):
        if i % 3 == 0:
            kept.append(buf.record(pod=f"ns/p{i}", node=f"n{i}", feasible=i,
                                   top_scores=[("n1", 7.0), ("n2", 3)], source="drip",
                                   extra_field=i))
        else:
            def build(i=i):
                builds.append(i)
                return {"pod": f"ns/p{i}", "node": None, "reason": "r", "feasible": 0,
                        "top_scores": (), "staleness_seconds": 1.23456789,
                        "source": "burst", "counts_top": {"n": i}}

            kept.append(buf.offer(build))
    return {"kept": kept, "builds": builds, "snapshot": buf.snapshot(),
            "last": buf.snapshot(limit=1), "stats": buf.stats(),
            "drain": buf.drain_since(2)}


def test_decision_buffer_matches():
    assert decision_scenario(ptel) == decision_scenario(jtel)
    with pytest.raises(ValueError):
        ptel.DecisionTraceBuffer(sample_every=0)


# -- lifecycle and flight recorder -------------------------------------------------


def lifecycle_scenario(tel, lifecycle_mod, directory):
    wall, mono = FakeClock(1_753_776_000.0, 0.5), FakeClock(10.0, 0.125)
    reg = tel.MetricsRegistry()
    spans = tel.SpanRecorder(clock=mono)
    flight = tel.FlightRecorder(str(directory), max_segment_bytes=900, max_segments=3)
    lc = tel.PodLifecycleTracker(registry=reg, spans=spans, capacity=4, completed_capacity=3,
                                 batch_sample=2, clock=wall, mono=mono, flight=flight)
    roots = [lc.seen("ns/a")]
    lc.stage("ns/a", "filtered")
    lc.stage("ns/a", "scored", node="n1", cycle_trace="ct", anno_ts=5.0)
    lc.posted("ns/a", node="n1")
    lc.confirmed("ns/a", node="n1")  # finalizes
    tracked = lc.seen_batch(["ns/b", "ns/c", "ns/d"], source="burst")
    lc.stage_batch(tracked, "scored", cycle_trace="cyc", anno_ts=7.0)
    lc.confirmed_batch([("ns/b", "n2")])  # before the post: waits for it
    lc.posted_batch([("ns/b", "n2"), ("ns/c", "n3"), ("ns/zz", "n9")])
    lc.evicted("ns/b", reason="load")
    roots.append(lc.seen("ns/b"))  # attempt 2 on the same trace
    lc.evicted("ns/q")  # eviction-only record
    lc.rearm("ns/e", "ab" * 16, attempt=3)
    roots.append(lc.seen("ns/e"))
    tp = [lc.traceparent("ns/e"), lc.traceparent("ns/nope"),
          lc.traceparent_batch(["ns/e", "ns/c", "ns/x"])]
    for i in range(6):  # past capacity: the oldest live records drop
        lc.seen(f"ns/f{i}")
    lc.stage("ns/untracked", "scored")
    flight.write_many("span", spans.drain_since(0)[0])
    flight.close()
    records = lc.records()
    return {
        "roots": [(r.trace_id, r.span_id) for r in roots], "tracked": tracked, "tp": tp,
        "records": records, "last": lc.records(limit=1), "stats": lc.stats(),
        "live": lc.live_count(), "snapshot": lc.snapshot(limit=2),
        "render": reg.render(), "spans": spans.export_chrome_trace(),
        "segments": sorted(os.listdir(directory)),
        "flight": list(tel.FlightRecorder.read(str(directory))),
        "slo": lifecycle_mod.slo_report(records, target_seconds=0.3),
        "slo_none": lifecycle_mod.slo_report([]),
        "percentile": lifecycle_mod.percentile([3, 1, 2, 5], 0.5),
    }


def test_lifecycle_tracker_and_flight_recorder_match(tmp_path):
    want = lifecycle_scenario(jtel, jlifecycle, tmp_path / "jax")
    got = lifecycle_scenario(ptel, plifecycle, tmp_path / "port")
    assert normalise_ids(got) == normalise_ids(want)
    assert len(got["segments"]) > 1  # rotation ran
    # a torn tail is skipped alike
    for side in ("jax", "port"):
        seg = sorted((tmp_path / side).iterdir())[-1]
        with open(seg, "a") as f:
            f.write('{"kind": "lifecycle", "pod": "ns/tor')
    got_read = list(ptel.FlightRecorder.read(str(tmp_path / "port")))
    assert normalise_ids(got_read) == normalise_ids(
        list(jtel.FlightRecorder.read(str(tmp_path / "jax"))))
    assert not any(r.get("pod") == "ns/tor" for r in got_read)
    assert list(ptel.FlightRecorder.read(str(tmp_path / "absent"))) == []


def test_bundle_flight_flush_and_globals(tmp_path, monkeypatch):
    monkeypatch.setenv("CRANE_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("CRANE_FLIGHT_FSYNC", "1")
    tel = ptel.Telemetry(decision_sample_every=1)
    assert tel.flight is not None and tel.flight.fsync
    tel._flight_stop.set()  # the once-a-second pump must not drain before the asserts
    with ptel.maybe_span(tel, "stage", rows=3):
        pass
    tel.decisions.record(pod="ns/p", node="n")
    assert tel.flush_flight() == {"spans": 1, "decisions": 1}
    assert tel.flush_flight() == {"spans": 0, "decisions": 0}  # incremental cursors
    kinds = sorted(r["kind"] for r in ptel.FlightRecorder.read(str(tmp_path / "flight")))
    assert kinds == ["decision", "span"]
    assert tel.render_prometheus() == "" and tel.export_chrome_trace()["traceEvents"]
    # maybe_span without telemetry is the one shared null context
    assert ptel.maybe_span(None, "x", a=1) is ptel.maybe_span(None, "y")
    monkeypatch.delenv("CRANE_FLIGHT_DIR")
    assert ptel.Telemetry().flight is None


# -- the scheduler paths -------------------------------------------------------

# what only the port records: the drip window's stage spans and the GC
# pause families (tests/test_torch_drip_stages.py holds them)
PORT_ONLY = DRIP_STAGES + ("crane_gc_pause_seconds_total", "crane_gc_collections_total")


def track_names(tel) -> dict:
    """Sorted span names per track, the port-only ones left out."""
    events = tel.export_chrome_trace()["traceEvents"]
    tracks = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    out: dict = {}
    for e in events:
        if e["ph"] == "X" and e["name"] not in PORT_ONLY:
            out.setdefault(tracks[e["tid"]], []).append(e["name"])
    return {k: sorted(v) for k, v in out.items()}


def comparable_snapshot(tel) -> dict:
    return {k: v for k, v in tel.registry.snapshot().items()
            if "_ms_total" not in k and not (k.startswith(("crane_bind_flush_window_seconds_sum",
                                                            "crane_drip_kernel_seconds_sum")))
            and k.split("{")[0] not in PORT_ONLY}


def comparable_decisions(tel) -> list:
    return [{k: v for k, v in d.items() if k not in ("ts", "staleness_seconds")}
            for d in tel.decisions.snapshot()]


def assert_same_telemetry(want, got):
    assert track_names(got) == track_names(want)
    assert comparable_snapshot(got) == comparable_snapshot(want)
    assert comparable_decisions(got) == comparable_decisions(want)
    pexpfmt.parse_exposition(got.render_prometheus())
    pexpfmt.parse_exposition(got.render_prometheus(openmetrics=True))


RESULT_GAP_S = 0.15  # between results: each background refresh and bind window ends


def burst_twin(side, dtype, tel):
    clock = Clock()
    if side == "jax":
        cluster = ClusterState()
        for name, anno in annotations(300, 5):
            cluster.add_node(Node(name=name, annotations=dict(anno)))
        return BatchScheduler(cluster, DEFAULT_POLICY, clock=clock, snapshot_bucket=64,
                              dtype={"f32": jnp.float32, "f64": jnp.float64}[dtype],
                              telemetry=tel)
    cluster = pc.ClusterState()
    for name, anno in annotations(300, 5):
        cluster.add_node(pc.Node(name=name, annotations=dict(anno)))
    return PortBatchScheduler(cluster, PORT_POLICY, clock=clock, snapshot_bucket=64,
                              device="cpu", telemetry=tel,
                              dtype={"f32": torch.float32, "f64": torch.float64}[dtype])


def drive_burst_path(sched, overlap_bind: bool) -> list:
    """``schedule_batch``, ``schedule_pod_burst`` and both pipelined loops
    at depth 2 with ``overlap_refresh``, the clock moving between entries."""
    pod_cls = Pod if isinstance(sched, BatchScheduler) else pc.Pod
    out = []
    pods = [pod_cls(name=f"single-{i}", namespace="ns") for i in range(60)]
    sched.cluster.add_pods(pods)
    r = sched.schedule_batch(pods)
    out.append((r.assignments, r.unassigned))
    sched._clock.t += 7.0
    out.append(np.asarray(sched.schedule_pod_burst("ns", [f"one-{i}" for i in range(90)])
                          .node_idx).tolist())
    sched._clock.t += 7.0
    batches = pod_batches(pod_cls, "pb", k=3)
    for b in batches:
        sched.cluster.add_pods(b)
    for r in sched.schedule_batches_pipelined(batches, depth=2, overlap_refresh=True,
                                              overlap_bind=overlap_bind):
        time.sleep(RESULT_GAP_S)
        out.append((r.assignments, r.unassigned))
    sched._clock.t += 7.0
    for r in sched.schedule_bursts_pipelined(bursts("bb", k=3), depth=2, overlap_refresh=True,
                                             overlap_bind=overlap_bind):
        time.sleep(RESULT_GAP_S)
        out.append(r)
    # consumed: every bind has settled
    return [np.asarray(x.node_idx).tolist() if hasattr(x, "node_idx") else x for x in out]


@pytest.mark.parametrize("overlap_bind", [False, True], ids=["bind", "overlap_bind"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_burst_path_telemetry_matches(dtype, overlap_bind):
    tels = {"jax": jtel.Telemetry(), "port": ptel.Telemetry()}
    scheds = {side: burst_twin(side, dtype, tels[side]) for side in tels}
    placed = {side: drive_burst_path(s, overlap_bind) for side, s in scheds.items()}
    assert placed["port"] == placed["jax"]
    assert_same_telemetry(tels["jax"], tels["port"])
    port, tel = scheds["port"], tels["port"]
    tracks = track_names(tel)
    assert {"MainThread", "d2h-prefetch_0", "overlap-refresh_0", "lifecycle"} <= set(tracks)
    assert ("bind-flush" in tracks) == overlap_bind
    if dtype == "f32":
        assert "risk_rescan" in tracks["MainThread"]
    # the registry mirrors refresh_stats
    snap = tel.registry.snapshot()
    assert sum(v for k, v in snap.items() if k.startswith("crane_refresh_path_total")) == sum(
        port.refresh_stats[k] for k in ("hit", "columns", "delta", "full"))
    assert snap["crane_refresh_ingest_ms_total"] == pytest.approx(port.refresh_stats["ingest_ms"])
    # one decision per cycle, read from host arrays
    decisions = tel.decisions.snapshot()
    assert [d["source"] for d in decisions] == ["batch", "burst"] + ["batch"] * 3 + ["burst"] * 3
    assert port.last_anno_ts == scheds["jax"].last_anno_ts is not None


def update_twins(dtype, direct, tels):
    """Twin clusters of 90 nodes (in direct mode, twin stores the test
    writes) with the JAX ``BatchScheduler`` and the port's, each on its
    telemetry."""
    from crane_scheduler_tpu.loadstore import NodeLoadStore
    from crane_scheduler_tpu_torch.loadstore import NodeLoadStore as PortStore

    rng = random.Random(7)
    clock = Clock()
    out = {}
    for side in ("jax", "port"):
        port = side == "port"
        cluster = pc.ClusterState() if port else ClusterState()
        node_cls = pc.Node if port else Node
        rng.seed(7)
        for i in range(90):
            cluster.add_node(node_cls(name=f"node-{i:03d}", annotations=anno(rng, clock.t)))
        kw = {}
        if direct:
            kw = dict(store=PortStore(TENSORS_PORT) if port else NodeLoadStore(TENSORS),
                      refresh_from_cluster=False)
            for node in cluster.list_nodes():
                kw["store"].ingest_node_annotations(node.name, node.annotations)
        if port:
            out[side] = PortBatchScheduler(
                cluster, PORT_POLICY, clock=clock, snapshot_bucket=BUCKET, device="cpu",
                dtype={"f32": torch.float32, "f64": torch.float64}[dtype],
                telemetry=tels[side], **kw)
        else:
            out[side] = BatchScheduler(
                cluster, DEFAULT_POLICY, clock=clock, snapshot_bucket=BUCKET,
                dtype={"f32": jnp.float32, "f64": jnp.float64}[dtype],
                telemetry=tels[side], **kw)
    return out, clock


@pytest.mark.parametrize("direct", [False, True], ids=["cluster", "direct"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_update_paths_telemetry_matches(dtype, direct):
    """Bursts after annotation patches (the delta path) or annotator
    sweeps and single store writes (direct mode: the column and delta
    paths) record the same upload spans, counters and decisions."""
    tels = {"jax": jtel.Telemetry(), "port": ptel.Telemetry()}
    scheds, clock = update_twins(dtype, direct, tels)
    rng, nprng = random.Random(3), np.random.default_rng(3)
    placed = {"jax": [], "port": []}
    for cycle in range(6):
        names = [n.name for n in scheds["port"].cluster.list_nodes()]
        if cycle and direct:
            stores = (scheds["jax"].store, scheds["port"].store)
            if cycle % 2:
                sweep_columns(stores, len(names), nprng, clock.t, partial=cycle == 3,
                              uniform=True)
            else:
                for name in rng.sample(names, 3):
                    for st in stores:
                        st.set_metric(name, METRICS_PORT[cycle % len(METRICS_PORT)],
                                      0.25 * (cycle % 4), clock.t)
        elif cycle:
            per = {name: anno(rng, clock.t) for name in rng.sample(names, 5)}
            for side in scheds:
                scheds[side].cluster.patch_node_annotations_bulk(
                    {k: dict(v) for k, v in per.items()})
        for side, sched in scheds.items():
            r = sched.schedule_pod_burst("ns", [f"u{cycle}-{i}" for i in range(70)])
            placed[side].append(np.asarray(r.node_idx).tolist())
        clock.t += 11.0
    assert placed["port"] == placed["jax"]
    assert_same_telemetry(tels["jax"], tels["port"])
    spans = track_names(tels["port"])["MainThread"]
    assert ("h2d_columns" in spans) == direct and "h2d_delta" in spans
    assert ("risk_rescan" in spans) == (dtype == "f32")


def drip_twin(side, node_specs, tel, columnar=True):
    from crane_scheduler_tpu.fit import FitTracker, ResourceFitPlugin
    from crane_scheduler_tpu.framework.scheduler import Scheduler
    from crane_scheduler_tpu.plugins import DynamicPlugin
    from crane_scheduler_tpu_torch.fit import FitTracker as PFitTracker
    from crane_scheduler_tpu_torch.fit import ResourceFitPlugin as PFitPlugin
    from crane_scheduler_tpu_torch.plugins import DynamicPlugin as PDynamicPlugin

    cluster = build_cluster(side, node_specs)
    clock = lambda: NOW  # noqa: E731
    if side == "jax":
        sched = Scheduler(cluster, clock=clock, columnar=columnar, telemetry=tel)
        sched.register(ResourceFitPlugin(FitTracker(cluster, telemetry=tel)), weight=1)
        sched.register(DynamicPlugin(DEFAULT_POLICY, clock=clock), weight=3)
    else:
        sched = PortScheduler(cluster, clock=clock, columnar=columnar, telemetry=tel,
                              device="cpu")
        sched.register(PFitPlugin(PFitTracker(cluster, telemetry=tel)), weight=1)
        sched.register(PDynamicPlugin(PORT_POLICY, clock=clock), weight=3)
    return cluster, sched


@pytest.fixture(scope="module")
def jax_window():
    with jax_drip_reference() as mod:
        yield mod


@pytest.mark.parametrize("mode", ["scalar", "perpod", "queue8", "drip8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_drip_path_telemetry_matches(jax_window, seed, mode):
    """Fuzzed annotations and allocatable, mixed requests, interleaved
    daemonset pods (per-pod fallbacks inside the windows)."""
    rng = random.Random(seed)
    node_specs = fuzz_node_specs(rng, rng.choice([23, 41]))
    pod_specs = fuzz_pod_specs(rng, 40)
    tels, out = {}, {}
    for side in ("jax", "port"):
        tels[side] = SIDES[side].Telemetry(decision_sample_every=3)
        cluster, sched = drip_twin(side, node_specs, tels[side], columnar=mode != "scalar")
        pods = [make_pod(side, *spec) for spec in pod_specs]
        cluster.add_pods(pods)
        out[side] = (sched, run_mode(side, mode, cluster, sched, pods))
    (js, jr), (ps, pr) = out["jax"], out["port"]
    assert outcome(pr) == outcome(jr)
    assert_same_stats(js, ps, STAT_KEYS)
    assert_same_telemetry(tels["jax"], tels["port"])
    snap = tels["port"].registry.snapshot()
    scheduled = sum(r.node is not None for r in pr)
    assert snap.get('crane_drip_decisions_total{outcome="scheduled"}', 0) == scheduled
    windows = ps.drip_stats()["batch"]["dispatches"]
    assert snap.get("crane_drip_batch_pods_count", 0) == windows
    assert tels["port"].decisions.stats()["seen"] == len(pr)


# -- off, and the process-global fallback -------------------------------------------


def test_telemetry_off_places_alike_and_builds_nothing():
    on, off = burst_twin("port", "f32", ptel.Telemetry()), burst_twin("port", "f32", None)
    assert ptel.active() is None
    assert type(off.refresh_stats) is dict and off._lifecycle is None
    assert off._step.telemetry is None and off._fit._telemetry is None
    assert drive_burst_path(off, True) == drive_burst_path(on, True)
    rng = random.Random(3)
    node_specs, pod_specs = fuzz_node_specs(rng, 17), fuzz_pod_specs(rng, 24)
    results = []
    for tel in (None, ptel.Telemetry()):
        cluster, sched = drip_twin("port", node_specs, tel)
        pods = [make_pod("port", *spec) for spec in pod_specs]
        cluster.add_pods(pods)
        results.append(outcome(sched.schedule_queue(pods, window=8)))
        if tel is None:
            assert sched._m_decisions is None and sched._drip._m_hits is None
    assert results[0] == results[1]
    assert ptel.maybe_span(None, "prepare") is ptel._NULL_CTX


@pytest.mark.parametrize("value,on", [("1", True), ("true", True), ("0", False), ("no", False)])
def test_crane_telemetry_env_turns_both_entry_points_on(monkeypatch, value, on):
    ptel.disable()
    monkeypatch.setenv("CRANE_TELEMETRY", value)
    try:
        batch = PortBatchScheduler(pc.ClusterState(), PORT_POLICY, device="cpu")
        drip = PortScheduler(pc.ClusterState(), device="cpu")
        assert (batch._telemetry is not None) == on and (drip._telemetry is not None) == on
        if on:
            assert batch._telemetry is drip._telemetry is ptel.active()
            assert isinstance(batch.refresh_stats, dict) and batch._step.telemetry is ptel.active()
        explicit = ptel.Telemetry()
        assert PortScheduler(pc.ClusterState(), device="cpu",
                             telemetry=explicit)._telemetry is explicit
    finally:
        ptel.disable()
    monkeypatch.delenv("CRANE_TELEMETRY")
    assert ptel.active() is None
    assert ptel.enable() is ptel.enable()
    ptel.disable()


# -- the device-side hook ------------------------------------------------------


def test_torch_trace_and_chrome_trace_write_their_files(tmp_path):
    with torch_trace(None) as prof:
        assert prof is None
    rec = ptel.SpanRecorder()
    with chrome_trace(rec, str(tmp_path / "spans.json")):
        with torch_trace(str(tmp_path / "torch")) as prof:
            with rec.span("work"):
                torch.ones(64).cumsum(0)
    (trace,) = (tmp_path / "torch").glob("*.pt.trace.json")
    assert json.loads(trace.read_text())["traceEvents"]
    assert any("cumsum" in e.key for e in prof.key_averages())
    events = json.loads((tmp_path / "spans.json").read_text())["traceEvents"]
    assert [e["name"] for e in events if e["ph"] == "X"] == ["work"]
    with chrome_trace(None, str(tmp_path / "none.json")):
        pass
    assert not (tmp_path / "none.json").exists()
