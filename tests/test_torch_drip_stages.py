"""The drip window's stage clock, the profiler-range switch and the GC
pause counter of the PyTorch port, on the CPU.

``Scheduler.schedule_queue`` splits each window into ``DRIP_STAGES``
(admit, prepare, launch, wait, bind, fold; the NRT window's zone stage,
which the plain window never opens) on one clock; the readings
feed ``drip_stats()["batch"]["stage_seconds"]`` always, the span recorder
with telemetry on and ``torch.profiler`` under ``profiler_ranges()``.
``device_idle_by_range`` books a trace's device idle to those ranges;
``GC_PAUSES`` counts the collector's pauses. Port-only: the JAX package
has none of these.
"""

import gc
import random
import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from crane_scheduler_tpu_torch import telemetry as ptel
from crane_scheduler_tpu_torch.framework.scheduler import DRIP_STAGES
from crane_scheduler_tpu_torch.parallel.mesh import make_placement_mesh
from crane_scheduler_tpu_torch.telemetry import expfmt
from crane_scheduler_tpu_torch.utils.profiling import device_idle_by_range, torch_trace
from test_drip_columnar import fuzz_node_specs
from test_torch_drip import build_cluster, build_scheduler, make_pod

WINDOW = 8
PODS = 40  # five full windows
# the stages of the plain Dynamic + Fit window: drip_zone is the NRT
# window's and reads 0 here
PLAIN = tuple(s for s in DRIP_STAGES if s != "drip_zone")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def queue_run(telemetry=None, mesh=None, pods=PODS, seed=5):
    """One ``schedule_queue`` call over ``pods`` pods in windows of 8 on
    23 fuzzed nodes; returns the scheduler, the results and the call's
    wall seconds."""
    rng = random.Random(seed)
    cluster = build_cluster("port", fuzz_node_specs(rng, 23))
    sched = build_scheduler("port", cluster, telemetry=telemetry)
    sched._kernel_mesh = mesh
    queue = [make_pod("port", f"p{i:03d}", 50 + 10 * (i % 7), 1 << 20) for i in range(pods)]
    cluster.add_pods(queue)
    t0 = time.perf_counter()
    results = sched.schedule_queue(queue, window=WINDOW)
    return sched, results, time.perf_counter() - t0


@pytest.mark.parametrize("tiles", [None, 2], ids=["single", "tiled"])
def test_stage_seconds_split_the_call(tiles):
    mesh = make_placement_mesh(tiles, [torch.device("cpu")] * tiles) if tiles else None
    sched, results, wall = queue_run(mesh=mesh)
    assert any(r.node for r in results)
    batch = sched.drip_stats()["batch"]
    stages = batch["stage_seconds"]
    assert tuple(stages) == DRIP_STAGES
    assert all(stages[s] > 0 for s in PLAIN) and stages["drip_zone"] == 0.0
    assert sum(stages.values()) <= wall
    assert batch["dispatches"] == PODS // WINDOW == len(batch["batch_sizes"])
    assert "kernel_seconds" not in batch
    assert not hasattr(sched._batch_kernel, "last_kernel_seconds")


@pytest.mark.parametrize("tiles", [None, 2], ids=["single", "tiled"])
def test_drip_stats_count_graph_and_eager_windows(tiles):
    """``drip_stats()["batch"]`` carries the kernel's CUDA-graph counters;
    on the CPU, and over tiles, every window is eager. Before any window
    there is no kernel and each reads 0."""
    rng = random.Random(5)
    idle = build_scheduler("port", build_cluster("port", fuzz_node_specs(rng, 3)))
    assert {k: idle.drip_stats()["batch"][k]
            for k in ("graph_captures", "graph_replays", "eager_windows")} == dict.fromkeys(
                ("graph_captures", "graph_replays", "eager_windows"), 0)
    mesh = make_placement_mesh(tiles, [torch.device("cpu")] * tiles) if tiles else None
    sched, _results, _wall = queue_run(mesh=mesh)
    batch = sched.drip_stats()["batch"]
    assert batch["graph_captures"] == batch["graph_replays"] == 0
    assert batch["eager_windows"] == batch["dispatches"] == PODS // WINDOW
    assert batch["replays"] == 0  # the tie replays, a separate count


def test_stage_spans_once_per_window_in_order():
    tel = ptel.Telemetry()
    sched, _results, wall = queue_run(telemetry=tel)
    spans = sorted((e for e in tel.export_chrome_trace()["traceEvents"]
                    if e["ph"] == "X" and e["name"] in DRIP_STAGES), key=lambda e: e["ts"])
    windows = sched.drip_stats()["batch"]["dispatches"]
    assert [e["name"] for e in spans] == list(PLAIN) * windows
    tracks = {e["tid"]: e["args"]["name"] for e in tel.export_chrome_trace()["traceEvents"]
              if e["ph"] == "M"}
    assert {tracks[e["tid"]] for e in spans} == {"MainThread"}
    # back to back: each stage starts where the one before it ended
    for a, b in zip(spans, spans[1:]):
        if b["name"] != "drip_admit":
            assert b["ts"] == pytest.approx(a["ts"] + a["dur"], abs=1e-3)
    # the spans carry the counters' readings
    stages = sched.drip_stats()["batch"]["stage_seconds"]
    for name in DRIP_STAGES:
        total = sum(e["dur"] for e in spans if e["name"] == name) * 1e-6
        assert total == pytest.approx(stages[name], rel=1e-6, abs=1e-8)
    # drip_dispatch keeps its extent: prepare through wait
    snap = tel.registry.snapshot()
    assert snap["crane_drip_kernel_seconds_count"] == windows
    assert snap["crane_drip_kernel_seconds_sum"] <= (
        stages["drip_prepare"] + stages["drip_launch"] + stages["drip_wait"])


@pytest.mark.parametrize("ranges", [True, False], ids=["profiler_ranges", "plain_profile"])
def test_stage_ranges_in_the_profiler_only_when_asked(ranges):
    """Under ``profiler_ranges()`` each stage and span of the window is a
    host range of the profiler, once per window; a plain profiler session
    sees none of the port's ranges."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if ranges:
            with ptel.profiler_ranges():
                sched, _results, _wall = queue_run()
        else:
            sched, _results, _wall = queue_run()
    windows = sched.drip_stats()["batch"]["dispatches"]
    names = [e.name for e in prof.events() if getattr(e, "is_user_annotation", False)]
    for name in PLAIN + ("drip_dispatch",):
        assert names.count(name) == (windows if ranges else 0), name
    assert "drip_zone" not in names
    assert "drip_column_rebuild" in names if ranges else "drip_column_rebuild" not in names
    assert not ptel.stages.RANGES


def test_off_is_the_null_context_and_no_gc_hook():
    assert ptel.maybe_span(None, "prepare") is ptel._NULL_CTX
    assert not ptel.GC_PAUSES.installed
    with ptel.profiler_ranges():
        assert ptel.maybe_span(None, "prepare") is not ptel._NULL_CTX
        with ptel.profiler_ranges():
            pass
        assert ptel.stages.RANGES
    assert ptel.maybe_span(None, "prepare") is ptel._NULL_CTX
    sched, _results, _wall = queue_run()
    assert sched._telemetry is None and not ptel.GC_PAUSES.installed


def test_torch_trace_records_the_stages(tmp_path):
    with torch_trace(str(tmp_path)) as prof:
        sched, _results, _wall = queue_run(pods=2 * WINDOW)
    names = [e.name for e in prof.events() if getattr(e, "is_user_annotation", False)]
    assert names.count("drip_launch") == sched.drip_stats()["batch"]["dispatches"] == 2
    assert not ptel.stages.RANGES


def test_open_queue_books_no_admission():
    rng = random.Random(2)
    cluster = build_cluster("port", fuzz_node_specs(rng, 17))
    sched = build_scheduler("port", cluster)
    pods = [make_pod("port", f"q{i}", 100, 1 << 20) for i in range(2 * WINDOW)]
    cluster.add_pods(pods)
    q = sched.open_queue(window=WINDOW)
    for pod in pods:
        q.offer(pod)
    q.drain()
    stages = sched.drip_stats()["batch"]["stage_seconds"]
    assert stages["drip_admit"] == 0.0
    assert all(stages[name] > 0 for name in PLAIN[1:])


def test_gc_counter_counts_and_unhooks():
    before = list(gc.callbacks)
    held = gc.callbacks
    counter = ptel.GC_PAUSES
    secs, colls = counter.seconds[2], counter.collections[2]
    assert counter.install() and not counter.install()
    try:
        gc.collect(2)
    finally:
        counter.uninstall()
    assert counter.seconds[2] > secs and counter.collections[2] >= colls + 1
    assert gc.callbacks is held and gc.callbacks == before
    counted = counter.collections[2]
    gc.collect(2)
    assert counter.collections[2] == counted  # unhooked: no more counts


def test_gc_families_under_enable_render_and_parse():
    ptel.disable()
    before = list(gc.callbacks)
    tel = ptel.enable()
    try:
        assert ptel.GC_PAUSES.installed
        gc.collect(2)
        text = tel.render_prometheus()
        for openmetrics in (False, True):
            expfmt.parse_exposition(tel.render_prometheus(openmetrics=openmetrics))
        assert 'crane_gc_collections_total{generation="2"}' in text
        assert 'crane_gc_pause_seconds_total{generation="0"}' in text
        snap = tel.registry.snapshot()
        assert snap['crane_gc_collections_total{generation="2"}'] >= 1
        assert snap['crane_gc_pause_seconds_total{generation="2"}'] > 0
    finally:
        ptel.disable()
    assert gc.callbacks == before and not ptel.GC_PAUSES.installed


def ev(name, start, end, device=False, annotation=None):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=(not device) if annotation is None else annotation)


KERNELS = [ev("k1", 10, 20, True), ev("k2", 40, 50, True), ev("copy", 45, 70, True),
           ev("k3", 100, 110, True)]  # idle: 20-40 and 70-100, 50 us


def test_device_idle_by_range_books_the_innermost_range():
    ranges = [ev("bench.call", 0, 120), ev("drip_fold", 15, 30), ev("drip_admit", 30, 35),
              ev("drip_launch", 35, 80), ev("drip_wait", 80, 95)]
    got = device_idle_by_range(KERNELS + ranges)
    want = {"drip_fold": 10e-6, "drip_admit": 5e-6, "drip_launch": 15e-6, "drip_wait": 15e-6,
            "bench.call": 5e-6}
    assert got.keys() == want.keys()
    for name, s in want.items():
        assert got[name] == pytest.approx(s), name
    # the device-side copies of host ranges are not device work: adding
    # them changes nothing, and the total idle is the gaps' sum
    shadows = [ev(name, 20, 100, True, annotation=True) for name in ("drip_launch", "bench.call")]
    assert device_idle_by_range(KERNELS + ranges + shadows) == got
    assert sum(got.values()) == pytest.approx(50e-6)
    # with no range the idle is the same, booked to None
    assert device_idle_by_range(KERNELS) == {None: pytest.approx(50e-6)}
    # a plain host op (no annotation) is no range
    assert device_idle_by_range(KERNELS + [ev("aten::add", 0, 120, annotation=False)]) == {
        None: pytest.approx(50e-6)}
    assert device_idle_by_range(ranges) == {}
