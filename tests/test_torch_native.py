"""The port's host library (``crane_scheduler_tpu_torch/native/``) held three
ways: the port's native route, the port's Python twin, and the JAX package's
native route, on the same inputs made from a seed with numpy.

- codec: ``bulk_parse_annotations`` (fuzzed strings, a 50,000 x 12 sweep, a
  zone with DST), ``bulk_parse_values`` against ``go_parse_float``,
  ``bulk_render_f5`` against ``format_metric_value`` (-0.0, oversize rows,
  ``with_parse``);
- the C++ binding heap against the Python heap over random streams;
- the LIST decoders' resourceVersion reuse and ``decode_watch_lines``
  against the per-line path;
- the flush engine's route threshold over ``tests/kube_stub.py``, its
  disabling on a failed name resolution, and a failed build raising;
- the consumers: the simulator's three-column render and a mirror's
  bootstrap, relist with reuse and watch storm against the reference
  client's default routes.

Equality is bit for bit (strings, float64 bit patterns, counts, objects,
statuses). The native routes of the two packages agree on every input. A
native route and its Python twin agree on every input but three classes,
pinned in ``test_native_codec_diverges_from_its_twin``: the twin accepts a
non-ASCII decimal digit ("１") and a timestamp field narrower than its
layout ("2026-7-30"), which Go and the C parser reject; the C parser
accepts a day past the month's end ("2026-02-30"), which Go and the twin
reject; and a missing or invalid entry is NaN with the sign bit set on the
native route, positive NaN on the twin. Every case that opens sockets or
threads runs under a 120 s limit.
"""

import importlib.util
import json
import os
import signal
import time

import numpy as np
import pytest

import crane_scheduler_tpu.cluster.kube as ref_kube
import crane_scheduler_tpu.native.bindings as ref_bindings
import crane_scheduler_tpu.native.codec as ref_codec
import crane_scheduler_tpu.native.listdecode as ref_ld
from crane_scheduler_tpu.annotator import Binding as RefBinding
from crane_scheduler_tpu_torch.annotator import Binding, BindingRecords
from crane_scheduler_tpu_torch.cluster import kube as port_kube
from crane_scheduler_tpu_torch.loadstore.codec import (
    bulk_decode_annotations,
    format_metric_value,
    go_parse_float,
)
from crane_scheduler_tpu_torch.native import codec, lib
from crane_scheduler_tpu_torch.native import listdecode as port_ld
from crane_scheduler_tpu_torch.native.bindings import NativeBindingRecords

_STUB = os.path.join(os.path.dirname(__file__), "kube_stub.py")
_spec = importlib.util.spec_from_file_location("kube_stub_torch_native", _STUB)
kube_stub = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kube_stub)

NOW = 1753776000


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        raise TimeoutError("test case exceeded its 120 s limit")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


def _wait_until(predicate, timeout=20.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64).view(np.int64)


# -- codec ----------------------------------------------------------------------

# inputs where the Python twin accepts what Go's ParseFloat / time.Parse
# (and the C parser) reject
TWIN_ONLY_DIGIT = "\uff11"  # a non-ASCII decimal digit
TWIN_ONLY_STAMP = "2026-7-30T00:00:00Z"  # a one-digit month
# a day past the month's end: the C parser accepts it, Go and the twin
# reject it
NATIVE_ONLY_STAMP = "2026-02-30T00:00:00Z"


_STAMPS = ["2026-07-30T00:00:00Z", "2025-12-31T23:59:59Z", "2026-02-28T12:30:05Z"]
_ODD_VALUES = [
    "NaN", "nan", "+Inf", "-Inf", "inf", "Infinity", "-0", "-0.0", "+1.5", "1e3",
    "1E-7", ".5", "5.", "0x1p-2", "1_000", "0.123456789012345678901", "1e400",
    "-1e400", "4.9e-324", "", " 1", "1 ", "abc", "1.0.0", TWIN_ONLY_DIGIT, "1.5é", "0.5́",
]
_ODD_ANNOTATIONS = [
    None, "", "abc", "1.0", "1.0,", ",2026-07-30T00:00:00Z", "1,2,3",
    "1.0,2026-13-01T00:00:00Z", "1.0,2026-07-30T00:00:00", " 1.0,2026-07-30T00:00:00Z",
    "1.0,2026-07-30T00:00:00Z ", "1.0,2026-07-30T25:00:00Z", "1.0,2026-02-30T00:00:00Z",
    "1.0,2026-07-30T00:00:00Z漢", "漢,2026-07-30T00:00:00Z", "1.0,2026-07-30 00:00:00Z",
    "1.0,+2026-07-30T00:00:00Z", "1.0,2026-7-30T00:00:00Z", 7,
]


def fuzz_annotations(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        roll = rng.random()
        stamp = _STAMPS[int(rng.integers(len(_STAMPS)))]
        if roll < 0.5:
            out.append(f"{rng.random():.5f},{stamp}")
        elif roll < 0.7:
            out.append(f"{_ODD_VALUES[int(rng.integers(len(_ODD_VALUES)))]},{stamp}")
        elif roll < 0.85:
            out.append(_ODD_ANNOTATIONS[int(rng.integers(len(_ODD_ANNOTATIONS)))])
        else:
            out.append(f"{rng.normal() * 10 ** int(rng.integers(-8, 30)):.{int(rng.integers(0, 12))}f}"
                       f",{stamp}")
    return out


def _twin_divergent(raw) -> bool:
    return isinstance(raw, str) and any(
        d in raw for d in (TWIN_ONLY_DIGIT, TWIN_ONLY_STAMP, NATIVE_ONLY_STAMP))


def _three_way_annotations(raws):
    """Port native == reference native bit for bit; port native == the
    twin bit for bit except the pinned classes: NaN sign, and the twin-only
    inputs."""
    got = codec.bulk_parse_annotations(raws)
    twin = bulk_decode_annotations(raws)
    ref = ref_codec.bulk_parse_annotations(raws)
    keep = np.asarray([not _twin_divergent(r) for r in raws], dtype=bool)
    for a, b, c in zip(got, twin, ref):
        np.testing.assert_array_equal(bits(a), bits(c))
        np.testing.assert_array_equal(np.isnan(a[keep]), np.isnan(b[keep]))
        both = keep & ~np.isnan(a)
        np.testing.assert_array_equal(bits(a[both]), bits(b[both]))
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bulk_parse_annotations_fuzz_three_ways(seed):
    raws = fuzz_annotations(seed, 4000)
    values, ts = _three_way_annotations(raws)
    assert np.isfinite(ts).sum() > 1000 and np.isneginf(ts).sum() > 100
    assert np.isnan(values[np.isfinite(ts)]).any()  # "NaN" keeps its timestamp


def test_bulk_parse_annotations_50k_by_12_sweep():
    rng = np.random.default_rng(7)
    loads = rng.random((50_000, 12))
    stamps = np.asarray(_STAMPS)[rng.integers(0, 2, 12)]
    raws = [f"{v:.5f},{stamps[j]}" for row in loads for j, v in enumerate(row.tolist())]
    values, ts = _three_way_annotations(raws)
    assert np.isfinite(ts).all()
    np.testing.assert_array_equal(values, np.round(loads.ravel(), 5))


def test_bulk_parse_annotations_dst_zone_takes_the_twin(monkeypatch):
    """A zone with DST: the C parser knows only fixed offsets, so both
    packages parse through the numpy twin (the exact per-string codec)."""
    monkeypatch.setenv("TZ", "America/New_York")
    assert codec._fixed_utc_offset_seconds() is None
    raws = fuzz_annotations(5, 1000) + ["0.5,2026-03-08T02:30:00Z", "0.5,2026-11-01T01:30:00Z"]
    _three_way_annotations(raws)
    monkeypatch.setenv("TZ", "UTC")
    assert codec._fixed_utc_offset_seconds() == 0
    _three_way_annotations(raws)


@pytest.mark.parametrize("seed", [0, 1])
def test_bulk_parse_values_equals_go_parse_float(seed):
    rng = np.random.default_rng(seed)
    strings = [f"{rng.random():.5f}" for _ in range(2000)] + _ODD_VALUES * 3
    strings += [f"{x:.{int(rng.integers(0, 20))}g}" for x in rng.normal(0, 1e6, 500)]
    strings = [strings[i] for i in rng.permutation(len(strings))]
    values, ok = codec.bulk_parse_values(strings)
    ref_values, ref_ok = ref_codec.bulk_parse_values(strings)
    np.testing.assert_array_equal(ok, ref_ok)
    np.testing.assert_array_equal(bits(values), bits(ref_values))
    strings = [s for s in strings if not _twin_divergent(s)]
    values, ok = codec.bulk_parse_values(strings)
    per = [go_parse_float(s) for s in strings]
    want_ok = np.asarray([v is not None for v in per])
    want = np.asarray([np.nan if v is None else v for v in per])
    np.testing.assert_array_equal(ok, want_ok)
    np.testing.assert_array_equal(bits(values[ok]), bits(want[ok]))
    assert codec.bulk_parse_values([])[0].shape == (0,)


def test_native_codec_diverges_from_its_twin():
    """The pinned native-vs-twin divergences, the same in both packages:
    the twin parses a non-ASCII digit and a one-digit month, the native
    route (like Go) rejects them; the native route parses Feb 30 (as
    Mar 2), the twin (like Go) rejects it; an entry the parsers reject is
    NaN with the sign bit set on the native route, positive NaN on the
    twin."""
    for parse in (codec.bulk_parse_values, ref_codec.bulk_parse_values):
        values, ok = parse([TWIN_ONLY_DIGIT, "1"])
        assert ok.tolist() == [False, True] and np.isnan(values[0])
    assert go_parse_float(TWIN_ONLY_DIGIT) == 1.0
    raws = [f"0.5,{TWIN_ONLY_STAMP}", f"{TWIN_ONLY_DIGIT},2026-07-30T00:00:00Z", "junk"]
    for parse in (codec.bulk_parse_annotations, ref_codec.bulk_parse_annotations):
        values, ts = parse(raws)
        assert np.isneginf(ts).all() and np.isnan(values).all()
        assert np.signbit(values).all()
    values, ts = bulk_decode_annotations(raws)
    assert values[:2].tolist() == [0.5, 1.0] and np.isfinite(ts[:2]).all()
    assert np.isnan(values[2]) and not np.signbit(values[2])
    raws = [f"0.5,{NATIVE_ONLY_STAMP}", "0.5,2026-03-02T00:00:00Z"]
    for parse in (codec.bulk_parse_annotations, ref_codec.bulk_parse_annotations):
        values, ts = parse(raws)
        assert values.tolist() == [0.5, 0.5] and ts[0] == ts[1]
    values, ts = bulk_decode_annotations(raws)
    assert np.isnan(values[0]) and np.isneginf(ts[0]) and ts[1] == codec.bulk_parse_annotations(
        raws)[1][1]


def test_bulk_render_f5_equals_format_metric_value():
    rng = np.random.default_rng(3)
    vals = np.concatenate([
        rng.random(5000), rng.random(500) * 1e4, rng.normal(0, 1e8, 500),
        [0.0, -0.0, 1e-5, 5e-6, 4.999995e-6, 0.000005, 9999.999995, 1e4, 12345.678905,
         1e25, -1e25, 1e30, -1e300, 1.7976931348623157e308, float("nan"), float("inf"),
         float("-inf"), 2.5e-324, -2.5e-324],
        np.nextafter(np.round(rng.random(200), 5) + 5e-6, 2.0),
    ])
    out, parsed, ok = codec.bulk_render_f5(vals, with_parse=True)
    assert out == [format_metric_value(float(v)) for v in vals.tolist()]
    assert out == codec.bulk_render_f5(vals)
    ref_out, ref_parsed, ref_ok = ref_codec.bulk_render_f5(vals, with_parse=True)
    assert out == ref_out
    np.testing.assert_array_equal(ok, ref_ok)
    np.testing.assert_array_equal(bits(parsed), bits(ref_parsed))
    per = [go_parse_float(s) for s in out]
    np.testing.assert_array_equal(ok, [v is not None for v in per])
    np.testing.assert_array_equal(
        bits(parsed[ok]), bits(np.asarray([v for v in per if v is not None])))
    # -0.0 keeps its sign through the fast path, as FormatFloat renders it
    assert codec.bulk_render_f5(np.asarray([-0.0, 0.0])) == ["-0.00000", "0.00000"]
    # oversize rows (over 31 characters) re-render in Python
    assert codec.bulk_render_f5(np.asarray([1e30]))[0] == format_metric_value(1e30)


# -- the binding heap -------------------------------------------------------------


def _heap_stream(seed: int, n_ops: int = 600):
    rng = np.random.default_rng(seed)
    nodes = [f"node-{i:02d}" for i in range(30)]
    ops = []
    t = NOW - 2000
    for _ in range(n_ops):
        roll = rng.random()
        t += int(rng.integers(0, 5))
        if roll < 0.4:
            ops.append(("add", nodes[int(rng.integers(30))], t - int(rng.integers(0, 600))))
        elif roll < 0.6:
            ops.append(("batch", [(nodes[int(rng.integers(30))], t - int(rng.integers(0, 900)))
                                  for _ in range(int(rng.integers(0, 12)))]))
        elif roll < 0.7:
            ops.append(("columns", tuple(nodes) if rng.random() < 0.5 else list(nodes),
                        rng.integers(0, 30, int(rng.integers(0, 40))), t - 0.5))
        elif roll < 0.8:
            ops.append(("gc", t + int(rng.integers(0, 400))))
        else:
            ops.append(("count", nodes[int(rng.integers(30))], int(rng.choice([60, 300, 900])),
                        t + int(rng.integers(0, 300))))
    return ops


def _run_heap(records, binding_cls, ops):
    out = []
    for op in ops:
        if op[0] == "add":
            records.add_binding(binding_cls(op[1], "ns", "p", op[2]))
        elif op[0] == "batch":
            records.add_binding_batch([binding_cls(n, "ns", "p", ts) for n, ts in op[1]])
        elif op[0] == "columns":
            records.add_bind_columns(op[1], op[2], op[3])
        elif op[0] == "gc":
            records.bindings_gc(op[1])
        else:
            out.append(records.get_last_node_binding_count(op[1], op[2], op[3]))
        out.append(len(records))
    return out


def _counts(records, windows, now) -> dict:
    names, counts = records.counts_batch(windows, now)
    return {n: counts[:, i].tolist() for i, n in enumerate(names) if counts[:, i].any()}


@pytest.mark.parametrize("seed,size", [(0, 64), (1, 4096), (2, 1)])
def test_native_heap_equals_python_heap_and_reference(seed, size):
    ops = _heap_stream(seed)
    port = NativeBindingRecords(size, 900)
    twin = BindingRecords(size, 900)
    ref = ref_bindings.NativeBindingRecords(size, 900)
    got = _run_heap(port, Binding, ops)
    assert got == _run_heap(twin, Binding, ops) == _run_heap(ref, RefBinding, ops)
    windows = [60, 300, 900, 0]
    for now in (NOW - 1000, NOW, NOW + 500):
        names, counts = port.counts_batch(windows, now)
        ref_names, ref_counts = ref.counts_batch(windows, now)
        assert names == ref_names
        np.testing.assert_array_equal(counts, ref_counts)
        assert _counts(port, windows, now) == _counts(twin, windows, now)
        # counts_batch equals the per-node counts
        for i, name in enumerate(names):
            assert counts[:, i].tolist() == [port.get_last_node_binding_count(name, w, now)
                                             for w in windows]
    v = port.version
    port.add_binding(Binding("node-00", "ns", "p", NOW))
    assert port.version > v


# -- the LIST and watch decoders ----------------------------------------------------


def _node_obj(i: int, rv: str, extra=None):
    obj = {"metadata": {"name": f"n{i}", "resourceVersion": rv,
                        "annotations": {"m": f"0.{i},2026-07-30T00:00:00Z", **(extra or {})}},
           "status": {"addresses": [{"type": "InternalIP", "address": f"10.0.0.{i}"}]}}
    return obj


def _page(items, rv="100"):
    return json.dumps({"metadata": {"resourceVersion": rv}, "items": items}).encode()


def test_known_rvs_reuse_markers_equal_reference():
    items = [_node_obj(i, str(10 + i)) for i in range(12)]
    items[5]["status"]["allocatable"] = {"cpu": "4"}  # a fallback row: never a marker
    items[7]["metadata"].pop("resourceVersion")  # no rv: never a marker
    body = _page(items)
    known = {f"n{i}": str(10 + i) for i in range(12)}
    known["n3"] = "999"  # moved since: rebuilt
    port = port_ld.decode_list_page(body, 0, known_rvs=known)
    ref = ref_ld.decode_list_page(body, 0, known_rvs=known)
    objs = port.materialize()
    markers = [i for i, o in enumerate(objs) if isinstance(o, str)]
    assert markers == [i for i in range(12) if i not in (3, 5, 7)]
    assert [o if isinstance(o, str) else o.name for o in objs] == \
        [o if isinstance(o, str) else o.name for o in ref.materialize()]
    assert port.rvs == ref.rvs
    assert port._reused == ref._reused
    for i in markers:
        assert json.loads(port.reused_span(i)) == items[i]
    fresh = port_ld.decode_list_page(body, 0, native="pylist").materialize()
    assert all(not isinstance(o, str) for o in fresh)
    assert port.reused_span(3) is None


def _watch_lines(seed: int, kind: int) -> list:
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(60):
        roll = rng.random()
        rv = str(1000 + i)
        if kind == 0:
            obj = _node_obj(int(rng.integers(40)), rv)
            if roll < 0.1:
                obj["status"]["allocatable"] = {"cpu": "8"}
            elif roll < 0.15:
                obj["metadata"]["annotations"]["bad"] = 5
        else:
            obj = {"metadata": {"name": f"p{int(rng.integers(40))}", "namespace": "ns",
                                "resourceVersion": rv},
                   "spec": {"nodeName": f"n{int(rng.integers(5))}" if roll < 0.7 else ""}}
            if roll < 0.1:
                obj["spec"]["containers"] = [{"name": "c", "resources": {"requests": {"cpu": "1"}}}]
        t = str(rng.choice(["ADDED", "MODIFIED", "DELETED", "MODIFIED"]))
        if roll > 0.93:
            lines.append(json.dumps({"type": "BOOKMARK",
                                     "object": {"metadata": {"resourceVersion": rv}}}).encode())
        elif roll > 0.9:
            lines.append(b"   ")
        else:
            lines.append(json.dumps({"type": t, "object": obj}).encode())
    return lines


def _parsed_t(kind, parsed):
    batch, last_rv, error_obj, n_seen, model = parsed
    from_json = port_kube.node_from_json if kind == 0 else port_kube.pod_from_json
    from tests.test_torch_read_path import node_t, pod_t

    to_t = node_t if kind == 0 else pod_t
    models = [(t, to_t(o if model else from_json(o))) for t, o in batch]
    return models, last_rv, error_obj, n_seen


@pytest.mark.parametrize("kind", [0, 1], ids=["nodes", "pods"])
@pytest.mark.parametrize("tail", ["plain", "error_410", "error_500", "error_mid"])
def test_decode_watch_lines_equals_per_line_path(kind, tail):
    """``decode_watch_lines`` (the model route) against the per-line JSON
    route of the same client, and against the reference client's model
    route: the same models, last resourceVersion, ERROR object and count
    of lines seen (blank lines, BOOKMARKs and fallback lines included)."""
    lines = _watch_lines(kind + 10, kind)
    error = {"type": "ERROR", "object": {"kind": "Status", "code": 410 if tail != "error_500"
                                         else 500, "message": "gone"}}
    if tail == "error_mid":
        lines.insert(30, json.dumps(error).encode())
    elif tail != "plain":
        lines.append(json.dumps(error).encode())
    rv_key = "nodes" if kind == 0 else "pods"
    port = port_kube.KubeClusterClient("http://127.0.0.1:1")
    ref = ref_kube.KubeClusterClient("http://127.0.0.1:1")
    try:
        model = port._parse_watch_lines(list(lines), rv_key)
        assert model[4] is True
        per_line = port._parse_watch_lines(list(lines), "nrts")  # a per-line stream
        assert per_line[4] is False
        want = _parsed_t(kind, per_line)
        assert _parsed_t(kind, model) == want
        assert _parsed_t(kind, ref._parse_watch_lines(list(lines), rv_key)) == want
        if tail != "plain":
            assert model[2]["code"] == error["object"]["code"]
    finally:
        port.stop()
        ref.stop()


def test_decode_watch_lines_torn_line_raises_like_per_line():
    """A torn line (malformed JSON): the decoder declines the batch and the
    per-line path raises the JSON error, in both packages."""
    lines = _watch_lines(3, 0)[:5] + [b'{"type": "MODIFIED", "object": {"metadata": ']
    assert port_ld.decode_watch_lines(b"\n".join(lines), 0) is None
    for kube in (port_kube, ref_kube):
        client = kube.KubeClusterClient("http://127.0.0.1:1")
        with pytest.raises(json.JSONDecodeError):
            client._parse_watch_lines(list(lines), "nodes")
        client.stop()


# -- the flush engine -------------------------------------------------------------


@pytest.fixture()
def stub():
    server = kube_stub.KubeStubServer().start()
    yield server
    server.stop()


@pytest.mark.parametrize("n", [127, 128])
def test_batch_of_127_stays_python_and_128_takes_the_engine(stub, n):
    for i in range(4):
        stub.state.add_node(f"node-{i}", f"10.0.0.{i}")
    for i in range(n):
        stub.state.add_pod("t", f"p{i}")
    client = port_kube.KubeClusterClient(stub.url, concurrent_syncs=2)
    try:
        bound = client.bind_pods([(f"t/p{i}", f"node-{i % 4}") for i in range(n)])
        assert len(bound) == n
        route = "native" if n >= 128 else "pipelined"
        assert client.bulk_flushes[route] == [1, n, n]
        other = "pipelined" if route == "native" else "native"
        assert client.bulk_flushes[other] == [0, 0, 0]
        with stub.state.lock:
            assert stub.state.duplicate_binds() == 0 and sum(stub.state.bind_posts.values()) == n
        # merge-patches: the same threshold
        patched = client.patch_node_annotations_bulk(
            {f"node-{i % 4}" if i < 4 else f"ghost-{i}": {"k": str(i)} for i in range(n)})
        assert patched == 4 and client.bulk_flushes[route][0] == 2
    finally:
        client.stop()


def test_engine_only_over_plain_http_and_resolution_failure_disables(monkeypatch):
    assert port_kube.KubeClusterClient("https://127.0.0.1:1")._get_native_flusher() is None
    import socket

    def refuse(*args, **kwargs):
        raise OSError("no such host")

    client = port_kube.KubeClusterClient("http://127.0.0.1:1")
    monkeypatch.setattr(socket, "getaddrinfo", refuse)
    assert client._get_native_flusher() is None and client._native_flush_disabled
    monkeypatch.undo()
    assert client._get_native_flusher() is None  # stays off for the client's life
    assert port_kube.KubeClusterClient("http://127.0.0.1:1")._get_native_flusher() is not None


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    """No hidden fallback: a compiler that fails raises RuntimeError from
    the loader, the heap, the codec and the flush engine's getter."""
    monkeypatch.setattr(lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(lib, "_loaded", {})
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="building crane_native.cpp failed"):
        lib.load_native()
    with pytest.raises(RuntimeError):
        NativeBindingRecords(8, 60)
    with pytest.raises(RuntimeError):
        codec.bulk_parse_values(["1"])
    with pytest.raises(RuntimeError):
        port_kube.KubeClusterClient("http://127.0.0.1:1")._get_native_flusher()
    assert not list(tmp_path.glob("*.tmp"))


def test_build_is_keyed_on_sources_and_flags():
    paths = lib.library_paths()
    lib.load_native()
    lib.load_pylist()
    paths = lib.library_paths()
    for name, path in paths.items():
        assert os.path.dirname(path) == str(lib.BUILD_DIR)
        assert os.path.basename(path).startswith(f"lib{name}-")
    key = lib._library_path("crane_native", [lib.CSRC / "crane_native.cpp",
                                             lib.CSRC / "listscan.h"], ())
    assert str(key) == paths["crane_native"]


def test_build_key_follows_the_compiler_version(monkeypatch):
    """The same compiler command at another ``--version`` keys another
    library, so an upgraded compiler builds anew."""
    sources = [lib.CSRC / "crane_native.cpp", lib.CSRC / "listscan.h"]
    before = lib._library_path("crane_native", sources, ())
    assert lib.compiler_version(tuple(lib.compiler_command()))
    monkeypatch.setattr(lib, "compiler_version", lambda cxx: "g++ (GCC) 99.0.0\n")
    after = lib._library_path("crane_native", sources, ())
    assert after != before and after.parent == before.parent


# -- consumers ----------------------------------------------------------------------


def test_simulator_columns_equal_reference():
    from crane_scheduler_tpu.sim import SimConfig as RefSimConfig
    from crane_scheduler_tpu.sim import Simulator as RefSimulator
    from crane_scheduler_tpu_torch.sim import SimConfig, Simulator

    ref = RefSimulator(RefSimConfig(n_nodes=64, seed=5))
    port = Simulator(SimConfig(n_nodes=64, seed=5))
    for k in range(2):
        for m, column in port.metrics._columns.items():
            hosts, strings, floats = column()
            r_hosts, r_strings, r_floats = ref.metrics._columns[m]()
            assert hosts == r_hosts and strings == r_strings
            np.testing.assert_array_equal(bits(floats), bits(r_floats))
            assert strings == [format_metric_value(float(go_parse_float(s))) for s in strings]
        for sim in (ref, port):
            for j in range(40):
                sim.record(f"node-{j % 7:05d}")
            sim.clock.advance(30.0)


def _annotated(stub, n):
    for i in range(n):
        stub.state.add_node(f"node-{i:03d}", f"10.0.0.{i}",
                            annotations={"m": f"0.{i:03d},2026-01-01T00:00:00Z"})


def _spy_routes(monkeypatch) -> tuple[list, list]:
    """Record the backend of every LIST page the client decodes and the
    result of every ``decode_watch_lines`` call (the client imports both
    from the module at each call)."""
    backends, watch = [], []
    decode_page, decode_watch = port_ld.decode_list_page, port_ld.decode_watch_lines

    def page_spy(*args, **kwargs):
        page = decode_page(*args, **kwargs)
        backends.append(page.backend)
        return page

    def watch_spy(*args, **kwargs):
        res = decode_watch(*args, **kwargs)
        watch.append(res is not None)
        return res

    monkeypatch.setattr(port_ld, "decode_list_page", page_spy)
    monkeypatch.setattr(port_ld, "decode_watch_lines", watch_spy)
    return backends, watch


def _without_python_headers(monkeypatch) -> None:
    """This host as one without ``Python.h``: the object decoder must
    then be neither built nor called."""
    def no_object_decoder():
        raise AssertionError("the object decoder was used without Python.h")

    monkeypatch.setattr(port_ld, "python_headers_present", lambda: False)
    monkeypatch.setattr(port_ld, "load_pylist", no_object_decoder)


@pytest.mark.parametrize("headers", [True, False], ids=["python_h", "no_python_h"])
def test_default_list_route_follows_python_headers(monkeypatch, headers):
    """The production LIST route: the object decoder where ``Python.h``
    exists, the columnar scanner where it is missing; the twin's
    ``json.loads`` error for a malformed page on both. Models equal the
    reference's default route."""
    from tests.test_torch_read_path import GOLDEN_NODES, GOLDEN_PODS, _body, model_t

    if not headers:
        _without_python_headers(monkeypatch)
    for kind, items in ((0, GOLDEN_NODES), (1, GOLDEN_PODS)):
        body = _body(items, cont="tok-1")
        page = port_ld.decode_list_page(body, kind)
        assert page.backend == ("pylist" if headers else "native")
        assert (page.rv, page.cont) == ("17", "tok-1")
        want = ref_ld.decode_list_page(body, kind).materialize()
        assert model_t(kind, page.materialize()) == model_t(kind, want)
    with pytest.raises(json.JSONDecodeError):
        port_ld.decode_list_page(b'{"items": [{"metadata": }]}', 0)


def test_mirror_without_python_headers_takes_the_scanner(stub, monkeypatch):
    """Where ``Python.h`` is missing: every LIST page on the columnar
    scanner, every watch batch on the per-line route and no reuse map,
    with the mirror equal to the reference client's and the stub through
    a bootstrap, a watch storm and a relist."""
    from tests.test_torch_read_path import mirror_t, stub_t

    _without_python_headers(monkeypatch)
    backends, watch = _spy_routes(monkeypatch)
    _annotated(stub, 40)
    for i in range(12):
        stub.state.add_pod("d", f"p{i}", spec={"nodeName": f"node-{i:03d}"})
    port = port_kube.KubeClusterClient(stub.url, list_page_limit=16)
    ref = ref_kube.KubeClusterClient(stub.url, list_page_limit=16)
    try:
        port.start()
        ref.start()
        assert _wait_until(lambda: mirror_t(port) == mirror_t(ref) == stub_t(stub.state))
        assert backends == ["native"] * 4  # 3 node pages + 1 pod page
        stub.state.storm_nodes(100)
        assert _wait_until(lambda: mirror_t(port) == mirror_t(ref) == stub_t(stub.state))
        port._relist_nodes()
        ref._relist_nodes()
        assert mirror_t(port) == mirror_t(ref) == stub_t(stub.state)
        assert set(backends) == {"native"} and len(backends) == 7
        assert watch == [] and port.rv_reuse_size() == 0 and port.watch_errors == 0
    finally:
        port.stop()
        ref.stop()


def test_mirror_relist_reuse_and_storm_equal_reference(stub, monkeypatch):
    """Bootstrap, a relist that reuses every unchanged instance, a watch
    storm, a patch and a relist after them: the port's mirror, reuse map
    and annotation columns equal the reference client's on its default
    routes, every LIST page decodes through the object decoder and every
    node batch through ``decode_watch_lines``."""
    from tests.test_torch_read_path import mirror_t, stub_t

    backends, watch = _spy_routes(monkeypatch)
    _annotated(stub, 40)
    for i in range(12):
        stub.state.add_pod("d", f"p{i}", spec={"nodeName": f"node-{i:03d}"})
    port = port_kube.KubeClusterClient(stub.url, list_page_limit=16)
    ref = ref_kube.KubeClusterClient(stub.url, list_page_limit=16)
    try:
        port.start()
        ref.start()
        assert _wait_until(lambda: mirror_t(port) == mirror_t(ref) == stub_t(stub.state))
        assert backends == ["pylist"] * 4  # 3 node pages + 1 pod page
        assert port.rv_reuse_size() == ref.rv_reuse_size() == 40
        before = {n.name: n for n in port.list_nodes()}
        port._relist_nodes()
        ref._relist_nodes()
        assert all(port.get_node(name) is node for name, node in before.items())
        assert port.rv_reuse_size() == 40
        cols = port.node_annotation_columns()
        assert cols[1] == sorted(before)
        stub.state.storm_nodes(100)
        assert _wait_until(lambda: mirror_t(port) == mirror_t(ref) == stub_t(stub.state))
        assert watch and all(watch)
        assert port.rv_reuse_size() == ref.rv_reuse_size() == 0  # every node moved
        assert port.patch_node_annotation("node-003", "m", "x")
        port._relist_nodes()
        ref._relist_nodes()
        assert port.rv_reuse_size() == ref.rv_reuse_size() == 40
        port._relist_nodes()
        version, names, keys, values, offsets = port.node_annotation_columns()
        got = {names[i]: dict(zip(keys[offsets[i]:offsets[i + 1]],
                                  values[offsets[i]:offsets[i + 1]])) for i in range(len(names))}
        assert got == {n.name: dict(n.annotations) for n in port.list_nodes()}
        # a patch after a relist with reuse: the journal-patched columns
        # follow the mirror
        assert port.patch_node_annotation("node-007", "m", "y")
        assert _wait_until(lambda: mirror_t(port) == stub_t(stub.state))
        version, names, keys, values, offsets = port.node_annotation_columns()
        got = {names[i]: dict(zip(keys[offsets[i]:offsets[i + 1]],
                                  values[offsets[i]:offsets[i + 1]])) for i in range(len(names))}
        assert got == {n.name: dict(n.annotations) for n in port.list_nodes()}
        assert got["node-007"]["m"] == "y"
        assert set(backends) == {"pylist"}
        assert port.watch_errors == 0
    finally:
        port.stop()
        ref.stop()


def test_relist_reuse_survives_concurrent_invalidation(stub):
    """Relists with reuse on one thread while two others drop reuse entries
    (as patches and watch deliveries do) under a short switch interval:
    no relist fails, the map keeps only live nodes, the mirror equals the
    stub."""
    import sys
    import threading

    from tests.test_torch_read_path import mirror_t, stub_t

    _annotated(stub, 60)
    client = port_kube.KubeClusterClient(stub.url, list_page_limit=16)
    names = [f"node-{i:03d}" for i in range(60)]
    errors, stop = [], threading.Event()

    def invalidate():
        while not stop.is_set():
            client._invalidate_node_rvs(names)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=invalidate) for _ in range(2)]
    try:
        client._relist_nodes()
        for t in threads:
            t.start()
        for _ in range(15):
            try:
                client._relist_nodes()
            except Exception as e:  # noqa: BLE001 - the invariant under test
                errors.append(e)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        sys.setswitchinterval(prev)
        client.stop()
    assert not errors and not any(t.is_alive() for t in threads)
    assert set(client._node_rvs) <= set(names)
    assert mirror_t(client) == stub_t(stub.state)
