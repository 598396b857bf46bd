"""The NRT cell (``numa-drip-65k``) on the CPU at a small size: the plain
reference (``reference/numa.py``) against the port's scalar loop, the
window's own fault (its zone fold skipped on the device), the controls'
readings, and the parent's refusal at set-up (a port whose window does
not take the plugin)."""

import time

import numpy as np
import pytest

import portbench.traffic
from portbench.harness import load_manifest, resolve, run_cell
from portbench.reference import numa as ref_numa
from portbench.tests.kinds.numa_backlog import ZONE_FAULT, plant

CELL = "numa-drip-65k"
SEED = 4_000_000_555


def small_backlog(monkeypatch, pods: int):
    load = portbench.traffic.load_traffic

    def cut(root, name):
        return dict(load(root, name), backlog_pods=pods)

    monkeypatch.setattr(portbench.traffic, "load_traffic", cut)


def test_reference_equals_the_scalar_loop(monkeypatch):
    """200 nodes, 700 pods placed one by one by the port's scalar plugin
    loop (``columnar=False``): placements, the last pod's scores, the
    counts and every zone result equal the plain reference's; both zones
    take pods."""
    small_backlog(monkeypatch, 700)
    _cell, config, traffic, kind = resolve(load_manifest(), CELL)
    driver = kind.Driver(config, traffic, SEED, "cpu", nodes=200)
    driver.setup(0)
    driver.sched._columnar = False
    driver.warm()
    while driver.step():
        pass
    assert len(driver.results) == 128 * 3 + 700
    assert driver.check() == {"placement_mismatch": 0, "score_mismatch": 0,
                              "count_mismatch": 0, "zone_mismatch": 0}
    got = driver.port()
    assert (got["takes"] > 0).any(axis=0).all()
    assert sum(node is not None for node in driver.results) > 600
    assert driver.sched.drip_stats()["batch"]["zone_windows"] == 1  # the probe alone


def test_vector_totals_equal_the_row_totals():
    """``class_totals`` (the reference's score vector per request class)
    against ``pack`` and ``nrt_score`` node by node, over zones in every
    state."""
    rng = np.random.default_rng(7)
    n, alloc = 400, [46000, 48000]
    used = rng.integers(0, 49, (n, 2)) * 1000
    used[::17, 0] = 50000  # overcommitted
    free = np.tile(np.array([94000, 376 << 30, 0, 110]), (n, 1))
    free[:, 0] -= used.sum(axis=1)  # Fit's room is the zones' room
    sched = rng.random(n) < 0.9
    weighted = rng.integers(0, 101, n) * 3
    for req in (2000, 4000, 8000, 16000):
        for aware in (False, True):
            vec = np.array([req, req // 1000 << 32, 0, 1])
            t, ok = ref_numa.class_totals(sched, weighted, free, used, alloc, vec, req, aware, 2)
            for i in range(n):
                takes = ref_numa.pack(alloc, used[i].tolist(), req, aware)
                fits = all(f >= v for f, v in zip(free[i], vec) if v > 0)
                want = (None if not (sched[i] and fits) or takes is None
                        else int(weighted[i]) + 2 * ref_numa.nrt_score(takes, aware))
                assert (int(t[i]) if bool(ok[i]) else None) == want


def test_zone_fold_skipped_is_not_correct(monkeypatch):
    plant(monkeypatch, ZONE_FAULT)
    r = run_cell(load_manifest(), CELL, SEED, 0.5, False, "cpu", time.perf_counter(),
                 nodes=1500)
    assert not r["correct"], r["checks"]
    assert r["checks"]["zone_mismatch"]["value"] > 0


def test_controls_read_not_correct():
    """The port is correct, and both controls that skip a fold break the
    cell's guarantee; the float32 reference is read."""
    r = run_cell(load_manifest(), CELL, SEED, 0.5, False, "cpu", time.perf_counter(),
                 nodes=1500, controls=True)
    assert r["correct"], r["checks"]
    for control in ("no_zone_fold", "no_fold"):
        assert any(v > 0 for v in r["controls"][control].values()), r["controls"]
    assert set(r["controls"]) == {"float32", "no_fold", "no_zone_fold"}


def test_a_port_without_the_nrt_window_fails_at_setup(monkeypatch):
    """A port that places these pods one by one (no NRT window) fails at
    set-up, before it makes the backlog."""
    from crane_scheduler_tpu_torch.framework.scheduler import Scheduler

    monkeypatch.setattr(Scheduler, "_window_recognition", Scheduler._recognition)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="NodeResourceTopologyMatch"):
        run_cell(load_manifest(), CELL, SEED, 0.5, False, "cpu", time.perf_counter(),
                 nodes=1500)
    assert time.perf_counter() - t0 < 30


def test_traced_run_reads_the_new_metrics(monkeypatch):
    """A traced run on the CPU (its operations standing in for the
    device's): ``numa.zone_ms`` and ``numa.window_roofline`` read numbers,
    beside the drip window's stage metrics."""
    import portbench.trace

    monkeypatch.setattr(portbench.trace, "_is_device", lambda e: True)
    r = run_cell(load_manifest(), CELL, SEED, 1.0, True, "cpu", time.perf_counter(),
                 nodes=1500)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert m["numa.zone_ms"]["value"] > 0 and m["numa.zone_ms"]["unit"] == "ms"
    assert 0 < m["numa.window_roofline"]["value"] < 100
    stages = [f"drip.{s}_ms" for s in ("admit", "prepare", "launch", "wait", "bind", "fold")]
    total = sum(m[s]["value"] for s in stages) + m["numa.zone_ms"]["value"]
    assert 0.90 <= total / r["window"]["mean_ms"] <= 1.01
    assert "drip.window_roofline" not in m
