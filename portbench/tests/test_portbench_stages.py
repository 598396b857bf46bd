"""The drip window's stage metrics and the profiled pods set apart, on the
CPU at a small size. The CPU's operations stand in for the device's in the
profiled stretch, so the trace's reduction has something to read."""

import time

import pytest

import portbench.trace
import portbench.traffic
from portbench.harness import load_manifest, resolve, run_cell

NODES = 1500
SEED = 4_000_000_777
CELL = "drip-65k"
STAGES = [f"drip.{s}_ms" for s in ("admit", "prepare", "launch", "wait", "bind", "fold")]


@pytest.fixture
def cpu_trace(monkeypatch):
    monkeypatch.setattr(portbench.trace, "_is_device", lambda e: True)


def run(seconds):
    return run_cell(load_manifest(), CELL, SEED, seconds, True, "cpu", time.perf_counter(),
                    nodes=NODES)


def test_stages_add_up_to_the_call(cpu_trace):
    r = run(1.0)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert set(STAGES) <= set(m), sorted(m)
    total = sum(m[s]["value"] for s in STAGES)
    assert 0.90 <= total / r["window"]["mean_ms"] <= 1.01, (total, r["window"])
    assert all(m[s]["unit"] == "ms" and m[s]["value"] >= 0 for s in STAGES)
    # the CPU's batch kernel never captures a graph: every window is eager
    assert m["drip.graph_replay_share"] == {"value": 0.0, "unit": "%"}


def test_a_cut_backlog_still_profiles_every_window(cpu_trace, monkeypatch, capsys):
    _cell, _config, traffic, kind = resolve(load_manifest(), CELL)
    window, calls = int(traffic["window"]), int(traffic["profile_calls"])
    load = portbench.traffic.load_traffic

    def cut(root, name):
        return dict(load(root, name), backlog_pods=window // 2)

    monkeypatch.setattr(portbench.traffic, "load_traffic", cut)
    seen = {}
    profile = kind.Driver.profile

    def spy(self, session, n):
        profile(self, session, n)
        seen.update(asked=n, profiled=self.profiled_calls, pods=len(self.results))

    monkeypatch.setattr(kind.Driver, "profile", spy)
    r = run(5.0)
    assert r["correct"], r["checks"]
    assert r["attempted"] == window // 2 and r["window"]["calls"] == 1
    assert seen["asked"] == seen["profiled"] == calls
    warm = window * (1 + int(traffic["warm_windows"]))
    assert seen["pods"] == warm + window // 2 + window * calls
    assert "window ended early" in capsys.readouterr().err
    assert r["metrics"]["drip.launches_per_window"]["value"] > 0
