"""Each cell driven end to end on the CPU at a small size: every number
that the cell's kind compares with the reference is within its limit; the
kind's control that breaks the cell's guarantee, in the port's place, and
each fault that the kind's fault file plants in the timed path, come out
not correct."""

import time

import pytest

from portbench.harness import load_manifest, resolve, run_cell
from portbench.tests.kinds import FAULTS, planter

NODES = 1500  # a cluster a test run holds; the cells run 65,000
SECONDS = 0.5
SEED = 4_000_000_123  # beyond 32 signed bits, as the driver's are
CELLS = [w["name"] for w in load_manifest()["workloads"]]


def run(cell, controls=False, trace=False, device="cpu"):
    return run_cell(load_manifest(), cell, SEED, SECONDS, trace, device, time.perf_counter(),
                    nodes=NODES, controls=controls)


def kind(cell) -> str:
    return resolve(load_manifest(), cell)[2]["kind"]


def broken(numbers: dict, checks: dict) -> bool:
    """Whether any number exceeds the limit that the run's checks give it."""
    return any(v > checks[k]["limit"] for k, v in numbers.items())


@pytest.mark.parametrize("cell", CELLS)
def test_port_equals_reference_and_controls_fail(cell):
    r = run(cell, controls=True)
    assert r["correct"], r["checks"]
    # every control reports every number compared; the one that breaks the
    # cell's guarantee comes out not correct, the others are read, not
    # required to fail at this size (PERF.md gives their readings at the
    # cell's)
    assert all(list(v) == list(r["checks"]) and min(v.values()) >= 0
               for v in r["controls"].values())
    breaks = resolve(load_manifest(), cell)[3].Driver.breaks
    assert broken(r["controls"][breaks], r["checks"]), r["controls"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    assert all(v["value"] > 0 for v in r["metrics"].values())


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(monkeypatch, cell, fault):
    planter(kind(cell))(monkeypatch, fault)
    r = run(cell)
    assert not r["correct"], (cell, fault, r["checks"])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_card(cuda_device, cell):
    r = run(cell, trace=True, device=cuda_device)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0 and r["device"]["window_s"] > 0
    assert r["metrics"] and "breakdown" in r
