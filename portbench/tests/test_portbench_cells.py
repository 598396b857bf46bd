"""Each cell driven end to end on the CPU at a small size: the port's
placements, scores and bound counts equal the reference; a control in the
port's place, and each fault planted in the timed path, comes out not
correct."""

import time

import numpy as np
import pytest

from portbench.harness import load_manifest, run_cell

NODES = 1500  # a cluster a test run holds; the cells run 65,000
SECONDS = 0.5
SEED = 4_000_000_123  # beyond 32 signed bits, as the driver's are
CELLS = [w["name"] for w in load_manifest()["workloads"]]
# the control that breaks the cell's guarantee, and the faults it can have
CONTROL = {"drip_backlog": "no_fold"}


def run(cell, controls=False, trace=False, device="cpu"):
    return run_cell(load_manifest(), cell, SEED, SECONDS, trace, device, time.perf_counter(),
                    nodes=NODES, controls=controls)


def kind(cell):
    import json
    from pathlib import Path

    m = load_manifest()
    w = next(w for w in m["workloads"] if w["name"] == cell)
    root = Path(__file__).resolve().parents[2]
    return json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())["kind"]


@pytest.mark.parametrize("cell", CELLS)
def test_port_equals_reference_and_controls_fail(cell):
    r = run(cell, controls=True)
    assert r["correct"], r["checks"]
    assert r["controls"][CONTROL[kind(cell)]]["placement_mismatch"] > 0
    # the reference a precision below: read, not required to fail at this
    # size (PERF.md gives its readings at the cell's)
    assert all(v >= 0 for v in r["controls"]["float32"].values())
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    assert all(v["value"] > 0 for v in r["metrics"].values())


def _no_op_bind(monkeypatch):
    from crane_scheduler_tpu_torch.cluster.state import ClusterState

    def bind_pods(self, assignments, now=None, *a, **k):
        pairs = assignments.items() if isinstance(assignments, dict) else assignments
        return [key for key, _node in pairs]

    monkeypatch.setattr(ClusterState, "bind_pods", bind_pods)


def _drip_fault(monkeypatch, how):
    from crane_scheduler_tpu_torch.scorer.drip_batch import DripBatchKernel

    real = DripBatchKernel.dispatch

    def dispatch(self, schedulable, *a, **k):
        chosen, feasible, ties = real(self, schedulable, *a, **k)
        chosen = np.array(chosen)
        if how == "half":
            chosen[len(chosen) // 2:] = -1
        elif chosen[0] >= 0:
            chosen[0] = (chosen[0] + 1) % len(schedulable)
        return chosen, feasible, ties

    monkeypatch.setattr(DripBatchKernel, "dispatch", dispatch)


def _score_fault(monkeypatch):
    """The Dynamic score of one node off by one where the plugin makes it."""
    from crane_scheduler_tpu_torch.framework.drip import DripColumns

    real = DripColumns.ensure

    def ensure(self, *a, **k):
        out = real(self, *a, **k)
        if self.weighted is not None and not getattr(self, "_planted", False):
            self.weighted = self.weighted.copy()
            self.weighted[-1] += 1
            self._planted = True
        return out

    monkeypatch.setattr(DripColumns, "ensure", ensure)


FAULTS = {"drip_backlog": _drip_fault}


@pytest.mark.parametrize("fault", ("state_unchanged", "half_left_out", "answer_altered",
                                   "score_altered"))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(monkeypatch, cell, fault):
    if fault == "state_unchanged":
        _no_op_bind(monkeypatch)
    elif fault == "score_altered":
        _score_fault(monkeypatch)
    else:
        FAULTS[kind(cell)](monkeypatch, "half" if fault == "half_left_out" else "alter")
    r = run(cell)
    assert not r["correct"], (cell, fault, r["checks"])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_card(cuda_device, cell):
    r = run(cell, trace=True, device=cuda_device)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0 and r["device"]["window_s"] > 0
    assert r["metrics"] and "breakdown" in r
