"""The faults of ``Scheduler.schedule_queue``'s drip window, planted in
the port."""

import numpy as np


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


def plant(monkeypatch, fault: str) -> None:
    if fault == "state_unchanged":
        _no_op_bind(monkeypatch)
    elif fault == "score_altered":
        _score_fault(monkeypatch)
    elif fault in ("half_left_out", "answer_altered"):
        _drip_fault(monkeypatch, "half" if fault == "half_left_out" else "alter")
    else:
        raise ValueError(f"unknown fault {fault!r}")
