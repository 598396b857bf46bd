"""The faults of the NRT drip window (``Scheduler.schedule_queue`` with
``NodeResourceTopologyMatch``), planted in the port: the drip window's,
through the NRT window's own dispatch (``DripBatchKernel.dispatch_numa``),
and one of its own, ``ZONE_FAULT``: the zone fold skipped on the device,
so every pod of a window sees the zones as they were at its start."""

import numpy as np

from portbench.tests.kinds import drip_backlog as plain

ZONE_FAULT = "zone_fold_skipped"


def _dispatch_fault(monkeypatch, how):
    from crane_scheduler_tpu_torch.scorer.drip_batch import DripBatchKernel

    real = DripBatchKernel.dispatch_numa

    def dispatch_numa(self, schedulable, *a, **k):
        chosen, feasible, ties, bad, takes = real(self, schedulable, *a, **k)
        chosen = np.array(chosen)
        if how == "half":
            chosen[len(chosen) // 2:] = -1
        elif chosen[0] >= 0:
            chosen[0] = (chosen[0] + 1) % len(schedulable)
        return chosen, feasible, ties, bad, takes

    monkeypatch.setattr(DripBatchKernel, "dispatch_numa", dispatch_numa)


def _zone_fold_skipped(monkeypatch):
    import torch

    from crane_scheduler_tpu_torch.scorer import drip_batch

    real = drip_batch._drip_batch_numa

    def window(schedulable, weighted, bounded, free, vecs, active, zcols, used, pods,
               want_ties=True):
        # each pod alone over the window's zone carry: the free rows fold,
        # the zones never do
        rows = []
        for k in range(vecs.shape[0]):
            outs, free, _folded = real(schedulable, weighted, bounded, free, vecs[k:k + 1],
                                       active[k:k + 1], zcols, used, pods[k:k + 1],
                                       want_ties=want_ties)
            rows.append(outs)
        return torch.cat(rows), free, used.clone()

    monkeypatch.setattr(drip_batch, "_drip_batch_numa", window)


def plant(monkeypatch, fault: str) -> None:
    if fault in ("state_unchanged", "score_altered"):
        plain.plant(monkeypatch, fault)
    elif fault in ("half_left_out", "answer_altered"):
        _dispatch_fault(monkeypatch, "half" if fault == "half_left_out" else "alter")
    elif fault == ZONE_FAULT:
        _zone_fold_skipped(monkeypatch)
    else:
        raise ValueError(f"unknown fault {fault!r}")
