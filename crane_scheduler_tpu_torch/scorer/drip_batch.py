"""Device-resident drip batch window: mask + argmax + fold for K pods.

Counterpart of ``crane_scheduler_tpu/scorer/drip_batch.py``. The
reference's ``_drip_batch`` is a jitted XLA program (a ``lax.scan``), not a
Pallas kernel; here it is the plain PyTorch function ``_drip_batch``, whose
K dependent steps run as PyTorch kernels on the caller's device:

    for each pod k (sequentially):
        fit_fail = bounded & any(vec_k > 0 & free < vec_k)
        mask     = schedulable & ~fit_fail
        best     = argmax(where(mask, weighted, INT64_MIN))
        free[best] -= vec_k                       # the fold
        emit (best, feasible_count, tie_count)

so later pods in the window see earlier folds exactly like the sequential
host loop, and the host gets all K verdicts in one device-to-host copy (a
packed ``[K, 3]`` int64 tensor). The loop issues no host synchronisation:
the winning index stays a device tensor and indexes the fold directly. The
window is pure: the host columns stay authoritative and untouched until
the scheduler accepts it, which is what makes the optimistic tie-break
replay in ``Scheduler.schedule_queue`` free.

The math is exact int64 (memory bytes exceed int32). ``torch.argmax``
returns the first maximum, as ``np.argmax`` and XLA's argmax do. Shapes
are not padded to the reference's buckets: nothing here compiles per
shape. ``_drip_batch`` still takes padded inputs (padded nodes are
``schedulable=False``, padded pods ``active=False``) with the reference's
results.

The fold carry stays on the device across windows: after a fully accepted
window the host applies the same integer folds to its own ``free`` copy
(``mark_synced``), so the next dispatch skips the ``[N, 4]`` upload.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.column_cache import SINGLE_DEVICE, DeviceColumnCache, upload

__all__ = ["DripBatchKernel", "drip_batch_dispatch"]

_I64_MIN = int(np.iinfo(np.int64).min)


def _drip_batch(schedulable, weighted, bounded, free, vecs, active, want_ties=True):
    """One dispatch window over device tensors: ``schedulable`` bool [N],
    ``weighted`` int64 [N], ``bounded`` bool [N], ``free`` int64 [N, 4],
    ``vecs`` int64 [K, 4], ``active`` bool [K]. Returns ``(outs, free)``:
    ``outs`` int64 [K, 3] of (chosen or -1, feasible count, tie count) and
    the folded carry, a new tensor (``free`` is not written).

    ``want_ties=False`` drops the tie reduction and reports a constant 1,
    as the reference's unseeded program does. With no feasible row argmax
    gives 0, the fold's delta is zeroed and the row reads ``[-1, 0,
    ties]``, where ``ties`` counts ``mask & (weighted == INT64_MIN)``: 0."""
    free = free.clone()
    dev = free.device
    # per-pod operands for every step at once: the fold's negated delta
    # (zero for padded pods) and the one-row index view of the winner
    neg_delta = torch.where(active[:, None], -vecs, torch.zeros_like(vecs))
    need = vecs > 0
    minus_one = torch.full((), -1, dtype=torch.int64, device=dev)
    one = torch.ones((), dtype=torch.int64, device=dev)
    zero_row = torch.zeros((1, vecs.shape[1]), dtype=torch.int64, device=dev)
    rows = []
    for k in range(vecs.shape[0]):
        vec = vecs[k]
        fit_fail = bounded & (need[k] & (free < vec)).any(dim=1)
        mask = schedulable & ~fit_fail
        w = torch.where(mask, weighted, _I64_MIN)
        best = torch.argmax(w).reshape(1)  # first maximum, like np.argmax
        feasible = mask.sum(dtype=torch.int64)
        if want_ties:
            ties = (mask & (weighted == w.gather(0, best))).sum(dtype=torch.int64)
        else:
            ties = one
        some = feasible > 0
        free.index_add_(0, best, torch.where(some, neg_delta[k : k + 1], zero_row))
        rows.append(torch.stack([torch.where(some, best[0], minus_one), feasible, ties]))
    if not rows:
        return torch.zeros((0, 3), dtype=torch.int64, device=dev), free
    return torch.stack(rows), free


def col_delta_rows(cols: DeviceColumnCache, name: str, arr, col_version, col_delta):
    """The rows to scatter into the cached device copy of column ``name``
    (``DeviceColumnCache.put(delta_rows=)``), or None for a full upload:
    no ``col_delta`` source, no held slot for this array, or a chain the
    scatter log no longer covers."""
    if col_delta is None:
        return None
    held = cols.held_version(name, arr)
    if held is None or held == col_version:
        return None
    return col_delta(held, col_version)


class DripBatchKernel:
    """Host wrapper: device column placement and fold-carry reuse.

    One instance per ``Scheduler`` (single scheduling loop, like
    ``DripColumns``). The dynamic and fit columns are cached on the device
    by identity (``DeviceColumnCache``; rebuilds replace host arrays, so
    identity is the version). The ``free`` carry is the only column the
    window advances: ``mark_synced`` tells the wrapper the host applied the
    very same folds (exact int64 subtraction, so device == host bit for
    bit) and the carry may be reused; anything else — replay, partial
    bind, column drop — calls ``mark_desynced`` and the next dispatch
    re-uploads from the host.

    ``device``: ``None`` means the GPU (raises without one); ``"cpu"``
    runs the same PyTorch code on the CPU. ``mesh`` must be None: the
    shard-parallel window comes with the multi-GPU slice.
    """

    def __init__(self, device=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= is not ported: the shard-parallel drip window "
                "(_sharded_drip_fn) comes with the multi-GPU slice "
                "(ROADMAP Queue 1 item 7)"
            )
        self.device = resolve_device(device)
        self._cols = DeviceColumnCache(self.device)
        self._cols.set_partition(SINGLE_DEVICE)
        self._free_dev = None  # device fold carry [N, 4]
        self._free_src = None  # host free array the carry mirrors
        self._free_synced = False
        self._host_out = None  # pinned [K, 3] landing buffer (CUDA only)
        self._event = None
        self.dispatches = 0
        self.free_uploads = 0
        self.last_kernel_seconds = 0.0

    def mark_synced(self, host_free) -> None:
        """Host applied exactly the window's folds — carry is reusable."""
        self._free_src = host_free
        self._free_synced = True

    def mark_desynced(self) -> None:
        self._free_synced = False
        self._free_dev = None
        self._free_src = None

    def _fetch(self, outs: torch.Tensor) -> np.ndarray:
        """The window's single device-to-host copy: into a reused pinned
        buffer with an event behind it, returned as a private array."""
        if not outs.is_cuda:
            return outs.numpy()
        k = outs.shape[0]
        if self._host_out is None or self._host_out.shape[0] < k:
            self._host_out = torch.empty((k, 3), dtype=torch.int64, pin_memory=True)
            self._event = torch.cuda.Event()
        host = self._host_out[:k]
        host.copy_(outs, non_blocking=True)
        self._event.record(torch.cuda.current_stream(outs.device))
        self._event.synchronize()
        return host.numpy().copy()

    def dispatch(
        self,
        schedulable: np.ndarray,
        weighted: np.ndarray,
        bounded: np.ndarray | None,
        free: np.ndarray | None,
        vecs: np.ndarray,
        want_ties: bool = True,
        col_version: int = 0,
        col_delta=None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Run one window; returns ``(chosen, feasible, ties)`` int64[K]
        (chosen = -1 where no feasible node; ties is a constant 1 when
        ``want_ties`` is False). Pure with respect to the host columns; the
        device fold carry advances and is kept for reuse.

        ``col_version`` is the dynamic columns' epoch
        (``DripColumns.col_epoch``): O(dirty) refreshes patch the host
        arrays in place, so identity alone does not key freshness.
        ``col_delta(held, current)`` (``DripColumns.dirty_rows_between``)
        turns a version miss into a row scatter on the device instead of a
        full column upload; returning None falls back to the upload."""
        n = int(schedulable.shape[0])
        k = int(vecs.shape[0])
        t0 = time.perf_counter()
        if n == 0:
            # no node: every pod is infeasible, as the reference's padded
            # rows report (no tie among infeasible rows; 1 without ties)
            self.mark_desynced()
            self.dispatches += 1
            self.last_kernel_seconds = time.perf_counter() - t0
            ties = np.zeros(k, np.int64) if want_ties else np.ones(k, np.int64)
            return np.full(k, -1, np.int64), np.zeros(k, np.int64), ties
        cols = self._cols
        sched_d = cols.put("schedulable", schedulable, version=col_version,
                           delta_rows=col_delta_rows(cols, "schedulable", schedulable,
                                                     col_version, col_delta))
        w_d = cols.put("weighted", weighted, version=col_version,
                       prepare=lambda a: a.astype(np.int64),
                       delta_rows=col_delta_rows(cols, "weighted", weighted,
                                                 col_version, col_delta),
                       row_prepare=lambda v: v.astype(np.int64))
        if bounded is None or free is None:
            # tracker-less plugin set: fit never fails
            bounded = np.zeros((n,), dtype=bool)
            free = np.zeros((n, 4), dtype=np.int64)
        bnd_d = cols.put("bounded", bounded)
        free_d = self._free_dev
        if not self._free_synced or free_d is None or self._free_src is not free:
            free_d = upload(free, self.device)
            self._free_src = free
            self.free_uploads += 1
        vecs_d = upload(np.asarray(vecs, dtype=np.int64).reshape(k, 4), self.device)
        active = torch.ones((k,), dtype=torch.bool, device=self.device)
        outs, free_out = _drip_batch(sched_d, w_d, bnd_d, free_d, vecs_d, active,
                                     want_ties=want_ties)
        host = self._fetch(outs)
        self._free_dev = free_out
        self._free_synced = True  # provisional; the caller desyncs on reject
        self.last_kernel_seconds = time.perf_counter() - t0
        self.dispatches += 1
        return host[:, 0], host[:, 1], host[:, 2]


def drip_batch_dispatch(schedulable, weighted, bounded, free, vecs, device=None):
    """One-shot functional entry (benchmarks, tests): no carry reuse."""
    return DripBatchKernel(device=device).dispatch(schedulable, weighted, bounded, free, vecs)
