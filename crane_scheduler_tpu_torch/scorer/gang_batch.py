"""Device-resident multi-gang window: water-filling for K gangs in a row.

Counterpart of ``crane_scheduler_tpu/scorer/gang_batch.py``.
``BatchScheduler.schedule_gang`` solves one gang per call: a full
``refresh()``, a ``_prepare`` and one solve each time. This module is the
gang twin of ``scorer.drip_batch``: one window takes the version-cached
gang columns (raw Dynamic score, schedulable mask, fit free matrix —
``framework.drip.GangColumns``) and K heterogeneous gangs (per-gang pod
count, request row, per-class score offsets) and runs

    for each gang k (sequentially, on the device):
        cap      = copies of vec_k fitting in the free carry
        counts   = water-filling split (GangScheduler._assign_impl)
        free    -= counts · vec_k                  # the fold
        emit (counts, unassigned, waterline)

so later gangs see earlier gangs' capacity consumption exactly like a
sequential ``schedule_gang(bind=True)`` loop, and the host gets all K
verdicts in one device-to-host copy (a ``[K, N+2]`` int32 tensor).

The reference's jitted ``lax.scan`` finds the waterline with a fixed-trip
binary search over the monotone ``totals(L) >= P`` predicate. Here each
gang step calls the port's own ``GangScheduler._assign_impl`` with a zero
prior, which takes every level total of the dense grid in one launch of
the gang totals kernel (``csrc/gang_totals.cu``) on CUDA tensors. totals
is non-increasing in L, so the highest satisfying level of the dense grid
is the level the binary search finds; the zero-prior level table is the
reference's prior-free ``_a_table``; both clip per-node tokens to
``(2^31-1)//n`` with the unpadded n. One water-filling implementation
serves the burst step, ``schedule_gang`` and this window. The capacity
carry stays int64 and the solve int32, as in the reference; the loop
makes no host synchronisation (``_assign_impl`` selects both outcomes on
the device).

Columns are cached on the device by ``(identity, col_epoch)`` through
``parallel.column_cache.DeviceColumnCache``: an O(dirty) dynamic patch
scatters only the journal's dirty rows, and the free fold carry stays
resident across windows under the drip path's ``mark_synced`` discipline
(exact int64 subtraction on both sides, so device == host bit for bit).
Shapes are not padded to the reference's buckets: nothing here compiles
per shape.

``gang_window_host`` is the numpy twin of the whole window: the parity
reference for the device window and the engine for tie policies the
prefix split cannot express (fragmentation-aware and seeded splits
reorder the waterline take on the host via ``waterline_take``).
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from ..constants import MAX_NODE_SCORE
from ..device import resolve_device
from ..fit.tracker import UNBOUNDED, copy_counts_rows
from ..parallel.column_cache import SINGLE_DEVICE, DeviceColumnCache, upload
from ..topology.batched import stranded_copies
from .drip_batch import col_delta_rows
from .topk import GangResult, GangScheduler, gang_assign_host

__all__ = ["GangBatchKernel", "gang_window_host", "stranded_copies"]

_I32_MAX = 2**31 - 1


def _tie_order_for(tie_policy, tie_rng, capacity, n):
    """Per-gang ``tie_order`` closure for ``gang_assign_host``.

    - ``"fragmentation"``: waterline tokens go to the nodes that would
      strand the least copy capacity if drained (ascending stranded
      count, node index breaking exact ties).
    - ``"seeded"``: a seeded random permutation; one ``rng.random(n)``
      draw per gang regardless of window size, so RNG consumption is
      identical however the queue is windowed.
    """
    if tie_policy is None:
        return None
    idx = np.arange(n)
    if tie_policy == "fragmentation":
        cap = capacity
        if cap is None:
            cap = np.full((n,), _I32_MAX, dtype=np.int64)

        def order(exact, upper, l_star, _cap=cap):
            return np.lexsort((idx, stranded_copies(_cap, upper, exact)))

        return order
    if tie_policy == "seeded":
        if tie_rng is None:
            raise ValueError("tie_policy='seeded' needs tie_rng")

        def order(exact, upper, l_star):
            return np.lexsort((idx, tie_rng.random(n)))

        return order
    raise ValueError(f"unknown tie_policy: {tie_policy!r}")


def gang_window_host(
    scores,
    schedulable,
    bounded,
    free,
    gangs,
    hv_counts: Sequence[int],
    dynamic_weight: int = 1,
    max_offset: int = 0,
    tie_policy=None,
    tie_rng=None,
    fold: bool = True,
) -> tuple[list[GangResult], np.ndarray | None]:
    """Numpy twin of one window: solve each gang in ``gangs`` (an iterable
    of ``(num_pods, request_vec, offsets-or-None)``) against an evolving
    free-matrix copy, exactly the device carry's semantics. Returns
    ``(results, free_after)``; the caller's arrays are never written.
    ``fold=False`` solves every gang against the same initial capacity
    (the ``bind=False`` preview: with nothing bound, sequential
    ``schedule_gang`` calls see no capacity evolution either)."""
    free_c = None if free is None else np.array(free, dtype=np.int64)
    n = len(np.asarray(scores))
    results: list[GangResult] = []
    for num_pods, vec, offs in gangs:
        cap = None
        if free_c is not None and bounded is not None:
            cap = copy_counts_rows(free_c, bounded, np.asarray(vec, np.int64))
        r = gang_assign_host(
            scores,
            schedulable,
            int(num_pods),
            hv_counts,
            capacity=cap,
            offsets=offs,
            dynamic_weight=dynamic_weight,
            max_offset=max_offset,
            tie_order=_tie_order_for(tie_policy, tie_rng, cap, n),
        )
        if fold and free_c is not None:
            free_c -= (
                np.asarray(r.counts, np.int64)[:, None]
                * np.asarray(vec, np.int64)[None, :]
            )
        results.append(r)
    return results, free_c


def _copy_capacity(free, bounded, vec, need, q):
    """``copy_counts_rows`` on the device: int64 [N] free carry in, int32
    [N] copy capacity out, clipped to [0, 2^31-1]. Operands are clamped
    to >= 0 before the floor division; rows with no requested dimension,
    and unbounded rows, get UNBOUNDED."""
    per = torch.where(
        need[None, :],
        torch.div(torch.clamp(free, min=0), q[None, :], rounding_mode="floor"),
        UNBOUNDED,
    )
    cap = torch.clamp(per.min(dim=1).values, max=UNBOUNDED)
    cap = torch.where(bounded, cap, UNBOUNDED)
    return torch.clamp(cap, 0, _I32_MAX).to(torch.int32)


class GangBatchKernel:
    """Host wrapper: device column placement and fold-carry reuse.

    One instance per gang engine (single scheduling loop, like
    ``DripBatchKernel``), static over (hotValue table, dynamic weight, max
    offset). The gang columns are cached on the device keyed on
    ``GangColumns.col_epoch`` with journal-driven row scatters; the
    ``free`` carry advances on the device and is reusable only while the
    host replays the identical folds (``mark_synced``).

    ``device``: ``None`` means the GPU (raises without one); ``"cpu"``
    runs the same PyTorch code, with the gang totals kernel's plain
    version, on the CPU."""

    def __init__(
        self,
        hv_counts: Sequence[int],
        dynamic_weight: int = 1,
        max_offset: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        # validates the weight and offset bound
        self._gang = GangScheduler(hv_counts, dynamic_weight=dynamic_weight,
                                   max_offset=max_offset, device=self.device)
        self._n_levels = MAX_NODE_SCORE * int(dynamic_weight) + int(max_offset) + 2
        self._cols = DeviceColumnCache(self.device)
        self._cols.set_partition(SINGLE_DEVICE, self.device)
        self._free_dev = None  # device fold carry [N, 4]
        self._free_src = None  # host free array the carry mirrors
        self._free_synced = False
        self._host_out = None  # pinned [K, N+2] landing buffer (CUDA only)
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

    def _window(self, s, schedulable, bounded, free, vecs, offs, class_id, num_pods):
        """The K-gang loop over device tensors: ``s`` int32 [N] scores,
        ``schedulable``/``bounded`` bool [N], ``free`` int64 [N, 4] carry
        (not written), ``vecs`` int64 [C, 4], ``offs`` a list of C int32
        [N] rows; ``class_id`` and ``num_pods`` host ints per gang.
        Returns ``(outs int32 [K, N+2], free after the folds)``."""
        need = vecs > 0
        q = torch.where(need, vecs, 1)
        zero_prior = torch.zeros_like(s)
        rows = []
        for cid, p in zip(class_id, num_pods):
            cap = _copy_capacity(free, bounded, vecs[cid], need[cid], q[cid])
            counts, unassigned, waterline = self._gang._assign_impl(
                s, schedulable, p, cap, offs[cid], zero_prior
            )
            free = free - counts[:, None].to(torch.int64) * vecs[cid][None, :]
            rows.append(torch.cat([counts, torch.stack([unassigned, waterline])]))
        return torch.stack(rows), free

    def _fetch(self, outs: torch.Tensor) -> np.ndarray:
        """The window's single device-to-host copy: into a reused pinned
        buffer with an event behind it, returned as a private array."""
        if not outs.is_cuda:
            return outs.numpy()
        k, width = outs.shape
        host = self._host_out
        if host is None or host.shape[1] != width or host.shape[0] < k:
            host = self._host_out = torch.empty((k, width), dtype=torch.int32,
                                                pin_memory=True)
            self._event = torch.cuda.Event()
        host = host[:k]
        host.copy_(outs, non_blocking=True)
        self._event.record(torch.cuda.current_stream(outs.device))
        self._event.synchronize()
        return host.numpy().copy()

    def dispatch(
        self,
        score: np.ndarray,
        schedulable: np.ndarray,
        bounded: np.ndarray,
        free: np.ndarray,
        vecs: np.ndarray,
        offsets,
        class_id,
        num_pods,
        col_version: int = 0,
        col_delta=None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Run one window of K >= 1 gangs; returns ``(counts, unassigned,
        waterline)`` — int32 ``[K, N]`` / ``[K]`` / ``[K]`` — from one
        device-to-host copy. ``bounded``/``free`` are the fit columns
        (``GangColumns`` always has a tracker). ``vecs`` is the ``[C, 4]``
        class request matrix, ``offsets`` a length-C list of per-class int32 offset rows
        (or None for all-zero), ``class_id``/``num_pods`` length-K per-gang
        arrays. Pure with respect to the host columns; the device fold
        carry advances and is kept for reuse. ``col_version``/``col_delta``
        follow ``DripBatchKernel.dispatch``'s epoch-scatter contract."""
        n = int(score.shape[0])
        c = int(vecs.shape[0])
        t0 = time.perf_counter()
        cols = self._cols
        s_d = cols.put(
            "gang:score", score, version=col_version,
            prepare=lambda a: a.astype(np.int32),
            delta_rows=col_delta_rows(cols, "gang:score", score, col_version, col_delta),
            row_prepare=lambda v: v.astype(np.int32),
        )
        sched_d = cols.put(
            "gang:schedulable", schedulable, version=col_version,
            delta_rows=col_delta_rows(cols, "gang:schedulable", schedulable,
                                      col_version, col_delta),
        )
        bnd_d = cols.put("gang:bounded", bounded)
        free_d = self._free_dev
        if not self._free_synced or free_d is None or self._free_src is not free:
            free_d = upload(np.asarray(free, dtype=np.int64), self.device)
            self._free_src = free
            self.free_uploads += 1
        if offsets is None:
            zeros = torch.zeros((n,), dtype=torch.int32, device=self.device)
            offs_d = [zeros] * c
        else:
            offs_d = [
                cols.put(f"gang:offs:{i}", row, prepare=lambda a: a.astype(np.int32))
                for i, row in enumerate(offsets)
            ]
        vecs_d = upload(np.ascontiguousarray(vecs, dtype=np.int64).reshape(c, 4), self.device)
        pods = [int(min(int(p), _I32_MAX)) for p in np.asarray(num_pods).tolist()]
        cids = [int(i) for i in np.asarray(class_id).tolist()]
        outs, free_out = self._window(s_d, sched_d, bnd_d, free_d, vecs_d, offs_d, cids, pods)
        host = self._fetch(outs)
        self._free_dev = free_out
        self._free_synced = True  # provisional; the caller desyncs on reject
        self.last_kernel_seconds = time.perf_counter() - t0
        self.dispatches += 1
        return host[:, :n], host[:, n], host[:, n + 1]
