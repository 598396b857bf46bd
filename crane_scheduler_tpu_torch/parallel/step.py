"""The full scheduling step on one device: score, then gang-assign.

Counterpart of ``ShardedScheduleStep`` (``crane_scheduler_tpu/parallel/
sharded.py``) for a single GPU. One step runs the fused Dynamic
filter+score (``BatchedScorer``; the float32 mode launches
``csrc/score_kernel.cu``), substitutes the hybrid f64 rescue rows, and
runs the water-filling solve (``GangScheduler``; its dense level totals
launch ``csrc/gang_totals.cu``). ``packed`` returns the cycle's single
device->host fetch, already started.

``prepare`` uploads a store snapshot with one pinned, non-blocking copy
per array; the hybrid risk scan runs on the host while those copies are
in flight. ``apply_delta`` (changed rows) and ``apply_columns`` (a replay
of the store's whole-column writes) bring a resident snapshot up to date
with a changed store without a full upload; ``with_overrides`` refreshes
the rescue vectors for a later wall time or for the rows those updates
touched (full or incremental; the incremental path patches the device
vectors with ``index_copy``).

Every update returns a new ``PreparedSnapshot`` and leaves the one it was
given as it was (out-of-place ``index_copy``, or a private clone that is
then written), as the reference's immutable arrays do: a pipelined loop
may still hold cycles dispatched against an older snapshot. Scatters
write exactly the changed rows; there is no padding to bound compiled
variants, and so no out-of-range index.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..policy.compile import PolicyTensors
from ..scorer.batched import BatchedScorer
from ..scorer.hybrid import compute_overrides_incremental
from ..scorer.topk import GangScheduler
from ..telemetry import maybe_span

# compact packed layout (single source of truth for pack AND unpack):
# per-node uint32 = counts(COMPACT_COUNT_BITS) | score | schedulable(msb).
# COMPACT_MAX_PODS bounds the burst size the counts field can carry
# (per-node counts never exceed the burst's pod total).
COMPACT_COUNT_BITS = 18
COMPACT_MAX_PODS = 1 << COMPACT_COUNT_BITS
_COMPACT_COUNT_MASK = COMPACT_MAX_PODS - 1
_COMPACT_SCORE_MASK = (1 << (31 - COMPACT_COUNT_BITS)) - 1

# Rebased (f32) snapshots must not age past this: the f32 rounding window
# of `now - epoch` grows with age, so with_overrides re-rebases past it.
EPOCH_REBASE_SECONDS = 6 * 3600.0


@dataclass
class PreparedSnapshot:
    """Device-resident scoring inputs.

    In float32 mode timestamps are stored rebased to ``epoch``; ``now``
    holds the rebased scheduling time as a Python float rounded to the
    dtype. A cached snapshot can be re-scored at a later wall time by
    passing ``now`` to the step call — the upload is not redone.
    """

    values: Any  # [N, M] dtype
    ts: Any  # [N, M] dtype (possibly rebased)
    hot_value: Any  # [N]
    hot_ts: Any  # [N] (possibly rebased)
    node_valid: Any  # [N] bool
    now: float  # rebased scheduling time, rounded to the dtype
    capacity: Any  # [N] int64
    offsets: Any = None  # [N] int32 combined-score offsets
    epoch: float = 0.0  # host-side rebase origin (0 in float64 mode)
    # hybrid-mode f64 rescue vectors (None when the step is not hybrid)
    ovr_mask: Any = None  # [N] bool
    ovr_sched: Any = None  # [N] bool
    ovr_score: Any = None  # [N] int32
    ovr_now: float | None = None  # wall-clock the overrides were computed at
    ovr_cache: Any = None  # host-side scorer.hybrid.OverrideCache
    ovr_rescan_rows: int = 0  # rows rescanned by the last override refresh


@dataclass
class StepResult:
    schedulable: Any  # [N] bool
    scores: Any  # [N] int32
    counts: Any  # [N] int32 — pods assigned per node
    unassigned: Any  # 0-dim int32
    waterline: Any  # 0-dim int32


class PackedFetch:
    """The device->host copy of one packed step result, started at
    construction: a non-blocking copy into a pinned host buffer and a CUDA
    event recorded after it. ``result()`` waits on the event (from any
    thread) and returns the host array — ``np.uint32`` for the compact
    layout, ``np.int32`` for the wide one."""

    def __init__(self, dev: torch.Tensor, compact: bool):
        self.compact = compact
        if dev.is_cuda:
            self._host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
            self._host.copy_(dev, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev.device))
        else:
            self._host = dev
            self._event = None

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        host = self._host.numpy()
        return host.view(np.uint32) if self.compact else host


class ScheduleStep:
    """score + gang-assign on one device."""

    def __init__(self, tensors: PolicyTensors, dtype=torch.float32, device=None,
                 telemetry=None, dynamic_weight: int = 1, max_offset: int = 0):
        """A float32 step is hybrid: every prepared snapshot carries
        host-computed f64 rescue rows (scorer.hybrid) that the step
        substitutes, giving bit-for-bit Go/f64 placement parity at f32
        throughput. A float64 step is the parity mode itself.
        ``telemetry``: optional spans for the uploads (``h2d_prepare``,
        ``h2d_delta``, ``h2d_columns``) and the hybrid ``risk_rescan``;
        they time the host's enqueue, never a device wait.
        ``dynamic_weight`` / ``max_offset``: the water-filling solve's
        combined-score domain (``GangScheduler``); the defaults are the
        plain Dynamic score."""
        self.device = resolve_device(device)
        self.telemetry = telemetry
        self.tensors = tensors
        self.hybrid = dtype != torch.float64
        self.scorer = BatchedScorer(tensors, dtype=dtype, device=self.device)
        self.gang = GangScheduler(tensors.hv_count, dynamic_weight=dynamic_weight,
                                  max_offset=max_offset, device=self.device)

    # -- the step ----------------------------------------------------------

    def _step(self, vecs, num_pods: int):
        values, ts, hot_value, hot_ts, node_valid, now, capacity, offsets = vecs[:8]
        schedulable, scores = self.scorer._score_impl(
            values, ts, hot_value, hot_ts, node_valid, now
        )
        if self.hybrid:
            ovr_mask, ovr_sched, ovr_score = vecs[8:]
            schedulable = torch.where(ovr_mask, ovr_sched & node_valid, schedulable)
            scores = torch.where(ovr_mask & node_valid, ovr_score, scores)
        counts, unassigned, waterline = self.gang._assign_impl(
            scores, schedulable, num_pods, capacity, offsets,
            torch.zeros_like(offsets),
        )
        return schedulable, scores, counts, unassigned, waterline

    def _step_packed(self, vecs, num_pods: int):
        """[3N+2] int32: schedulable | scores | counts | unassigned, level."""
        schedulable, scores, counts, unassigned, waterline = self._step(vecs, num_pods)
        return torch.cat([
            schedulable.to(torch.int32),
            scores.to(torch.int32),
            counts.to(torch.int32),
            torch.stack([unassigned, waterline]).to(torch.int32),
        ])

    def _step_packed_compact(self, vecs, num_pods: int):
        """[N+2] int32 holding uint32 words: per node ``counts(bits 0-17)
        | score(18-30) | schedulable(31)``; tail ``[unassigned,
        waterline]``. Built with int64 bit operations and stored as the
        same 32 bits in int32 (PyTorch's uint32 ops are thin); the host
        views it as ``np.uint32``. Sound while counts <= num_pods < 2^18
        (``packed`` enforces) and scores are in [0, 8191]."""
        schedulable, scores, counts, unassigned, waterline = self._step(vecs, num_pods)
        body = (
            counts.to(torch.int64)
            | (scores.to(torch.int64) << COMPACT_COUNT_BITS)
            | (schedulable.to(torch.int64) << 31)
        )
        tail = torch.stack([
            unassigned.to(torch.int64),
            waterline.to(torch.int64) & 0xFFFFFFFF,
        ])
        words = torch.cat([body, tail])
        return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)

    # -- uploads -----------------------------------------------------------

    def _np_dtype(self):
        return np.float64 if self.scorer.dtype == torch.float64 else np.float32

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """One host array to the device: a pinned, non-blocking copy on
        CUDA; a private copy on the CPU (snapshots are mutable hosts)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cpu":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def prepare(self, snapshot, now: float) -> PreparedSnapshot:
        """Upload a store snapshot. Host -> device transfer happens here,
        once per refresh; the step then reruns against the resident
        tensors for any pod batch. Capacity is unbounded (1 << 30 per
        node) and offsets are zero: the plain Dynamic-score domain."""
        with maybe_span(self.telemetry, "h2d_prepare", n=int(snapshot.n_nodes)):
            return self._prepare_impl(snapshot, now)

    def _prepare_impl(self, snapshot, now: float) -> PreparedSnapshot:
        np_dtype = self._np_dtype()
        ts = np.asarray(snapshot.ts, np.float64)
        hot_ts = np.asarray(snapshot.hot_ts, np.float64)
        now_value = float(now)
        epoch = 0.0
        if np_dtype != np.float64:
            epoch = now_value  # exact in f64; deltas small enough for f32
            ts = ts - epoch
            hot_ts = hot_ts - epoch
            now_value = 0.0
        n = ts.shape[0]
        up = self._upload
        prepared = PreparedSnapshot(
            values=up(np.asarray(snapshot.values, dtype=np_dtype)),
            ts=up(ts.astype(np_dtype)),
            hot_value=up(np.asarray(snapshot.hot_value, dtype=np_dtype)),
            hot_ts=up(hot_ts.astype(np_dtype)),
            node_valid=up(np.asarray(snapshot.node_valid, dtype=bool)),
            now=self.scorer.consts.round(now_value),
            capacity=up(np.full((n,), 1 << 30, dtype=np.int64)),
            offsets=up(np.zeros((n,), dtype=np.int32)),
            epoch=epoch,
        )
        if self.hybrid:
            # the risk scan overlaps the uploads still in flight
            prepared = dataclasses.replace(
                prepared, **self._override_vectors(snapshot, float(now))
            )
        return prepared

    def _override_vectors(self, snapshot, now: float, rebase_age: float = 0.0) -> dict:
        """Compute (a full scan) and upload the hybrid f64 rescue vectors
        for ``(snapshot, now)``."""
        ovr_mask, ovr_sched, ovr_score, _, new_cache, scanned = (
            compute_overrides_incremental(
                self.tensors, snapshot.values, snapshot.ts, snapshot.hot_value,
                snapshot.hot_ts, snapshot.node_valid, now, rebase_age=rebase_age,
            )
        )
        return {
            "ovr_mask": self._upload(ovr_mask),
            "ovr_sched": self._upload(ovr_sched),
            "ovr_score": self._upload(np.asarray(ovr_score, dtype=np.int32)),
            "ovr_now": now,
            "ovr_cache": new_cache,
            "ovr_rescan_rows": scanned,
        }

    def with_overrides(self, prepared: PreparedSnapshot, snapshot, now: float,
                       force: bool = False, dirty_rows=None) -> PreparedSnapshot:
        """Refresh the hybrid rescue vectors for a new wall time against
        the same resident snapshot. No-op for non-hybrid steps or (unless
        ``force``) when the overrides are current for ``now``.

        With the snapshot's incremental cache, only rows whose inputs
        changed (``dirty_rows``: the rows of a delta or column update;
        ``force`` with ``dirty_rows=None`` means unknown changes and a
        full rescan) or whose cached verdict can flip with the clock are
        rescanned, and those rows are copied into new device vectors with
        ``index_copy``. Past ``EPOCH_REBASE_SECONDS`` of snapshot age the
        timestamps are re-uploaded rebased around ``now``."""
        if not self.hybrid or (not force and prepared.ovr_now == float(now)):
            return prepared
        tel = self.telemetry
        if tel is None:
            return self._with_overrides_impl(prepared, snapshot, now, force, dirty_rows)
        t0 = time.perf_counter()
        out = self._with_overrides_impl(prepared, snapshot, now, force, dirty_rows)
        tel.spans.record("risk_rescan", t0, time.perf_counter(),
                         args={"rows": int(out.ovr_rescan_rows)})
        return out

    def _with_overrides_impl(self, prepared: PreparedSnapshot, snapshot, now: float,
                             force: bool, dirty_rows) -> PreparedSnapshot:
        age = abs(float(now) - prepared.epoch)
        if age > EPOCH_REBASE_SECONDS:  # hybrid is always non-f64
            np_dtype = np.float32
            ts = np.asarray(snapshot.ts, np.float64) - float(now)
            hot_ts = np.asarray(snapshot.hot_ts, np.float64) - float(now)
            return dataclasses.replace(
                prepared,
                ts=self._upload(ts.astype(np_dtype)),
                hot_ts=self._upload(hot_ts.astype(np_dtype)),
                now=0.0,
                epoch=float(now),
                **self._override_vectors(snapshot, float(now), rebase_age=0.0),
            )
        cache = prepared.ovr_cache if prepared.ovr_mask is not None else None
        if force and dirty_rows is None:
            cache = None  # unknown mutations: a full rescan is required
        if cache is None:
            return dataclasses.replace(
                prepared, **self._override_vectors(snapshot, float(now), rebase_age=age)
            )
        mask, sched, score, changed, new_cache, scanned = (
            compute_overrides_incremental(
                self.tensors, snapshot.values, snapshot.ts, snapshot.hot_value,
                snapshot.hot_ts, snapshot.node_valid, float(now),
                cache=cache, dirty_rows=dirty_rows, rebase_age=age,
            )
        )
        if changed is None:  # the cache was rebuilt: full re-upload
            return dataclasses.replace(
                prepared,
                ovr_mask=self._upload(mask),
                ovr_sched=self._upload(sched),
                ovr_score=self._upload(np.asarray(score, dtype=np.int32)),
                ovr_now=float(now), ovr_cache=new_cache,
                ovr_rescan_rows=scanned,
            )
        if changed.size == 0:  # nothing changed on device: no upload
            return dataclasses.replace(
                prepared, ovr_now=float(now), ovr_cache=new_cache,
                ovr_rescan_rows=0,
            )
        idx = self._upload(changed.astype(np.int64))
        return dataclasses.replace(
            prepared,
            ovr_mask=prepared.ovr_mask.index_copy(0, idx, self._upload(mask[changed])),
            ovr_sched=prepared.ovr_sched.index_copy(0, idx, self._upload(sched[changed])),
            ovr_score=prepared.ovr_score.index_copy(
                0, idx, self._upload(np.asarray(score[changed], dtype=np.int32))
            ),
            ovr_now=float(now), ovr_cache=new_cache, ovr_rescan_rows=scanned,
        )

    def with_vectors(self, prepared: PreparedSnapshot, capacity=None,
                     offsets=None) -> PreparedSnapshot:
        """A copy of a prepared snapshot with new per-node gang vectors,
        reusing the resident load tensors: only the ``[N]`` capacity
        (clipped to 2^31-1) and offset rows upload (the per-gang-request
        path)."""
        changes = {}
        if capacity is not None:
            capacity = np.minimum(np.asarray(capacity, np.int64), 2**31 - 1)
            changes["capacity"] = self._upload(capacity)
        if offsets is not None:
            changes["offsets"] = self._upload(np.asarray(offsets, np.int32))
        return dataclasses.replace(prepared, **changes) if changes else prepared

    # -- resident-snapshot updates -----------------------------------------

    def apply_delta(self, prepared: PreparedSnapshot, rows, values_rows, ts_rows,
                    hot_rows, hot_ts_rows) -> PreparedSnapshot:
        """Scatter changed rows into new copies of the resident arrays
        instead of re-uploading full matrices. Timestamps rebase to the
        snapshot's existing epoch (in float64 on the host, then cast), so
        the result equals a full ``prepare`` of the updated store at the
        same epoch bit for bit. Hybrid callers must refresh their override
        vectors afterwards: the rescue rows derive from the changed data."""
        k = len(rows)
        if k == 0:
            return prepared
        with maybe_span(self.telemetry, "h2d_delta", rows=int(k)):
            return self._apply_delta_impl(
                prepared, rows, values_rows, ts_rows, hot_rows, hot_ts_rows
            )

    def _apply_delta_impl(self, prepared, rows, values_rows, ts_rows, hot_rows,
                          hot_ts_rows) -> PreparedSnapshot:
        np_dtype = self._np_dtype()
        up = self._upload
        idx = up(np.asarray(rows, dtype=np.int64))
        ts_rows = np.asarray(ts_rows, np.float64) - prepared.epoch
        hot_ts_rows = np.asarray(hot_ts_rows, np.float64) - prepared.epoch
        return dataclasses.replace(
            prepared,
            values=prepared.values.index_copy(0, idx, up(np.asarray(values_rows, np_dtype))),
            ts=prepared.ts.index_copy(0, idx, up(ts_rows.astype(np_dtype))),
            hot_value=prepared.hot_value.index_copy(0, idx, up(np.asarray(hot_rows, np_dtype))),
            hot_ts=prepared.hot_ts.index_copy(0, idx, up(hot_ts_rows.astype(np_dtype))),
        )

    def apply_columns(self, prepared: PreparedSnapshot, entries, n: int) -> PreparedSnapshot:
        """Replay a store column-write log (``NodeLoadStore.
        column_delta_since``) against the resident arrays: a whole-column
        write uploads one [N] vector per touched column (its timestamps as
        one scalar when they are uniform), a partial one scatters its
        rows. Timestamps rebase to the snapshot's epoch. Scores and
        verdicts equal a full ``prepare`` of the updated store at the same
        epoch; pad rows may differ (a uniform timestamp stamps them too,
        a whole hot-value write pads with NaN), and they never score."""
        with maybe_span(self.telemetry, "h2d_columns", entries=int(len(entries))):
            return self._apply_columns_impl(prepared, entries, n)

    def _apply_columns_impl(self, prepared: PreparedSnapshot, entries, n: int) -> PreparedSnapshot:
        np_dtype = self._np_dtype()
        up = self._upload
        npad = int(prepared.capacity.shape[0])
        own: dict = {}

        def private(name):
            # one copy of each touched array per replay, then written in place
            t = own.get(name)
            if t is None:
                t = own[name] = getattr(prepared, name).clone()
            return t

        for col, ids, v, t, hv, ht in entries:
            full = len(ids) == n and np.array_equal(ids, np.arange(n, dtype=ids.dtype))
            idx = None if full else up(np.asarray(ids, dtype=np.int64))
            if col is not None:
                values, ts = private("values"), private("ts")
                t64 = np.asarray(t, np.float64) - prepared.epoch
                if full:
                    v_pad = np.full((npad,), np.nan)
                    v_pad[:n] = v
                    values[:, col] = up(v_pad.astype(np_dtype))
                    if t64.size and np.all(t64 == t64[0]):
                        # one scalar, rounded to the dtype on the host
                        ts[:, col] = float(np_dtype(t64[0]))
                    else:
                        t_pad = np.full((npad,), -np.inf)
                        t_pad[:n] = t64
                        ts[:, col] = up(t_pad.astype(np_dtype))
                else:
                    values[idx, col] = up(np.asarray(v, np_dtype))
                    ts[idx, col] = up(t64.astype(np_dtype))
            if hv is not None:
                ht64 = np.asarray(ht, np.float64) - prepared.epoch
                if full:
                    # fresh uploads: private already, nothing to clone
                    h_pad = np.full((npad,), np.nan)
                    h_pad[:n] = hv
                    ht_pad = np.full((npad,), -np.inf)
                    ht_pad[:n] = ht64
                    own["hot_value"] = up(h_pad.astype(np_dtype))
                    own["hot_ts"] = up(ht_pad.astype(np_dtype))
                else:
                    hot, hot_ts = private("hot_value"), private("hot_ts")
                    hot[idx] = up(np.asarray(hv, np_dtype))
                    hot_ts[idx] = up(ht64.astype(np_dtype))
        return dataclasses.replace(prepared, **own) if own else prepared

    # -- calls -------------------------------------------------------------

    def _args(self, prepared: PreparedSnapshot, now):
        now_value = (
            prepared.now if now is None
            else self.scorer.consts.round(float(now) - prepared.epoch)
        )
        vecs = (
            prepared.values, prepared.ts, prepared.hot_value, prepared.hot_ts,
            prepared.node_valid, now_value, prepared.capacity, prepared.offsets,
        )
        if self.hybrid:
            if prepared.ovr_mask is None:
                raise ValueError(
                    "hybrid step requires a snapshot prepared with overrides "
                    "(use prepare()/with_overrides of a hybrid step)"
                )
            if now is not None and prepared.ovr_now != float(now):
                raise ValueError(
                    "hybrid overrides are stale for this `now`; call "
                    "with_overrides(prepared, snapshot, now) first"
                )
            vecs = vecs + (prepared.ovr_mask, prepared.ovr_sched, prepared.ovr_score)
        return vecs

    def __call__(self, prepared: PreparedSnapshot, num_pods: int,
                 now: float | None = None) -> StepResult:
        return StepResult(*self._step(self._args(prepared, now), int(num_pods)))

    def packed(self, prepared: PreparedSnapshot, num_pods: int,
               now: float | None = None) -> PackedFetch:
        """Dispatch the step and start the fetch of its packed result.
        Bursts below ``COMPACT_MAX_PODS`` use the compact [N+2] layout
        (a third of the wide [3N+2] layout's bytes); larger bursts use
        the wide one. ``unpack`` tells them apart by dtype."""
        vecs = self._args(prepared, now)
        num_pods = int(num_pods)
        if num_pods < COMPACT_MAX_PODS:
            return PackedFetch(self._step_packed_compact(vecs, num_pods), compact=True)
        return PackedFetch(self._step_packed(vecs, num_pods), compact=False)

    @staticmethod
    def unpack(packed_host: np.ndarray, n: int):
        """Split a fetched packed result into host-side step outputs
        (wide int32 or compact uint32 — see ``_step_packed_compact``)."""
        if packed_host.dtype == np.uint32:
            body = packed_host[:n]
            counts = (body & _COMPACT_COUNT_MASK).astype(np.int32)
            scores = (
                (body >> COMPACT_COUNT_BITS) & _COMPACT_SCORE_MASK
            ).astype(np.int32)
            schedulable = (body >> 31).astype(bool)
            unassigned = int(packed_host[-2])
            waterline = int(packed_host[-2:].view(np.int32)[1])
            return schedulable, scores, counts, unassigned, waterline
        npad = (packed_host.shape[0] - 2) // 3
        schedulable = packed_host[:n].astype(bool)
        scores = packed_host[npad : npad + n]
        counts = packed_host[2 * npad : 2 * npad + n]
        unassigned = int(packed_host[3 * npad])
        waterline = int(packed_host[3 * npad + 1])
        return schedulable, scores, counts, unassigned, waterline
