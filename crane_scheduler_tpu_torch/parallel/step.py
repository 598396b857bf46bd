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

The uploads and updates are written once over spans, the ``(device,
start, stop)`` of each tile in the host snapshot's rows: here one span
over every row, and ``ShardedScheduleStep`` (``parallel/sharded.py``)
says where its tiles lie and keeps only its own step body.

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
from .column_cache import upload

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

    def rows(self) -> int:
        """The padded node rows the snapshot holds."""
        return int(self.capacity.shape[0])


@dataclass
class StepResult:
    schedulable: Any  # [N] bool
    scores: Any  # [N] int32
    counts: Any  # [N] int32 — pods assigned per node
    unassigned: Any  # 0-dim int32
    waterline: Any  # 0-dim int32


def compact_body(schedulable, scores, counts):
    """The compact layout's per-node words, as int64."""
    return (
        counts.to(torch.int64)
        | (scores.to(torch.int64) << COMPACT_COUNT_BITS)
        | (schedulable.to(torch.int64) << 31)
    )


def compact_tail(unassigned, waterline):
    """The compact layout's ``[unassigned, waterline]`` words, as int64."""
    return torch.stack([unassigned.to(torch.int64), waterline.to(torch.int64) & 0xFFFFFFFF])


def compact_words(parts):
    """int64 word pieces (one device), concatenated and stored as the same
    32 bits in int32."""
    words = torch.cat(parts)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def split_rows(rows, spans):
    """Per span ``(tile-local ids, positions in rows)`` for host-numbered
    ``rows``; rows outside every span drop."""
    rows = np.asarray(rows, dtype=np.int64)
    out = []
    for _dev, a, b in spans:
        pos = np.flatnonzero((rows >= a) & (rows < b))
        out.append((rows[pos] - a, pos))
    return out


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

    # A tiled step (``ShardedScheduleStep`` over several tiles) holds each
    # snapshot field as a tuple of per-tile tensors; this one holds the
    # tensor itself.
    tiled = False

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
        return compact_words([compact_body(schedulable, scores, counts),
                              compact_tail(unassigned, waterline)])

    # -- tiles -------------------------------------------------------------
    # Every upload and update below is written once over spans: the
    # ``(device, start, stop)`` of each tile in the host snapshot's rows.
    # One device is one span over every row.

    def _row_spans(self, n_rows: int, host_row0: int = 0) -> list:
        """The spans of a snapshot of ``n_rows`` global rows whose host
        arrays start at global row ``host_row0``."""
        return [(self.device, 0, int(n_rows))]

    def _spans(self, prepared: PreparedSnapshot) -> list:
        return self._row_spans(prepared.rows())

    def _snapshot(self, fields: dict, n_rows: int, host_row0: int,
                  host_rows: int) -> PreparedSnapshot:
        return PreparedSnapshot(**fields)

    def _join(self, tiles: list):
        """A snapshot field from its per-span tensors."""
        return tuple(tiles) if self.tiled else tiles[0]

    @staticmethod
    def _tiles(field) -> list:
        """A snapshot field's per-span tensors."""
        return list(field) if isinstance(field, tuple) else [field]

    def _put(self, arr: np.ndarray, spans):
        """One host array (host rows) to its spans' devices: a pinned,
        non-blocking copy on CUDA; a private copy on the CPU (snapshots
        are mutable hosts)."""
        return self._join([upload(arr[a:b], dev) for dev, a, b in spans])

    # -- uploads -----------------------------------------------------------

    def _np_dtype(self):
        return np.float64 if self.scorer.dtype == torch.float64 else np.float32

    def prepare(self, snapshot, now: float, capacity=None, offsets=None) -> PreparedSnapshot:
        """Upload a store snapshot. Host -> device transfer happens here,
        once per refresh; the step then reruns against the resident
        tensors for any pod batch. Capacity defaults to unbounded (1 << 30
        per node) and offsets to zero: the plain Dynamic-score domain."""
        with maybe_span(self.telemetry, "h2d_prepare", n=int(snapshot.n_nodes)):
            n = int(np.asarray(snapshot.ts).shape[0])
            return self._prepare_rows(snapshot, now, capacity, offsets, n, 0)

    def _host_arrays(self, snapshot, now: float, capacity=None, offsets=None) -> tuple:
        """The snapshot's scoring inputs as host arrays of the step's dtype,
        timestamps rebased in f32: ``(arrays, now_value, epoch)`` with
        ``arrays`` = values, ts, hot_value, hot_ts, node_valid, capacity,
        offsets."""
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
        if capacity is None:
            capacity = np.full((n,), 1 << 30, dtype=np.int64)
        if offsets is None:
            offsets = np.zeros((n,), dtype=np.int32)
        arrays = (
            np.asarray(snapshot.values, dtype=np_dtype),
            ts.astype(np_dtype),
            np.asarray(snapshot.hot_value, dtype=np_dtype),
            hot_ts.astype(np_dtype),
            np.asarray(snapshot.node_valid, dtype=bool),
            np.asarray(capacity, dtype=np.int64),
            np.asarray(offsets, dtype=np.int32),
        )
        return arrays, now_value, epoch

    def _prepare_rows(self, snapshot, now: float, capacity, offsets, n_rows: int,
                      host_row0: int) -> PreparedSnapshot:
        """Upload ``snapshot``, which holds the ``n_rows``-row node axis's
        rows from ``host_row0`` on (all of them, or one process's shard)."""
        arrays, now_value, epoch = self._host_arrays(snapshot, now, capacity, offsets)
        spans = self._row_spans(n_rows, host_row0)
        values, ts, hot_value, hot_ts, node_valid, capacity, offsets = (
            self._put(a, spans) for a in arrays
        )
        prepared = self._snapshot(
            dict(values=values, ts=ts, hot_value=hot_value, hot_ts=hot_ts,
                 node_valid=node_valid, now=self.scorer.consts.round(now_value),
                 capacity=capacity, offsets=offsets, epoch=epoch),
            n_rows, host_row0, int(arrays[1].shape[0]),
        )
        if self.hybrid:
            # the risk scan overlaps the uploads still in flight
            prepared = dataclasses.replace(
                prepared, **self._override_vectors(prepared, snapshot, float(now))
            )
        return prepared

    def _override_vectors(self, prepared: PreparedSnapshot, snapshot, now: float,
                          rebase_age: float = 0.0) -> dict:
        """Compute (a full scan) and upload the hybrid f64 rescue vectors
        for ``(snapshot, now)``."""
        mask, sched, score, _, new_cache, scanned = compute_overrides_incremental(
            self.tensors, snapshot.values, snapshot.ts, snapshot.hot_value,
            snapshot.hot_ts, snapshot.node_valid, now, rebase_age=rebase_age,
        )
        spans = self._spans(prepared)
        return {
            "ovr_mask": self._put(np.asarray(mask, bool), spans),
            "ovr_sched": self._put(np.asarray(sched, bool), spans),
            "ovr_score": self._put(np.asarray(score, np.int32), spans),
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
        now = float(now)
        age = abs(now - prepared.epoch)
        spans = self._spans(prepared)
        if age > EPOCH_REBASE_SECONDS:  # hybrid is always non-f64
            ts = (np.asarray(snapshot.ts, np.float64) - now).astype(np.float32)
            hot_ts = (np.asarray(snapshot.hot_ts, np.float64) - now).astype(np.float32)
            rebased = dataclasses.replace(
                prepared, ts=self._put(ts, spans), hot_ts=self._put(hot_ts, spans),
                now=0.0, epoch=now,
            )
            return dataclasses.replace(
                rebased, **self._override_vectors(rebased, snapshot, now)
            )
        cache = prepared.ovr_cache if prepared.ovr_mask is not None else None
        if force and dirty_rows is None:
            cache = None  # unknown mutations: a full rescan is required
        if cache is None:
            return dataclasses.replace(
                prepared, **self._override_vectors(prepared, snapshot, now, age)
            )
        mask, sched, score, changed, new_cache, scanned = compute_overrides_incremental(
            self.tensors, snapshot.values, snapshot.ts, snapshot.hot_value,
            snapshot.hot_ts, snapshot.node_valid, now,
            cache=cache, dirty_rows=dirty_rows, rebase_age=age,
        )
        host = {"ovr_mask": np.asarray(mask, bool), "ovr_sched": np.asarray(sched, bool),
                "ovr_score": np.asarray(score, np.int32)}
        if changed is None:  # the cache was rebuilt: full re-upload
            return dataclasses.replace(
                prepared, **{k: self._put(v, spans) for k, v in host.items()},
                ovr_now=now, ovr_cache=new_cache, ovr_rescan_rows=scanned,
            )
        if changed.size == 0:  # nothing changed on device: no upload
            return dataclasses.replace(prepared, ovr_now=now, ovr_cache=new_cache,
                                       ovr_rescan_rows=0)
        out = self._scatter(prepared, spans, changed,
                            {k: v[changed] for k, v in host.items()})
        return dataclasses.replace(prepared, **out, ovr_now=now, ovr_cache=new_cache,
                                   ovr_rescan_rows=scanned)

    def _scatter(self, prepared: PreparedSnapshot, spans, rows, host: dict) -> dict:
        """New copies of the fields named in ``host`` with ``rows`` (host
        numbering) replaced by ``host[name]`` (one entry per row), by one
        ``index_copy`` per touched tile."""
        out = {name: self._tiles(getattr(prepared, name)) for name in host}
        for t, ((dev, _a, _b), (local, pos)) in enumerate(zip(spans, split_rows(rows, spans))):
            if local.size == 0:
                continue
            idx = upload(local, dev)
            for name, arr in host.items():
                out[name][t] = out[name][t].index_copy(0, idx, upload(arr[pos], dev))
        return {name: self._join(tiles) for name, tiles in out.items()}

    def with_vectors(self, prepared: PreparedSnapshot, capacity=None,
                     offsets=None) -> PreparedSnapshot:
        """A copy of a prepared snapshot with new per-node gang vectors,
        reusing the resident load tensors: only the ``[N]`` capacity
        (clipped to 2^31-1) and offset rows upload (the per-gang-request
        path)."""
        spans = self._spans(prepared)
        changes = {}
        if capacity is not None:
            capacity = np.minimum(np.asarray(capacity, np.int64), 2**31 - 1)
            changes["capacity"] = self._put(capacity, spans)
        if offsets is not None:
            changes["offsets"] = self._put(np.asarray(offsets, np.int32), spans)
        return dataclasses.replace(prepared, **changes) if changes else prepared

    # -- resident-snapshot updates -----------------------------------------

    def apply_delta(self, prepared: PreparedSnapshot, rows, values_rows, ts_rows,
                    hot_rows, hot_ts_rows) -> PreparedSnapshot:
        """Scatter changed rows into new copies of the resident arrays
        instead of re-uploading full matrices. Timestamps rebase to the
        snapshot's existing epoch (in float64 on the host, then cast), so
        the result equals a full ``prepare`` of the updated store at the
        same epoch bit for bit. Rows past the snapshot drop (the
        reference's padding index). Hybrid callers must refresh their
        override vectors afterwards: the rescue rows derive from the
        changed data."""
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
        host = {
            "values": np.asarray(values_rows, np_dtype),
            "ts": (np.asarray(ts_rows, np.float64) - prepared.epoch).astype(np_dtype),
            "hot_value": np.asarray(hot_rows, np_dtype),
            "hot_ts": (np.asarray(hot_ts_rows, np.float64) - prepared.epoch).astype(np_dtype),
        }
        return dataclasses.replace(
            prepared, **self._scatter(prepared, self._spans(prepared), rows, host)
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
        spans = self._spans(prepared)
        npad = spans[-1][2]  # the host rows the spans cover
        own: dict = {}
        cloned: set = set()

        def private(name, t):
            # one copy of each touched tile per replay, then written in place
            tiles = own.setdefault(name, self._tiles(getattr(prepared, name)))
            if (name, t) not in cloned:
                tiles[t] = tiles[t].clone()
                cloned.add((name, t))
            return tiles[t]

        for col, ids, v, t, hv, ht in entries:
            ids = np.asarray(ids)
            full = len(ids) == n and np.array_equal(ids, np.arange(n, dtype=ids.dtype))
            parts = None if full else split_rows(ids, spans)
            if col is not None:
                t64 = np.asarray(t, np.float64) - prepared.epoch
                if full:
                    v_pad = np.full((npad,), np.nan)
                    v_pad[:n] = v
                    v_pad = v_pad.astype(np_dtype)
                    uniform = t64.size and np.all(t64 == t64[0])
                    if not uniform:
                        t_pad = np.full((npad,), -np.inf)
                        t_pad[:n] = t64
                        t_pad = t_pad.astype(np_dtype)
                    for k, (dev, a, b) in enumerate(spans):
                        private("values", k)[:, col] = upload(v_pad[a:b], dev)
                        if uniform:
                            # one scalar, rounded to the dtype on the host
                            private("ts", k)[:, col] = float(np_dtype(t64[0]))
                        else:
                            private("ts", k)[:, col] = upload(t_pad[a:b], dev)
                else:
                    vv = np.asarray(v, np_dtype)
                    tt = t64.astype(np_dtype)
                    for k, ((dev, _a, _b), (local, pos)) in enumerate(zip(spans, parts)):
                        if local.size:
                            idx = upload(local, dev)
                            private("values", k)[idx, col] = upload(vv[pos], dev)
                            private("ts", k)[idx, col] = upload(tt[pos], dev)
            if hv is not None:
                ht64 = np.asarray(ht, np.float64) - prepared.epoch
                if full:
                    h_pad = np.full((npad,), np.nan)
                    h_pad[:n] = hv
                    ht_pad = np.full((npad,), -np.inf)
                    ht_pad[:n] = ht64
                    # fresh uploads: private already, nothing to clone
                    for name, arr in (("hot_value", h_pad), ("hot_ts", ht_pad)):
                        arr = arr.astype(np_dtype)
                        own[name] = [upload(arr[a:b], dev) for dev, a, b in spans]
                        cloned.update((name, k) for k in range(len(spans)))
                else:
                    hh = np.asarray(hv, np_dtype)
                    hts = ht64.astype(np_dtype)
                    for k, ((dev, _a, _b), (local, pos)) in enumerate(zip(spans, parts)):
                        if local.size:
                            idx = upload(local, dev)
                            private("hot_value", k)[idx] = upload(hh[pos], dev)
                            private("hot_ts", k)[idx] = upload(hts[pos], dev)
        if not own:
            return prepared
        return dataclasses.replace(prepared, **{k: self._join(v) for k, v in own.items()})

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
        num_pods = int(num_pods)
        compact = num_pods < COMPACT_MAX_PODS
        return PackedFetch(self._packed_words(prepared, num_pods, now, compact),
                           compact=compact)

    def _packed_words(self, prepared: PreparedSnapshot, num_pods: int, now,
                      compact: bool) -> torch.Tensor:
        vecs = self._args(prepared, now)
        if compact:
            return self._step_packed_compact(vecs, num_pods)
        return self._step_packed(vecs, num_pods)

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
