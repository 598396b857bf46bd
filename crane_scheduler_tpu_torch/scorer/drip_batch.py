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

Over a node mesh of more than one tile (``DripBatchKernel(mesh=)``, the
reference's ``_sharded_drip_fn``) the columns are padded to the
reference's bucket rounded up to the tile count and split into equal
tiles, and ``_sharded_drip`` runs each step per tile: a local first-max
``(value, global index)``, the pairs gathered with the lowest tile
winning value ties (so the winner is the lowest global index holding the
maximum, as ``np.argmax`` has it), the feasible and tie counts summed in
int64, and the fold on the winning tile only. Such columns are
re-uploaded on a version change, never patched, so the column and carry
counters equal the reference's. A mesh that spans processes adds two
``all_reduce`` sums per step and holds ``_COLLECTIVE_LOCK`` through the
window's output sync.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.column_cache import SINGLE_DEVICE, DeviceColumnCache, upload
from ..parallel.distributed import COLLECTIVE_LOCK as _COLLECTIVE_LOCK
from ..parallel.mesh import node_tiles, round_up_to_shards

__all__ = ["DripBatchKernel", "drip_batch_dispatch"]

_I64_MIN = int(np.iinfo(np.int64).min)

# the reference's shape buckets, which the sharded window pads to: small
# node counts round up to a power of two >= 256, past 4096 to the next
# multiple of 4096
_MIN_N_BUCKET = 256
_N_BUCKET_STEP = 4096


def _bucket_nodes(n: int) -> int:
    if n <= _N_BUCKET_STEP:
        m = max(int(n), _MIN_N_BUCKET)
        return 1 << (m - 1).bit_length()
    return -(-int(n) // _N_BUCKET_STEP) * _N_BUCKET_STEP


def _pad(arr: np.ndarray, npad: int, fill) -> np.ndarray:
    if arr.shape[0] == npad:
        return arr
    out = np.full((npad,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


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


def _sharded_drip(tiles, vecs, want_ties=True, first_tile=0, n_tiles=None,
                  combine=None):
    """The window over a tiled node axis. ``tiles``: per local tile
    ``(schedulable, weighted, bounded, free)`` on the tile's device, equal
    tile lengths; ``vecs`` int64 [K, 4] (any device). Tile ``t`` is global
    tile ``first_tile + t`` of ``n_tiles``; ``combine`` sums a tensor over
    every process (None: this process holds every tile). Returns ``(outs,
    frees)``: ``outs`` int64 [K, 3] on the first tile's device, as
    ``_drip_batch`` gives them, and the per-tile folded carries (new
    tensors)."""
    dev0 = tiles[0][0].device
    nloc = tiles[0][0].shape[0]
    n_local = len(tiles)
    n_tiles = n_local if n_tiles is None else n_tiles
    frees = [t[3].clone() for t in tiles]
    per_dev = {}
    for sched, *_ in tiles:
        dev = sched.device
        if dev not in per_dev:
            v = vecs.to(dev)
            per_dev[dev] = (v, v > 0, -v, torch.zeros((1, v.shape[1]), dtype=torch.int64,
                                                       device=dev))
    base = [torch.full((1,), (first_tile + t) * nloc, dtype=torch.int64,
                       device=tiles[t][0].device) for t in range(n_local)]
    tile_ids = torch.arange(first_tile, first_tile + n_local, device=dev0)
    minus_one = torch.full((), -1, dtype=torch.int64, device=dev0)
    one = torch.ones((), dtype=torch.int64, device=dev0)
    rows = []
    for k in range(vecs.shape[0]):
        masks, lbests, vals, idxs, feas = [], [], [], [], []
        for t, (sched, weighted, bounded, _f) in enumerate(tiles):
            vec, need, _neg, _z = per_dev[sched.device]
            fit_fail = bounded & (need[k] & (frees[t] < vec[k])).any(dim=1)
            mask = sched & ~fit_fail
            w = torch.where(mask, weighted, _I64_MIN)
            lbest = torch.argmax(w).reshape(1)  # first maximum within the tile
            masks.append(mask)
            lbests.append(lbest)
            vals.append(w.gather(0, lbest).to(dev0))
            idxs.append((base[t] + lbest).to(dev0))
            feas.append(mask.sum(dtype=torch.int64).reshape(1).to(dev0))
        if combine is None:
            vals, idxs = torch.cat(vals), torch.cat(idxs)
            feasible = torch.cat(feas).sum()
        else:
            # every process writes its own tiles' pairs into zeros; one sum
            pairs = torch.zeros((2 * n_tiles + 1,), dtype=torch.int64, device=dev0)
            pairs[first_tile:first_tile + n_local] = torch.cat(vals)
            pairs[n_tiles + first_tile:n_tiles + first_tile + n_local] = torch.cat(idxs)
            pairs[-1] = torch.cat(feas).sum()
            pairs = combine(pairs)
            vals, idxs, feasible = pairs[:n_tiles], pairs[n_tiles:-1], pairs[-1]
        win = torch.argmax(vals)  # lowest tile among value ties
        gval = vals[win]
        gbest = idxs[win]
        if want_ties:
            ties = torch.cat([
                (m & (tile[1] == gval.to(m.device))).sum(dtype=torch.int64).reshape(1).to(dev0)
                for m, tile in zip(masks, tiles)
            ]).sum()
            if combine is not None:
                ties = combine(ties.reshape(1))[0]
        else:
            ties = one
        some = feasible > 0
        mine = some & (tile_ids == win)
        for t, (sched, *_rest) in enumerate(tiles):
            _v, _need, neg, zero_row = per_dev[sched.device]
            frees[t].index_add_(0, lbests[t], torch.where(mine[t].to(sched.device),
                                                          neg[k:k + 1], zero_row))
        rows.append(torch.stack([torch.where(some, gbest, minus_one), feasible, ties]))
    if not rows:
        return torch.zeros((0, 3), dtype=torch.int64, device=dev0), frees
    return torch.stack(rows), frees


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
    runs the same PyTorch code on the CPU. ``mesh``: a placement mesh
    (``parallel.mesh.make_placement_mesh``); more than one tile runs the
    shard-parallel window, one tile the single-device window on that tile's
    device. With a mesh and no ``device`` the first tile's device holds the
    window's outputs.
    """

    def __init__(self, device=None, mesh=None):
        self.device = (mesh.devices[0] if device is None and mesh is not None
                       else resolve_device(device))
        self._cols = DeviceColumnCache(self.device)
        self._free_dev = None  # device fold carry [N, 4], or per-tile carries
        self._free_src = None  # host free array the carry mirrors
        self._free_rows = None  # padded rows of a tiled carry
        self._free_synced = False
        self._host_out = None  # pinned [K, 3] landing buffer (CUDA only)
        self._event = None
        self.dispatches = 0
        self.free_uploads = 0
        self._mesh = None
        self.repartitions = 0
        if mesh is None:
            self._cols.set_partition(SINGLE_DEVICE)
        else:
            self.repartition(mesh)

    @property
    def mesh(self):
        return self._mesh

    def _partition_token(self):
        return SINGLE_DEVICE if self._mesh is None else self._mesh.token()

    def repartition(self, mesh) -> bool:
        """Point the window at a (possibly resized) placement mesh, or at
        none. Any change of the tile devices or layout drops every cached
        device column and desyncs the fold carry: folds never replay onto a
        carry tiled for the old partitioning. Returns True when the
        partitioning changed."""
        self._mesh = mesh
        self._cols._device = self.device if mesh is None else mesh.devices[0]
        changed = self._cols.set_partition(self._partition_token())
        if changed:
            self.mark_desynced()
            self.repartitions += 1
        return changed

    def mark_synced(self, host_free) -> None:
        """Host applied exactly the window's folds — carry is reusable."""
        self._free_src = host_free
        self._free_synced = True

    def mark_desynced(self) -> None:
        self._free_synced = False
        self._free_dev = None
        self._free_src = None
        self._free_rows = None

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
        stages=None,
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
        full column upload; returning None falls back to the upload.

        ``stages`` (a ``telemetry.StageClock``, or None) is split into
        ``drip_launch`` before the K-step enqueue and ``drip_wait`` before
        the fetch."""
        n = int(schedulable.shape[0])
        k = int(vecs.shape[0])
        if n == 0:
            # no node: every pod is infeasible, as the reference's padded
            # rows report (no tie among infeasible rows; 1 without ties)
            self.mark_desynced()
            self.dispatches += 1
            ties = np.zeros(k, np.int64) if want_ties else np.ones(k, np.int64)
            return np.full(k, -1, np.int64), np.zeros(k, np.int64), ties
        if self._cols.set_partition(self._partition_token()):
            self.mark_desynced()
            self.repartitions += 1
        mesh = self._mesh
        if mesh is not None and mesh.size > 1:
            return self._dispatch_tiled(schedulable, weighted, bounded, free, vecs,
                                        want_ties, col_version, stages)
        cols = self._cols
        dev = cols._device
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
        if (not self._free_synced or free_d is None or self._free_src is not free
                or self._free_rows is not None):
            free_d = upload(free, dev)
            self._free_src = free
            self._free_rows = None
            self.free_uploads += 1
        vecs_d = upload(np.asarray(vecs, dtype=np.int64).reshape(k, 4), dev)
        active = torch.ones((k,), dtype=torch.bool, device=dev)
        if stages is not None:
            stages.split("drip_launch")
        outs, free_out = _drip_batch(sched_d, w_d, bnd_d, free_d, vecs_d, active,
                                     want_ties=want_ties)
        if stages is not None:
            stages.split("drip_wait")
        host = self._fetch(outs)
        self._free_dev = free_out
        self._free_synced = True  # provisional; the caller desyncs on reject
        self.dispatches += 1
        return host[:, 0], host[:, 1], host[:, 2]


    def _dispatch_tiled(self, schedulable, weighted, bounded, free, vecs, want_ties,
                        col_version, stages):
        """The shard-parallel window (``_sharded_drip``) over ``self.mesh``:
        columns padded to ``round_up_to_shards(_bucket_nodes(n))`` rows and
        tiled; no delta scatter, the carry kept per tile."""
        mesh = self._mesh
        n = int(schedulable.shape[0])
        k = int(vecs.shape[0])
        npad = round_up_to_shards(_bucket_nodes(n), mesh)  # equal tiles
        spans = node_tiles(mesh, npad)

        def place(host):
            return tuple(upload(host[a:b], dev) for dev, a, b in spans)

        cols = self._cols
        sched_t = cols.put("schedulable", schedulable, version=col_version,
                           prepare=lambda a: _pad(a, npad, False), place=place)
        w_t = cols.put("weighted", weighted, version=col_version,
                       prepare=lambda a: _pad(a.astype(np.int64), npad, _I64_MIN),
                       place=place)
        if bounded is None or free is None:
            # tracker-less plugin set: fit never fails
            bounded = np.zeros((n,), dtype=bool)
            free = np.zeros((n, 4), dtype=np.int64)
        bnd_t = cols.put("bounded", bounded, prepare=lambda a: _pad(a, npad, False),
                         place=place)
        free_t = self._free_dev
        if (not self._free_synced or free_t is None or self._free_src is not free
                or self._free_rows != npad):
            free_t = place(_pad(np.asarray(free, np.int64), npad, 0))
            self._free_src = free
            self._free_rows = npad
            self.free_uploads += 1
        vecs_d = upload(np.asarray(vecs, dtype=np.int64).reshape(k, 4), self.device)
        tiles = list(zip(sched_t, w_t, bnd_t, free_t))
        if stages is not None:
            stages.split("drip_launch")
        if mesh.distributed:
            from ..parallel.distributed import all_sum

            with _COLLECTIVE_LOCK:
                outs, free_out = _sharded_drip(tiles, vecs_d, want_ties, mesh.first_tile,
                                               mesh.size, combine=all_sum)
                if stages is not None:
                    stages.split("drip_wait")
                # the output sync inside the lock: every collective retired
                host = self._fetch(outs)
        else:
            outs, free_out = _sharded_drip(tiles, vecs_d, want_ties)
            if stages is not None:
                stages.split("drip_wait")
            host = self._fetch(outs)
        self._free_dev = tuple(free_out)
        self._free_synced = True  # provisional; the caller desyncs on reject
        self.dispatches += 1
        return host[:, 0], host[:, 1], host[:, 2]


def drip_batch_dispatch(schedulable, weighted, bounded, free, vecs, device=None):
    """One-shot functional entry (benchmarks, tests): no carry reuse."""
    return DripBatchKernel(device=device).dispatch(schedulable, weighted, bounded, free, vecs)
