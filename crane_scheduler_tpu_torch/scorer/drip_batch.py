"""Device-resident drip batch window: mask + argmax + fold for K pods.

Counterpart of ``crane_scheduler_tpu/scorer/drip_batch.py``. The
reference's ``_drip_batch`` is a jitted XLA program (a ``lax.scan``), not a
Pallas kernel. Here the window has two routes, chosen by the tensors'
device: on a card, ``scorer.drip_step.drip_window`` launches one
hand-written CUDA kernel per pod (``csrc/drip_step.cu``), each the pod's
whole step over every node; on the CPU, the plain PyTorch function
``_drip_batch`` runs the same K dependent steps as PyTorch ops, and the
tests hold the kernel against it bit for bit:

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
are not padded to the reference's buckets. ``_drip_batch`` still takes
padded inputs (padded nodes are ``schedulable=False``, padded pods
``active=False``) with the reference's results.

On a CUDA device the window is the counterpart of the reference's
compile-once-per-shape program: when two windows in a row have one shape
``(device, n, k, want_ties)``, the second captures the window's K step
launches into a CUDA graph (``_WindowGraph``) and every later window of
that shape replays it with one launch from the host. The kernels and their
arithmetic are the eager ones. ``GraphSlot`` decides which route a window
takes and holds one graph: a shape that does not repeat back to back runs
eagerly and leaves the held graph in place, so shapes that alternate never
capture each other out.

The fold carry stays on the device across windows: after a fully accepted
window the host applies the same integer folds to its own ``free`` copy
(``mark_synced``), so the next dispatch skips the ``[N, 4]`` upload.

With ``NodeResourceTopologyMatch`` registered the scheduler runs the NRT
window instead (``DripBatchKernel.dispatch_numa``: the step kernel with zone
columns on a card, ``_drip_batch_numa`` on the CPU; port-only, the
reference places such a queue pod by pod): each step also evaluates
the plugin's Filter and greedy zone pack over every node's NUMA zones
(``[N, Z]`` int64 milli-CPU), adds its weighted score to the Dynamic one,
and folds the winner's zone takes into a second carry, ``used``, which
stays on the device beside ``free``. Its graphs (``_NumaWindowGraph``)
are keyed by shape and zone count in the same ``GraphSlot``.

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
window's output sync. The tiled window runs PyTorch ops on every device; a
one-tile mesh takes the single-device routes above.
"""

from __future__ import annotations

import gc
import threading

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.column_cache import SINGLE_DEVICE, DeviceColumnCache, upload
from ..parallel.distributed import COLLECTIVE_LOCK as _COLLECTIVE_LOCK
from ..parallel.mesh import node_tiles, round_up_to_shards
from .drip_step import StepScratch, drip_window

__all__ = ["DripBatchKernel", "drip_batch_dispatch"]

_I64_MIN = int(np.iinfo(np.int64).min)

# The threaded shard plane runs one kernel per scheduler on one card. A
# capture runs in ``thread_local`` mode, so CUDA work of other threads
# (eager windows, fetch waits, K1/K2, the gang window) cannot invalidate
# it; this lock, held over each graph window's input copies, capture and
# replay (not its wait), keeps one capture at a time in the process, as
# PyTorch requires, and none beside another kernel's replay.
_GRAPH_LOCK = threading.Lock()

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


def numa_pod_rows(req: np.ndarray, aware: np.ndarray, weight: int, z: int) -> np.ndarray:
    """The per-pod input of ``_drip_batch_numa``, int64 [K, 5 + z]: the
    guaranteed milli-CPU, the awareness annotation absent, true (``aware``:
    -1 absent, 0 false, 1 true), then the weighted NRT score by zone index:
    entry ``c`` in 1..z is ``weight * (100 // c)`` (the plugin's score for
    a pack over ``c`` zones), entry 0 is 0 (a pack over no zone: the
    plugin divides by zero, flagged as ``bad``), entry ``z + 1`` is 0 (a
    node NRT leaves alone). A pod with no guaranteed CPU (``req`` 0) gets
    zeros."""
    from ..constants import MAX_NODE_SCORE

    req = np.asarray(req, np.int64)
    on = req > 0
    aware = np.asarray(aware)
    table = np.zeros(z + 2, np.int64)
    table[1:z + 1] = [weight * (MAX_NODE_SCORE // c) for c in range(1, z + 1)]
    return np.concatenate([req[:, None], (on & (aware < 0))[:, None],
                           (on & (aware > 0))[:, None],
                           np.where(on[:, None], table[None, :], 0)], axis=1).astype(np.int64)


def _drip_batch_numa(schedulable, weighted, bounded, free, vecs, active, zcols, used, pods,
                     want_ties=True):
    """``_drip_batch`` with ``NodeResourceTopologyMatch`` beside Dynamic and
    Fit: per step, the NRT Filter and the pack over each node's NUMA zones
    for the pod's guaranteed CPU, its weighted score added to ``weighted``,
    the argmax, and both folds, ``free`` and the winner's zones.

    ``zcols``, the node columns: ``zkey`` int64 [N, Z], a zone's
    allocatable milli-CPU (``-2^62`` past the node's zones, so they sort
    last and never fit); ``zcap`` int64 [N, Z], the allocatable floored to
    whole cores (0 past the zones); ``nrt_has`` bool [N], a CR exists;
    ``nrt_active``, the CR's CPU manager policy is Static; ``nrt_act_naw``,
    Static and the node's topology manager policy single-NUMA. ``used``
    int64 [N, Z]: each zone's requested milli-CPU (the carry). ``pods``
    (``numa_pod_rows``) int64 [K, 5 + Z]: per pod the guaranteed milli-CPU
    ``req`` (0: NRT leaves the pod alone), the awareness annotation absent
    and true (both 0 where ``req`` is 0), and the score table.

    The zone math is Go's on int64 milli-CPU (``topology.helper``): an
    aware pod fits where one zone's free CPU holds the whole request and
    takes the freest zone (first among equals, in CR order); a non-aware
    pod packs greedily over the zones in free-descending order (stable),
    ``min(remaining, floored allocatable - requested)`` per zone, which a
    negative (overcommitted) zone inflates, until the request is met. A
    zone counts where it takes a positive part; the score divides 100 by
    the count. Returns ``(outs, free, used)``: ``outs`` int64 [K, 4 + Z]
    of (chosen or -1, feasible count, tie count, feasible nodes whose pack
    used no zone, then the winner's take per zone in CR order)."""
    free = free.clone()
    used = used.clone()
    dev = free.device
    z = used.shape[1]
    ops = _numa_pod_operands(zcols, pods)
    neg_delta = torch.where(active[:, None], -vecs, torch.zeros_like(vecs))
    need = vecs > 0
    # an aware pod's take: the whole request in its first (freest) zone
    first_take = torch.zeros((vecs.shape[0], z), dtype=torch.int64, device=dev)
    first_take[:, 0] = ops[0]
    act_on = ops[2]
    minus_one = torch.full((), -1, dtype=torch.int64, device=dev)
    one = torch.ones((), dtype=torch.int64, device=dev)
    zero_row = torch.zeros((1, vecs.shape[1]), dtype=torch.int64, device=dev)
    rows = []
    for k in range(vecs.shape[0]):
        mask, total, idx, need_fit, orders, takes = _numa_step(
            schedulable, weighted, bounded, free, vecs[k], need[k], zcols, used, ops, k)
        w = torch.where(mask, total, _I64_MIN)
        best = torch.argmax(w).reshape(1)  # first maximum, like np.argmax
        feasible = mask.sum(dtype=torch.int64)
        if want_ties:
            ties = (mask & (total == w.gather(0, best))).sum(dtype=torch.int64)
        else:
            ties = one
        bad = (mask & (idx == 0)).sum(dtype=torch.int64)
        some = feasible > 0
        free.index_add_(0, best, torch.where(some, neg_delta[k:k + 1], zero_row))
        # the winner's takes by pack position, then by CR zone
        a_best = torch.cat([t.gather(0, best) for t in takes])[None, :]
        o_best = torch.cat([o.index_select(0, best) for o in orders], dim=1)
        t_sorted = torch.where(need_fit.gather(0, best)[:, None], first_take[k:k + 1],
                               a_best.clamp(min=0))
        keep = some & act_on[k].gather(0, best)
        row = torch.zeros_like(t_sorted).scatter(1, o_best, t_sorted)
        row = torch.where(keep[:, None], row, torch.zeros_like(row))
        used.index_add_(0, best, row)
        head = torch.stack([torch.where(some, best[0], minus_one), feasible, ties, bad])
        rows.append(torch.cat([head, row[0]]))
    if not rows:
        return torch.zeros((0, 4 + z), dtype=torch.int64, device=dev), free, used
    return torch.stack(rows), free, used


def _numa_pod_operands(zcols, pods):
    """The window's per-pod NRT operands, once for every step: the request
    ``req`` [K], the awareness annotation absent ``aw_none`` [K], and per
    pod and node (K x N) where NRT acts (``act_on``: Static, and a pod with
    guaranteed CPU), where an annotated-aware pod needs a zone that fits
    (``act_if_true``) and where the pod passes unless aware
    (``has_or_off``: a CR exists, or NRT leaves the pod alone); the score
    table [K, Z + 2]."""
    _zkey, _zcap, nrt_has, nrt_active, _act_naw = zcols
    req = pods[:, 0]
    on = req > 0
    act_on = nrt_active[None, :] & on[:, None]
    return (req, pods[:, 1] > 0, act_on, act_on & (pods[:, 2] > 0)[:, None],
            nrt_has[None, :] | ~on[:, None], pods[:, 3:])


def _numa_step(schedulable, weighted, bounded, free, vec, need, zcols, used, ops, k):
    """Pod ``k``'s Filter and Score over every node (``_drip_batch_numa``):
    ``(mask, total, idx, need_fit, orders, takes)``, the feasible nodes,
    the weighted Dynamic + NRT score, the score table's index (1 for an
    aware pack, the zone count of a greedy one, ``Z + 1`` where NRT does
    not act), where the pod needs one fitting zone, and per pack position
    the zone visited ([N, 1]) and the part it takes ([N], negative on an
    overcommitted zone)."""
    zkey, zcap, _has, _active, nrt_act_naw = zcols
    req, aw_none, act_on, act_if_true, has_or_off, table = ops
    z = used.shape[1]
    fit_fail = bounded & (need & (free < vec)).any(dim=1)
    zfree = zkey - used
    fits = (zfree >= req[k]).any(dim=1)
    # aware: the pod's annotation, else the node's policy
    need_fit = torch.where(aw_none[k], nrt_act_naw, act_if_true[k])
    mask = schedulable & ~fit_fail & torch.where(need_fit, fits, has_or_off[k])
    # the greedy pack over zones by free CPU, descending, first among
    # equals first (argmax), each zone visited once
    capfree = zcap - used
    key = zfree
    rem = req[k]
    orders, takes = [], []
    cnt = None
    for s in range(z):
        o = torch.argmax(key, dim=1, keepdim=True)
        if s + 1 < z:
            key = key.scatter(1, o, _I64_MIN)
        c = capfree.gather(1, o).squeeze(1)
        if s == 0:
            a = torch.minimum(rem, c)
        else:
            a = torch.where(rem > 0, torch.minimum(rem, c), torch.zeros_like(c))
        if s + 1 < z:
            rem = rem - a
        pos = (a > 0).to(torch.int64)
        cnt = pos if cnt is None else cnt + pos
        orders.append(o)
        takes.append(a)
    idx = torch.where(need_fit, 1, torch.where(act_on[k], cnt, z + 1))
    total = weighted + torch.take(table[k], idx)
    return mask, total, idx, need_fit, orders, takes


def numa_eval(schedulable, weighted, bounded, free, vec, zcols, used, pod_row):
    """One pod's step of the NRT window over host numpy columns, on the
    CPU: ``(mask, total, idx)`` as numpy (``_numa_step``). ``bounded`` /
    ``free`` None: no Fit plugin. ``zcols`` as ``_drip_batch_numa`` takes
    them, numpy; ``pod_row`` int64 [5 + Z] (``numa_pod_rows``)."""
    t = torch.from_numpy
    n = int(schedulable.shape[0])
    if bounded is None or free is None:
        bounded = np.zeros((n,), dtype=bool)
        free = np.zeros((n, 4), dtype=np.int64)
    vec = np.zeros(4, np.int64) if vec is None else np.asarray(vec, np.int64)
    zc = tuple(t(np.ascontiguousarray(c)) for c in zcols)
    ops = _numa_pod_operands(zc, t(np.asarray(pod_row, np.int64)[None, :]))
    mask, total, idx, *_ = _numa_step(
        t(np.asarray(schedulable)), t(np.asarray(weighted, np.int64)), t(np.asarray(bounded)),
        t(np.asarray(free, np.int64)), t(vec), t(vec > 0), zc,
        t(np.asarray(used, np.int64)), ops, 0)
    return mask.numpy(), total.numpy(), idx.numpy()


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


class GraphSlot:
    """Which route a window of shape ``key = (device, n, k, want_ties)``
    takes: ``"replay"`` when the held graph has that shape, ``"capture"``
    (replacing the held graph) when the previous window had it too, else
    ``"eager"``. Holds any graph object, so it runs without a card."""

    def __init__(self):
        self.key = None  # the held graph's shape
        self.graph = None
        self._last = None  # the previous window's shape

    def route(self, key) -> str:
        """Note one window of shape ``key``; returns its route."""
        last, self._last = self._last, key
        if key == self.key:
            return "replay"
        return "capture" if key == last else "eager"

    def hold(self, key, graph) -> None:
        self.key, self.graph = key, graph


class _WindowGraph:
    """One shape's window captured as a CUDA graph: static inputs, the
    step kernel's scratch, the graph, its ``outs``. The graph folds the
    carry in place into ``free``, so after an accepted window the carry is
    already the next replay's input."""

    def __init__(self, dev: torch.device, n: int, k: int):
        self.sched = torch.empty((n,), dtype=torch.bool, device=dev)
        self.weighted = torch.empty((n,), dtype=torch.int64, device=dev)
        self.bounded = torch.empty((n,), dtype=torch.bool, device=dev)
        self.free = torch.empty((n, 4), dtype=torch.int64, device=dev)
        self.vecs = torch.empty((k, 4), dtype=torch.int64, device=dev)
        self.active = torch.ones((k,), dtype=torch.bool, device=dev)
        self._cols = (None, None, None)  # the column tensors last copied in
        self.scratch = StepScratch(dev)
        self.graph = None
        self.outs = None

    def load(self, cols, free, vecs) -> None:
        """Copy the window's inputs into the static buffers, on the current
        stream: a device column only where its tensor changed (the column
        cache returns a new one on an upload or a scatter), the carry unless
        it is already ``self.free``; ``free`` and ``vecs`` may be pinned
        host tensors."""
        for static, src, last in zip((self.sched, self.weighted, self.bounded), cols,
                                     self._cols):
            if src is not last:
                static.copy_(src)
        self._cols = tuple(cols)
        if free is not self.free:
            self.free.copy_(free, non_blocking=True)
        self.vecs.copy_(vecs, non_blocking=True)

    def capture(self, want_ties: bool, stream) -> None:
        """Record the window on the side ``stream``; nothing runs until a
        replay. The collector stays off meanwhile, so no finalizer touches
        CUDA inside the capture."""
        cur = torch.cuda.current_stream(self.free.device)
        stream.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    outs = self._run(want_ties)
                finally:
                    graph.capture_end()
        finally:
            if gc_on:
                gc.enable()
        cur.wait_stream(stream)
        self.graph, self.outs = graph, outs

    def _run(self, want_ties: bool):
        """The window over the static buffers, its carry folded in place;
        returns ``outs``."""
        return drip_window(self.sched, self.weighted, self.bounded, self.free, self.vecs,
                           self.active, self.scratch, want_ties)


class _NumaWindowGraph(_WindowGraph):
    """``_WindowGraph`` of the NRT window (``_drip_batch_numa``): the zone
    columns, the zone carry ``used`` and the per-pod rows beside the plain
    buffers; both carries fold back in place."""

    def __init__(self, dev: torch.device, n: int, k: int, z: int):
        super().__init__(dev, n, k)
        self.zcols = (torch.empty((n, z), dtype=torch.int64, device=dev),
                      torch.empty((n, z), dtype=torch.int64, device=dev),
                      *(torch.empty((n,), dtype=torch.bool, device=dev) for _ in range(3)))
        self.used = torch.empty((n, z), dtype=torch.int64, device=dev)
        self.pods = torch.empty((k, 5 + z), dtype=torch.int64, device=dev)
        self._zlast = (None,) * len(self.zcols)

    def load_numa(self, zcols, used, pods) -> None:
        """As ``load``: a zone column only where its tensor changed, the
        zone carry unless it is already ``self.used``, the pod rows."""
        for static, src, last in zip(self.zcols, zcols, self._zlast):
            if src is not last:
                static.copy_(src)
        self._zlast = tuple(zcols)
        if used is not self.used:
            self.used.copy_(used, non_blocking=True)
        self.pods.copy_(pods, non_blocking=True)

    def _run(self, want_ties: bool):
        return drip_window(self.sched, self.weighted, self.bounded, self.free, self.vecs,
                           self.active, self.scratch, want_ties,
                           zones=(self.zcols, self.used, self.pods))


def _pinned(host: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(host)).pin_memory()


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

    On a CUDA device without tiles, every window's steps run the step
    kernel (``drip_step.drip_window``), and once two windows in a row share
    a shape, that shape's windows replay a captured graph of its launches
    (``GraphSlot``). ``graph_captures``, ``graph_replays`` and
    ``eager_windows`` count them: every window is a replay or eager, so
    ``dispatches == graph_replays + eager_windows``. ``kernel_windows``
    counts the windows whose steps went through the kernel: on a card
    every single-device window with a pod in it, on the CPU none.
    """

    def __init__(self, device=None, mesh=None):
        self.device = (mesh.devices[0] if device is None and mesh is not None
                       else resolve_device(device))
        self._cols = DeviceColumnCache(self.device)
        self._free_dev = None  # device fold carry [N, 4], or per-tile carries
        self._free_src = None  # host free array the carry mirrors
        self._used_dev = None  # device zone carry [N, Z] of the NRT window
        self._used_src = None  # host zone array it mirrors
        self._free_rows = None  # padded rows of a tiled carry
        self._free_synced = False
        self._host_out = None  # pinned [K, 3] landing buffer (CUDA only)
        self._event = None
        self.dispatches = 0
        self.free_uploads = 0
        self._graphs = GraphSlot()
        self._capture_stream = None
        self.graph_captures = 0
        self.graph_replays = 0
        self.eager_windows = 0
        self.kernel_windows = 0
        self._scratch = None  # the eager windows' StepScratch (CUDA only)
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

    def mark_synced(self, host_free, host_used=None) -> None:
        """Host applied exactly the window's folds — carry is reusable
        (``host_used``: the NRT window's zone carry too)."""
        self._free_src = host_free
        self._used_src = host_used
        self._free_synced = True

    def mark_desynced(self) -> None:
        self._free_synced = False
        self._free_dev = None
        self._free_src = None
        self._free_rows = None
        self._used_dev = None
        self._used_src = None

    def _fetch(self, outs: torch.Tensor) -> np.ndarray:
        """The window's single device-to-host copy: into a reused pinned
        buffer with an event behind it, returned as a private array."""
        if not outs.is_cuda:
            return outs.numpy()
        k, width = outs.shape
        if (self._host_out is None or self._host_out.shape[0] < k
                or self._host_out.shape[1] != width):
            self._host_out = torch.empty((k, width), dtype=torch.int64, pin_memory=True)
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
            self.eager_windows += 1
            ties = np.zeros(k, np.int64) if want_ties else np.ones(k, np.int64)
            return np.full(k, -1, np.int64), np.zeros(k, np.int64), ties
        if self._cols.set_partition(self._partition_token()):
            self.mark_desynced()
            self.repartitions += 1
        mesh = self._mesh
        if mesh is not None and mesh.size > 1:
            return self._dispatch_tiled(schedulable, weighted, bounded, free, vecs,
                                        want_ties, col_version, stages)
        dev = self._cols._device
        sched_d, w_d, bnd_d, free = self._put_columns(schedulable, weighted, bounded, free,
                                                      col_version, col_delta)
        free_d = self._free_dev
        fresh = (not self._free_synced or free_d is None or self._free_src is not free
                 or self._free_rows is not None)
        if fresh:
            self._free_src = free
            self._free_rows = None
            self.free_uploads += 1
        vecs = np.asarray(vecs, dtype=np.int64).reshape(k, 4)
        key = (dev, n, k, bool(want_ties))
        route = self._graphs.route(key) if dev.type == "cuda" and k > 0 else "eager"
        if route == "eager":
            if fresh:
                free_d = upload(free, dev)
            vecs_d = upload(vecs, dev)
            if stages is not None:
                stages.split("drip_launch")
            outs, free_out = self._eager((sched_d, w_d, bnd_d), free_d, vecs_d, want_ties)
        else:
            outs, free_out = self._replay(route, key, (sched_d, w_d, bnd_d),
                                          _pinned(free) if fresh else free_d, vecs, stages)
        if stages is not None:
            stages.split("drip_wait")
        host = self._fetch(outs)
        self._free_dev = free_out
        self._free_synced = True  # provisional; the caller desyncs on reject
        self.dispatches += 1
        return host[:, 0], host[:, 1], host[:, 2]

    def _eager(self, cols, free, vecs, want_ties, numa=None):
        """One window without a graph on the tensors' device: the step
        kernel on a card, the PyTorch window on the CPU; the inputs stay
        as they were. ``numa``: the zone columns, zone carry and pod rows.
        Returns ``(outs, free)``, and the zone carry after them with
        ``numa``."""
        dev, k = free.device, vecs.shape[0]
        active = torch.ones((k,), dtype=torch.bool, device=dev)
        self.eager_windows += 1
        if dev.type != "cuda":
            if numa is None:
                return _drip_batch(*cols, free, vecs, active, want_ties=want_ties)
            return _drip_batch_numa(*cols, free, vecs, active, *numa, want_ties=want_ties)
        if self._scratch is None or self._scratch.device != dev:
            self._scratch = StepScratch(dev)
        free = free.clone()
        zones = None if numa is None else (numa[0], numa[1].clone(), numa[2])
        outs = drip_window(*cols, free, vecs, active, self._scratch, want_ties, zones=zones)
        self.kernel_windows += int(k > 0)
        return (outs, free) if zones is None else (outs, free, zones[1])

    def _put_columns(self, schedulable, weighted, bounded, free, col_version, col_delta):
        """The single-device column puts of a window: the device
        ``schedulable``, ``weighted`` and ``bounded``, and the host ``free``
        the carry mirrors (zeros for a tracker-less plugin set)."""
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
            n = int(schedulable.shape[0])
            bounded = np.zeros((n,), dtype=bool)
            free = np.zeros((n, 4), dtype=np.int64)
        return sched_d, w_d, cols.put("bounded", bounded), free

    def dispatch_numa(self, schedulable, weighted, bounded, free, vecs, zones, pods,
                      want_ties=True, col_version=0, col_delta=None, stages=None):
        """``dispatch`` for the window with ``NodeResourceTopologyMatch``
        (``_drip_batch_numa``; one device, no tiles). ``zones``: the host
        zone columns (``framework.drip.ZoneColumns``: ``zkey``, ``zcap``,
        ``has``, ``active``, ``act_naw`` under the version ``epoch``, and
        ``used``, which the zone carry mirrors); ``pods`` int64 [K, 5 + Z]
        (``numa_pod_rows``). Returns ``(chosen, feasible, ties, bad,
        takes)``: ``bad`` counts the feasible nodes whose pack used no zone,
        ``takes`` int64 [K, Z] is the winner's milli-CPU per zone in CR
        order (zeros where NRT took nothing). Both carries, ``free`` and
        the zones, stay on the device as ``dispatch``'s does; the shape key
        adds the zone count."""
        n = int(schedulable.shape[0])
        k = int(vecs.shape[0])
        z = int(zones.used.shape[1])
        if n == 0:
            self.mark_desynced()
            self.dispatches += 1
            self.eager_windows += 1
            ties = np.zeros(k, np.int64) if want_ties else np.ones(k, np.int64)
            return (np.full(k, -1, np.int64), np.zeros(k, np.int64), ties,
                    np.zeros(k, np.int64), np.zeros((k, z), np.int64))
        if self._mesh is not None and self._mesh.size > 1:
            raise ValueError("the NRT drip window runs on one device, not over tiles")
        if self._cols.set_partition(self._partition_token()):
            self.mark_desynced()
            self.repartitions += 1
        cols = self._cols
        dev = cols._device
        sched_d, w_d, bnd_d, free = self._put_columns(schedulable, weighted, bounded, free,
                                                      col_version, col_delta)
        zcols = tuple(cols.put(f"zone_{name}", getattr(zones, name), version=zones.epoch)
                      for name in ("zkey", "zcap", "has", "active", "act_naw"))
        used = zones.used
        fresh = (not self._free_synced or self._free_dev is None or self._used_dev is None
                 or self._free_src is not free or self._used_src is not used
                 or self._free_rows is not None)
        if fresh:
            self._free_src, self._used_src = free, used
            self._free_rows = None
            self.free_uploads += 1
        vecs = np.asarray(vecs, dtype=np.int64).reshape(k, 4)
        pods = np.asarray(pods, dtype=np.int64).reshape(k, 5 + z)
        key = (dev, n, k, bool(want_ties), "numa", z)
        route = self._graphs.route(key) if dev.type == "cuda" and k > 0 else "eager"
        if route == "eager":
            free_d = upload(free, dev) if fresh else self._free_dev
            used_d = upload(used, dev) if fresh else self._used_dev
            vecs_d = upload(vecs, dev)
            pods_d = upload(pods, dev)
            if stages is not None:
                stages.split("drip_launch")
            outs, free_out, used_out = self._eager((sched_d, w_d, bnd_d), free_d, vecs_d,
                                                   want_ties, numa=(zcols, used_d, pods_d))
        else:
            numa = (zcols, _pinned(used) if fresh else self._used_dev, _pinned(pods))
            outs, free_out, used_out = self._replay(
                route, key, (sched_d, w_d, bnd_d), _pinned(free) if fresh else self._free_dev,
                vecs, stages, numa=numa)
        if stages is not None:
            stages.split("drip_wait")
        host = self._fetch(outs)
        self._free_dev, self._used_dev = free_out, used_out
        self._free_synced = True  # provisional; the caller desyncs on reject
        self.dispatches += 1
        return host[:, 0], host[:, 1], host[:, 2], host[:, 3], host[:, 4:]

    def _replay(self, route, key, cols, free, vecs, stages, numa=None):
        """The window from its shape's graph, captured first on the
        ``"capture"`` route: the inputs copied into its static buffers,
        one launch. Returns the graph's ``outs`` and its carry, and with
        ``numa`` (the NRT window's zone columns, zone carry and pod rows)
        its zone carry too."""
        dev, n, k, want_ties = key[:4]
        with _GRAPH_LOCK:
            if route != "capture":
                graph = self._graphs.graph
            elif numa is None:
                graph = _WindowGraph(dev, n, k)
            else:
                graph = _NumaWindowGraph(dev, n, k, key[5])
            graph.load(cols, free, _pinned(vecs))
            if numa is not None:
                graph.load_numa(*numa)
            if stages is not None:
                stages.split("drip_launch")
            if route == "capture":
                if self._capture_stream is None:
                    self._capture_stream = torch.cuda.Stream(device=dev)
                graph.capture(want_ties, self._capture_stream)
                self._graphs.hold(key, graph)
                self.graph_captures += 1
            graph.graph.replay()
        self.graph_replays += 1
        self.kernel_windows += 1
        if numa is not None:
            return graph.outs, graph.free, graph.used
        return graph.outs, graph.free

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
        self.eager_windows += 1
        return host[:, 0], host[:, 1], host[:, 2]


def drip_batch_dispatch(schedulable, weighted, bounded, free, vecs, device=None):
    """One-shot functional entry (benchmarks, tests): no carry reuse."""
    return DripBatchKernel(device=device).dispatch(schedulable, weighted, bounded, free, vecs)
