"""``NodeResourceTopologyMatch`` beside Dynamic and NodeResourcesFit: the
sequential scheduling queue, in plain PyTorch and Python integers.

Semantics of crane-scheduler's ``pkg/plugins/noderesourcetopology``
(filter.go, scorer.go, reserver.go, binder.go, helper.go) for the pods and
nodes of a NUMA cell: every node has a CR with Static CPU management; every
pod is Guaranteed, its whole CPU request pinned; zone usage is milli-CPU
only (the plugin's topology-aware resource is CPU):

- Filter: the Dynamic verdict (``reference.dynamic``), Fit (the request
  within allocatable minus requested, one pod slot) and, for an aware pod
  (annotation ``topology.crane.io/topology-awareness: "true"``), a zone
  whose free CPU (allocatable - requested) holds the whole request;
- the zone result: zones by free CPU, descending (CR order among equals);
  an aware pod takes the first; a non-aware pod takes from each zone in
  turn ``min(remaining, whole cores of allocatable - requested)`` until
  the request is met;
- Score: ``dynamic_weight`` x the Dynamic score + ``topology_weight`` x
  ``100 // zones taken`` (100 for an aware pod);
- the best node, ties to the lowest index; then the bind, which takes the
  request from the node's free row and the result's CPU from its zones.

``drip`` keeps one score per node and request class and, after each bind,
works out only the bound node's again; a heap per class finds the best
node (the highest score, the lowest index among equals) as an argmax over
every node would. ``fold_free`` / ``fold_zones`` False are controls: the
free rows, or the zones, stay as they were at the start of each window of
``window`` pods, and take the window's binds at its end.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

MAX_NODE_SCORE = 100


def pack(alloc: list, used: list, req: int, aware: bool):
    """The zone result of one pod on one node: milli-CPU taken per zone in
    CR order, or None when an aware pod finds no zone that holds it."""
    free = [a - u for a, u in zip(alloc, used)]
    order = sorted(range(len(alloc)), key=lambda j: -free[j])  # stable
    takes = [0] * len(alloc)
    if aware:
        fitting = [j for j in order if free[j] >= req]
        if not fitting:
            return None
        takes[fitting[0]] = req
        return takes
    rem = req
    for j in order:
        a = min(rem, alloc[j] // 1000 * 1000 - used[j])
        rem -= a
        if a > 0:
            takes[j] = a
        if rem <= 0:
            break
    return takes


def nrt_score(takes: list, aware: bool) -> int:
    zones = sum(t > 0 for t in takes)
    if zones == 0:
        raise ZeroDivisionError("the plugin's Score divides by the zones of an empty result")
    return MAX_NODE_SCORE if aware else MAX_NODE_SCORE // zones


def class_totals(schedulable, weighted, free, used, alloc, vec, req, aware, nrt_weight):
    """Every node's score for one request class, int64 [N] (None where the
    pod does not pass the Filter), as torch tensors over the columns:
    ``weighted`` int64 [N] (the weighted Dynamic score), ``free`` int64
    [N, 4], ``used`` int64 [N, Z], ``alloc`` the zones' allocatable
    milli-CPU [Z]."""
    schedulable = torch.as_tensor(schedulable)
    free = torch.as_tensor(free, dtype=torch.int64)
    used = torch.as_tensor(used, dtype=torch.int64)
    vec = torch.as_tensor(vec, dtype=torch.int64)
    alloc = torch.as_tensor(alloc, dtype=torch.int64)
    fits = ((free >= vec) | (vec <= 0)).all(dim=1)
    zfree = alloc - used
    ok = schedulable & fits
    if aware:
        ok = ok & (zfree >= req).any(dim=1)
        nrt = torch.full_like(ok, MAX_NODE_SCORE, dtype=torch.int64)
    else:
        # zones by free CPU, descending, CR order among equals
        order = torch.sort(-zfree, dim=1, stable=True).indices
        cap = (alloc // 1000 * 1000 - used).gather(1, order)
        rem = torch.full((free.shape[0],), req, dtype=torch.int64)
        zones = torch.zeros_like(rem)
        for s in range(cap.shape[1]):
            a = torch.where(rem > 0, torch.minimum(rem, cap[:, s]), torch.zeros_like(rem))
            rem = rem - a
            zones = zones + (a > 0).to(torch.int64)
        if bool((ok & (zones == 0)).any()):
            raise ZeroDivisionError("the plugin's Score divides by the zones of an empty result")
        nrt = MAX_NODE_SCORE // zones.clamp(min=1)
    total = torch.as_tensor(weighted, dtype=torch.int64) + nrt_weight * nrt
    return torch.where(ok, total, torch.full_like(total, torch.iinfo(torch.int64).min)), ok


def drip(schedulable, weighted, nrt_weight: int, node_free, alloc, pods, window: int = 128,
         fold_free: bool = True, fold_zones: bool = True, scores_of_last: bool = True):
    """The queue ``pods`` (each ``(vec, req, aware)``: the int64 request
    row [milli-CPU, memory, ephemeral, 1], the guaranteed milli-CPU and
    the awareness) over nodes with the weighted Dynamic score ``weighted``
    and verdict ``schedulable`` [N], allocatable row ``node_free`` [4] and
    zones of allocatable milli-CPU ``alloc`` [Z] (every node the same).

    Returns ``(nodes, takes, counts, scores)``: each pod's node (-1: none),
    its milli-CPU per zone int64 [P, Z], the bound pods per node, and the
    last pod's score of every feasible node before its bind ({node index:
    score})."""
    n = len(schedulable)
    z = len(alloc)
    sched = [bool(s) for s in np.asarray(schedulable)]
    dynw = [int(w) for w in np.asarray(weighted)]
    free = [list(map(int, node_free)) for _ in range(n)]
    used = [[0] * z for _ in range(n)]
    # what the Filter and Score read: the live rows, or (controls) the
    # rows as they were at the window's start
    free_seen = free if fold_free else [list(r) for r in free]
    used_seen = used if fold_zones else [list(r) for r in used]
    classes: dict = {}
    for vec, req, aware in pods:
        classes.setdefault((tuple(int(v) for v in vec), int(req), bool(aware)), len(classes))
    keys = list(classes)

    def total(i, key):
        vec, req, aware = key
        if not sched[i]:
            return None
        row = free_seen[i]
        if any(v > 0 and row[d] < v for d, v in enumerate(vec)):
            return None
        takes = pack(alloc, used_seen[i], req, aware)
        if takes is None:
            return None
        return dynw[i] + nrt_weight * nrt_score(takes, aware)

    # one score per node and class, and a heap per class of (-score,
    # node, version): an entry is live while its version is the node's
    cur = []
    heaps = []
    for key in keys:
        vec, req, aware = key
        t, ok = class_totals(np.asarray(schedulable), np.asarray(weighted),
                             np.asarray(free_seen), np.asarray(used_seen), alloc, vec, req, aware,
                             nrt_weight)
        t = t.tolist()
        ok = ok.tolist()
        cur.append([t[i] if ok[i] else None for i in range(n)])
        heap = [(-t[i], i, 0) for i in range(n) if ok[i]]
        heapq.heapify(heap)
        heaps.append(heap)
    version = [[0] * n for _ in keys]

    def refresh(i):
        for c, key in enumerate(keys):
            t = total(i, key)
            if t != cur[c][i]:
                cur[c][i] = t
                version[c][i] += 1
                if t is not None:
                    heapq.heappush(heaps[c], (-t, i, version[c][i]))

    nodes = np.full(len(pods), -1, np.int64)
    takes_out = np.zeros((len(pods), z), np.int64)
    touched: set = set()
    scores = {}
    for p, (vec, req, aware) in enumerate(pods):
        c = classes[(tuple(int(v) for v in vec), int(req), bool(aware))]
        if scores_of_last and p == len(pods) - 1:
            scores = {i: cur[c][i] for i in range(n) if cur[c][i] is not None}
        heap = heaps[c]
        while heap and heap[0][2] != version[c][heap[0][1]]:
            heapq.heappop(heap)
        if heap:
            i = heap[0][1]
            takes = pack(alloc, used_seen[i], int(req), bool(aware))
            nodes[p] = i
            takes_out[p] = takes
            row = free[i]
            for d in range(4):
                row[d] -= int(vec[d])
            for j in range(z):
                used[i][j] += takes[j]
            touched.add(i)
            refresh(i)
        if (p + 1) % window == 0 or p == len(pods) - 1:
            # the window's end: the seen rows take its binds
            for i in touched:
                if not fold_free:
                    free_seen[i][:] = free[i]
                if not fold_zones:
                    used_seen[i][:] = used[i]
                if not (fold_free and fold_zones):
                    refresh(i)
            touched.clear()
    counts = np.bincount(nodes[nodes >= 0], minlength=n)
    return nodes, takes_out, counts, scores
