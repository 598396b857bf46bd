"""The full scheduling step over a node mesh: score, then gang-assign, per tile.

Counterpart of ``crane_scheduler_tpu/parallel/sharded.py``. The reference
annotates node-axis shardings on one jitted program and lets GSPMD place
the collectives; here the node axis is split into equal tiles by hand
(``mesh.node_tiles``) and the step runs each phase once per tile:

    load tensors [N/S, M] per tile
      -> filter mask + scores     per tile (K1 on CUDA f32 tiles)
      -> level totals             per tile (K2 on CUDA tiles), summed
      -> waterline l_star         once, from the global totals
      -> upper / exact per node   per tile; sum(upper) and each tile's
                                  sum(exact) combined once
      -> counts per node          per tile, the node-order prefix seeded
                                  with the tile's offset

The combines are int32 sums, exact in any order (the token clip uses the
global row count, as the reference's program sees the global array). The
packed result is assembled in node order on the first tile's device. A
1-tile mesh runs ``ScheduleStep``'s own code.

A ``PreparedSnapshot`` of a tiled step (``TiledSnapshot``) holds the same
fields, each a tuple of per-tile tensors, plus the global row count.
The uploads and updates (``prepare``, ``with_overrides``,
``apply_delta``, ``apply_columns``, ``with_vectors``) are
``ScheduleStep``'s, which are written over spans: this class only says
where the tiles lie (``_row_spans``). Rows come in the host snapshot's
numbering, split into tile-local ids, and rows past the snapshot drop
(the reference's padding index ``npad`` drops the same way).

Over a mesh from ``distributed.global_node_mesh`` each process holds only
its own tiles. The three combines and the final assembly are
``all_reduce`` sums across processes (each process writes its own rows
into a zeroed packed vector, process 0 the replicated tail), so every
rank returns the full packed vector, in process order. Gloo has no
collectives on CUDA tensors for every op and NCCL has none on CPU
tensors, so under gloo the few small vectors travel through CPU tensors.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from ..scorer.batched import BatchedScorer
from ..scorer.topk import GangScheduler
from .column_cache import DeviceColumnCache
from .mesh import NodeMesh, node_tiles
from .step import (
    PreparedSnapshot,
    ScheduleStep,
    StepResult,
    compact_body,
    compact_tail,
    compact_words,
)

__all__ = ["DeviceColumnCache", "ShardedScheduleStep", "TiledSnapshot"]


@dataclass
class TiledSnapshot(PreparedSnapshot):
    """A ``PreparedSnapshot`` whose tensor fields are tuples of this
    process's per-tile tensors. ``n_rows`` is the global padded row count;
    the host snapshot it came from covers ``host_rows`` rows starting at
    global row ``host_row0`` (the whole node axis, or one process's shard)."""

    n_rows: int = 0
    host_row0: int = 0
    host_rows: int = 0

    def rows(self) -> int:
        return self.n_rows


class ShardedScheduleStep(ScheduleStep):
    """score + gang-assign with the node axis tiled over ``mesh``."""

    def __init__(self, tensors, mesh: NodeMesh, dtype=torch.float32,
                 dynamic_weight: int = 1, max_offset: int = 0, telemetry=None):
        """A float32 step is hybrid, as ``ScheduleStep``'s is. The first
        tile's device holds the replicated values and the packed result."""
        super().__init__(tensors, dtype=dtype, device=mesh.devices[0],
                         telemetry=telemetry, dynamic_weight=dynamic_weight,
                         max_offset=max_offset)
        self.mesh = mesh
        self.tiled = mesh.size > 1 or mesh.distributed
        # one scorer and solver per distinct tile device (constants live there)
        self._parts = {self.device: (self.scorer, self.gang)}
        for dev in mesh.devices:
            if dev not in self._parts:
                self._parts[dev] = (
                    BatchedScorer(tensors, dtype=dtype, device=dev),
                    GangScheduler(tensors.hv_count, dynamic_weight=dynamic_weight,
                                  max_offset=max_offset, device=dev),
                )

    # -- geometry ----------------------------------------------------------

    def _row_spans(self, n_rows: int, host_row0: int = 0) -> list:
        """``(device, start, stop)`` of each local tile in host rows."""
        if not self.tiled:
            return super()._row_spans(n_rows, host_row0)
        return [(dev, a - host_row0, b - host_row0)
                for dev, a, b in node_tiles(self.mesh, n_rows)]

    def _spans(self, prepared) -> list:
        if not self.tiled:
            return super()._spans(prepared)
        return self._row_spans(prepared.n_rows, prepared.host_row0)

    def _snapshot(self, fields: dict, n_rows: int, host_row0: int, host_rows: int):
        if not self.tiled:
            return super()._snapshot(fields, n_rows, host_row0, host_rows)
        return TiledSnapshot(**fields, n_rows=n_rows, host_row0=host_row0,
                             host_rows=host_rows)

    # -- the step ----------------------------------------------------------

    def _collective(self):
        """The process-wide collective lock when the mesh spans processes
        (concurrent steps must not interleave their all_reduce calls)."""
        if not self.mesh.distributed:
            return contextlib.nullcontext()
        from .distributed import COLLECTIVE_LOCK

        return COLLECTIVE_LOCK

    def _all_sum(self, t: torch.Tensor) -> torch.Tensor:
        if not self.mesh.distributed:
            return t
        from .distributed import all_sum

        return all_sum(t)

    def _tile_step(self, prepared: TiledSnapshot, num_pods: int, now):
        """Every phase over this process's tiles: per tile ``(schedulable,
        scores, counts)`` on the tile's device, and ``(unassigned,
        waterline)`` on the first tile's."""
        vecs = self._args(prepared, now)
        n_tiles = len(prepared.values)
        per_tile = [tuple(v[t] if isinstance(v, tuple) else v for v in vecs)
                    for t in range(n_tiles)]
        dev0 = self.device
        num_pods = min(int(num_pods), 2**31 - 1)
        tiles = []
        for tv in per_tile:
            values, ts, hot_value, hot_ts, node_valid, now_value, capacity, offsets = tv[:8]
            scorer, gang = self._parts[values.device]
            schedulable, scores = scorer._score_impl(values, ts, hot_value, hot_ts,
                                                     node_valid, now_value)
            if self.hybrid:
                ovr_mask, ovr_sched, ovr_score = tv[8:]
                schedulable = torch.where(ovr_mask, ovr_sched & node_valid, schedulable)
                scores = torch.where(ovr_mask & node_valid, ovr_score, scores)
            inputs = gang._tile_inputs(scores, schedulable, num_pods, capacity, offsets,
                                       torch.zeros_like(offsets), prepared.n_rows)
            totals = gang._tile_totals(*inputs)  # K2 on CUDA tiles
            tiles.append([gang, schedulable, scores, inputs, totals])
        # combine 1: the level totals of every node
        totals = torch.stack([t[4].to(dev0) for t in tiles]).sum(dim=0, dtype=torch.int32)
        totals = self._all_sum(totals)
        levels = torch.arange(self.gang._n_levels, dtype=torch.int32, device=dev0)
        l_star = self.gang._waterline(totals, levels, num_pods)
        # combine 2: sum(upper) and each tile's sum(exact), in node order
        sums = torch.zeros((self.mesh.size + 1,), dtype=torch.int32, device=dev0)
        first = self.mesh.first_tile
        for k, tile in enumerate(tiles):
            gang, _s, _sc, (s, offs, k_cap, pri), _tot = tile
            l_t = l_star.to(s.device)
            upper, exact = gang._tile_upper_exact(s, offs, k_cap, pri, l_t)
            tile += [l_t, upper, exact]
            sums[first + k] = exact.sum(dtype=torch.int32).to(dev0)
            sums[-1] += upper.sum(dtype=torch.int32).to(dev0)
        sums = self._all_sum(sums)
        remainder = num_pods - sums[-1]
        starts = torch.cumsum(sums[:-1], dim=0, dtype=torch.int32) - sums[:-1]
        out = []
        for k, (gang, schedulable, scores, inputs, _tot, l_t, upper, exact) in enumerate(tiles):
            dev = l_t.device
            counts = gang._tile_counts(inputs[2], upper, exact, remainder.to(dev),
                                       starts[first + k].to(dev), l_t)
            out.append((schedulable, scores, counts))
        unassigned, waterline = self.gang._outcome(totals, l_star, num_pods)
        return out, unassigned, waterline

    def _gather(self, local: torch.Tensor, prepared: TiledSnapshot,
                tail: torch.Tensor, sections: int) -> torch.Tensor:
        """The whole packed vector on every process: this process's rows of
        each of ``sections`` node sections (``local``: [sections, rows]),
        written into zeros and summed across processes; the replicated
        ``tail`` counts once (process 0's)."""
        if not self.mesh.distributed:
            return torch.cat([local.reshape(-1), tail])
        n = prepared.n_rows
        full = torch.zeros((sections * n + tail.shape[0],), dtype=local.dtype,
                           device=local.device)
        r0, rows = prepared.host_row0, local.shape[1]
        for sec in range(sections):
            full[sec * n + r0: sec * n + r0 + rows] = local[sec]
        if self.mesh.process_index == 0:
            full[sections * n:] = tail
        return self._all_sum(full)

    def __call__(self, prepared, num_pods: int, now: float | None = None) -> StepResult:
        if not self.tiled:
            return super().__call__(prepared, num_pods, now)
        wide = self._packed_words(prepared, int(num_pods), now, compact=False)
        n = prepared.n_rows
        return StepResult(wide[:n].to(torch.bool), wide[n:2 * n], wide[2 * n:3 * n],
                          wide[3 * n], wide[3 * n + 1])

    def _packed_words(self, prepared, num_pods: int, now, compact: bool) -> torch.Tensor:
        """The packed result in node order on the first tile's device: the
        compact [N+2] words, or the wide [3N+2] int32 schedulable | scores
        | counts | unassigned, level."""
        if not self.tiled:
            return super()._packed_words(prepared, num_pods, now, compact)
        with self._collective():
            out, unassigned, waterline = self._tile_step(prepared, num_pods, now)
            dev0 = self.device
            if compact:
                local = compact_words([compact_body(*t).to(dev0) for t in out])[None, :]
                tail = compact_words([compact_tail(unassigned, waterline)])
            else:
                local = torch.stack([torch.cat([t[i].to(torch.int32).to(dev0) for t in out])
                                     for i in range(3)])
                tail = torch.stack([unassigned, waterline]).to(torch.int32)
            words = self._gather(local, prepared, tail, local.shape[0])
            if self.mesh.distributed and words.is_cuda:
                torch.cuda.current_stream(words.device).synchronize()
            return words
