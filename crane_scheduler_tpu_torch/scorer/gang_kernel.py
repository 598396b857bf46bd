"""Wrapper of the gang level-table totals CUDA kernel (``csrc/gang_totals.cu``).

Counterpart of ``crane_scheduler_tpu/scorer/pallas_gang.py``: ``totals[L] =
Σ_n A_n(L)`` for the dense level grid of the water-filling solve
(``topk.GangScheduler``), without writing the ``[n_levels, N]`` table to
device memory. ``a_table`` is the per-node token count both the solver
and the plain version use; ``gang_totals_plain`` is the kernel's plain
version. CPU tensors take it; CUDA tensors launch the kernel or raise.

The kernel adds each node's step function of L (at most 13 steps) into a
per-block difference histogram and prefix-scans it, so its work does not
grow with the level count; the histogram lives in shared memory, which
bounds the level count per launch (``max_levels``).
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import MAX_NODE_SCORE
from ..kernels import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = CudaKernel(
    "gang_totals.cu",
    "crane_gang_totals",
    [_P, _P, _P, _P, _I,  # s, offs, cap, pri, n
     _P, _I, _I,  # g staircase [11], dynamic weight, n_levels
     _P, _P],  # totals out (zeroed), stream
)

_MAX_LEVELS: dict[int, int] = {}  # device index -> levels one launch holds


def max_levels(device: torch.device) -> int:
    """The largest ``n_levels`` the kernel takes on ``device`` (a CUDA
    device): its opt-in shared memory per block in 4-byte bins."""
    if device.index not in _MAX_LEVELS:
        query = KERNEL.function("crane_gang_totals_max_levels", [])
        with torch.cuda.device(device):
            got = query()
        if got <= 0:
            raise RuntimeError(f"crane_gang_totals_max_levels failed with CUDA error {-got}")
        _MAX_LEVELS[device.index] = got
    return _MAX_LEVELS[device.index]


def a_table(s, offsets, k_cap, prior, lv, g, w: int):
    """A_n(L): tokens of node n valued >= level L, for ``lv`` broadcast
    against the node axis (``topk.py`` ``GangScheduler._a_table`` in the
    reference). Level 0, and any L <= offset, is the full ``k_cap``;
    ``prior`` tokens were taken by an earlier pass and come off the
    unlocked count. int32 throughout; ``//`` floors as in the reference."""
    qnum = lv - offsets
    q = torch.div(qnum + (w - 1), w, rounding_mode="floor")
    xq = torch.clamp(torch.div(s - q, 10, rounding_mode="floor"), 0, 10)
    unlocked = torch.where((q <= MAX_NODE_SCORE) & (s >= q), g[xq.long()], 0)
    unlocked = torch.clamp(unlocked - prior, min=0)
    unlocked = torch.where(qnum <= 0, k_cap, unlocked)
    return torch.minimum(k_cap, unlocked)


def gang_totals_plain(s, offs, k_cap, pri, g, w: int, n_levels: int):
    """Dense totals through the materialized [n_levels, N] table."""
    levels = torch.arange(n_levels, dtype=torch.int32, device=s.device)
    table = a_table(s[None, :], offs[None, :], k_cap[None, :], pri[None, :],
                    levels[:, None], g, w)
    return table.sum(dim=1, dtype=torch.int32)


def gang_totals(s, offs, k_cap, pri, g, w: int, n_levels: int):
    """``totals`` int32 [n_levels] for int32 [N] scores, offsets (clipped
    to [0, max_offset]), per-node capacity (clipped to (2^31-1)//N) and
    prior counts, and the int32 [11] hot-penalty staircase ``g``."""
    if s.device.type == "cpu":
        return gang_totals_plain(s, offs, k_cap, pri, g, w, n_levels)
    if s.device.type != "cuda":
        raise ValueError(f"unsupported device {s.device}")
    n = s.shape[0]
    for name, t, shape in (("s", s, (n,)), ("offs", offs, (n,)),
                           ("k_cap", k_cap, (n,)), ("pri", pri, (n,)),
                           ("g", g, (11,))):
        if t.device != s.device:
            raise ValueError(f"{name} is on {t.device}, s on {s.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if w < 1 or n_levels < 1:
        raise ValueError(f"need dynamic weight >= 1 and n_levels >= 1, got {w}, {n_levels}")
    if n == 0:
        return torch.zeros((n_levels,), dtype=torch.int32, device=s.device)
    limit = max_levels(s.device)
    if n_levels > limit:
        raise ValueError(
            f"n_levels={n_levels} exceeds the {limit} levels the gang totals "
            f"kernel's shared-memory histogram holds on {s.device}"
        )
    totals = torch.zeros((n_levels,), dtype=torch.int32, device=s.device)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        KERNEL.launch(
            s.data_ptr(), offs.data_ptr(), k_cap.data_ptr(), pri.data_ptr(), n,
            g.data_ptr(), w, n_levels, totals.data_ptr(), stream,
        )
    return totals
