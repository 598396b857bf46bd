"""Wrapper of the fused filter+score CUDA kernel (``csrc/score_kernel.cu``).

Counterpart of ``crane_scheduler_tpu/scorer/pallas_kernel.py``: the same
function as ``BatchedScorer(float32)._score_impl`` in one pass over the
node-major ``[N, M]`` float32 matrices the scheduling step holds, with
``now`` passed in (the step re-scores a cached snapshot at later rebased
times). CPU tensors take the plain version, ``batched.score_plain``; CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import CudaKernel
from .batched import PolicyConstants, score_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

KERNEL = CudaKernel(
    "score_kernel.cu",
    "crane_score_nodes",
    [_P, _P, _P, _P, _P, _I, _I, _F,  # values, ts, hot, hot_ts, valid, n, m, now
     _P, _P, _P, _I,  # predicates: idx, threshold, window, count
     _P, _P, _P, _I,  # priorities: idx, weight, window, count
     _F, _F,  # weight_sum, hot-value window
     _P, _P, _P],  # sched out, score out, stream
)


def _check(values, ts, hot_value, hot_ts, node_valid, consts: PolicyConstants):
    dev = values.device
    if values.dim() != 2 or ts.shape != values.shape:
        raise ValueError(f"values/ts must be matching [N, M], got {tuple(values.shape)} and {tuple(ts.shape)}")
    n, m = values.shape
    if m != consts.num_metrics:
        raise ValueError(f"load matrix has {m} metric columns, policy has {consts.num_metrics}")
    for name, t, dt, shape in (
        ("values", values, torch.float32, (n, m)),
        ("ts", ts, torch.float32, (n, m)),
        ("hot_value", hot_value, torch.float32, (n,)),
        ("hot_ts", hot_ts, torch.float32, (n,)),
        ("node_valid", node_valid, torch.bool, (n,)),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, values on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if consts.dtype != torch.float32:
        raise TypeError("the fused kernel scores in float32")
    if consts.device != dev:
        raise ValueError(f"policy constants are on {consts.device}, inputs on {dev}")


def fused_score(values, ts, hot_value, hot_ts, node_valid, now: float,
                consts: PolicyConstants):
    """``(schedulable bool [N], scores int32 [N])`` for float32 inputs with
    timestamps rebased to the same origin as ``now``."""
    if values.device.type == "cpu":
        return score_plain(values, ts, hot_value, hot_ts, node_valid, now, consts)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    _check(values, ts, hot_value, hot_ts, node_valid, consts)
    n, m = values.shape
    sched = torch.empty((n,), dtype=torch.bool, device=values.device)
    scores = torch.empty((n,), dtype=torch.int32, device=values.device)
    if n == 0:
        return sched, scores
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        KERNEL.launch(
            values.data_ptr(), ts.data_ptr(), hot_value.data_ptr(),
            hot_ts.data_ptr(), node_valid.data_ptr(), n, m, now,
            consts.pred_idx_d.data_ptr(), consts.pred_threshold_d.data_ptr(),
            consts.pred_active_d.data_ptr(), len(consts.pred),
            consts.prio_idx_d.data_ptr(), consts.prio_weight_d.data_ptr(),
            consts.prio_active_d.data_ptr(), len(consts.prio),
            consts.weight_sum, consts.hot_active,
            sched.data_ptr(), scores.data_ptr(), stream,
        )
    return sched, scores
