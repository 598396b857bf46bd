"""Wrapper of the fused filter+score CUDA kernel (``csrc/score_kernel.cu``).

Counterpart of ``crane_scheduler_tpu/scorer/pallas_kernel.py``: the same
function as ``BatchedScorer(float32)._score_impl`` in one pass over the
node-major ``[N, M]`` float32 matrices the scheduling step holds, with
``now`` passed in (the step re-scores a cached snapshot at later rebased
times). CPU tensors take the plain version, ``batched.score_plain``; CUDA
tensors launch the kernel or raise.

The kernel takes the policy by value (``ScorePolicy``, at most
``MAX_ENTRIES`` predicates and as many priorities; more raises).
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from ..kernels import CudaKernel
from .batched import PolicyConstants, score_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

MAX_ENTRIES = 16  # kMaxEntries in csrc/score_kernel.cu


class ScorePolicy(ctypes.Structure):
    """``ScorePolicy`` of ``csrc/score_kernel.cu``, field for field."""

    _fields_ = [
        ("n_pred", _I), ("n_prio", _I),
        ("pred_col", _I * MAX_ENTRIES), ("pred_thr", _F * MAX_ENTRIES),
        ("pred_active", _F * MAX_ENTRIES),
        ("prio_col", _I * MAX_ENTRIES), ("prio_w", _F * MAX_ENTRIES),
        ("prio_active", _F * MAX_ENTRIES),
        ("weight_sum", _F), ("hot_active", _F),
    ]


KERNEL = CudaKernel(
    "score_kernel.cu",
    "crane_score_nodes",
    [_P, _P, _P, _P, _P, _I, _I, _F,  # values, ts, hot, hot_ts, valid, n, m, now
     ctypes.POINTER(ScorePolicy),  # the policy, copied into the launch
     _P, _P, _P],  # sched out, score out, stream
)

_STRUCTS: "weakref.WeakKeyDictionary[PolicyConstants, ScorePolicy]" = (
    weakref.WeakKeyDictionary()
)


@functools.cache
def _check_layout() -> None:
    """Raise unless ``ScorePolicy`` has the kernel's byte layout."""
    size = KERNEL.function("crane_score_nodes_policy_bytes", [])()
    if size != ctypes.sizeof(ScorePolicy):
        raise RuntimeError(
            f"score_kernel.cu's ScorePolicy is {size} bytes, the wrapper's "
            f"{ctypes.sizeof(ScorePolicy)}"
        )


def policy_struct(consts: PolicyConstants) -> ScorePolicy:
    """The kernel's by-value policy for ``consts`` (built once per
    ``PolicyConstants``); raises when a list exceeds ``MAX_ENTRIES``."""
    got = _STRUCTS.get(consts)
    if got is not None:
        return got
    for kind, entries in (("predicate", consts.pred), ("priority", consts.prio)):
        if len(entries) > MAX_ENTRIES:
            raise ValueError(
                f"policy has {len(entries)} {kind} entries; the fused score "
                f"kernel takes at most {MAX_ENTRIES}"
            )
    pol = ScorePolicy(n_pred=len(consts.pred), n_prio=len(consts.prio),
                      weight_sum=consts.weight_sum, hot_active=consts.hot_active)
    for p, (col, thr, active) in enumerate(consts.pred):
        pol.pred_col[p], pol.pred_thr[p], pol.pred_active[p] = col, thr, active
    for k, (col, weight, active) in enumerate(consts.prio):
        pol.prio_col[k], pol.prio_w[k], pol.prio_active[k] = col, weight, active
    _STRUCTS[consts] = pol
    return pol


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
    pol = policy_struct(consts)
    _check_layout()
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
            ctypes.byref(pol), sched.data_ptr(), scores.data_ptr(), stream,
        )
    return sched, scores
