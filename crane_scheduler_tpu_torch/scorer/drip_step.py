"""Wrapper of the drip window's step kernel (``csrc/drip_step.cu``).

``drip_window`` runs a whole window on the card: one launch per pod, in
order on the current stream, each the pod's Filter, Score, argmax and
fold over every node, folding the carries in place. It computes what
``drip_batch._drip_batch`` (no zone columns) and ``_drip_batch_numa``
(zone columns) compute, bit for bit; those stay the CPU route and the
kernel's test oracle. The kernel replaces no TPU kernel: the reference's
window is a ``lax.scan``.

Each window's launches merge their per-block partial rows through a
``StepScratch``: int64 scratch and a ticket the kernel returns to 0 at the
end of every launch. A kernel instance or a captured graph owns one, so
two schedulers on one card never share it.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import CudaKernel

_P = ctypes.c_void_p


class DripArgs(ctypes.Structure):
    """``DripArgs`` of ``drip_step.cu``, field for field: every pointer,
    then every int."""

    _fields_ = [(name, _P) for name in (
        "sched", "weighted", "bounded", "free", "vecs", "active", "outs", "scratch", "ticket",
        "zkey", "zcap", "has", "zactive", "act_naw", "used", "pods")] + [
        (name, ctypes.c_int) for name in ("n", "z", "want_ties")]


KERNEL = CudaKernel(
    "drip_step.cu",
    "crane_drip_window",
    [ctypes.POINTER(DripArgs), ctypes.c_int, _P],  # args, pods, stream
)


class StepScratch:
    """The partial rows and the ticket of one kernel instance's windows,
    on ``device`` (a CUDA device). Made before any capture: it loads the
    kernel's library, building it at a checkout's first use."""

    def __init__(self, device: torch.device):
        words = KERNEL.function("crane_drip_scratch_words", [])()
        self.partials = torch.empty((words,), dtype=torch.int64, device=device)
        self.ticket = torch.zeros((1,), dtype=torch.int32, device=device)
        self.device = self.partials.device


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def drip_window(schedulable, weighted, bounded, free, vecs, active, scratch, want_ties=True,
                zones=None):
    """The window's K steps on the card: ``outs`` int64 [K, 3] as
    ``_drip_batch`` gives them, ``free`` int64 [N, 4] folded in place.
    ``zones``: ``(zcols, used, pods)`` as ``_drip_batch_numa`` takes them;
    then ``outs`` is int64 [K, 4 + Z] and ``used`` folds in place too.
    ``scratch``: a ``StepScratch`` on the tensors' device. Raises on a
    tensor of another device, type, shape or layout."""
    n = int(schedulable.shape[0])
    k = int(vecs.shape[0])
    b, i64 = torch.bool, torch.int64
    cols = [("schedulable", schedulable, b, (n,)), ("weighted", weighted, i64, (n,)),
            ("bounded", bounded, b, (n,)), ("free", free, i64, (n, 4)),
            ("vecs", vecs, i64, (k, 4)), ("active", active, b, (k,))]
    z = 0
    if zones is not None:
        (zkey, zcap, has, zactive, act_naw), used, pods = zones
        z = int(used.shape[1]) if used.dim() == 2 else -1
        cols += [("zkey", zkey, i64, (n, z)), ("zcap", zcap, i64, (n, z)),
                 ("has", has, b, (n,)), ("zactive", zactive, b, (n,)),
                 ("act_naw", act_naw, b, (n,)), ("used", used, i64, (n, z)),
                 ("pods", pods, i64, (k, 5 + z))]
    for name, t, dtype, shape in cols:
        _check(name, t, dtype, shape)
    dev = free.device
    if dev.type != "cuda":
        raise ValueError(f"the drip step kernel runs on a CUDA device, not {dev}")
    for name, t, _dtype, _shape in cols:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, free on {dev}")
    if not 0 < n < 2**31 or (zones is not None and z < 1):
        raise ValueError(f"need 1 to 2^31 - 1 nodes and a zone column, got n={n}, z={z}")
    if scratch.device != dev:
        raise ValueError(f"the scratch is on {scratch.device}, the window on {dev}")
    outs = torch.empty((k, 4 + z if zones is not None else 3), dtype=i64, device=dev)
    if k == 0:
        return outs
    ptr = {name: t.data_ptr() for name, t, _d, _s in cols}
    args = DripArgs(
        ptr["schedulable"], ptr["weighted"], ptr["bounded"], ptr["free"], ptr["vecs"],
        ptr["active"], outs.data_ptr(), scratch.partials.data_ptr(), scratch.ticket.data_ptr(),
        ptr.get("zkey"), ptr.get("zcap"), ptr.get("has"), ptr.get("zactive"),
        ptr.get("act_naw"), ptr.get("used"), ptr.get("pods"), n, z, int(bool(want_ties)))
    with torch.cuda.device(dev):
        KERNEL.launch(ctypes.byref(args), k, torch.cuda.current_stream(dev).cuda_stream)
    return outs
