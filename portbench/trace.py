"""The reduction from a ``torch.profiler`` session to the numbers the
benchmark reports: device busy seconds over the traced window, device
operations by name, kernel launches, and the idle gaps of the device by
the benchmark's own host span that was open while the device waited."""

from __future__ import annotations

import time
from contextlib import contextmanager


def _is_device(e) -> bool:
    import torch

    return e.device_type == torch.autograd.DeviceType.CUDA


class Session:
    """One profiled stretch. Use ``span(name)`` around each entry call;
    read the numbers after the ``with`` block closes."""

    def __init__(self):
        self.prof = None
        self.window_s = 0.0
        self._spans = []

    @contextmanager
    def run(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield self
            if cuda:
                torch.cuda.synchronize()
            self.window_s = time.perf_counter() - t0
        self.prof = prof

    @contextmanager
    def span(self, name: str):
        from torch.profiler import record_function

        with record_function(name):
            yield

    def summary(self) -> dict:
        """``busy_s``, ``window_s``, ``kernels`` (device kernel events),
        ``launches`` (host kernel-launch calls), per-name device seconds
        and counts, and the idle gaps by host span."""
        events = list(self.prof.events())
        # the benchmark's own spans also leave a device-side annotation
        # (record_function): those are not device work
        dev = [e for e in events if _is_device(e) and e.time_range.end > e.time_range.start
               and not e.name.startswith("bench.")]
        if not dev:
            raise RuntimeError("the profiler recorded no device operation")
        by_name: dict = {}
        for e in dev:
            s, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (s + (e.time_range.end - e.time_range.start) * 1e-6, c + 1)
        # busy time is the union of the device intervals (copies overlap
        # kernels on other streams)
        iv = sorted((e.time_range.start, e.time_range.end) for e in dev)
        busy = 0.0
        cur_s, cur_e = iv[0]
        merged = []
        for s, e in iv[1:]:
            if s > cur_e:
                merged.append((cur_s, cur_e))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        merged.append((cur_s, cur_e))
        busy = sum(e - s for s, e in merged) * 1e-6
        kernels = sum(1 for e in dev if not e.name.startswith(("Memcpy", "Memset")))
        launches = sum(1 for e in events if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                                        "cudaLaunchKernelExC"))
        spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.name.startswith("bench.")]
        gaps: dict = {}
        for (s0, e0), (s1, _e1) in zip(merged, merged[1:]):
            mid = (e0 + s1) / 2
            owner = "outside_any_span"
            for a, b, name in spans:
                if a <= mid <= b:
                    owner = name
                    break
            gaps[owner] = gaps.get(owner, 0.0) + (s1 - e0) * 1e-6
        return {
            "busy_s": busy, "window_s": self.window_s, "kernels": kernels,
            "launches": launches, "by_name": by_name, "idle_gaps": gaps,
        }


def breakdown(summary: dict) -> dict:
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(summary["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name[:64], s] for name, (s, _c) in ops],
            "idle_gaps": [[name, s] for name, s in gaps]}
