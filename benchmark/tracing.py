"""A traced window: torch.profiler over a few calls, reduced to what the
per-layer metrics read.

``Trace`` is entered around the calls and stopped with the card idle
(a synchronize on both sides). From the profiler's raw events it keeps:

- ``window_s``: the host clock from the start to the end of the window;
- ``kernels``: (name, start ns, duration ns) of every device kernel;
  ``busy_s`` is the union of every device operation's interval
  (kernels, copies, sets): the seconds in which the card ran something;
- ``launches``: the host's launch calls (kernel and graph launches of
  the CUDA runtime and driver APIs), a graph launch counting once;
- ``breakdown``: the device operations that took most time, and the
  idle gaps between device operations summed by the host operator that
  was running when the operation after the gap was launched.
"""

from __future__ import annotations

import bisect
import time

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch", "cuGraphLaunch")
TOP = 10


class Trace:
    def __init__(self, device):
        self.device = torch.device(device)
        self.window_s = None
        self._prof = None

    def __enter__(self) -> "Trace":
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._reduce(self._prof.profiler.kineto_results.events())
        self._prof = None

    def _reduce(self, events) -> None:
        device_ops, kernels, host_ops = [], [], []
        launch_at: dict = {}
        launches = 0
        cuda = torch.autograd.DeviceType.CUDA
        for e in events:
            name = e.name()
            if e.device_type() == cuda:
                if e.is_user_annotation() or e.is_hidden_event():
                    continue
                op = (name, e.start_ns(), e.duration_ns(),
                      e.correlation_id())
                device_ops.append(op)
                if not name.startswith(("Memcpy", "Memset")):
                    kernels.append(op[:3])
            elif name.startswith(("cuda", "cu")):
                # every runtime and driver call: what launched each
                # device operation, copies included
                launch_at[e.correlation_id()] = e.start_ns()
                launches += name in LAUNCH_CALLS
            elif not e.is_user_annotation():
                host_ops.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                 name))
        device_ops.sort(key=lambda o: o[1])
        host_ops.sort()
        self.kernels = kernels
        self.launches = launches
        # the union of the device operations' intervals, and its gaps
        busy, gaps, end = 0, [], None
        for op in device_ops:
            s, e = op[1], op[1] + op[2]
            if end is None or s >= end:
                if end is not None and s > end:
                    gaps.append((s - end, op[3]))
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        self.busy_s = busy / 1e9
        by_kernel: dict = {}
        for name, _, dur, _ in device_ops:
            by_kernel[name] = by_kernel.get(name, 0) + dur
        by_host: dict = {}
        starts = [h[0] for h in host_ops]
        for gap, corr in gaps:
            what = _host_op_at(host_ops, starts, launch_at.get(corr))
            by_host[what] = by_host.get(what, 0) + gap
        self.breakdown = {
            "device_ops": _top(by_kernel), "idle_gaps": _top(by_host)}

    def device_seconds(self, parts: tuple) -> float:
        """Summed duration of the kernels whose name holds one of
        ``parts``."""
        return sum(d for n, _, d in self.kernels
                   if any(p in n for p in parts)) / 1e9


def _host_op_at(host_ops, starts, t) -> str:
    """The innermost host operator running at time ``t``."""
    if t is None:
        return "(launch not traced)"
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        s, e, name = host_ops[i]
        if s <= t <= e:
            return name
        i -= 1
        if t - s > 10 ** 10:
            break
    return "(no host operator)"


def _top(totals: dict) -> list:
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:120], ns / 1e9] for name, ns in ranked]
