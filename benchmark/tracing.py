"""The traced window and its reduction.

The benchmark opens its own torch.profiler (CPU and CUDA activity) around
the window and marks it, each call and each of the program's pipeline
phases with record_function spans named `bench:...`.  The phases come from
the program's own pipeline.profiled hook, fed a profiling.GcupsCounter
whose phase() also opens the span.  `summarize` reduces the profiler's raw
events to the device's busy time inside the window, device time per kernel
class and per operation name, and the device's idle gaps labelled by the
span the host was in.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Window:
    prof = None


@contextlib.contextmanager
def window(trace: bool, dev: torch.device):
    tw = Window()
    if not trace:
        yield tw
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("bench:window"):
            yield tw
    tw.prof = prof


def span(name: str):
    return torch.profiler.record_function("bench:" + name)


def phase_counter():
    """A profiling.GcupsCounter whose phases are also profiler spans."""
    from ssw_tpu_torch import profiling

    class PhaseCounter(profiling.GcupsCounter):
        @contextlib.contextmanager
        def phase(self, name: str):
            with span("phase:" + name), super().phase(name):
                yield

    return PhaseCounter()


@contextlib.contextmanager
def profiled(counter):
    if counter is None:
        yield
        return
    from ssw_tpu_torch import pipeline

    with pipeline.profiled(counter):
        yield


def _times(e):
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.end_ns()
    s = int(e.start_us() * 1000)
    return s, s + int(e.duration_us() * 1000)


def summarize(prof, classes: dict) -> dict:
    """busy_s, window_s, kernel_s (per class of `classes`: name
    substrings), n_device_ops, device_ops and idle_gaps (top [name,
    seconds])."""
    from torch.autograd import DeviceType

    win, calls, phases, dev = None, [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if not e.is_user_annotation():
                continue
            name = e.name()
            if name == "bench:window":
                win = _times(e)
            elif name == "bench:call":
                calls.append(_times(e))
            elif name.startswith("bench:phase:"):
                phases.append((*_times(e), name[len("bench:phase:"):]))
            continue
        name = e.name()
        if e.is_user_annotation() or name.startswith("bench:"):
            continue
        act = e.activity_type() if hasattr(e, "activity_type") else None
        if isinstance(act, str) and act not in DEVICE_ACTIVITIES:
            continue
        dev.append((*_times(e), name))
    if win is None:
        raise RuntimeError("the profiler recorded no bench:window span")
    w0, w1 = win
    dev = [(max(s, w0), min(t, w1), n) for s, t, n in dev if t > w0 and s < w1]
    dev.sort()

    per_op = defaultdict(int)
    kernel_ns = {c: 0 for c in classes}
    for s, t, n in dev:
        per_op[n[:120]] += t - s
        for c, pats in classes.items():
            if any(p in n for p in pats):
                kernel_ns[c] += t - s

    busy, gaps, cur = 0, [], None
    for s, t, _ in dev:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            gaps.append((cur[1] if cur else w0, s))
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        busy += cur[1] - cur[0]
    gaps.append((cur[1] if cur else w0, w1))

    phases.sort()
    calls.sort()
    p_starts = [p[0] for p in phases]
    c_starts = [c[0] for c in calls]

    def label(mid):
        i = bisect.bisect_right(p_starts, mid) - 1
        if i >= 0 and phases[i][1] >= mid:
            return "phase:" + phases[i][2]
        i = bisect.bisect_right(c_starts, mid) - 1
        if i >= 0 and calls[i][1] >= mid:
            return "call:outside_phases"
        return "between_calls"

    idle = defaultdict(int)
    for s, t in gaps:
        if t > s:
            idle[label((s + t) // 2)] += t - s

    def top(d):
        return [[k, v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return dict(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                kernel_s={c: v / 1e9 for c, v in kernel_ns.items()},
                n_device_ops=len(dev), n_calls=len(calls),
                device_ops=top(per_op), idle_gaps=top(idle))
