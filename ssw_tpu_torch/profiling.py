"""Observability: GCUPS accounting, a span tree, counts and device tracing.

The reference's only instrumentation is a CPU-time print around the
alignment loop (ref: src/main.c:461,533-535).  This module adds explicit
DP-cell accounting (GCUPS = 1e9 cells/s), phase timers that separate the
pipeline's host waits, spans at the boundaries of the front ends and the
orchestration (one tree per call: a span opened with none open is a root
and starts a request), counts of events such as blocking device->host
copies, and an optional torch.profiler trace on which every span appears
as a `ssw:<name>` annotation beside the device's kernels and copies.

One counter is active at a time: pipeline.profiled routes it.  With none
routed, span() and count() cost one global read.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _autograd_profiler

_counter = None  # the routed GcupsCounter (pipeline.profiled sets it)
_last = None     # the counter of the last routed window that closed
_NULL = contextlib.nullcontext()


class _Span:
    """One open span of `counter`; see GcupsCounter.span.  A phase's span
    (phase is its name) also adds its duration to counter.seconds."""
    __slots__ = ("counter", "name", "phase", "sid", "request", "child_ns",
                 "t0", "annotation")

    def __init__(self, counter, name: str, phase: str | None = None):
        self.counter, self.name, self.phase = counter, name, phase

    def __enter__(self):
        c = self.counter
        if c._open:
            self.request = c._open[-1].request
        else:
            self.request = c.requests
            c.requests += 1
        self.sid = c._next_id
        c._next_id += 1
        self.child_ns = 0
        c._open.append(self)
        self.annotation = None
        if _autograd_profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(
                "ssw:" + self.name)
            self.annotation.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        c = self.counter
        c._open.pop()
        dur = t1 - self.t0
        parent = c._open[-1] if c._open else None
        if parent is not None:
            parent.child_ns += dur
        tot = c._totals.get(self.name)
        if tot is None:
            tot = c._totals[self.name] = [0, 0, 0]
        tot[0] += 1
        tot[1] += dur
        tot[2] += dur - self.child_ns
        c.spans.append((self.name, self.sid,
                        None if parent is None else parent.sid,
                        self.request, self.t0, t1))
        if self.phase is not None:
            c.seconds[self.phase] = c.seconds.get(self.phase, 0.0) + dur / 1e9
        return False


@dataclass
class GcupsCounter:
    """Accumulates DP-cell counts, wall time per pipeline phase, a span
    tree and counts.

    cells for one pair = ref_len * read_len; callers add the *useful* cells
    (not padded lanes), so the reported GCUPS is honest about batching
    waste.  `seconds` holds phase names only (the pipeline's forward,
    rerun, suboptimal, reverse, traceback; a tool may time one of its
    own); spans never write to it.  `spans` holds one (name, span id,
    parent span id or None, request id, start ns, end ns) per closed span,
    on time.perf_counter_ns's clock; `requests` is the number of root
    spans opened.
    """
    cells: int = 0
    seconds: dict = field(default_factory=dict)
    spans: list = field(default_factory=list)
    counts: dict = field(default_factory=dict)
    requests: int = 0
    _next_id: int = field(default=0, repr=False)
    _open: list = field(default_factory=list, repr=False)
    _totals: dict = field(default_factory=dict, repr=False)

    def add_pairs(self, read_lens, ref_len: int, passes: int = 1):
        self.cells += int(sum(int(l) for l in read_lens)) * ref_len * passes

    def phase(self, name: str):
        """Time a pipeline phase into seconds[name]; also the span
        `phase.<name>` of the tree."""
        return _Span(self, "phase." + name, name)

    def span(self, name: str):
        """A span `name` under the innermost open one.  While a
        torch.profiler records, it is also the annotation `ssw:<name>`."""
        return _Span(self, name)

    def count(self, name: str, n: int = 1):
        self.counts[name] = self.counts.get(name, 0) + n

    def totals(self) -> dict:
        """name -> (calls, total seconds, self seconds); self time is a
        span's duration less that of its direct children."""
        return {k: (v[0], v[1] / 1e9, v[2] / 1e9)
                for k, v in self._totals.items()}

    @property
    def device_seconds(self) -> float:
        return self.seconds.get("device", 0.0)

    def gcups(self, phase: str = "device") -> float:
        dt = self.seconds.get(phase, 0.0)
        return self.cells / dt / 1e9 if dt else 0.0

    def report(self) -> str:
        return json.dumps({
            "cells": self.cells,
            "seconds": {k: round(v, 4) for k, v in self.seconds.items()},
            "gcups_forward": round(self.gcups("forward"), 3),
            "spans": {k: [n, round(t, 6), round(s, 6)]
                      for k, (n, t, s) in self.totals().items()},
            "counts": dict(self.counts),
        })


@contextlib.contextmanager
def profiled(counter):
    """Route the spans, counts, phases and cell counts of the enclosed
    calls into `counter` (pipeline.profiled); on exit it stays readable
    as last()."""
    global _counter, _last
    prev, _counter = _counter, counter
    try:
        yield counter
    finally:
        _counter = prev
        if counter is not None:
            _last = counter


def last():
    """The counter of the last profiled window that closed, or None."""
    return _last


def span(name: str):
    """The routed counter's span `name`, or a shared null context."""
    c = _counter
    return _NULL if c is None else _Span(c, name)


def phase(name: str):
    """The routed counter's phase `name`, or a shared null context."""
    c = _counter
    return _NULL if c is None else c.phase(name)


def count(name: str, n: int = 1):
    c = _counter
    if c is not None:
        c.count(name, n)


def add_pairs(read_lens, ref_len: int):
    c = _counter
    if c is not None:
        c.add_pairs(read_lens, ref_len)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler trace context writing a Chrome trace into log_dir
    (no-op when log_dir is None).  View with Perfetto or chrome://tracing.
    The routed counter's spans appear on it as `ssw:<name>`."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
