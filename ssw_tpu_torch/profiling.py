"""Observability: GCUPS accounting and device tracing.

The reference's only instrumentation is a CPU-time print around the
alignment loop (ref: src/main.c:461,533-535).  This module adds explicit
DP-cell accounting (GCUPS = 1e9 cells/s), phase timers that separate
I/O / device / traceback time, and an optional torch.profiler trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field


@dataclass
class GcupsCounter:
    """Accumulates DP-cell counts and wall time per phase.

    cells for one pair = ref_len * read_len; callers add the *useful* cells
    (not padded lanes), so the reported GCUPS is honest about batching
    waste.
    """
    cells: int = 0
    seconds: dict = field(default_factory=dict)

    def add_pairs(self, read_lens, ref_len: int, passes: int = 1):
        self.cells += int(sum(int(l) for l in read_lens)) * ref_len * passes

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)

    @property
    def device_seconds(self) -> float:
        return self.seconds.get("device", 0.0)

    def gcups(self, phase: str = "device") -> float:
        dt = self.seconds.get(phase, 0.0)
        return self.cells / dt / 1e9 if dt else 0.0

    def report(self) -> str:
        total = sum(self.seconds.values())
        parts = {k: round(v, 4) for k, v in self.seconds.items()}
        return json.dumps({
            "cells": self.cells,
            "seconds": parts,
            "total_seconds": round(total, 4),
            "gcups_device": round(self.gcups("device"), 3),
            "gcups_wall": round(self.cells / total / 1e9, 3) if total else 0,
        })


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler trace context writing a Chrome trace into log_dir
    (no-op when log_dir is None).  View with Perfetto or chrome://tracing."""
    if not log_dir:
        yield
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
