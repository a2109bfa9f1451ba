"""Runs one cell of BENCHMARK.json against ssw_tpu_torch.

Everything that belongs to one configuration, traffic mix or metric is
found by name: configs/<config>.json; traffic/<traffic>.json, a data file
whose `entry` names the driver entries/<entry>.py and its comparison
compare/<entry>.py; the configuration's target kind, read model and
scoring matrix as targets/, readmodels/ and scoring/<name>.py
(plugins.py); metrics/<metric>.py, or metrics/<name before the first
dot>.py shared by a metric's per-configuration names (a `read(ctx)` that
returns a number or None); and layers/<class>/*.txt (kernel-name
substrings that class a device kernel into a layer).

A run: set-up (imports, kernel libraries, data from the seed, one warm-up
call or a few hundred), the measured window of whole calls, the
reference's comparison on a sample drawn from the seed, the metrics.  With
trace=True the window runs under torch.profiler and the program's
pipeline.profiled phases, and the per-layer metrics are read instead of
the end-to-end ones.
"""

from __future__ import annotations

import contextlib
import gc
import glob
import json
import os
import sys
import tempfile
import time
import types

import torch

from benchmark import check, opcount, tracing
from benchmark.plugins import plugin

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "ssw_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_specs(man: dict, workload: str):
    """(cell, config, traffic, end_to_end specs, per_layer specs)."""
    cell = next(w for w in man["workloads"] if w["name"] == workload)
    conf = next(c for c in man["configs"] if c["name"] == cell["config"])
    cfg = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     cell["traffic"] + ".json"))

    def mine(specs):
        return [m for m in specs if workload in m.get("workloads",
                                                      [workload])]
    return cell, cfg, traffic, mine(man["end_to_end"]), mine(man["per_layer"])


def forbidden_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in sys.modules
                   if n.split(".")[0] in FORBIDDEN})


def reader(name: str):
    """metrics/<name>.py's read, or that of the metric's name before its
    first dot (one reader for reads_per_s.illumina and reads_per_s.ion)."""
    if not os.path.isfile(os.path.join(HERE, "metrics", name + ".py")):
        name = name.split(".")[0]
    return plugin("metrics", name).read


def kernel_classes() -> dict:
    out = {}
    for d in sorted(glob.glob(os.path.join(HERE, "layers", "*"))):
        pats = []
        for f in sorted(glob.glob(os.path.join(d, "*.txt"))):
            with open(f) as fh:
                pats += [ln.strip() for ln in fh
                         if ln.strip() and not ln.startswith("#")]
        out[os.path.basename(d)] = pats
    return out


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# --- one run ---------------------------------------------------------------

def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, man: dict | None = None,
             cfg: dict | None = None, traffic: dict | None = None):
    """One run of one cell.  Returns (result dict, check lines).  device
    None is the card; tests pass "cpu" with small cfg/traffic."""
    man = man or manifest()
    _, cfg0, traffic0, e2e, per_layer = cell_specs(man, workload)
    cfg, traffic = cfg or cfg0, traffic or traffic0
    dev = torch.device("cuda" if device is None else device)
    on_card = dev.type == "cuda"
    with tempfile.TemporaryDirectory(prefix="sswbench_") as tmp:
        driver = plugin("entries", traffic["entry"]).Driver(
            cfg, traffic, seed, dev, tmp)
        span = ((lambda: tracing.span("call")) if trace
                else contextlib.nullcontext)
        driver.warm_up()
        sync(dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        counter = tracing.phase_counter() if trace else None
        # the set-up's objects (the read pool) out of the collector's way
        gc.collect()
        gc.freeze()
        with tracing.window(trace, dev) as tw:
            t0 = time.perf_counter()
            setup_s = t0 - t_start
            with tracing.profiled(counter):
                driver.run(seconds, t0, span)
            sync(dev)
            window_s = time.perf_counter() - t0
        mem_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        name = torch.cuda.get_device_name(dev) if on_card else "cpu"
        summary = (tracing.summarize(tw.prof, kernel_classes())
                   if trace else None)
        driver.free()
        if on_card:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        ref_stages = {}
        checks = plugin("compare", traffic["entry"]).compare(
            driver, dev, None, ref_stages)
        reference_s = time.perf_counter() - t_ref
        print("reference stages (s): " + json.dumps(ref_stages),
              file=sys.stderr)

    ctx = types.SimpleNamespace(
        setup_s=setup_s, window_s=window_s,
        calls=driver.calls, attempted=driver.attempted(),
        reads_done=driver.attempted() - driver.failed(),
        latencies_s=driver.latencies(),
        phases=dict(counter.seconds) if counter is not None else None,
        trace=summary, mem_peak_bytes=mem_peak if on_card else None,
        forward_cells=driver.forward_cells(),
        peak_cells_per_s=opcount.peak_cells_per_s(name) if on_card
        else None)
    metrics = {}
    for m in (per_layer if trace else e2e):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {
        "correct": check.correct(checks) and driver.failed() == 0,
        "attempted": driver.attempted(),
        "failed": driver.failed(),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": name,
                   "count": 1, "memory_peak_bytes": int(mem_peak)},
    }
    if trace:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result.update(driver.extra())
    result["reference_s"] = reference_s
    result["checks"] = checks
    lines = [f"check {k}: {c['value']} (limit {c['limit']}"
             + (f", of {c['of']} compared)" if "of" in c else ")")
             for k, c in checks.items()]
    return result, lines

