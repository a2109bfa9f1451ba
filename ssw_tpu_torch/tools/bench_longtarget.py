"""The long-target benchmark, BASELINE config 5 on one process: the
counterpart of the JAX package's tools/bench_longtarget.py.

The first --reads (default 1000) records of --fastq (default
bench_data/100k_illumina1.fastq.gz) against --ref (default
bench_data/10M.fa: 1M.fa's slice and a composition-matched random tail, as
tools/make_data.py writes them), through the whole CLI with -c -s -h,
under pipeline.profiled.  A cold run, then a warm run; their SAMs must be
byte-equal.  Each prints the JAX tool's dict (unrounded) with "device" and
"peak_device_gb" (torch.cuda.max_memory_allocated over the run, the
counterpart of the JAX package's device memory_stats; None on the CPU).

"Cold" is the first call in the process: on the card it pays the kernel
libraries' load (ops/_kernels.py: built already, or built now) and the
40 MB target upload (pipeline._device_ref); the warm run reuses both.
Every wall ends in a torch.cuda.synchronize() on the card.

    python tools/make_data.py bench_data
    python -m ssw_tpu_torch.tools.bench_longtarget [--reads 1000]
        [--fastq bench_data/100k_illumina1.fastq.gz]
        [--ref bench_data/10M.fa] [--device cpu]

On the card unless --device cpu (the plain versions; slow at this size).
Ref workload: the reference's README.md:66-74.
"""

from __future__ import annotations

import argparse
import gzip
import io
import os
import resource
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
N_READS = 1000


def head_fastq(fastq: str, n_reads: int, out_path: str) -> str:
    """The first n_reads records of fastq (gzip or plain) into out_path."""
    opener = gzip.open if fastq.endswith(".gz") else open
    with opener(fastq, "rt") as f:
        lines = [f.readline() for _ in range(4 * n_reads)]
    with open(out_path, "w") as f:
        f.writelines(lines)
    return out_path


def one_run(label, args, n_reads, device=None):
    """cli.main(args) under a GcupsCounter; returns (the JAX tool's dict
    with "device" and "peak_device_gb", the SAM text)."""
    import torch

    from ssw_tpu_torch import cli, pipeline, profiling

    dev = pipeline.resolve_device(device)
    counter = profiling.GcupsCounter()
    out, err = io.StringIO(), io.StringIO()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with pipeline.profiled(counter):
        rc = cli.main(list(args), out=out, err=err, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n = sum(1 for ln in out.getvalue().splitlines()
            if ln and not ln.startswith("@"))
    res = {"run": label, "rc": rc, "reads": n_reads, "records": n,
           "seconds": dt, "reads_per_s": n_reads / dt,
           "phases": dict(counter.seconds),
           "gcups_forward": counter.gcups("forward"),
           "peak_rss_gb": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss / 1e6,
           "peak_device_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                              if dev.type == "cuda" else None),
           "device": str(dev)}
    print(res, flush=True)
    return res, out.getvalue()


def run(ref: str, fastq: str, n_reads: int = N_READS, device=None):
    """Cold, then warm, on the first n_reads of fastq; asserts the SAMs
    byte-equal.  Returns ([cold dict, warm dict], the SAM text)."""
    with tempfile.TemporaryDirectory() as tmp:
        fq = head_fastq(fastq, n_reads, os.path.join(tmp, "reads.fastq"))
        args = ["-c", "-s", "-h", ref, fq]
        cold, sam_cold = one_run("cold", args, n_reads, device)
        warm, sam_warm = one_run("warm", args, n_reads, device)
    assert sam_cold == sam_warm, "the cold and warm SAMs differ"
    return [cold, warm], sam_cold


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "ssw_tpu_torch.tools.bench_longtarget")
    ap.add_argument("--reads", type=int, default=N_READS)
    ap.add_argument("--fastq", default=os.path.join(
        REPO, "bench_data", "100k_illumina1.fastq.gz"))
    ap.add_argument("--ref", default=os.path.join(REPO, "bench_data",
                                                  "10M.fa"))
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    runs, _ = run(args.ref, args.fastq, args.reads, args.device)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
