"""One reproducible config-4 FULL run, the counterpart of the JAX package's
tools/run_config4_full.py.

The full BASELINE config-4 workload: 100,000 Illumina-like 100 bp reads,
both strands, the whole pipeline (`-c -s -h -r`) against tests/data/1M.fa,
under pipeline.profiled, with inclusive accounting (FASTQ parse, every
phase and the SAM rendering inside the wall) and the SHA-256 of the SAM
body, so that byte-stability against the JAX package and across code
versions is one string comparison.

    python tools/make_data.py bench_data   # writes 100k_illumina1.fastq.gz
    python -m ssw_tpu_torch.tools.run_config4_full [--reads N]
        [--fastq bench_data/100k_illumina1.fastq.gz] [--ref tests/data/1M.fa]
        [--device cpu]

--reads N below 100,000 runs the first N reads (slice mode, as the JAX
tool's SSW_TPU_FULLRUN_READS).  The run is on the card and raises without
one; --device cpu runs the plain versions (slow at full size).
Ref workload: the reference's src/main.c:462-535 and its README benchmark.
"""

from __future__ import annotations

import argparse
import gzip
import hashlib
import io
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FULL_READS = 100_000


def sam_body(sam: str) -> str:
    """The SAM's records without its @ header lines."""
    return "".join(ln for ln in sam.splitlines(keepends=True)
                   if not ln.startswith("@"))


def run(ref: str, fq: str, n_reads: int = FULL_READS, device=None):
    """cli.main(["-c", "-s", "-h", "-r", ref, fq]) under a GcupsCounter;
    with n_reads below FULL_READS, on the first n_reads records of fq.
    Returns (the JAX tool's dict, unrounded, with "device" added; the SAM
    text)."""
    import torch

    from ssw_tpu_torch import cli, pipeline, profiling

    dev = pipeline.resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        if n_reads != FULL_READS:
            opener = gzip.open if fq.endswith(".gz") else open
            with opener(fq, "rt") as f:
                lines = [f.readline() for _ in range(4 * n_reads)]
            fq = os.path.join(tmp, "slice.fastq")
            with open(fq, "w") as f:
                f.writelines(lines)
        counter = profiling.GcupsCounter()
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with pipeline.profiled(counter):
            rc = cli.main(["-c", "-s", "-h", "-r", ref, fq], out=out,
                          err=err, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    sam = out.getvalue()
    return {
        "rc": rc,
        "reads": n_reads,
        "wall_s": wall,
        "reads_per_s_inclusive": n_reads / wall,
        "phases_s": dict(counter.seconds),
        "gcups_forward": counter.gcups("forward"),
        "sam_bytes": len(sam),
        "sam_body_sha256": hashlib.sha256(sam_body(sam).encode()).hexdigest(),
        "device": str(dev),
    }, sam


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "ssw_tpu_torch.tools.run_config4_full")
    ap.add_argument("--reads", type=int, default=FULL_READS)
    ap.add_argument("--fastq", default=os.path.join(
        REPO, "bench_data", "100k_illumina1.fastq.gz"))
    ap.add_argument("--ref", default=os.path.join(REPO, "tests", "data",
                                                  "1M.fa"))
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    res, _ = run(args.ref, args.fastq, args.reads, args.device)
    print(res, flush=True)
    return 0 if res["rc"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
