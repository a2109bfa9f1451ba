"""The north star's three metrics (BASELINE.json) as one JSON report: the
counterpart of the JAX package's tools/bench_suite.py.

  forward      forward-DP GCUPS of the JAX tool's workload: eight launches
               of 128 reads of 200 bp at L 256 against 2^20 columns (on the
               CPU 2^14 columns and two launches) through
               cuda_sw.forward_shared(..., max_sub=2), the int16 tier on
               the card (cuda_sw.i16_exact); not ssw_tpu_torch.bench's
               packed leaf
  e2e_config4  reads/s of a config-4 slice through the whole CLI (-c -s -h
               -r against tests/data/1M.fa, parsing, traceback and SAM
               included), after a 64-read warm-up
  scaling      parallel.dist.sharded_forward over make_mesh(data=s) for s
               in 1, 2, 4, 8 (the sizes the device pool holds), the same
               work at each size; each mesh's outputs must equal s = 1's

The device pool is every card of the host, each repeated --mesh-repeat
times (default 1), or with --device cpu the CPU repeated so (the JAX
tool's --fake-devices).  When the largest mesh repeats a device, its wall
cannot improve, and the report gives collective_overhead_vs_single (1.0:
no overhead) with a note, as the JAX tool does for its virtual CPU mesh;
with distinct cards it gives speedup and efficiency_vs_linear.  Every
clock on the card stops after a torch.cuda.synchronize().

    python tools/make_data.py bench_data   # for e2e_config4
    python -m ssw_tpu_torch.tools.bench_suite [--reads 2000]
        [--skip-scaling] [--skip-e2e] [--device cpu] [--mesh-repeat N]

On the card unless --device cpu (the plain versions).
"""

from __future__ import annotations

import argparse
import gzip
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FASTQ = os.path.join(REPO, "bench_data", "100k_illumina1.fastq.gz")
REF_1M = os.path.join(REPO, "tests", "data", "1M.fa")
# the forward workload's (target columns, reads): the JAX tool's sizes
FORWARD_SIZE = {"cuda": (1 << 20, 1024), "cpu": (1 << 14, 256)}
# the scaling workload's (reads, L, target columns): the JAX tool's
SCALING_SIZE = (64, 128, 4096 * 4)


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_forward_gcups(device=None) -> dict:
    import torch

    from ssw_tpu_torch import pipeline, profiling
    from ssw_tpu_torch.core.encoding import dna_matrix
    from ssw_tpu_torch.ops import common, cuda_sw

    dev = pipeline.resolve_device(device)
    R, reads_n = FORWARD_SIZE[dev.type]
    rng = np.random.default_rng(42)
    READ_LEN, B, L = 200, 128, 256
    mat_ext = common.extend_matrix(dna_matrix(2, 2))
    ref = rng.integers(0, 4, R).astype(np.int32)
    rl = np.full(B, READ_LEN, np.int32)
    geo = common.batch_geometry(rl, L, word=False)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)
    args = (t(rl), t(geo.col_mask), t(geo.seg_id), t(geo.seg_start))
    ref_d = t(ref)

    def make(seed):
        r = np.random.default_rng(seed)
        reads = [ref[o:o + READ_LEN] for o in
                 r.integers(0, R - READ_LEN, B)]
        rp = common.pad_reads([x.copy() for x in reads], L, 5)
        return t(common.build_profile(rp, rl, mat_ext))

    profs = [make(s) for s in range(1 + reads_n // B)]
    run = lambda p: cuda_sw.forward_shared(p, ref_d, *args, 3, 1, False,
                                           max_sub=2)
    int(run(profs[0])[0][0])
    n = reads_n // B
    counter = profiling.GcupsCounter()
    counter.add_pairs([READ_LEN] * reads_n, R)
    with counter.phase("device"):
        outs = [run(profs[1 + i]) for i in range(n)]
        _sync(dev)
        int(outs[-1][0][0])
    return dict(gcups=counter.gcups("device"), platform=dev.type,
                seconds=counter.device_seconds, device=str(dev))


def bench_e2e_reads_per_s(n_reads, device=None, fastq=FASTQ,
                          ref=REF_1M) -> dict:
    """Config-4 slice through the whole CLI (parsing, reverse complement,
    traceback, SAM rendering)."""
    from ssw_tpu_torch import cli, pipeline, profiling

    dev = pipeline.resolve_device(device)
    if not os.path.exists(fastq):
        return dict(skipped="bench_data missing; run tools/make_data.py")
    with tempfile.TemporaryDirectory() as tmp:
        with gzip.open(fastq, "rt") as f:
            lines = [f.readline() for _ in range(n_reads * 4)]
        path = os.path.join(tmp, "slice.fastq")
        warm_path = os.path.join(tmp, "warm.fastq")
        with open(path, "w") as f:
            f.writelines(lines)
        with open(warm_path, "w") as f:
            f.writelines(lines[:4 * 64])
        # warm-up on a small slice: the kernel libraries, the target upload
        warm = io.StringIO()
        cli.main(["-c", "-s", "-h", "-r", ref, warm_path], out=warm,
                 err=warm, device=dev)
        out, err = io.StringIO(), io.StringIO()
        counter = profiling.GcupsCounter()
        _sync(dev)
        t0 = time.perf_counter()
        with pipeline.profiled(counter):
            cli.main(["-c", "-s", "-h", "-r", ref, path], out=out, err=err,
                     device=dev)
        _sync(dev)
        dt = time.perf_counter() - t0
    n_recs = sum(1 for ln in out.getvalue().splitlines()
                 if ln and not ln.startswith("@"))
    return dict(reads=n_reads, records=n_recs, seconds=dt,
                reads_per_s=n_reads / dt,
                phases=dict(sorted(counter.seconds.items())),
                gcups_device=counter.gcups("forward"), device=str(dev))


def device_pool(device=None, mesh_repeat: int = 1) -> list:
    """Every card of the host (or the CPU with device="cpu"), each
    repeated mesh_repeat times, interleaved so that a mesh of the first s
    holds as many distinct devices as it can."""
    import torch

    from ssw_tpu_torch import pipeline

    dev = pipeline.resolve_device(device)
    if dev.type == "cpu":
        devs = [dev]
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return devs * max(1, mesh_repeat)


def bench_scaling(pool) -> dict:
    """Sharded-forward wall against mesh size (the same total work)."""
    import torch

    from ssw_tpu_torch import pipeline
    from ssw_tpu_torch.core.encoding import dna_matrix
    from ssw_tpu_torch.ops import common
    from ssw_tpu_torch.parallel import dist
    from ssw_tpu_torch.parallel import mesh as mesh_lib

    n_dev = len(pool)
    if n_dev < 2:
        return dict(skipped=f"{n_dev} device(s)")
    rng = np.random.default_rng(0)
    B, L, R = SCALING_SIZE
    mat = dna_matrix(2, 2)
    ref = rng.integers(0, 4, R).astype(np.int32)
    rl = np.full(B, 100, np.int32)
    reads = [rng.integers(0, 4, 100).astype(np.int32) for _ in range(B)]
    prof = common.build_profile(common.pad_reads(reads, L, 5), rl,
                                common.extend_matrix(mat))
    geo = common.batch_geometry(rl, L, word=False)
    halo = pipeline._window_len(100, R, mat, 3, 1)
    ref_ext = np.concatenate([np.full(halo, 5, np.int32), ref])
    mask_len = np.full(B, 50, np.int32)
    home = pool[0]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(home)
    inputs = (t(prof), t(ref_ext), t(rl), t(geo.col_mask), t(geo.seg_id),
              t(geo.seg_start))
    out, first = {}, None
    sizes = [s for s in (1, 2, 4, 8) if s <= n_dev]
    for s in sizes:
        mesh = mesh_lib.make_mesh(data=s, seq=1, devices=pool[:s])
        run = lambda: dist.sharded_forward(mesh, *inputs, 3, 1, mask_len, R,
                                           halo, False)
        run()
        _sync(home)
        t0 = time.perf_counter()
        res = run()
        _sync(home)
        out[f"data={s}"] = time.perf_counter() - t0
        got = [x.cpu() for x in res]
        first = first or got
        assert all(torch.equal(a, b) for a, b in zip(got, first)), \
            f"the outputs of the mesh of {s} differ from those of 1"
    t1 = out[f"data={sizes[0]}"]
    tn = out[f"data={sizes[-1]}"]
    if len(set(map(str, pool[:sizes[-1]]))) < sizes[-1]:
        # repeated devices share one card (or the host's cores): wall time
        # cannot improve, so the meaningful number is how much overhead
        # the sharding machinery + collectives add (1.0 = none)
        out["collective_overhead_vs_single"] = tn / t1
        what = "virtual CPU mesh" if home.type == "cpu" else \
            "one card repeated in the mesh"
        out["note"] = (f"{what}: speedup not measurable, reporting "
                       f"sharding overhead instead")
    else:
        out["speedup"] = t1 / tn
        out["efficiency_vs_linear"] = (t1 / tn) / (sizes[-1] / sizes[0])
    out["device"] = str(home)
    return out


def suite(n_reads=2000, skip_scaling=False, skip_e2e=False, device=None,
          mesh_repeat=1, fastq=FASTQ) -> dict:
    report = {"forward": bench_forward_gcups(device)}
    if not skip_e2e:
        report["e2e_config4"] = bench_e2e_reads_per_s(n_reads, device,
                                                      fastq)
    if not skip_scaling:
        report["scaling"] = bench_scaling(device_pool(device, mesh_repeat))
    return report


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "ssw_tpu_torch.tools.bench_suite")
    ap.add_argument("--reads", type=int, default=2000)
    ap.add_argument("--skip-scaling", action="store_true")
    ap.add_argument("--skip-e2e", action="store_true")
    ap.add_argument("--device", default=device,
                    help="cpu: the plain versions (default: the card)")
    ap.add_argument("--mesh-repeat", type=int, default=1,
                    help="repeat each device of the pool this many times "
                         "for the scaling benchmark")
    args = ap.parse_args(argv)
    report = suite(args.reads, args.skip_scaling, args.skip_e2e,
                   args.device, args.mesh_repeat)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
