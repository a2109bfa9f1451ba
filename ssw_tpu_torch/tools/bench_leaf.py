"""One leaf's wall and phases at the config-4 shape (2048 x 100 bp against
1 Mbp, streaming by the card's rule): the counterpart of the JAX package's
tools/bench_leaf.py, the harness for the pipeline's orchestration cost
around the forward kernel.

    python -m ssw_tpu_torch.tools.bench_leaf [R [B [read_len [reps]]]]
        [--device cpu]

The workload is sweep_boundaries.mk_workload(R, B, read_len) (default
1,048,576, 2048, 100).  Each of `reps` (default 3) calls of
pipeline.align_batch prints one dict: its wall (ending in a
torch.cuda.synchronize() on the card), reads/s, the phase seconds of
profiling.GcupsCounter and the checksum (sums of score1, score2 and
ref_end2 over the results that are not None).  The first rep pays the
kernel libraries' load and the target's upload.  On the card unless
--device cpu.
"""

from __future__ import annotations

import sys
import time

from ssw_tpu_torch.tools import _common
from ssw_tpu_torch.tools.sweep_boundaries import mk_workload, request


def checksum(out) -> tuple:
    live = [a for a in out if a is not None]
    return (int(sum(a.score1 for a in live)),
            int(sum(a.score2 for a in live)),
            int(sum(a.ref_end2 for a in live)))


def run(R=1048576, B=2048, rl=100, reps=3, device=None) -> list[dict]:
    """`reps` timed align_batch calls of the leaf; returns their dicts."""
    import torch

    from ssw_tpu_torch import pipeline, profiling
    from ssw_tpu_torch.core.encoding import dna_matrix

    dev = pipeline.resolve_device(device)
    ref, reads = mk_workload(R, B, rl)
    req = request(ref, reads, dna_matrix(2, 2))
    rows = []
    for it in range(reps):
        ctr = profiling.GcupsCounter()
        with pipeline.profiled(ctr):
            t0 = time.perf_counter()
            out = pipeline.align_batch(req, dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        row = {"rep": it, "wall_s": wall, "reads_per_s": B / wall,
               "phases": dict(sorted(ctr.seconds.items())),
               "checksum": checksum(out), "device": str(dev)}
        print(row, flush=True)
        rows.append(row)
    return rows


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = _common.device_of(argv) or device
    R = int(argv[0]) if len(argv) > 0 else 1048576
    B = int(argv[1]) if len(argv) > 1 else 2048
    rl = int(argv[2]) if len(argv) > 2 else 100
    reps = int(argv[3]) if len(argv) > 3 else 3
    run(R, B, rl, reps, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
