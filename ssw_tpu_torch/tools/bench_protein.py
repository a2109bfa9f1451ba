"""Config 2 at scale, the counterpart of the JAX package's
tools/bench_protein.py: BLOSUM50 reads against a synthetic proteome, with
lane packing off and on.

The workload is the JAX tool's: seed 2024, 512 reads of 30-150 aa over
the 20 standard residues at 5 % substitutions, drawn from a random
proteome of 200,000 aa; the whole pipeline (forward, suboptimal, begins,
traceback), BLOSUM50 at -o3 -e1, so the lane-block E quirk is on
(min(mat) = -5 < -2 * gapE).  Each mode runs once to warm and once timed;
align_batch returns host results, so the timed call ends with the work.

    python -m ssw_tpu_torch.tools.bench_protein [--reads 512]
        [--proteome 200000] [--pack {0,1,both}] [--device cpu]

--pack sets pipeline.PACK (0: False, never pack; 1: True, the JAX
package's planner) in place of the JAX tool's SSW_TPU_PACK.  At 200,000
columns the leaves do not stream by the port's rule, and the port packs
only streaming leaves, so both modes run the same kernels unless the
caller forces pipeline.STREAM_SUBOPT.  On the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

N_AA = 20  # reads over the 20 standard residues (codes 0..19)


def workload(n_reads: int = 512, proteome: int = 200_000, seed: int = 2024):
    """(reads, proteome codes, BLOSUM50) as the JAX tool draws them."""
    from ssw_tpu_torch.core.encoding import BLOSUM50

    rng = np.random.default_rng(seed)
    ref = rng.integers(0, N_AA, proteome).astype(np.int32)
    reads = []
    for _ in range(n_reads):
        ln = int(rng.integers(30, 151))
        off = int(rng.integers(0, proteome - ln))
        rd = ref[off:off + ln].copy()
        m = rng.random(ln) < 0.05
        rd[m] = rng.integers(0, N_AA, int(m.sum()))
        reads.append(rd.astype(np.int32))
    return reads, ref, np.asarray(BLOSUM50, np.int8)


def run(reads, ref, mat, pack: bool | None, device=None):
    """One pipeline.align_batch with pipeline.PACK = pack (None: the card's
    rule); returns (the AlignResults, wall seconds)."""
    import torch

    from ssw_tpu_torch import pipeline

    dev = pipeline.resolve_device(device)
    req = pipeline.BatchRequest(
        reads=reads, ref=ref, mat=mat, gapO=3, gapE=1, flag=0x0F,
        mask_len=[max(len(r) // 2, 15) for r in reads])
    prev, pipeline.PACK = pipeline.PACK, pack
    try:
        t0 = time.perf_counter()
        out = pipeline.align_batch(req, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        pipeline.PACK = prev
    return out, wall


def summary(pack: bool | None, reads, proteome: int, outs,
            wall: float) -> dict:
    """The JAX tool's dict for one mode (unrounded)."""
    cells = float(sum(len(r) for r in reads)) * proteome
    return {
        "pack": None if pack is None else int(pack),
        "reads": len(reads),
        "proteome": proteome,
        "wall_s": wall,
        "reads_per_s": len(reads) / wall,
        "gcups": cells / wall / 1e9,
        "score_sum": int(sum(a.score1 for a in outs)),
        "cigar_sum": int(sum(len(a.cigar or []) for a in outs)),
    }


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "ssw_tpu_torch.tools.bench_protein")
    ap.add_argument("--reads", type=int, default=512)
    ap.add_argument("--proteome", type=int, default=200000)
    ap.add_argument("--pack", default="both", choices=("0", "1", "both"))
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    reads, ref, mat = workload(args.reads, args.proteome)
    modes = {"0": (False,), "1": (True,), "both": (False, True)}[args.pack]
    for pack in modes:
        run(reads, ref, mat, pack, args.device)               # warm
        outs, wall = run(reads, ref, mat, pack, args.device)  # timed
        print(summary(pack, reads, args.proteome, outs, wall), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
