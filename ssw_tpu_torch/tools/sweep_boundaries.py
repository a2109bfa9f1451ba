"""The pipeline's two decision boundaries, measured: the counterpart of the
JAX package's tools/sweep_boundaries.py.

  stream  streaming against the materialized suboptimal scan, over target
          lengths R of 16,384 to 1,048,576 columns (pipeline.STREAM_SUBOPT
          False, then True, in place of SSW_TPU_STREAM_SUBOPT)
  packw   the pack width: pipeline.PACK_L 0 (the rule's choice), 1024,
          2048 and 4096, with streaming forced, at 100, 150 and 200 bp

Each setting runs pipeline.align_batch twice on the same inputs; the second
call is the warm number (align_batch returns host results, so its wall
ends with the work; on the card the clock also stops after a
torch.cuda.synchronize()).  Every setting's checksum (the sums of score1
and score2) must equal the others' at the same shape.  The tool measures
and records: it changes no rule of the pipeline (_pack_rule, DUAL,
STREAM_MIN_COLS).  The switches it sets are restored when it returns.

    python -m ssw_tpu_torch.tools.sweep_boundaries [stream|packw]
        [--device cpu]

On the card unless --device cpu (the plain versions; slow at these sizes).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

# (R, B) of the stream sweep; (R, B, read lengths, widths) of packw
STREAM_SIZES = ((16384, 2048), (32768, 2048), (131072, 2048),
                (1048576, 1024))
PACKW_R, PACKW_B = 1048576, 2048
PACKW_READ_LENS = (100, 150, 200)
PACKW_WIDTHS = (0, 1024, 2048, 4096)


def mk_workload(R, B, read_len, seed=11):
    """The JAX tool's workload, byte for byte: a random target of R codes
    and B reads, the even ones cut from it with 4 % of their codes redrawn,
    the odd ones random."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, R).astype(np.int32)
    reads = []
    for i in range(B):
        if i % 2 == 0:
            off = int(rng.integers(0, R - read_len))
            rd = ref[off:off + read_len].copy()
            m = rng.random(read_len) < 0.04
            rd[m] = rng.integers(0, 4, int(m.sum()))
        else:
            rd = rng.integers(0, 4, read_len)
        reads.append(rd.astype(np.int32))
    return ref, reads


def request(ref, reads, mat):
    from ssw_tpu_torch import pipeline

    return pipeline.BatchRequest(
        reads=reads, ref=ref, mat=mat, gapO=3, gapE=1, flag=0x0F,
        mask_len=[max(len(r) // 2, 15) for r in reads])


def run_once(ref, reads, mat, device):
    """One pipeline.align_batch; returns (wall seconds, AlignResults)."""
    import torch

    from ssw_tpu_torch import pipeline

    dev = pipeline.resolve_device(device)
    req = request(ref, reads, mat)
    t0 = time.perf_counter()
    out = pipeline.align_batch(req, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0, out


def checksum(out) -> tuple:
    return (int(sum(a.score1 for a in out)), int(sum(a.score2 for a in out)))


def timed(ref, reads, mat, label, device) -> dict:
    """The warm call's dict, after a first, same-shape call."""
    from ssw_tpu_torch import pipeline

    dev = pipeline.resolve_device(device)
    run_once(ref, reads, mat, dev)                 # build, upload
    wall, out = run_once(ref, reads, mat, dev)     # warm
    res = {"cfg": label, "warm_s": wall, "reads_per_s": len(reads) / wall,
           "checksum": checksum(out), "device": str(dev)}
    print(res, flush=True)
    return res


def sweep_stream(device=None, sizes=STREAM_SIZES, read_len=100):
    """R x STREAM_SUBOPT {False, True}; returns the rows."""
    from ssw_tpu_torch import pipeline
    from ssw_tpu_torch.core.encoding import dna_matrix

    mat = dna_matrix(2, 2)
    rows = []
    prev = pipeline.STREAM_SUBOPT
    try:
        for R, B in sizes:
            ref, reads = mk_workload(R, B, read_len)
            row = {}
            for s in (False, True):
                pipeline.STREAM_SUBOPT = s
                row[s] = timed(ref, reads, mat, f"R={R} stream={int(s)}",
                               device)
                rows.append(row[s])
            assert row[False]["checksum"] == row[True]["checksum"], \
                f"mismatch at R={R}"
            print({"R": R, "stream_speedup": row[False]["warm_s"]
                   / row[True]["warm_s"]}, flush=True)
    finally:
        pipeline.STREAM_SUBOPT = prev
    return rows


def sweep_packw(device=None, R=PACKW_R, B=PACKW_B,
                read_lens=PACKW_READ_LENS, widths=PACKW_WIDTHS):
    """read length x PACK_L with streaming forced; returns the rows."""
    from ssw_tpu_torch import pipeline
    from ssw_tpu_torch.core.encoding import dna_matrix

    mat = dna_matrix(2, 2)
    rows = []
    prev = pipeline.STREAM_SUBOPT, pipeline.PACK_L
    pipeline.STREAM_SUBOPT = True
    try:
        for rl in read_lens:
            ref, reads = mk_workload(R, B, rl)
            base = None
            for w in widths:
                pipeline.PACK_L = w
                res = timed(ref, reads, mat, f"rl={rl} packL={w or 'auto'}",
                            device)
                rows.append(res)
                base = base or res["checksum"]
                assert res["checksum"] == base, f"mismatch rl={rl} w={w}"
    finally:
        pipeline.STREAM_SUBOPT, pipeline.PACK_L = prev
    return rows


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "ssw_tpu_torch.tools.sweep_boundaries")
    ap.add_argument("mode", nargs="?", default="stream",
                    choices=("stream", "packw"))
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    (sweep_stream if args.mode == "stream" else sweep_packw)(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
