"""Parity spot-check of the whole pipeline on the card: the counterpart of
the JAX package's tools/spotcheck_tpu.py.

api.align_batch on the card (device=None) against the plain versions on
the CPU (device="cpu"), field by field (score1, score2, ref_begin1,
ref_end1, read_begin1, read_end1, ref_end2, cigar, flag), in the JAX
tool's five cases, from its default_rng(42) draws in its order:

  dna-default       96 reads of 30-400 bp (70 % cut from a 5000-code
                    target with 1/12 of their codes redrawn) at -m2 -x2
                    -o3 -e1: the word tier and the reverse pass
  dna-m1x3o5e2      the same reads at -m1 -x3 -o5 -e2
  dna-streaming-40k 48 reads of 30-300 bp against 40,000 columns
  dna-packed-40k    the same with pipeline.PACK_L = 1024
  protein-quirk     48 reads of 20-150 aa against 2000 aa, BLOSUM50 at
                    -o3 -e1: the lane-block quirk

then the JAX tool's sharded check: pipeline.align_batch_sharded over
parallel.mesh.make_mesh() (every card of the host, data-parallel) against
pipeline.align_batch, on the first 32 reads of the first case.

The JAX tool's streaming case meant to cross the streaming boundary, but
40,000 columns lie under both packages' STREAM_MIN_COLS, and the port's
_use_streaming does not stream there.  So the streaming and the packed
cases force pipeline.STREAM_SUBOPT = True on the card's side (and False on
the CPU's, the JAX scan backend's materialized scan), as their comments
intend; the packed case also checks, through cuda_sw.launch_counts(), that
the packed wavefront launched on the card.  Every switch is restored.

    python -m ssw_tpu_torch.tools.spotcheck_cuda [--device cpu]

Prints one line per case and "TOTAL MISMATCHES: n"; fails unless n is 0.
--device cpu runs both sides on the plain versions.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _draw(rng, ref, n_reads, lo, hi, n_codes, div):
    reads = []
    for _ in range(n_reads):
        ln = int(rng.integers(lo, hi))
        if rng.random() < 0.7:
            s = int(rng.integers(0, len(ref) - ln))
            r = ref[s:s + ln].copy()
            idx = rng.integers(0, ln, max(1, ln // div))
            r[idx] = rng.integers(0, n_codes, len(idx))
            reads.append(r)
        else:
            reads.append(rng.integers(0, n_codes, ln).astype(np.int32))
    return reads


def cases(n_reads=None) -> list[dict]:
    """The JAX tool's cases from its draws, each cut to its first n_reads
    reads (None: all): dicts of tag, reads, ref, mat, gapO, gapE and the
    switches (stream, pack_l, sharded)."""
    from ssw_tpu_torch.core.encoding import BLOSUM50, dna_matrix

    rng = np.random.default_rng(42)
    ref = rng.integers(0, 4, 5000).astype(np.int32)
    reads = _draw(rng, ref, 96, 30, 400, 4, 12)
    big = rng.integers(0, 4, 40000).astype(np.int32)
    breads = _draw(rng, big, 48, 30, 300, 4, 12)
    pref = rng.integers(0, 20, 2000).astype(np.int32)
    preads = _draw(rng, pref, 48, 20, 150, 20, 10)
    blosum = np.asarray(BLOSUM50, np.int8)
    cut = lambda r: r[:n_reads]
    base = {"stream": None, "pack_l": 0, "sharded": False}
    return [
        {**base, "tag": "dna-default", "reads": cut(reads), "ref": ref,
         "mat": dna_matrix(2, 2), "gapO": 3, "gapE": 1},
        {**base, "tag": "dna-m1x3o5e2", "reads": cut(reads), "ref": ref,
         "mat": dna_matrix(1, 3), "gapO": 5, "gapE": 2},
        {**base, "tag": "dna-streaming-40k", "reads": cut(breads),
         "ref": big, "mat": dna_matrix(2, 2), "gapO": 3, "gapE": 1,
         "stream": True},
        {**base, "tag": "dna-packed-40k", "reads": cut(breads), "ref": big,
         "mat": dna_matrix(2, 2), "gapO": 3, "gapE": 1, "stream": True,
         "pack_l": 1024},
        {**base, "tag": "protein-quirk", "reads": cut(preads), "ref": pref,
         "mat": blosum, "gapO": 3, "gapE": 1},
        {**base, "tag": "sharded-mesh", "reads": reads[:min(32, n_reads or 32)],
         "ref": ref, "mat": dna_matrix(2, 2), "gapO": 3, "gapE": 1,
         "sharded": True},
    ]


def fields(x) -> tuple:
    return (x.score1, x.score2, x.ref_begin1, x.ref_end1, x.read_begin1,
            x.read_end1, x.ref_end2, tuple(x.cigar or ()), x.flag)


def _align(case, device, stream):
    from ssw_tpu_torch import api, pipeline

    prev = pipeline.STREAM_SUBOPT, pipeline.PACK_L
    pipeline.STREAM_SUBOPT, pipeline.PACK_L = stream, case["pack_l"]
    try:
        return api.align_batch(case["reads"], case["ref"], case["mat"],
                               case["gapO"], case["gapE"], device=device)
    finally:
        pipeline.STREAM_SUBOPT, pipeline.PACK_L = prev


def check(case, device=None) -> int:
    """The case on `device` against the CPU; prints and returns the count
    of reads whose fields differ."""
    from ssw_tpu_torch import pipeline
    from ssw_tpu_torch.ops import cuda_sw

    dev = pipeline.resolve_device(device)
    tag = case["tag"]
    if case["pack_l"]:
        reads = case["reads"]
        prev = pipeline.PACK_L
        pipeline.PACK_L = case["pack_l"]
        try:
            assert pipeline._pack_rule(
                np.array([len(r) for r in reads], np.int32),
                np.zeros(len(reads), bool), len(reads), 512) is not None
        finally:
            pipeline.PACK_L = prev
    before = cuda_sw.launch_counts()
    a = _align(case, dev, case["stream"])
    launched = {k: n - before[k] for k, n in cuda_sw.launch_counts().items()
                if n != before[k]}
    b = _align(case, "cpu", False if case["stream"] else None)
    if case["pack_l"] and dev.type == "cuda":
        assert any(k.startswith("forward_shared_packed") for k in launched), \
            f"{tag}: the packed wavefront did not launch: {launched}"
    bad = 0
    for i, (x, y) in enumerate(zip(a, b)):
        fx, fy = fields(x), fields(y)
        if fx != fy:
            bad += 1
            if bad <= 3:
                print(f"  MISMATCH {tag}[{i}]: {dev.type}={fx} cpu={fy}")
    print(f"{tag}: {len(a)} pairs, {bad} mismatches", flush=True)
    return bad


def check_sharded(case, device=None) -> int:
    """align_batch_sharded over make_mesh() (on the CPU: a mesh of the CPU)
    against align_batch; returns the count of reads that differ."""
    from ssw_tpu_torch import pipeline
    from ssw_tpu_torch.parallel.mesh import make_mesh

    dev = pipeline.resolve_device(device)
    reads = case["reads"]
    req = pipeline.BatchRequest(
        reads=reads, ref=case["ref"], mat=case["mat"], gapO=case["gapO"],
        gapE=case["gapE"], flag=0x0F,
        mask_len=[max(len(r) // 2, 15) for r in reads])
    mesh = make_mesh(devices=[dev] if dev.type == "cpu" else None)
    a = pipeline.align_batch_sharded(req, mesh)
    b = pipeline.align_batch(req, dev)
    bad = sum(1 for x, y in zip(a, b) if vars(x) != vars(y))
    print(f"{case['tag']}: {len(a)} pairs, {bad} mismatches", flush=True)
    return bad


def run(device=None, n_reads=None) -> int:
    """Every case; returns the total mismatches."""
    total = 0
    for case in cases(n_reads):
        total += (check_sharded if case["sharded"] else check)(case, device)
    print("TOTAL MISMATCHES:", total, flush=True)
    return total


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "ssw_tpu_torch.tools.spotcheck_cuda")
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    total = run(args.device)
    assert total == 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
