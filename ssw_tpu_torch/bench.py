"""Benchmark: forward-DP throughput (GCUPS) on one card, the counterpart of
the JAX package's root bench.py.

    python -m ssw_tpu_torch.bench               # the card; raises without one
    python -m ssw_tpu_torch.bench --device cpu  # the plain versions, R = 2^14

The workload is bench.py's: rng 42, a random DNA target of R = 2^20
columns (2^14 with --device cpu), 1024 reads of 200 bp drawn from it at 5 %
substitutions (seeds 0 and 1, as bench.py's make_packed draws them),
m2/x2/o3/e1, max_sub 2, the L = 256 bucket, and
GcupsCounter.add_pairs([200] * 1024, R).  The reference C library
sustains about 1.1 GCUPS on one CPU core (9.9e11 cells in about 880 s),
the vs_baseline denominator.

The kernel runs the way the port's pipeline runs such a leaf on the card,
through the pipeline's own helpers: pipeline._use_streaming(2^20, 256)
streams it (block maxima over the target's columns, valid_len = R);
score_size 2 (the request's default) with the quirk off and 200 bp at +2
that might reach 255 with the bias takes the dual tier
(pipeline._might_overflow, pipeline._dual_tier), whose one pass emits the
byte-tier and the word-tier block maxima; pipeline._pack_rule packs it
(PACK = None: 1024-lane rows of four 208-lane slots) and pipeline._gate
gates nothing (GATE = None).  So the timed call is one
cuda_sw.forward_shared_packed launch in dual mode
(pipeline._packed_forward), the anti-diagonal wavefront of
csrc/sw_wave_packed.cu.  bench.py times the blockmax mode instead; the
dual mode adds the word channel's max per lane-cell.  The --device cpu run
makes the same call on the plain version at bench.py's CPU size.

One warm call on seed 0's reads, then one timed call on seed 1's reads
inside counter.phase("device"), ending in torch.cuda.synchronize(): its
GCUPS is the last line, bench.py's, letter for letter in its keys:

  {"metric": "GCUPS", "value": N, "unit": "GCUPS", "vs_baseline": N/1.1}

Earlier lines give the card's name and power limit, the launch counts, the
median of TIMED_CALLS more calls by CUDA events and the kernel's bound at
the card's integer rate.  There is no fallback: a failing build or launch
raises, the process exits non-zero and prints no line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ssw_tpu_torch import pipeline, profiling
from ssw_tpu_torch.core.encoding import dna_matrix, matrix_bias
from ssw_tpu_torch.ops import common, cuda_sw
from ssw_tpu_torch.tools import _common

READS, READ_LEN, L = 1024, 200, 256
CARD_R, CPU_R = 1 << 20, 1 << 14
GAP_O, GAP_E, MAX_SUB = 3, 1, 2
SCORE_SIZE = 2         # pipeline.BatchRequest's default
BASELINE_GCUPS = 1.1   # the reference C library on one CPU core
TIMED_CALLS = 5        # card only: the median of these, beside the line


def make_target(R: int, seed: int = 42) -> np.ndarray:
    """bench.py's random DNA target (its rng 42 draws nothing before)."""
    return np.random.default_rng(seed).integers(0, 4, R).astype(np.int32)


def make_reads(ref: np.ndarray, seed: int, n_reads: int,
               read_len: int = READ_LEN) -> list[np.ndarray]:
    """bench.py's make_packed draw: each read a window of the target at a
    uniform offset with 5 % substitutions."""
    r = np.random.default_rng(seed)
    R = len(ref)
    reads = []
    for _ in range(n_reads):
        off = int(r.integers(0, R - read_len))
        rd = ref[off:off + read_len].copy()
        m = r.random(read_len) < 0.05
        rd[m] = r.integers(0, 4, int(m.sum()))
        reads.append(rd)
    return reads


class Leaf:
    """The timed call's fixed inputs on `device` (target, substitution
    matrix, tier and pack plan) for n_reads reads of read_len, a multiple
    of 64 as the pipeline pads its batch for the pack rule, and the call
    itself through the pipeline's packed helpers."""

    def __init__(self, ref: np.ndarray, n_reads: int, read_len: int,
                 device):
        if n_reads % 64:
            raise ValueError("the bench's leaf packs a multiple of 64 reads")
        if not pipeline._use_streaming(CARD_R, L):
            raise RuntimeError("pipeline._use_streaming no longer streams "
                               "the bench's leaf; the bench times the "
                               "streaming packed launch")
        device = torch.device(device)
        mat = dna_matrix(2, 2)
        self.R = len(ref)
        self.read_len = np.full(n_reads, read_len, np.int32)
        self.quirk = pipeline.needs_quirk(mat, GAP_E)
        might = pipeline._might_overflow(self.read_len, SCORE_SIZE,
                                         self.quirk, MAX_SUB,
                                         matrix_bias(mat))
        self.dual = pipeline._dual_tier(might, True)
        col_word = np.zeros(n_reads, bool) if self.dual else might
        self.plan = pipeline._pack_rule(self.read_len, col_word, n_reads, L)
        if self.plan is None:
            raise RuntimeError("pipeline._pack_rule made no plan for the "
                               "bench's leaf")
        self.ref_d = pipeline._to(device, ref)
        self.mat_ext = pipeline._to(device, common.extend_matrix(mat),
                                    torch.int8)

    def inputs(self, reads: list[np.ndarray]):
        """(packed profile (rows, 6, W) int8, slot tables) of the reads, as
        the pipeline builds them."""
        return pipeline._packed_inputs(
            self.plan, common.pad_reads(reads, L, 5), self.read_len,
            len(reads), 5, self.mat_ext)

    def call(self, inputs, ref=None, valid_len=None):
        """The timed call on the target (or `ref`, with valid_len): score,
        end_ref, end_read (B,) and block maxima (B, ceil(R/256)), or (B, 2,
        ceil(R/256)) in the dual tier, int32."""
        pprof, tables = inputs
        return pipeline._packed_forward(
            self.plan, pprof, self.ref_d if ref is None else ref, tables,
            GAP_O, GAP_E, MAX_SUB, self.R if valid_len is None else valid_len,
            self.quirk, SCORE_SIZE == 1, self.dual)

    def bound_ms(self, int32_rate: float) -> float:
        """The least time for the call's work on the card: its operations
        (cuda_sw.packed_ops) at int32_rate op/s; its bytes (about 2 MB) are
        far below the operations' time."""
        return cuda_sw.packed_ops(self.plan.slot_len, self.read_len, self.R,
                                  self.quirk, self.dual) / int32_rate * 1e3


def result_line(gcups: float) -> dict:
    """bench.py's last line."""
    return {"metric": "GCUPS", "value": round(gcups, 2), "unit": "GCUPS",
            "vs_baseline": round(gcups / BASELINE_GCUPS, 2)}


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ssw_tpu_torch.bench")
    ap.add_argument("--device", default=device)
    dev = pipeline.resolve_device(ap.parse_args(argv).device)
    on_card = dev.type == "cuda"
    R = CARD_R if on_card else CPU_R
    ref = make_target(R)
    leaf = Leaf(ref, READS, READ_LEN, dev)
    inputs = [leaf.inputs(make_reads(ref, s, READS)) for s in range(2)]
    counter = profiling.GcupsCounter()
    counter.add_pairs([READ_LEN] * READS, R)

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cuda_sw.reset_launches()
    leaf.call(inputs[0])
    sync()
    with counter.phase("device"):
        leaf.call(inputs[1])
        sync()
    gcups = counter.gcups("device")
    info = {"device": str(dev), "R": R, "reads": READS, "L": L,
            "rows": int(inputs[1][0].shape[0]), "W": leaf.plan.L,
            "slots": leaf.plan.S, "dual": leaf.dual, "cells": counter.cells,
            "timed_call_ms": counter.seconds["device"] * 1e3}
    if on_card:
        ms = sorted(_common.time_ms(lambda: leaf.call(inputs[1]), 1,
                                    warm=False)
                    for _ in range(TIMED_CALLS))
        info.update(card=torch.cuda.get_device_name(dev),
                    nvidia_smi=_common.card_line(),
                    median_ms=ms[len(ms) // 2], calls_ms=ms,
                    bound_ms=leaf.bound_ms(_common.int32_rate(dev)),
                    launches=cuda_sw.launch_counts(),
                    libraries=cuda_sw.library_counts())
    print(json.dumps(info), flush=True)
    print(json.dumps(result_line(gcups)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
