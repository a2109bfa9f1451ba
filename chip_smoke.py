#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ssw_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card

Phases (any failure exits non-zero before the final line):
  1. device: fails without CUDA; prints the card's name and power limit
  2. build: the CUDA kernels from ssw_tpu_torch/csrc (nvcc, sm_90a) and the
     host C++ library, timed as set-up
  3. kernels vs their plain PyTorch versions on the card, exact equality
     (integer DP: tolerance 0) over DNA/protein penalties, byte/word
     geometry, L buckets 64..512 (+ generic-variant widths), ragged B and R,
     the int16 tier of forward_shared, terminate and emit_maxcol
  4. the ssw_test main path (ssw_tpu_torch.cli.main) on the card, byte-equal
     to the reference-binary captures in tests/golden (configs 1-3)
  5. config 4 at real size: >= 8192 Illumina-like 100 bp reads sampled from
     tests/data/1M.fa, -c -s -h -r; reads/s, GCUPS, peak device memory and
     the share of reads whose begin is the sampled position.  Launch counts
     are set to 0 before phase 4 and read after phase 5: configs 1-4 are the
     main path, and each kernel must have run in it.
  6. kernel timing at the largest shapes phases 4-5 gave each kernel, beside
     the plain version and the integer-ALU bound; prints the
     {"kernels": [...]} line

The last line of stdout is {"ok": true, "device": {...}}.  Imports nothing
of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
GOLD = os.path.join(ROOT, "tests", "golden")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
INT32_LANES_PER_SM = 64     # INT32 lanes per SM per clock (Hopper white paper)
CONFIG4_READS = 8192        # BASELINE config 4 cut from 100k reads (depth)
SLICE_COLS = 32768          # target columns of the forward kernel's timed
                            # slice, short enough for its plain version


class SmokeFailure(Exception):
    pass


def log(msg: str):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi(query: str, fmt: str = "csv,noheader") -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        f"--format={fmt}"],
                       capture_output=True, text=True, timeout=60)
    lines = r.stdout.strip().splitlines()
    return lines[0] if r.returncode == 0 and lines else ""


# --------------------------------------------------------------------- inputs

def dna_mat(match, mismatch):
    mat = np.zeros((5, 5), np.int8)
    for i in range(4):
        for j in range(4):
            mat[i, j] = match if i == j else -mismatch
    return mat


def make_shared(torch, common, dev, *, B, L, R, mat, word, seed):
    """Random reads (some embedded in the target) and their geometry."""
    rng = np.random.default_rng(seed)
    n = mat.shape[0]
    ref = rng.integers(0, n - 1, R).astype(np.int32)
    lo = max(L // 3, 2)
    read_len = rng.integers(lo, max(lo + 1, L - 16), B).astype(np.int32)
    reads = []
    for b, ln in enumerate(read_len):
        if b % 2 and R > ln:
            s = int(rng.integers(0, R - ln))
            r = ref[s:s + ln].copy()
            m = rng.random(ln) < 0.05
            r[m] = rng.integers(0, n - 1, int(m.sum()))
        else:
            r = rng.integers(0, n - 1, ln).astype(np.int32)
        reads.append(r)
    rp = common.pad_reads(reads, L, n)
    prof = common.build_profile(rp, read_len, common.extend_matrix(mat))
    geo = common.batch_geometry(read_len, L, word=word)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)
    return (t(prof), t(ref), t(read_len), t(geo.col_mask), t(geo.seg_id),
            t(geo.seg_start)), reads, ref


def make_perread(torch, common, dev, *, B, L, W, mat, word, seed):
    rng = np.random.default_rng(seed)
    n = mat.shape[0]
    read_len = rng.integers(max(L // 3, 2), max(L // 3 + 1, L - 16),
                            B).astype(np.int32)
    reads = [rng.integers(0, n - 1, l).astype(np.int32) for l in read_len]
    refw = np.full((B, W), n, np.int32)
    for b in range(B):
        w = int(rng.integers(W // 2, W))
        refw[b, :w] = rng.integers(0, n - 1, w)
        s = int(rng.integers(0, max(1, w - read_len[b])))
        take = min(int(read_len[b]), w - s)
        refw[b, s:s + take] = reads[b][:take]
    rp = common.pad_reads(reads, L, n)
    prof = common.build_profile(rp, read_len, common.extend_matrix(mat))
    geo = common.batch_geometry(read_len, L, word=word)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)
    return (t(prof), t(refw), t(read_len), t(geo.col_mask), t(geo.seg_id),
            t(geo.seg_start))


def max_abs_diff(torch, got, want):
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"shape/dtype {tuple(g.shape)}/{g.dtype} vs "
              f"{tuple(w.shape)}/{w.dtype}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


# ------------------------------------------------------------------- phase 3

def phase_kernels(torch, dev):
    from ssw_tpu_torch.core.encoding import BLOSUM50
    from ssw_tpu_torch.ops import common, cuda_sw, scan_sw

    cases = []  # (label, kernel, kwargs)
    Ls = (64, 128, 192, 256, 320, 384, 448, 512, 96, 1088)
    for i, L in enumerate(Ls):
        for mat, gO, gE, quirk, word in (
                (dna_mat(2, 2), 3, 1, False, False),
                (dna_mat(1, 3), 5, 2, False, True),
                (BLOSUM50, 3, 1, True, i % 2 == 0)):
            cases.append((f"shared L={L} gapO={gO} gapE={gE} quirk={quirk} "
                          f"word={word}", "shared",
                          dict(B=37 + i, L=L, R=700 + 13 * i, mat=mat,
                               word=word, gO=gO, gE=gE, quirk=quirk,
                               seed=100 + i)))
    for j, (mat, gO, gE, quirk, word, term, emit) in enumerate((
            (dna_mat(2, 2), 3, 1, False, False, False, False),
            (dna_mat(2, 2), 3, 1, False, True, True, False),
            (dna_mat(1, 3), 5, 2, False, False, True, True),
            (BLOSUM50, 3, 1, True, False, False, True),
            (BLOSUM50, 3, 1, True, False, True, False),
            (dna_mat(2, 2), 3, 1, False, False, True, True))):
        L = (128, 256, 64, 128, 192, 1088)[j]
        cases.append((f"perread L={L} gapO={gO} gapE={gE} quirk={quirk} "
                      f"word={word} terminate={term} emit_maxcol={emit}",
                      "perread",
                      dict(B=29 + j, L=L, W=200 + 7 * j, mat=mat, word=word,
                           gO=gO, gE=gE, quirk=quirk, term=term, emit=emit,
                           seed=300 + j)))
    worst = {name: 0 for name in cuda_sw.LAUNCHES}
    for label, kind, kw in cases:
        if kind == "shared":
            args, _, _ = make_shared(torch, common, dev, B=kw["B"], L=kw["L"],
                                     R=kw["R"], mat=kw["mat"],
                                     word=kw["word"], seed=kw["seed"])
            want = scan_sw.forward_shared_ref(*args, kw["gO"], kw["gE"],
                                              kw["quirk"])
            max_sub = int(np.abs(kw["mat"]).max())
            if cuda_sw.i16_exact(kw["L"], kw["gO"], kw["gE"], max_sub,
                                 kw["quirk"]):
                got = cuda_sw.forward_shared(*args, kw["gO"], kw["gE"],
                                             kw["quirk"], max_sub=max_sub)
                torch.cuda.synchronize()
                err = max_abs_diff(torch, got, want)
                worst["forward_shared_i16"] = max(
                    worst["forward_shared_i16"], err)
                log(f"  {label} int16 tier: max_abs_err {err}")
                check(err == 0, f"{label} int16 tier: kernel != plain "
                      f"(max_abs_err {err})")
            got = cuda_sw.forward_shared(*args, kw["gO"], kw["gE"],
                                         kw["quirk"])
            name = "forward_shared"
        else:
            args = make_perread(torch, common, dev, B=kw["B"], L=kw["L"],
                                W=kw["W"], mat=kw["mat"], word=kw["word"],
                                seed=kw["seed"])
            term = None
            if kw["term"]:
                base = scan_sw.forward_perread_ref(*args, kw["gO"], kw["gE"],
                                                   kw["quirk"])
                t = base[0].clone()
                t[::2] = -1
                term = t.contiguous()
            got = cuda_sw.forward_perread(*args, kw["gO"], kw["gE"],
                                          kw["quirk"], terminate=term,
                                          emit_maxcol=kw["emit"])
            want = scan_sw.forward_perread_ref(*args, kw["gO"], kw["gE"],
                                               kw["quirk"], terminate=term,
                                               emit_maxcol=kw["emit"])
            name = "forward_perread"
        torch.cuda.synchronize()
        err = max_abs_diff(torch, got, want)
        worst[name] = max(worst[name], err)
        log(f"  {label}: max_abs_err {err}")
        check(err == 0, f"{label}: kernel != plain (max_abs_err {err})")
    # main-path shape: 256 sampled 100 bp reads vs the first 32768 columns
    # of 1M.fa
    seq = load_genome()
    codes = encode_dna(seq)
    rng = np.random.default_rng(2024)
    R = 32768
    reads = []
    for _ in range(256):
        s = int(rng.integers(0, R - 100))
        reads.append(codes[s:s + 100].copy())
    read_len = np.full(256, 100, np.int32)
    L = common.bucket_size(common.pad_total(100, False), 64)
    rp = common.pad_reads(reads, L, 4)
    mat = dna_mat(2, 2)
    prof = common.build_profile(rp, read_len, common.extend_matrix(mat))
    geo = common.batch_geometry(read_len, L, word=False)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)
    args = (t(prof), t(codes[:R].astype(np.int32)), t(read_len),
            t(geo.col_mask), t(geo.seg_id), t(geo.seg_start))
    want = scan_sw.forward_shared_ref(*args, 3, 1, False)
    for name, max_sub in (("forward_shared", None),
                          ("forward_shared_i16", 2)):
        got = cuda_sw.forward_shared(*args, 3, 1, False, max_sub=max_sub)
        torch.cuda.synchronize()
        err = max_abs_diff(torch, got, want)
        worst[name] = max(worst[name], err)
        log(f"  {name} 256 x 100 bp vs 1M.fa[:32768]: max_abs_err {err}")
        check(err == 0, f"main-shape {name} != plain")
    return worst


# ------------------------------------------------------------------- phase 4

GOLDEN_CASES = [
    (["-c", "-p", "pRef.fa", "pRead.fa"], "g_prot_blast.txt"),
    (["-c", "target.fastq", "query.fastq"], "g_fq_blast.txt"),
    (["-c", "-s", "-h", "r1.fa", "r1_query.fq"], "g_r1_sam.txt"),
    (["-c", "-s", "-h", "-r", "10k.fa", "54mer_hap1_1.100.fa"],
     "g_54fa_10k_sam.txt"),
    (["-c", "-r", "1k.fa", "54mer_hap1_1.100.fastq"], "g_54_1k_blast.txt"),
    (["-m", "1", "-x", "3", "-o", "5", "-e", "2", "-c", "-s", "-h", "10k.fa",
      "54mer_hap1_1.100.fastq"], "g_54_10k_m1x3o5e2.txt"),
    (["1k.fa", "test.seq", "-c"], "g_testseq_blast.txt"),
    (["-c", "-s", "-h", "-r", "100k.fa", "54mer_hap1_1.100.fastq"],
     "g_54mer_100k_sam.txt"),
]


def run_cli(cli, args, dev):
    out, err = io.StringIO(), io.StringIO()
    rc = cli.main(args, out=out, err=err, device=dev)
    return rc, out.getvalue(), err.getvalue()


def phase_golden(dev, scratch):
    from ssw_tpu_torch import cli

    def path(a):
        return os.path.join(DATA, a) if a.endswith(
            (".fa", ".fastq", ".fq", ".seq")) else a

    for args, gold in GOLDEN_CASES:
        t0 = time.perf_counter()
        rc, out, _ = run_cli(cli, [path(a) for a in args], dev)
        with open(os.path.join(GOLD, gold)) as f:
            same = out == f.read()
        log(f"  {gold}: rc {rc} byte-equal {same} "
            f"({time.perf_counter() - t0:.2f} s)")
        check(rc == 0 and same, f"golden {gold} differs")
    rc, out, _ = run_cli(cli, [path("-c"), path("target2.fa"),
                               path("query2.fa")], dev)
    check(rc == 0 and out == "", "headerless target2.fa produced output")
    log("  target2.fa (headerless): no records, as the reference")
    # BASELINE config 2: BLOSUM62 matrix file, from a controlled cwd with
    # the uppercase names the capture was taken with (see cli.parse_args)
    d = os.path.join(scratch, "b62")
    os.makedirs(d, exist_ok=True)
    for src, dst in (("blosum62.txt", "B62.TXT"), ("protein1.fa",
                     "PROTEIN1.FA"), ("protein2.fa", "PROTEIN2.FA")):
        shutil.copy(os.path.join(DATA, src), os.path.join(d, dst))
    cwd = os.getcwd()
    os.chdir(d)
    try:
        rc, out, _ = run_cli(cli, ["-p", "-a", "B62.TXT", "-c",
                                   "PROTEIN2.FA", "PROTEIN1.FA"], dev)
    finally:
        os.chdir(cwd)
    with open(os.path.join(GOLD, "g_prot_b62_blast.txt")) as f:
        same = out == f.read()
    log(f"  g_prot_b62_blast.txt (BLOSUM62 file): rc {rc} byte-equal {same}")
    check(rc == 0 and same, "golden g_prot_b62_blast.txt differs")


# ------------------------------------------------------------------- phase 5

def load_genome() -> bytes:
    seq = []
    with open(os.path.join(DATA, "1M.fa"), "rb") as f:
        for line in f:
            if not line.startswith(b">"):
                seq.append(line.strip())
    return b"".join(seq)


def encode_dna(seq: bytes) -> np.ndarray:
    table = np.full(256, 4, np.int8)
    for i, ch in enumerate(b"ACGT"):
        table[ch] = i
        table[ord(chr(ch).lower())] = i
    return table[np.frombuffer(seq, np.uint8)]


def sample_reads(path, n_reads, seed, read_len=100, err=0.005):
    """Illumina-like FASTQ sampled from 1M.fa: N-free windows, 0.5 %
    substitutions, half reverse-complemented, Q-ramp qualities.  Returns
    {name: 0-based window start}."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    g = np.frombuffer(load_genome(), np.uint8)
    run = np.cumsum(np.isin(g, bases).astype(np.int64))
    win = run[read_len - 1:] - np.concatenate(([0], run[:-read_len]))
    positions = np.nonzero(win == read_len)[0]
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    qual = np.full(read_len, ord("I"), np.uint8)
    qual[-read_len // 5:] = ord("?")
    rng = np.random.default_rng(seed)
    pos = rng.choice(positions, size=n_reads)
    do_rc = rng.random(n_reads) < 0.5
    truth = {}
    with open(path, "wb") as f:
        for i in range(n_reads):
            rd = g[pos[i]:pos[i] + read_len].copy()
            m = rng.random(read_len) < err
            if m.any():
                rd[m] = rng.choice(bases, size=int(m.sum()))
            if do_rc[i]:
                rd = comp[rd][::-1]
            name = f"sim_{i}_{pos[i]}_{'r' if do_rc[i] else 'f'}"
            truth[name] = int(pos[i])
            f.write(b"@" + name.encode() + b"\n" + rd.tobytes() + b"\n+\n"
                    + qual.tobytes() + b"\n")
    return truth


class Recorder:
    """Wraps a kernel wrapper to keep the inputs of its largest call per
    kernel: name_of(args, kwargs) says which kernel a call launches."""

    def __init__(self, fn, name_of):
        self.fn, self.name_of, self.calls = fn, name_of, {}

    def __call__(self, *args, **kwargs):
        name = self.name_of(args, kwargs)
        size = args[0].shape[0] * args[1].numel()
        if size > self.calls.get(name, (-1,))[0]:
            self.calls[name] = (size, args, kwargs)
        return self.fn(*args, **kwargs)


def record_main_path(cuda_sw):
    """Install recorders on the kernel wrappers; returns {kernel: (args,
    kwargs) of its largest call} filled as the main path runs, and a
    function that removes them."""
    def shared_name(args, kwargs):
        prof, gapO, gapE, quirk = args[0], args[6], args[7], args[8]
        return ("forward_shared_i16" if cuda_sw.i16_exact(
            int(prof.shape[2]), gapO, gapE, kwargs.get("max_sub"), quirk)
            else "forward_shared")

    recs = (Recorder(cuda_sw.forward_shared, shared_name),
            Recorder(cuda_sw.forward_perread,
                     lambda args, kwargs: "forward_perread"))
    cuda_sw.forward_shared, cuda_sw.forward_perread = recs

    def restore():
        cuda_sw.forward_shared, cuda_sw.forward_perread = (r.fn
                                                           for r in recs)
        return {name: call[1:] for r in recs
                for name, call in r.calls.items()}
    return restore


def phase_config4(torch, dev, scratch, n_reads, card):
    from ssw_tpu_torch import cli, pipeline, profiling

    fq = os.path.join(scratch, "illumina_1M.fastq")
    truth = sample_reads(fq, n_reads, seed=100_000)
    counter = profiling.GcupsCounter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with pipeline.profiled(counter):
        rc, out, err = run_cli(cli, ["-c", "-s", "-h", "-r",
                                     os.path.join(DATA, "1M.fa"), fq], dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    check(rc == 0, f"config 4 cli rc {rc}: {err[-2000:]}")
    hits = total = 0
    for line in out.splitlines():
        if line.startswith("@"):
            continue
        f = line.split("\t")
        total += 1
        hits += int(f[3]) - 1 == truth.get(f[0], -10)
    share = hits / max(n_reads, 1)
    fwd_s = counter.seconds.get("forward", 0.0)
    res = {
        "card": card, "reads": n_reads, "sam_records": total, "wall_s": wall,
        "reads_per_s": n_reads / wall,
        "cells": counter.cells,
        "gcups_forward_phase": counter.cells / fwd_s / 1e9 if fwd_s else 0.0,
        "gcups_wall": counter.cells / wall / 1e9,
        "phase_seconds": counter.seconds,
        "peak_device_bytes": peak, "begin_at_sampled_pos": share,
    }
    log("  config4 " + json.dumps(res))
    check(total == n_reads, f"{total} SAM records for {n_reads} reads")
    check(share >= 0.95, f"only {share:.4f} of reads begin at the sampled "
          f"position")
    return res


# ------------------------------------------------------------------- phase 6

def time_ms(torch, fn, reps):
    fn()  # warm-up
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_timing(torch, dev, rec, worst, launches, clock_mhz, slice_cols):
    from ssw_tpu_torch.ops import cuda_sw, scan_sw

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    int32_rate = INT32_LANES_PER_SM * sms * clock_mhz * 1e6
    log(f"  int32 rate: {INT32_LANES_PER_SM} lanes x {sms} SMs x "
        f"{clock_mhz} MHz = {int32_rate:.4g} op/s")
    rows = []

    def bound(ops, nbytes):
        t_ops = ops / int32_rate * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes,
                                                               "bytes")

    def shared_bound(opc, prof, cm, cols):
        # inputs once (profile, target, masks, read_len), outputs once
        # (int16 maxima, three (B,) int32)
        B = prof.shape[0]
        nbytes = (prof.numel() + 4 * cols + 3 * cm.numel() + 4 * B
                  + 2 * B * cols + 12 * B)
        return bound(opc * int(cm.sum()) * cols, nbytes)

    def shared_row(name, source, replaces):
        """forward_shared's kernel `name` at its largest main-path call; the
        plain version and the bound on a column slice of the same inputs
        when the call is too long for the plain version."""
        args, kw = rec[name]
        prof, ref, rl, cm, seg, ss, gapO, gapE, quirk = args
        B, n1, L = prof.shape
        R = int(ref.numel())
        opc = (cuda_sw.OPS_PER_CELL_I16 if name.endswith("_i16") else
               cuda_sw.OPS_PER_CELL_QUIRK if quirk else cuda_sw.OPS_PER_CELL)
        cols = min(slice_cols, R)
        sl = (prof, ref[:cols].contiguous(), rl, cm, seg, ss, gapO, gapE,
              quirk)
        ms = time_ms(torch, lambda: cuda_sw.forward_shared(*sl, **kw), 5)
        t0 = time.perf_counter()
        want = scan_sw.forward_shared_ref(*sl)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = cuda_sw.forward_shared(*sl, **kw)
        torch.cuda.synchronize()
        err = max_abs_diff(torch, got, want)
        check(err == 0, f"{name} at the main-path shape: max_abs_err {err}")
        b_ms, b_by = shared_bound(opc, prof, cm, cols)
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(err, worst[name]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "shape": f"B={B} L={L} R={cols} quirk={bool(quirk)}"
                     + (" (column slice of the leaf)" if cols < R else ""),
        }
        if cols < R:
            row["leaf_ms"] = time_ms(
                torch, lambda: cuda_sw.forward_shared(*args, **kw), 3)
            row["leaf_bound_ms"] = shared_bound(opc, prof, cm, R)[0]
            row["leaf_shape"] = f"B={B} L={L} R={R}"
        return row

    rows.append(shared_row(
        "forward_shared", "ssw_tpu_torch/csrc/sw_forward.cu",
        "ssw_tpu/ops/pallas_sw.py:109 (_forward_kernel, base mode, int32; "
        "pallas_call at :557)"))
    row = shared_row(
        "forward_shared_i16", "ssw_tpu_torch/csrc/sw_forward_i16.cu",
        "ssw_tpu/ops/pallas_sw.py:109 (_forward_kernel, int16 tier: use_i16 "
        "chosen at :735, pallas_call at :557; probe _i16_supported :576)")
    # the int32 kernel on the same config-4 leaf (same inputs, same call)
    args, kw = rec["forward_shared_i16"]
    prof, ref, rl, cm, seg, ss, gapO, gapE, quirk = args
    B = prof.shape[0]
    row["int32_leaf_ms"] = time_ms(
        torch, lambda: cuda_sw.forward_shared(*args), 3)
    row["int32_leaf_bound_ms"] = shared_bound(cuda_sw.OPS_PER_CELL, prof, cm,
                                              int(ref.numel()))[0]
    rows.append(row)
    # the suboptimal glue (torch, not a kernel) on this leaf's maxima, with
    # the CLI's mask_len (read_len // 2) and byte-tier window edges
    _, er, _, mc = cuda_sw.forward_shared(*args, **kw)
    ml = (rl // 2).to(torch.int32)
    word = torch.zeros(B, dtype=torch.bool, device=dev)
    sub_ms = time_ms(torch, lambda: scan_sw.second_best_batch(
        mc, er, ml, int(ref.numel()), word), 3)
    del mc
    log(f"  suboptimal glue (second_best_batch) at B={B} R={ref.numel()}: "
        f"{sub_ms:.3f} ms")
    # forward_perread at the recorded reverse pass
    args, kw = rec["forward_perread"]
    prof, refw, rl, cm, seg, ss, gapO, gapE, quirk = args
    B, n1, L = prof.shape
    W = refw.shape[1]
    ms = time_ms(torch, lambda: cuda_sw.forward_perread(*args, **kw), 20)
    t0 = time.perf_counter()
    want = scan_sw.forward_perread_ref(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = cuda_sw.forward_perread(*args, **kw)
    torch.cuda.synchronize()
    err = max_abs_diff(torch, got, want)
    check(err == 0, f"forward_perread at the main-path shape: max_abs_err "
          f"{err}")
    # columns this run's data needs: up to each read's terminate column
    term = kw.get("terminate")
    mc = scan_sw.forward_perread_ref(*args, emit_maxcol=True)[3]
    if term is not None:
        hit = mc == term[:, None]
        first = torch.where(hit.any(1), hit.int().argmax(1), W - 1) + 1
    else:
        first = torch.full((B,), W, device=dev)
    cells = int((cm.sum(1) * first).sum())
    opc = cuda_sw.OPS_PER_CELL_QUIRK if quirk else cuda_sw.OPS_PER_CELL
    nbytes = prof.numel() + 4 * refw.numel() + 3 * cm.numel() + 8 * B + 12 * B
    b_ms, b_by = bound(opc * cells, nbytes)
    rows.append({
        "name": "forward_perread", "route": "cuda",
        "source": "ssw_tpu_torch/csrc/sw_perread.cu",
        "replaces": "ssw_tpu/ops/pallas_sw.py:819 (_perread_kernel; "
                    "pallas_call at :963)",
        "launches": launches["forward_perread"],
        "max_abs_err": max(err, worst["forward_perread"]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "shape": f"B={B} L={L} W={W} terminate={term is not None}",
    })
    return rows


# ---------------------------------------------------------------------- main

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False; chip_smoke needs a "
            "CUDA card")
        return 1
    sys.path.insert(0, ROOT)
    try:
        from ssw_tpu_torch.native import build as native_build
        from ssw_tpu_torch.ops import _kernels, cuda_sw
    except ImportError as e:
        log(f"FAIL: ssw_tpu_torch is not importable next to chip_smoke.py "
            f"({e})")
        return 1
    dev = torch.device("cuda:0")
    scratch = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(scratch, exist_ok=True)
    try:
        # phase 1
        smi = nvidia_smi("name,power.limit")
        clock = nvidia_smi("clocks.max.sm", "csv,noheader,nounits")
        log(f"phase 1 device: {torch.cuda.get_device_name(0)} x "
            f"{torch.cuda.device_count()}; torch {torch.__version__} "
            f"cuda {torch.version.cuda}; nvidia-smi: {smi}; max SM clock "
            f"{clock} MHz")
        # phase 2
        t0 = time.perf_counter()
        secs = _kernels.build(_kernels.KERNELS)
        for name in _kernels.KERNELS:
            for line in _kernels.build_log.get(name, "").splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")
        native_ok = native_build.load() is not None
        log(f"phase 2 build: kernels {json.dumps(secs)} s, total "
            f"{time.perf_counter() - t0:.1f} s; host library "
            f"{'built' if native_ok else 'UNAVAILABLE (python fallback)'}")
        # phase 3
        t0 = time.perf_counter()
        log("phase 3 kernels vs plain versions (exact):")
        worst = phase_kernels(torch, dev)
        log(f"phase 3 done in {time.perf_counter() - t0:.1f} s")
        # phases 4-5 are the main path (configs 1-4): launch counts from 0
        cuda_sw.reset_launches()
        restore = record_main_path(cuda_sw)
        try:
            t0 = time.perf_counter()
            log("phase 4 ssw_test main path vs reference-binary goldens:")
            phase_golden(dev, scratch)
            log(f"phase 4 done in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            log(f"phase 5 config 4: {CONFIG4_READS} reads vs 1M.fa, "
                f"-c -s -h -r:")
            phase_config4(torch, dev, scratch, CONFIG4_READS, smi)
            log(f"phase 5 done in {time.perf_counter() - t0:.1f} s")
        finally:
            rec = restore()
        launches = cuda_sw.launch_counts()
        log(f"main-path launches (phases 4-5): {json.dumps(launches)}")
        for name, n in launches.items():
            check(n > 0, f"{name} was not launched on the main path")
        t0 = time.perf_counter()
        log("phase 6 kernel timing at main-path shapes:")
        kernels = phase_timing(torch, dev, rec, worst, launches,
                               float(clock or 1980), SLICE_COLS)
        log(f"phase 6 done in {time.perf_counter() - t0:.1f} s")
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        return 1
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
