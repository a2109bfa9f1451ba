#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ssw_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                 # needs one CUDA card
    python3 chip_smoke.py --kernels-only  # phases 1-3, then exit 2

Phases (any failure exits non-zero before the final line):
  1. device: fails without CUDA; prints the card's name and power limit
  2. build: the CUDA kernels from ssw_tpu_torch/csrc (nvcc, sm_90a) and the
     host C++ library, timed as set-up
  3. kernels vs their plain PyTorch versions on the card, exact equality
     (integer DP: tolerance 0) over DNA/protein penalties, byte/word
     geometry, L buckets 64..512 (+ generic-variant widths), ragged B and R,
     the int16 tier of forward_shared, terminate and emit_maxcol, and the
     blockmax mode of both forward kernels (valid_len inside the last
     blocks, score/ends equal to the base mode's on the same inputs); the
     packed kernel (both tiers' slots, the quirk, dual, degenerate reads,
     W 256..4096, up to 64 slots; whole and with the target split into 2
     and 3 stretches) and the dual mode of both forward tiers,
     also equal to the unpacked blockmax kernel channel by channel; the
     bounded-radius gate (phase_gate) in every forward kernel and mode, K 2
     to 34, the card's tiers and the JAX plan's, against the gated plain
     model and the ungated launch, depth histograms count for count; the
     owned-column mode of both forward kernels (phase_owned: random and
     shard idx/own, K 2 to 16 and 34, odd B, the quirk, gated and not);
     every ungated case runs the anti-diagonal wavefront (sw_wave_i32,
     sw_wave_i16, sw_wave_packed, sw_wave_perread) and is also held equal
     to the column-scan body of the same mode (sw_forward, sw_forward_i16,
     sw_forward_packed, sw_perread; scan_body=True): the int32 quirk at L
     64 to 1088, the K = 14 int16 fault input and two more seeds of its
     shape (int16 and int32), per-read windows with terminate, emit_maxcol
     and the quirk at L 64 to 1088, and hand-built terminate windows
     (tools/_common.terminate_case: later columns beat the terminate
     column, ties); the gated cases stay on the column-scan bodies
  4. the ssw_test main path (ssw_tpu_torch.cli.main) on the card, byte-equal
     to the reference-binary captures in tests/golden (configs 1-3), then
     every golden again with the streaming suboptimal scan forced, and with
     the card's gate tiers on every launch (GATE = "tiers")
  4s. every golden again through dcli align + merge with the forward pass
     sharded over a mesh of [card] x 4: --mesh-seq 2 by the default rules,
     --mesh-seq 4 with GATE = "tiers"; byte-equal
  4f. the four other front ends on the card, each with its default device:
     api.Aligner/Filter and ssw_lib.CSsw on the reference example pair
     (score 21, next best 8, 4=1X4=1I5=, NM 2; CSsw's NULL on a score_size
     0 overflow), pyssw.main byte-equal to the three pyssw goldens, a
     `python -m ssw_tpu_torch.bridge` worker without the platform variable
     (the example pair, the batched form, a bad line; any other "error"
     fails) equal to bridge.serve and api.align_batch in-process, and the
     C client of bindings/c (gcc) through bridge.write_launcher's script;
     every launch of this process in the phase in a sw_wave_* library
  5. config 4 at real size: 8192 Illumina-like 100 bp reads sampled from
     tests/data/1M.fa, -c -s -h -r, in turns: the full (B, R) suboptimal
     scan, streaming unpacked, streaming by the default rules (packed,
     the gate by its rule), the default without the gate (GATE = False),
     streaming with PACK = True and the card's gate tiers everywhere, in
     turns; the SAM outputs must be byte-equal.  reads/s,
     GCUPS, phase seconds, peak device memory, launches (all and gated),
     the gate's column steps by scan depth and the share of reads whose POS
     is the sampled position, for each run.
  5b. a 10 Mbp target (1M.fa and nine copies of it with 5 % seeded
     substitutions, one record) with 4096 reads, streaming by the default
     rule, then with GATE = False; the first 256 reads again with the full
     scan, byte-equal.
  5c. the reference README's Ion Torrent headline at full size: 1000 reads
     of 25-540 bp vs a 4,938,920 bp genome (tools/make_data.py's generator,
     copied), -c -s -h, streaming, in turns: the default rules (packed, the
     dual tier, the gate by its rule), GATE = False, unpacked dual, the
     re-run route (PACK = DUAL = False), the JAX planner's packing (PACK =
     True), these three with the card's gate tiers everywhere, GATE = False
     and the default again, byte-equal; then its reads of 273 bp and more
     with the penalties scaled by 20 (the int32 tier), dual and the re-run
     route, by the card's rule (the int32 wavefront) and with the card's
     gate tiers (the column-scan body), byte-equal.
  5d. the same reads and genome with the README's second penalty set,
     -m 1 -x 3 -o 5 -e 2 -c -s -h (the JAX package's gate_plan turns its
     gate on there; the card's rule gates no launch), in turns: GATE =
     None, False, True, None, byte-equal.
  5e. BASELINE config 5 on one card: phase 5b's target and its first 2048
     reads, -c -s -h -r, through dcli align --batch-size 1024 --mesh-seq 4
     over [card] x 4 (the sequence-parallel path: halo re-compute, best-hit
     merge) and dcli merge, byte-equal to phase 5b's SAM for those reads;
     wall, reads/s, GCUPS, phase seconds, peak memory, launches.
  5f. two dcli align processes on the card joined by a gloo rendezvous
     (--coordinator), BASELINE config 3, merged: equal to its capture.
  5g. the front ends at config-4 size on phase 5's reads: api.Aligner with
     the 1 Mbp reference set once and align_batch over the 8192 query
     strings (of the forward-strand reads, >= 0.95 begin at the sampled
     position), 64 of them against the first 100 kbp on the card and on
     the CPU equal field for field; pyssw -c -s -r against phase 5's cli
     SAM (qname, FLAG, RNAME, POS, AS, ZS equal but for strand ties, which
     pyssw gives the reverse strand: counted); one batched request of 256
     reads against 100k.fa to a bridge worker on the card, equal to
     api.align_batch in-process; wall, reads/s and host seconds outside the
     pipeline's phases of each, the median latency of one Aligner.align.
     Launch counts are set to 0 before phase 4 and read after phase 5g:
     these are the main path, and each kernel must have run in it, each
     forward kernel with the gate too; the counts by library must show
     every ungated forward launch in the wavefront libraries, every gated
     one in the column-scan libraries and every per-read launch in
     sw_wave_perread.
  5h. BASELINE config 4 at its full 100,000 reads: tools/make_data.py (run
     unedited, as a subprocess) writes 100k_illumina1.fastq.gz from 1M.fa,
     then ssw_tpu_torch.tools.run_config4_full (-c -s -h -r) by the default
     rules (streaming, packed) and with STREAM_SUBOPT = False (the full
     scan), one run each: both SAM bodies byte-equal, their SHA-256 the one
     the JAX package's tools/run_config4_full.py recorded (BENCH.md), >= 0.95
     of the reads at the position in their name; wall, reads/s, phase
     seconds, host share outside the phases, peak device memory.
  5i. BASELINE config 2 at scale: ssw_tpu_torch.tools.bench_protein's
     workload (512 reads of 30-150 aa, 200,000 aa, BLOSUM50, -o3 -e1: the
     quirk) with PACK 0 and 1 (non-streaming leaves: the int32 base mode),
     and STREAM_SUBOPT = True by the card's pack rule (the packed quirk
     path) and unpacked (the int32 blockmax mode), in turns a b c d d c b a:
     every AlignResult equal, every launch a wavefront, each route's kernel
     launched.  Its largest leaf is phase 6's int32 base-mode row.  Launch
     counts are set to 0 before phase 5h and read after phase 5i: each
     kernel of these entry points (ENTRY_KERNELS) must have run there,
     none gated, all in the wavefront libraries.
  6. kernel timing at the largest shapes phases 4-5d and 5i gave each
     kernel (the int32 base mode at 5i's protein leaf, the quirk: equal to
     its column-scan body on the whole leaf; the int16 tier's parity probe
     cuda_sw._i16_parity at its fixed workload),
     beside the plain version and the integer-ALU bound, the wavefront
     kernels in turns against the column-scan body of the same mode on
     the same inputs (the config-4 int32, int16 base and blockmax leaves,
     the Ion x20 int32 blockmax and dual leaves, the Ion int16 dual leaf,
     the config-4 packed leaf, the Ion L = 192 packed dual leaf (its
     slice also split into the stretches of the whole leaf's launch,
     against the plain version; its row counts the main path's split
     launches, each with a launch of the merge kernel), the
     protein-golden int32 launch with the quirk, the int32 owned launch,
     the largest config-5 owned shard, the reverse pass and the 10 Mbp
     window re-run), packed leaves
     beside unpacked leaves of the same reads in turns, each gated
     kernel family beside its ungated launch in turns, and the owned
     kernels beside their base mode on the same inputs in turns (the
     largest config-5 shard)
  3l. (after phase 3) the measurement tools' kernels (ssw_tpu_torch/tools:
     probe_swar, probe_i16, kernel_lab's sw_lab) against their plain twins,
     every lab variant with a comparison also against full or the
     production kernel (kernel_lab.verify), among the inputs one at the
     lab entry point's B 128, L 256; tolerance 0
  7. the tools' entry points as a user runs them (launch counts from 0,
     each tool kernel must launch), then their timing: ns per chain step
     of each max form (one warp, the whole card), the DPX SASS table, the
     lab's variants in turns against full on the config-4 int32 leaf's
     slice, each held there to its plain twin and kernel-run comparisons
     (tolerance 0), and full against the production column-scan body (the
     lab's copy) on the whole leaf (within 3 %)
  8. `python -m ssw_tpu_torch.bench` as a user runs it (a subprocess): exit
     0, its last line bench.py's four keys, every launch the packed
     wavefront in the mode the pipeline takes for the leaf (the dual tier);
     then, in this process, the timed call's inputs through the same launch
     on the target's first SLICE_COLS columns against the plain version
     (scan_sw.forward_shared_ref_packed), with the whole call's block
     maxima there, and the whole call against the unpacked int32 launch of
     the same reads in the same mode, all equal (tolerance 0); the bench's
     times and bound join the packed kernel's row of its mode in the
     {"kernels": [...]} line, printed last
  9. the measurement battery, the JAX package's remaining tools ported
     (ssw_tpu_torch/tools), on phase 5h's tools/make_data.py files: 9a
     BASELINE config 5 on 10M.fa (1M.fa's slice and a random tail) with
     1000 reads, -c -s -h: bench_longtarget cold and warm, then two dcli
     align processes (--num-hosts 2, gloo, each over [card] x 2 at
     --mesh-seq 2), merged; the three SAMs byte-equal, >= 0.95 of the
     forward-strand reads at their sampled position; 9b bench_iontorrent
     cold and warm, byte-equal to phase 5c's default-route SAM; 9c
     bench_leaf, 3 reps with one checksum; 9d sweep_boundaries' stream and
     pack-width sweeps (each setting's checksum equal); 9e
     spotcheck_revmem at (B, L, W) = (2048, 1024, 8192), its first 16
     reads equal to the plain reverse pass on the card (the K = 32
     per-read template), peak memory and the K = 32 ptxas registers and
     spills; 9f spotcheck_cuda, 0 mismatches; 9g bench_suite --reads
     2000 over meshes of [card] x 1, 2, 4, 8, its JSON on one line, each
     mesh's outputs equal.  Launch counts are set to 0 before phase 9 and
     read after it: they join each kernel's row as launches_9

The last line of stdout is {"ok": true, "device": {...}}.  Imports nothing
of JAX and nothing of the JAX package.
"""

from __future__ import annotations

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
CONFIG4_READS = 8192        # BASELINE config 4 cut from 100k reads (depth)
TARGET10M_COPIES = 9        # 1M.fa + 9 mutated copies: BASELINE config 5's
                            # 10 Mbp on one card
TARGET10M_READS = 4096      # config 5 cut to 4096 reads (depth)
TARGET10M_FULL_READS = 256  # of those, run again with the full scan
SLICE_COLS = 8192           # target columns of the forward kernel's timed
                            # slice (from the middle of the leaf's real
                            # columns), short enough for its plain version


def mid_slice(R, valid_len, cols):
    """First column of a cols-wide slice centred in the real columns: 1M.fa
    starts with 10,001 Ns."""
    return max(0, min(R, valid_len or R) // 2 - cols // 2)


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


def make_shared(dev, **kw):
    """Random reads (some embedded in the target) and their geometry:
    ssw_tpu_torch.tools._common.shared_case, the generator of
    i16_fault.failing_input too."""
    from ssw_tpu_torch.tools import _common as tools_common
    return tools_common.shared_case(dev, **kw)


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


def same_as_scan_body(label, got, scan):
    """A wavefront launch's outputs against the column-scan body of the
    same library and mode on the same inputs (scan() launches it)."""
    import torch
    want = scan()
    torch.cuda.synchronize()
    err = max_abs_diff(torch, got, want)
    log(f"  {label}: wavefront vs column-scan body: max_abs_err {err}")
    check(err == 0, f"{label}: the wavefront differs from the column-scan "
          f"body (max_abs_err {err})")


# ------------------------------------------------------------------- phase 3

def phase_terminate(torch, dev, worst):
    """The per-read kernel's terminate rule on hand-built windows
    (tools/_common.terminate_case): every distinct column maximum of a
    window as terminate[b], so the column after the terminate column
    mostly holds a higher maximum and values tie across columns and rows;
    DNA and BLOSUM50 with the quirk, emit_maxcol off and on; against the
    plain version and the column-scan body."""
    from ssw_tpu_torch.core.encoding import BLOSUM50
    from ssw_tpu_torch.ops import cuda_sw, scan_sw
    from ssw_tpu_torch.tools import _common as tools_common

    for label, mat, quirk, word, L in (
            ("dna 2/-2", dna_mat(2, 2), False, False, 64),
            ("BLOSUM50 quirk", BLOSUM50, True, True, 128)):
        args, term = tools_common.terminate_case(
            dev, mat=mat, word=word, seed=len(label), quirk=quirk, L=L)
        for emit in (False, True):
            got = cuda_sw.forward_perread(*args, 3, 1, quirk,
                                          terminate=term, emit_maxcol=emit)
            want = scan_sw.forward_perread_ref(*args, 3, 1, quirk,
                                               terminate=term,
                                               emit_maxcol=emit)
            torch.cuda.synchronize()
            err = max_abs_diff(torch, got, want)
            worst["forward_perread"] = max(worst["forward_perread"], err)
            name = (f"terminate by hand {label} B={term.numel()} "
                    f"emit_maxcol={emit}")
            log(f"  {name}: max_abs_err {err}")
            check(err == 0, f"{name}: kernel != plain (max_abs_err {err})")
            same_as_scan_body(name, got, lambda: cuda_sw.forward_perread(
                *args, 3, 1, quirk, terminate=term, emit_maxcol=emit,
                scan_body=True))


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
            (dna_mat(2, 2), 3, 1, False, False, True, True),
            (BLOSUM50, 3, 1, True, True, True, True),
            (BLOSUM50, 10, 1, True, False, True, False),
            (BLOSUM50, 3, 1, True, True, False, True))):
        L = (128, 256, 64, 128, 192, 1088, 1088, 448, 320)[j]
        cases.append((f"perread L={L} gapO={gO} gapE={gE} quirk={quirk} "
                      f"word={word} terminate={term} emit_maxcol={emit}",
                      "perread",
                      dict(B=29 + j, L=L, W=200 + 7 * j, mat=mat, word=word,
                           gO=gO, gE=gE, quirk=quirk, term=term, emit=emit,
                           seed=300 + j)))
    worst = {name: 0 for name in cuda_sw.LAUNCHES}

    def shared_modes(label, args, gO, gE, quirk, max_sub, valid_len):
        """Both modes of every eligible tier of forward_shared against the
        plain versions; blockmax score/ends against the base mode's on the
        same launch inputs."""
        want = scan_sw.forward_shared_ref(*args, gO, gE, quirk)
        want_bm = scan_sw.forward_shared_ref(*args, gO, gE, quirk,
                                             blockmax=True,
                                             valid_len=valid_len)
        L = int(args[0].shape[2])
        tiers = [None] + ([max_sub] if cuda_sw.i16_exact(
            L, gO, gE, max_sub, quirk) else [])
        for ms in tiers:
            got = cuda_sw.forward_shared(*args, gO, gE, quirk, max_sub=ms)
            got_bm = cuda_sw.forward_shared(*args, gO, gE, quirk,
                                            max_sub=ms, blockmax=True,
                                            valid_len=valid_len)
            torch.cuda.synchronize()
            for bm, g, w in ((False, got, want), (True, got_bm, want_bm)):
                name = cuda_sw.shared_kernel_name(ms is not None, bm)
                err = max_abs_diff(torch, g, w)
                worst[name] = max(worst[name], err)
                log(f"  {label} {name}"
                    + (f" valid_len={valid_len}" if bm else "")
                    + f": max_abs_err {err}")
                check(err == 0, f"{label} {name}: kernel != plain "
                      f"(max_abs_err {err})")
                same_as_scan_body(
                    f"{label} {name}", g, lambda: cuda_sw.forward_shared(
                        *args, gO, gE, quirk, max_sub=ms, blockmax=bm,
                        valid_len=valid_len if bm else None,
                        scan_body=True))
            check(max_abs_diff(torch, got_bm[:3], got[:3]) == 0,
                  f"{label}: blockmax score/ends differ from the base "
                  f"mode's")

    for label, kind, kw in cases:
        if kind == "shared":
            args, _, _ = make_shared(dev, B=kw["B"], L=kw["L"],
                                     R=kw["R"], mat=kw["mat"],
                                     word=kw["word"], seed=kw["seed"])
            # valid_len inside the last block, not a multiple of 256: the
            # target's columns run past it
            shared_modes(label, args, kw["gO"], kw["gE"], kw["quirk"],
                         int(np.abs(kw["mat"]).max()), kw["R"] - 37)
            continue
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
        torch.cuda.synchronize()
        err = max_abs_diff(torch, got, want)
        worst["forward_perread"] = max(worst["forward_perread"], err)
        log(f"  {label}: max_abs_err {err}")
        check(err == 0, f"{label}: kernel != plain (max_abs_err {err})")
        same_as_scan_body(label, got, lambda: cuda_sw.forward_perread(
            *args, kw["gO"], kw["gE"], kw["quirk"], terminate=term,
            emit_maxcol=kw["emit"], scan_body=True))
    phase_terminate(torch, dev, worst)
    # two more seeds of the shape on which an int16 build once went wrong
    # at K = 14 (ROADMAP §C; the failing input, seed 106, is the case
    # `shared L=448 gapO=3 gapE=1 quirk=False word=False` above): the
    # production int16 base mode, pinned
    from ssw_tpu_torch.tools import i16_fault
    for seed in (1106, 2106):
        args = i16_fault.failing_input(dev, seed)
        got = cuda_sw.forward_shared(*args, 3, 1, False, max_sub=2)
        want = scan_sw.forward_shared_ref(*args, 3, 1, False)
        torch.cuda.synchronize()
        err = max_abs_diff(torch, got, want)
        worst["forward_shared_i16"] = max(worst["forward_shared_i16"], err)
        log(f"  K=14 int16 pin seed {seed} B=43 L=448 R=778: "
            f"max_abs_err {err}")
        check(err == 0, f"the int16 kernel at K = 14 is wrong again on "
              f"seed {seed} (ROADMAP §C): max_abs_err {err}")
        same_as_scan_body(f"K=14 int16 pin seed {seed}", got,
                          lambda: cuda_sw.forward_shared(
                              *args, 3, 1, False, max_sub=2, scan_body=True))
        got = cuda_sw.forward_shared(*args, 3, 1, False)
        torch.cuda.synchronize()
        err = max_abs_diff(torch, got, want)
        worst["forward_shared"] = max(worst["forward_shared"], err)
        log(f"  K=14 int32 seed {seed}: max_abs_err {err}")
        check(err == 0, f"the int32 wavefront at K = 14, seed {seed}: "
              f"max_abs_err {err}")
        same_as_scan_body(f"K=14 int32 seed {seed}", got,
                          lambda: cuda_sw.forward_shared(
                              *args, 3, 1, False, scan_body=True))
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
    shared_modes("256 x 100 bp vs 1M.fa[:32768]", args, 3, 1, False, 2,
                 R - 100)
    return worst


def make_packed(torch, common, dev, *, mat, lens, word_rows, W, R, vl, seed,
                max_slots=64, gate_k=None):
    """Reads of the given lengths (half embedded in the target with 5 %
    substitutions; with gate_k, gate_reads' hot and cold reads), the
    target's columns past vl the virtual letter (the pipeline's padding),
    in the packed layout (common.pack_plan at W lanes) and unpacked:
    (packed args, unpacked args with each read's tier's col_mask, byte-tier
    col_mask, word-tier col_mask, plan)."""
    rng = np.random.default_rng(seed)
    n = mat.shape[0]
    ref = np.full(R, n, np.int32)
    ref[:vl] = rng.integers(0, n - 1, vl)
    reads = [] if gate_k is None else gate_reads(rng, lens, ref, vl, n,
                                                 gate_k)
    for b, ln in enumerate(lens if gate_k is None else ()):
        ln = int(ln)
        if b % 2 and vl > ln:
            s = int(rng.integers(0, vl - ln))
            r = ref[s:s + ln].copy()
            m = rng.random(ln) < 0.05
            r[m] = rng.integers(0, n - 1, int(m.sum()))
        else:
            r = rng.integers(0, n - 1, ln).astype(np.int32)
        reads.append(r)
    read_len = np.asarray(lens, np.int32)
    word_rows = np.asarray(word_rows, bool)
    L = common.bucket_size(max(common.pad_total(int(read_len.max()), False),
                               1), 64)
    rp = common.pad_reads(reads, L, n)
    slot_len = np.where(word_rows, (read_len + 7) // 8 * 8,
                        (read_len + 15) // 16 * 16).astype(np.int32)
    plan = common.pack_plan(slot_len, W, max_slots=max_slots)
    mat_ext = common.extend_matrix(mat)
    so, sl, rl_s = common.pack_tables(plan, read_len)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)
    packed = (t(common.build_profile(common.pack_codes(plan, rp, n), None,
                                     mat_ext)), t(ref), t(so), t(sl),
              t(rl_s), t((plan.row * plan.S + plan.slot).astype(np.int32)))
    gb = common.batch_geometry(read_len, L, word=False)
    gw = common.batch_geometry(read_len, L, word=True)
    seg = gw if word_rows.all() else gb
    unpacked = (t(common.build_profile(rp, read_len, mat_ext)), t(ref),
                t(read_len),
                t(np.where(word_rows[:, None], gw.col_mask, gb.col_mask)),
                t(seg.seg_id), t(seg.seg_start))
    return packed, unpacked, t(gb.col_mask), t(gw.col_mask), plan


def phase_packed(torch, dev, worst):
    """The packed kernel (both tiers' slot geometry, the quirk, dual,
    degenerate reads, W 256..4096 with up to 64 slots, slots past 1024
    lanes) and the dual mode of both forward tiers, exactly against their
    plain versions and against the unpacked blockmax kernel, channel by
    channel."""
    from ssw_tpu_torch.core.encoding import BLOSUM50
    from ssw_tpu_torch.leaf_timing import pinned_stretches
    from ssw_tpu_torch.ops import common, cuda_sw, pack, scan_sw

    rng = np.random.default_rng(77)
    q_mat = dna_mat(2, 4)  # min -4 < -2*gapE: the quirk is observable
    cases = [  # label, mat, gapO, gapE, quirk, lens, word_rows, W, R, vl
        ("dna m2x2o3e1 byte W=1024", dna_mat(2, 2), 3, 1, False,
         rng.integers(20, 221, 40), np.zeros(40, bool), 1024, 768, 700),
        ("dna m1x3o5e2 mixed tiers W=512", dna_mat(1, 3), 5, 2, False,
         rng.integers(20, 221, 37), np.arange(37) % 2 == 0, 512, 768, 700),
        ("quirk dna 2/-4 byte W=512", q_mat, 3, 1, True,
         rng.integers(20, 221, 24), np.zeros(24, bool), 512, 512, 500),
        ("quirk dna 2/-4 word W=512", q_mat, 3, 1, True,
         rng.integers(20, 221, 24), np.ones(24, bool), 512, 512, 500),
        ("quirk BLOSUM50 o10e1 byte W=1024", BLOSUM50, 10, 1, True,
         rng.integers(20, 201, 30), np.zeros(30, bool), 1024, 600, 600),
        ("quirk BLOSUM50 o10e1 word W=1024", BLOSUM50, 10, 1, True,
         rng.integers(20, 201, 30), np.ones(30, bool), 1024, 600, 600),
        ("degenerate reads W=256", dna_mat(2, 2), 3, 1, False,
         np.array([0, 1, 90, 0, 1, 37, 120, 2, 0, 64]), np.zeros(10, bool),
         256, 512, 430),
        ("64 slots W=2048", dna_mat(2, 2), 3, 1, False,
         rng.integers(17, 33, 200), np.zeros(200, bool), 2048, 512, 480),
        ("64 slots W=4096", dna_mat(2, 2), 3, 1, False,
         rng.integers(33, 65, 160), np.zeros(160, bool), 4096, 512, 512),
        ("slots past 1024 lanes W=4096", dna_mat(2, 2), 3, 1, False,
         rng.integers(1100, 1500, 6), np.zeros(6, bool), 4096, 512, 400),
    ]
    for label, mat, gO, gE, quirk, lens, word_rows, W, R, vl in cases:
        pa, ua, cm_byte, cm_word, plan = make_packed(
            torch, common, dev, mat=mat, lens=lens, word_rows=word_rows, W=W,
            R=R, vl=vl, seed=len(label))
        ms = int(np.abs(mat).max())
        word = bool(word_rows.all())
        duals = (False,) if quirk or not (~word_rows).all() else (False,
                                                                  True)
        for dual in duals:
            kw = dict(max_sub=ms, valid_len=vl, quirk=quirk, word=word,
                      dual=dual)
            got = cuda_sw.forward_shared_packed(*pa, gO, gE, **kw)
            want = scan_sw.forward_shared_ref_packed(*pa, gO, gE, **kw)
            torch.cuda.synchronize()
            name = "forward_shared_packed" + ("_dual" if dual else "")
            err = max_abs_diff(torch, got, want)
            worst[name] = max(worst[name], err)
            log(f"  packed {label} S={plan.S} rows={plan.n_rows} "
                f"dual={dual}: max_abs_err {err}")
            check(err == 0, f"packed {label} dual={dual}: kernel != plain "
                  f"(max_abs_err {err})")
            # the target split into stretches (the rule pinned), each
            # launch also running the merge kernel
            for P in (2, 3):
                split = cuda_sw.split_counts()[name]
                with pinned_stretches(P):
                    got_p = cuda_sw.forward_shared_packed(*pa, gO, gE, **kw)
                torch.cuda.synchronize()
                serr = max_abs_diff(torch, got_p, want)
                worst[name] = max(worst[name], serr)
                P_eff = pack.stretch_bounds(vl, P)[0]
                log(f"  packed {label} dual={dual} split into {P_eff} "
                    f"stretches: max_abs_err {serr}")
                check(serr == 0 and P_eff > 1
                      and cuda_sw.split_counts()[name] == split + 1,
                      f"packed {label} dual={dual} split into {P_eff} "
                      f"stretches: kernel != plain (max_abs_err {serr})")
            same_as_scan_body(
                f"packed {label} dual={dual}", got,
                lambda: cuda_sw.forward_shared_packed(*pa, gO, gE,
                                                      scan_body=True, **kw))
            # the unpacked blockmax kernel (int32) on the same reads
            if dual:
                byte = cuda_sw.forward_shared(*ua[:3], cm_byte, *ua[4:], gO,
                                              gE, False, blockmax=True,
                                              valid_len=vl)
                wrd = cuda_sw.forward_shared(*ua[:3], cm_word, *ua[4:], gO,
                                             gE, False, blockmax=True,
                                             valid_len=vl)
                same = (max_abs_diff(torch, got[:3], byte[:3]) == 0
                        and max_abs_diff(torch, (got[3][:, 0],
                                                 got[3][:, 1]),
                                         (byte[3], wrd[3])) == 0)
                # the dual mode of both unpacked tiers on the same reads
                for tier in (None, ms):
                    if tier and not cuda_sw.i16_exact(
                            int(ua[0].shape[2]), gO, gE, ms, False):
                        continue
                    ud = cuda_sw.forward_shared(
                        *ua[:3], cm_byte, *ua[4:], gO, gE, False,
                        max_sub=tier, blockmax=True, valid_len=vl,
                        wmask=cm_word)
                    uw = scan_sw.forward_shared_ref(
                        *ua[:3], cm_byte, *ua[4:], gO, gE, False,
                        blockmax=True, valid_len=vl, wmask=cm_word)
                    torch.cuda.synchronize()
                    dname = cuda_sw.shared_kernel_name(tier is not None,
                                                       True, True)
                    same_as_scan_body(
                        f"{dname} {label}", ud,
                        lambda: cuda_sw.forward_shared(
                            *ua[:3], cm_byte, *ua[4:], gO, gE, False,
                            max_sub=tier, blockmax=True, valid_len=vl,
                            wmask=cm_word, scan_body=True))
                    derr = max_abs_diff(torch, ud, uw)
                    worst[dname] = max(worst[dname], derr)
                    log(f"  {dname} {label}: max_abs_err {derr}, equal to "
                        f"the packed dual "
                        f"{max_abs_diff(torch, ud, got) == 0}")
                    check(derr == 0 and max_abs_diff(torch, ud, got) == 0,
                          f"{dname} {label}: kernel != plain or != packed")
            else:
                unp = cuda_sw.forward_shared(*ua, gO, gE, quirk,
                                             blockmax=True, valid_len=vl)
                same = max_abs_diff(torch, got, unp) == 0
            check(same, f"packed {label} dual={dual}: != the unpacked "
                  f"blockmax kernel")


def gate_reads(rng, lens, ref, vl, n, K):
    """tests/test_gatescan.py's hot and cold reads, and hot reads the gate
    can get wrong: every 4th read an exact copy of the target (it closes
    the gate near its hit), every 4th from the second a copy with a
    read-side insertion of K + 1 .. 64 random bases after a prefix of up to
    40 (F has to carry the prefix's score across the insertion, further
    than depth 0 reaches), the rest random (they keep the gate open)."""
    reads = []
    for b, ln in enumerate(lens):
        ln = int(ln)
        r = rng.integers(0, n - 1, ln).astype(np.int32)
        a = min(40, ln // 3)
        ins = min(64, ln - a - 8)
        if b % 4 == 0 and vl > ln:
            s = int(rng.integers(0, vl - ln))
            r = ref[s:s + ln].copy()
        elif b % 4 == 1 and ins > K and vl > ln:
            ins = int(rng.integers(K + 1, ins + 1))
            s = int(rng.integers(0, vl - ln))
            r = np.concatenate([ref[s:s + a], r[:ins],
                                ref[s + a:s + ln - ins]])
        reads.append(r)
    return reads


def make_gate_shared(torch, common, dev, *, B, L, R, mat, word, seed):
    """gate_reads of lengths L/3 .. L-16 against a random target, with
    their geometry (make_shared's layout)."""
    rng = np.random.default_rng(seed)
    n = mat.shape[0]
    ref = rng.integers(0, n - 1, R).astype(np.int32)
    read_len = rng.integers(max(L // 3, 2), L - 16, B).astype(np.int32)
    reads = gate_reads(rng, read_len, ref, R, n, L // 32)
    prof = common.build_profile(common.pad_reads(reads, L, n), read_len,
                                common.extend_matrix(mat))
    geo = common.batch_geometry(read_len, L, word=word)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)
    return (t(prof), t(ref), t(read_len), t(geo.col_mask), t(geo.seg_id),
            t(geo.seg_start))


def phase_gate(torch, dev, worst):
    """The gated forward kernels (the bounded-radius gate, every mode and
    tier, the card's tiers and the JAX plan's) against their plain model,
    which runs the same truncated scans, and against their own ungated
    launch: exact outputs, and the kernel's histogram of column steps by
    scan depth equal to the plain model's, count for count.  Returns the
    steps by depth summed per kernel."""
    from ssw_tpu_torch.core.encoding import BLOSUM50
    from ssw_tpu_torch.ops import common, cuda_sw, gate, pack, scan_sw

    steps = {}

    def one(label, name, kernel, plain, thr):
        """kernel(gate) and plain(gate) -> outputs (plain: with steps)."""
        cuda_sw.reset_gate_steps()
        got = kernel(thr)
        hist = cuda_sw.gate_steps()  # synchronises
        ungated = kernel(None)
        want, want_hist = plain(thr)
        torch.cuda.synchronize()
        err = max(max_abs_diff(torch, got, want),
                  max_abs_diff(torch, got, ungated))
        worst[name] = max(worst[name], err)
        want_hist = want_hist.tolist()
        log(f"  gate {label} {name} thr={list(thr)}: max_abs_err {err}, "
            f"steps by depth {hist}")
        check(err == 0, f"gate {label} {name}: gated kernel != plain model "
              f"or != ungated kernel (max_abs_err {err})")
        check(hist == want_hist, f"gate {label} {name}: depth histogram "
              f"{hist} != the plain model's {want_hist}")
        check(sum(hist[:5]) > 0, f"gate {label} {name}: the gate never "
              f"opened")
        tot = steps.setdefault(name, [0] * len(hist))
        for m, c in enumerate(hist):
            tot[m] += c

    q_mat = dna_mat(2, 4)  # min -4 < -2*gapE: the quirk is observable
    shared = [  # label, L, B, R, mat, gapO, gapE, quirk, plan
        ("K=2 m2x2o3e1", 64, 22, 600, dna_mat(2, 2), 3, 1, False, None),
        ("K=4 m2x2o3e1", 128, 21, 600, dna_mat(2, 2), 3, 1, False, None),
        ("K=8 m1x3o5e2", 256, 17, 600, dna_mat(1, 3), 5, 2, False, None),
        ("K=8 m1x3o5e2 JAX plan", 256, 17, 600, dna_mat(1, 3), 5, 2, False,
         "1"),
        ("K=8 m2x2o3e1 JAX plan forced", 256, 17, 600, dna_mat(2, 2), 3, 1,
         False, "force"),
        ("K=14 m2x2o3e1", 448, 13, 600, dna_mat(2, 2), 3, 1, False, None),
        ("K=16 m2x2o3e1", 512, 11, 600, dna_mat(2, 2), 3, 1, False, None),
        ("K=32 m2x2o3e1", 1024, 7, 600, dna_mat(2, 2), 3, 1, False, None),
        ("K=34 GlobRow m2x2o3e1", 1088, 7, 600, dna_mat(2, 2), 3, 1, False,
         None),
        ("K=4 quirk 2/-4", 128, 19, 600, q_mat, 3, 1, True, None),
        ("K=8 quirk BLOSUM50 o10e2", 256, 13, 600, BLOSUM50, 10, 2, True,
         None),
    ]
    for i, (label, L, B, R, mat, gO, gE, quirk, plan) in enumerate(shared):
        args = make_gate_shared(torch, common, dev, B=B, L=L, R=R, mat=mat,
                                word=False, seed=500 + i)
        ms = int(np.abs(mat).max())
        K = L // 32
        if plan is None:
            thr = gate.card_thresholds(K, L, gO, gE, ms)
        else:
            gate.GATESCAN = plan
            try:
                thr = gate.plan_thresholds(K, L, gO, gE, ms)
            finally:
                gate.GATESCAN = "1"
        check(thr is not None, f"gate {label}: no threshold")
        rl = args[2]
        j = torch.arange(L, device=dev)[None, :]
        wmask = (j < (rl[:, None] + 7) // 8 * 8).contiguous()
        vl = R - 37
        modes = [("base", {}), ("blockmax", dict(blockmax=True,
                                                 valid_len=vl))]
        if not quirk:
            modes.append(("dual", dict(blockmax=True, valid_len=vl,
                                       wmask=wmask)))
        tiers = [None] + ([ms] if cuda_sw.i16_exact(L, gO, gE, ms, quirk)
                          else [])
        for mode, kw in modes:
            for tier in tiers:
                name = cuda_sw.shared_kernel_name(
                    tier is not None, mode != "base", mode == "dual")
                one(f"{label} {mode}", name,
                    lambda g: cuda_sw.forward_shared(
                        *args, gO, gE, quirk, max_sub=tier, gate=g, **kw),
                    lambda g: scan_sw.forward_shared_ref(
                        *args, gO, gE, quirk, gate=g, pairs=tier is not None,
                        steps=True, **kw), thr)

    rng = np.random.default_rng(78)
    packed = [  # label, mat, gapO, gapE, quirk, lens, word_rows, W, R, vl
        ("m2x2o3e1 byte W=1024", dna_mat(2, 2), 3, 1, False,
         rng.integers(20, 221, 40), np.zeros(40, bool), 1024, 768, 700),
        ("m1x3o5e2 mixed tiers W=512", dna_mat(1, 3), 5, 2, False,
         rng.integers(60, 221, 37), np.arange(37) % 2 == 0, 512, 768, 700),
        ("quirk 2/-4 word W=512", q_mat, 3, 1, True,
         rng.integers(20, 221, 24), np.ones(24, bool), 512, 512, 500),
        ("64 slots W=4096", dna_mat(2, 2), 3, 1, False,
         rng.integers(33, 65, 160), np.zeros(160, bool), 4096, 512, 512),
        ("slots past 1024 lanes W=4096", dna_mat(2, 2), 3, 1, False,
         rng.integers(1100, 1500, 6), np.zeros(6, bool), 4096, 512, 400),
    ]
    for label, mat, gO, gE, quirk, lens, word_rows, W, R, vl in packed:
        slot = np.where(word_rows, (lens + 7) // 8 * 8, (lens + 15) // 16 * 16)
        smax = int(slot.max())
        K = pack.packed_lanes(smax) // 32
        pa, _, _, _, plan = make_packed(
            torch, common, dev, mat=mat, lens=lens, word_rows=word_rows, W=W,
            R=R, vl=vl, seed=len(label) + 1, gate_k=K)
        ms = int(np.abs(mat).max())
        word = bool(word_rows.all())
        thrs = [("card", gate.card_thresholds(K, smax, gO, gE, ms))]
        gate.GATESCAN = "force"
        try:
            thrs.append(("JAX plan forced", gate.plan_thresholds(
                K, W, gO, gE, ms, pack.pack_bound(smax))))
        finally:
            gate.GATESCAN = "1"
        duals = (False,) if quirk or not (~word_rows).all() else (False,
                                                                  True)
        for src, thr in thrs:
            if thr is None:
                continue
            for dual in duals:
                kw = dict(max_sub=ms, valid_len=vl, quirk=quirk, word=word,
                          dual=dual)
                one(f"packed {label} S={plan.S} {src}",
                    "forward_shared_packed" + ("_dual" if dual else ""),
                    lambda g: cuda_sw.forward_shared_packed(*pa, gO, gE,
                                                            gate=g, **kw),
                    lambda g: scan_sw.forward_shared_ref_packed(
                        *pa, gO, gE, gate=g, steps=True, **kw), thr)
    for name, tot in steps.items():
        log(f"  gate {name}: steps by depth {tot}")
        check(sum(tot[:5]) > 0 and tot[5] > 0, f"gate {name}: depths below "
              f"5 and the full scan did not both occur ({tot})")
    return steps


def owned_columns(rng, layout, R):
    """idx/own of one shard: "shard" is shard 1 of a seq split (halo
    warm-up columns before the owned ones), "random" a permutation of
    global indices with random ownership."""
    if layout == "shard":
        halo, start = 96, 1000
        idx = np.arange(R, dtype=np.int32) + (start - halo)
        return idx, idx >= start
    return (rng.permutation(4 * R)[:R].astype(np.int32),
            rng.random(R) < 0.5)


def phase_owned(torch, dev, worst):
    """The owned-column mode of both forward kernels (the sequence-parallel
    shards' pass) against the plain version forward_shared_ref_gated: both
    idx/own layouts, K 2..16 (14 included) and the GlobRow width 34, odd B
    (the last int16 pair has no second read), the int32 kernel with the
    quirk, each gated (the card's tiers) and ungated; exact outputs, and a
    gated launch's depth histogram equal to the plain model's."""
    from ssw_tpu_torch.core.encoding import BLOSUM50
    from ssw_tpu_torch.ops import cuda_sw, gate, scan_sw

    cases = []  # label, L, B, R, mat, gapO, gapE, quirk, layout
    for i, L in enumerate((64, 128, 192, 256, 320, 384, 448, 512, 1088)):
        for layout in ("random", "shard"):
            cases.append((f"K={L // 32} {layout}", L, 2 * (9 + i) + 1,
                          600 + 37 * i, dna_mat(2, 2), 3, 1, False, layout))
    cases += [("K=4 quirk BLOSUM50 shard", 128, 23, 700, BLOSUM50, 3, 1,
               True, "shard"),
              ("K=14 quirk 2/-4 random", 448, 13, 700, dna_mat(2, 4), 3, 1,
               True, "random"),
              ("K=8 m1x3o5e2 shard", 256, 19, 700, dna_mat(1, 3), 5, 2,
               False, "shard")]
    for i, (label, L, B, R, mat, gO, gE, quirk, layout) in enumerate(cases):
        args, _, _ = make_shared(dev, B=B, L=L, R=R, mat=mat,
                                 word=False, seed=900 + i)
        idx, own = owned_columns(np.random.default_rng(950 + i), layout, R)
        t = lambda a: torch.as_tensor(a).to(dev)
        cols = (t(idx), t(own))
        ms = int(np.abs(mat).max())
        thr = gate.card_thresholds(L // 32, L, gO, gE, ms)
        tiers = [None] + ([ms] if cuda_sw.i16_exact(L, gO, gE, ms, quirk)
                          else [])
        for g in (None, thr):
            for tier in tiers:
                name = cuda_sw.owned_kernel_name(tier is not None)
                cuda_sw.reset_gate_steps()
                got = cuda_sw.forward_shared_gated(
                    *args[:2], *cols, *args[2:], gO, gE, quirk,
                    max_sub=tier, gate=g)
                hist = cuda_sw.gate_steps()  # synchronises
                want = scan_sw.forward_shared_ref_gated(
                    *args[:2], *cols, *args[2:], gO, gE, quirk, gate=g,
                    pairs=tier is not None, steps=g is not None)
                if g is not None:
                    want, want_hist = want
                    check(hist == want_hist.tolist(),
                          f"owned {label} {name}: depth histogram {hist} != "
                          f"the plain model's {want_hist.tolist()}")
                torch.cuda.synchronize()
                err = max_abs_diff(torch, got, want)
                worst[name] = max(worst[name], err)
                log(f"  owned {label} B={B} {name}"
                    + (f" gate={list(g)} steps {hist}" if g else "")
                    + f": max_abs_err {err}")
                check(err == 0, f"owned {label} {name}: kernel != plain "
                      f"(max_abs_err {err})")
                if g is None:
                    same_as_scan_body(
                        f"owned {label} {name}", got,
                        lambda: cuda_sw.forward_shared_gated(
                            *args[:2], *cols, *args[2:], gO, gE, quirk,
                            max_sub=tier, scan_body=True))


# ------------------------------------------------------------------ phase 3l

def lab_inputs(torch, dev):
    """The lab's phase-3l inputs: the JAX lab's (every lane valid) at K 4
    and 8, the last at the entry point's B 128, L 256 over 2,048 columns,
    and ragged DNA reads (make_shared) at K 2, 4 and 16; every target
    longer than one 256-column block."""
    from ssw_tpu_torch.tools import kernel_lab

    rng = np.random.default_rng(41)
    sets = [(f"jax B={b} L={l} R={256 * nb}",
             kernel_lab.from_jax(*kernel_lab.jax_inputs(rng, b, l, nb), dev))
            for b, l, nb in ((37, 128, 2), (16, 256, 2),
                             (kernel_lab.B, kernel_lab.L, 8))]
    for b, l, r, seed in ((11, 64, 300, 401), (37, 128, 333, 402),
                          (9, 512, 290, 403)):
        args, _, _ = make_shared(dev, B=b, L=l, R=r,
                                 mat=dna_mat(2, 2), word=False, seed=seed)
        sets.append((f"reads B={b} L={l} R={r}", args))
    return sets


def phase_tools(torch, dev):
    """Phase 3l: every tool kernel against its plain twin, and every lab
    variant against its plain twin and its kernel-run comparison (full,
    the production kernel), tolerance 0; gatescan's depth histogram count
    for count.  Returns the worst error per tool kernel."""
    from ssw_tpu_torch.tools import kernel_lab, probe_i16, probe_swar

    worst = {"probe_swar": 0, "probe_i16": 0, "sw_lab": 0}
    probe_swar.check_exact(np.random.default_rng(0), dev)
    errs = probe_swar.exactness(dev)
    log(f"  probe_swar chains at ({probe_swar.B}, {probe_swar.L}) x "
        f"{probe_swar.DEPTH}, bench inputs: max_abs_err {errs}")
    check(not any(errs.values()), f"probe_swar chains: {errs}")
    for name in probe_i16.PROBES:
        err = probe_i16.check(name, dev)
        log(f"  probe_i16 {name}: max_abs_err {err}")
        check(err == 0, f"probe_i16 {name}: kernel != plain ({err})")
    for label, args in lab_inputs(torch, dev):
        gate = kernel_lab.card_gate(args)
        for v in kernel_lab.VARIANTS:
            if v == "skeleton":  # timed only: no comparison
                continue
            for m in (range(5) if v == "shortscan" else (None,)):
                err = kernel_lab.verify(v, args, m=m, gate=gate)
                worst["sw_lab"] = max(worst["sw_lab"], err)
                log(f"  sw_lab {v}{'' if m is None else f'!{m}'} {label}: "
                    f"max_abs_err {err}")
                check(err == 0, f"sw_lab {v} {label}: max_abs_err {err}")
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


def data_path(a):
    """A golden case's argument: a file name in tests/data, or a flag."""
    return os.path.join(DATA, a) if a.endswith(
        (".fa", ".fastq", ".fq", ".seq")) else a


def run_cli(cli, args, dev):
    out, err = io.StringIO(), io.StringIO()
    rc = cli.main(args, out=out, err=err, device=dev)
    return rc, out.getvalue(), err.getvalue()


def phase_golden(dev, scratch, label):
    from ssw_tpu_torch import cli

    path = data_path
    for args, gold in GOLDEN_CASES:
        t0 = time.perf_counter()
        rc, out, _ = run_cli(cli, [path(a) for a in args], dev)
        with open(os.path.join(GOLD, gold)) as f:
            same = out == f.read()
        log(f"  {label} {gold}: rc {rc} byte-equal {same} "
            f"({time.perf_counter() - t0:.2f} s)")
        check(rc == 0 and same, f"golden {gold} differs ({label})")
    rc, out, _ = run_cli(cli, [path("-c"), path("target2.fa"),
                               path("query2.fa")], dev)
    check(rc == 0 and out == "", "headerless target2.fa produced output")
    log(f"  {label} target2.fa (headerless): no records, as the reference")
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
    log(f"  {label} g_prot_b62_blast.txt (BLOSUM62 file): rc {rc} "
        f"byte-equal {same}")
    check(rc == 0 and same, f"golden g_prot_b62_blast.txt differs ({label})")


def run_dcli(dcli, dev, mesh_seq, args, prefix, cwd=None):
    """dcli align over a mesh of [dev] * 4 at --mesh-seq mesh_seq, then
    dcli merge; returns the merged output.  args: ssw_test flags (-h
    becomes --header) ending in target and query."""
    flags = ["--header" if a == "-h" else a for a in args]
    here = os.getcwd()
    if cwd:
        os.chdir(cwd)
    try:
        err = io.StringIO()
        rc = dcli.main(["align", "--mesh-seq", str(mesh_seq), "--out",
                        prefix, *flags], err=err, devices=[dev] * 4)
        check(rc == 0, f"dcli align {args}: rc {rc}: {err.getvalue()[-2000:]}")
        merged = prefix + ".merged"
        check(dcli.main(["merge", "--out", merged, prefix + ".part0"],
                        err=io.StringIO()) == 0, "dcli merge failed")
    finally:
        os.chdir(here)
    with open(merged) as f:
        return f.read()


def phase_dcli_golden(dev, scratch, mesh_seq, label):
    """Every golden case through dcli align + merge on one card, the
    forward pass sharded over a mesh of [dev] * 4 (data x seq = 4 /
    mesh_seq x mesh_seq): byte-equal to the reference-binary captures."""
    from ssw_tpu_torch import dcli

    path = data_path
    d = os.path.join(scratch, f"dcli_{mesh_seq}")
    os.makedirs(d, exist_ok=True)
    for i, (args, gold) in enumerate(GOLDEN_CASES):
        t0 = time.perf_counter()
        out = run_dcli(dcli, dev, mesh_seq, [path(a) for a in args],
                       os.path.join(d, f"g{i}"))
        with open(os.path.join(GOLD, gold)) as f:
            same = out == f.read()
        log(f"  {label} {gold}: byte-equal {same} "
            f"({time.perf_counter() - t0:.2f} s)")
        check(same, f"dcli golden {gold} differs ({label})")
    out = run_dcli(dcli, dev, mesh_seq, ["-c", path("target2.fa"),
                                         path("query2.fa")],
                   os.path.join(d, "t2"))
    check(out == "", "dcli: headerless target2.fa produced output")
    # BASELINE config 2, from the cwd phase_golden prepared
    out = run_dcli(dcli, dev, mesh_seq, ["-p", "-a", "B62.TXT", "-c",
                                         "PROTEIN2.FA", "PROTEIN1.FA"],
                   os.path.join(d, "b62"), cwd=os.path.join(scratch, "b62"))
    with open(os.path.join(GOLD, "g_prot_b62_blast.txt")) as f:
        same = out == f.read()
    log(f"  {label} g_prot_b62_blast.txt (BLOSUM62 file): byte-equal {same}")
    check(same, f"dcli golden g_prot_b62_blast.txt differs ({label})")


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


def sample_reads(path, n_reads, seed, genome: bytes, read_len=100,
                 err=0.005):
    """Illumina-like FASTQ sampled from `genome`: N-free windows, 0.5 %
    substitutions, half reverse-complemented, Q-ramp qualities.  Returns
    {name: 0-based window start}."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    g = np.frombuffer(genome, np.uint8)
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


def make_target10m(path, seed) -> bytes:
    """1M.fa's sequence followed by TARGET10M_COPIES copies of it, each with
    5 % seeded substitutions (to another base) at its A/C/G/T positions, as
    one FASTA record: near-repeats for the suboptimal score.  Returns the
    sequence."""
    g = np.frombuffer(load_genome(), np.uint8)
    code = np.full(256, -1, np.int16)
    code[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(seed)
    parts = [g]
    for _ in range(TARGET10M_COPIES):
        c = g.copy()
        idx = code[c]
        m = (idx >= 0) & (rng.random(len(c)) < 0.05)
        c[m] = acgt[(idx[m] + rng.integers(1, 4, int(m.sum()))) % 4]
        parts.append(c)
    seq = np.concatenate(parts).tobytes()
    with open(path, "wb") as f:
        f.write(b">chr3_x10\n")
        for i in range(0, len(seq), 60):
            f.write(seq[i:i + 60] + b"\n")
    return seq


def run_sam(torch, dev, target, fq, label, card, truth=None,
            flags=("-c", "-s", "-h", "-r")):
    """cli.main `flags` (default -c -s -h -r) on the card under a
    GcupsCounter: returns the SAM text and the run's numbers (wall ends in
    a synchronize), with the kernel launches the run made."""
    from ssw_tpu_torch import cli, pipeline, profiling
    from ssw_tpu_torch.ops import cuda_sw

    counter = profiling.GcupsCounter()
    cuda_sw.reset_gate_steps()

    def cli_run():
        with pipeline.profiled(counter):
            return run_cli(cli, [*flags, target, fq], dev)

    (rc, out, err), win = launch_window(torch, dev, cli_run)
    wall = win["wall_s"]
    check(rc == 0, f"{label}: cli rc {rc}: {err[-2000:]}")
    hits = total = 0
    for line in out.splitlines():
        if line.startswith("@"):
            continue
        f = line.split("\t")
        total += 1
        if truth is not None:
            hits += int(f[3]) - 1 == truth.get(f[0], -10)
    fwd_s = counter.seconds.get("forward", 0.0)
    res = {
        "card": card, "reads": total, "wall_s": wall,
        "reads_per_s": total / wall, "cells": counter.cells,
        "gcups_forward_phase": counter.cells / fwd_s / 1e9 if fwd_s else 0.0,
        "gcups_wall": counter.cells / wall / 1e9,
        "phase_seconds": counter.seconds,
        "peak_device_bytes": win["peak_device_bytes"],
        "launches": win["launches"], "gated": win["gated"],
        "libraries": win["libraries"],
        "gate_steps_by_depth": cuda_sw.gate_steps(),
    }
    if truth is not None:
        res["begin_at_sampled_pos"] = hits / max(len(truth), 1)
        check(total == len(truth), f"{label}: {total} SAM records for "
              f"{len(truth)} reads")
        check(res["begin_at_sampled_pos"] >= 0.95,
              f"{label}: only {res['begin_at_sampled_pos']:.4f} of reads "
              f"begin at the sampled position")
    log(f"  {label} " + json.dumps(res))
    return out, res


def launch_window(torch, dev, fn):
    """fn() with the launches it made (by kernel, with the gate, by
    library), its peak device memory and its wall, which ends in a
    synchronize."""
    from ssw_tpu_torch.ops import cuda_sw

    counts = (cuda_sw.launch_counts, cuda_sw.gated_counts,
              cuda_sw.library_counts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = [c() for c in counts]
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, gated, libraries = (
        {k: n - then[k] for k, n in c().items() if n != then[k]}
        for c, then in zip(counts, before))
    return out, {"wall_s": wall,
                 "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
                 "launches": launches, "gated": gated,
                 "libraries": libraries}


def check_gated(label, gate_setting, res):
    """A run with GATE = False or None (the card's rule gates no launch)
    launches nothing gated, one with "tiers" launches only gated forward
    kernels."""
    fwd = {k: n for k, n in res["launches"].items() if k != "forward_perread"}
    if gate_setting is False or gate_setting is None:
        check(not res["gated"], f"{label}: gated launches {res['gated']}")
    if gate_setting == "tiers":
        check(res["gated"] == fwd, f"{label}: gated launches "
              f"{res['gated']} of {fwd}")


def phase_config4(torch, dev, scratch, n_reads, card):
    """Config 4 in turns: the full (B, R) suboptimal scan, streaming
    unpacked (PACK = False), streaming with the JAX planner's packing (PACK
    = True: 1024-lane rows of 9 slots) and the card's gate tiers, streaming
    by the default rules (which pack), the default rules without the gate
    (GATE = False) twice and the default again: every SAM output must be
    byte-equal.
    pipeline.STREAM_MIN_COLS and _pack_rule are set from these walls."""
    from ssw_tpu_torch import pipeline

    fq = os.path.join(scratch, "illumina_1M.fastq")
    truth = sample_reads(fq, n_reads, seed=100_000, genome=load_genome())
    target = os.path.join(DATA, "1M.fa")
    runs = {"full scan": (False, None, None, "5"),
            "streaming unpacked": (True, False, None, "5s"),
            "streaming default": (None, None, None, "5p"),
            "streaming GATE=False": (None, None, False, "5p_off"),
            "streaming PACK=True GATE=tiers": (None, True, "tiers", "5j")}
    order = ["full scan", "streaming unpacked",
             "streaming PACK=True GATE=tiers", "streaming default",
             "streaming GATE=False", "streaming GATE=False",
             "streaming default"]
    outs, walls = [], {k: [] for k in runs}
    for label in order:
        stream, pk, gt, tags[0] = runs[label]
        pipeline.STREAM_SUBOPT, pipeline.PACK, pipeline.GATE = stream, pk, gt
        try:
            out, res = run_sam(torch, dev, target, fq, f"config4 {label}",
                               card, truth)
        finally:
            pipeline.STREAM_SUBOPT = pipeline.PACK = pipeline.GATE = None
        check(label == "full scan" or label == "streaming unpacked"
              or res["launches"].get("forward_shared_packed", 0) > 0,
              f"config 4 {label} did not pack")
        check_gated(f"config 4 {label}", gt, res)
        outs.append(out)
        walls[label].append(res["wall_s"])
    check(all(o == outs[0] for o in outs), "config 4: the streaming SAMs "
          "(unpacked, packed) differ from the full scan's")
    mean = {k: sum(w) / len(w) for k, w in walls.items()}
    log(f"  config4: all SAMs byte-equal ({len(outs[0])} bytes); mean walls "
        f"{json.dumps(mean)}")
    return fq, truth, outs[0]


def phase_target10m(torch, dev, scratch, card):
    """A 10 Mbp target, streaming by the default rule (the memory rule
    fires); the first TARGET10M_FULL_READS reads again with the full scan
    (128-read leaves), byte-equal."""
    from ssw_tpu_torch import pipeline
    from ssw_tpu_torch.ops import common

    t0 = time.perf_counter()
    target = os.path.join(scratch, "target_10M.fa")
    seq = make_target10m(target, seed=10)
    fq = os.path.join(scratch, "illumina_10M.fastq")
    truth = sample_reads(fq, TARGET10M_READS, seed=200_000, genome=seq)
    Rp = common.bucket_size(len(seq), 256)
    check(pipeline.STREAM_SUBOPT is None and
          pipeline._use_streaming(Rp, 128),
          "the 10 Mbp target does not stream by the default rule")
    log(f"  target {len(seq)} bp (Rp {Rp}), {TARGET10M_READS} reads, made "
        f"in {time.perf_counter() - t0:.1f} s; leaf rows streaming "
        f"{pipeline._rows_per_leaf(Rp, 128, True)}, full scan "
        f"{pipeline._rows_per_leaf(Rp, 128, False)}")
    tags[0] = "5b"
    out, res = run_sam(torch, dev, target, fq, "10M streaming", card, truth)
    pipeline.GATE = False
    tags[0] = "5b_off"
    try:
        out_off, res_off = run_sam(torch, dev, target, fq,
                                   "10M streaming GATE=False", card, truth)
    finally:
        pipeline.GATE = None
    check(out_off == out, "10 Mbp: GATE = False changed the SAM")
    check_gated("10 Mbp GATE=False", False, res_off)
    # the first reads, alone, with the full scan
    fq_small = os.path.join(scratch, "illumina_10M_first.fastq")
    with open(fq) as f, open(fq_small, "w") as g:
        for i, line in enumerate(f):
            if i >= 4 * TARGET10M_FULL_READS:
                break
            g.write(line)
    lines = out.splitlines(keepends=True)
    head = [ln for ln in lines if ln.startswith("@")]
    recs = [ln for ln in lines if not ln.startswith("@")]
    want = "".join(head + recs[:TARGET10M_FULL_READS])
    pipeline.STREAM_SUBOPT = False
    tags[0] = "5b_full"
    try:
        out_full, res_full = run_sam(torch, dev, target, fq_small,
                                     f"10M full-scan first "
                                     f"{TARGET10M_FULL_READS}", card)
    finally:
        pipeline.STREAM_SUBOPT = None
    check(out_full == want, "10 Mbp: the full scan's SAM differs from the "
          "streaming run's for the same reads")
    log(f"  10M: the full scan's SAM of the first {TARGET10M_FULL_READS} "
        f"reads is byte-equal to the streaming run's; walls default "
        f"{res['wall_s']} s, GATE=False {res_off['wall_s']} s")
    return target, fq, out


ION_GENOME = 4_938_920     # the reference README's Ion Torrent headline:
ION_READS = 1000           # 1000 reads vs a 4,938,920 bp genome, -c -s -h
ION_I32_MIN_LEN = 273      # reads this long run the scaled penalties' int32
                           # tier: L 320 * (40 + 20) + 60 >= 2^14


def make_iontorrent(out_ref, out_fq, genome_len=ION_GENOME,
                    n_reads=ION_READS):
    """The reference README's headline workload (README.md:66-71), as the
    repository's tools/make_data.py makes it: reads of 25-540 bp (normal
    around 200 bp, sd 80), 1 % substitutions, on one strand, vs a random
    genome, from seed 4,938,920.  Returns {read name: 0-based position}."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(4_938_920)
    genome = rng.choice(bases, genome_len).astype(np.uint8)
    with open(out_ref, "wb") as f:
        f.write(b">ecoli_synth\t4938920bp\n")
        for i in range(0, len(genome), 10000):
            f.write(genome[i:i + 10000].tobytes() + b"\n")
    truth = {}
    with open(out_fq, "wb") as f:
        for i in range(n_reads):
            ln = int(np.clip(rng.normal(200, 80), 25, 540))
            pos = int(rng.integers(0, len(genome) - ln))
            rd = genome[pos:pos + ln].copy()
            m = rng.random(ln) < 0.01
            if m.any():
                rd[m] = rng.choice(bases, int(m.sum()))
            f.write(b"@ion_%d_%d\n" % (i, pos))
            f.write(rd.tobytes() + b"\n+\n" + b"I" * ln + b"\n")
            truth[f"ion_{i}_{pos}"] = pos
    return truth


def ion_data(scratch, genome_len=ION_GENOME, n_reads=ION_READS):
    """The Ion Torrent headline's target and reads, made once for phases
    5c and 5d: (target path, FASTQ path, truth)."""
    t0 = time.perf_counter()
    target = os.path.join(scratch, "ecoli_synth.fa")
    fq = os.path.join(scratch, "iontorrent_1k.fastq")
    truth = make_iontorrent(target, fq, genome_len, n_reads)
    log(f"  target {genome_len} bp, {n_reads} reads, made in "
        f"{time.perf_counter() - t0:.1f} s")
    return target, fq, truth


def phase_iontorrent(torch, dev, scratch, card, ion):
    """The Ion Torrent headline at full size, -c -s -h, in turns: the
    default rules (the dual tier, every group packed by the card's rule,
    the gate by its rule), the default without the gate (GATE = False),
    unpacked with the dual tier (PACK = False), the re-run route (PACK =
    False, DUAL = False), the JAX planner's packing (PACK = True: it packs
    the L = 192 group), these three with the card's gate tiers everywhere
    (GATE = "tiers"), GATE = False and the default again; byte-equal SAMs.
    Then the reads of ION_I32_MIN_LEN bp and more with the default
    penalties scaled by 20 (-m 40 -x 40 -o 60 -e 20: the same alignments,
    outside the int16 tier's bound), dual and the re-run route, by the
    card's rule (the int32 wavefront) and with the card's gate tiers (the
    column-scan body)."""
    from ssw_tpu_torch import pipeline

    target, fq, truth = ion
    outs, res = [], {}
    for i, (label, pk, du, gt) in enumerate((
            ("default", None, None, None), ("GATE=False", None, None, False),
            ("unpacked dual GATE=tiers", False, None, "tiers"),
            ("re-run route GATE=tiers", False, False, "tiers"),
            ("PACK=True GATE=tiers", True, None, "tiers"),
            ("GATE=False", None, None, False), ("default", None, None, None))):
        pipeline.PACK, pipeline.DUAL, pipeline.GATE = pk, du, gt
        tags[0] = f"5c{i}"
        try:
            out, r = run_sam(torch, dev, target, fq, f"ion {label}", card,
                             truth, flags=("-c", "-s", "-h"))
        finally:
            pipeline.PACK = pipeline.DUAL = pipeline.GATE = None
        check_gated(f"Ion Torrent {label}", gt, r)
        outs.append(out)
        res.setdefault(label, []).append(r)
    check(all(o == outs[0] for o in outs), "Ion Torrent: the SAMs of the "
          "default, GATE=False, unpacked dual, re-run, PACK=True and default "
          "runs differ")
    for label in ("default", "PACK=True GATE=tiers"):
        check(res[label][0]["launches"].get("forward_shared_packed_dual", 0)
              > 0, f"Ion Torrent {label} did not pack")
    walls = {k: [r["wall_s"] for r in v] for k, v in res.items()}
    log(f"  ion: seven SAMs byte-equal ({len(outs[0])} bytes); walls "
        f"{json.dumps(walls)}")
    # int32 tier: long reads, scaled penalties
    fq32 = os.path.join(scratch, "iontorrent_long.fastq")
    with open(fq) as f, open(fq32, "w") as g:
        lines = f.read().splitlines(keepends=True)
        for k in range(0, len(lines), 4):
            if len(lines[k + 1]) - 1 >= ION_I32_MIN_LEN:
                g.writelines(lines[k:k + 4])
    flags = ("-m", "40", "-x", "40", "-o", "60", "-e", "20", "-c", "-s",
             "-h")
    outs32, walls32 = [], {}
    for i, (du, gt) in enumerate(((None, None), (False, None),
                                  (None, "tiers"), (False, "tiers"))):
        # the unpacked int32 tier: by the card's rule (the wavefront), then
        # with the card's gate tiers everywhere (the column-scan body)
        pipeline.PACK, pipeline.DUAL, pipeline.GATE = False, du, gt
        tags[0] = f"5c_i32_{i}"
        label = (f"ion >= {ION_I32_MIN_LEN} bp x20 penalties "
                 + ("dual" if du is None else "re-run route")
                 + f" GATE={gt}")
        try:
            out, r = run_sam(torch, dev, target, fq32, label, card, None,
                             flags=flags)
        finally:
            pipeline.PACK = pipeline.DUAL = pipeline.GATE = None
        check_gated("Ion Torrent x20", gt, r)
        outs32.append(out)
        walls32[label] = r["wall_s"]
        if du is None:
            check(r["launches"].get("forward_shared_dual", 0) > 0,
                  "scaled penalties did not take the int32 dual tier")
    recs = [ln.split("\t") for ln in outs32[0].splitlines()
            if not ln.startswith("@")]
    hits = sum(int(f[3]) - 1 == truth.get(f[0], -10) for f in recs)
    check(all(o == outs32[0] for o in outs32) and recs
          and hits >= 0.95 * len(recs),
          "Ion Torrent, scaled penalties: the dual and re-run routes, gated "
          "or not, differ, or reads are off their sampled position")
    log(f"  ion x20 penalties: {len(recs)} reads, four SAMs byte-equal "
        f"(dual and re-run route, the rule and GATE=tiers), "
        f"{hits / len(recs):.4f} at the sampled position; walls "
        f"{json.dumps(walls32)}")
    return res, outs[0]


ION_PENALTIES2 = ("-m", "1", "-x", "3", "-o", "5", "-e", "2")


def phase_iontorrent_o5e2(torch, dev, card, ion):
    """The reference README's second configuration of the Ion Torrent
    headline: the same reads and genome with -m 1 -x 3 -o 5 -e 2 -c -s -h,
    the only full-size run where the JAX package's gate_plan turns the gate
    on.  In turns: the card's rule (GATE = None: no gate, every launch the
    wavefront), no gate, the JAX plan (GATE = True: the column-scan bodies,
    gated), the card's rule again; byte-equal SAMs, >= 95 % of reads at the
    sampled position."""
    from ssw_tpu_torch import pipeline

    target, fq, truth = ion
    outs, res = [], {}
    for i, (label, gt) in enumerate((("GATE=None", None),
                                     ("GATE=False", False),
                                     ("GATE=True", True),
                                     ("GATE=None", None))):
        pipeline.GATE = gt
        tags[0] = f"5d{i}"
        try:
            out, r = run_sam(torch, dev, target, fq, f"ion o5e2 {label}",
                             card, truth, flags=ION_PENALTIES2
                             + ("-c", "-s", "-h"))
        finally:
            pipeline.GATE = None
        check_gated(f"Ion Torrent o5e2 {label}", gt, r)
        check(gt is not True or r["gated"], f"Ion Torrent o5e2 {label}: the "
              f"gate did not run")
        outs.append(out)
        res.setdefault(label, []).append(r)
    check(all(o == outs[0] for o in outs), "Ion Torrent o5e2: the SAMs of "
          "GATE None, False, True and None differ")
    walls = {k: [r["wall_s"] for r in v] for k, v in res.items()}
    log(f"  ion o5e2: four SAMs byte-equal ({len(outs[0])} bytes); walls "
        f"{json.dumps(walls)}")
    return res


CONFIG5_READS = 2048       # phase 5e: the first reads of phase 5b's
CONFIG5_SEQ = 4            # over a mesh of [card] * 4, --mesh-seq 4


def phase_config5(torch, dev, scratch, card, t10):
    """BASELINE config 5 on one card: phase 5b's 10 Mbp target and the
    first CONFIG5_READS of its reads, -c -s -h -r, through dcli align with
    the target sharded over a mesh of [card] * 4 (--mesh-seq 4, 1024-read
    batches: the JAX package's sequence-parallel path, halo re-compute and
    best-hit merge), then dcli merge: byte-equal to phase 5b's streaming
    SAM for the same reads."""
    from ssw_tpu_torch import dcli, pipeline, profiling
    from ssw_tpu_torch.ops import cuda_sw

    target, fq, sam5b = t10
    fq_small = os.path.join(scratch, "illumina_10M_config5.fastq")
    with open(fq) as f, open(fq_small, "w") as g:
        for i, line in enumerate(f):
            if i >= 4 * CONFIG5_READS:
                break
            g.write(line)
    lines = sam5b.splitlines(keepends=True)
    want = "".join([ln for ln in lines if ln.startswith("@")]
                   + [ln for ln in lines
                      if not ln.startswith("@")][:CONFIG5_READS])
    prefix = os.path.join(scratch, "config5")
    counter = profiling.GcupsCounter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = cuda_sw.launch_counts()
    gated_before = cuda_sw.gated_counts()
    t0 = time.perf_counter()
    err = io.StringIO()
    with pipeline.profiled(counter):
        rc = dcli.main(["align", "-c", "-s", "--header", "-r",
                        "--batch-size", "1024", "--mesh-seq",
                        str(CONFIG5_SEQ), "--out", prefix, target, fq_small],
                       err=err, devices=[dev] * CONFIG5_SEQ)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, f"config 5: dcli align rc {rc}: {err.getvalue()[-2000:]}")
    peak = torch.cuda.max_memory_allocated(dev)
    merged = prefix + ".sam"
    check(dcli.main(["merge", "--out", merged, prefix + ".part0"],
                    err=io.StringIO()) == 0, "config 5: dcli merge failed")
    with open(merged) as f:
        same = f.read() == want
    res = {
        "card": card, "reads": CONFIG5_READS, "mesh": f"1 x {CONFIG5_SEQ}",
        "wall_s": wall, "reads_per_s": CONFIG5_READS / wall,
        "cells": counter.cells, "gcups_wall": counter.cells / wall / 1e9,
        "phase_seconds": counter.seconds, "peak_device_bytes": peak,
        "launches": {k: n - before[k] for k, n in
                     cuda_sw.launch_counts().items() if n != before[k]},
        "gated": {k: n - gated_before[k] for k, n in
                  cuda_sw.gated_counts().items() if n != gated_before[k]},
        "byte_equal_to_5b": same,
    }
    log("  config5 " + json.dumps(res))
    check(same, "config 5: the sharded SAM differs from phase 5b's "
          "streaming SAM for the same reads")
    check(res["launches"].get("forward_shared_i16_owned", 0) > 0,
          "config 5 did not run the owned kernel")
    return res


DCLI_RUNNER = """
import sys
sys.path.insert(0, {root!r})
from ssw_tpu_torch import dcli
sys.exit(dcli.main({args!r}))
"""


def free_coordinator() -> str:
    """A free local port for a gloo rendezvous, as HOST:PORT."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


def phase_two_process(scratch):
    """BASELINE config 3 (54mer_hap1_1.100.fastq vs 100k.fa -r -c -s -h) as
    two dcli align processes on the card that meet in a gloo rendezvous
    (--coordinator 127.0.0.1:<free port>), then dcli merge: equal to the
    reference-binary capture.  Both processes are killed if they outlive
    their time limit."""
    from ssw_tpu_torch import dcli

    coord = free_coordinator()
    prefix = os.path.join(scratch, "two_proc")
    procs = []
    t0 = time.perf_counter()
    for host in (0, 1):
        args = ["align", "-r", "-c", "-s", "--header", "--coordinator",
                coord, "--num-hosts", "2", "--host-id", str(host),
                "--batch-size", "32", "--out", prefix,
                os.path.join(DATA, "100k.fa"),
                os.path.join(DATA, "54mer_hap1_1.100.fastq")]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", DCLI_RUNNER.format(root=ROOT, args=args)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            outs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for host, (rc, err) in enumerate(outs):
        log(f"  host {host}: rc {rc}; {err.strip().splitlines()[-1:]}")
        check(rc == 0, f"two-process dcli host {host}: rc {rc}: "
              f"{err[-2000:]}")
    merged = prefix + ".sam"
    check(dcli.main(["merge", "--out", merged, prefix + ".part0",
                     prefix + ".part1"], err=io.StringIO()) == 0,
          "two-process dcli merge failed")
    with open(merged) as f, open(os.path.join(
            GOLD, "g_54mer_100k_sam.txt")) as g:
        same = f.read() == g.read()
    log(f"  two processes merged: byte-equal to g_54mer_100k_sam.txt "
        f"{same} ({time.perf_counter() - t0:.1f} s)")
    check(same, "two-process dcli output differs from the golden")


# ----------------------------------------------------------- phases 4f, 5g

EX_REF = "CAGCCTTTCTGACCCGGAAATCAAAATAGGCACAACAAA"  # ref: src/example.cpp
EX_QUERY = "CTGAGCCGGTAAATC"
PYSSW_GOLDENS = [
    (["-c", "r1.fa", "r1_query.fq"], "g_pyssw_r1_blast.txt"),
    (["-c", "-s", "-header", "r1.fa", "r1_query.fq"], "g_pyssw_r1_sam.txt"),
    (["-c", "-p", "pRef.fa", "pRead.fa"], "g_pyssw_prot_blast.txt"),
]
FE_CPU_READS = 64          # phase 5g: reads also run with device="cpu"
FE_CPU_REF = 100_000       # against the first bases of 1M.fa
FE_BRIDGE_READS = 256      # phase 5g: one batched bridge request vs 100k.fa
FE_LATENCY_CALLS = 200     # Aligner.align calls timed on the example pair


def bridge_env():
    """The environment a client gives the worker: no platform variable,
    so the worker takes the card."""
    env = dict(os.environ)
    env.pop("SSW_TPU_BRIDGE_PLATFORM", None)
    env.pop("PYTHONPATH", None)
    return env


def start_worker(err_path):
    """A bridge worker on the card; its stderr goes to err_path (a pipe
    nobody reads could fill and stall it)."""
    with open(err_path, "w") as err:
        w = subprocess.Popen(
            [sys.executable, "-m", "ssw_tpu_torch.bridge"], cwd=ROOT,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err,
            text=True, env=bridge_env())
    w.err_path = err_path
    return w


def worker_err(worker):
    with open(worker.err_path) as f:
        return f.read()[-2000:]


def ask(worker, line):
    """One request line to a worker; its response line."""
    worker.stdin.write(line + "\n")
    worker.stdin.flush()
    got = worker.stdout.readline()
    if not got:
        worker.kill()
        worker.communicate()
        raise SmokeFailure(f"bridge worker died: {worker_err(worker)}")
    return got


def stop_worker(worker):
    """Shut the worker down, or kill it if it does not exit; returns its
    exit code and the end of its stderr."""
    try:
        worker.communicate('{"op":"shutdown"}\n', timeout=60)
    except subprocess.TimeoutExpired:
        worker.kill()
        worker.communicate()
    return worker.returncode, worker_err(worker)


def bridge_request(rid, reads, ref, mat, flag=0x0F, batch=False):
    """A request line as the clients send it (compact JSON), gap open 3,
    extend 1, mask length max(15, len/2) as the Java client's."""
    from ssw_tpu_torch import bridge

    def one(read, i):
        return {"id": i, "read": [int(x) for x in read], "ref": ref,
                "matrix": [int(x) for x in mat.reshape(-1)],
                "n": mat.shape[0], "gap_open": 3, "gap_extend": 1,
                "flag": flag, "mask_len": max(15, len(read) // 2)}
    if not batch:
        return bridge._dumps(one(reads[0], rid))
    return bridge._dumps({"id": rid, "batch": [one(r, None) for r in reads]})


def check_responses(label, lines, bad=()):
    """Every response line but those at `bad` (bad-json lines) carries no
    error; returns the parsed responses."""
    out = []
    for i, line in enumerate(lines):
        if i in bad:
            check(line.strip() == '{"error":"bad json"}',
                  f"{label}: line {i}: {line[:200]}")
        else:
            check('"error"' not in line, f"{label}: {line[:2000]}")
        out.append(json.loads(line))
    return out


def phase_front_ends_golden(scratch):
    """The four front ends on the card at golden size, each with its
    default device: Aligner/Filter and CSsw on the reference example pair,
    pyssw.main byte-equal to the three pyssw goldens, a `python -m
    ssw_tpu_torch.bridge` worker (no platform variable) on the example
    pair, the batched form and a bad line, and the C client of bindings/c
    through the launcher.  Every launch of this process in the phase runs
    a wavefront library."""
    from ssw_tpu_torch import api, bridge, pyssw, ssw_lib
    from ssw_tpu_torch.core.encoding import NT_TABLE, dna_matrix
    from ssw_tpu_torch.ops import cuda_sw

    t0 = time.perf_counter()
    # the worker reaches the card while the rest runs
    worker = start_worker(os.path.join(scratch, "worker_4f.err"))
    libs_before = cuda_sw.library_counts()
    try:
        flag, al = api.Aligner().align(EX_QUERY, EX_REF, api.Filter(),
                                       mask_len=15)
        got = (al.sw_score, al.sw_score_next_best, al.ref_begin, al.ref_end,
               al.query_begin, al.query_end, al.ref_end_next_best,
               al.mismatches, al.cigar_string, flag)
        log(f"  Aligner example pair: {got}")
        check(got == (21, 8, 8, 21, 0, 14, 4, 2, "4=1X4=1I5=", 0),
              f"Aligner example pair: {got}")

        def enc(s):
            return [int(NT_TABLE[ord(c)]) for c in s]

        mat = dna_matrix(2, 2)
        flat = [int(x) for x in mat.reshape(-1)]
        ssw = ssw_lib.CSsw("/ignored/libssw.so")
        q, r = enc(EX_QUERY), enc(EX_REF)
        prof = ssw.ssw_init(q, len(q), flat, 5, 2)
        res = ssw.ssw_align(prof, r, len(r), 3, 1, 0x0F, 0, 2 ** 15, 15)
        check(bool(res), "CSsw: NULL result on the example pair")
        c = res.contents
        ar = api.align(np.asarray(q), np.asarray(r), 3, 1, mat=mat)
        got = (c.nScore, c.nScore2, c.nRefBeg, c.nRefEnd, c.nQryBeg,
               c.nQryEnd, c.nRefEnd2, list(c.sCigar))
        check(c.nScore == 21 and got == (
            ar.score1, ar.score2, ar.ref_begin1, ar.ref_end1,
            ar.read_begin1, ar.read_end1, ar.ref_end2, list(ar.cigar)),
            f"CSsw example pair: {got} vs api.align {ar}")
        ssw.align_destroy(res)
        ssw.init_destroy(prof)
        check(not res and not prof, "CSsw: destroy left the pointers set")
        big = ssw.ssw_init(enc("A" * 200), 200, flat, 5, 0)
        null = ssw.ssw_align(big, enc("A" * 300), 300, 3, 1, 0, 0, 2 ** 15,
                             15)
        check(not null, "CSsw: score_size 0 overflow did not return NULL")
        log(f"  CSsw example pair: {got}; score_size 0 overflow: NULL")

        for args, gold in PYSSW_GOLDENS:
            out = io.StringIO()
            rc = pyssw.main([data_path(a) for a in args], out=out,
                            err=io.StringIO())
            with open(os.path.join(GOLD, gold)) as f:
                same = out.getvalue() == f.read()
            log(f"  pyssw {gold}: rc {rc} byte-equal {same}")
            check(rc == 0 and same, f"pyssw golden {gold} differs")

        # the worker: example pair, batched form, a bad line
        q_codes = encode_dna(EX_QUERY.encode())
        r_codes = encode_dna(EX_REF.encode())
        ref = [int(x) for x in r_codes]
        reads = [q_codes, r_codes[5:30], np.random.default_rng(4).integers(0, 4, 33)]
        lines = [bridge_request(0, reads, ref, mat, flag=1),
                 bridge_request(1, reads, ref, mat, batch=True),
                 "this is not json"]
        t1 = time.perf_counter()
        answers = [ask(worker, line) for line in lines]
        resp = check_responses("bridge worker", answers, bad=(2,))
        rc, err = stop_worker(worker)
        check(rc == 0, f"bridge worker rc {rc}: {err}")
        r0 = resp[0]["result"]
        check((r0["score1"], r0["ref_begin1"], r0["ref_end1"],
               r0["read_begin1"], r0["read_end1"], r0["cigar_string"]) ==
              (21, 8, 21, 0, 14, "9M1I5M"), f"bridge example pair: {r0}")
        inproc = io.StringIO()
        bridge.serve(io.StringIO("\n".join(lines) + "\n"), inproc)
        check(inproc.getvalue() == "".join(answers),
              "bridge: the worker's responses differ from serve in-process")
        want = [bridge._result_dict(x) for x in api.align_batch(
            reads, r_codes, mat, 3, 1, mask_len=[max(15, len(x) // 2)
                                             for x in reads])]
        check(resp[1]["result"] == want,
              "bridge: the batched form differs from api.align_batch")
        log(f"  bridge worker (no platform variable): example pair "
            f"{r0['cigar_string']} score {r0['score1']}, batch of "
            f"{len(reads)} equal to api.align_batch, bad line answered; "
            f"three requests {time.perf_counter() - t1:.2f} s")
    finally:
        if worker.poll() is None:
            worker.kill()
            worker.communicate()
    after = cuda_sw.library_counts()
    libs = {k: n - libs_before[k] for k, n in after.items()
            if n != libs_before[k]}
    check(libs.get("sw_wave_perread", 0) > 0
          and all(k.startswith("sw_wave_") for k in libs),
          f"front ends: launches by library {libs}")
    log(f"  in-process launches by library: {json.dumps(libs)}")

    # the C client through the launcher
    gcc = shutil.which("gcc") or shutil.which("cc")
    check(gcc is not None, "no C compiler for bindings/c")
    exe = os.path.join(scratch, "example_c")
    src = os.path.join(ROOT, "bindings", "c")
    b = subprocess.run([gcc, "-O2", "-Wall", "-o", exe,
                        os.path.join(src, "example_c.c"),
                        os.path.join(src, "ssw_client.c")],
                       capture_output=True, text=True, timeout=120)
    check(b.returncode == 0, f"gcc bindings/c: {b.stderr[-2000:]}")
    launcher = bridge.write_launcher(os.path.join(scratch, "launch_bridge"))
    t1 = time.perf_counter()
    r = subprocess.run([exe, ROOT, launcher], capture_output=True, text=True,
                       timeout=300, env=bridge_env())
    check(r.returncode == 0, f"C client rc {r.returncode}: "
          f"{r.stderr[-2000:]}")
    want = ("optimal_alignment_score: 21", "sub-optimal_alignment_score: 8",
            "target_begin: 9", "target_end: 22", "query_begin: 1",
            "query_end: 15", "cigar: 9M1I5M")
    missing = [w for w in want if w not in r.stdout]
    check(not missing, f"C client output lacks {missing}: {r.stdout}")
    log(f"  C client through the launcher: {r.stdout.strip()!r} "
        f"({time.perf_counter() - t1:.1f} s with the worker's start)")
    log(f"  front ends at golden size in {time.perf_counter() - t0:.1f} s")


def read_fastq(path):
    names, seqs = [], []
    with open(path) as f:
        for i, line in enumerate(f):
            if i % 4 == 0:
                names.append(line[1:].split()[0])
            elif i % 4 == 1:
                seqs.append(line.strip())
    return names, seqs


def sam_fields(text, pyssw_layout=False):
    """{qname: (FLAG, RNAME, POS, [(tag, value)] of AS and ZS)} of SAM
    records.  pyssw breaks a reverse-strand record with qualities after
    its QUAL (the reference's missing trailing comma): there a line
    starting with a tab continues the record before it."""
    import re

    recs = []
    for line in text.splitlines():
        if line.startswith("@"):
            continue
        if pyssw_layout and line.startswith("\t") and recs:
            recs[-1] += line
        else:
            recs.append(line)
    out = {}
    for rec in recs:
        f = rec.split("\t")
        out[f[0]] = (f[1].strip(), f[2], f[3],
                     re.findall(r"(AS|ZS):i:(-?\d+)", rec))
    return out


def phase_front_ends_config4(torch, scratch, card, fq, truth, cli_sam):
    """Phase 5's reads through the front ends on the card: api.Aligner
    against the 1 Mbp reference (set once), the share of forward-strand
    reads at their sampled position, 64 reads against 100 kbp on the card
    and on the CPU equal field for field; pyssw -c -s -r against phase 5's
    cli SAM (qname, FLAG, RNAME, POS, AS, ZS; the reverse strand wins
    pyssw's ties); one batched bridge request of 256 reads against 100k.fa
    to a worker on the card, equal to api.align_batch in-process.  Wall,
    reads/s and host seconds outside the pipeline's phases of each, and
    the latency of one Aligner.align."""
    from ssw_tpu_torch import api, bridge, pipeline, profiling, pyssw
    from ssw_tpu_torch.core.encoding import dna_matrix

    # the worker reaches the card while the Aligner runs
    worker = start_worker(os.path.join(scratch, "worker_5g.err"))
    numbers = {}

    def timed(label, fn, reads):
        counter = profiling.GcupsCounter()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with pipeline.profiled(counter):
            out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        inside = sum(counter.seconds.values())
        numbers[label] = {
            "card": card, "reads": reads, "wall_s": wall,
            "reads_per_s": reads / wall,
            "host_s_outside_phases": wall - inside,
            "host_share": (wall - inside) / wall,
            "phase_seconds": counter.seconds}
        log(f"  {label} " + json.dumps(numbers[label]))
        return out

    try:
        names, seqs = read_fastq(fq)
        genome = load_genome().decode()

        # api.Aligner: the 1 Mbp reference once, then every read
        aligner = api.Aligner()
        aligner.set_reference_sequence(genome)
        flags, als = timed("Aligner.align_batch",
                           lambda: aligner.align_batch(seqs), len(seqs))
        fwd = [(n, a) for n, a in zip(names, als) if n.endswith("_f")]
        share = sum(a.ref_begin == truth[n] for n, a in fwd) / len(fwd)
        log(f"  Aligner: {len(fwd)} forward-strand reads, share at the "
            f"sampled position {share}")
        check(share >= 0.95, f"Aligner: only {share} of the forward reads "
              f"begin at the sampled position")
        near = [i for i, n in enumerate(names)
                if truth[n] < FE_CPU_REF - 200][:FE_CPU_READS]
        sub = [seqs[i] for i in near]
        outs = []
        for device in (None, "cpu"):
            a = api.Aligner(device=device)
            a.set_reference_sequence(genome[:FE_CPU_REF])
            t0 = time.perf_counter()
            f_, a_ = a.align_batch(sub)
            outs.append((f_, [vars(x) for x in a_]))
            log(f"  Aligner {len(sub)} reads vs {FE_CPU_REF} bp on "
                f"{device or 'the card'}: {time.perf_counter() - t0:.2f} s")
        check(len(sub) == FE_CPU_READS and outs[0] == outs[1],
              "Aligner: the card's alignments differ from the CPU's")

        # one Aligner.align on the example pair
        ex = api.Aligner()
        for _ in range(10):
            ex.align(EX_QUERY, EX_REF)
        lat = []
        for _ in range(FE_LATENCY_CALLS):
            t0 = time.perf_counter()
            ex.align(EX_QUERY, EX_REF)
            lat.append(time.perf_counter() - t0)
        lat.sort()
        numbers["Aligner.align latency"] = {
            "card": card, "calls": FE_LATENCY_CALLS,
            "median_ms": lat[len(lat) // 2] * 1e3,
            "p90_ms": lat[int(len(lat) * 0.9)] * 1e3}
        log("  Aligner.align latency (example pair) "
            + json.dumps(numbers["Aligner.align latency"]))

        # pyssw -c -s -r against phase 5's cli SAM
        out = io.StringIO()
        rc = timed("pyssw -c -s -r", lambda: pyssw.main(
            ["-c", "-s", "-r", os.path.join(DATA, "1M.fa"), fq], out=out,
            err=io.StringIO()), len(seqs))
        check(rc == 0, f"pyssw rc {rc}")
        ours, theirs = sam_fields(out.getvalue(), True), sam_fields(cli_sam)
        check(list(ours) == list(theirs) == names,
              "pyssw: SAM records differ from the reads")
        ties = 0
        for n in names:
            o, t = ours[n], theirs[n]
            if o == t:
                continue
            check((o[0], t[0]) == ("16", "0") and
                  dict(o[3]).get("AS") == dict(t[3]).get("AS"),
                  f"pyssw: {n}: {o} vs cli {t}")
            ties += 1
        numbers["pyssw -c -s -r"]["strand_ties"] = ties
        log(f"  pyssw: every record's qname, FLAG, RNAME, POS, AS and ZS "
            f"equal to the cli's but {ties} strand ties (pyssw takes the "
            f"reverse strand)")

        # one batched bridge request to the worker on the card
        with open(os.path.join(DATA, "100k.fa"), "rb") as f:
            ref100k = encode_dna(b"".join(
                ln.strip() for ln in f if not ln.startswith(b">")))
        mat = dna_matrix(2, 2)
        ref = [int(x) for x in ref100k]
        reads = [encode_dna(s.encode()) for s in seqs[:FE_BRIDGE_READS]]
        t0 = time.perf_counter()
        line = bridge_request(7, reads, ref, mat, batch=True)
        enc_s = time.perf_counter() - t0
        check_responses("bridge warm-up", [ask(worker, bridge_request(
            0, reads, ref[:1000], mat))])
        t0 = time.perf_counter()
        answer = ask(worker, line)
        wall = time.perf_counter() - t0
        resp = check_responses("bridge batch", [answer])[0]
        rc, err = stop_worker(worker)
        check(rc == 0, f"bridge worker rc {rc}: {err}")
        want = [bridge._result_dict(r) for r in api.align_batch(
            reads, ref100k, mat, 3, 1, mask_len=[max(15, len(r) // 2)
                                                 for r in reads])]
        check(resp["id"] == 7 and resp["result"] == want,
              "bridge: the worker's batch differs from api.align_batch")
        numbers["bridge worker"] = {
            "card": card, "reads": len(reads), "wall_s": wall,
            "reads_per_s": len(reads) / wall, "request_bytes": len(line),
            "client_encode_s": enc_s}
        log("  bridge worker " + json.dumps(numbers["bridge worker"]))
        inproc = io.StringIO()
        timed("bridge serve in-process", lambda: bridge.serve(
            io.StringIO(line + "\n"), inproc), len(reads))
        check(inproc.getvalue() == answer, "bridge: serve in-process "
              "differs from the worker")
    finally:
        if worker.poll() is None:
            worker.kill()
            worker.communicate()
    return numbers


# ------------------------------------------------------------- phases 5h, 5i

# the SAM body of BASELINE config 4 at its 100,000 reads (tools/make_data.py's
# FASTQ, -c -s -h -r vs 1M.fa), as the JAX package's
# tools/run_config4_full.py recorded it (BENCH.md, config-4 FULL run)
CONFIG4_FULL_SHA256 = ("3602ab95b928f9449848bfca3ed23f0c2f9b61eaa9f4227375d7"
                       "6b82c8e01aee")


def sampled_position_share(sam: str, strand=None) -> tuple[float, int]:
    """The share of SAM records (of reads of `strand`, f or r, or all) at
    the 0-based position in their name, @sim_<i>_<pos>_<f|r>; and their
    count."""
    hits = n = 0
    for line in sam.splitlines():
        if line.startswith("@"):
            continue
        f = line.split("\t", 4)
        name = f[0].split("_")
        if strand is not None and name[3] != strand:
            continue
        n += 1
        hits += int(f[3]) - 1 == int(name[2])
    return hits / max(n, 1), n


def phase_config4_full(torch, dev, scratch, card):
    """BASELINE config 4 at its 100,000 reads: tools/make_data.py's FASTQ
    (run unedited, as a subprocess), then the port's run_config4_full by
    the default rules (streaming, packed) and with STREAM_SUBOPT = False
    (the full scan), in turns, one run each.  Both SAM bodies byte-equal,
    their SHA-256 the JAX package's recorded one, and >= 0.95 of the reads
    at the position in their name (@sim_<i>_<pos>_<f|r>, 0-based)."""
    from ssw_tpu_torch import pipeline
    from ssw_tpu_torch.tools import run_config4_full

    data = os.path.join(scratch, "bench_data")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                     "make_data.py"), data],
                       capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"tools/make_data.py rc {r.returncode}: "
          f"{r.stderr[-2000:]}")
    fq = os.path.join(data, "100k_illumina1.fastq.gz")
    log(f"  tools/make_data.py {data}: {time.perf_counter() - t0:.1f} s; "
        f"{r.stdout.strip()}")
    ref = os.path.join(DATA, "1M.fa")
    bodies, numbers = [], {}
    for label, stream, tag in (("default rules", None, "5h"),
                               ("full scan", False, "5h_full")):
        tags[0] = tag
        pipeline.STREAM_SUBOPT = stream
        try:
            (res, sam), win = launch_window(
                torch, dev, lambda: run_config4_full.run(ref, fq,
                                                         device=dev))
        finally:
            pipeline.STREAM_SUBOPT = None
        check(res["rc"] == 0, f"config 4 full, {label}: rc {res['rc']}")
        body = run_config4_full.sam_body(sam)
        share, n_records = sampled_position_share(body)
        inside = sum(res["phases_s"].values())
        res = {**win, **res, "card": card, "records": n_records,
               "sam_body_bytes": len(body),
               "begin_at_sampled_pos": share,
               "host_s_outside_phases": res["wall_s"] - inside,
               "host_share": (res["wall_s"] - inside) / res["wall_s"]}
        log(f"  config4 full {label} " + json.dumps(res))
        check(n_records == run_config4_full.FULL_READS,
              f"config 4 full, {label}: {n_records} SAM records")
        check(res["begin_at_sampled_pos"] >= 0.95,
              f"config 4 full, {label}: only "
              f"{res['begin_at_sampled_pos']:.4f} of the reads at their "
              f"sampled position")
        bodies.append(body)
        numbers[label] = res
    check(bodies[0] == bodies[1], "config 4 full: the streaming and full "
          "scan SAM bodies differ")
    sha = numbers["default rules"]["sam_body_sha256"]
    log(f"  config4 full: both SAM bodies byte-equal "
        f"({len(bodies[0])} bytes), sha256 {sha}, recorded "
        f"{CONFIG4_FULL_SHA256}")
    check(sha == CONFIG4_FULL_SHA256, "config 4 full: the SAM body's "
          "SHA-256 differs from the JAX package's recorded one")
    return numbers


PROTEIN_ROUTES = {  # label: (pipeline.PACK, pipeline.STREAM_SUBOPT, tag)
    "pack 0": (False, None, "5i0"),
    "pack 1": (True, None, "5i1"),
    "streaming": (None, True, "5is"),
    "streaming unpacked": (False, True, "5isu"),
}


def phase_protein(torch, dev, card):
    """BASELINE config 2 at scale, the port's bench_protein workload (512
    reads of 30-150 aa, a 200,000-aa proteome, BLOSUM50, -o3 -e1: the
    quirk): PACK 0 and 1 as the JAX tool runs them (these leaves do not
    stream, so both take the int32 base mode), and STREAM_SUBOPT = True by
    the card's pack rule (the packed quirk path) and unpacked (the int32
    blockmax mode), in turns a b c d d c b a.  Every read's AlignResult
    equal across routes; every forward launch in the wavefront libraries
    (quirk_wave_exact holds at every L), the packed quirk path and the
    int32 quirk modes each launched."""
    from ssw_tpu_torch import pipeline, profiling
    from ssw_tpu_torch.ops import common, cuda_sw
    from ssw_tpu_torch.tools import bench_protein

    reads, ref, mat = bench_protein.workload()
    max_sub = int(np.abs(mat).max())
    Ls = sorted({common.bucket_size(common.pad_total(len(r), False), 64)
                 for r in reads})
    check(all(cuda_sw.quirk_wave_exact(L, max_sub) for L in Ls),
          f"the quirk wavefront is not exact at L {Ls}")
    log(f"  {len(reads)} reads, L buckets {Ls}, proteome {len(ref)} aa, "
        f"max_sub {max_sub}; leaf streams by the rule: "
        f"{pipeline._use_streaming(common.bucket_size(len(ref), 256), 128)}")
    bench_protein.run(reads, ref, mat, False, dev)  # warm
    order = list(PROTEIN_ROUTES)
    first, numbers = None, {k: [] for k in order}
    for label in order + order[::-1]:
        pack, stream, tags[0] = PROTEIN_ROUTES[label]
        pipeline.STREAM_SUBOPT = stream
        counter = profiling.GcupsCounter()
        try:
            with pipeline.profiled(counter):
                (outs, wall), win = launch_window(
                    torch, dev, lambda: bench_protein.run(reads, ref, mat,
                                                          pack, dev))
        finally:
            pipeline.STREAM_SUBOPT = None
        res = bench_protein.summary(pack, reads, len(ref), outs, wall)
        inside = sum(counter.seconds.values())
        res.update(win, card=card, route=label, wall_s=wall,
                   phase_seconds=counter.seconds,
                   host_s_outside_phases=wall - inside,
                   host_share=(wall - inside) / wall)
        log(f"  protein {label} " + json.dumps(res))
        numbers[label].append(res)
        got = [vars(a) for a in outs]
        first = first or got
        check(got == first,
              f"protein {label}: AlignResults differ from route {order[0]}")
        libs = res["libraries"]
        check(not any(k in libs for k in ("sw_forward", "sw_forward_packed",
                                          "sw_perread")),
              f"protein {label}: a column-scan body ran: {libs}")
        want = {"pack 0": "forward_shared", "pack 1": "forward_shared",
                "streaming": "forward_shared_packed",
                "streaming unpacked": "forward_shared_blockmax"}[label]
        check(res["launches"].get(want, 0) > 0 and
              libs.get("sw_wave_perread", 0) > 0,
              f"protein {label}: {want} or the per-read wavefront did not "
              f"launch: {res['launches']}")
    log("  protein: every route's AlignResults equal; mean walls "
        + json.dumps({k: sum(r["wall_s"] for r in v) / len(v)
                      for k, v in numbers.items()}))
    return numbers


# the phase label the recorders file each kernel call under
tags = ["3"]


class Recorder:
    """Wraps a kernel wrapper to keep, per kernel and phase, the inputs of
    its largest call: name_of(args, kwargs) says which kernel a call
    launches."""

    def __init__(self, fn, name_of):
        self.fn, self.name_of, self.calls = fn, name_of, {}

    def __call__(self, *args, **kwargs):
        key = (self.name_of(args, kwargs), tags[0])
        size = args[0].shape[0] * args[1].numel()
        if size > self.calls.get(key, (-1,))[0]:
            self.calls[key] = (size, args, kwargs)
        return self.fn(*args, **kwargs)


def record_main_path(cuda_sw):
    """Install recorders on the kernel wrappers; returns a function that
    removes them and returns {(kernel, phase): (size, args, kwargs)} of the
    largest calls."""
    def shared_name(args, kwargs):
        prof, gapO, gapE, quirk = args[0], args[6], args[7], args[8]
        return cuda_sw.shared_kernel_name(
            cuda_sw.i16_exact(int(prof.shape[2]), gapO, gapE,
                              kwargs.get("max_sub"), quirk),
            bool(kwargs.get("blockmax")), kwargs.get("wmask") is not None)

    def owned_name(args, kwargs):
        prof, gapO, gapE, quirk = args[0], args[8], args[9], args[10]
        return cuda_sw.owned_kernel_name(cuda_sw.i16_exact(
            int(prof.shape[2]), gapO, gapE, kwargs.get("max_sub"), quirk))

    recs = (Recorder(cuda_sw.forward_shared, shared_name),
            Recorder(cuda_sw.forward_shared_packed,
                     lambda args, kwargs: "forward_shared_packed"
                     + ("_dual" if kwargs.get("dual") else "")),
            Recorder(cuda_sw.forward_perread,
                     lambda args, kwargs: "forward_perread"),
            Recorder(cuda_sw.forward_shared_gated, owned_name))
    (cuda_sw.forward_shared, cuda_sw.forward_shared_packed,
     cuda_sw.forward_perread, cuda_sw.forward_shared_gated) = recs

    def restore():
        (cuda_sw.forward_shared, cuda_sw.forward_shared_packed,
         cuda_sw.forward_perread, cuda_sw.forward_shared_gated) = (
            r.fn for r in recs)
        return {key: call for r in recs for key, call in r.calls.items()}
    return restore


# ------------------------------------------------------------------- phase 6

def time_ms(torch, fn, reps, warm=True):
    if warm:
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def in_turns(torch, fa, fb, reps):
    """Times of fa and fb timed in turns a, b, b, a on one card, after one
    warm-up call of each."""
    fa()
    fb()
    ta = [time_ms(torch, fa, reps, warm=False)]
    tb = [time_ms(torch, fb, reps, warm=False) for _ in range(2)]
    ta.append(time_ms(torch, fa, reps, warm=False))
    return sum(ta) / 2, sum(tb) / 2


def phase_timing(torch, dev, rec, worst, launches, gated_launches,
                 parity_launches, split_launches, clock_mhz, slice_cols):
    from ssw_tpu_torch.leaf_timing import pinned_stretches
    from ssw_tpu_torch.ops import cuda_sw, pack, scan_sw
    from ssw_tpu_torch.tools import _common

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    int32_rate = _common.int32_rate(dev, clock_mhz)
    log(f"  int32 rate: {_common.INT32_LANES_PER_SM} lanes x {sms} SMs x "
        f"{clock_mhz} MHz = {int32_rate:.4g} op/s")
    rows = []

    def call(name, tag=None, gated=False):
        """(args, kwargs) of the kernel's largest main-path call, or of its
        largest call in phase `tag`; without the gate unless gated."""
        got = [(size, key[1], a, kw) for key, (size, a, kw) in rec.items()
               if key[0] == name and (tag is None or key[1] == tag)]
        check(got, f"no main-path call of {name}"
              + (f" in phase {tag}" if tag else ""))
        _, t, a, kw = max(got, key=lambda g: g[0])
        if not gated:
            kw = {k: v for k, v in kw.items() if k != "gate"}
        return a, kw, t

    def bound(ops, nbytes):
        t_ops = ops / int32_rate * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes,
                                                               "bytes")

    def shared_bound(name, prof, cm, cols, quirk, wmask=None,
                     extra_bytes=0):
        """The recurrence's operations over the lane-cells inside col_mask
        (plus blockmax's running max per read and column, and the dual
        mode's word-channel max per wmask lane-cell); inputs read once
        (profile, target, masks, read_len), outputs written once (int16
        maxima or int32 block maxima, one or two channels, three (B,)
        int32)."""
        B = prof.shape[0]
        i16 = "_i16" in name
        bm = name.endswith(("_blockmax", "_dual"))
        opc = (cuda_sw.OPS_PER_CELL_I16 if i16 else
               cuda_sw.OPS_PER_CELL_QUIRK if quirk else cuda_sw.OPS_PER_CELL)
        ops = opc * int(cm.sum()) * cols
        out_bytes = 2 * B * cols
        if bm:
            ops += ((cuda_sw.OPS_PER_COLUMN_BLOCKMAX_I16 if i16 else
                     cuda_sw.OPS_PER_COLUMN_BLOCKMAX) * B * cols)
            out_bytes = 4 * B * ((cols + scan_sw.BM - 1) // scan_sw.BM)
        in_bytes = (prof.numel() + 4 * cols + 3 * cm.numel() + 4 * B
                    + extra_bytes)
        if wmask is not None:
            ops += ((cuda_sw.OPS_PER_WORD_CELL_DUAL_I16 if i16 else
                     cuda_sw.OPS_PER_WORD_CELL_DUAL)
                    * int(wmask.sum()) * cols)
            out_bytes *= 2
            in_bytes += wmask.numel()
        return bound(ops, in_bytes + out_bytes + 12 * B)

    def shared_row(name, source, replaces, tag=None, leaf_turns=True,
                   leaf_equal=False):
        """forward_shared's kernel `name` at its largest main-path call (or
        its largest in phase `tag`); the plain version and the bound on a
        column slice of the same inputs when the call is too long for the
        plain version.  The wavefront is timed in turns with the
        column-scan body of the same mode on the slice and, with
        leaf_turns, on the whole leaf (with leaf_equal, held equal to it
        there first)."""
        args, kw, t = call(name, tag)
        prof, ref, rl, cm, seg, ss, gapO, gapE, quirk = args
        B, n1, L = prof.shape
        R = int(ref.numel())
        cols = min(slice_cols, R)
        lo = mid_slice(R, kw.get("valid_len"), cols)
        sl = (prof, ref[lo:lo + cols].contiguous(), rl, cm, seg, ss, gapO,
              gapE, quirk)
        plain_kw = {k: v for k, v in kw.items() if k != "max_sub"}
        fk = lambda a, **k: cuda_sw.forward_shared(*a, **kw, **k)
        ms, scan_ms = in_turns(torch, lambda: fk(sl),
                               lambda: fk(sl, scan_body=True), 5)
        t0 = time.perf_counter()
        want = scan_sw.forward_shared_ref(*sl, **plain_kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = cuda_sw.forward_shared(*sl, **kw)
        torch.cuda.synchronize()
        err = max_abs_diff(torch, got, want)
        check(err == 0, f"{name} at the main-path shape: max_abs_err {err}")
        wm = kw.get("wmask")
        b_ms, b_by = shared_bound(name, prof, cm, cols, quirk, wm)
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(err, worst[name]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "shape": f"B={B} L={L} R={cols} quirk={bool(quirk)} phase {t}"
                     + (" (column slice of the leaf)" if cols < R else ""),
            "scan_body_ms": scan_ms,
        }
        if cols < R and leaf_equal:
            same_as_scan_body(f"{name} whole leaf (B={B} L={L} R={R})",
                              fk(args), lambda: fk(args, scan_body=True))
        if cols < R and leaf_turns:
            row["leaf_ms"], row["scan_body_leaf_ms"] = in_turns(
                torch, lambda: fk(args), lambda: fk(args, scan_body=True), 1)
        elif cols < R:
            reps = 1 if B * R > (1 << 32) else 3
            row["leaf_ms"] = time_ms(torch, lambda: fk(args), reps)
        if cols < R:
            row["leaf_bound_ms"] = shared_bound(name, prof, cm, R, quirk,
                                                wm)[0]
            row["leaf_shape"] = f"B={B} L={L} R={R}"
        return row, args, kw

    def parity_row():
        """The int16 tier's device parity probe (cuda_sw._i16_parity: the
        int32 launch and both int16 designs on its fixed workload, run
        once per process and card before the tier's first launch; its
        launches count in cuda_sw.PARITY_LAUNCHES, read from the main
        path), its three launches timed together."""
        pargs = cuda_sw.i16_parity_inputs(dev)
        designs = ((False, False), (True, False), (True, True))
        run3 = lambda: [cuda_sw._launch_shared(*pargs, i16=i16,
                                               scan_body=sb)[0]
                        for i16, sb in designs]
        ms = time_ms(torch, run3, 20)
        t0 = time.perf_counter()
        want = scan_sw.forward_shared_ref(*pargs)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(max_abs_diff(torch, got, want) for got in run3())
        check(err == 0, f"the int16 parity probe's launches differ from "
              f"the plain version (max_abs_err {err})")
        prof, ref, _, cm = pargs[:4]
        B, R = prof.shape[0], int(ref.numel())
        cells = int(cm.sum()) * R
        b_ms, b_by = bound(
            (cuda_sw.OPS_PER_CELL + 2 * cuda_sw.OPS_PER_CELL_I16) * cells,
            3 * (prof.numel() + 4 * R + 3 * cm.numel() + 4 * B
                 + 2 * B * R + 12 * B))
        return {
            "name": "_i16_parity", "route": "cuda",
            "source": "ssw_tpu_torch/ops/cuda_sw.py (_i16_parity: "
                      "csrc/sw_wave_i32.cu, sw_wave_i16.cu, "
                      "sw_forward_i16.cu)",
            "replaces": "ssw_tpu/ops/pallas_sw.py:576 (_i16_supported -> "
                        "probe; pallas_call at :598, parity :611)",
            "launches": parity_launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": f"B={B} L={prof.shape[2]} R={R}, three launches "
                     f"(int32, int16 wavefront, int16 column-scan body) "
                     f"once per process and card"}

    def base_vs_blockmax(row, name, args, base, blockmax):
        """The base and blockmax modes of one kernel on the same launch
        inputs (the config-4 streaming leaf), timed in turns: the cost of
        the per-column stores shows as their difference."""
        prof, ref, _, cm, _, _, _, _, quirk = args
        base_ms, bm_ms = in_turns(torch, base, blockmax, 2)
        row["config4_leaf"] = {
            "base_ms": base_ms, "blockmax_ms": bm_ms,
            "blockmax_bound_ms": shared_bound(name, prof, cm,
                                              int(ref.numel()), quirk)[0],
            "shape": f"B={prof.shape[0]} L={prof.shape[2]} "
                     f"R={ref.numel()}"}

    # base mode, int32: its largest main-path call is phase 5i's protein
    # leaf (config 2 at scale, the quirk)
    row, _, _ = shared_row(
        "forward_shared", "ssw_tpu_torch/csrc/sw_wave_i32.cu",
        "ssw_tpu/ops/pallas_sw.py:109 (_forward_kernel, base mode, int32; "
        "pallas_call at :557)", leaf_equal=True)
    rows.append(row)
    rows.append(parity_row())
    row, c4, c4kw = shared_row(
        "forward_shared_i16", "ssw_tpu_torch/csrc/sw_wave_i16.cu",
        "ssw_tpu/ops/pallas_sw.py:109 (_forward_kernel, int16 tier: use_i16 "
        "chosen at :735, pallas_call at :557; probe _i16_supported :576)",
        tag="5")
    # the int32 kernel on the same config-4 leaf (same inputs, same call),
    # the wavefront in turns with the column-scan body
    prof, ref, rl, cm, seg, ss, gapO, gapE, quirk = c4
    B = prof.shape[0]
    row["int32_leaf_ms"], row["int32_scan_body_leaf_ms"] = in_turns(
        torch, lambda: cuda_sw.forward_shared(*c4),
        lambda: cuda_sw.forward_shared(*c4, scan_body=True), 1)
    row["int32_leaf_bound_ms"] = shared_bound(
        "forward_shared", prof, cm, int(ref.numel()), quirk)[0]
    rows.append(row)
    # the suboptimal glue (torch, not a kernel) on this leaf's maxima, with
    # the CLI's mask_len (read_len // 2) and byte-tier window edges
    _, er, _, mc = cuda_sw.forward_shared(*c4, **c4kw)
    ml = (rl // 2).to(torch.int32)
    word = torch.zeros(B, dtype=torch.bool, device=dev)
    sub_ms = time_ms(torch, lambda: scan_sw.second_best_batch(
        mc, er, ml, int(ref.numel()), word), 3)
    del mc
    log(f"  suboptimal glue (second_best_batch) at B={B} R={ref.numel()}: "
        f"{sub_ms:.3f} ms")

    # blockmax mode, int32: its largest main-path call (protein goldens),
    # then on the config-4 streaming leaf beside the base mode, in turns
    row, _, _ = shared_row(
        "forward_shared_blockmax", "ssw_tpu_torch/csrc/sw_wave_i32.cu",
        "ssw_tpu/ops/pallas_sw.py:109 (_forward_kernel, blockmax/lanetrack "
        "mode :153-213, :278-297, :361-416, int32; pallas_call at :557; "
        "wrapper forward_shared_ref :702 with blockmax=True)")
    s4, s4kw, _ = call("forward_shared_i16_blockmax", "5s")
    bm_kw = {k: v for k, v in s4kw.items() if k != "max_sub"}
    base_vs_blockmax(row, "forward_shared_blockmax", s4,
                     lambda: cuda_sw.forward_shared(*s4),
                     lambda: cuda_sw.forward_shared(*s4, **bm_kw))
    rows.append(row)
    # blockmax mode, int16 tier: the 10 Mbp leaf (slice + whole leaf), and
    # the config-4 streaming leaf beside the base mode, in turns
    row, _, _ = shared_row(
        "forward_shared_i16_blockmax", "ssw_tpu_torch/csrc/sw_wave_i16.cu",
        "ssw_tpu/ops/pallas_sw.py:109 (_forward_kernel, blockmax/lanetrack "
        "mode, int16 tier (rv, rc) :290-297; pallas_call at :557; wrapper "
        "forward_shared_ref :702 with blockmax=True)", leaf_turns=False)
    base_kw = {k: v for k, v in s4kw.items() if k == "max_sub"}
    base_vs_blockmax(row, "forward_shared_i16_blockmax", s4,
                     lambda: cuda_sw.forward_shared(*s4, **base_kw),
                     lambda: cuda_sw.forward_shared(*s4, **s4kw))
    # the config-4 streaming leaf: the wavefront against the column-scan
    # body of the blockmax mode, in turns
    (row["config4_leaf"]["blockmax_ms"],
     row["config4_leaf"]["scan_body_blockmax_ms"]) = in_turns(
        torch, lambda: cuda_sw.forward_shared(*s4, **s4kw),
        lambda: cuda_sw.forward_shared(*s4, **s4kw, scan_body=True), 1)
    rows.append(row)

    # dual mode, both tiers: the largest main-path call (the Ion Torrent
    # leaves), and beside it the blockmax mode on the same inputs, in turns
    fs = lambda *a, **k: cuda_sw.forward_shared(*a, **k)
    for name, source, tier in (
            ("forward_shared_i16_dual", "ssw_tpu_torch/csrc/sw_wave_i16.cu",
             "int16 tier"),
            ("forward_shared_dual", "ssw_tpu_torch/csrc/sw_wave_i32.cu",
             "int32")):
        row, args, kw = shared_row(
            name, source,
            f"ssw_tpu/ops/pallas_sw.py:109 (_forward_kernel, dual mode "
            f":142-151, :405-412, {tier}; pallas_call at :557; wrapper "
            f"forward_shared_ref :702 with wmask)")
        bm_kw = {k: v for k, v in kw.items() if k != "wmask"}
        bm_ms, dual_ms = in_turns(torch, lambda: fs(*args, **bm_kw),
                                  lambda: fs(*args, **kw), 1)
        row["leaf_dual_vs_blockmax"] = {"dual_ms": dual_ms,
                                        "blockmax_ms": bm_ms}
        rows.append(row)

    def packed_bound(args, kw, cols):
        """The recurrence's operations over the read slots' lanes, the block
        running max per read and column, and the dual word channel's max
        per word-tier lane-cell; inputs (packed profile, target, slot
        tables, flat_idx) read once, outputs written once."""
        prof, _, so, sl, rl_s, fi = args[:6]
        B = fi.numel()
        per_read = lambda x: x.flatten()[fi.long()].cpu().numpy()
        ops = cuda_sw.packed_ops(per_read(sl), per_read(rl_s), cols,
                                 bool(kw.get("quirk")), bool(kw.get("dual")))
        nblk = (cols + scan_sw.BM - 1) // scan_sw.BM
        out_bytes = 4 * B * nblk * (2 if kw.get("dual") else 1) + 12 * B
        return bound(ops, prof.numel() + 4 * cols + 12 * so.numel() + 4 * B
                     + out_bytes)

    def packed_row(name, tag=None):
        """The packed kernel at its largest main-path call: slice vs plain,
        also split into the stretches the whole leaf's launch has (on the
        slice the rule keeps P = 1), bound, and the whole leaf."""
        args, kw, t = call(name, tag)
        prof, ref = args[:2]
        R = int(ref.numel())
        cols = min(slice_cols, R)
        lo = mid_slice(R, kw.get("valid_len"), cols)
        sl_args = (prof, ref[lo:lo + cols].contiguous(), *args[2:])
        plain_kw = {k: v for k, v in kw.items() if k != "slot_max"}
        fp = lambda a, **k: cuda_sw.forward_shared_packed(*a, **kw, **k)
        ms, scan_ms = in_turns(torch, lambda: fp(sl_args),
                               lambda: fp(sl_args, scan_body=True), 5)
        t0 = time.perf_counter()
        want = scan_sw.forward_shared_ref_packed(*sl_args, **plain_kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = cuda_sw.forward_shared_packed(*sl_args, **kw)
        torch.cuda.synchronize()
        err = max_abs_diff(torch, got, want)
        check(err == 0, f"{name} at the main-path shape: max_abs_err {err}")
        # the whole leaf's stretches, on the slice
        leaf_P = cuda_sw.packed_launch(
            int(args[5].numel()), kw.get("slot_max") or pack.slot_max(
                args[3]), int(prof.shape[1]),
            min(kw.get("valid_len") or R, R), kw.get("max_sub"), args[6],
            args[7], bool(kw.get("quirk")), bool(kw.get("dual")), dev)[0]
        slice_P = pack.stretch_bounds(cols, leaf_P)[0]
        with pinned_stretches(leaf_P):
            got = cuda_sw.forward_shared_packed(*sl_args, **kw)
        torch.cuda.synchronize()
        serr = max_abs_diff(torch, got, want)
        log(f"  {name}: the leaf's launch has {leaf_P} stretches a read; "
            f"the slice split into {slice_P}: max_abs_err {serr}")
        check(serr == 0, f"{name} at the main-path shape split into "
              f"{slice_P} stretches: max_abs_err {serr}")
        err = max(err, serr)
        b_ms, b_by = packed_bound(args, kw, cols)
        S = int(args[2].shape[1])
        row = {
            "name": name, "route": "cuda",
            "source": "ssw_tpu_torch/csrc/sw_wave_packed.cu",
            "replaces": "ssw_tpu/ops/pallas_sw.py:109 (_forward_kernel, "
                        "packed mode :137-141, :214-248, :381-404"
                        + (", dual :398-404" if kw.get("dual") else "")
                        + "; set-up _forward_call :445-481, pallas_call at "
                        ":557; wrapper forward_shared_ref_packed :1139)",
            "launches": launches[name],
            # the launches split into stretches, each with one launch of
            # sw_wave_packed_merge_kernel (phases 4-5g)
            "merge_launches": split_launches[name],
            "leaf_stretches": leaf_P, "slice_stretches": slice_P,
            "max_abs_err": max(err, worst[name]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "scan_body_ms": scan_ms,
            "shape": f"B={args[5].numel()} rows={prof.shape[0]} "
                     f"W={prof.shape[2]} S={S} R={cols} "
                     f"quirk={bool(kw.get('quirk'))} phase {t}"
                     + (" (column slice of the leaf)" if cols < R else ""),
        }
        if cols < R:
            row["leaf_ms"], row["scan_body_leaf_ms"] = in_turns(
                torch, lambda: fp(args), lambda: fp(args, scan_body=True), 1)
            # the kernel stops at valid_len: the columns this data needs
            row["leaf_bound_ms"] = packed_bound(
                args, kw, min(R, kw.get("valid_len") or R))[0]
            row["leaf_shape"] = f"R={R} valid_len={kw.get('valid_len')}"
        return row, args, kw

    def pack_vs_unpacked(row, key, packed, unpacked, others):
        """A packed leaf and the unpacked leaf of the same reads, in turns,
        with the same outputs; `others` are timed once after."""
        pa, pkw = packed
        ua, ukw = unpacked
        p_out = cuda_sw.forward_shared_packed(*pa, **pkw)
        u_out = cuda_sw.forward_shared(*ua, **ukw)
        torch.cuda.synchronize()
        check(max_abs_diff(torch, p_out, u_out) == 0,
              f"{key}: the packed leaf's outputs differ from the unpacked "
              f"leaf's on the same reads")
        p_ms, u_ms = in_turns(
            torch, lambda: cuda_sw.forward_shared_packed(*pa, **pkw),
            lambda: cuda_sw.forward_shared(*ua, **ukw), 1)
        row[key] = {"packed_ms": p_ms, "unpacked_ms": u_ms,
                    "ratio": p_ms / u_ms,
                    "shape": f"B={ua[0].shape[0]} L={ua[0].shape[2]} "
                             f"R={ua[1].numel()}; packed W="
                             f"{pa[0].shape[2]} S={pa[2].shape[1]}"}
        for label, kw in others.items():
            row[key][label + "_ms"] = time_ms(
                torch, lambda: cuda_sw.forward_shared(*ua, **kw), 1)

    # packed: config 4 streaming by the default rules (phase 5p), beside
    # the unpacked streaming leaf of the same reads (phase 5s)
    row, pa, pkw = packed_row("forward_shared_packed", "5p")
    ua, ukw, _ = call("forward_shared_i16_blockmax", "5s")
    pack_vs_unpacked(row, "config4_leaf_vs_int16_blockmax", (pa, pkw),
                     (ua, ukw), {"int32_blockmax": {
                         k: v for k, v in ukw.items() if k != "max_sub"}})
    rows.append(row)
    # packed dual: the Ion Torrent L = 192 group (phase 5c, PACK = True),
    # beside the unpacked dual leaf and the blockmax leaf of the same reads;
    # Ion's leaves fill the card by splitting the target
    row, pa, pkw = packed_row("forward_shared_packed_dual", "5c4")
    check(row["leaf_stretches"] > 1 and row["slice_stretches"] > 1
          and row["merge_launches"] > 0,
          f"the Ion Torrent packed dual leaf ran unsplit: "
          f"{row['leaf_stretches']} stretches, "
          f"{row['merge_launches']} split launches on the main path")
    ua, ukw, _ = call("forward_shared_i16_dual", "5c2")
    pack_vs_unpacked(row, "ion_L192_leaf_vs_int16_dual", (pa, pkw),
                     (ua, ukw), {"int16_blockmax": {
                         k: v for k, v in ukw.items() if k != "wmask"}})
    rows.append(row)

    def gated_row(name, tag, leaf, source):
        """Kernel `name` with the gate at its largest call in phase `tag`
        (the gate the pipeline's rule gave it): on a column slice of the
        leaf, timed in turns against the same launch without the gate, held
        against the gated plain model (outputs and depth histogram), and
        with `leaf`, the whole leaf in turns too.  The bound is the ungated
        mode's: the gate changes no counted operation."""
        args, kw, t = call(name, tag, gated=True)
        thr = kw.get("gate")
        check(thr is not None, f"{name} ran without the gate in phase {tag}")
        ukw = {k: v for k, v in kw.items() if k != "gate"}
        packed = name.startswith("forward_shared_packed")
        fn = (cuda_sw.forward_shared_packed if packed
              else cuda_sw.forward_shared)
        R = int(args[1].numel())
        cols = min(slice_cols // 2, R)  # the gated plain model is slower
        lo = mid_slice(R, ukw.get("valid_len"), cols)
        sl = (args[0], args[1][lo:lo + cols].contiguous(), *args[2:])
        ms, ungated_ms = in_turns(torch, lambda: fn(*sl, **kw),
                                  lambda: fn(*sl, **ukw), 3)
        cuda_sw.reset_gate_steps()
        got = fn(*sl, **kw)
        hist = cuda_sw.gate_steps()
        t0 = time.perf_counter()
        if packed:
            want, want_hist = scan_sw.forward_shared_ref_packed(
                *sl, gate=thr, steps=True,
                **{k: v for k, v in ukw.items() if k != "slot_max"})
        else:
            want, want_hist = scan_sw.forward_shared_ref(
                *sl, gate=thr, pairs="_i16" in name, steps=True,
                **{k: v for k, v in ukw.items() if k != "max_sub"})
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_diff(torch, got, want)
        check(err == 0 and hist == want_hist.tolist(),
              f"{name} gated at the main-path shape: max_abs_err {err}, "
              f"steps {hist} vs the plain model's {want_hist.tolist()}")
        if packed:
            vl = min(cols, ukw.get("valid_len") or cols)
            b_ms, b_by = packed_bound(args, ukw, vl)
        else:
            b_ms, b_by = shared_bound(name, args[0], args[3], cols, args[8],
                                      ukw.get("wmask"))
        row = {
            "name": name + "+gate", "route": "cuda", "source": source,
            "replaces": "ssw_tpu/ops/pallas_sw.py:314-359 (_forward_kernel, "
                        "bounded-radius gate: hm sample :314-321, tiers "
                        ":334-353, run_group bound :231-236; gate_plan "
                        ":645; pallas_call at :557)",
            "launches": gated_launches[name],
            "max_abs_err": max(err, worst[name]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "ungated_ms": ungated_ms, "gate": list(thr),
            "steps_by_depth": hist,
            "shape": f"{tuple(args[0].shape)} R={cols} phase {t}"
                     + (f" (columns {lo}.. of the leaf)" if cols < R else ""),
        }
        if leaf and cols < R:
            g_ms, u_ms = in_turns(torch, lambda: fn(*args, **kw),
                                  lambda: fn(*args, **ukw), 1)
            row["leaf"] = {"gated_ms": g_ms, "ungated_ms": u_ms,
                           "ratio": g_ms / u_ms, "R": R}
        return row

    for name, tag, leaf, source in (
            ("forward_shared_packed", "5j", True, "sw_forward_packed.cu"),
            ("forward_shared_packed_dual", "5c4", True,
             "sw_forward_packed.cu"),
            ("forward_shared_packed_dual", "5d2", True,
             "sw_forward_packed.cu"),
            ("forward_shared_i16_dual", "5c2", True, "sw_forward_i16.cu"),
            ("forward_shared_i16", "4t", False, "sw_forward_i16.cu"),
            ("forward_shared", "4t", False, "sw_forward.cu"),
            ("forward_shared_dual", "5c_i32_2", True, "sw_forward.cu"),
            ("forward_shared_blockmax", "5c_i32_3", True, "sw_forward.cu")):
        rows.append(gated_row(name, tag, leaf,
                              "ssw_tpu_torch/csrc/" + source))

    def owned_row(name, source, tag=None):
        """The owned-column mode at its largest main-path call (or its
        largest in phase `tag`): a column slice against the plain version
        and, in turns, against the base mode of the same kernel on the same
        inputs without idx/own; the whole shard in turns too.  The bound is
        the base mode's operations (the owned gate adds no counted
        operation per lane-cell) with idx/own read once."""
        args, kw, t = call(name, tag)
        prof, ref, idx, own, rl, cm, seg, ss, gapO, gapE, quirk = args
        B, n1, L = prof.shape
        R = int(ref.numel())
        cols = min(slice_cols, R)
        lo = mid_slice(R, None, cols)
        cut = lambda x: x[lo:lo + cols].contiguous()
        sl = (prof, cut(ref), cut(idx), cut(own), rl, cm, seg, ss, gapO,
              gapE, quirk)
        base = (prof, cut(ref), rl, cm, seg, ss, gapO, gapE, quirk)
        fo = lambda a, **k: cuda_sw.forward_shared_gated(*a, **kw, **k)
        fb = lambda a: cuda_sw.forward_shared(*a, **kw)
        ms, base_ms = in_turns(torch, lambda: fo(sl), lambda: fb(base), 3)
        _, scan_ms = in_turns(torch, lambda: fo(sl),
                              lambda: fo(sl, scan_body=True), 3)
        t0 = time.perf_counter()
        want = scan_sw.forward_shared_ref_gated(*sl)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = fo(sl)
        torch.cuda.synchronize()
        err = max_abs_diff(torch, got, want)
        check(err == 0, f"{name} at the main-path shape: max_abs_err {err}")
        b_ms, b_by = shared_bound(name, prof, cm, cols, quirk,
                                  extra_bytes=5 * cols)
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": "ssw_tpu/ops/pallas_sw.py:1039 "
                        "(forward_shared_ref_gated: _forward_call with "
                        "idx/own, base-mode own-gating :299-311; "
                        "pallas_call at :557 via :1063)",
            "launches": launches[name],
            "max_abs_err": max(err, worst[name]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "base_mode_ms": base_ms,
            "scan_body_ms": scan_ms,
            "shape": f"B={B} L={L} R={cols} quirk={bool(quirk)} phase {t}"
                     + (" (column slice of the shard)" if cols < R else ""),
        }
        if cols < R:
            bl = (prof, ref, rl, cm, seg, ss, gapO, gapE, quirk)
            own_ms, basemode_ms = in_turns(torch, lambda: fo(args),
                                           lambda: fb(bl), 1)
            row["shard"] = {
                "owned_ms": own_ms, "base_mode_ms": basemode_ms,
                "bound_ms": shared_bound(name, prof, cm, R, quirk,
                                         extra_bytes=5 * R)[0],
                "shape": f"B={B} L={L} R={R} (halo + C)"}
            row["shard"]["wave_ms"], row["shard"]["scan_body_ms"] = \
                in_turns(torch, lambda: fo(args),
                         lambda: fo(args, scan_body=True), 1)
        return row

    rows.append(owned_row("forward_shared_i16_owned",
                          "ssw_tpu_torch/csrc/sw_wave_i16.cu", tag="5e"))
    rows.append(owned_row("forward_shared_owned",
                          "ssw_tpu_torch/csrc/sw_wave_i32.cu"))

    # forward_perread at the recorded reverse pass of config 4
    args, kw, _ = call("forward_perread", "5")
    prof, refw, rl, cm, seg, ss, gapO, gapE, quirk = args
    B, n1, L = prof.shape
    W = refw.shape[1]
    fr = lambda a, **k: cuda_sw.forward_perread(*a, **kw, **k)
    ms, scan_ms = in_turns(torch, lambda: fr(args),
                           lambda: fr(args, scan_body=True), 20)
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
    row = {
        "name": "forward_perread", "route": "cuda",
        "source": "ssw_tpu_torch/csrc/sw_wave_perread.cu",
        "replaces": "ssw_tpu/ops/pallas_sw.py:819 (_perread_kernel; "
                    "pallas_call at :963)",
        "launches": launches["forward_perread"],
        "max_abs_err": max(err, worst["forward_perread"]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "scan_body_ms": scan_ms,
        "shape": f"B={B} L={L} W={W} terminate={term is not None}",
    }
    # the streaming scan's first window re-run on the 10 Mbp target
    # (emit_maxcol, no terminate: every column of the window)
    args, kw, _ = call("forward_perread", "5b")
    prof, refw, rl, cm, seg, ss, gapO, gapE, quirk = args
    fr = lambda a, **k: cuda_sw.forward_perread(*a, **kw, **k)
    row["window_rerun_ms"], row["window_rerun_scan_body_ms"] = in_turns(
        torch, lambda: fr(args), lambda: fr(args, scan_body=True), 20)
    row["window_rerun_bound_ms"] = bound(
        (cuda_sw.OPS_PER_CELL_QUIRK if quirk else cuda_sw.OPS_PER_CELL)
        * int(cm.sum()) * refw.shape[1],
        prof.numel() + 8 * refw.numel() + 3 * cm.numel() + 16 * B)[0]
    row["window_rerun_shape"] = (f"B={prof.shape[0]} L={prof.shape[2]} "
                                 f"W={refw.shape[1]} emit_maxcol")
    rows.append(row)
    return rows


# ------------------------------------------------------------------- phase 7

def phase_tools_path():
    """Phase 7's run of the slice's path: the three tools' entry points as
    a user calls them (the lab at the JAX lab's default shape, every
    variant), with their launch counts from 0; each tool kernel must have
    launched.  Returns the counts."""
    from ssw_tpu_torch.tools import _common, kernel_lab, probe_i16, \
        probe_swar

    _common.reset_launches()
    log("  python -m ssw_tpu_torch.tools.probe_swar")
    probe_swar.main([])
    log("  python -m ssw_tpu_torch.tools.probe_i16")
    probe_i16.main([])
    log("  python -m ssw_tpu_torch.tools.kernel_lab "
        + " ".join(kernel_lab.ALL_LABELS))
    kernel_lab.main(list(kernel_lab.ALL_LABELS))
    launches = dict(_common.LAUNCHES)
    log(f"  tool launches (phase 7 path): {json.dumps(launches)}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by its tool")
    return launches


def phase_tools_timing(torch, dev, rec, worst, launches, int32_rate,
                       slice_cols):
    """Phase 7's measurements: each tool kernel's row of the kernels line,
    and the lab's table in turns on the config-4 int32 leaf (phase 6's)."""
    from ssw_tpu_torch.ops import cuda_sw, scan_sw
    from ssw_tpu_torch.tools import kernel_lab, probe_i16, probe_swar

    def bound(ops, nbytes):
        t_ops = ops / int32_rate * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes,
                                                               "bytes")

    rows = []
    # probe_swar: each form's chain at the JAX shape, beside its plain twin
    x, y = probe_swar.inputs()
    xt, yt = torch.as_tensor(x).to(dev), torch.as_tensor(y).to(dev)
    n, depth = x.size, probe_swar.DEPTH
    ops_per_step = {"native": 2, "swar": 9, "vmaxs2": 2,
                    "viaddmax_s16x2": 2, "viaddmax_s32": 2}
    sass = probe_swar.sass_report()
    forms = {}
    for which in probe_swar.FORMS:
        fn = lambda: probe_swar.run(xt, yt, which)
        ms = time_ms(torch, fn, 50)
        t0 = time.perf_counter()
        probe_swar.chain_ref(xt, yt, which)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        b_ms, b_by = bound(ops_per_step[which] * n * depth, 12 * n)
        forms[which] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, **probe_swar.bench(which, dev),
                        "sass_max_per_step": sass[which]["max_instructions"]
                        / sass[which]["steps"]}
        log(f"  probe_swar {which}: {json.dumps(forms[which])}")
    nat = forms["native"]
    rows.append({
        "name": "probe_swar", "route": "cuda",
        "source": "ssw_tpu_torch/csrc/probe_swar.cu",
        "replaces": "tools/probe_swar.py:77 (run: _native_kernel :58, "
                    "_swar_kernel :66)",
        "launches": launches["probe_swar"],
        "max_abs_err": worst["probe_swar"], "ms": nat["ms"],
        "plain_ms": nat["plain_ms"], "bound_ms": nat["bound_ms"],
        "bound_by": nat["bound_by"], "library_ms": None,
        "shape": f"({probe_swar.B}, {probe_swar.L}) int32 x {depth} steps, "
                 f"native form; every form in 'forms'",
        "forms": forms})
    # probe_i16: every probe at the JAX shape, beside its plain twin
    probes = {}
    for name in probe_i16.PROBES:
        xs = [x.to(dev) for x in probe_i16.random_inputs(name, 0)]
        ms = time_ms(torch, lambda: probe_i16.run(name, xs), 50)
        fn = probe_i16.PROBES[name][0]
        t0 = time.perf_counter()
        fn(*xs)
        torch.cuda.synchronize()
        probes[name] = {"ms": ms,
                        "plain_ms": (time.perf_counter() - t0) * 1e3}
    xs = probe_i16.random_inputs("full_step", 0)
    nbytes = sum(x.numel() * 2 for x in xs) + xs[0].numel() * 2
    # full_step: 13 packed ops per lane pair, 5 scan steps per thread
    b_ms, b_by = bound(13 * xs[0].numel() // 2, nbytes)
    fs = probes["full_step"]
    rows.append({
        "name": "probe_i16", "route": "cuda",
        "source": "ssw_tpu_torch/csrc/probe_i16.cu",
        "replaces": "tools/probe_i16.py:32 (_run over the @probe registry "
                    ":37-143)",
        "launches": launches["probe_i16"],
        "max_abs_err": worst["probe_i16"], "ms": fs["ms"],
        "plain_ms": fs["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "shape": "(8, 128) int16, full_step; every probe in 'probes'",
        "probes": probes})
    # the lab on the config-4 int32 leaf (phase 6's): its slice in turns
    got = [(size, a) for (name, tag), (size, a, _) in rec.items()
           if name == "forward_shared_i16" and tag == "5"]
    check(got, "no config-4 leaf call of forward_shared_i16 in phase 5")
    prof, ref, rl, cm, seg, ss, gapO, gapE, quirk = max(
        got, key=lambda g: g[0])[1]
    check(not quirk and (gapO, gapE) == (3, 1), "config-4 leaf: quirk off, "
          "gapO 3, gapE 1 expected")
    R = int(ref.numel())
    lo = mid_slice(R, None, slice_cols)
    leaf = (prof, ref, rl, cm, seg, ss)
    sl = (prof, ref[lo:lo + slice_cols].contiguous(), rl, cm, seg, ss)
    table = []
    for label in kernel_lab.ALL_LABELS:
        r = kernel_lab.time_label(label, sl, reps=5)
        twinned = not label.startswith("skeleton")
        check(r["max_abs_err"] == 0 if twinned else r["max_abs_err"] is None,
              f"sw_lab {label} on the config-4 slice, against its plain "
              f"twin and kernel-run comparisons: max_abs_err "
              f"{r['max_abs_err']}")
        worst["sw_lab"] = max(worst["sw_lab"], r["max_abs_err"] or 0)
        log("  lab " + kernel_lab.format_row(r))
        table.append(r)
    # the lab copies the column-scan body (sw_forward.cu), which ungated
    # int32 launches reach with scan_body=True
    lab_ms, prod_ms = in_turns(
        torch, lambda: kernel_lab.run("full", leaf),
        lambda: cuda_sw.forward_shared(*leaf, gapO, gapE, quirk,
                                       scan_body=True), 1)
    log(f"  lab full vs forward_shared's column-scan body on the whole "
        f"config-4 leaf (B={prof.shape[0]} L={prof.shape[2]} R={R}), in "
        f"turns: {lab_ms:.2f} vs {prod_ms:.2f} ms "
        f"({(lab_ms / prod_ms - 1) * 100:+.2f} %)")
    check(abs(lab_ms / prod_ms - 1) <= 0.03, "the lab's full is more than "
          "3 % off the production column-scan body on the config-4 leaf")
    t0 = time.perf_counter()
    want = scan_sw.forward_shared_ref(*sl, gapO, gapE, False)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = kernel_lab.run("full", sl)
    check(max_abs_diff(torch, [got[k] for k in ("score", "end_ref",
                                                "end_read", "maxcol")],
                       want) == 0, "sw_lab full != plain on the slice")
    B, L = prof.shape[0], prof.shape[2]
    cells = int(cm.sum())
    io = prof.numel() + 3 * cm.numel() + 4 * B + 12 * B
    full = table[0]
    b_ms, b_by = bound(cuda_sw.OPS_PER_CELL * cells * slice_cols,
                       io + 4 * slice_cols + 2 * B * slice_cols)
    rows.append({
        "name": "sw_lab", "route": "cuda",
        "source": "ssw_tpu_torch/csrc/sw_lab.cu",
        "replaces": "tools/kernel_lab.py:73 (make_kernel; pallas_call in "
                    "run :463)",
        "launches": launches["sw_lab"], "max_abs_err": worst["sw_lab"],
        "ms": full["ms"], "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
        "shape": f"variant full, B={B} L={L} R={slice_cols} (column slice "
                 f"of the config-4 int32 leaf)",
        "leaf_ms": lab_ms, "leaf_production_ms": prod_ms,
        "leaf_bound_ms": bound(cuda_sw.OPS_PER_CELL * cells * R,
                               io + 4 * R + 2 * B * R)[0],
        "leaf_shape": f"B={B} L={L} R={R}",
        "table": [{k: r[k] for k in ("label", "ms", "full_ms", "delta_pct",
                                     "registers")} for r in table]})
    return rows


# ------------------------------------------------------------------- phase 8

BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]  # bench.py's line


def phase_bench(torch, dev):
    """`python -m ssw_tpu_torch.bench` as a user runs it: exit 0, its last
    line bench.py's four keys with vs_baseline within 0.01 of value / 1.1
    (both rounded from one GCUPS), its launches all of one packed kernel
    (the mode the pipeline takes for the leaf) in sw_wave_packed.  Then,
    in this process, the timed call's inputs (seed 1's reads) through the
    same launch on the target's first SLICE_COLS columns against the plain
    version on the card (outputs equal, and the whole call's block maxima
    over those columns), and the whole call against the unpacked int32
    launch of the same reads in the same mode (forward_shared, L 256):
    tolerance 0 (comparisons, after the counted window).  Returns (the
    line, the bench's other numbers, the packed kernel's name)."""
    from ssw_tpu_torch import bench, pipeline
    from ssw_tpu_torch.ops import common, cuda_sw, scan_sw

    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "ssw_tpu_torch.bench"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = r.stdout.strip().splitlines()
    log(f"  python -m ssw_tpu_torch.bench: rc {r.returncode}, "
        f"{time.perf_counter() - t0:.1f} s")
    for ln in lines:
        log(f"    {ln}")
    check(r.returncode == 0 and len(lines) >= 2,
          f"the bench failed: rc {r.returncode}: {r.stderr[-2000:]}")
    line, info = json.loads(lines[-1]), json.loads(lines[-2])
    check(list(line) == BENCH_KEYS and line["metric"] == "GCUPS"
          and line["unit"] == "GCUPS" and line["value"] > 0
          # bench.py rounds value and vs_baseline from the same GCUPS
          and abs(line["vs_baseline"] - line["value"] / 1.1) <= 0.01,
          f"the bench's last line is not bench.py's: {lines[-1]}")

    ref = bench.make_target(bench.CARD_R)
    leaf = bench.Leaf(ref, bench.READS, bench.READ_LEN, dev)
    kernel = "forward_shared_packed" + ("_dual" if leaf.dual else "")
    fwd = {k: n for k, n in info["launches"].items() if n}
    check(info["dual"] == leaf.dual and set(fwd) == {kernel} and
          {k: n for k, n in info["libraries"].items() if n}
          == {"sw_wave_packed": fwd[kernel]},
          f"the bench's launches: {info['launches']}, {info['libraries']}")
    reads = bench.make_reads(ref, 1, bench.READS)
    inputs = leaf.inputs(reads)
    got = leaf.call(inputs)
    # the plain version on a column slice: the recurrence runs left to
    # right, so the whole call's first blocks see the same columns
    cols = SLICE_COLS
    head = leaf.ref_d[:cols].contiguous()
    got_head = leaf.call(inputs, head, cols)
    t0 = time.perf_counter()
    want_head = scan_sw.forward_shared_ref_packed(
        inputs[0], head, *inputs[1], bench.GAP_O, bench.GAP_E,
        max_sub=bench.MAX_SUB, valid_len=cols, quirk=leaf.quirk,
        dual=leaf.dual)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    nb = cols // scan_sw.BM
    err_plain = max(max_abs_diff(torch, got_head, want_head),
                    max_abs_diff(torch, got[3][..., :nb], want_head[3]))
    log(f"  the timed call vs the plain version on the first {cols} "
        f"columns ({plain_s:.1f} s), and its block maxima there: "
        f"max_abs_err {err_plain}")
    check(err_plain == 0, f"the bench's packed call differs from the plain "
          f"version on the first {cols} columns (max_abs_err {err_plain})")
    read_len = np.full(bench.READS, bench.READ_LEN, np.int32)
    prof = common.build_profile(common.pad_reads(reads, bench.L, 5), read_len,
                                common.extend_matrix(dna_mat(2, 2)))
    geo = common.batch_geometry(read_len, bench.L, word=False)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)
    want = cuda_sw.forward_shared(
        t(prof), leaf.ref_d, t(read_len), t(geo.col_mask), t(geo.seg_id),
        t(geo.seg_start), bench.GAP_O, bench.GAP_E, leaf.quirk,
        blockmax=True, valid_len=bench.CARD_R,
        wmask=(pipeline._word_mask(t(read_len), bench.L) if leaf.dual
               else None))
    torch.cuda.synchronize()
    err = max_abs_diff(torch, got, want)
    log(f"  the timed call ({kernel}) vs the unpacked int32 launch in the "
        f"same mode on the same {bench.READS} reads: max_abs_err {err}")
    check(err == 0, f"the bench's packed call differs from the unpacked "
          f"int32 launch (max_abs_err {err})")
    info["max_abs_err_vs_plain"] = err_plain
    info["max_abs_err_vs_unpacked"] = err
    return line, info, kernel


ENTRY_KERNELS = ("forward_shared", "forward_shared_i16",
                 "forward_shared_blockmax", "forward_shared_packed",
                 "forward_perread")  # what phases 5h-5i must launch


def check_entry_points(launches, gated, libraries):
    """Phases 5h-5i: each kernel of their path launched, none gated, and
    every launch in a wavefront library."""
    for name in ENTRY_KERNELS:
        check(launches[name] > 0, f"{name} was not launched in phases "
              f"5h-5i")
    check(not any(gated.values()), f"gated launches in phases 5h-5i: "
          f"{gated}")
    check(sum(launches.values()) == sum(
        n for k, n in libraries.items() if k.startswith("sw_wave_")),
          f"phases 5h-5i: launches {launches} by library {libraries}")


def check_designs(launches, gated, libraries):
    """The main path's launches by library: every ungated launch of each
    forward kernel ran its wavefront (sw_wave_i32, sw_wave_i16,
    sw_wave_packed) and every gated one its column-scan body (sw_forward,
    sw_forward_i16, sw_forward_packed), at least one of each; every
    per-read launch ran sw_wave_perread."""
    def split(pred):
        names = [n for n in launches if pred(n)]
        return (sum(launches[n] - gated.get(n, 0) for n in names),
                sum(gated.get(n, 0) for n in names))
    i16 = split(lambda n: "_i16" in n)
    packed = split(lambda n: "_packed" in n)
    int32 = split(lambda n: "_i16" not in n and "_packed" not in n
                  and n != "forward_perread")
    for what, (ungated, with_gate), wave, scan in (
            ("int32", int32, "sw_wave_i32", "sw_forward"),
            ("int16-tier", i16, "sw_wave_i16", "sw_forward_i16"),
            ("packed", packed, "sw_wave_packed", "sw_forward_packed")):
        check(ungated > 0 and libraries[wave] == ungated,
              f"{ungated} ungated {what} launches, {libraries[wave]} in "
              f"{wave}")
        check(with_gate > 0 and libraries[scan] == with_gate,
              f"{with_gate} gated {what} launches, {libraries[scan]} in "
              f"{scan}")
    per = launches["forward_perread"]
    check(per > 0 and libraries["sw_wave_perread"] == per
          and libraries["sw_perread"] == 0,
          f"{per} per-read launches, {libraries['sw_wave_perread']} in "
          f"sw_wave_perread")
    log(f"  designs: int32 {int32[0]} ungated launches in sw_wave_i32, "
        f"{int32[1]} gated in sw_forward; int16 tier {i16[0]} in "
        f"sw_wave_i16, {i16[1]} in sw_forward_i16; packed {packed[0]} in "
        f"sw_wave_packed, {packed[1]} in sw_forward_packed; per-read {per} "
        f"in sw_wave_perread")


# ------------------------------------------------------------------- phase 9

LONGTARGET_READS = 1000      # phase 9a: bench_longtarget's default
CONFIG5_HOSTS = 2            # phase 9a: BASELINE config 5 as two hosts,
CONFIG5_HOST_SEQ = 2         # each over [card] * 2 (--mesh-seq 2)
LEAF_REPS = 3                # phase 9c
REVMEM_SHAPE = (2048, 1024, 8192)  # phase 9e: BENCH.md's (B, L, W)
REVMEM_PLAIN_READS = 16      # phase 9e: held to the plain version
SUITE_READS = 2000           # phase 9g: bench_suite --reads
SUITE_MESH_REPEAT = 8        # phase 9g: meshes of [card] * 1, 2, 4, 8

HOST_RUNNER = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
from ssw_tpu_torch import dcli, pipeline, profiling
dev = torch.device("cuda:0")
counter = profiling.GcupsCounter()
t0 = time.perf_counter()
with pipeline.profiled(counter):
    rc = dcli.main({args!r}, devices=[dev] * {seq})
torch.cuda.synchronize()
print(json.dumps({{"rc": rc, "wall_s": time.perf_counter() - t0,
                  "phase_seconds": counter.seconds,
                  "peak_device_bytes": torch.cuda.max_memory_allocated(dev)}}))
sys.exit(rc)
"""


def phase_longtarget(torch, dev, scratch, card, data):
    """9a: BASELINE config 5 on tools/make_data.py's 10M.fa (1M.fa's slice
    and a composition-matched random tail) with the first 1000 reads of its
    FASTQ, -c -s -h: bench_longtarget's cold and warm runs (byte-equal
    SAMs), then two dcli align processes (--num-hosts 2, each over [card]
    * 2, --mesh-seq 2) joined by a gloo rendezvous, merged: byte-equal to
    bench_longtarget's SAM.  Without -r only the forward-strand reads can
    align at their sampled position: >= 0.95 of them must."""
    from ssw_tpu_torch import dcli
    from ssw_tpu_torch.tools import bench_longtarget

    ref = os.path.join(data, "10M.fa")
    fq = os.path.join(data, "100k_illumina1.fastq.gz")
    runs, sam = bench_longtarget.run(ref, fq, LONGTARGET_READS, dev)
    for r in runs:
        check(r["rc"] == 0 and r["records"] == LONGTARGET_READS,
              f"bench_longtarget {r['run']}: rc {r['rc']}, {r['records']} "
              f"records")
        log(f"  longtarget {r['run']} " + json.dumps({**r, "card": card}))
    fwd, n_fwd = sampled_position_share(sam, "f")
    every, _ = sampled_position_share(sam)
    log(f"  longtarget: cold and warm SAMs byte-equal ({len(sam)} bytes); "
        f"{fwd:.4f} of the {n_fwd} forward-strand reads and {every:.4f} of "
        f"all reads at their sampled position")
    check(fwd >= 0.95, f"config 5: only {fwd:.4f} of the forward-strand "
          f"reads at their sampled position")
    # BASELINE config 5 as two hosts
    head = bench_longtarget.head_fastq(
        fq, LONGTARGET_READS, os.path.join(scratch, "config5_1k.fastq"))
    prefix = os.path.join(scratch, "config5_hosts")
    coord = free_coordinator()
    procs = []
    t0 = time.perf_counter()
    for host in range(CONFIG5_HOSTS):
        args = ["align", "-c", "-s", "--header", "--coordinator", coord,
                "--num-hosts", str(CONFIG5_HOSTS), "--host-id", str(host),
                "--mesh-seq", str(CONFIG5_HOST_SEQ), "--out", prefix, ref,
                head]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", HOST_RUNNER.format(
                root=ROOT, args=args, seq=CONFIG5_HOST_SEQ)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    hosts = []
    for host, (rc, out, err) in enumerate(outs):
        check(rc == 0, f"config 5 host {host}: rc {rc}: {err[-2000:]}")
        hosts.append(json.loads(out.strip().splitlines()[-1]))
    merged = prefix + ".sam"
    check(dcli.main(["merge", "--out", merged] + [
        f"{prefix}.part{h}" for h in range(CONFIG5_HOSTS)],
        err=io.StringIO()) == 0, "config 5: dcli merge failed")
    with open(merged) as f:
        same = f.read() == sam
    res = {"card": card, "reads": LONGTARGET_READS,
           "hosts": CONFIG5_HOSTS, "mesh_per_host": f"1 x {CONFIG5_HOST_SEQ}",
           "wall_s": wall, "reads_per_s": LONGTARGET_READS / wall,
           "host_runs": hosts, "byte_equal_to_longtarget": same}
    log("  config5 two hosts " + json.dumps(res))
    check(same, "config 5: the two hosts' merged SAM differs from "
          "bench_longtarget's")
    return runs, res


def phase_battery(torch, dev, scratch, card, ion_sam):
    """Phase 9: the JAX package's remaining measurement tools, ported
    (ssw_tpu_torch/tools), on phase 5h's bench_data; every check fails the
    script."""
    from ssw_tpu_torch.ops import cuda_sw, scan_sw
    from ssw_tpu_torch.tools import (_common, bench_iontorrent, bench_leaf,
                                     bench_suite, spotcheck_cuda,
                                     spotcheck_revmem, sweep_boundaries)

    data = os.path.join(scratch, "bench_data")
    t0 = time.perf_counter()
    log("  9a config 5 on 10M.fa (bench_longtarget, then two hosts):")
    phase_longtarget(torch, dev, scratch, card, data)
    log(f"  9a done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    runs, sam = bench_iontorrent.run(
        os.path.join(data, "ecoli_synth.fa"),
        os.path.join(data, "iontorrent_1k.fastq"), dev)
    for r in runs:
        check(r["rc"] == 0 and r["records"] == bench_iontorrent.N_READS,
              f"bench_iontorrent {r['run']}: rc {r['rc']}, {r['records']} "
              f"records")
        log(f"  9b iontorrent {r['run']} " + json.dumps({**r, "card": card}))
    log(f"  9b iontorrent: cold and warm SAMs byte-equal; equal to phase "
        f"5c's default-route SAM: {sam == ion_sam}")
    check(sam == ion_sam, "bench_iontorrent's SAM (tools/make_data.py's "
          "files) differs from phase 5c's")
    log(f"  9b done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rows = bench_leaf.run(reps=LEAF_REPS, device=dev)
    for r in rows:
        log("  9c leaf " + json.dumps({**r, "card": card}))
    check(all(r["checksum"] == rows[0]["checksum"] for r in rows),
          "bench_leaf: the reps' checksums differ")
    log(f"  9c done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for r in sweep_boundaries.sweep_stream(dev):
        log("  9d stream " + json.dumps({**r, "card": card}))
    for r in sweep_boundaries.sweep_packw(dev):
        log("  9d packw " + json.dumps({**r, "card": card}))
    log(f"  9d done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    res, inp, got = spotcheck_revmem.run(*REVMEM_SHAPE, dev)
    log("  9e revmem " + json.dumps({**res, "card": card}))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    again = spotcheck_revmem.reverse(inp)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t1
    B, L, W = REVMEM_SHAPE
    bound = B * L * W * cuda_sw.OPS_PER_CELL / _common.int32_rate(dev) * 1e3
    log(f"  9e revmem: a second call {warm * 1e3:.3f} ms (no read "
        f"terminates: {B} x {L} x {W} cells, integer-ALU bound "
        f"{bound:.3f} ms)")
    check(torch.equal(again, got), "the reverse pass differs between two "
          "calls on the same inputs")
    check(res["ptxas_k"], "no ptxas -v record of sw_wave_perread's K = 32 "
          "entries in this process")
    real = cuda_sw.forward_perread
    cuda_sw.forward_perread = scan_sw.forward_perread_ref
    try:
        want = spotcheck_revmem.reverse(inp, rows=REVMEM_PLAIN_READS)
    finally:
        cuda_sw.forward_perread = real
    err = max_abs_diff(torch, got[:, :REVMEM_PLAIN_READS], want)
    log(f"  9e revmem: the first {REVMEM_PLAIN_READS} reads against the "
        f"plain version on the card: max_abs_err {err}")
    check(err == 0, f"the reverse pass at {REVMEM_SHAPE} differs from the "
          f"plain version (max_abs_err {err})")
    log(f"  9e done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    total = spotcheck_cuda.run(dev)
    check(total == 0, f"spotcheck_cuda: {total} mismatches")
    log(f"  9f done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    report = bench_suite.suite(SUITE_READS, device=dev,
                               mesh_repeat=SUITE_MESH_REPEAT,
                               fastq=os.path.join(
                                   data, "100k_illumina1.fastq.gz"))
    log(json.dumps({"bench_suite": report, "card": card}))
    check("skipped" not in report["scaling"]
          and "skipped" not in report["e2e_config4"],
          f"bench_suite skipped a section: {report}")
    log(f"  9g done in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------- main

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False; chip_smoke needs a "
            "CUDA card")
        return 1
    sys.path.insert(0, ROOT)
    try:
        from ssw_tpu_torch import pipeline
        from ssw_tpu_torch.native import build as native_build
        from ssw_tpu_torch.ops import _kernels, cuda_sw
    except ImportError as e:
        log(f"FAIL: ssw_tpu_torch is not importable next to chip_smoke.py "
            f"({e})")
        return 1
    dev = torch.device("cuda:0")
    scratch = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(scratch, exist_ok=True)
    t_start = time.perf_counter()
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
        secs = _kernels.build(_kernels.KERNELS + _kernels.TOOL_KERNELS)
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
        phase_packed(torch, dev, worst)
        phase_gate(torch, dev, worst)
        phase_owned(torch, dev, worst)
        log(f"phase 3 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        log("phase 3l tool kernels vs plain twins (exact):")
        worst_tools = phase_tools(torch, dev)
        log(f"phase 3l done in {time.perf_counter() - t0:.1f} s")
        if "--kernels-only" in sys.argv[1:]:
            log("stopped after phase 3 (--kernels-only): no result")
            return 2
        # phases 4-5g are the main path: launch counts from 0, and the
        # int16 tier's parity probe runs again, as in a fresh process,
        # before the main path's first int16 launch
        cuda_sw.reset_launches()
        cuda_sw._I16_CHECKED.clear()
        restore = record_main_path(cuda_sw)
        try:
            t0 = time.perf_counter()
            log("phase 4 ssw_test main path vs reference-binary goldens:")
            tags[0] = "4"
            phase_golden(dev, scratch, "default")
            tags[0] = "4s"
            pipeline.STREAM_SUBOPT = True
            try:
                phase_golden(dev, scratch, "streaming")
            finally:
                pipeline.STREAM_SUBOPT = None
            tags[0] = "4t"
            pipeline.GATE = "tiers"
            try:
                phase_golden(dev, scratch, "GATE=tiers")
            finally:
                pipeline.GATE = None
            log(f"phase 4 done in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            log("phase 4s dcli align + merge, the forward pass sharded over "
                "[card] x 4, vs the goldens:")
            tags[0] = "4s2"
            phase_dcli_golden(dev, scratch, 2, "dcli --mesh-seq 2")
            tags[0] = "4s4"
            pipeline.GATE = "tiers"
            try:
                phase_dcli_golden(dev, scratch, 4,
                                  "dcli --mesh-seq 4 GATE=tiers")
            finally:
                pipeline.GATE = None
            log(f"phase 4s done in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            log("phase 4f the front ends (api, ssw_lib, pyssw, bridge, the C "
                "client) on the card at golden size:")
            tags[0] = "4f"
            phase_front_ends_golden(scratch)
            log(f"phase 4f done in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            log(f"phase 5 config 4: {CONFIG4_READS} reads vs 1M.fa, "
                f"-c -s -h -r, full scan and streaming in turns:")
            config4 = phase_config4(torch, dev, scratch, CONFIG4_READS, smi)
            log(f"phase 5 done in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            log(f"phase 5b 10 Mbp target: {TARGET10M_READS} reads, "
                f"-c -s -h -r:")
            t10 = phase_target10m(torch, dev, scratch, smi)
            log(f"phase 5b done in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            log(f"phase 5c Ion Torrent headline: {ION_READS} reads vs "
                f"{ION_GENOME} bp, -c -s -h:")
            ion = ion_data(scratch)
            _, ion_sam = phase_iontorrent(torch, dev, scratch, smi, ion)
            log(f"phase 5c done in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            log(f"phase 5d Ion Torrent headline, second penalty set "
                f"{' '.join(ION_PENALTIES2)}:")
            phase_iontorrent_o5e2(torch, dev, smi, ion)
            log(f"phase 5d done in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            log(f"phase 5e config 5 on one card: {CONFIG5_READS} reads vs "
                f"the 10 Mbp target sharded over [card] x {CONFIG5_SEQ}, "
                f"-c -s -h -r:")
            tags[0] = "5e"
            phase_config5(torch, dev, scratch, smi, t10)
            log(f"phase 5e done in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            log("phase 5f two dcli processes on the card, gloo rendezvous, "
                "config 3:")
            phase_two_process(scratch)
            log(f"phase 5f done in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            log(f"phase 5g the front ends at config-4 size: {CONFIG4_READS} "
                f"reads of phase 5:")
            tags[0] = "5g"
            phase_front_ends_config4(torch, scratch, smi, *config4)
            log(f"phase 5g done in {time.perf_counter() - t0:.1f} s")
            launches = cuda_sw.launch_counts()
            gated = cuda_sw.gated_counts()
            libraries = cuda_sw.library_counts()
            parity = cuda_sw.parity_counts()
            split = cuda_sw.split_counts()
            # phases 5h-5i, the measurement entry points: counts from 0
            cuda_sw.reset_launches()
            t0 = time.perf_counter()
            log("phase 5h config 4 at its 100,000 reads "
                "(tools/make_data.py), run_config4_full by both suboptimal "
                "routes:")
            phase_config4_full(torch, dev, scratch, smi)
            log(f"phase 5h done in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            log("phase 5i config 2 at scale (bench_protein: 512 reads vs "
                "200,000 aa, BLOSUM50, the quirk), four routes in turns:")
            phase_protein(torch, dev, smi)
            log(f"phase 5i done in {time.perf_counter() - t0:.1f} s")
            entry = cuda_sw.launch_counts()
            entry_gated = cuda_sw.gated_counts()
            entry_libs = cuda_sw.library_counts()
        finally:
            # phase 6 times the calls of phases 4-5f and 5i: the front ends
            # and 5h add no kernel and no shape to time
            rec = {k: v for k, v in restore().items()
                   if k[1] not in ("4f", "5g", "5h", "5h_full")}
        log(f"main-path launches (phases 4-5g): {json.dumps(launches)}; "
            f"with the gate: {json.dumps(gated)}")
        for name, n in launches.items():
            check(n > 0, f"{name} was not launched on the main path")
            check(name not in gated or gated[name] > 0,
                  f"{name} never ran with the gate on the main path")
        log(f"main-path launches by library: {json.dumps(libraries)}; "
            f"parity probe: {json.dumps(parity)}; split into stretches "
            f"(each with a merge launch): {json.dumps(split)}")
        check(parity["_i16_parity"] == 3, f"the int16 parity probe made "
              f"{parity['_i16_parity']} launches on the main path, not 3")
        check_designs(launches, gated, libraries)
        log(f"entry-point launches (phases 5h-5i): {json.dumps(entry)}; by "
            f"library: {json.dumps(entry_libs)}")
        check_entry_points(entry, entry_gated, entry_libs)
        t0 = time.perf_counter()
        log("phase 6 kernel timing at main-path shapes:")
        kernels = phase_timing(torch, dev, rec, worst, launches, gated,
                               parity["_i16_parity"], split,
                               float(clock or 1980), SLICE_COLS)
        for row in kernels:
            row["launches_5h_5i"] = entry.get(row["name"], 0)
            row["launches"] += row["launches_5h_5i"]
        log(f"phase 6 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        log("phase 7 the tools' entry points, then their timing:")
        tool_launches = phase_tools_path()
        from ssw_tpu_torch.tools import _common
        kernels += phase_tools_timing(
            torch, dev, rec, worst_tools, tool_launches,
            _common.int32_rate(dev, float(clock or 1980)), SLICE_COLS)
        log(f"phase 7 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        log("phase 8 the bench line (python -m ssw_tpu_torch.bench):")
        line, bench_info, bench_kernel = phase_bench(torch, dev)
        packed = next(r for r in kernels if r["name"] == bench_kernel)
        packed["launches_bench"] = bench_info["launches"][bench_kernel]
        packed["launches"] += packed["launches_bench"]
        packed["bench_leaf"] = {
            k: bench_info[k] for k in ("timed_call_ms", "median_ms",
                                       "calls_ms", "bound_ms", "rows", "W",
                                       "slots", "R", "cells", "dual",
                                       "max_abs_err_vs_plain",
                                       "max_abs_err_vs_unpacked")}
        packed["bench_leaf"]["line"] = line
        log(f"  bench line: {json.dumps(line)}")
        log(f"phase 8 done in {time.perf_counter() - t0:.1f} s")
        # phase 9, the measurement battery: counts from 0
        cuda_sw.reset_launches()
        t0 = time.perf_counter()
        log("phase 9 the measurement battery (ssw_tpu_torch/tools):")
        phase_battery(torch, dev, scratch, smi, ion_sam)
        battery = cuda_sw.launch_counts()
        log(f"  battery launches (phase 9): {json.dumps(battery)}; by "
            f"library: {json.dumps(cuda_sw.library_counts())}")
        for row in kernels:
            row["launches_9"] = battery.get(row["name"], 0)
            row["launches"] += row["launches_9"]
        log(f"phase 9 done in {time.perf_counter() - t0:.1f} s")
        log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    except (SmokeFailure, AssertionError) as e:
        log(f"FAIL: {e or repr(e)}")
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
