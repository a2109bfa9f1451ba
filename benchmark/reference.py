"""The plain reference that decides `correct`: ssw_test's and the C++
Aligner's answers worked out again from the inputs the benchmark made.

It imports nothing of the program.  Two kinds of code are here:

  * `forward`, written for this benchmark: the reference library's forward
    pass (ref: src/ssw.c sw_sse2_byte / sw_sse2_word) as plain PyTorch
    over whole rows of the target, one read position at a time, so that a
    sample of reads against a 1-5 Mbp target runs in seconds on the card.
    It keeps the semantics that ssw_tpu_torch/core/oracle.py documents
    (first column attaining the max, the least read position attaining it
    there, per-column maxima over the striped padding rows, the lazy-F
    quirk, the byte/word tier rule, `terminate` for the reverse pass);
  * frozen copies, each headed by its origin: the banded traceback, the
    CIGAR re-scorer and mismatch marking, the SAM record, the MAPQ formula
    and the C++ Aligner's field rendering.

`sat` computes the forward pass in a saturating signed byte (every score
capped at 127), the control that must come out not correct.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

NEG = -(1 << 30)

# --- alphabets (frozen copy of ssw_tpu_torch/core/encoding.py) ------------
NT_TABLE = np.full(256, 4, dtype=np.int8)
for _c, _v in {"A": 0, "C": 1, "G": 2, "T": 3, "U": 3}.items():
    NT_TABLE[ord(_c)] = _v
    NT_TABLE[ord(_c.lower())] = _v

RC_TABLE = np.full(256, 4, dtype=np.uint8)
for _a, _b in [("A", "T"), ("T", "A"), ("C", "G"), ("G", "C"), ("U", "A"),
               ("N", "N")]:
    RC_TABLE[ord(_a)] = ord(_b)
    RC_TABLE[ord(_a.lower())] = ord(_b)

# the C++ wrapper's table: ACGT (either case), everything else 4
CPP_TABLE = np.full(256, 4, dtype=np.int8)
for _c, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    CPP_TABLE[ord(_c)] = _v
    CPP_TABLE[ord(_c.lower())] = _v


def encode(seq: bytes, table=NT_TABLE) -> np.ndarray:
    return table[np.frombuffer(seq, dtype=np.uint8)].astype(np.int64)


def reverse_complement(seq: bytes) -> bytes:
    """ASCII-space reverse complement (ref: src/main.c:95-116)."""
    return RC_TABLE[np.frombuffer(seq, dtype=np.uint8)][::-1].tobytes()


def dna_matrix(match: int, mismatch: int) -> np.ndarray:
    """ssw_test's 5x5 matrix: N scores 0 (ref: src/main.c:328-335)."""
    m = np.zeros((5, 5), dtype=np.int64)
    for i in range(4):
        for j in range(4):
            m[i, j] = match if i == j else -mismatch
    return m


def cpp_matrix(match: int, mismatch: int) -> np.ndarray:
    """The C++ wrapper's 5x5 matrix: N scores -mismatch
    (ref: src/ssw_cpp.cpp:26-50)."""
    m = np.full((5, 5), -mismatch, dtype=np.int64)
    for i in range(4):
        m[i, i] = match
    return m


# --- the forward pass ------------------------------------------------------

@dataclass
class Forward:
    score: np.ndarray      # (B,) best score
    end_ref: np.ndarray    # (B,) first column attaining it, -1 for 0
    end_read: np.ndarray   # (B,) least read position attaining it there
    colmax: torch.Tensor | None  # (B, C) per-column maxima incl. pad rows
    colmax_word: torch.Tensor | None = None  # the same over word-tier rows


def run_max(x: torch.Tensor, seg: int = 4096) -> torch.Tensor:
    """Running maximum along dim 1 of a (B, n) tensor: cummax within
    segments of `seg` columns, then each segment raised to the maximum of
    the segments before it.  The same numbers as torch.cummax, but a few
    long rows become many short ones, which a card scans in parallel."""
    B, n = x.shape
    if n <= 2 * seg:
        return torch.cummax(x, dim=1).values
    k = -(-n // seg)
    pad = torch.full((B, k * seg - n), NEG, dtype=x.dtype, device=x.device)
    y = torch.cummax(torch.cat([x, pad], 1).view(B, k, seg), dim=2).values
    before = torch.cummax(y[:, :-1, -1], dim=1).values
    y[:, 1:] = torch.maximum(y[:, 1:], before[:, :, None])
    return y.view(B, k * seg)[:, :n]


def forward(reads, ref_idx: torch.Tensor, mat: np.ndarray, gapO: int,
            gapE: int, word: bool, *, ref_len=None, terminate=None,
            keep_colmax: bool = False, sat: int | None = None,
            both_tiers: bool = False, chunk: int = 1 << 23) -> Forward:
    """Local affine DP of every read in `reads` (1-D code arrays) against
    the columns of `ref_idx`: (C,) shared by all reads, or (B, C) one row
    per read with `ref_len[b]` valid columns.

    Rows are the striped read layout: the read padded to a multiple of 16
    (byte) or 8 (word) lanes, pad rows scoring 0; the lane blocks of
    seg_len rows bound the vertical gap that the horizontal one sees (the
    lazy-F quirk).  Per row, over all columns at once:
        h_diag = H[j-1][c-1] + sub
        F      = max(F - gapE, h_tilde[j-1] - gapO, 0)   (F_loc: reset per block)
        E[c]   = max(0, max_{k<c} max(h_diag, F_loc, 0)[k] - gapO - (c-1-k) gapE)
        h_tilde = max(h_diag, E, 0);  H = max(h_tilde, F)
    which needs gapO > gapE.  Columns run in chunks, the last column's H
    and the E scan's running max carried per row.  With `terminate`, a
    read stops after the first column whose maximum equals it.

    both_tiers (byte geometry, for a matrix whose min >= -2 gapE): E from
    the full F, and the per-column maxima of the word tier's rows kept
    too.  There the quirk changes no value: a vertical gap followed at
    once by a horizontal one never beats the diagonal step that replaces
    the pair (it saves at least 2 gapE for one mismatch), so every cell's
    H is the same in both tiers' geometries, and only the pad rows below
    the read (16-lane or 8-lane multiples) tell the tiers' column maxima
    apart."""
    if gapO <= gapE:
        raise ValueError("the reference needs gapO > gapE")
    dev = ref_idx.device
    B = len(reads)
    rl = np.array([len(r) for r in reads], dtype=np.int64)
    lanes = 8 if word else 16
    sl = (rl + lanes - 1) // lanes
    L = sl * lanes
    Lmax = int(L.max())
    nl = mat.shape[0]
    prof = np.zeros((B, Lmax, nl + 1), dtype=np.int32)  # letter nl: no column
    for b, r in enumerate(reads):
        prof[b, :len(r), :nl] = np.asarray(mat, dtype=np.int32)[:, r].T
    prof_d = torch.as_tensor(prof, device=dev)
    C = ref_idx.shape[-1]
    shared = ref_idx.dim() == 1
    vlen = torch.as_tensor(np.full(B, C) if ref_len is None else
                           np.asarray(ref_len), device=dev).long()
    L_d = torch.as_tensor(L, device=dev)[:, None]
    L_word = ((rl + 7) // 8) * 8
    sl_d = torch.as_tensor(sl, device=dev)[:, None]
    term = (None if terminate is None else
            torch.as_tensor(np.asarray(terminate), device=dev).long())
    i32 = torch.int32

    gmax = torch.zeros(B, dtype=torch.long, device=dev)
    end_ref = torch.full((B,), -1, dtype=torch.long, device=dev)
    end_row = torch.full((B,), -1, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    h_last = torch.zeros((B, Lmax), dtype=i32, device=dev)
    cm_carry = torch.full((B, Lmax), NEG, dtype=i32, device=dev)
    colmax_out = (torch.zeros((B, C), dtype=i32, device=dev)
                  if keep_colmax else None)
    colmax_word = (torch.zeros((B, C), dtype=i32, device=dev)
                   if keep_colmax and both_tiers else None)

    for c0 in range(0, C, chunk):
        if bool(done.all()):
            break
        c1 = min(C, c0 + chunk)
        n = c1 - c0
        idx = (ref_idx[c0:c1][None, :].expand(B, n) if shared
               else ref_idx[:, c0:c1]).long()
        kE = (torch.arange(c0, c1, device=dev, dtype=i32) * gapE)[None, :]
        h_prev = ht_prev = f = f_loc = None
        colmax = torch.zeros((B, n), dtype=i32, device=dev)
        colrow = torch.zeros((B, n), dtype=i32, device=dev)
        cm_word = torch.zeros((B, n), dtype=i32, device=dev)
        h_last_new = torch.zeros_like(h_last)
        for j in range(Lmax):
            sub = torch.gather(prof_d[:, j, :], 1, idx)
            if j == 0:
                h_diag = sub
                f = torch.zeros_like(sub)
                f_loc = torch.zeros_like(sub)
            else:
                diag = torch.cat([h_last[:, j - 1:j], h_prev[:, :-1]], 1)
                h_diag = diag + sub
                go = ht_prev - gapO
                f = torch.maximum(f - gapE, go).clamp_min_(0)
                if both_tiers:
                    f_loc = f
                else:
                    f_loc = torch.maximum(f_loc - gapE, go).clamp_min_(0)
                    f_loc = torch.where(j % sl_d == 0, 0, f_loc)
            if sat is not None:
                h_diag.clamp_max_(sat)
                f.clamp_max_(sat)
                f_loc.clamp_max_(sat)
            brow = torch.maximum(h_diag, f_loc).clamp_min_(0)
            cm = run_max(brow + kE)
            if c0:
                cm = torch.maximum(cm, cm_carry[:, j:j + 1])
            cm_prev = torch.cat([cm_carry[:, j:j + 1], cm[:, :-1]], 1)
            cm_carry[:, j] = cm[:, -1]
            e = (cm_prev - gapO - (kE - gapE)).clamp_min_(0)
            if sat is not None:
                e.clamp_max_(sat)
            ht = torch.maximum(h_diag, e).clamp_min_(0)
            h = torch.maximum(ht, f)
            upd = (h > colmax) & (j < L_d)
            colmax = torch.where(upd, h, colmax)
            colrow = torch.where(upd, j, colrow)
            if both_tiers:
                last = np.nonzero(L_word - 1 == j)[0]
                if len(last):
                    last = torch.as_tensor(last, device=dev)
                    cm_word[last] = colmax[last]
            h_last_new[:, j] = h[:, -1]
            h_prev, ht_prev = h, ht
        h_last = h_last_new
        del h_prev, ht_prev, f, f_loc, idx

        cols = torch.arange(c0, c1, device=dev)[None, :]
        live = (cols < vlen[:, None]) & ~done[:, None]
        if term is not None:
            hit = live & (colmax.long() == term[:, None])
            first_hit = torch.where(hit, cols, C).min(1).values
            live &= cols <= first_hit[:, None]
            done |= first_hit < C
        if colmax_out is not None:
            colmax_out[:, c0:c1] = colmax
        if colmax_word is not None:
            colmax_word[:, c0:c1] = cm_word
        cmx = torch.where(live, colmax.long(), -1)
        best = cmx.max(1).values
        first = torch.where(cmx == best[:, None], cols, C).min(1).values
        better = best > gmax
        pos = (first - c0).clamp(0, n - 1)
        gmax = torch.where(better, best, gmax)
        end_ref = torch.where(better, first, end_ref)
        end_row = torch.where(better, colrow.gather(1, pos[:, None])[:, 0]
                              .long(), end_row)
        done |= vlen <= c1

    score = gmax.cpu().numpy()
    er = end_ref.cpu().numpy()
    ed = end_row.cpu().numpy()
    ed = np.where(score > 0, ed, rl - 1)
    return Forward(score, er, ed, colmax_out, colmax_word)


def second_best(colmax: torch.Tensor, end_ref: np.ndarray, mask_len,
                ref_len: np.ndarray, word: np.ndarray):
    """Suboptimal score outside the maskLen window around end_ref: byte
    tier columns [0, end-maskLen) and (end+maskLen, refLen), word tier
    [0, end-maskLen) and [end+maskLen, refLen); the first column strictly
    above the running best wins (ref: src/ssw.c:368-381, 570-583)."""
    dev = colmax.device
    B, C = colmax.shape
    er = torch.as_tensor(end_ref, device=dev).long()[:, None]
    ml = torch.as_tensor(np.asarray(mask_len), device=dev).long()
    ml = ml.expand(B)[:, None] if ml.dim() == 0 else ml[:, None]
    wd = torch.as_tensor(np.asarray(word), device=dev)[:, None]
    cols = torch.arange(C, device=dev)[None, :]
    lo = (er - ml).clamp_min(0)
    rlen = torch.as_tensor(np.asarray(ref_len), device=dev).long()[:, None]
    hi = torch.minimum(er + ml, rlen)
    start = torch.where(wd, hi, hi + 1)
    take = ((cols < lo) | (cols >= start)) & (cols < rlen)
    v = torch.where(take, colmax.long(), 0)
    s2 = v.max(1).values
    first = torch.where((v == s2[:, None]) & take, cols, C).min(1).values
    s2 = s2.cpu().numpy()
    re2 = np.where(s2 > 0, first.cpu().numpy(), 0)
    return s2, re2


# --- frozen copies of ssw_tpu_torch/core/cigar.py -------------------------
MAPSTR = "MIDNSHP=X"
_OP_CODE = {c: i for i, c in enumerate(MAPSTR)}


def to_cigar_int(length: int, op: str) -> int:
    return (int(length) << 4) | _OP_CODE.get(op, 0)


def cigar_int_to_op(c: int) -> str:
    low = c & 0xF
    return "M" if low > 8 else MAPSTR[low]


def cigar_int_to_len(c: int) -> int:
    return int(c) >> 4


def cigar_to_string(cigar) -> str:
    return "".join(f"{cigar_int_to_len(c)}{cigar_int_to_op(c)}"
                   for c in cigar)


def cigar_alignment_score(cigar, ref, read, mat, gapO: int, gapE: int):
    """Re-score a path to verify the banded traceback (ref:
    src/ssw.c:785-811); None when the path walks outside the sequences."""
    score = 0
    i = j = 0
    n_ref, n_read = len(ref), len(read)
    for c in cigar:
        ln = cigar_int_to_len(c)
        op = cigar_int_to_op(c)
        if op == "M":
            if i + ln > n_ref or j + ln > n_read:
                return None
            for _ in range(ln):
                score += int(mat[ref[i], read[j]])
                i += 1
                j += 1
        else:
            score -= gapO + (ln - 1) * gapE if ln > 1 else gapO
            if op == "I":
                j += ln
            elif op == "D":
                i += ln
    return score


def mark_mismatch(ref_begin1, read_begin1, read_end1, ref, read, read_len,
                  cigar):
    """M runs into '='/'X', soft clips, NM (ref: src/ssw.c:1019-1074)."""
    nm = 0
    out: list[int] = []
    i, j = int(ref_begin1), int(read_begin1)
    if read_begin1 > 0:
        out.append(to_cigar_int(read_begin1, "S"))
    run_op, run_len = "", 0

    def flush():
        nonlocal run_len
        if run_len:
            out.append(to_cigar_int(run_len, run_op))
            run_len = 0

    for c in cigar:
        ln = cigar_int_to_len(c)
        op = cigar_int_to_op(c)
        if op == "M":
            for _ in range(ln):
                cur = "=" if ref[i] == read[j] else "X"
                if cur == "X":
                    nm += 1
                if cur != run_op:
                    flush()
                    run_op = cur
                run_len += 1
                i += 1
                j += 1
        elif op in ("I", "D"):
            flush()
            nm += ln
            out.append(to_cigar_int(ln, op))
            if op == "I":
                j += ln
            else:
                i += ln
            run_op = ""
    flush()
    tail = read_len - read_end1 - 1
    if tail > 0:
        out.append(to_cigar_int(tail, "S"))
    return nm, out


# --- frozen copy of ssw_tpu_torch/core/oracle.py banded_sw ----------------
def banded_sw(ref, read, score: int, gapO: int, gapE: int, band_width: int,
              mat):
    """Banded affine DP + traceback emitting a BAM cigar, row-vectorized,
    with the reference's tie-break rules and trailing-1M fixup
    (ref: src/ssw.c:590-783).  None on traceback failure."""
    ref = np.asarray(ref, dtype=np.int64)
    read = np.asarray(read, dtype=np.int64)
    mat = np.asarray(mat, dtype=np.int64)
    ref_len, read_len = len(ref), len(read)
    neg_inf = np.int64(-(2 ** 30))
    length = max(ref_len, read_len)
    best = best_i = best_j = 0
    sub_rows = mat[ref]
    while True:
        width = band_width * 2 + 3
        width_d = band_width * 2 + 1
        h_b = np.zeros(width, dtype=np.int64)
        e_b = np.zeros(width, dtype=np.int64)
        h_c = np.zeros(width, dtype=np.int64)
        direction = np.zeros((read_len, width_d, 3), dtype=np.int8)
        for i in range(read_len):
            beg = max(0, i - band_width)
            end = min(ref_len - 1, i + band_width)
            if beg > end:
                continue
            edge = min(end + 1, width - 1)
            h_b[0] = h_c[0] = 0
            h_b[edge] = 0
            e_b[0] = e_b[edge] = neg_inf
            js = np.arange(beg, end + 1)
            off_cur = max(i - band_width, 0)
            off_prev = max(i - 1 - band_width, 0)
            u = js - off_cur + 1
            eu = js - off_prev + 1
            du = js - 1 - off_prev + 1
            d = js - off_cur
            if i == 0:
                t1e = np.full(len(js), -gapO, dtype=np.int64)
                t2e = np.full(len(js), neg_inf, dtype=np.int64)
            else:
                t1e = h_b[eu] - gapO
                t2e = e_b[eu] - gapE
            e_new = np.maximum(t1e, t2e)
            e_b[u] = e_new
            direction[i, d, 0] = np.where(t1e > t2e, 3, 2)
            diag = h_b[du] + sub_rows[js, read[i]]
            e1 = np.maximum(e_new, 0)
            h_nof = np.maximum(e1, diag)
            k = np.arange(len(js), dtype=np.int64)
            src = np.concatenate(([np.int64(-gapO)], h_nof[:-1] - gapO))
            f = np.maximum.accumulate(src + k * gapE) - k * gapE
            f1 = np.maximum(f, 0)
            h_row = np.maximum(h_nof, f1)
            f_prev = np.concatenate(([np.int64(neg_inf)], f[:-1]))
            t1f = np.concatenate(([np.int64(0)], h_row[:-1])) - gapO
            t2f = f_prev - gapE
            direction[i, d, 1] = np.where(t1f > t2f, 5, 4)
            t1h = np.maximum(e1, f1)
            direction[i, d, 2] = np.where(
                t1h <= diag, 1,
                np.where(e1 > f1, direction[i, d, 0], direction[i, d, 1]))
            h_c[u] = h_row
            row_best = int(h_row.max())
            if row_best > best:
                best = row_best
                best_i = i
                best_j = int(js[int(np.argmax(h_row == row_best))])
            h_b[1:u[-1] + 1] = h_c[1:u[-1] + 1]
        band_width *= 2
        if not (best < score and band_width <= length):
            break
    band_width //= 2

    i, j = best_i, best_j
    runs: list[tuple[int, str]] = []
    count = 0
    op = prev_op = "M"
    plane = 2
    width_d = band_width * 2 + 1
    while i >= 0 and j > 0:
        slot = j - max(i - band_width, 0)
        if not (0 <= slot < width_d):
            return None
        dcode = direction[i, slot, plane]
        if dcode == 1:
            i, j, plane, op = i - 1, j - 1, 2, "M"
        elif dcode == 2:
            i, plane, op = i - 1, 0, "I"
        elif dcode == 3:
            i, plane, op = i - 1, 2, "I"
        elif dcode == 4:
            j, plane, op = j - 1, 1, "D"
        elif dcode == 5:
            j, plane, op = j - 1, 2, "D"
        else:
            return None
        if op == prev_op:
            count += 1
        else:
            runs.append((count, prev_op))
            prev_op = op
            count = 1
    if op == "M":
        runs.append((count + 1, op))
    else:
        runs.append((count, op))
        runs.append((1, "M"))
    return [to_cigar_int(ln, o) for ln, o in reversed(runs)]


# --- ssw_align over a batch of reads ---------------------------------------

@dataclass
class AlignResult:
    """Mirror of s_align (ref: src/ssw.h:55-66)."""
    score1: int = 0
    score2: int = 0
    ref_begin1: int = -1
    ref_end1: int = 0
    read_begin1: int = -1
    read_end1: int = 0
    ref_end2: int = 0
    cigar: list = field(default_factory=list)
    flag: int = 0


def _groups(lengths, max_cells: int, C: int, most: int = 16):
    """Positions into `lengths` in groups of similar length: at most
    `most` reads, and reads times columns at most max_cells (at least one
    read)."""
    order = np.argsort(lengths, kind="stable")
    per = max(1, min(most, max_cells // max(C, 1)))
    return [order[i:i + per] for i in range(0, len(order), per)]


def align_many(reads, ref, mat: np.ndarray, gapO: int, gapE: int, *,
               flag: int, filters: int = 0, filterd: int = 2 ** 31 - 1,
               mask_len, device, sat: int | None = None,
               max_cells: int = 1 << 27, timings: dict | None = None,
               paths: bool = True):
    """ssw_align (score_size 2) of every read against `ref`, one code array
    shared by all reads or a list of one per read (ref:
    src/ssw.c:855-977): byte-tier forward, word re-run where
    score + bias >= 255, suboptimal scan, begin-finding reverse pass,
    banded CIGAR with its verification retry (left to a later `add_paths`
    when paths is False).  `timings`, when given, gathers the seconds of
    the forward, reverse and banded stages."""
    tm = timings if timings is not None else {}
    t0 = time.perf_counter()
    mat = np.asarray(mat, dtype=np.int64)
    B = len(reads)
    bias = int(abs(min(int(mat.min()), 0)))
    ml = np.broadcast_to(np.asarray(mask_len), (B,)).astype(np.int64)
    shared = not isinstance(ref, list)
    refs = [ref] * B if shared else ref
    ref_lens = np.array([len(r) for r in refs], dtype=np.int64)
    if shared:
        ref_rows = torch.as_tensor(np.asarray(ref, dtype=np.int64),
                                   device=device)
    else:
        pad = np.full((B, int(ref_lens.max())), mat.shape[0], dtype=np.int64)
        for b, r in enumerate(refs):
            pad[b, :len(r)] = r
        ref_rows = torch.as_tensor(pad, device=device)
    C = ref_rows.shape[-1]
    score = np.zeros(B, dtype=np.int64)
    end_ref = np.full(B, -1, dtype=np.int64)
    end_read = np.zeros(B, dtype=np.int64)
    score2 = np.zeros(B, dtype=np.int64)
    ref_end2 = np.zeros(B, dtype=np.int64)
    word = np.zeros(B, dtype=bool)
    lens = np.array([len(r) for r in reads])

    def run_both():
        """One pass for both tiers (the quirk changes no value here)."""
        for g in _groups(lens, max_cells, C):
            rows = ref_rows if shared else ref_rows[torch.as_tensor(
                g, device=device)]
            fw = forward([reads[b] for b in g], rows, mat, gapO, gapE,
                         False, ref_len=None if shared else ref_lens[g],
                         keep_colmax=True, sat=sat, both_tiers=True)
            tier = fw.score + bias >= 255
            cm = torch.where(torch.as_tensor(tier, device=device)[:, None],
                             fw.colmax_word, fw.colmax)
            del fw.colmax, fw.colmax_word
            s2, r2 = second_best(cm, fw.end_ref, ml[g], ref_lens[g], tier)
            score[g], end_ref[g], end_read[g] = (fw.score, fw.end_ref,
                                                 fw.end_read)
            score2[g], ref_end2[g] = s2, r2
            word[g] = tier

    def run(idx, tier):
        for g in _groups(lens[idx], max_cells, C):
            sel = idx[g]
            rows = ref_rows if shared else ref_rows[torch.as_tensor(
                sel, device=device)]
            fw = forward([reads[b] for b in sel], rows, mat, gapO, gapE,
                         tier, ref_len=None if shared else ref_lens[sel],
                         keep_colmax=True, sat=sat)
            s2, r2 = second_best(fw.colmax, fw.end_ref, ml[sel],
                                 ref_lens[sel], np.full(len(sel), tier))
            del fw.colmax
            score[sel], end_ref[sel], end_read[sel] = (fw.score, fw.end_ref,
                                                       fw.end_read)
            score2[sel], ref_end2[sel] = s2, r2
            word[sel] = tier

    if int(mat.min()) >= -2 * gapE:
        run_both()
    else:
        run(np.arange(B), False)
        over = np.nonzero(score + bias >= 255)[0]
        if len(over):
            run(over, True)
    t1 = time.perf_counter()

    out = []
    for b in range(B):
        r = AlignResult()
        if score[b] > 0:
            r.score1 = int(score[b])
            r.ref_end1 = int(end_ref[b])
            r.read_end1 = int(end_read[b])
            if ml[b] >= 15:
                r.score2, r.ref_end2 = int(score2[b]), int(ref_end2[b])
            else:
                r.score2, r.ref_end2 = 0, -1
        out.append(r)

    def wants_begin(r):
        return r.score1 > 0 and not (flag == 0 or (flag == 2 and
                                                   r.score1 < filters))

    for tier in (False, True):
        sel = np.array([b for b in range(B)
                        if word[b] == tier and wants_begin(out[b])],
                       dtype=np.int64)
        if len(sel):
            _reverse(out, sel, reads, ref_rows, shared, mat, gapO, gapE,
                     tier, sat)
    t2 = time.perf_counter()

    tm["forward_s"] = tm.get("forward_s", 0.0) + t1 - t0
    tm["reverse_s"] = tm.get("reverse_s", 0.0) + t2 - t1
    if paths:
        add_paths(out, reads, refs, mat, gapO, gapE, flag=flag,
                  filters=filters, filterd=filterd, timings=tm)
    return out


def add_paths(out, reads, refs, mat, gapO: int, gapE: int, *, flag: int,
              filters: int = 0, filterd: int = 2 ** 31 - 1,
              timings: dict | None = None) -> None:
    """The banded CIGAR of each result whose begins are known, with the
    reference's verification retry at the full band; flag 1 where no
    path verifies (ref: src/ssw.c:936-975)."""
    t2 = time.perf_counter()
    mat = np.asarray(mat, dtype=np.int64)
    for b, r in enumerate(out):
        if r.score1 <= 0 or flag == 0 or (flag == 2 and r.score1 < filters):
            continue  # no begins were found (align_many's wants_begin)
        if (flag & 7) == 0 or ((flag & 2) and r.score1 < filters) or \
           ((flag & 4) and (r.ref_end1 - r.ref_begin1 > filterd or
                            r.read_end1 - r.read_begin1 > filterd)):
            continue
        sub_ref = refs[b][r.ref_begin1:r.ref_end1 + 1]
        sub_read = reads[b][r.read_begin1:r.read_end1 + 1]
        band = abs(len(sub_ref) - len(sub_read)) + 1
        full_band = max(len(sub_ref), len(sub_read))
        while True:
            path = banded_sw(sub_ref, sub_read, r.score1, gapO, gapE, band,
                             mat)
            if path is None:
                break
            if cigar_alignment_score(path, sub_ref, sub_read, mat, gapO,
                                     gapE) == r.score1:
                break
            if band >= full_band:
                path = None
                break
            band = full_band
        if path is None:
            r.flag = 1
        else:
            r.cigar = path
    if timings is not None:
        timings["banded_s"] = (timings.get("banded_s", 0.0)
                               + time.perf_counter() - t2)


def _reverse(out, sel, reads, ref_rows, shared, mat, gapO, gapE, tier, sat):
    """The begin-finding pass: each reversed read prefix against its
    reversed reference prefix, stopping at the first column whose max
    reaches score1 (ref: src/ssw.c:918-935).  The prefixes are read in
    windows that grow until every read has stopped or been read whole."""
    dev = ref_rows.device
    rev_reads = [reads[b][out[b].read_end1::-1] for b in sel]
    er = torch.as_tensor([out[b].ref_end1 for b in sel], device=dev).long()
    term = np.array([out[b].score1 for b in sel])
    prefix = (er + 1).cpu().numpy()
    rows = (ref_rows[None, :] if shared else
            ref_rows[torch.as_tensor(sel, device=dev)])
    W = 4 * max(len(r) for r in rev_reads) + 64
    while True:
        src = er[:, None] - torch.arange(W, device=dev)[None, :]
        win = torch.where(src >= 0, rows.expand(len(sel), -1).gather(
            1, src.clamp(0, rows.shape[-1] - 1)), mat.shape[0])
        fw = forward(rev_reads, win, mat, gapO, gapE, tier,
                     ref_len=np.minimum(prefix, W), terminate=term, sat=sat)
        if not ((prefix > W) & (fw.score < term)).any():
            break
        W *= 4
    for k, b in enumerate(sel):
        r = out[b]
        r.ref_begin1 = r.ref_end1 - int(fw.end_ref[k])
        r.read_begin1 = r.read_end1 - int(fw.end_read[k])
        if r.score1 > int(fw.score[k]):
            r.flag = 2


# --- output rendering ------------------------------------------------------

def mapq(score1: int, score2: int) -> int:
    """Frozen copy of ssw_tpu_torch/io/writers.py mapq (ref:
    src/main.c:220-222, C's double->uint32 truncations)."""
    d = abs(score1 - score2)
    m0 = 0 if d >= score1 else int(-4.343 * math.log(1.0 - d / score1))
    m = int(m0 + 4.99)
    return m if m < 254 else 254


def sam_record(a: AlignResult, ref_name: str, read_name: str, read_seq: str,
               qual: str | None, ref_num, read_num, strand: int) -> str:
    """Frozen copy of ssw_tpu_torch/io/writers.py sam_record (ref:
    src/main.c:215-244), returning the line."""
    if a.score1 == 0:
        return f"{read_name}\t4\t*\t0\t255\t*\t*\t0\t0\t*\t*\n"
    parts = [f"{read_name}\t", "16\t" if strand else "0\t",
             f"{ref_name}\t{a.ref_begin1 + 1}\t{mapq(a.score1, a.score2)}\t"]
    nm, cig = mark_mismatch(a.ref_begin1, a.read_begin1, a.read_end1,
                            ref_num, read_num, len(read_seq), a.cigar)
    parts.append(cigar_to_string(cig))
    parts.append(f"\t*\t0\t0\t{read_seq}\t")
    if qual is not None:
        parts.append(qual[::-1] if strand else qual)
    else:
        parts.append("*")
    parts.append(f"\tAS:i:{a.score1}\tNM:i:{nm}\t")
    parts.append(f"ZS:i:{a.score2}\n" if a.score2 > 0 else "\n")
    return "".join(parts)


def cli_sam_line(fwd: AlignResult, rc: AlignResult | None, ref_name: str,
                 ref_num, name: str, seq: bytes, qual: str | None,
                 filt: int = 0) -> str | None:
    """The record ssw_test writes for one read against one target under
    -c -s (and -r when `rc` is given): the reverse complement wins only
    when strictly better (ref: src/main.c:505-518)."""
    if rc is not None and rc.score1 > fwd.score1 and rc.score1 >= filt:
        rseq = reverse_complement(seq)
        return sam_record(rc, ref_name, name, rseq.decode("latin-1"), qual,
                          ref_num, encode(rseq), 1)
    if fwd.score1 > 0 and fwd.score1 >= filt:
        return sam_record(fwd, ref_name, name, seq.decode("latin-1"), qual,
                          ref_num, encode(seq), 0)
    return None


def aligner_fields(a: AlignResult, ref, query) -> tuple:
    """The C++ Aligner's Alignment as a tuple (sw_score,
    sw_score_next_best, ref_begin, ref_end, query_begin, query_end,
    ref_end_next_best, mismatches, cigar_string, flag): a frozen copy of
    ssw_tpu_torch/api.py _mark_mismatches (ref: src/ssw_cpp.cpp:123-204)."""
    i, j, nm = a.ref_begin1, a.read_begin1, 0
    parts = []
    if a.read_begin1 > 0:
        parts.append(f"{a.read_begin1}S")
    run_op, run_len = "", 0
    for c in a.cigar:
        op, ln = cigar_int_to_op(c), cigar_int_to_len(c)
        if op == "M":
            for _ in range(ln):
                cur = "=" if ref[i] == query[j] else "X"
                nm += cur == "X"
                if cur != run_op:
                    if run_len:
                        parts.append(f"{run_len}{run_op}")
                    run_op, run_len = cur, 0
                run_len += 1
                i += 1
                j += 1
        elif op in ("I", "D"):
            if run_len:
                parts.append(f"{run_len}{run_op}")
            run_op, run_len = "", 0
            nm += ln
            parts.append(f"{ln}{op}")
            if op == "I":
                j += ln
            else:
                i += ln
    if run_len:
        parts.append(f"{run_len}{run_op}")
    tail = len(query) - a.read_end1 - 1
    if tail > 0:
        parts.append(f"{tail}S")
    return (a.score1, a.score2, a.ref_begin1, a.ref_end1, a.read_begin1,
            a.read_end1, a.ref_end2, nm, "".join(parts), a.flag)

