"""NumPy golden model of the reference SSW pipeline.

This is the *semantic specification* the device kernels are tested against.  It
reproduces the observable behavior of the reference C engine exactly — not by
re-implementing SSE byte/word arithmetic, but by computing the DP exactly in
int64 and emulating the places where the SIMD formulation is observable:

  * kernel tier selection: the byte kernel's result is accepted iff
    max_score + bias < 255, else the word kernel reruns
    (ref: src/ssw.c:329,881-891);
  * segment padding: the striped layout pads the read to ceil(len/16)*16
    (byte) or ceil(len/8)*8 (word) positions whose profile entries score 0,
    so padded cells propagate values diagonally at zero cost and participate
    in the per-column maxima used for the suboptimal score
    (ref: src/ssw.c:169,181-184,338);
  * the suboptimal-score window asymmetry: the byte kernel scans columns
    [0, end-maskLen) and (end+maskLen, refLen), the word kernel scans
    [0, end-maskLen) and [end+maskLen, refLen) (ref: src/ssw.c:368-381 vs
    570-583);
  * the lazy-F quirk: E is refreshed from the H values of the *first* inner
    pass, i.e. H corrected only by F propagation local to a SIMD lane's
    contiguous block of `segLen` read positions; F corrections that crossed
    lanes in the lazy loop are never seen by E (ref: src/ssw.c:288-291 vs
    301-315 — "don't update E").  This forbids a deletion immediately
    following an insertion whose run crossed a lane-block boundary and is
    observable whenever min(mat) < -2*gapE (e.g. BLOSUM matrices).

Assumes gapO >= gapE (holds for the reference CLI and every published
scoring scheme; with gapO < gapE the reference's own lazy loop is not a
fixpoint either).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import sys

import numpy as np

from ssw_tpu_torch.core.cigar import cigar_alignment_score, to_cigar_int
from ssw_tpu_torch.core.encoding import matrix_bias

NEG_INF = np.int64(-(2 ** 40))


def seg_len(read_len: int, word: bool) -> int:
    """Farrar segment length: lanes hold contiguous blocks of this size
    (ref: src/ssw.c:169 byte, src/ssw.c:393 word)."""
    lanes = 8 if word else 16
    return (read_len + lanes - 1) // lanes


def _pad_len(read_len: int, word: bool) -> int:
    return seg_len(read_len, word) * (8 if word else 16)


@dataclass
class ForwardResult:
    score: int              # exact best score (uncapped)
    end_ref: int            # first column attaining the max (-1 if score==0)
    end_read: int           # min read index attaining the max in that column
    max_column: np.ndarray  # per-column max incl. striping pads (int64)
    word: bool              # which tier's pad geometry max_column used


def sw_forward_striped_sim(ref: np.ndarray, read: np.ndarray, mat: np.ndarray,
                           gapO: int, gapE: int, word: bool,
                           terminate: int = 0) -> ForwardResult:
    """Bug-compatible simulation of the reference SIMD kernel mechanics.

    Replicates the first inner pass, the lazy-F sweeps with their
    segment-granular early exit (ref: src/ssw.c:301-315), and the striped
    lane layout.  The early exit truncates F propagation across lane blocks
    in a way that can *lose* score relative to the true DP when
    gapO <= gapE (reopening a gap ties/beats extending, so the exit's
    dominance argument fails).  Used by `sw_forward` for those regimes; the
    closed-form path is exact for gapO > gapE.
    """
    ref = np.asarray(ref, dtype=np.int64)
    read = np.asarray(read, dtype=np.int64)
    mat = np.asarray(mat, dtype=np.int64)
    rl = len(read)
    lanes = 8 if word else 16
    sl = seg_len(rl, word)
    L = sl * lanes
    prof = np.zeros((mat.shape[0], L), dtype=np.int64)
    prof[:, :rl] = mat[:, read]
    base = np.arange(lanes) * sl  # position of (segment j, lane s) = j + s*sl

    H = np.zeros(L, dtype=np.int64)
    E = np.zeros(L, dtype=np.int64)
    n_ref = len(ref)
    max_column = np.zeros(n_ref, dtype=np.int64)
    gmax = 0
    end_ref = -1
    h_best = np.zeros(L, dtype=np.int64)

    for i in range(n_ref):
        Hn = np.zeros(L, dtype=np.int64)
        En = np.zeros(L, dtype=np.int64)
        vH = np.concatenate(([0], H[(sl - 1) + base[:-1]]))
        vF = np.zeros(lanes, dtype=np.int64)
        vMaxCol = np.zeros(lanes, dtype=np.int64)
        sub = prof[ref[i]]
        for j in range(sl):
            p = base + j
            vH = np.maximum(vH + sub[p], 0)
            e = E[p]
            vH = np.maximum(np.maximum(vH, e), vF)
            vMaxCol = np.maximum(vMaxCol, vH)
            Hn[p] = vH
            vHgo = np.maximum(vH - gapO, 0)
            En[p] = np.maximum(np.maximum(e - gapE, 0), vHgo)
            vF = np.maximum(np.maximum(vF - gapE, 0), vHgo)
            vH = H[p]
        done = False
        for _ in range(lanes):
            vF = np.concatenate(([0], vF[:-1]))
            for j in range(sl):
                p = base + j
                vH = np.maximum(Hn[p], vF)
                vMaxCol = np.maximum(vMaxCol, vH)
                Hn[p] = vH
                vHgo = np.maximum(vH - gapO, 0)
                vF = np.maximum(vF - gapE, 0)
                if np.all(vF <= vHgo):
                    done = True
                    break
            if done:
                break
        H, E = Hn, En
        cmax = int(vMaxCol.max())
        max_column[i] = cmax
        if cmax > gmax:
            gmax = cmax
            end_ref = i
            h_best = H.copy()
        if terminate and cmax == terminate:
            max_column = max_column[: i + 1]
            break

    end_read = rl - 1
    real = np.nonzero(h_best[:rl] == gmax)[0]
    if gmax > 0 and len(real):
        end_read = int(real[0])
    return ForwardResult(gmax, end_ref, end_read, max_column, word)


def sw_forward(ref: np.ndarray, read: np.ndarray, mat: np.ndarray,
               gapO: int, gapE: int, word: bool,
               terminate: int = 0) -> ForwardResult:
    """Column-major exact affine-gap local DP with lane-quirk emulation.

    Per ref column i (all values clamped at 0):
      h_tilde[j] = max(0, H[i-1][j-1] + sub, E[j])
      F_loc[j]   = within-lane-block prefix of max(h_tilde[k]-gapO-(j-1-k)gapE)
      F[j]       = unrestricted prefix of the same
      H[i][j]    = max(h_tilde[j], F[j])
      E[j]      <- max(E[j]-gapE, max(h_tilde, F_loc)[j]-gapO)   (the quirk)

    `terminate`: stop after the first column whose max equals it (used by the
    begin-finding reverse pass, ref: src/ssw.c:339).
    """
    if gapO <= gapE:
        # the reference's lazy-F early exit is lossy here; be bug-compatible
        return sw_forward_striped_sim(ref, read, mat, gapO, gapE, word,
                                      terminate)
    ref = np.asarray(ref, dtype=np.int64)
    read = np.asarray(read, dtype=np.int64)
    mat = np.asarray(mat, dtype=np.int64)
    n_ref = len(ref)
    rl = len(read)
    lanes = 8 if word else 16
    sl = seg_len(rl, word)
    L = sl * lanes
    prof = np.zeros((mat.shape[0], L), dtype=np.int64)
    prof[:, :rl] = mat[:, read]

    H = np.zeros(L, dtype=np.int64)
    E = np.zeros(L, dtype=np.int64)
    idx = np.arange(L, dtype=np.int64)
    decay = idx * gapE
    max_column = np.zeros(n_ref, dtype=np.int64)
    gmax = 0
    end_ref = -1
    h_best = np.zeros(L, dtype=np.int64)

    for i in range(n_ref):
        sub = prof[ref[i]]
        h_diag = np.concatenate(([0], H[:-1])) + sub
        h_tilde = np.maximum(np.maximum(h_diag, E), 0)
        # shared scan source: c[j] = h_tilde[j] - gapO + j*gapE
        c = h_tilde - gapO + decay
        # full prefix-max -> F
        cm = np.maximum.accumulate(c)
        F = np.concatenate(([NEG_INF], cm[:-1] - decay[1:] + gapE))
        F = np.maximum(F, 0)
        H = np.maximum(h_tilde, F)
        # lane-blocked prefix-max -> F_loc (resets every sl positions)
        cb = np.maximum.accumulate(c.reshape(lanes, sl), axis=1).reshape(L)
        F_loc = np.concatenate(([NEG_INF], cb[:-1] - decay[1:] + gapE))
        F_loc = np.maximum(F_loc, 0)
        F_loc[idx % sl == 0] = 0
        h_fp = np.maximum(h_tilde, F_loc)
        E = np.maximum(np.maximum(E - gapE, h_fp - gapO), 0)
        cmax = int(H.max())
        max_column[i] = cmax
        if cmax > gmax:
            gmax = cmax
            end_ref = i
            h_best = H.copy()
        if terminate and cmax == terminate:
            max_column = max_column[: i + 1]
            break

    end_read = rl - 1
    real = np.nonzero(h_best[:rl] == gmax)[0]
    if gmax > 0 and len(real):
        end_read = int(real[0])
    return ForwardResult(gmax, end_ref, end_read, max_column, word)


def second_best(max_column: np.ndarray, end_ref: int, mask_len: int,
                ref_len: int, word: bool) -> tuple[int, int]:
    """Suboptimal score scan outside the maskLen window around end_ref.

    Byte tier: columns [0, max(end-maskLen,0)) and (min(end+maskLen,refLen),
    refLen); word tier starts the upper scan at the window edge itself
    (ref: src/ssw.c:368-381, 570-583).  First strictly-greater column wins.
    """
    score2 = 0
    ref_end2 = 0
    lo_edge = max(end_ref - mask_len, 0)
    for i in range(lo_edge):
        if max_column[i] > score2:
            score2 = int(max_column[i])
            ref_end2 = i
    hi_edge = min(end_ref + mask_len, ref_len)
    start = hi_edge if word else hi_edge + 1
    for i in range(start, ref_len):
        if max_column[i] > score2:
            score2 = int(max_column[i])
            ref_end2 = i
    return score2, ref_end2


def banded_sw(ref: np.ndarray, read: np.ndarray, score: int, gapO: int,
              gapE: int, band_width: int, mat: np.ndarray):
    """Banded affine DP + traceback emitting a BAM cigar.

    Row-vectorized reimplementation of the reference's scalar routine with
    identical semantics: internal band-doubling loop, cross-iteration max
    bookkeeping, tie-break rules (diagonal wins ties; E beats F only when
    strictly greater; E/F prefer the gap-open predecessor only when strictly
    greater) and the trailing-1M fixup (ref: src/ssw.c:590-783).  Returns a
    list[int] cigar or None on traceback failure.
    """
    ref = np.asarray(ref, dtype=np.int64)
    read = np.asarray(read, dtype=np.int64)
    mat = np.asarray(mat, dtype=np.int64)
    ref_len = len(ref)
    read_len = len(read)
    neg_inf = np.int64(-(2 ** 30))
    length = max(ref_len, read_len)
    best = 0
    best_i = 0
    best_j = 0
    direction = None
    sub_rows = mat[ref]  # sub_rows[j, c]: score of ref[j] vs letter c

    while True:
        width = band_width * 2 + 3
        width_d = band_width * 2 + 1
        h_b = np.zeros(width, dtype=np.int64)
        e_b = np.zeros(width, dtype=np.int64)
        h_c = np.zeros(width, dtype=np.int64)
        # per row: 3 planes (e, f, h) of direction codes across the band
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
            u = js - off_cur + 1          # this row's band slots
            eu = js - off_prev + 1        # previous row's slots for (i-1, j)
            du = js - 1 - off_prev + 1    # previous row's slots for (i-1, j-1)
            d = js - off_cur              # direction slots

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
            # f scan along the row: C computes f[j] = max(h_c[j-1]-gapO,
            # f[j-1]-gapE) with h_c the final row H including f; under
            # gapO>=gapE the f-sourced part of h_c is dominated by plain
            # extension, so the scan sources reduce to max(e1, diag) of the
            # left neighbor (h_c[slot beg-1] == 0 supplies the row entry).
            h_nof = np.maximum(e1, diag)  # e1 >= 0 supplies the local clamp
            if gapO < gapE:
                # shortcut invalid (opening from an f-sourced H can beat
                # extension); run the exact scalar recurrence with full h
                f = np.empty(len(js), dtype=np.int64)
                f_run = np.int64(neg_inf)
                h_prev = np.int64(0)       # h_c[beg-1] boundary
                for k in range(len(js)):
                    f_run = max(h_prev - gapO, f_run - gapE)
                    f[k] = f_run
                    h_prev = max(h_nof[k], max(f_run, 0))
            else:
                k = np.arange(len(js), dtype=np.int64)
                src = np.concatenate(([np.int64(-gapO)], h_nof[:-1] - gapO))
                f = np.maximum.accumulate(src + k * gapE) - k * gapE
            f1 = np.maximum(f, 0)
            h_row = np.maximum(h_nof, f1)
            # direction planes for f and h with exact C comparisons
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
                # C scans j ascending updating on strictly-greater cells, so
                # the surviving (i, j) is the first cell attaining the row max
                best = row_best
                best_i = i
                best_j = int(js[int(np.argmax(h_row == row_best))])
            h_b[1:u[-1] + 1] = h_c[1:u[-1] + 1]
        band_width *= 2
        if not (best < score and band_width <= length):
            break
    band_width //= 2

    # traceback (ref: src/ssw.c:682-773)
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
            i -= 1
            j -= 1
            plane = 2
            op = "M"
        elif dcode == 2:
            i -= 1
            plane = 0
            op = "I"
        elif dcode == 3:
            i -= 1
            plane = 2
            op = "I"
        elif dcode == 4:
            j -= 1
            plane = 1
            op = "D"
        elif dcode == 5:
            j -= 1
            plane = 2
            op = "D"
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


def ssw_align(read: np.ndarray, ref: np.ndarray, mat: np.ndarray,
              gapO: int, gapE: int, flag: int = 0x0F, filters: int = 0,
              filterd: int = 2 ** 31 - 1, mask_len: int = 15,
              score_size: int = 2):
    """Full reference pipeline: forward pass -> tier selection -> suboptimal
    scan -> reverse begin-finding pass -> banded cigar with verification
    (ref: src/ssw.c:855-977).  Returns AlignResult, or None where the
    reference returns NULL (byte-only profile overflowing).
    """
    read = np.asarray(read)
    ref = np.asarray(ref)
    bias = matrix_bias(mat)
    ref_len = len(ref)

    if score_size == 1:
        word = True
        fwd = sw_forward(ref, read, mat, gapO, gapE, word=True)
    else:
        word = False
        fwd = sw_forward(ref, read, mat, gapO, gapE, word=False)
        if fwd.score + bias >= 255:
            if score_size == 0:
                # ref warns and returns NULL (src/ssw.c:887-891)
                sys.stderr.write(
                    "Please set 2 to the score_size parameter of the "
                    "function ssw_init, otherwise the alignment results "
                    "will be incorrect.\n")
                return None
            word = True
            fwd = sw_forward(ref, read, mat, gapO, gapE, word=True)
    score1 = fwd.score

    r = AlignResult()
    if score1 <= 0:
        return r
    r.score1 = score1
    r.ref_end1 = fwd.end_ref
    r.read_end1 = fwd.end_read
    if mask_len >= 15:
        r.score2, r.ref_end2 = second_best(fwd.max_column, fwd.end_ref,
                                           mask_len, ref_len, word)
    else:
        r.score2, r.ref_end2 = 0, -1

    if flag == 0 or (flag == 2 and r.score1 < filters):
        return r

    # reverse pass: align reversed read prefix against reversed ref prefix,
    # stopping at the first column reaching score1 (ref: src/ssw.c:918-935)
    read_prefix_rev = read[r.read_end1::-1]
    ref_prefix_rev = ref[r.ref_end1::-1]
    rev = sw_forward(ref_prefix_rev, read_prefix_rev, mat, gapO, gapE,
                     word=word, terminate=r.score1)
    r.ref_begin1 = r.ref_end1 - rev.end_ref
    r.read_begin1 = r.read_end1 - rev.end_read
    if r.score1 > rev.score:
        # the reference library prints this itself (ref: src/ssw.c:933)
        sys.stderr.write("Warning: The alignment path of one pair of "
                         "sequences may miss a small part. "
                         "[ssw.c ssw_align]\n")
        r.flag = 2

    if (flag & 7) == 0 or ((flag & 2) and r.score1 < filters) or \
       ((flag & 4) and (r.ref_end1 - r.ref_begin1 > filterd or
                        r.read_end1 - r.read_begin1 > filterd)):
        return r

    # banded cigar + verification retry (ref: src/ssw.c:940-957)
    sub_ref = ref[r.ref_begin1:r.ref_end1 + 1]
    sub_read = read[r.read_begin1:r.read_end1 + 1]
    band_width = abs(len(sub_ref) - len(sub_read)) + 1
    full_band = max(len(sub_ref), len(sub_read))
    path = None
    while True:
        path = banded_sw(sub_ref, sub_read, r.score1, gapO, gapE, band_width, mat)
        if path is None:
            break
        if cigar_alignment_score(path, sub_ref, sub_read, mat, gapO, gapE) == r.score1:
            break
        if band_width >= full_band:
            path = None
            break
        band_width = full_band
    if path is None:
        r.flag = 1
    else:
        r.cigar = path
    return r
