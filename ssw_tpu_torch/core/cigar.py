"""BAM-style CIGAR codec + CIGAR utilities.

Encoding (ref: src/ssw.h:29-33,166-190): a CIGAR element is a uint32 with the
length in the high 28 bits and the op code in the low 4 bits, ops indexed into
"MIDNSHP=X".  `mark_mismatch` (ref: src/ssw.c:1019-1074) rewrites M runs into
'='/'X', adds soft clips, and returns the SAM NM count.
"""

from __future__ import annotations

import numpy as np

MAPSTR = "MIDNSHP=X"
_OP_CODE = {c: i for i, c in enumerate(MAPSTR)}
BAM_CIGAR_SHIFT = 4


def to_cigar_int(length: int, op: str) -> int:
    return (int(length) << BAM_CIGAR_SHIFT) | _OP_CODE.get(op, 0)


def cigar_int_to_op(c: int) -> str:
    low = c & 0xF
    return "M" if low > 8 else MAPSTR[low]


def cigar_int_to_len(c: int) -> int:
    return int(c) >> BAM_CIGAR_SHIFT


def cigar_to_string(cigar) -> str:
    return "".join(f"{cigar_int_to_len(c)}{cigar_int_to_op(c)}" for c in cigar)


def string_to_cigar(s: str) -> list[int]:
    out: list[int] = []
    num = ""
    for ch in s:
        if ch.isdigit():
            num += ch
        else:
            out.append(to_cigar_int(int(num), ch))
            num = ""
    return out


def cigar_alignment_score(cigar, ref, read, mat, gapO: int, gapE: int):
    """Re-score an alignment path; used to validate the banded traceback
    (ref: src/ssw.c:785-811).  Gap of length L costs gapO + (L-1)*gapE —
    the 'first gap base costs only gapO' convention (ref: README.md:38).

    Returns None when the path walks outside the sequences: the banded
    traceback's tail fix-up can append a 1M past the sub-rectangle
    (ref: src/ssw.c:745-762), where the reference re-scorer reads
    out-of-bounds garbage that fails its verification — None reproduces
    that failure deterministically.
    """
    score = 0
    i = j = 0  # i: ref pos, j: read pos
    mat = np.asarray(mat)
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


def mark_mismatch(ref_begin1: int, read_begin1: int, read_end1: int,
                  ref, read, read_len: int, cigar) -> tuple[int, list[int]]:
    """Split M runs into '='/'X', add soft clips, count NM.

    Returns (nm, new_cigar).  NM counts mismatches plus all inserted/deleted
    bases (ref: src/ssw.c:1019-1074).
    """
    nm = 0
    out: list[int] = []
    i = int(ref_begin1)
    j = int(read_begin1)
    if read_begin1 > 0:
        out.append(to_cigar_int(read_begin1, "S"))
    run_op = ""
    run_len = 0

    def flush():
        nonlocal run_len, run_op
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
        elif op == "I":
            flush()
            nm += ln
            out.append(to_cigar_int(ln, "I"))
            j += ln
            run_op = ""
        elif op == "D":
            flush()
            nm += ln
            out.append(to_cigar_int(ln, "D"))
            i += ln
            run_op = ""
        # any other op is silently dropped without advancing positions,
        # exactly like the reference's if/else chain (ref: src/ssw.c:1035-1062)
    flush()
    tail = read_len - read_end1 - 1
    if tail > 0:
        out.append(to_cigar_int(tail, "S"))
    return nm, out
