"""Output emitters reproducing ssw_test's formats byte-for-byte.

  * BLAST-like triple-row 60-column blocks with the reference's exact
    resume/carry state machine (ref: src/main.c:129-214);
  * SAM records incl. the MAPQ computation with C's double->uint32
    truncation semantics (truncate BEFORE adding 4.99; +inf truncates to 0
    on x86) and AS/NM/ZS tags (ref: src/main.c:215-244).
"""

from __future__ import annotations

import math

from ssw_tpu_torch.core.cigar import cigar_int_to_len, cigar_int_to_op, mark_mismatch


def mapq(score1: int, score2: int) -> int:
    """MAPQ formula (ref: src/main.c:220-222): the double result is first
    truncated into uint32 (C cast), then 4.99 is added and truncated again.
    score2 == score1 gives 4; score2 == 0 makes the log argument 0 -> +inf,
    which the C cast turns into 0 (x86 cvttsd2si low-word), also giving 4."""
    d = abs(score1 - score2)
    if d >= score1:
        m0 = 0  # log(0) -> inf path
    else:
        m0 = int(-4.343 * math.log(1.0 - d / score1))
    m = int(m0 + 4.99)
    return m if m < 254 else 254


def blast_like(out, a, ref_name: str, read_name: str, ref_seq: str,
               read_seq: str, table, strand: int) -> None:
    """BLAST-like block (ref: src/main.c:129-214).  `a` carries score1,
    score2, ref/read begin/end (0-based) and the M/I/D cigar; `table` is the
    ASCII->code array used for match/mismatch marks."""
    w = out.write
    w(f"target_name: {ref_name}\nquery_name: {read_name}\n"
      f"optimal_alignment_score: {a.score1}\t")
    if a.score2 > 0:
        w(f"suboptimal_alignment_score: {a.score2}\t")
    w("strand: +\t" if strand == 0 else "strand: -\t")
    if a.ref_begin1 + 1:
        w(f"target_begin: {a.ref_begin1 + 1}\t")
    w(f"target_end: {a.ref_end1 + 1}\t")
    if a.read_begin1 + 1:
        w(f"query_begin: {a.read_begin1 + 1}\t")
    w(f"query_end: {a.read_end1 + 1}\n\n")
    if not a.cigar:
        return

    ops = [(cigar_int_to_op(c), cigar_int_to_len(c)) for c in a.cigar]
    n_ops = len(ops)
    e = 0
    left = 0
    qb = a.ref_begin1
    pb = a.read_begin1
    while e < n_ops or left > 0:
        # target row
        count = 0
        q = qb
        w(f"Target: {q + 1:8d}    ")
        brk = False
        for c in range(e, n_ops):
            letter, length = ops[c]
            l = left if (count == 0 and left > 0) else length
            for _ in range(l):
                if letter == "I":
                    w("-")
                else:
                    w(ref_seq[q])
                    q += 1
                count += 1
                if count == 60:
                    brk = True
                    break
            if brk:
                break
        w(f"    {q}\n                    ")
        # match row
        q = qb
        p = pb
        count = 0
        brk = False
        for c in range(e, n_ops):
            letter, length = ops[c]
            l = left if (count == 0 and left > 0) else length
            for _ in range(l):
                if letter == "M":
                    w("|" if table[ord(ref_seq[q])] == table[ord(read_seq[p])]
                      else "*")
                    q += 1
                    p += 1
                else:
                    w(" ")
                    if letter == "I":
                        p += 1
                    else:
                        q += 1
                count += 1
                if count == 60:
                    qb = q
                    brk = True
                    break
            if brk:
                break
        # query row
        p = pb
        w(f"\nQuery:  {p + 1:8d}    ")
        count = 0
        brk = False
        for c in range(e, n_ops):
            letter, length = ops[c]
            l = left if (count == 0 and left > 0) else length
            for i in range(l):
                if letter == "D":
                    w("-")
                else:
                    w(read_seq[p])
                    p += 1
                count += 1
                if count == 60:
                    pb = p
                    left = l - i - 1
                    e = c + 1 if left == 0 else c
                    brk = True
                    break
            if brk:
                break
        if not brk:
            e = n_ops
            left = 0
        w(f"    {p}\n\n")


def sam_record(out, a, ref_name: str, read_name: str, read_seq: str,
               qual: str | None, ref_num, read_num, strand: int) -> None:
    """One SAM line (ref: src/main.c:215-244).  Mutates a.cigar the way the
    reference does (mark_mismatch rewrites it in place before printing)."""
    w = out.write
    w(f"{read_name}\t")
    if a.score1 == 0:
        w("4\t*\t0\t255\t*\t*\t0\t0\t*\t*\n")
        return
    mq = mapq(a.score1, a.score2)
    w("16\t" if strand else "0\t")
    w(f"{ref_name}\t{a.ref_begin1 + 1}\t{mq}\t")
    mismatch, new_cigar = mark_mismatch(a.ref_begin1, a.read_begin1,
                                        a.read_end1, ref_num, read_num,
                                        len(read_seq), a.cigar)
    a.cigar = new_cigar
    for c in new_cigar:
        w(f"{cigar_int_to_len(c)}{cigar_int_to_op(c)}")
    w("\t*\t0\t0\t")
    w(read_seq)
    w("\t")
    if qual is not None and strand:
        w(qual[::-1])
    elif qual is not None:
        w(qual)
    else:
        w("*")
    w(f"\tAS:i:{a.score1}")
    w(f"\tNM:i:{mismatch}\t")
    if a.score2 > 0:
        w(f"ZS:i:{a.score2}\n")
    else:
        w("\n")
