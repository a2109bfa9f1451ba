"""`pyssw.py`-compatible command line driver (ref: src/pyssw.py:189-376).

The reference pyssw is the Python twin of `ssw_test` with its own output
formats (it predates the C CLI's SAM polish): BLAST-like blocks built by
`buildPath` (ref: src/pyssw.py:145-186) and SAM records without soft clips
whose SEQ/QUAL are sliced to the aligned region (ref: src/pyssw.py:311-342).
Alignment semantics: flag=2 with zero filters (begins + cigar always,
ref: src/pyssw.py:233-234,263), maskLen = len(query)//2 with no floor
(ref: src/pyssw.py:259), and on ties the reverse-complement alignment wins
(`res[0] > resRc[0]` picks rc on equality, ref: src/pyssw.py:273-280).

Output framing: the reference was written for Python 2's `print x,`
soft-space rules but is executed under Python 3 where every fragment lands
on its own line; we reproduce the *intended* Python-2 semantics exactly
(CPython 2.7 softspace: a space separates fragments unless the previous
fragment ended with a non-space whitespace character).  Documented
reference bugs not reproduced: `args.bProtien` typo crashes `-p -r`
(ref: src/pyssw.py:227) — we warn and continue; `math.log(0)` crashes on
unique alignments (score2 == 0, ref: src/pyssw.py:316) — we cap MAPQ at 254
like the C CLI; `-f` is parsed but never used (ref: src/pyssw.py:361) — kept.

The counterpart of the JAX package's pyssw.py on the PyTorch/CUDA pipeline:
`main(..., device=None)` runs on the CUDA card and raises when there is
none; device="cpu" runs the plain PyTorch versions.

    python -m ssw_tpu_torch.pyssw [-c -s -header -p -r -a FILE] target query
"""

from __future__ import annotations

import argparse
import gzip
import math
import os
import sys
import timeit

import numpy as np

from ssw_tpu_torch import pipeline
from ssw_tpu_torch.core.encoding import AA_ORDER, BLOSUM50, parse_matrix_file

DNA_ELE = ["A", "C", "G", "T", "N"]
DNA_RC = {"A": "T", "C": "G", "G": "C", "T": "A",
          "a": "T", "c": "G", "g": "C", "t": "A"}


class Py2Printer:
    """CPython 2.7 `print` statement emulation (softspace semantics)."""

    def __init__(self, stream):
        self.stream = stream
        self.softspace = False

    def item(self, s: str):
        """`print s,` — trailing comma."""
        if self.softspace:
            self.stream.write(" ")
        self.stream.write(s)
        # ceval.c PRINT_ITEM: softspace unless s ends with non-space
        # whitespace (e.g. '\t' or '\n')
        self.softspace = (not s) or (not s[-1].isspace()) or s[-1] == " "

    def line(self, s: str = ""):
        """`print s` — no trailing comma."""
        if self.softspace:
            self.stream.write(" ")
        self.stream.write(s + "\n")
        self.softspace = False


def read(path: str):
    """pyssw's reader (ref: src/pyssw.py:19-99): extension-based gzip, 4-line
    FASTQ records, first-byte format sniff."""
    is_gz = path.lower().endswith((".gz", ".gzip"))
    op = (lambda: gzip.open(path, "rt")) if is_gz else (lambda: open(path))
    with op() as f:
        first = f.readline()
        if first.startswith(">"):
            fasta = True
        elif first.startswith("@"):
            fasta = False
        else:
            sys.stderr.write("file format cannot be recognized\n")
            sys.exit()
    with op() as f:
        if fasta:
            sid, seq = "", ""
            for line in f:
                if line.startswith(">"):
                    if seq:
                        yield sid, seq, ""
                    sid = line.strip()[1:].split()[0] if line.strip()[1:] else ""
                    seq = ""
                else:
                    seq += line.strip()
            yield sid, seq, ""
        else:
            for line in f:
                sid = line.strip()[1:].split()[0]
                seq = f.readline().strip()
                f.readline()
                qual = f.readline().strip()
                yield sid, seq, qual


def to_int(seq: str, ele2int: dict, n_ele: int) -> np.ndarray:
    """Unknown letters map to the last alphabet element
    (ref: src/pyssw.py:102-117)."""
    out = np.empty(len(seq), dtype=np.int32)
    last = n_ele - 1
    for i, ch in enumerate(seq):
        out[i] = ele2int.get(ch, last)
    return out


def build_path(q: str, r: str, qry_beg: int, ref_beg: int, cigar: list[int]):
    """CIGAR string + gapped alignment rows (ref: src/pyssw.py:145-186)."""
    info = "MIDNSHP=X"
    s_cigar, s_q, s_a, s_r = "", "", "", ""
    qo, ro = qry_beg, ref_beg
    for x in cigar:
        n, m = x >> 4, x & 15
        c = "M" if m > 8 else info[m]
        s_cigar += f"{n}{c}"
        if c == "M":
            s_q += q[qo:qo + n]
            s_a += "".join("|" if q[qo + j] == r[ro + j] else "*"
                           for j in range(n))
            s_r += r[ro:ro + n]
            qo += n
            ro += n
        elif c == "I":
            s_q += q[qo:qo + n]
            s_a += " " * n
            s_r += "-" * n
            qo += n
        elif c == "D":
            s_q += "-" * n
            s_a += " " * n
            s_r += r[ro:ro + n]
            ro += n
    return s_cigar, s_q, s_a, s_r


def _setup_alphabet(args):
    if not args.bProtein:
        if not args.sMatrix:
            ele = DNA_ELE
            e2i = {}
            for i, e in enumerate(ele):
                e2i[e] = i
                e2i[e.lower()] = i
            n = len(ele)
            mat = np.zeros((n, n), dtype=np.int8)
            for i in range(n - 1):
                for j in range(n - 1):
                    mat[i, j] = args.nMatch if i == j else -args.nMismatch
            return ele, e2i, mat
        mat, table = parse_matrix_file(args.sMatrix)
    else:
        if not args.sMatrix:
            ele = list(AA_ORDER)
            e2i = {}
            for i, e in enumerate(ele):
                e2i[e] = i
                e2i[e.lower()] = i
            return ele, e2i, BLOSUM50
        mat, table = parse_matrix_file(args.sMatrix)
    # reconstruct element list from the parsed ascii table
    n = mat.shape[0]
    ele = [""] * n
    for c in range(ord("A"), ord("Z") + 1):
        idx = int(table[c])
        if idx < n and not ele[idx]:
            ele[idx] = chr(c)
    for i in range(n):
        if not ele[i]:
            ele[i] = "*"
    e2i = {}
    for i, e in enumerate(ele):
        e2i[e] = i
        e2i[e.lower()] = i
    return ele, e2i, mat


def main(argv=None, out=None, err=None, device=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("-l", "--sLibPath", default="",
                        help="ignored (kept for pyssw flag parity)")
    parser.add_argument("-m", "--nMatch", type=int, default=2)
    parser.add_argument("-x", "--nMismatch", type=int, default=2)
    parser.add_argument("-o", "--nOpen", type=int, default=3)
    parser.add_argument("-e", "--nExt", type=int, default=1)
    parser.add_argument("-p", "--bProtein", action="store_true")
    parser.add_argument("-a", "--sMatrix", default="")
    parser.add_argument("-c", "--bPath", action="store_true")
    parser.add_argument("-f", "--nThr", default=0)  # parsed, unused (parity)
    parser.add_argument("-r", "--bBest", action="store_true")
    parser.add_argument("-s", "--bSam", action="store_true")
    parser.add_argument("-header", "--bHeader", action="store_true")
    parser.add_argument("target")
    parser.add_argument("query")
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        parser.print_help()
        return 0
    args = parser.parse_args(argv)
    device = pipeline.resolve_device(device)
    out = out or sys.stdout
    err = err or sys.stderr
    for path in (args.target, args.query):
        if not os.path.exists(path):
            err.write(f"Failed to open the file {path}.\n")
            return 1

    t1 = timeit.default_timer()
    _run(args, Py2Printer(out), err, device)
    t2 = timeit.default_timer()
    err.write("CPU time: {} seconds\n".format(t2 - t1))
    return 0


def _run(args, p: Py2Printer, err, device):
    ele, e2i, mat = _setup_alphabet(args)
    n_ele = len(ele)

    if args.bBest and args.bProtein:
        err.write("Reverse complement alignment is not available for "
                  "protein sequences.\n")

    flag = 2 if args.bPath else 0
    if args.bSam and args.bHeader and args.bPath:
        p.line("@HD\tVN:1.4\tSO:queryname")
        for rid, rseq, _ in read(args.target):
            p.line("@SQ\tSN:{}\tLN:{}".format(rid, len(rseq)))
    elif args.bSam and not args.bPath:
        err.write("SAM format output is only available together with "
                  "option -c.\n")
        args.bSam = False

    targets = [(rid, rseq) for rid, rseq, _ in read(args.target)]
    enc_targets = [to_int(rseq, e2i, n_ele) for _, rseq in targets]
    do_rc = args.bBest and not args.bProtein

    # batch queries for one device round-trip per target (output below is
    # re-serialized in pyssw's loop order)
    queries = list(read(args.query))
    if not queries:
        return
    enc_q = [to_int(q, e2i, n_ele) for _, q, _ in queries]
    mask_lens = [len(q) // 2 for _, q, _ in queries]
    rc_seqs = ["".join(DNA_RC.get(x, "N") for x in q[::-1])
               for _, q, _ in queries] if do_rc else None

    per_target = []
    for enc_t in enc_targets:
        req = pipeline.BatchRequest(
            reads=enc_q, ref=enc_t, mat=mat, gapO=args.nOpen, gapE=args.nExt,
            flag=flag, filters=0, filterd=0, mask_len=mask_lens,
            score_size=2)
        res = pipeline.align_batch(req, device)
        res_rc = None
        if do_rc:
            req_rc = pipeline.BatchRequest(
                reads=[to_int(s, e2i, n_ele) for s in rc_seqs], ref=enc_t,
                mat=mat, gapO=args.nOpen, gapE=args.nExt, flag=flag,
                filters=0, filterd=0, mask_len=mask_lens, score_size=2)
            res_rc = pipeline.align_batch(req_rc, device)
        per_target.append((res, res_rc))

    for qi, (qid, qseq, qqual) in enumerate(queries):
        for ti, (rid, rseq) in enumerate(targets):
            if mask_lens[qi] < 15:
                # printed by the C library inside each ssw_align call
                # (1 + rc per pair, ref: src/ssw.c:876-878)
                for _ in range(2 if do_rc else 1):
                    err.write("When maskLen < 15, the function ssw_align "
                              "doesn't return 2nd best alignment "
                              "information.\n")
            res_l, res_rc_l = per_target[ti]
            r = res_l[qi]
            r_rc = res_rc_l[qi] if res_rc_l else None
            if r_rc is None or r.score1 > r_rc.score1:
                rp, strand, q_used = r, 0, qseq
            else:
                rp, strand, q_used = r_rc, 1, rc_seqs[qi]
            cig, s_q, s_a, s_r = build_path(q_used, rseq, rp.read_begin1,
                                            rp.ref_begin1, rp.cigar or [])
            _emit(p, args, qid, rid, qseq, qqual, q_used, rp, strand,
                  cig, s_q, s_a, s_r)


def _emit(p: Py2Printer, args, qid, rid, qseq, qqual, q_used, rp, strand,
          cig, s_q, s_a, s_r):
    if not args.bSam:
        p.item("target_name: {}\nquery_name: {}\n"
               "optimal_alignment_score: {}\t".format(rid, qid, rp.score1))
        if rp.score2 > 0:
            p.item("suboptimal_alignment_score: {}\t".format(rp.score2))
        p.item("strand: +\t" if strand == 0 else "strand: -\t")
        if rp.ref_begin1 + 1:
            p.item("target_begin: {}\t".format(rp.ref_begin1 + 1))
        p.item("target_end: {}\t".format(rp.ref_end1 + 1))
        if rp.read_begin1 + 1:
            p.item("query_begin: {}\t".format(rp.read_begin1 + 1))
        p.line("query_end: {}\n".format(rp.read_end1 + 1))
        if rp.cigar:
            n1 = 1 + rp.ref_begin1
            n2 = min(60, len(s_r)) + rp.ref_begin1 - s_r.count("-", 0, 60)
            n3 = 1 + rp.read_begin1
            n4 = min(60, len(s_q)) + rp.read_begin1 - s_q.count("-", 0, 60)
            for i in range(0, len(s_q), 60):
                p.line("Target:{:>8}\t{}\t{}".format(n1, s_r[i:i + 60], n2))
                n1 = n2 + 1
                n2 = n2 + min(60, len(s_r) - i - 60) - s_r.count("-", i + 60,
                                                                 i + 120)
                p.line("{: ^15}\t{}".format("", s_a[i:i + 60]))
                p.line("Query:{:>9}\t{}\t{}\n".format(n3, s_q[i:i + 60], n4))
                n3 = n4 + 1
                n4 = n4 + min(60, len(s_q) - i - 60) - s_q.count("-", i + 60,
                                                                 i + 120)
    else:
        p.item("{}\t".format(qid))
        if rp.score1 == 0:
            p.item("4\t*\t0\t255\t*\t*\t0\t0\t*\t*")
            p.line()
            return
        # MAPQ (ref: src/pyssw.py:316-318); log(0) capped instead of crashing
        ratio = 1 - abs(rp.score1 - rp.score2) / float(rp.score1)
        mapq = 254 if ratio <= 0 else int(int(-4.343 * math.log(ratio)) + 4.99)
        mapq = min(mapq, 254)
        p.item("16\t" if strand else "0\t")
        p.item("{}\t{}\t{}\t".format(rid, rp.ref_begin1 + 1, mapq))
        p.item(cig)
        p.item("\t*\t0\t0\t")
        p.item(q_used[rp.read_begin1:rp.read_end1 + 1])
        p.item("\t")
        if qqual:
            if strand == 0:
                p.item(qqual[rp.read_begin1:rp.read_end1 + 1])
            else:
                # verbatim slice semantics incl. the reference's off-by-one
                # at query_end == len-1, AND the source's missing trailing
                # comma — the Py2 statement `print sQQual[...]` (no comma,
                # ref: src/pyssw.py:334) emits a newline and resets
                # softspace mid-record.  Unreachable in the reference (its
                # `bProtien` typo crashes every -r run) but reproduced
                # faithfully.
                p.line(qqual[-rp.read_begin1 - 1:-rp.read_end1 - 1:-1])
        else:
            p.item("*")
        p.item("\tAS:i:{}".format(rp.score1))
        p.item("\tNM:i:{}\t".format(len(s_a) - s_a.count("|")))
        if rp.score2 > 0:
            p.line("ZS:i:{}".format(rp.score2))
        else:
            p.line()


if __name__ == "__main__":
    sys.exit(main())
