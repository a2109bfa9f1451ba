"""Public API mirroring both reference surfaces:

  * the C API `ssw_init` / `ssw_align` (ref: src/ssw.h:86-134) as
    `Profile` + `align` / `align_batch`;
  * the C++ `StripedSmithWaterman::Aligner/Filter/Alignment` wrapper
    (ref: src/ssw_cpp.h:13-262, src/ssw_cpp.cpp) as the same-named classes,
    including its quirks: the default 5x5 matrix scores N as -mismatch
    (src/ssw_cpp.cpp:42-49), maskLen is clamped to >= 15
    (src/ssw_cpp.cpp:330), report_cigar sets flag bits 0x0f
    (src/ssw_cpp.cpp:206-213), and cigar strings carry soft clips
    (src/ssw_cpp.cpp:52-87,123-204).

Batched execution (`align_batch`, `Aligner.align_batch`) is this
package's extension: thousands of queries per device call.  The
PyTorch/CUDA counterpart of the JAX package's api.py: every entry point
takes `device` (None: the CUDA card, raising when there is none; "cpu":
the plain PyTorch versions) where that module takes `backend`.
`Aligner.set_reference_sequence` translates the reference once and keeps
that one array, so the pipeline's device copy of it (cached by identity)
is uploaded once for every later `align` against it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ssw_tpu_torch import pipeline, profiling
from ssw_tpu_torch.core import oracle
from ssw_tpu_torch.core.cigar import (cigar_int_to_len, cigar_int_to_op,
                                      to_cigar_int)

AlignResult = oracle.AlignResult


class Profile:
    """Query profile (ssw_init equivalent, ref: src/ssw.c:826-847)."""

    def __init__(self, read, mat, score_size: int = 2):
        self.read = np.asarray(read, dtype=np.int8)
        self.mat = np.asarray(mat, dtype=np.int8)
        if self.mat.ndim == 1:
            n = int(np.sqrt(self.mat.size))
            self.mat = self.mat.reshape(n, n)
        self.n = self.mat.shape[0]
        self.score_size = score_size


def align(profile_or_read, ref, gapO: int, gapE: int, *, mat=None,
          flag: int = 0x0F, filters: int = 0, filterd: int = 2 ** 31 - 1,
          mask_len: int = 15, score_size: int = 2, device=None):
    """Single-pair ssw_align equivalent (ref: src/ssw.c:855-977).

    Returns AlignResult or None (NULL-result parity for byte-only overflow).
    """
    if isinstance(profile_or_read, Profile):
        p = profile_or_read
    else:
        p = Profile(profile_or_read, mat, score_size)
    res = align_batch([p.read], ref, p.mat, gapO, gapE, flag=flag,
                      filters=filters, filterd=filterd, mask_len=mask_len,
                      score_size=p.score_size, device=device)
    return res[0]


def align_batch(reads, ref, mat, gapO: int, gapE: int, *, flag: int = 0x0F,
                filters: int = 0, filterd: int = 2 ** 31 - 1,
                mask_len=15, score_size: int = 2, device=None):
    """Batched alignment of many reads against one target (one device
    round-trip for the whole batch)."""
    req = pipeline.BatchRequest(
        reads=[np.asarray(r, dtype=np.int32) for r in reads],
        ref=np.asarray(ref, dtype=np.int32), mat=np.asarray(mat),
        gapO=gapO, gapE=gapE, flag=flag, filters=filters, filterd=filterd,
        mask_len=mask_len, score_size=score_size)
    return pipeline.align_batch(req, device=device)


# --------------------------------------------------------------------------
# C++-wrapper-compatible surface (StripedSmithWaterman namespace)
# --------------------------------------------------------------------------

@dataclass
class Filter:
    """ref: src/ssw_cpp.h:40-63."""
    report_begin_position: bool = True
    report_cigar: bool = True
    score_filter: int = 0
    distance_filter: int = 32767


@dataclass
class Alignment:
    """ref: src/ssw_cpp.h:65-90."""
    sw_score: int = 0
    sw_score_next_best: int = 0
    ref_begin: int = -1
    ref_end: int = 0
    query_begin: int = -1
    query_end: int = 0
    ref_end_next_best: int = 0
    mismatches: int = 0
    cigar_string: str = ""
    cigar: list = field(default_factory=list)


def _cpp_default_matrix(match: int, mismatch: int) -> np.ndarray:
    """5x5 with N scoring -mismatch everywhere (ref: src/ssw_cpp.cpp:26-50).
    Note this differs from ssw_test's matrix where N rows/cols are 0."""
    m = np.full((5, 5), -mismatch, dtype=np.int8)
    for i in range(4):
        m[i, i] = match
    return m


_CPP_BASE_TABLE = np.full(256, 4, dtype=np.int8)
for _c, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _CPP_BASE_TABLE[ord(_c)] = _v
    _CPP_BASE_TABLE[ord(_c.lower())] = _v


class Aligner:
    """StripedSmithWaterman::Aligner equivalent (ref: src/ssw_cpp.h:92-261).

    align()/align_batch() return (flag, Alignment)/(flags, alignments):
    flag is the s_align accuracy code (0 exact, 1 banded failed, 2 path
    may miss a part), matching AlignImpl's return (src/ssw_cpp.cpp:350)."""

    def __init__(self, match_score: int = 2, mismatch_penalty: int = 2,
                 gap_opening_penalty: int = 3, gap_extending_penalty: int = 1,
                 score_matrix=None, translation_matrix=None,
                 device=None):
        self.gap_open = gap_opening_penalty
        self.gap_extend = gap_extending_penalty
        self.device = device
        if score_matrix is not None:
            self.matrix = np.asarray(score_matrix, dtype=np.int8)
            if self.matrix.ndim == 1:
                n = int(np.sqrt(self.matrix.size))
                self.matrix = self.matrix.reshape(n, n)
            self.table = (np.asarray(translation_matrix, dtype=np.int8)
                          if translation_matrix is not None
                          else _CPP_BASE_TABLE)
        else:
            self.matrix = _cpp_default_matrix(match_score, mismatch_penalty)
            self.table = _CPP_BASE_TABLE
        self._reference = None

    def set_reference_sequence(self, ref: str) -> int:
        """ref: src/ssw_cpp.cpp:241-248 — a cleared (disabled) aligner
        cannot store a reference; returns the stored length (0 if
        disabled)."""
        self._reference = None
        if self.table is not None:
            self._reference = self._translate(ref)
            return len(self._reference)
        return 0

    def clear(self):
        """Clear all containers; the aligner is disabled until a rebuild
        (ref: src/ssw_cpp.h:188-190, src/ssw_cpp.cpp:359-362)."""
        self.matrix = None
        self.table = None
        self._reference = None

    def rebuild(self, *args) -> bool:
        """ReBuild overloads (ref: src/ssw_cpp.cpp:370-407):

          rebuild()                       -> defaults (2/2/3/1, 5x5 matrix)
          rebuild(m, x, o, e)             -> default matrix w/ those scores
          rebuild(score_matrix[, translation_matrix])
                                          -> custom matrices

        The 0- and 4-arg forms FAIL (return False) unless the aligner was
        cleared first; the custom-matrix form succeeds unconditionally —
        reference parity, it never checks (src/ssw_cpp.cpp:394-407)."""
        if len(args) in (0, 4):
            if self.table is not None:
                return False
            if len(args) == 4:
                match_score, mismatch_penalty, gap_open, gap_extend = args
            else:
                match_score, mismatch_penalty, gap_open, gap_extend = (
                    2, 2, 3, 1)
            # SetAllDefault resets every parameter, gaps included
            # (ref: src/ssw_cpp.cpp:364-368)
            self.gap_open = gap_open
            self.gap_extend = gap_extend
            self._reference = None
            self.matrix = _cpp_default_matrix(match_score, mismatch_penalty)
            self.table = _CPP_BASE_TABLE
            return True
        if len(args) in (1, 2):
            self.matrix = np.asarray(args[0], dtype=np.int8)
            if self.matrix.ndim == 1:
                n = int(np.sqrt(self.matrix.size))
                self.matrix = self.matrix.reshape(n, n)
            self.table = (np.asarray(args[1], dtype=np.int8)
                          if len(args) == 2 else _CPP_BASE_TABLE)
            return True
        raise TypeError(f"rebuild takes 0, 4, or 1-2 args, got {len(args)}")

    def clear_reference_sequence(self):
        self._reference = None

    def set_gap_penalty(self, opening: int, extending: int):
        self.gap_open = opening
        self.gap_extend = extending

    def _translate(self, s: str) -> np.ndarray:
        b = s.encode("latin-1") if isinstance(s, str) else s
        table = self.table
        if len(table) < 256:
            ext = np.zeros(256, dtype=np.int8)
            ext[: len(table)] = table
            table = ext
        return table[np.frombuffer(b, dtype=np.uint8)].astype(np.int32)

    def align(self, query: str, ref: str | None = None,
              filter: Filter | None = None, mask_len: int = 15):
        flags, als = self.align_batch([query], ref, filter, mask_len)
        return flags[0], als[0]

    def align_batch(self, queries, ref: str | None = None,
                    filter: Filter | None = None, mask_len=15):
        with profiling.span("api.align_batch"):
            return self._align_batch(queries, ref, filter, mask_len)

    def _align_batch(self, queries, ref, filter, mask_len):
        filter = filter or Filter()
        if self.table is None:
            # disabled (cleared) aligner: Align returns false and leaves the
            # alignment untouched (ref: src/ssw_cpp.cpp:278)
            return [0] * len(queries), [Alignment() for _ in queries]
        empty = [len(q) == 0 for q in queries]
        if any(empty):
            # per-query failure, like the reference's per-call Align check
            # (ref: src/ssw_cpp.cpp:301): only the empty query gets flag 0 +
            # an untouched Alignment; the rest of the batch still aligns
            live = [q for q, e in zip(queries, empty) if not e]
            if isinstance(mask_len, (int, np.integer)):
                ml_live = mask_len
            else:
                ml_live = [m for m, e in zip(mask_len, empty) if not e]
            lf, la = self.align_batch(live, ref, filter, ml_live)
            flags = []
            als = []
            it = iter(zip(lf, la))
            for e in empty:
                if e:
                    flags.append(0)
                    als.append(Alignment())
                else:
                    f_, a_ = next(it)
                    flags.append(f_)
                    als.append(a_)
            return flags, als
        if ref is not None:
            if len(ref) == 0:
                return [0] * len(queries), [Alignment() for _ in queries]
            with profiling.span("api.translate"):
                t_ref = self._translate(ref)
        elif self._reference is not None and len(self._reference) > 0:
            t_ref = self._reference
        else:
            # no (or empty) stored reference: Align(query, filter, ...)
            # returns false — the reference checks
            # translated_reference_.empty() (ref: src/ssw_cpp.cpp:277-279)
            return [0] * len(queries), [Alignment() for _ in queries]
        with profiling.span("api.translate"):
            t_queries = [self._translate(q) for q in queries]
        flag = 0
        if filter.report_begin_position:
            flag |= 0x08
        if filter.report_cigar:
            flag |= 0x0F
        if isinstance(mask_len, (int, np.integer)):
            mls = [max(int(mask_len), 15)] * len(queries)
        else:
            mls = [max(int(m), 15) for m in mask_len]
        results = align_batch(
            t_queries, t_ref, self.matrix, self.gap_open, self.gap_extend,
            flag=flag, filters=filter.score_filter,
            filterd=filter.distance_filter, mask_len=mls, score_size=2,
            device=self.device)
        with profiling.span("api.alignments"):
            flags = []
            als = []
            for r, q in zip(results, t_queries):
                a = Alignment()
                if r is None:
                    flags.append(0)
                    als.append(a)
                    continue
                a.sw_score = r.score1
                a.sw_score_next_best = r.score2
                a.ref_begin = r.ref_begin1
                a.ref_end = r.ref_end1
                a.query_begin = r.read_begin1
                a.query_end = r.read_end1
                a.ref_end_next_best = r.ref_end2
                # the reference AlignImpl runs CalculateNumberMismatch
                # unconditionally (ref: src/ssw_cpp.cpp:346-348) and it
                # rewrites cigar/cigar_string wholesale (ConvertAlignment's
                # version is discarded), so even path-less results carry
                # soft-clip-only cigar strings
                a.mismatches, a.cigar, a.cigar_string = _mark_mismatches(
                    a, t_ref, q, len(q), r.cigar or [])
                flags.append(r.flag)
                als.append(a)
            return flags, als


def _mark_mismatches(a: Alignment, ref, query, query_len: int, raw_cigar):
    """CalculateNumberMismatch (ref: src/ssw_cpp.cpp:123-204): rewrite M
    runs into '='/'X', wrap in soft clips and count NM (mismatches + indel
    bases).  Subsumes ConvertAlignment (ref: src/ssw_cpp.cpp:52-87), whose
    output the reference discards by running this unconditionally after."""
    i = a.ref_begin
    j = a.query_begin
    nm = 0
    new_cigar = []
    parts = []
    if a.query_begin > 0:
        new_cigar.append(to_cigar_int(a.query_begin, "S"))
        parts.append(f"{a.query_begin}S")
    run_op = ""
    run_len = 0

    def flush():
        nonlocal run_len, run_op
        if run_len:
            new_cigar.append(to_cigar_int(run_len, run_op))
            parts.append(f"{run_len}{run_op}")
        run_len = 0
        run_op = ""

    for c in raw_cigar:
        op = cigar_int_to_op(c)
        ln = cigar_int_to_len(c)
        if op == "M":
            for _ in range(ln):
                cur = "=" if ref[i] == query[j] else "X"
                if cur == "X":
                    nm += 1
                if cur != run_op:
                    flush()
                    run_op = cur
                run_len += 1
                i += 1
                j += 1
        elif op == "I":
            j += ln
            nm += ln
            flush()
            new_cigar.append(c)
            parts.append(f"{ln}I")
        elif op == "D":
            i += ln
            nm += ln
            flush()
            new_cigar.append(c)
            parts.append(f"{ln}D")
    flush()
    end = query_len - a.query_end - 1
    if end > 0:
        new_cigar.append(to_cigar_int(end, "S"))
        parts.append(f"{end}S")
    return nm, new_cigar, "".join(parts)
