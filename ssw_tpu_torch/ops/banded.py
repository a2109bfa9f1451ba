"""Banded traceback dispatch: native C++ engine with numpy fallback.

The banded DP + traceback is inherently sequential per pair (band geometry,
pointer chasing), so it runs on the host: C++ (ssw_tpu_torch/native/traceback.cpp)
when the toolchain is available, the row-vectorized numpy oracle otherwise.
Both implement the reference semantics incl. verification retry
(ref: src/ssw.c:940-957)."""

from __future__ import annotations

import ctypes

import numpy as np

from ssw_tpu_torch.core import oracle
from ssw_tpu_torch.core.cigar import cigar_alignment_score
from ssw_tpu_torch.native import build as native_build

# BAM op codes used by the native engine: 0=M 1=I 2=D (matches MAPSTR order)


def native_available() -> bool:
    return native_build.load() is not None


def banded_cigar(sub_ref: np.ndarray, sub_read: np.ndarray, score: int,
                 gapO: int, gapE: int, mat: np.ndarray):
    """Cigar (list[int], BAM-encoded) for one [begin,end] sub-rectangle, or
    None when the banded traceback fails (s_align.flag=1 parity)."""
    lib = native_build.load()
    if lib is not None:
        ref8 = np.ascontiguousarray(sub_ref, dtype=np.int8)
        read8 = np.ascontiguousarray(sub_read, dtype=np.int8)
        mat8 = np.ascontiguousarray(mat, dtype=np.int8)
        cap = 2 * (len(ref8) + len(read8)) + 8
        out = np.empty(cap, dtype=np.uint32)
        n = lib.sswtpu_banded_cigar(
            ref8.ctypes.data_as(ctypes.c_void_p), len(ref8),
            read8.ctypes.data_as(ctypes.c_void_p), len(read8),
            int(score), int(gapO), int(gapE),
            mat8.ctypes.data_as(ctypes.c_void_p), mat8.shape[0],
            out.ctypes.data_as(ctypes.c_void_p), cap)
        if n == 0:
            return None
        if n > 0:
            return [int(x) for x in out[:n]]
        # fall through on buffer overflow (shouldn't happen with this cap)

    # numpy fallback: the oracle's banded_sw + the same verification loop
    band_width = abs(len(sub_ref) - len(sub_read)) + 1
    full_band = max(len(sub_ref), len(sub_read))
    while True:
        path = oracle.banded_sw(sub_ref, sub_read, score, gapO, gapE,
                                band_width, mat)
        if path is None:
            return None
        if cigar_alignment_score(path, sub_ref, sub_read, mat, gapO,
                                 gapE) == score:
            return path
        if band_width >= full_band:
            return None
        band_width = full_band


def banded_cigar_batch(sub_refs, sub_reads, scores, gapO: int, gapE: int,
                       mat: np.ndarray):
    """Cigars for many sub-rectangles in ONE native call (threaded C++
    loop); per-pair results are list[int] or None (banded failure).
    Falls back to the per-pair path when the native engine is absent."""
    lib = native_build.load()
    n_pairs = len(sub_refs)
    if lib is None or n_pairs == 0:
        return [banded_cigar(r, q, s, gapO, gapE, mat)
                for r, q, s in zip(sub_refs, sub_reads, scores)]
    refs8 = [np.ascontiguousarray(r, dtype=np.int8) for r in sub_refs]
    reads8 = [np.ascontiguousarray(q, dtype=np.int8) for q in sub_reads]
    ref_cat = (np.concatenate(refs8) if refs8 else
               np.empty(0, np.int8))
    read_cat = (np.concatenate(reads8) if reads8 else
                np.empty(0, np.int8))
    ref_len = np.array([len(r) for r in refs8], np.int32)
    read_len = np.array([len(q) for q in reads8], np.int32)
    ref_off = np.zeros(n_pairs, np.int64)
    np.cumsum(ref_len[:-1], out=ref_off[1:])
    read_off = np.zeros(n_pairs, np.int64)
    np.cumsum(read_len[:-1], out=read_off[1:])
    sc = np.asarray(scores, np.int32)
    mat8 = np.ascontiguousarray(mat, dtype=np.int8)
    out_cap = int((2 * (ref_len.astype(np.int64) + read_len) + 8).sum())
    out = np.empty(out_cap, np.uint32)
    meta = np.empty(2 * n_pairs, np.int64)
    lib.sswtpu_banded_cigar_batch(
        ref_cat.ctypes.data_as(ctypes.c_void_p),
        ref_off.ctypes.data_as(ctypes.c_void_p),
        ref_len.ctypes.data_as(ctypes.c_void_p),
        read_cat.ctypes.data_as(ctypes.c_void_p),
        read_off.ctypes.data_as(ctypes.c_void_p),
        read_len.ctypes.data_as(ctypes.c_void_p),
        sc.ctypes.data_as(ctypes.c_void_p), n_pairs, int(gapO), int(gapE),
        mat8.ctypes.data_as(ctypes.c_void_p), mat8.shape[0],
        out.ctypes.data_as(ctypes.c_void_p), out_cap,
        meta.ctypes.data_as(ctypes.c_void_p))
    results = []
    for p in range(n_pairs):
        off, ln = int(meta[2 * p]), int(meta[2 * p + 1])
        if ln > 0:
            results.append([int(x) for x in out[off:off + ln]])
        elif ln < 0:
            # native capacity-overflow marker: re-run this pair through the
            # per-pair path (which falls back to the numpy engine on the
            # same condition) instead of mislabeling it a banded failure
            results.append(banded_cigar(refs8[p], reads8[p], int(sc[p]),
                                        gapO, gapE, mat))
        else:
            results.append(None)
    return results
