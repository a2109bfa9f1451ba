"""Drop-in compatibility shim for the reference's `ssw_lib.py` Python
embedding surface (ref: src/ssw_lib.py:45-223): the same class and field
names (`CSsw`, `CAlignRes`, `CProfile`, `lBlosum50`, `read_matrix`) so
reference-era scripts port mechanically — but the calls run the
PyTorch/CUDA pipeline instead of dlopen'ing `libssw.so`.  The counterpart
of the JAX package's ssw_lib.py, with `device` (None: the CUDA card,
raising when there is none; "cpu": the plain PyTorch versions) in place of
its `backend`.

Differences from the reference, by design:
  * `CSsw(sLibPath)` accepts and ignores the library path (there is no
    shared object to load; the reference exits when libssw.so is missing,
    ref: src/ssw_lib.py:104-120).
  * results/profiles are plain Python objects wrapped in a `.contents`
    pointer lookalike, so `res.contents.nScore`, `res.contents.sCigar[i]`
    and friends work unchanged; no ctypes memory to free (`init_destroy` /
    `align_destroy` are no-ops kept for API parity).
  * `read_matrix(sFile)` reads the file it is given — the reference's
    version reads the global `args.sMatrix` instead of its parameter and
    NameErrors when imported as a library (ref: src/ssw_lib.py:201-223);
    output format (lEle, dEle2Int, dInt2Ele, lScore) is identical.
"""

from __future__ import annotations

import numpy as np

from ssw_tpu_torch import pipeline
from ssw_tpu_torch.core.encoding import BLOSUM50

# flattened BLOSUM50 in the reference's AA order (ref: src/ssw_lib.py:15-41)
lBlosum50 = [int(x) for x in np.asarray(BLOSUM50).reshape(-1)]


class _Ptr:
    """Minimal ctypes-POINTER lookalike: truthy iff non-NULL, with
    `.contents`."""

    def __init__(self, contents=None):
        self.contents = contents

    def __bool__(self):
        return self.contents is not None


class CAlignRes:
    """Alignment result, field-compatible with the reference's ctypes
    struct (ref: src/ssw_lib.py:45-69)."""

    def __init__(self, res):
        self.nScore = res.score1
        self.nScore2 = res.score2
        self.nRefBeg = res.ref_begin1
        self.nRefEnd = res.ref_end1
        self.nQryBeg = res.read_begin1
        self.nQryEnd = res.read_end1
        self.nRefEnd2 = res.ref_end2
        cig = list(res.cigar or [])
        self.sCigar = cig  # indexable like POINTER(c_uint32)
        self.nCigarLen = len(cig)


class CProfile:
    """Query profile, field-compatible with the reference's ctypes struct
    (ref: src/ssw_lib.py:73-90).  pByte/pWord are not materialized (the
    pipeline builds its own dense profile); pRead/pMat carry the
    encoded read and matrix."""

    def __init__(self, read, read_len, mat, n, score_size):
        self.pByte = None
        self.pWord = None
        self.pRead = read
        self.pMat = mat
        self.nReadLen = read_len
        self.nN = n
        self.nBias = max(0, -int(mat.min())) if mat.size else 0
        self.score_size = score_size


class CSsw:
    """API twin of the reference's libssw.so loader
    (ref: src/ssw_lib.py:94-197).  Same four entry points, same argument
    order; `sLibPath` is accepted for signature parity and ignored."""

    def __init__(self, sLibPath=None, device=None):
        self.device = device

    def ssw_init(self, read, readLen, mat, n, score_size):
        """ref: src/ssw.c:826-847 via ctypes (src/ssw_lib.py:143-145)."""
        read_arr = np.asarray([read[i] for i in range(readLen)],
                              dtype=np.int32)
        mat_arr = np.asarray([mat[i] for i in range(n * n)],
                             dtype=np.int8).reshape(n, n)
        return _Ptr(CProfile(read_arr, readLen, mat_arr, n, score_size))

    def init_destroy(self, qProfile):
        if qProfile:
            qProfile.contents = None

    def ssw_align(self, qProfile, ref, refLen, weight_gapO, weight_gapE,
                  flag, filters, filterd, maskLen):
        """ref: src/ssw.c:855-977 via ctypes (src/ssw_lib.py:190-192).
        Returns a NULL-like pointer exactly where the C API returns NULL
        (score_size=0 overflow)."""
        p = qProfile.contents
        ref_arr = np.asarray([ref[i] for i in range(refLen)], dtype=np.int32)
        req = pipeline.BatchRequest(
            reads=[p.pRead], ref=ref_arr, mat=p.pMat,
            gapO=int(weight_gapO), gapE=int(weight_gapE), flag=int(flag),
            filters=int(filters), filterd=int(filterd),
            mask_len=int(maskLen), score_size=int(p.score_size))
        res = pipeline.align_batch(req, device=self.device)[0]
        if res is None:
            return _Ptr(None)
        return _Ptr(CAlignRes(res))

    def align_destroy(self, res):
        if res:
            res.contents = None


def read_matrix(sFile):
    """NCBI-format matrix reader with the reference's output contract
    (lEle, dEle2Int incl. lowercase keys, dInt2Ele, flat lScore)
    (ref: src/ssw_lib.py:201-223, with the global-`args` bug fixed)."""
    with open(sFile) as f:
        for line in f:
            if not line.startswith('#'):
                break
        lEle = line.strip().split()
        dEle2Int = {}
        dInt2Ele = {}
        for i, ele in enumerate(lEle):
            dEle2Int[ele] = i
            dEle2Int[ele.lower()] = i
            dInt2Ele[i] = ele
        lScore = []
        for line in f:
            lScore.extend(int(x) for x in line.strip().split()[1:])
    return lEle, dEle2Int, dInt2Ele, lScore
