"""ssw_tpu_torch.ssw_lib (CSsw on device "cpu") against ssw_tpu.ssw_lib
(JAX on the CPU, backend "scan"), field for field (tolerance 0): the CSsw
cases of tests/test_ssw_lib.py in the reference's usage pattern, the NULL
result of a score_size = 0 overflow, lBlosum50 and read_matrix, and seeded
reads over flags, filters and mask lengths."""

import os

import numpy as np
import pytest

from ssw_tpu import ssw_lib as jssw_lib
from ssw_tpu_torch import api, ssw_lib
from ssw_tpu_torch.core.encoding import AA_TABLE, NT_TABLE, dna_matrix

DATA = os.path.join(os.path.dirname(__file__), "data")
READ = "CTGAGCCGGTAAATC"
REF = "CAGCCTTTCTGACCCGGAAATCAAAATAGGCACAACAAA"
FIELDS = ("nScore", "nScore2", "nRefBeg", "nRefEnd", "nQryBeg", "nQryEnd",
          "nRefEnd2", "nCigarLen")


def enc(s, table=NT_TABLE):
    return [int(table[ord(c)]) for c in s]


def _fields(res):
    if not res:
        return None
    c = res.contents
    return [int(getattr(c, f)) for f in FIELDS] + [[int(x) for x in c.sCigar]]


def _both(q, r, flat, n, score_size, *args):
    """ssw_init + ssw_align through both shims with the reference's
    argument order; returns the port's pointer after holding its fields
    equal to the JAX shim's."""
    got_ssw = ssw_lib.CSsw(device="cpu")
    want_ssw = jssw_lib.CSsw(backend="scan")
    got = got_ssw.ssw_align(got_ssw.ssw_init(q, len(q), flat, n, score_size),
                            r, len(r), *args)
    want = want_ssw.ssw_align(
        want_ssw.ssw_init(q, len(q), flat, n, score_size), r, len(r), *args)
    assert _fields(got) == _fields(want)
    return got


def test_ssw_lib_reference_usage_pattern():
    """Drive the shim exactly like the reference's pyssw drives CSsw
    (ref: src/pyssw.py:246-279)."""
    ssw = ssw_lib.CSsw("/nonexistent/path/ok/to/ignore", device="cpu")
    mat = dna_matrix(2, 2)
    flat = [int(x) for x in mat.reshape(-1)]
    q, r = enc(READ), enc(REF)
    prof = ssw.ssw_init(q, len(q), flat, 5, 2)
    assert prof.contents.nReadLen == len(q)
    assert prof.contents.nN == 5
    assert prof.contents.nBias == 2
    res = ssw.ssw_align(prof, r, len(r), 3, 1, 0x0F, 0, 2 ** 15, 15)
    assert res
    c = res.contents
    assert c.nScore == 21
    assert c.nRefBeg >= 0 and c.nQryBeg >= 0
    assert c.nCigarLen == len(c.sCigar) and c.nCigarLen > 0
    ar = api.align(np.asarray(q), np.asarray(r), 3, 1, mat=mat, device="cpu")
    assert (c.nScore, c.nScore2, c.nRefBeg, c.nRefEnd, c.nQryBeg,
            c.nQryEnd, c.nRefEnd2) == (
        ar.score1, ar.score2, ar.ref_begin1, ar.ref_end1, ar.read_begin1,
        ar.read_end1, ar.ref_end2)
    assert list(c.sCigar) == list(ar.cigar)
    assert _fields(res) == _fields(_both(q, r, flat, 5, 2, 3, 1, 0x0F, 0,
                                         2 ** 15, 15))
    ssw.align_destroy(res)
    assert not res
    ssw.init_destroy(prof)
    assert not prof


def test_ssw_lib_null_on_score_size_zero_overflow():
    """score_size=0 + byte overflow returns a NULL-like pointer
    (ref: src/ssw.c:887-891)."""
    flat = [int(x) for x in dna_matrix(2, 2).reshape(-1)]
    assert not _both(enc("A" * 200), enc("A" * 300), flat, 5, 0, 3, 1, 0, 0,
                     2 ** 15, 15)
    assert _both(enc("A" * 60), enc("A" * 300), flat, 5, 0, 3, 1, 0, 0,
                 2 ** 15, 15)


def test_ssw_lib_blosum50_matches_encoding():
    assert ssw_lib.lBlosum50 == jssw_lib.lBlosum50
    assert len(ssw_lib.lBlosum50) == 24 * 24
    assert ssw_lib.lBlosum50[0] == 5  # A vs A


def test_read_matrix_uses_its_parameter(tmp_path):
    p = tmp_path / "m.txt"
    p.write_text("# comment\n  A C G T\nA 2 -1 -1 -1\nC -1 2 -1 -1\n"
                 "G -1 -1 2 -1\nT -1 -1 -1 2\n")
    lEle, dEle2Int, dInt2Ele, lScore = ssw_lib.read_matrix(str(p))
    assert lEle == ["A", "C", "G", "T"]
    assert dEle2Int["a"] == 0 and dEle2Int["T"] == 3
    assert dInt2Ele[2] == "G"
    assert lScore == [2, -1, -1, -1, -1, 2, -1, -1,
                      -1, -1, 2, -1, -1, -1, -1, 2]
    for f in (str(p), os.path.join(DATA, "blosum62.txt")):
        assert ssw_lib.read_matrix(f) == jssw_lib.read_matrix(f)


@pytest.mark.parametrize("seed", range(4))
def test_seeded_reads_equal_jax(seed):
    """Random DNA and BLOSUM50 pairs over the flag bits, both filters, mask
    lengths below and above 15 and the three score sizes."""
    rng = np.random.default_rng(seed)
    protein = seed % 2 == 1
    n = 24 if protein else 5
    flat = (ssw_lib.lBlosum50 if protein
            else [int(x) for x in dna_matrix(2, 2).reshape(-1)])
    alpha = 20 if protein else 4
    ref = [int(x) for x in rng.integers(0, alpha, 400)]
    for k in range(6):
        ln = int(rng.integers(10, 120))
        s = int(rng.integers(0, len(ref) - ln))
        q = ref[s:s + ln] if k % 3 else [int(x) for x in
                                          rng.integers(0, alpha, ln)]
        q = [x if rng.random() > 0.08 else int(rng.integers(alpha))
             for x in q]
        flag = [0, 0x0F, 0x08, 0x01, 0x0F, 0x04][k]
        filters = [0, 0, 30, 0, 0, 0][k]
        filterd = [2 ** 15, 2 ** 15, 2 ** 15, 2 ** 15, 40, 2 ** 15][k]
        mask = [15, ln // 2, 5, 30, 15, 20][k]
        score_size = [2, 2, 1, 0, 2, 2][k]
        gaps = (10, 2) if protein else (3, 1)
        _both(q, ref, flat, n, score_size, *gaps, flag, filters, filterd,
              mask)


def test_protein_with_the_translation_table():
    """The reference's protein flow: lBlosum50 over AA codes."""
    q = enc("MKVLAAGIVGHWWKRND", AA_TABLE)
    r = enc("PPQMKVLAGGIVGHWWKRNDPPE", AA_TABLE)
    res = _both(q, r, ssw_lib.lBlosum50, 24, 2, 10, 1, 0x0F, 0, 2 ** 15, 15)
    assert res and res.contents.nScore > 0
