"""Alphabets, ASCII->code lookup tables and substitution matrices.

Reference behavior reproduced (by spec, not by code copy):
  * nucleotide table        ref: src/main.c:84-93
  * amino-acid table        ref: src/main.c:72-81
  * reverse complement      ref: src/main.c:95-116
  * 5x5 DNA matrix builder  ref: src/main.c:328-335
  * BLOSUM50 default        ref: src/main.c:43-69
  * NCBI matrix file parser ref: src/main.c:342-390
  * C++ wrapper tables      ref: src/ssw_cpp.cpp:18-50
"""

from __future__ import annotations

import numpy as np

# --- DNA -------------------------------------------------------------------
# A=0 C=1 G=2 T/U=3, everything else (incl. N) = 4.
NT_CODES = {"A": 0, "C": 1, "G": 2, "T": 3, "U": 3}

_nt = np.full(256, 4, dtype=np.int8)
for _c, _v in NT_CODES.items():
    _nt[ord(_c)] = _v
    _nt[ord(_c.lower())] = _v
NT_TABLE = _nt

# complement in ASCII space: A<->T, C<->G, N stays N, unknown -> chr(4)
_rc = np.full(256, 4, dtype=np.uint8)
for _a, _b in [("A", "T"), ("T", "A"), ("C", "G"), ("G", "C"),
               ("U", "A"), ("N", "N")]:
    _rc[ord(_a)] = ord(_b)
    _rc[ord(_a.lower())] = ord(_b)
RC_TABLE = _rc

# --- protein ---------------------------------------------------------------
# Standard 24-letter NCBI order: ARNDCQEGHILKMFPSTWYVBZX*
AA_ORDER = "ARNDCQEGHILKMFPSTWYVBZX*"
_aa = np.full(256, 23, dtype=np.int8)
for _i, _c in enumerate(AA_ORDER[:23]):
    _aa[ord(_c)] = _i
    _aa[ord(_c.lower())] = _i
AA_TABLE = _aa

BLOSUM50 = np.array([
    #A   R   N   D   C   Q   E   G   H   I   L   K   M   F   P   S   T   W   Y   V   B   Z   X   *
    [ 5, -2, -1, -2, -1, -1, -1,  0, -2, -1, -2, -1, -1, -3, -1,  1,  0, -3, -2,  0, -2, -1, -1, -5],
    [-2,  7, -1, -2, -4,  1,  0, -3,  0, -4, -3,  3, -2, -3, -3, -1, -1, -3, -1, -3, -1,  0, -1, -5],
    [-1, -1,  7,  2, -2,  0,  0,  0,  1, -3, -4,  0, -2, -4, -2,  1,  0, -4, -2, -3,  5,  0, -1, -5],
    [-2, -2,  2,  8, -4,  0,  2, -1, -1, -4, -4, -1, -4, -5, -1,  0, -1, -5, -3, -4,  6,  1, -1, -5],
    [-1, -4, -2, -4, 13, -3, -3, -3, -3, -2, -2, -3, -2, -2, -4, -1, -1, -5, -3, -1, -3, -3, -1, -5],
    [-1,  1,  0,  0, -3,  7,  2, -2,  1, -3, -2,  2,  0, -4, -1,  0, -1, -1, -1, -3,  0,  4, -1, -5],
    [-1,  0,  0,  2, -3,  2,  6, -3,  0, -4, -3,  1, -2, -3, -1, -1, -1, -3, -2, -3,  1,  5, -1, -5],
    [ 0, -3,  0, -1, -3, -2, -3,  8, -2, -4, -4, -2, -3, -4, -2,  0, -2, -3, -3, -4, -1, -2, -1, -5],
    [-2,  0,  1, -1, -3,  1,  0, -2, 10, -4, -3,  0, -1, -1, -2, -1, -2, -3,  2, -4,  0,  0, -1, -5],
    [-1, -4, -3, -4, -2, -3, -4, -4, -4,  5,  2, -3,  2,  0, -3, -3, -1, -3, -1,  4, -4, -3, -1, -5],
    [-2, -3, -4, -4, -2, -2, -3, -4, -3,  2,  5, -3,  3,  1, -4, -3, -1, -2, -1,  1, -4, -3, -1, -5],
    [-1,  3,  0, -1, -3,  2,  1, -2,  0, -3, -3,  6, -2, -4, -1,  0, -1, -3, -2, -3,  0,  1, -1, -5],
    [-1, -2, -2, -4, -2,  0, -2, -3, -1,  2,  3, -2,  7,  0, -3, -2, -1, -1,  0,  1, -3, -1, -1, -5],
    [-3, -3, -4, -5, -2, -4, -3, -4, -1,  0,  1, -4,  0,  8, -4, -3, -2,  1,  4, -1, -4, -4, -1, -5],
    [-1, -3, -2, -1, -4, -1, -1, -2, -2, -3, -4, -1, -3, -4, 10, -1, -1, -4, -3, -3, -2, -1, -1, -5],
    [ 1, -1,  1,  0, -1,  0, -1,  0, -1, -3, -3,  0, -2, -3, -1,  5,  2, -4, -2, -2,  0,  0, -1, -5],
    [ 0, -1,  0, -1, -1, -1, -1, -2, -2, -1, -1, -1, -1, -2, -1,  2,  5, -3, -2,  0,  0, -1, -1, -5],
    [-3, -3, -4, -5, -5, -1, -3, -3, -3, -3, -2, -3, -1,  1, -4, -4, -3, 15,  2, -3, -5, -2, -1, -5],
    [-2, -1, -2, -3, -3, -1, -2, -3,  2, -1, -1, -2,  0,  4, -3, -2, -2,  2,  8, -1, -3, -2, -1, -5],
    [ 0, -3, -3, -4, -1, -3, -3, -4, -4,  4,  1, -3,  1, -1, -3, -2,  0, -3, -1,  5, -3, -3, -1, -5],
    [-2, -1,  5,  6, -3,  0,  1, -1,  0, -4, -4,  0, -3, -4, -2,  0,  0, -5, -3, -3,  6,  1, -1, -5],
    [-1,  0,  0,  1, -3,  4,  5, -2,  0, -3, -3,  1, -1, -4, -1,  0, -1, -2, -2, -3,  1,  5, -1, -5],
    [-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -5],
    [-5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5, -5,  1],
], dtype=np.int8)


def dna_matrix(match: int = 2, mismatch: int = 2) -> np.ndarray:
    """5x5 DNA substitution matrix; row/col 4 (ambiguous) scores 0.

    Matches the layout `ssw_test` builds (ref: src/main.c:328-335).
    """
    m = np.zeros((5, 5), dtype=np.int8)
    for i in range(4):
        for j in range(4):
            m[i, j] = match if i == j else -mismatch
    return m


def encode_dna(seq: str | bytes) -> np.ndarray:
    b = seq.encode() if isinstance(seq, str) else seq
    return NT_TABLE[np.frombuffer(b, dtype=np.uint8)]


def encode_aa(seq: str | bytes) -> np.ndarray:
    b = seq.encode() if isinstance(seq, str) else seq
    return AA_TABLE[np.frombuffer(b, dtype=np.uint8)]


def encode_with_table(seq: str | bytes, table: np.ndarray) -> np.ndarray:
    b = seq.encode() if isinstance(seq, str) else seq
    return table[np.frombuffer(b, dtype=np.uint8)]


def reverse_complement(seq: str | bytes) -> str:
    """ASCII-space reverse complement (ref: src/main.c:95-116).

    Unknown characters map to chr(4), mirroring the reference's rc_table
    default of numeric 4.
    """
    b = seq.encode() if isinstance(seq, str) else seq
    return RC_TABLE[np.frombuffer(b, dtype=np.uint8)][::-1].tobytes().decode("latin-1")


def matrix_bias(mat: np.ndarray) -> int:
    """abs(min entry) — the byte-kernel bias (ref: src/ssw.c:832-837)."""
    return int(abs(min(int(mat.min()), 0)))


def parse_matrix_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse an NCBI-format BLOSUM/PAM matrix file.

    Returns (matrix n x n int8, ascii_table mapping letters -> row index).
    Mirrors the reference's parser semantics (ref: src/main.c:342-390):
    any line starting with '*' or an uppercase letter is a data row; the
    leading letter is registered in the lookup table (upper+lower case); all
    signed integers on the line become the row entries.  The header line of
    column letters is ignored because it starts with whitespace.
    """
    table = AA_TABLE.copy()
    rows: list[list[int]] = []
    m = 0
    with open(path, "r", encoding="latin-1") as f:
        for line in f:
            if not line:
                continue
            c = line[0]
            if c == "*" or ("A" <= c <= "Z"):
                if "A" <= c <= "Z":
                    table[ord(c)] = m
                    table[ord(c.lower())] = m
                vals: list[int] = []
                tok = ""
                for ch in line[1:]:
                    if ch.isdigit() or ch == "-":
                        tok += ch
                    elif tok:
                        vals.append(int(tok))
                        tok = ""
                if tok:
                    vals.append(int(tok))
                rows.append(vals)
                m += 1
    if m == 0 or not rows or any(len(r) != m for r in rows):
        # the reference only checks k == 0; we additionally require a square
        # matrix and surface the same error string for CLI parity
        raise ValueError("Problem of reading the weight matrix file.")
    n = m
    flat = [v for r in rows for v in r]
    mat = np.array(flat, dtype=np.int8).reshape(n, n)
    return mat, table
