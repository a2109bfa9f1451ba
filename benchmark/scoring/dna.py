"""ssw_test's nucleotide scoring: reads and target encoded A C G T (U as
T, either case) and everything else N, a 5x5 matrix of `match` on the
diagonal, -`mismatch` off it, N scoring 0 (ref: src/main.c:328-335)."""

from benchmark import reference as R

TABLE = R.NT_TABLE


def matrix(scoring: dict):
    return R.dna_matrix(scoring["match"], scoring["mismatch"])
