"""Illumina-like reads (tools/make_data.py make_reads): read_len bases
from uniform N-free origins, substitutions at `err`, rc_frac of them
reverse-complemented, a Q-ramp quality string."""

from benchmark import gen


def prepare(reads: dict, target: dict) -> None:
    pass


def sample(reads: dict, target: dict, n: int, rng, first: int = 0):
    return gen.illumina_reads(target["seq"], n, rng, reads["read_len"],
                              reads["err"], reads["rc_frac"], first)
