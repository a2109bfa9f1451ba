"""A target read from a FASTA file of the benchmark's own (under paths, so
that the yardstick's inputs cannot change under a later PR)."""

import os

from benchmark import gen

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make(spec: dict, tmp: str) -> dict:
    path = os.path.join(ROOT, spec["file"])
    return dict(name=gen.fasta_name(path), seq=gen.load_fasta_seq(path),
                path=path)
