"""A composition-uniform random genome of `length` bases drawn from
`seed` (tools/make_data.py's Ion Torrent genome), written as FASTA under
the run's temporary directory.  The generator is handed on (`rng`): the
read model may draw from it as make_data does."""

import os

import numpy as np

from benchmark import gen


def make(spec: dict, tmp: str) -> dict:
    rng = np.random.default_rng(spec["seed"])
    seq = gen.uniform_genome(spec["length"], rng)
    path = os.path.join(tmp, "target.fa")
    gen.write_fasta(path, spec["name"], seq)
    return dict(name=spec["name"].split()[0], seq=seq, path=path, rng=rng)
