"""A FASTA file of the benchmark's own extended to `length` bases by a
tail drawn from `seed` with the file's ACGT composition (tools/
make_data.py make_10m, which extends demo/1M.fa to demo/10M.fa), written
as FASTA under the run's temporary directory."""

import os

import numpy as np

from benchmark import gen

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make(spec: dict, tmp: str) -> dict:
    base = gen.load_fasta_seq(os.path.join(ROOT, spec["file"]))
    rng = np.random.default_rng(spec["seed"])
    arr = np.frombuffer(base, dtype=np.uint8)
    acgt = arr[np.isin(arr, gen.BASES)]
    counts = np.array([(acgt == b).sum() for b in gen.BASES],
                      dtype=np.float64)
    tail = rng.choice(gen.BASES, size=spec["length"] - len(base),
                      p=counts / counts.sum()).astype(np.uint8)
    seq = base + tail.tobytes()
    path = os.path.join(tmp, "target.fa")
    gen.write_fasta(path, spec["name"], seq)
    return dict(name=spec["name"].split()[0], seq=seq, path=path)
