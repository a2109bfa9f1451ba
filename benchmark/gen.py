"""The one traffic generator: targets and reads made from a seed.

Frozen copies of tools/make_data.py's samplers (`load_fasta_seq`,
`write_fasta`, the Illumina-like read sampler of `make_reads` and the Ion
Torrent genome and read sampler of `make_iontorrent`), restructured to
take their numpy Generator as an argument so that the reads are re-seeded
from --seed; with make_data's own seeds they give its bytes.  Besides, the
sampler of one-read calls against a reference window (`local_pairs`).
"""

from __future__ import annotations

import gzip

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    COMP[_a] = _b


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A Generator for one stream of one seed (any whole number)."""
    return np.random.default_rng([seed % (1 << 64), *stream])


def load_fasta_seq(path: str) -> bytes:
    seq = []
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                continue
            seq.append(line.strip())
    return b"".join(seq)


def fasta_name(path: str) -> str:
    """The first record's name: its header up to the first whitespace."""
    with open(path, "rb") as f:
        head = f.readline()[1:].split(None, 1)
    return head[0].decode("latin-1") if head else ""


def write_fasta(path: str, name: str, seq: bytes, width: int = 10000):
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        for i in range(0, len(seq), width):
            f.write(seq[i:i + width] + b"\n")


def write_fastq(path: str, records, gz: bool) -> None:
    """records: (name, seq, qual) byte strings."""
    opener = (lambda p: gzip.open(p, "wb", compresslevel=6)) if gz else \
        (lambda p: open(p, "wb"))
    with opener(path) as f:
        for name, seq, qual in records:
            f.write(b"@" + name + b"\n" + seq + b"\n+\n" + qual + b"\n")


def read_start_positions(genome: bytes, read_len: int) -> np.ndarray:
    """Start positions whose read_len window is N-free (make_reads)."""
    g = np.frombuffer(genome, dtype=np.uint8)
    is_acgt = np.isin(g, BASES)
    run = np.cumsum(is_acgt.astype(np.int64))
    window_acgt = run[read_len - 1:] - np.concatenate(([0], run[:-read_len]))
    return np.nonzero(window_acgt == read_len)[0]


def illumina_reads(genome: bytes, n_reads: int, rng: np.random.Generator,
                   read_len: int = 100, err: float = 0.005,
                   rc_frac: float = 0.5, first: int = 0):
    """make_reads: uniform positions, substitution errors, a Q-ramp
    quality string, rc_frac of the reads reverse-complemented; names
    sim_<i>_<pos>_<f|r> with i counted from `first`."""
    g = np.frombuffer(genome, dtype=np.uint8)
    positions = read_start_positions(genome, read_len)
    qual_hi = np.full(read_len, ord("I"), dtype=np.uint8)
    qual_hi[-read_len // 5:] = ord("?")
    qual_line = qual_hi.tobytes()
    pos = rng.choice(positions, size=n_reads)
    do_rc = rng.random(n_reads) < rc_frac
    out = []
    for i in range(n_reads):
        rd = g[pos[i]:pos[i] + read_len].copy()
        m = rng.random(read_len) < err
        if m.any():
            rd[m] = rng.choice(BASES, size=int(m.sum()))
        if do_rc[i]:
            rd = COMP[rd][::-1]
        out.append((b"sim_%d_%d_%s" % (first + i, pos[i],
                                       b"r" if do_rc[i] else b"f"),
                    rd.tobytes(), qual_line))
    return out


def uniform_genome(length: int, rng: np.random.Generator) -> bytes:
    """make_iontorrent's genome: composition-uniform random bases."""
    return rng.choice(BASES, length).astype(np.uint8).tobytes()


def iontorrent_reads(genome: bytes, n_reads: int, rng: np.random.Generator,
                     mean: float = 200, sd: float = 80, lo: int = 25,
                     hi: int = 540, err: float = 0.01, first: int = 0):
    """make_iontorrent's reads: normal(mean, sd) lengths clipped to
    [lo, hi], uniform positions, substitutions at `err`, quality 'I';
    names ion_<i>_<pos>."""
    g = np.frombuffer(genome, dtype=np.uint8)
    out = []
    for i in range(n_reads):
        ln = int(np.clip(rng.normal(mean, sd), lo, hi))
        pos = int(rng.integers(0, len(g) - ln))
        rd = g[pos:pos + ln].copy()
        m = rng.random(ln) < err
        if m.any():
            rd[m] = rng.choice(BASES, int(m.sum()))
        out.append((b"ion_%d_%d" % (first + i, pos), rd.tobytes(),
                    b"I" * ln))
    return out


def reads_of_lengths(genome: bytes, lengths, rng: np.random.Generator,
                     err: float, first: int = 0):
    """Reads of the given lengths in an order drawn from rng, each at a
    uniform origin with substitutions at `err`, quality 'I' (the Ion
    Torrent sampler's model with its lengths fixed, so that every seed
    asks for the same work)."""
    g = np.frombuffer(genome, dtype=np.uint8)
    out = []
    for i, ln in enumerate(rng.permutation(np.asarray(lengths))):
        ln = int(ln)
        pos = int(rng.integers(0, len(g) - ln))
        rd = g[pos:pos + ln].copy()
        m = rng.random(ln) < err
        if m.any():
            rd[m] = rng.choice(BASES, int(m.sum()))
        out.append((b"ion_%d_%d" % (first + i, pos), rd.tobytes(),
                    b"I" * ln))
    return out


def local_pairs(genome: bytes, order: np.ndarray, start: int, n: int,
                rng: np.random.Generator, read_len: int, err: float,
                window: int):
    """n one-read calls: the read at origin order[start + i] (read_len
    bases with substitutions at `err`, in its reference orientation) and
    the `window` bases of the genome that hold it, at a uniform offset.
    Returns (reads (n, read_len) uint8, window starts (n,))."""
    g = np.frombuffer(genome, dtype=np.uint8)
    pos = order[start:start + n]
    reads = g[pos[:, None] + np.arange(read_len)[None, :]].copy()
    m = rng.random(reads.shape) < err
    reads[m] = BASES[rng.integers(0, 4, int(m.sum()))]
    off = rng.integers(0, window - read_len + 1, len(pos))
    ws = np.clip(pos - off, 0, len(g) - window)
    return reads, ws
