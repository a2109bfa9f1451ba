"""The port's bench_longtarget and bench_iontorrent (ssw_tpu_torch/tools)
on the CPU: their cold and warm runs through ssw_tpu_torch.cli on a small
target cut from tests/data/1M.fa, each SAM byte-equal to ssw_tpu.cli.main
with the same arguments (JAX on the CPU, the scan backend)."""

import gzip
import io
import os

import numpy as np
import pytest

from ssw_tpu import cli as jax_cli
from ssw_tpu_torch.tools import bench_iontorrent, bench_longtarget
from tools import make_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_READS = 12


def _jax_sam(args):
    out, err = io.StringIO(), io.StringIO()
    assert jax_cli.main(list(args), out=out, err=err) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def genome():
    return make_data.load_fasta_seq(
        os.path.join(ROOT, "tests", "data", "1M.fa"))[:12_000]


def test_bench_longtarget_matches_jax_cli(genome, tmp_path):
    """The 1M head followed by a random tail, as make_data's 10M.fa; the
    FASTQ longer than the slice the tool takes."""
    rng = np.random.default_rng(5)
    tail = rng.choice(np.frombuffer(b"ACGT", np.uint8), 4000).tobytes()
    ref = str(tmp_path / "long.fa")
    make_data.write_fasta(ref, "chr3\tsynthetic-extension", genome + tail)
    fq = str(tmp_path / "reads.fastq.gz")
    make_data.make_reads(fq, genome, n_reads=N_READS + 4)
    runs, sam = bench_longtarget.run(ref, fq, N_READS, device="cpu")
    assert [r["run"] for r in runs] == ["cold", "warm"]
    for r in runs:
        assert r["rc"] == 0 and r["records"] == N_READS
        assert r["reads"] == N_READS and r["device"] == "cpu"
        assert r["peak_device_gb"] is None and r["peak_rss_gb"] > 0
        assert {"run", "rc", "reads", "records", "seconds", "reads_per_s",
                "phases", "gcups_forward", "peak_rss_gb"} < set(r)
    head = str(tmp_path / "head.fastq")
    with gzip.open(fq, "rt") as f, open(head, "w") as g:
        g.writelines(f.readline() for _ in range(4 * N_READS))
    assert sam == _jax_sam(["-c", "-s", "-h", ref, head])


def test_bench_iontorrent_matches_jax_cli(tmp_path):
    """make_data's Ion Torrent workload, cut: reads of 25-300 bp on one
    strand with 1 % substitutions, against a random 12 kbp genome."""
    rng = np.random.default_rng(4_938_920)
    g = rng.choice(np.frombuffer(b"ACGT", np.uint8), 12_000)
    target = str(tmp_path / "ecoli_small.fa")
    make_data.write_fasta(target, "ecoli_synth\t12000bp", g.tobytes())
    reads = str(tmp_path / "ion.fastq")
    with open(reads, "wb") as f:
        for i in range(N_READS):
            ln = int(np.clip(rng.normal(200, 80), 25, 300))
            pos = int(rng.integers(0, len(g) - ln))
            rd = g[pos:pos + ln].copy()
            m = rng.random(ln) < 0.01
            rd[m] = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                               int(m.sum()))
            f.write(b"@ion_%d_%d\n" % (i, pos) + rd.tobytes() + b"\n+\n"
                    + b"I" * ln + b"\n")
    runs, sam = bench_iontorrent.run(target, reads, "cpu", N_READS)
    assert [r["records"] for r in runs] == [N_READS, N_READS]
    assert sam == _jax_sam(["-c", "-s", "-h", target, reads])
