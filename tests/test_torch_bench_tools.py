"""ssw_tpu_torch.tools.run_config4_full, the counterpart of
tools/run_config4_full.py, on the CPU: in slice mode, on reads drawn by the
generator of tools/make_data.py from the first 50 kbp of 1M.fa (the plain
DP takes about 0.1 ms a column on the CPU, per strand), its SAM body and
SHA-256 equal ssw_tpu.cli.main's on the same files (JAX on the CPU, the
scan backend)."""

import gzip
import hashlib
import io
import os

import pytest

from ssw_tpu import cli as jax_cli
from ssw_tpu_torch.tools import run_config4_full
from tools import make_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_READS = 32


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("config4")
    genome = make_data.load_fasta_seq(
        os.path.join(ROOT, "tests", "data", "1M.fa"))[:50_000]
    ref = str(d / "1M_first50k.fa")
    make_data.write_fasta(ref, "chr3_first50k", genome)
    fq = str(d / "reads.fastq.gz")
    # a FASTQ longer than the slice: slice mode takes its first N_READS
    make_data.make_reads(fq, genome, n_reads=N_READS + 8)
    return ref, fq


def test_slice_mode_sam_equals_jax_cli(files):
    ref, fq = files
    res, sam = run_config4_full.run(ref, fq, N_READS, device="cpu")
    assert res["rc"] == 0 and res["reads"] == N_READS
    assert res["device"] == "cpu"
    assert set(res) == {"rc", "reads", "wall_s", "reads_per_s_inclusive",
                        "phases_s", "gcups_forward", "sam_bytes",
                        "sam_body_sha256", "device"}
    body = run_config4_full.sam_body(sam)
    assert len(body.splitlines()) == N_READS
    assert res["sam_bytes"] == len(sam)
    assert res["sam_body_sha256"] == hashlib.sha256(
        body.encode()).hexdigest()

    sliced = os.path.join(os.path.dirname(fq), "slice.fastq")
    with open(sliced, "w") as f, gzip.open(fq, "rt") as g:
        f.writelines(g.readline() for _ in range(4 * N_READS))
    out, err = io.StringIO(), io.StringIO()
    assert jax_cli.main(["-c", "-s", "-h", "-r", ref, sliced], out=out,
                        err=err) == 0
    want = run_config4_full.sam_body(out.getvalue())
    assert body == want
    assert res["sam_body_sha256"] == hashlib.sha256(
        want.encode()).hexdigest()
