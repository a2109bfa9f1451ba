"""The port's CLI (ssw_tpu_torch.cli.main on device "cpu") byte-equal to the
golden outputs captured from the reference `ssw_test` binary, on every case
that tests/test_cli_golden.py checks for the JAX package, and on a few of
them again with the streaming suboptimal scan forced."""

import io
import os
import shutil

import pytest

from ssw_tpu_torch import cli, pipeline

HERE = os.path.dirname(__file__)
DATA = os.path.join(HERE, "data")
GOLD = os.path.join(HERE, "golden")

CASES = [
    (["-c", "-p", "pRef.fa", "pRead.fa"], "g_prot_blast.txt"),
    (["-c", "target.fastq", "query.fastq"], "g_fq_blast.txt"),
    (["-c", "-s", "-h", "r1.fa", "r1_query.fq"], "g_r1_sam.txt"),
    (["-c", "-s", "-h", "-r", "10k.fa", "54mer_hap1_1.100.fa"],
     "g_54fa_10k_sam.txt"),
    (["-c", "-r", "1k.fa", "54mer_hap1_1.100.fastq"], "g_54_1k_blast.txt"),
    (["-m", "1", "-x", "3", "-o", "5", "-e", "2", "-c", "-s", "-h", "10k.fa",
      "54mer_hap1_1.100.fastq"], "g_54_10k_m1x3o5e2.txt"),
    (["1k.fa", "test.seq", "-c"], "g_testseq_blast.txt"),
]

# small goldens once more with the streaming suboptimal scan forced: DNA
# (byte tier, -r strands, SAM) and protein (the quirk, the int32 kernel)
STREAM_CASES = [c for c in CASES if c[1] in (
    "g_testseq_blast.txt", "g_54_1k_blast.txt", "g_r1_sam.txt",
    "g_prot_blast.txt")]

SLOW_CASES = [
    (["-c", "-s", "-h", "-r", "100k.fa", "54mer_hap1_1.100.fastq"],
     "g_54mer_100k_sam.txt"),
]


def run_cli(args):
    out, err = io.StringIO(), io.StringIO()
    rc = cli.main(args, out=out, err=err, device="cpu")
    return rc, out.getvalue(), err.getvalue()


def _paths(args):
    return [os.path.join(DATA, a) if a.endswith((".fa", ".fastq", ".fq",
                                                 ".seq")) else a
            for a in args]


def _golden(name):
    with open(os.path.join(GOLD, name)) as f:
        return f.read()


@pytest.mark.parametrize("args,gold", CASES)
def test_cli_golden(args, gold):
    rc, out, _ = run_cli(_paths(args))
    assert rc == 0
    assert out == _golden(gold)


@pytest.mark.parametrize("args,gold", STREAM_CASES)
def test_cli_golden_streaming(args, gold, monkeypatch):
    assert len(STREAM_CASES) == 4
    calls = []
    real = pipeline._second_best_streaming

    def spy(st, end_ref, word):
        calls.append(st.B)
        return real(st, end_ref, word)

    monkeypatch.setattr(pipeline, "STREAM_SUBOPT", True)
    monkeypatch.setattr(pipeline, "_second_best_streaming", spy)
    rc, out, _ = run_cli(_paths(args))
    assert rc == 0 and calls
    assert out == _golden(gold)


@pytest.mark.slow
@pytest.mark.parametrize("args,gold", SLOW_CASES)
def test_cli_golden_slow(args, gold):
    rc, out, _ = run_cli(_paths(args))
    assert rc == 0
    assert out == _golden(gold)


def test_headerless_target_yields_no_records():
    """target2.fa has no FASTA header: kseq finds no records and the
    reference emits nothing (ref: src/kseq.h:175-179)."""
    rc, out, _ = run_cli(_paths(["-c", "target2.fa", "query2.fa"]))
    assert rc == 0
    assert out == ""


def test_cli_golden_matrix_file_config2(tmp_path, monkeypatch):
    """BASELINE config 2: protein alignment with a BLOSUM62 matrix file,
    run from a controlled cwd with the uppercase names the capture was
    taken with (see cli.parse_args)."""
    for src, dst in (("blosum62.txt", "B62.TXT"), ("protein1.fa",
                     "PROTEIN1.FA"), ("protein2.fa", "PROTEIN2.FA")):
        shutil.copy(os.path.join(DATA, src), tmp_path / dst)
    monkeypatch.chdir(tmp_path)
    rc, out, _ = run_cli(["-p", "-a", "B62.TXT", "-c", "PROTEIN2.FA",
                          "PROTEIN1.FA"])
    assert rc == 0
    assert out == _golden("g_prot_b62_blast.txt")


def test_cli_usage_and_stderr_match_jax_cli():
    """Too few files prints the usage text; a run's stderr (CPU-time line
    aside) is what the JAX package's CLI writes."""
    from ssw_tpu import cli as jax_cli

    rc, out, err = run_cli(["-c"])
    assert rc == 1 and out == "" and err == jax_cli.USAGE
    args = _paths(["-c", "-s", "-h", "-r", "10k.fa", "54mer_hap1_1.100.fa"])
    _, _, err = run_cli(args)
    jerr = io.StringIO()
    jax_cli.main(args, out=io.StringIO(), err=jerr)

    def strip(text):
        return [ln for ln in text.splitlines()
                if not ln.startswith("CPU time")]

    assert strip(err) == strip(jerr.getvalue())
