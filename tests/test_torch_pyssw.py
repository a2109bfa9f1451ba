"""ssw_tpu_torch.pyssw (device "cpu"): the cases of tests/test_pyssw.py
(the three reference-generated goldens, SAM fields against ssw_test's
golden, the headerless target, Python 2 softspace), and main byte-equal to
ssw_tpu.pyssw.main (JAX on the CPU) on further argument sets: -r, -s
without -c, a matrix file with -p, -p -r with its warning, penalties."""

import io
import os
import re
import subprocess
import sys

import pytest

from ssw_tpu import pyssw as jpyssw
from ssw_tpu_torch import pyssw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
GOLD = os.path.join(ROOT, "tests", "golden")


def _args(args):
    return [os.path.join(DATA, a) if a.endswith((".fa", ".fq", ".fastq",
                                                 ".seq", ".txt")) else a
            for a in args]


def run_pyssw(args, main=None):
    """stdout and stderr of pyssw.main (the port's on the CPU unless
    `main` is given), without stderr's CPU-time line."""
    out, err = io.StringIO(), io.StringIO()
    if main is None:
        rc = pyssw.main(_args(args), out=out, err=err, device="cpu")
    else:
        rc = main(_args(args), out=out, err=err)
    assert rc == 0
    lines = [l for l in err.getvalue().splitlines(True)
             if not l.startswith("CPU time: ")]
    return out.getvalue(), "".join(lines)


def golden(name):
    with open(os.path.join(GOLD, name)) as f:
        return f.read()


@pytest.mark.parametrize("gold,args", [
    ("g_pyssw_r1_blast.txt", ["-c", "r1.fa", "r1_query.fq"]),
    ("g_pyssw_r1_sam.txt", ["-c", "-s", "-header", "r1.fa", "r1_query.fq"]),
    ("g_pyssw_prot_blast.txt", ["-c", "-p", "pRef.fa", "pRead.fa"]),
])
def test_pyssw_golden(gold, args):
    out, _ = run_pyssw(args)
    assert out == golden(gold)


SAM_ONLY_WITH_C = "SAM format output is only available together with"
NO_PROTEIN_RC = "Reverse complement alignment is not available for protein"
NO_2ND_BEST = "When maskLen < 15, the function ssw_align doesn't return"


@pytest.mark.parametrize("args,warning", [
    (["-r", "1k.fa", "54mer_hap1_1.100.fastq"], None),
    (["-c", "-r", "10k.fa", "54mer_hap1_1.100.fa"], None),
    (["-c", "-s", "-r", "1k.fa", "54mer_hap1_1.100.fastq"], None),
    (["-s", "r1.fa", "r1_query.fq"], SAM_ONLY_WITH_C),
    (["-c", "-p", "-a", "blosum62.txt", "protein2.fa", "protein1.fa"], None),
    (["-c", "-s", "-header", "-p", "-r", "pRef.fa", "pRead.fa"],
     NO_PROTEIN_RC),
    (["-m", "1", "-x", "3", "-o", "5", "-e", "2", "-c", "-s", "-header",
      "10k.fa", "54mer_hap1_1.100.fastq"], None),
    (["-c", "target.fastq", "query.fastq"], None),
    (["-c", "1k.fa", "test.seq"], NO_2ND_BEST),
])
def test_pyssw_equals_jax(args, warning):
    """stdout and stderr (warnings included) byte-equal to the JAX twin."""
    got = run_pyssw(args)
    assert got == run_pyssw(args, jpyssw.main)
    assert got[0]
    assert (warning is None and got[1] == "") or warning in got[1]


def test_pyssw_sam_fields_match_ssw_test():
    """POS / AS / ZS / FLAG / RNAME of pyssw SAM agree with the reference
    binary's SAM on the same pair (pyssw has no soft clips)."""
    out, _ = run_pyssw(["-c", "-s", "-header", "r1.fa", "r1_query.fq"])
    ours = [l for l in out.splitlines() if not l.startswith("@")]
    ref = [l for l in golden("g_r1_sam.txt").splitlines()
           if not l.startswith("@")]
    assert len(ours) == len(ref) == 1
    of, rf = ours[0].split("\t"), ref[0].split("\t")
    assert of[0] == rf[0]
    assert of[1].strip() == rf[1]
    assert of[2] == rf[2]
    assert of[3] == rf[3]
    assert re.findall(r"(AS|ZS):i:(\d+)", ours[0]) == re.findall(
        r"(AS|ZS):i:(\d+)", ref[0])


def test_pyssw_blast_scores_match_ssw_test_protein():
    out, _ = run_pyssw(["-c", "-p", "pRef.fa", "pRead.fa"])
    pat = (r"optimal_alignment_score: (\d+)\s+"
           r"suboptimal_alignment_score: (\d+)")
    assert re.search(pat, out).groups() == re.search(
        pat, golden("g_prot_blast.txt")).groups()


def test_pyssw_rejects_headerless_and_missing_files():
    with pytest.raises(SystemExit):
        list(pyssw.read(os.path.join(DATA, "target2.fa")))
    err = io.StringIO()
    assert pyssw.main(["/no/such.fa", os.path.join(DATA, "r1.fa")],
                      out=io.StringIO(), err=err, device="cpu") == 1
    assert err.getvalue() == "Failed to open the file /no/such.fa.\n"


def test_py2_softspace_semantics():
    buf = io.StringIO()
    p = pyssw.Py2Printer(buf)
    p.item("a\t")
    p.item("b")
    p.item("c")
    p.line("d\t")
    p.line("e")
    assert buf.getvalue() == "a\tb c d\t\ne\n"


def test_helpers_equal_jax():
    e2i = {c: i for i, c in enumerate("ACGTN")}
    assert (pyssw.to_int("ACGTXa", e2i, 5).tolist()
            == jpyssw.to_int("ACGTXa", e2i, 5).tolist())
    case = ("ACGTTGCA", "ACCTTTGCA", 0, 0, [(2 << 4) | 0, (1 << 4) | 2,
                                             (1 << 4) | 0, (4 << 4) | 0])
    assert pyssw.build_path(*case) == jpyssw.build_path(*case)


def test_module_prints_help_without_arguments():
    r = subprocess.run([sys.executable, "-m", "ssw_tpu_torch.pyssw"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.startswith("usage:")
