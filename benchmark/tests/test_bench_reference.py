"""The plain reference against the reference library's own answers: the
C API vectors (tests/vectors, from the compiled library), the C++
example pair, and ssw_test's SAM golden for the 54mer reads."""

import collections
import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT

from benchmark import reference as R
from benchmark.plugins import plugin

CLI = plugin("compare", "cli")
ALIGNER = plugin("compare", "aligner")


def vectors():
    with open(os.path.join(ROOT, "tests", "vectors", "ssw_vectors.jsonl")) as f:
        vs = [json.loads(line) for line in f if line.strip()]
    return [v for v in vs if v["gapO"] > v["gapE"] and v["score_size"] == 2]


def fields(r):
    return dict(score1=r.score1, score2=r.score2, ref_begin1=r.ref_begin1,
                ref_end1=r.ref_end1, read_begin1=r.read_begin1,
                read_end1=r.read_end1, ref_end2=r.ref_end2, aflag=r.flag,
                cigar=R.cigar_to_string(r.cigar))


@pytest.mark.parametrize("read,ref,want", [
    # a perfect 4-base match inside the target: 4 x 2
    ("ACGT", "TTACGTTT", (8, 0, 2, 5, 0, 3, "4M")),
    # one deleted target base costs gapO: 8 - 3 + 8 beats 8 + (-2 + 6)
    ("AAAACCCC", "AAAAGCCCC", (13, 0, 0, 8, 0, 7, "4M1D4M")),
])
def test_hand_worked_alignments(read, ref, want):
    r = R.align_many([R.encode(read.encode())], R.encode(ref.encode()),
                     R.dna_matrix(2, 2), 3, 1, flag=0x0F, mask_len=15,
                     device="cpu")[0]
    assert (r.score1, r.score2, r.ref_begin1, r.ref_end1, r.read_begin1,
            r.read_end1, R.cigar_to_string(r.cigar)) == want


def test_c_api_vectors_one_at_a_time():
    bad = []
    for v in vectors():
        n = v["n"]
        r = R.align_many([np.array(v["read"])], np.array(v["ref"]),
                         np.array(v["mat"]).reshape(n, n), v["gapO"],
                         v["gapE"], flag=v["flag"], filters=v["filters"],
                         filterd=v["filterd"], mask_len=v["maskLen"],
                         device="cpu")[0]
        want = {k: v[k] for k in fields(r)}
        if fields(r) != want:
            bad.append((v["tag"], fields(r), want))
    assert not bad and len(vectors()) > 100


def test_c_api_vectors_batched_with_own_targets():
    groups = collections.defaultdict(list)
    for v in vectors():
        groups[(tuple(v["mat"]), v["n"], v["gapO"], v["gapE"], v["flag"],
                v["filters"], v["filterd"])].append(v)
    for g in groups.values():
        v0, n = g[0], g[0]["n"]
        res = R.align_many(
            [np.array(v["read"]) for v in g], [np.array(v["ref"]) for v in g],
            np.array(v0["mat"]).reshape(n, n), v0["gapO"], v0["gapE"],
            flag=v0["flag"], filters=v0["filters"], filterd=v0["filterd"],
            mask_len=np.array([v["maskLen"] for v in g]), device="cpu",
            max_cells=1 << 14)
        for v, r in zip(g, res):
            assert fields(r) == {k: v[k] for k in fields(r)}


@pytest.mark.parametrize("word,both", [(False, False), (True, False),
                                       (False, True)])
def test_forward_in_column_chunks_equals_whole(word, both):
    rng = np.random.default_rng(3)
    ref = rng.integers(0, 4, 700)
    reads = [ref[100:180].copy(), rng.integers(0, 4, 45),
             ref[600:690].copy()]
    reads[0][[5, 40]] = 3 - reads[0][[5, 40]]
    mat = R.dna_matrix(2, 2)
    ref_d = torch.as_tensor(ref)
    whole = R.forward(reads, ref_d, mat, 3, 1, word, keep_colmax=True,
                      both_tiers=both)
    cut = R.forward(reads, ref_d, mat, 3, 1, word, keep_colmax=True,
                    both_tiers=both, chunk=37)
    for a, b in ((whole.score, cut.score), (whole.end_ref, cut.end_ref),
                 (whole.end_read, cut.end_read)):
        assert (a == b).all()
    assert torch.equal(whole.colmax, cut.colmax)
    if both:
        assert torch.equal(whole.colmax_word, cut.colmax_word)


def test_one_pass_for_both_tiers_is_each_tiers_own_pass():
    """Where min(mat) >= -2 gapE one byte-geometry pass gives both tiers'
    scores, ends and per-column maxima."""
    rng = np.random.default_rng(8)
    ref = rng.integers(0, 5, 900)
    reads = [ref[40:173].copy(), rng.integers(0, 4, 37), ref[500:800].copy(),
             ref[850:870].copy()]
    for r in reads:
        r[::17] = (r[::17] + 1) % 4
    mat = R.dna_matrix(2, 2)
    ref_d = torch.as_tensor(ref)
    both = R.forward(reads, ref_d, mat, 3, 1, False, keep_colmax=True,
                     both_tiers=True)
    for word, cm in ((False, both.colmax), (True, both.colmax_word)):
        own = R.forward(reads, ref_d, mat, 3, 1, word, keep_colmax=True)
        assert (own.score == both.score).all()
        assert (own.end_ref == both.end_ref).all()
        assert (own.end_read == both.end_read).all()
        assert torch.equal(own.colmax, cm)


def test_cpp_example_pair():
    """ref: src/example.cpp, the C++ wrapper's printed result."""
    cfg = {"scoring": {"match": 2, "mismatch": 2, "gap_open": 3,
                       "gap_extension": 1}}
    read = np.frombuffer(b"CTGAGCCGGTAAATC", dtype=np.uint8)
    ref = b"CAGCCTTTCTGACCCGGAAATCAAAATAGGCACAACAAA"
    got = ALIGNER.aligner_fields(cfg, {"window": len(ref)}, ref, [read], [0],
                               "cpu")
    assert got == [(21, 8, 8, 21, 0, 14, 4, 2, "4=1X4=1I5=", 0)]


def read_fastx(path):
    """(name up to the first whitespace, seq, qual or None) records of a
    FASTQ or FASTA file."""
    with open(path, "rb") as f:
        lines = [ln.rstrip(b"\r") for ln in f.read().split(b"\n")]
    if lines[0].startswith(b"@"):
        return [(lines[i][1:].split()[0], lines[i + 1], lines[i + 3])
                for i in range(0, len(lines) - 3, 4)]
    recs = []
    for ln in lines:
        if ln.startswith(b">"):
            recs.append([ln[1:].split()[0], b"", None])
        elif ln:
            recs[-1][1] += ln.strip()
    return [tuple(r) for r in recs]


# every SAM golden of tests/golden: ssw_test's own output (README there)
SAM_GOLDENS = [
    ("g_54mer_100k_sam.txt", "100k.fa", "54mer_hap1_1.100.fastq",
     ["-c", "-s", "-h", "-r"], (2, 2, 3, 1)),
    ("g_54fa_10k_sam.txt", "10k.fa", "54mer_hap1_1.100.fa",
     ["-c", "-s", "-h", "-r"], (2, 2, 3, 1)),
    ("g_54_10k_m1x3o5e2.txt", "10k.fa", "54mer_hap1_1.100.fastq",
     ["-c", "-s", "-h"], (1, 3, 5, 2)),
    ("g_r1_sam.txt", "r1.fa", "r1_query.fq", ["-c", "-s", "-h"],
     (2, 2, 3, 1)),
]


@pytest.mark.parametrize("golden,target,reads,flags,pen", SAM_GOLDENS,
                         ids=[g[0] for g in SAM_GOLDENS])
def test_sam_golden_whole(golden, target, reads, flags, pen):
    """Every record of ssw_test's SAM goldens: score, ends, suboptimal
    score (ZS), begins, CIGAR with '='/'X', MAPQ, NM, strand and the
    qualities, byte for byte."""
    from benchmark import gen

    data = os.path.join(ROOT, "tests", "data")
    recs = read_fastx(os.path.join(data, reads))
    path = os.path.join(data, target)
    tgt = {"name": gen.fasta_name(path), "seq": gen.load_fasta_seq(path)}
    m, x, o, e = pen
    cfg = {"scoring": {"matrix": "dna", "match": m, "mismatch": x,
                       "gap_open": o, "gap_extension": e},
           "cli_flags": flags}
    got = [ln for ln in CLI.sam_lines(cfg, tgt, recs, "cpu")
           if ln is not None]
    with open(os.path.join(ROOT, "tests", "golden", golden)) as f:
        gold = f.read().splitlines(keepends=True)
    assert CLI.header_lines(cfg, tgt) == [g.rstrip("\n") for g in gold[:2]]
    assert len(gold) - 2 == len(recs) and got == gold[2:]


def test_aligner_rendering_is_ssw_tests_marking():
    """The C++ Aligner's mismatches and '='/'X' CIGAR (a copy of the
    program's api._mark_mismatches) equal ssw_test's NM and CIGAR (a copy
    of ssw.c's mark_mismatch, which the SAM goldens hold) for every C-API
    vector's alignment: two renderings, one of them held to upstream."""
    n_checked = 0
    for v in vectors():
        n = v["n"]
        read, ref = np.array(v["read"]), np.array(v["ref"])
        r = R.align_many([read], ref, np.array(v["mat"]).reshape(n, n),
                         v["gapO"], v["gapE"], flag=v["flag"],
                         filters=v["filters"], filterd=v["filterd"],
                         mask_len=v["maskLen"], device="cpu")[0]
        if not r.cigar:
            continue
        nm, cig = R.mark_mismatch(r.ref_begin1, r.read_begin1, r.read_end1,
                                  ref, read, len(read), r.cigar)
        fields = R.aligner_fields(r, ref, read)
        assert (fields[7], fields[8]) == (nm, R.cigar_to_string(cig))
        n_checked += 1
    assert n_checked > 100


@pytest.mark.cuda
def test_reference_on_the_card_is_the_cpu_reference(card):
    """The runs compute the reference on the card: the same vectors there."""
    v0 = vectors()[0]
    key = ("mat", "gapO", "gapE", "flag", "filters", "filterd")
    g = [v for v in vectors() if all(v[k] == v0[k] for k in key)]
    n = v0["n"]
    assert len(g) >= 20
    kw = dict(flag=g[0]["flag"], filters=g[0]["filters"],
              filterd=g[0]["filterd"],
              mask_len=np.array([v["maskLen"] for v in g]))
    args = ([np.array(v["read"]) for v in g], [np.array(v["ref"]) for v in g],
            np.array(g[0]["mat"]).reshape(n, n), g[0]["gapO"], g[0]["gapE"])
    on_card = R.align_many(*args, device=card, **kw)
    on_cpu = R.align_many(*args, device="cpu", **kw)
    assert [fields(r) for r in on_card] == [fields(r) for r in on_cpu]
    assert [fields(r) for r in on_card] == [{k: v[k] for k in fields(r)}
                                           for v, r in zip(g, on_card)]
