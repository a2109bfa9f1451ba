"""The sharded path's spans and counts (parallel/dist.py, dcli.py) on CPU
meshes, and BASELINE config 5's route at a small size: `dcli align
--mesh-seq 4` + `dcli merge` over [cpu] * 4 against a target extended as
tools/make_data.py make_10m extends 1M.fa, byte-equal to the port's
cli.main with -c -s -h -r.

sharded_forward records `dist.launch` and `dist.merge` once a call, one
`shard_forwards` per mesh cell, and `peer_bytes` 0 (every cell on one
device)."""

import gzip
import io
import os

import numpy as np
import pytest
import torch

from ssw_tpu_torch import cli, dcli, pipeline, profiling
from ssw_tpu_torch.core.encoding import dna_matrix
from ssw_tpu_torch.ops import common
from ssw_tpu_torch.parallel import dist
from ssw_tpu_torch.parallel import mesh as mesh_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain DP here runs small tensors, on which torch's thread pool
    gains nothing and only competes with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    """12 reads of 40-110 codes, 15 % mutated copies of pieces of a 2,048
    column target, as sharded_forward takes them (halo prepended)."""
    rng = np.random.default_rng(5)
    B, L, R = 12, 128, 2048
    mat = dna_matrix(2, 2)
    ref = rng.integers(0, 4, R).astype(np.int32)
    read_len = rng.integers(40, 110, B).astype(np.int32)
    reads = []
    for ln in read_len:
        off = int(rng.integers(0, R - ln))
        r = ref[off:off + ln].copy()
        m = rng.random(ln) < 0.15
        r[m] = rng.integers(0, 4, int(m.sum()))
        reads.append(r)
    prof = common.build_profile(common.pad_reads(reads, L, 5), read_len,
                                common.extend_matrix(mat))
    geo = common.batch_geometry(read_len, L, word=False)
    halo = pipeline._window_len(int(read_len.max()), R, mat, 3, 1)
    ref_ext = np.concatenate([np.full(halo, 5, np.int32), ref])
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    args = (t(prof), t(ref_ext), t(read_len), t(geo.col_mask),
            t(geo.seg_id), t(geo.seg_start), 3, 1,
            t(np.maximum(read_len // 2, 15).astype(np.int32)), R, halo)
    return args


def _run(problem, data, seq):
    m = mesh_lib.make_mesh(data=data, seq=seq, devices=[CPU] * (data * seq))
    c = profiling.GcupsCounter()
    with pipeline.profiled(c):
        out = dist.sharded_forward(m, *problem, quirk=False, max_sub=2)
    return out, c


@pytest.mark.parametrize("data,seq", [(1, 4), (2, 2), (4, 1), (1, 1)])
def test_sharded_forward_spans_and_counts(problem, data, seq):
    out, c = _run(problem, data, seq)
    tot = c.totals()
    assert tot["dist.launch"][0] == 1 and tot["dist.merge"][0] == 1
    assert c.counts["shard_forwards"] == data * seq
    assert c.counts["peer_bytes"] == 0
    # the spans change nothing: the same answer as one cell
    want, _ = _run(problem, 1, 1)
    for g, w in zip(out, want):
        assert torch.equal(g, w)


def test_spans_nest_under_the_caller(problem):
    """dist.launch and dist.merge are children of the open span, and the
    launch precedes the merge."""
    m = mesh_lib.make_mesh(data=1, seq=4, devices=[CPU] * 4)
    c = profiling.GcupsCounter()
    with pipeline.profiled(c), profiling.span("caller"):
        dist.sharded_forward(m, *problem, quirk=False, max_sub=2)
    by = {name: (sid, parent, t0, t1)
          for name, sid, parent, _, t0, t1 in c.spans}
    root = by["caller"][0]
    assert by["dist.launch"][1] == root and by["dist.merge"][1] == root
    assert by["dist.launch"][3] <= by["dist.merge"][2]
    assert c.requests == 1


def _extended(path, base: bytes, length: int, seed: int):
    """make_10m's construction at a small size: base, then a tail of the
    base's ACGT composition drawn from seed; make_10m's FASTA name."""
    arr = np.frombuffer(base, np.uint8)
    acgt = arr[np.isin(arr, ACGT)]
    p = np.array([(acgt == b).sum() for b in ACGT], np.float64)
    tail = np.random.default_rng(seed).choice(
        ACGT, size=length - len(base), p=p / p.sum()).astype(np.uint8)
    seq = base + tail.tobytes()
    with open(path, "wb") as f:
        f.write(b">chr3\t50000\t10050000\tsynthetic-extension\n")
        for i in range(0, len(seq), 10000):
            f.write(seq[i:i + 10000] + b"\n")
    return seq


def _reads(path, genome: bytes, n: int, seed: int):
    """Illumina-like reads (make_data's make_reads model): 100 bp from
    uniform origins, 0.5 % substitutions, half reverse-complemented."""
    rng = np.random.default_rng(seed)
    g = np.frombuffer(genome, np.uint8)
    comp = np.zeros(256, np.uint8)
    comp[ACGT] = np.frombuffer(b"TGCA", np.uint8)
    with gzip.open(path, "wb") as f:
        for i in range(n):
            pos = int(rng.integers(0, len(g) - 100))
            rd = g[pos:pos + 100].copy()
            m = rng.random(100) < 0.005
            rd[m] = rng.choice(ACGT, int(m.sum()))
            if i % 2:
                rd = comp[rd][::-1]
            f.write(b"@r%d_%d\n%s\n+\n%s\n" % (i, pos, rd.tobytes(),
                                              b"I" * 100))


def _base():
    seq = []
    with open(os.path.join(REPO, "tests", "data", "1M.fa"), "rb") as f:
        for line in f:
            if not line.startswith(b">"):
                seq.append(line.strip())
            if sum(map(len, seq)) > 503_000:
                break
    return b"".join(seq)[500_000:503_000]


def test_dcli_mesh_seq4_matches_cli(tmp_path):
    """Config 5's route on [cpu] * 4: the merged SAM of dcli align
    --mesh-seq 4 (two batches) equals cli.main's, header included; the
    routed counter sees one dcli.align and one dcli.merge root, and one
    shard forward per batch, strand and shard (16 at least)."""
    target, query = str(tmp_path / "t.fa"), str(tmp_path / "q.fastq.gz")
    genome = _extended(target, _base(), 9000, 10_000_000)
    _reads(query, genome, 10, 3)
    out, err = io.StringIO(), io.StringIO()
    assert cli.main(["-c", "-s", "-h", "-r", target, query], out=out,
                    err=err, device="cpu") == 0
    want = out.getvalue()
    assert want.startswith("@HD") and "\tLN:9000\n" in want
    prefix, merged = str(tmp_path / "run"), str(tmp_path / "merged.sam")
    c = profiling.GcupsCounter()
    with pipeline.profiled(c):
        assert dcli.main(["align", "-c", "-s", "--header", "-r",
                          "--mesh-seq", "4", "--batch-size", "6", "--out",
                          prefix, target, query], out=io.StringIO(),
                         err=io.StringIO(), devices=[CPU] * 4) == 0
        assert dcli.main(["merge", "--out", merged, prefix + ".part0"],
                         out=io.StringIO(), err=io.StringIO()) == 0
    with open(merged) as f:
        assert f.read() == want
    tot = c.totals()
    assert tot["dcli.align"][0] == 1 and tot["dcli.merge"][0] == 1
    assert c.requests == 2
    assert c.counts["shard_forwards"] >= 2 * 2 * 4
    assert c.counts["peer_bytes"] == 0
