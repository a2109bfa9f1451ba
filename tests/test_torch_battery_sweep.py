"""The port's sweep_boundaries and bench_leaf (ssw_tpu_torch/tools) on the
CPU, held against the JAX package's tools and pipeline: mk_workload byte
for byte against tools/sweep_boundaries.py's, and every sweep setting's
checksum and results, at R 4096 and B 16, equal to
ssw_tpu.pipeline.align_batch(req, "scan") on the same workload.  Integer
outputs: tolerance 0."""

import os
import sys

import pytest

from ssw_tpu import pipeline as jax_pipeline
from ssw_tpu.core.encoding import dna_matrix as jax_dna_matrix
from ssw_tpu_torch import pipeline
from ssw_tpu_torch.core.encoding import dna_matrix
from ssw_tpu_torch.tools import bench_leaf, sweep_boundaries

R, B, READ_LEN = 4096, 16, 100


@pytest.fixture(scope="module")
def jax_tool():
    """tools/sweep_boundaries.py, imported as the namespace package
    `tools`; its import sets JAX_COMPILATION_CACHE_DIR and puts the working
    directory on sys.path, both undone here."""
    env, path = dict(os.environ), list(sys.path)
    try:
        from tools import sweep_boundaries as tool
        yield tool
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path


@pytest.fixture(scope="module")
def jax_results():
    ref, reads = sweep_boundaries.mk_workload(R, B, READ_LEN)
    req = jax_pipeline.BatchRequest(
        reads=reads, ref=ref, mat=jax_dna_matrix(2, 2), gapO=3, gapE=1,
        flag=0x0F, mask_len=[max(len(r) // 2, 15) for r in reads])
    return jax_pipeline.align_batch(req, "scan")


def _fields(out):
    return [None if a is None else vars(a) for a in out]


@pytest.mark.parametrize("R_,B_,rl", [(4096, 16, 100), (16384, 64, 150),
                                      (1 << 20, 8, 200)])
def test_mk_workload_byte_equal(jax_tool, R_, B_, rl):
    want_ref, want_reads = jax_tool.mk_workload(R_, B_, rl)
    ref, reads = sweep_boundaries.mk_workload(R_, B_, rl)
    assert ref.dtype == want_ref.dtype and ref.tobytes() == want_ref.tobytes()
    assert len(reads) == len(want_reads) == B_
    for a, b in zip(reads, want_reads):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_sweep_stream_matches_jax(jax_results):
    want = sweep_boundaries.checksum(jax_results)
    rows = sweep_boundaries.sweep_stream("cpu", sizes=((R, B),))
    assert [r["cfg"] for r in rows] == [f"R={R} stream=0", f"R={R} stream=1"]
    assert all(r["checksum"] == want and r["device"] == "cpu" for r in rows)
    assert pipeline.STREAM_SUBOPT is None
    ref, reads = sweep_boundaries.mk_workload(R, B, READ_LEN)
    for stream in (False, True):
        pipeline.STREAM_SUBOPT = stream
        try:
            _, out = sweep_boundaries.run_once(ref, reads, dna_matrix(2, 2),
                                               "cpu")
        finally:
            pipeline.STREAM_SUBOPT = None
        assert _fields(out) == _fields(jax_results)


def test_sweep_packw_matches_jax(jax_results):
    want = sweep_boundaries.checksum(jax_results)
    rows = sweep_boundaries.sweep_packw("cpu", R=R, B=B,
                                        read_lens=(READ_LEN,),
                                        widths=(0, 1024))
    assert [r["cfg"] for r in rows] == ["rl=100 packL=auto",
                                        "rl=100 packL=1024"]
    assert all(r["checksum"] == want for r in rows)
    assert pipeline.STREAM_SUBOPT is None and pipeline.PACK_L == 0


def test_bench_leaf_matches_jax(jax_results, capsys):
    assert bench_leaf.main([str(R), str(B), str(READ_LEN), "1",
                            "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "'checksum': " + repr(bench_leaf.checksum(jax_results)) in printed
    rows = bench_leaf.run(R, B, READ_LEN, reps=1, device="cpu")
    assert rows[0]["checksum"] == bench_leaf.checksum(jax_results)
    assert set(rows[0]) == {"rep", "wall_s", "reads_per_s", "phases",
                            "checksum", "device"}
    assert {"forward", "reverse"} <= set(rows[0]["phases"])


def test_bench_leaf_checksum_skips_none():
    class Res:
        score1, score2, ref_end2 = 5, 3, 40

    assert bench_leaf.checksum([Res, None, Res]) == (10, 6, 80)
    assert bench_leaf.checksum([]) == (0, 0, 0)
