"""ssw_tpu_torch.tools.bench_protein, the counterpart of
tools/bench_protein.py, on the CPU at a reduced size (24 reads, a
5,000-aa proteome, the JAX tool's seed recipe): with PACK off and on,
its AlignResults equal ssw_tpu.pipeline.align_batch(req, "scan") field by
field.  (The streaming routes of the quirk run at full size in
chip_smoke.py phase 5i; tests/test_torch_pack.py and test_torch_stream.py
hold them against the JAX package on the CPU.)"""

import dataclasses

import pytest

from ssw_tpu import pipeline as jax_pipeline
from ssw_tpu_torch import pipeline
from ssw_tpu_torch.tools import bench_protein

N_READS, PROTEOME = 24, 5000


@pytest.fixture(scope="module")
def jax_results():
    reads, ref, mat = bench_protein.workload(N_READS, PROTEOME)
    req = jax_pipeline.BatchRequest(
        reads=reads, ref=ref, mat=mat, gapO=3, gapE=1, flag=0x0F,
        mask_len=[max(len(r) // 2, 15) for r in reads])
    return [dataclasses.asdict(a)
            for a in jax_pipeline.align_batch(req, "scan")]


@pytest.mark.parametrize("pack", [False, True])
def test_bench_protein_equals_jax(jax_results, pack):
    """PACK 0 and 1 as the JAX tool runs them."""
    reads, ref, mat = bench_protein.workload(N_READS, PROTEOME)
    outs, wall = bench_protein.run(reads, ref, mat, pack, "cpu")
    assert [dataclasses.asdict(a) for a in outs] == jax_results
    res = bench_protein.summary(pack, reads, PROTEOME, outs, wall)
    assert list(res) == ["pack", "reads", "proteome", "wall_s",
                         "reads_per_s", "gcups", "score_sum", "cigar_sum"]
    assert res["score_sum"] == sum(r["score1"] for r in jax_results)
    assert res["reads"] == N_READS and res["proteome"] == PROTEOME


def test_workload_is_the_jax_tools():
    """The JAX tool's draw: 30-150 aa reads over 20 residues, BLOSUM50 with
    the quirk on at -o3 -e1."""
    reads, ref, mat = bench_protein.workload(N_READS, PROTEOME)
    assert len(reads) == N_READS and len(ref) == PROTEOME
    assert all(30 <= len(r) <= 150 and r.max() < 20 for r in reads)
    assert mat.shape == (24, 24) and pipeline.needs_quirk(mat, 1)
