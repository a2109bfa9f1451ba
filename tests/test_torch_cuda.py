"""The hand-written CUDA kernels on the card: built from ssw_tpu_torch/csrc
with nvcc, held exactly against their plain PyTorch versions, and the
pipeline on the card against the pipeline on the CPU.  These need an NVIDIA
card and skip without one; run them on a machine with a card with
`python -m pytest tests/test_torch_cuda.py -m cuda`."""

import numpy as np
import pytest
import torch

from ssw_tpu_torch import pipeline
from ssw_tpu_torch.core.encoding import BLOSUM50, dna_matrix
from ssw_tpu_torch.ops import common, cuda_sw, scan_sw

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


def _inputs(dev, B, L, R, mat, word, seed):
    rng = np.random.default_rng(seed)
    n = mat.shape[0]
    ref = rng.integers(0, n - 1, R).astype(np.int32)
    read_len = rng.integers(L // 3, L - 16, B).astype(np.int32)
    reads = [ref[s:s + ln].copy() if b % 2 else
             rng.integers(0, n - 1, ln).astype(np.int32)
             for b, (ln, s) in enumerate(zip(
                 read_len, rng.integers(0, R - L, B)))]
    rp = common.pad_reads(reads, L, n)
    prof = common.build_profile(rp, read_len, common.extend_matrix(mat))
    geo = common.batch_geometry(read_len, L, word=word)
    arrs = (prof, ref, read_len, geo.col_mask, geo.seg_id, geo.seg_start)
    return tuple(torch.as_tensor(np.ascontiguousarray(a)).to(dev)
                 for a in arrs)


def _equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("L,mat,gapO,gapE,quirk,word", [
    (128, dna_matrix(2, 2), 3, 1, False, False),
    (64, dna_matrix(1, 3), 5, 2, False, True),
    (256, BLOSUM50, 3, 1, True, False),
    (1088, dna_matrix(2, 2), 3, 1, False, False),
])
def test_forward_shared_kernel_equals_plain(card, L, mat, gapO, gapE, quirk,
                                            word):
    args = _inputs(card, 37, L, 1500, mat, word, seed=L)
    before = cuda_sw.launch_counts()["forward_shared"]
    got = cuda_sw.forward_shared(*args, gapO, gapE, quirk)
    assert cuda_sw.launch_counts()["forward_shared"] == before + 1
    _equal(got, scan_sw.forward_shared_ref(*args, gapO, gapE, quirk))


@pytest.mark.parametrize("L,B,mat,gapO,gapE", [
    (128, 37, dna_matrix(2, 2), 3, 1),
    (64, 36, dna_matrix(1, 3), 5, 2),
    (512, 5, dna_matrix(2, 2), 3, 1),
    (1088, 21, dna_matrix(2, 2), 3, 1),
])
def test_forward_shared_i16_kernel_equals_plain(card, L, B, mat, gapO, gapE):
    """The int16 tier (two reads per warp, packed s16x2): odd and even B,
    register and global-row variants."""
    args = _inputs(card, B, L, 1500, mat, False, seed=L + 1)
    max_sub = int(np.abs(mat).max())
    assert cuda_sw.i16_exact(L, gapO, gapE, max_sub, False)
    before = cuda_sw.launch_counts()
    got = cuda_sw.forward_shared(*args, gapO, gapE, False, max_sub=max_sub)
    after = cuda_sw.launch_counts()
    assert after["forward_shared_i16"] == before["forward_shared_i16"] + 1
    assert after["forward_shared"] == before["forward_shared"]
    _equal(got, scan_sw.forward_shared_ref(*args, gapO, gapE, False))


def test_i16_parity_gate_runs_once_uncounted(card):
    cuda_sw._I16_CHECKED.clear()
    before = cuda_sw.launch_counts()
    cuda_sw._i16_parity(card)
    assert cuda_sw.launch_counts() == before
    assert card.index in cuda_sw._I16_CHECKED


@pytest.mark.parametrize("terminate,emit", [(False, False), (True, False),
                                            (True, True)])
def test_forward_perread_kernel_equals_plain(card, terminate, emit):
    prof, ref, rl, cm, sid, ss = _inputs(card, 29, 128, 400,
                                         dna_matrix(2, 2), False, seed=3)
    refw = torch.stack([torch.roll(ref[:300], 7 * b) for b in range(29)])
    args = (prof, refw.contiguous(), rl, cm, sid, ss, 3, 1, False)
    term = None
    if terminate:
        term = scan_sw.forward_perread_ref(*args)[0].clone()
        term[::2] = -1
    _equal(cuda_sw.forward_perread(*args, terminate=term, emit_maxcol=emit),
           scan_sw.forward_perread_ref(*args, terminate=term,
                                       emit_maxcol=emit))


def test_pipeline_on_card_equals_cpu(card):
    rng = np.random.default_rng(11)
    ref = rng.integers(0, 4, 3000).astype(np.int8)
    reads = []
    for _ in range(100):
        ln = int(rng.integers(30, 200))
        s = int(rng.integers(0, 3000 - ln))
        r = ref[s:s + ln].copy()
        m = rng.random(ln) < 0.05
        r[m] = rng.integers(0, 4, int(m.sum()))
        reads.append(r)
    req = pipeline.BatchRequest(reads=reads, ref=ref, mat=dna_matrix(2, 2),
                                gapO=3, gapE=1,
                                mask_len=[max(len(r) // 2, 15)
                                          for r in reads])
    cuda_sw.reset_launches()
    got = pipeline.align_batch(req)
    counts = cuda_sw.launch_counts()
    # DNA m2/x2/o3/e1: every forward launch takes the int16 tier
    assert counts["forward_shared_i16"] > 0 and counts["forward_perread"] > 0
    assert counts["forward_shared"] == 0
    want = pipeline.align_batch(req, device="cpu")
    assert [vars(a) for a in got] == [vars(b) for b in want]
