"""The port's plain PyTorch DP (ssw_tpu_torch.ops.scan_sw) against the JAX
package: its scan path and its Pallas kernels in interpret mode, on the
grids of tests/test_pallas.py.  Inputs are made with numpy from a seed and
handed to both.  The DP is integer arithmetic: every output must be exactly
equal (tolerance 0).  On the CPU the CUDA wrappers (ops.cuda_sw) route to the
same plain versions, which is checked here too."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ssw_tpu.ops import common, pallas_sw
from ssw_tpu.ops import scan_sw as jax_scan
from ssw_tpu_torch.core.encoding import BLOSUM50
from ssw_tpu_torch.ops import cuda_sw
from ssw_tpu_torch.ops import scan_sw as torch_scan


def _mat(max_sub, n=5):
    mat = np.zeros((n, n), np.int8)
    for i in range(n - 1):
        for j in range(n - 1):
            mat[i, j] = max_sub if i == j else -max_sub
    return mat


def _geometry(reads, read_len, L, mat, word):
    n = mat.shape[0]
    rp = common.pad_reads(reads, L, n)
    prof = common.build_profile(rp, read_len, common.extend_matrix(mat))
    geo = common.batch_geometry(read_len, L, word=word)
    return (prof, read_len, geo.col_mask, geo.seg_id, geo.seg_start)


def _both(prof, ref, read_len, col_mask, seg_id, seg_start):
    """(jax args, torch args) of the same numpy inputs."""
    arrs = (prof, ref, read_len, col_mask, seg_id, seg_start)
    return (tuple(jnp.asarray(a) for a in arrs),
            tuple(torch.as_tensor(np.ascontiguousarray(a)) for a in arrs))


def _shared(B, L, R, max_sub, seed, word):
    rng = np.random.default_rng(seed)
    mat = _mat(max_sub)
    ref = rng.integers(0, 4, R).astype(np.int32)
    read_len = rng.integers(max(L // 3, 2), L - 20, B).astype(np.int32)
    reads = [rng.integers(0, 4, l).astype(np.int32) for l in read_len]
    prof, rl, cm, sid, ss = _geometry(reads, read_len, L, mat, word)
    return _both(prof, ref, rl, cm, sid, ss)


def _perread(B, L, W, max_sub, seed, word):
    rng = np.random.default_rng(seed)
    mat = _mat(max_sub)
    n = mat.shape[0]
    read_len = rng.integers(max(L // 3, 2), L - 20, B).astype(np.int32)
    reads = [rng.integers(0, 4, l).astype(np.int32) for l in read_len]
    refw = np.full((B, W), n, np.int32)
    for b in range(B):
        w = int(rng.integers(W // 2, W))
        refw[b, :w] = rng.integers(0, 4, w)
        # embed the read so positive scores (and terminate hits) exist
        s = int(rng.integers(0, max(1, w - read_len[b])))
        take = min(read_len[b], w - s)
        refw[b, s:s + take] = reads[b][:take]
    prof, rl, cm, sid, ss = _geometry(reads, read_len, L, mat, word)
    return _both(prof, refw, rl, cm, sid, ss)


def _eq(want, got, names):
    assert len(want) == len(got)
    for w, g, name in zip(want, got, names):
        w = np.asarray(w).astype(np.int64)
        g = g.numpy().astype(np.int64) if isinstance(g, torch.Tensor) \
            else np.asarray(g).astype(np.int64)
        np.testing.assert_array_equal(w, g, err_msg=name)


FWD = ("score", "end_ref", "end_read", "maxcol")
REV = ("score", "end_ref", "end_read", "maxcol")


@pytest.mark.parametrize("max_sub,gapO,gapE,quirk,word", [
    (2, 3, 1, False, False),
    (2, 3, 1, False, True),
    (3, 5, 2, False, False),
    (5, 3, 1, True, False),
    (127, 3, 1, False, False),
])
def test_forward_shared_matches_jax(max_sub, gapO, gapE, quirk, word):
    jx, tc = _shared(B=8, L=128, R=512, max_sub=max_sub, seed=max_sub * 7,
                     word=word)
    got = torch_scan.forward_shared_ref(*tc, gapO, gapE, quirk)
    assert got[3].dtype == torch.int16
    _eq(jax_scan.forward_shared_ref(*jx, gapO, gapE, quirk), got, FWD)
    _eq(pallas_sw.forward_shared_ref(*jx, gapO, gapE, quirk,
                                     max_sub=max_sub), got, FWD)


def test_forward_shared_protein_quirk():
    """BLOSUM50 (min -5 < -2*gapE: the lane-block E quirk is observable)
    with reads embedded in the target, word geometry."""
    rng = np.random.default_rng(5)
    ref = rng.integers(0, 20, 600).astype(np.int32)
    read_len = rng.integers(20, 90, 8).astype(np.int32)
    reads = []
    for ln in read_len:
        s = int(rng.integers(0, 600 - ln))
        r = ref[s:s + ln].copy()
        m = rng.random(ln) < 0.15
        r[m] = rng.integers(0, 20, int(m.sum()))
        reads.append(r)
    prof, rl, cm, sid, ss = _geometry(reads, read_len, 128, BLOSUM50, True)
    jx, tc = _both(prof, ref, rl, cm, sid, ss)
    got = torch_scan.forward_shared_ref(*tc, 3, 1, True)
    _eq(jax_scan.forward_shared_ref(*jx, 3, 1, True), got, FWD)


@pytest.mark.parametrize("L,gapO,gapE,max_sub,quirk", [
    (128, 3, 1, 2, False),     # config 4: the int16 tier
    (128, 3, 1, 2, True),      # the quirk needs int32
    (128, 3, 1, None, False),  # no max_sub: int32
    (5440, 3, 1, 2, False),    # just inside the bound
    (5504, 3, 1, 2, False),    # just outside it
    (1024, 5, 2, 3, False),
    (512, 3, 1, 127, False),
])
def test_i16_exact_matches_jax(L, gapO, gapE, max_sub, quirk):
    """The port picks the int16 tier of forward_shared exactly where the
    JAX package picks its own."""
    assert (cuda_sw.i16_exact(L, gapO, gapE, max_sub, quirk)
            == pallas_sw.i16_exact(L, gapO, gapE, max_sub, quirk))


@pytest.mark.parametrize("max_sub,gapO,gapE,quirk,word,with_term", [
    (2, 3, 1, False, False, False),
    (2, 3, 1, False, True, True),
    (3, 5, 2, False, False, True),
    (5, 3, 1, True, False, False),
    (5, 3, 1, True, False, True),
])
def test_forward_perread_matches_jax(max_sub, gapO, gapE, quirk, word,
                                     with_term):
    jx, tc = _perread(B=8, L=128, W=200, max_sub=max_sub, seed=max_sub * 13,
                      word=word)
    term_j = term_t = None
    if with_term:
        # realistic terminate: the actual best score for half the reads
        base = np.asarray(jax_scan.forward_perread_ref(*jx, 3, 1, False)[0])
        t = base.copy()
        t[::2] = -1
        term_j, term_t = jnp.asarray(t, jnp.int32), torch.as_tensor(t)
    got = torch_scan.forward_perread_ref(*tc, gapO, gapE, quirk,
                                         terminate=term_t)
    _eq(jax_scan.forward_perread_ref(*jx, gapO, gapE, quirk,
                                     terminate=term_j), got, REV)
    _eq(pallas_sw.forward_perread_ref(*jx, gapO, gapE, quirk,
                                      terminate=term_j), got, REV)


@pytest.mark.parametrize("quirk,with_term", [(False, False), (True, True)])
def test_forward_perread_emit_maxcol(quirk, with_term):
    jx, tc = _perread(B=8, L=128, W=512, max_sub=5 if quirk else 2, seed=29,
                      word=False)
    term_j = term_t = None
    if with_term:
        t = np.asarray(jax_scan.forward_perread_ref(*jx, 3, 1, quirk)[0])
        t = t.copy()
        t[1::2] = -1
        term_j, term_t = jnp.asarray(t, jnp.int32), torch.as_tensor(t)
    got = torch_scan.forward_perread_ref(*tc, 3, 1, quirk, terminate=term_t,
                                         emit_maxcol=True)
    assert got[3].dtype == torch.int32 and tuple(got[3].shape) == (8, 512)
    _eq(jax_scan.forward_perread_ref(*jx, 3, 1, quirk, terminate=term_j,
                                     emit_maxcol=True), got, REV)
    if not with_term:
        _eq(pallas_sw.forward_perread_ref(*jx, 3, 1, quirk,
                                          emit_maxcol=True), got, REV)


def _maxcol_with_ties(B, R, seed):
    rng = np.random.default_rng(seed)
    mc = rng.integers(0, 40, (B, R)).astype(np.int64)
    # plant equal maxima at several columns of each row (tie-break check)
    for b in range(B):
        cols = rng.choice(R, size=3, replace=False)
        mc[b, cols] = 60 + b % 3
    mc[0] = 0  # an all-zero row: score2 0, ref_end2 0
    return mc


@pytest.mark.parametrize("chunk_elems", [None, 300])
def test_second_best_batch_matches_jax(chunk_elems, monkeypatch):
    """Ties resolve to the FIRST attaining column, the word/byte tiers keep
    their window-edge asymmetry, and the row-chunked reduction (forced
    small here) equals the whole one."""
    if chunk_elems is not None:
        monkeypatch.setattr(torch_scan, "_SUBOPT_ELEMS", chunk_elems)
    B, R, ref_len = 12, 257, 240
    mc = _maxcol_with_ties(B, R, seed=3)
    rng = np.random.default_rng(4)
    end_ref = rng.integers(0, ref_len, B).astype(np.int32)
    end_ref[3] = ref_len - 1  # window at the target's edge
    mask_len = rng.integers(15, 40, B).astype(np.int32)
    word = np.arange(B) % 2 == 1
    want = jax_scan.second_best_batch(
        jnp.asarray(mc.astype(np.uint16)), jnp.asarray(end_ref),
        jnp.asarray(mask_len), ref_len, jnp.asarray(word))
    got = torch_scan.second_best_batch(
        torch.as_tensor(mc.astype(np.int16)), torch.as_tensor(end_ref),
        torch.as_tensor(mask_len), ref_len, torch.as_tensor(word))
    _eq(want, got, ("score2", "ref_end2"))


def test_second_best_tie_is_first_index():
    mc = np.zeros((2, 64), np.int16)
    mc[:, [5, 9, 60]] = 7
    got = torch_scan.second_best_batch(
        torch.as_tensor(mc), torch.tensor([30, 30], dtype=torch.int32),
        torch.tensor([15, 15], dtype=torch.int32), 64,
        torch.tensor([False, True]))
    assert got[0].tolist() == [7, 7] and got[1].tolist() == [5, 5]


def test_second_best_word_edge_asymmetry():
    """Column end_ref + mask_len is inside the byte window but outside the
    word window (ref: src/ssw.c:368-381 vs 570-583)."""
    mc = np.zeros((2, 100), np.int16)
    mc[:, 45] = 9  # end_ref 30 + mask_len 15
    got = torch_scan.second_best_batch(
        torch.as_tensor(mc), torch.tensor([30, 30], dtype=torch.int32),
        torch.tensor([15, 15], dtype=torch.int32), 100,
        torch.tensor([False, True]))
    want = jax_scan.second_best_batch(
        jnp.asarray(mc.astype(np.uint16)), jnp.asarray([30, 30], jnp.int32),
        jnp.asarray([15, 15], jnp.int32), 100, jnp.asarray([False, True]))
    _eq(want, got, ("score2", "ref_end2"))
    assert got[0].tolist() == [0, 9]


@pytest.mark.parametrize("R,ref_len", [(512, 512), (700, 650), (100, 90)])
def test_blockmax_reduce_matches_jax(R, ref_len):
    mc = _maxcol_with_ties(6, R, seed=R)
    want = jax_scan.blockmax_reduce(jnp.asarray(mc.astype(np.uint16)),
                                    ref_len)
    got = torch_scan.blockmax_reduce(torch.as_tensor(mc.astype(np.int16)),
                                     ref_len)
    _eq((want,), (got,), ("blockmax",))


def test_cuda_wrappers_route_cpu_tensors_to_plain():
    """On the CPU the kernel wrappers return exactly the plain versions'
    outputs and count no launch."""
    cuda_sw.reset_launches()
    _, tc = _shared(B=8, L=128, R=300, max_sub=2, seed=1, word=False)
    want = torch_scan.forward_shared_ref(*tc, 3, 1, False)
    _eq(want, cuda_sw.forward_shared(*tc, 3, 1, False), FWD)
    _eq(want, cuda_sw.forward_shared(*tc, 3, 1, False, max_sub=2), FWD)
    _, tp = _perread(B=8, L=128, W=200, max_sub=2, seed=2, word=False)
    term = torch.full((8,), 9, dtype=torch.int32)
    _eq(torch_scan.forward_perread_ref(*tp, 3, 1, False, terminate=term,
                                       emit_maxcol=True),
        cuda_sw.forward_perread(*tp, 3, 1, False, terminate=term,
                                emit_maxcol=True), REV)
    assert cuda_sw.launch_counts() == {"forward_shared": 0,
                                       "forward_shared_i16": 0,
                                       "forward_shared_blockmax": 0,
                                       "forward_shared_i16_blockmax": 0,
                                       "forward_shared_dual": 0,
                                       "forward_shared_i16_dual": 0,
                                       "forward_shared_packed": 0,
                                       "forward_shared_packed_dual": 0,
                                       "forward_shared_owned": 0,
                                       "forward_shared_i16_owned": 0,
                                       "forward_perread": 0}


def test_wrapper_never_falls_back_for_device_tensors():
    """A tensor that is not on the CPU goes to the kernel path, which
    raises for anything but a CUDA tensor; it never reaches the plain
    version."""
    _, tc = _shared(B=8, L=128, R=64, max_sub=2, seed=1, word=False)
    meta = tuple(t.to("meta") for t in tc)
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda_sw.forward_shared(*meta, 3, 1, False)
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda_sw._launch_shared(*meta, 3, 1, False, i16=True)
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda_sw.forward_perread(*meta[:1], meta[1].reshape(1, 64).expand(
            8, 64), *meta[2:], 3, 1, False)
