"""The port's sharded forward pass against the JAX package.

The owned-column mode of the plain forward DP (ops/scan_sw.py
forward_shared_ref_gated, the model of both CUDA forward kernels' Owned
mode) against the JAX package's scan_sw.forward_shared_ref_gated and, once,
its Pallas kernel in interpret mode; parallel/dist.sharded_forward on CPU
meshes of [cpu] * 8 against the JAX package's single-device forward pass and
suboptimal scan (tests/test_parallel.py's problem and mesh shapes); and the
best-hit merge's tie-breaks.  Inputs are made with numpy from seeds and
handed to both packages.  Integer DP: every output must be exactly equal
(tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssw_tpu import pipeline as jax_pipeline
from ssw_tpu.ops import common, pallas_sw
from ssw_tpu.ops import scan_sw as jax_scan
from ssw_tpu.parallel import dist as jax_dist
from ssw_tpu_torch.core.encoding import BLOSUM50
from ssw_tpu_torch.ops import cuda_sw, gate
from ssw_tpu_torch.ops import scan_sw as torch_scan
from ssw_tpu_torch.parallel import dist, mesh as mesh_lib

FWD = ("score", "end_ref", "end_read", "maxcol")
OUT = ("score", "end_ref", "end_read", "score2", "ref_end2")
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain DP here runs small tensors, on which torch's thread pool
    gains nothing and only competes with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _eq(want, got, names):
    assert len(want) == len(got)
    for w, g, name in zip(want, got, names):
        np.testing.assert_array_equal(
            np.asarray(w).astype(np.int64),
            (g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g))
            .astype(np.int64), err_msg=name)


def _dna(match=2, mismatch=2):
    mat = np.zeros((5, 5), np.int8)
    for i in range(4):
        for j in range(4):
            mat[i, j] = match if i == j else -mismatch
    return mat


def _batch(rng, B, L, ref, mat, lo=None):
    """Reads of lengths L/3 .. L-20, every other one a 10 %-mutated copy of
    a piece of ref, with their profile and geometry (numpy)."""
    n = mat.shape[0]
    R = len(ref)
    read_len = rng.integers(lo or max(L // 3, 2), L - 20, B).astype(np.int32)
    reads = []
    for b, ln in enumerate(read_len):
        if b % 2 and R > ln:
            off = int(rng.integers(0, R - ln))
            r = ref[off:off + ln].copy()
            m = rng.random(ln) < 0.1
            r[m] = rng.integers(0, n - 1, int(m.sum()))
        else:
            r = rng.integers(0, n - 1, ln)
        reads.append(r.astype(np.int32))
    prof = common.build_profile(common.pad_reads(reads, L, n), read_len,
                                common.extend_matrix(mat))
    geo = common.batch_geometry(read_len, L, word=False)
    return prof, read_len, geo


@pytest.mark.parametrize("layout,mat,quirk,gated,pairs", [
    ("random", _dna(), False, False, False),
    ("random", _dna(), False, True, True),
    ("shard", _dna(), False, False, False),
    ("shard", _dna(), False, True, False),
    ("shard", _dna(), False, True, True),
    ("shard", BLOSUM50, True, True, False),
])
def test_forward_shared_ref_gated_matches_jax(layout, mat, quirk, gated,
                                              pairs):
    """Only owned columns take the best hit, end_ref is the column's global
    index, every column emits its maximum; with the bounded-radius gate
    (int32 warps, or int16 pairs) the outputs are the same and the depth
    histogram is that of the same launch without idx/own."""
    rng = np.random.default_rng(17 + len(layout) + 2 * quirk + gated)
    n = mat.shape[0]
    B, L, R = 9, 128, 400
    ref = rng.integers(0, n - 1, R).astype(np.int32)
    prof, read_len, geo = _batch(rng, B, L, ref, mat)
    if layout == "random":
        idxs = rng.permutation(5 * R)[:R].astype(np.int32)
        owned = rng.random(R) < 0.6
    else:  # shard 1 of a seq split: halo warm-up columns, then owned ones
        halo, start = 144, 1000
        idxs = np.arange(R, dtype=np.int32) + (start - halo)
        owned = idxs >= start
    arrs = (prof, ref, idxs, owned, read_len, geo.col_mask, geo.seg_id,
            geo.seg_start)
    want = jax_scan.forward_shared_ref_gated(
        *(jnp.asarray(a) for a in arrs), 3, 1, quirk)
    ms = int(np.abs(mat).max())
    thr = gate.card_thresholds(L // 32, L, 3, 1, ms) if gated else None
    targs = tuple(_t(a) for a in arrs)
    got = torch_scan.forward_shared_ref_gated(
        *targs, 3, 1, quirk, gate=thr, pairs=pairs, steps=gated)
    if gated:
        got, hist = got
        _, base_hist = torch_scan.forward_shared_ref(
            targs[0], targs[1], *targs[4:], 3, 1, quirk, gate=thr,
            pairs=pairs, steps=True)
        assert hist.tolist() == base_hist.tolist()
        assert sum(hist.tolist()[:5]) > 0
    _eq(want, got, FWD)
    # the CUDA wrapper routes a CPU tensor to the same plain version
    cuda_sw.reset_launches()
    _eq(want, cuda_sw.forward_shared_gated(
        *targs, 3, 1, quirk, max_sub=ms if pairs else None, gate=thr), FWD)
    assert not any(cuda_sw.launch_counts().values())


def test_forward_shared_gated_matches_pallas_interpret():
    """One small shard layout against the JAX package's Pallas kernel with
    idx/own (interpret mode), int16 tier as the kernel chooses it."""
    rng = np.random.default_rng(29)
    mat = _dna()
    B, L, R = 6, 64, 300
    ref = rng.integers(0, 4, R).astype(np.int32)
    prof, read_len, geo = _batch(rng, B, L, ref, mat, lo=20)
    idxs = np.arange(R, dtype=np.int32) + 412 - 64
    owned = idxs >= 412
    arrs = (prof, ref, idxs, owned, read_len, geo.col_mask, geo.seg_id,
            geo.seg_start)
    want = pallas_sw.forward_shared_ref_gated(
        *(jnp.asarray(a) for a in arrs), 3, 1, False, max_sub=2)
    _eq(want, cuda_sw.forward_shared_gated(
        *(_t(a) for a in arrs), 3, 1, False, max_sub=2), FWD)


@pytest.fixture(scope="module")
def problem():
    """tests/test_parallel.py's problem."""
    rng = np.random.default_rng(3)
    B, L, R = 16, 128, 2048
    mat = _dna()
    ref = rng.integers(0, 4, R).astype(np.int32)
    read_len = rng.integers(40, 110, B).astype(np.int32)
    reads = []
    for ln in read_len:
        off = int(rng.integers(0, R - ln))
        r = ref[off:off + ln].copy()
        m = rng.random(ln) < 0.15
        r[m] = rng.integers(0, 4, int(m.sum()))
        reads.append(r.astype(np.int32))
    prof = common.build_profile(common.pad_reads(reads, L, 5), read_len,
                                common.extend_matrix(mat))
    geo = common.batch_geometry(read_len, L, word=False)
    mask_len = np.maximum(read_len // 2, 15).astype(np.int32)
    mask_len[::5] = 9  # no suboptimal score for these (mask_len < 15)
    args = (prof, ref, read_len, geo.col_mask, geo.seg_id, geo.seg_start)
    score, end_ref, end_read, maxcol = jax_scan.forward_shared_ref(
        *(jnp.asarray(a) for a in args), 3, 1, False)
    s2, re2 = jax_scan.second_best_batch(
        maxcol, end_ref, jnp.asarray(mask_len), R, jnp.zeros(B, bool))
    s2 = np.where(mask_len < 15, 0, np.asarray(s2))
    re2 = np.where(mask_len < 15, -1, np.asarray(re2))
    want = (score, end_ref, end_read, s2, re2)
    halo = jax_pipeline._window_len(int(read_len.max()), R, mat, 3, 1)
    return dict(mat=mat, ref=ref, read_len=read_len, prof=prof, geo=geo,
                mask_len=mask_len, want=want, halo=halo, R=R)


@pytest.mark.parametrize("data,seq,gated", [
    (1, 8, False), (8, 1, False), (2, 4, False), (2, 4, True),
])
def test_sharded_forward_matches_single(problem, data, seq, gated):
    p = problem
    m = mesh_lib.make_mesh(data=data, seq=seq, devices=CPU8)
    assert m.shape == {"data": data, "seq": seq}
    ref_ext = np.concatenate([np.full(p["halo"], 5, np.int32), p["ref"]])
    g = p["geo"]
    thr = gate.card_thresholds(4, 128, 3, 1, 2) if gated else None
    got = dist.sharded_forward(
        m, _t(p["prof"]), _t(ref_ext), _t(p["read_len"]), _t(g.col_mask),
        _t(g.seg_id), _t(g.seg_start), 3, 1, _t(p["mask_len"]), p["R"],
        p["halo"], quirk=False, max_sub=2, gate=thr)
    _eq(p["want"], got, OUT)


def test_merge_best_ties():
    """score desc, then the lowest index; a shard without an owned hit
    (score 0, end_ref -1) wins only where no shard scored, and then gives
    -1 as the JAX merge does; equal (score, idx) pairs pick the first
    row."""
    score = np.array([[5, 0, 7, 3, 0, 2],
                      [5, 0, 7, 4, 0, 2],
                      [4, 0, 7, 4, 1, 2]], np.int32)
    idx = np.array([[90, -1, 30, 10, 7, 12],
                    [40, -1, 10, 50, -1, 12],
                    [20, -1, 20, 60, 3, 11]], np.int32)
    want = jax_dist._merge_best(jnp.asarray(score), jnp.asarray(idx))
    got = dist._merge_best(_t(score), _t(idx))
    _eq(want, got, ("best", "idx", "row"))
    assert got[1].tolist()[1] == -1 and got[2].tolist() == [1, 0, 1, 1, 2, 2]
