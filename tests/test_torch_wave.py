"""The anti-diagonal wavefront design (ssw_tpu_torch/ops/wave.py, the plain
model of csrc/sw_wave_i32.cu, csrc/sw_wave_i16.cu, csrc/sw_wave_packed.cu
and csrc/sw_wave_perread.cu) against the JAX package.

The model computes what the wavefront kernels compute in their order
(anti-diagonal steps, row-sequential F and G chains, values handed lane to
lane, per-lane best-hit trackers merged after the last step); here it is
held field by field against ssw_tpu's scan path and its Pallas kernel in
interpret mode (the int16 tier where the kernel chooses it, the int32
kernel, the packed mode, the per-read kernel), in every mode the kernels
run: base, blockmax, dual, owned, the int32 quirk on protein matrices (L
64 to 1088), packed slots of mixed lengths with the quirk off and on (16
and 8 lane blocks), ties, a best hit only in pad rows, valid_len < R, the
shape of the K = 14 int16 fault, and the per-read kernel's terminate rule
after the skew (hand-built windows whose later columns beat the terminate
column, ties) with and without emit_maxcol.  Integer DP: tolerance 0.  Inputs are made with numpy
from a seed.  The int16 runs also check that no intermediate leaves int16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssw_tpu.ops import common as jax_common
from ssw_tpu.ops import pallas_sw
from ssw_tpu.ops import scan_sw as jax_scan
from ssw_tpu_torch.core.encoding import BLOSUM50, parse_matrix_file
from ssw_tpu_torch.ops import common, cuda_sw, wave
from ssw_tpu_torch.tools import _common as tools_common
from ssw_tpu_torch.tools import i16_fault

BLOSUM62 = parse_matrix_file("tests/data/blosum62.txt")[0]

FWD = ("score", "end_ref", "end_read", "maxima")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy().astype(np.int64)
    return np.asarray(x).astype(np.int64)


def _eq(want, got):
    assert len(want) == len(got)
    for w, g, name in zip(want, got, FWD):
        np.testing.assert_array_equal(_np(w), _np(g), err_msg=name)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _dna(match=2, mismatch=2):
    mat = np.zeros((5, 5), np.int8)
    mat[:4, :4] = -mismatch
    np.fill_diagonal(mat[:4, :4], match)
    return mat


def _batch(seed, B, L, R, mat=None, word=False):
    """B reads (every other one cut from the target with 10 % substitutions)
    in an L-row bucket, and a target of R codes."""
    mat = _dna() if mat is None else mat
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, R).astype(np.int32)
    read_len = rng.integers(L // 3, L - 7, B).astype(np.int32)
    reads = []
    for b, ln in enumerate(read_len):
        if b % 2:
            s = int(rng.integers(0, R - ln))
            r = ref[s:s + ln].copy()
            m = rng.random(ln) < 0.1
            r[m] = rng.integers(0, 4, int(m.sum()))
        else:
            r = rng.integers(0, 4, ln).astype(np.int32)
        reads.append(r)
    prof = common.build_profile(common.pad_reads(reads, L, 4), read_len,
                                common.extend_matrix(mat))
    geo = common.batch_geometry(read_len, L, word=word)
    return (prof, ref, read_len, geo.col_mask, geo.seg_id, geo.seg_start)


def _jax(arrs):
    return tuple(jnp.asarray(a) for a in arrs)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The model runs small tensors step by step, on which torch's thread
    pool gains nothing and only competes with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocks(mc, vl, nblk):
    """(B, R) column maxima -> (B, nblk) maxima of 256-column blocks over
    the columns < vl."""
    mc = np.asarray(mc, np.int64).copy()
    mc[:, vl:] = 0
    out = np.zeros((mc.shape[0], nblk * 256), np.int64)
    out[:, :mc.shape[1]] = mc
    return out.reshape(mc.shape[0], nblk, 256).max(axis=2)


def _scan_want(arrs, gapO, gapE, quirk=False):
    """ssw_tpu's scan path (its column maxima are (B, R) as the port's)."""
    s, er, ed, mc = jax_scan.forward_shared_ref(*_jax(arrs), gapO, gapE,
                                                quirk)
    return s, er, ed, np.asarray(mc).astype(np.int64)


@pytest.mark.parametrize("mode", ["base", "blockmax", "dual"])
@pytest.mark.parametrize("L,R,gapO,gapE,mat", [
    (64, 300, 3, 1, _dna()),
    (128, 260, 5, 2, _dna(1, 3)),
], ids=["L64", "L128_m1x3"])
def test_wave_i16_matches_jax(mode, L, R, gapO, gapE, mat):
    """The int16 wavefront against the scan path (block maxima over
    valid_len < R from its column maxima, the target past valid_len the
    virtual letter as the pipeline pads it, the dual word channel from a
    second pass over the word tier's rows) and, in base mode at L 64, the
    Pallas kernel's int16 tier in interpret mode."""
    arrs = _batch(L + R, 7, L, R, mat)
    ms = int(np.abs(mat).max())
    assert pallas_sw.i16_exact(L, gapO, gapE, ms, False)
    vl, nblk = R - 41, (R + 255) // 256
    if mode != "base":
        arrs[1][vl:] = 4
    word = common.batch_geometry(arrs[2], L, word=True).col_mask
    kw = {} if mode == "base" else dict(blockmax=True, valid_len=vl)
    if mode == "dual":
        kw["wmask"] = _t(word)
    got = wave.forward_shared(*(_t(a) for a in arrs), gapO, gapE, i16=True,
                              **kw)
    want = _scan_want(arrs, gapO, gapE)
    if mode != "base":
        bm = _blocks(want[3], vl, nblk)
        if mode == "dual":
            ww = _scan_want(arrs[:3] + (word,) + arrs[4:], gapO, gapE)
            bm = np.stack([bm, _blocks(ww[3], vl, nblk)], axis=1)
        want = want[:3] + (bm,)
    _eq(want, got)
    if mode == "base" and L == 64:
        _eq(pallas_sw.forward_shared_ref(*_jax(arrs), gapO, gapE, False,
                                         max_sub=ms), got)


@pytest.mark.parametrize("layout", ["random", "shard"])
def test_wave_owned_matches_jax(layout):
    """The owned-column mode: only owned columns take a best hit, end_ref
    is the column's global index; against the scan path and, for the
    shard layout, the Pallas kernel with idx/own."""
    rng = np.random.default_rng(11 + len(layout))
    R = 280
    arrs = _batch(5 + len(layout), 6, 64, R)
    if layout == "random":
        idx = rng.permutation(5 * R)[:R].astype(np.int32)
        own = rng.random(R) < 0.6
    else:  # shard 1 of a seq split: halo warm-up columns, then owned ones
        idx = np.arange(R, dtype=np.int32) + 900 - 96
        own = idx >= 900
    full = (arrs[0], arrs[1], idx, own) + arrs[2:]
    got = wave.forward_shared_gated(*(_t(a) for a in full), 3, 1, i16=True)
    s, er, ed, mc = jax_scan.forward_shared_ref_gated(*_jax(full), 3, 1,
                                                      False)
    _eq((s, er, ed, mc), got)
    if layout == "shard":
        _eq(pallas_sw.forward_shared_ref_gated(*_jax(full), 3, 1, False,
                                               max_sub=2), got)


def test_wave_ties_and_pad_row_hit():
    """Ties in score and in column: the target repeats one segment, so a
    read cut from it scores its maximum at three columns (the first wins)
    and a read that is the segment twice over at two rows of one column
    (the lowest wins).  A best hit only in pad rows: the column where a
    read ends is not owned, the next one is, and there only the pad rows
    (rl <= j < col_mask) carry the maximum along the diagonal, so end_read
    is rl - 1."""
    rng = np.random.default_rng(4)
    seg = rng.integers(0, 4, 40).astype(np.int32)
    gap = rng.integers(0, 4, 30).astype(np.int32)
    ref = np.concatenate([gap, seg, gap[:7], seg, seg, gap]).astype(np.int32)
    R = len(ref)
    reads = [seg[:37].copy(), np.concatenate([seg[:20], seg[:20]]),
             seg[5:30].copy(), rng.integers(0, 4, 50).astype(np.int32)]
    read_len = np.array([len(r) for r in reads], np.int32)
    L = 64
    prof = common.build_profile(common.pad_reads(reads, L, 4), read_len,
                                common.extend_matrix(_dna()))
    geo = common.batch_geometry(read_len, L, word=False)
    arrs = (prof, ref, read_len, geo.col_mask, geo.seg_id, geo.seg_start)
    got = wave.forward_shared(*(_t(a) for a in arrs), 3, 1, i16=True)
    _eq(_scan_want(arrs, 3, 1), got)
    assert int(got[1][0]) == 30 + 36  # the first of three equal columns
    # read 0 ends at column 66 in row 36; own columns 67 on, not 66
    idx = np.arange(R, dtype=np.int32)
    own = idx >= 67
    full = (prof, ref, idx, own) + arrs[2:]
    got = wave.forward_shared_gated(*(_t(a) for a in full), 3, 1, i16=True)
    s, er, ed, mc = jax_scan.forward_shared_ref_gated(*_jax(full), 3, 1,
                                                      False)
    _eq((s, er, ed, mc), got)
    assert geo.col_mask[0, 37] and int(got[2][0]) == 36


def _packed(seed, lens, word_rows, W, R, mat):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, R).astype(np.int32)
    reads = []
    for b, ln in enumerate(lens):
        if b % 2 and R > ln:
            s = int(rng.integers(0, R - ln))
            reads.append(ref[s:s + ln].copy())
        else:
            reads.append(rng.integers(0, 4, ln).astype(np.int32))
    read_len = np.asarray(lens, np.int32)
    slot_len = np.where(word_rows, (read_len + 7) // 8 * 8,
                        (read_len + 15) // 16 * 16).astype(np.int32)
    plan = jax_common.pack_plan(slot_len, W)
    L = common.bucket_size(max(common.pad_total(int(read_len.max()), False),
                               1), 64)
    rp = common.pad_reads(reads, L, 4)
    so, sl, rl_s = common.pack_tables(plan, read_len)
    prof = common.build_profile(common.pack_codes(plan, rp, 4), None,
                                common.extend_matrix(mat))
    flat_idx = (plan.row * plan.S + plan.slot).astype(np.int32)
    tier = [common.batch_geometry(read_len, L, word=w) for w in (False, True)]
    unpacked = (common.build_profile(rp, read_len, common.extend_matrix(mat)),
                read_len,
                np.where(word_rows[:, None], tier[1].col_mask,
                         tier[0].col_mask),
                np.where(word_rows[:, None], tier[1].seg_id, tier[0].seg_id),
                np.where(word_rows[:, None], tier[1].seg_start,
                         tier[0].seg_start))
    return plan, (prof, ref, so, sl, rl_s, flat_idx), unpacked


@pytest.mark.parametrize("case", ["byte", "dual", "quirk16", "quirk8",
                                  "mixed_m1x3"])
def test_wave_packed_matches_jax(case):
    """The packed wavefront (one warp per slot, slots of mixed lengths,
    zero-length and 1-base reads, valid_len < R) against the scan path on
    each read unpacked (its tier's geometry, the target cut at valid_len,
    the quirk's lane blocks those of the read's tier) and, in dual mode,
    the Pallas kernel's packed mode in interpret mode: the G chain on 16
    (byte) and 8 (word) lane blocks, the dual channels, mixed tiers."""
    quirk = case.startswith("quirk")
    mat = (_dna(2, 4) if quirk else _dna(1, 3) if case == "mixed_m1x3"
           else _dna())
    gapO, gapE = (5, 2) if case == "mixed_m1x3" else (3, 1)
    lens = np.array([150, 0, 37, 1, 96, 200, 64, 121, 17, 180])
    word_rows = (np.arange(10) % 2 == 0 if case == "mixed_m1x3"
                 else np.full(10, case == "quirk8"))
    R, vl = 540, 500
    plan, arrs, unpacked = _packed(len(case), lens, word_rows, 512, R, mat)
    assert plan.S > 1
    kw = dict(max_sub=int(np.abs(mat).max()), valid_len=vl, quirk=quirk,
              word=case == "quirk8", dual=case == "dual")
    got = wave.forward_shared_packed(*(_t(a) for a in arrs), gapO, gapE, **kw)
    nblk = (R + 255) // 256
    prof, rl, cm, seg, ss = unpacked
    want = _scan_want((prof, arrs[1][:vl], rl, cm, seg, ss), gapO, gapE,
                      quirk)
    bm = _blocks(want[3], vl, nblk)
    if case == "dual":
        word = common.batch_geometry(rl, prof.shape[2], word=True).col_mask
        ww = _scan_want((prof, arrs[1][:vl], rl, word, seg, ss), gapO, gapE)
        bm = np.stack([bm, _blocks(ww[3], vl, nblk)], axis=1)
    _eq(want[:3] + (bm,), got)
    if case == "dual":
        _eq(pallas_sw.forward_shared_ref_packed(
            jnp.asarray(arrs[0]), jnp.asarray(arrs[1]), *arrs[2:], gapO,
            gapE, **kw), got)


def test_wave_i16_k14_fault_shape():
    """L = 448 (K = 14, the shape of the int16 fault of ROADMAP §C) as a
    seeded random case: the int16 wavefront against the scan path."""
    args = i16_fault.failing_input(torch.device("cpu"), seed=3106)
    arrs = tuple(a.numpy() for a in args)
    got = wave.forward_shared(*args, 3, 1, i16=True)
    _eq(_scan_want(arrs, 3, 1), got)


def test_wave_i16_range_check_fires():
    """The int16 check is live: a score past int16 (a 300-base exact hit at
    +127 a base) makes an intermediate leave int16, and the model says
    so."""
    rng = np.random.default_rng(2)
    ref = rng.integers(0, 4, 400).astype(np.int32)
    read_len = np.array([300], np.int32)
    mat = _dna(127, 1)
    prof = common.build_profile(common.pad_reads([ref[50:350]], 320, 4),
                                read_len, common.extend_matrix(mat))
    geo = common.batch_geometry(read_len, 320, word=False)
    arrs = (prof, ref, read_len, geo.col_mask, geo.seg_id, geo.seg_start)
    assert not pallas_sw.i16_exact(320, 3, 1, 127, False)
    with pytest.raises(OverflowError):
        wave.forward_shared(*(_t(a) for a in arrs), 3, 1, i16=True)
    assert int(wave.forward_shared(*(_t(a) for a in arrs), 3, 1)[0][0]) \
        == 300 * 127


def _protein(seed, B, L, R, mat, word=False):
    """tools/_common.shared_case's reads (every odd one cut from the
    target, 5 % of its codes redrawn) as numpy arrays."""
    args, _, _ = tools_common.shared_case(torch.device("cpu"), B=B, L=L,
                                          R=R, mat=mat, word=word, seed=seed)
    return tuple(a.numpy() for a in args)


@pytest.mark.parametrize("mode,quirk", [
    ("base", False), ("base", True), ("blockmax", False),
    ("blockmax", True), ("dual", False), ("owned", False), ("owned", True),
])
def test_wave_i32_matches_jax(mode, quirk):
    """The int32 wavefront (sw_wave_i32) against the scan path with the
    quirk off (DNA) and on (BLOSUM50, byte-tier lane blocks), and, in base
    and owned mode at L 64, the Pallas kernel's int32 path in interpret
    mode.  The owned mode takes the shard layout (halo columns first)."""
    L, R = 64, 290
    if quirk:
        mat, gapO, gapE = BLOSUM50, 3, 1
        arrs = _protein(17 + len(mode), 6, L, R, mat)
    else:
        mat, gapO, gapE = _dna(), 3, 1
        arrs = _batch(L + R + len(mode), 7, L, R, mat)
    vl, nblk = R - 41, (R + 255) // 256
    t = tuple(_t(a) for a in arrs)
    if mode == "owned":
        idx = np.arange(R, dtype=np.int32) + 700 - 96
        own = idx >= 700
        full = (arrs[0], arrs[1], idx, own) + arrs[2:]
        got = wave.forward_shared_gated(*(_t(a) for a in full), gapO, gapE,
                                        quirk)
        _eq(jax_scan.forward_shared_ref_gated(*_jax(full), gapO, gapE,
                                              quirk), got)
        _eq(pallas_sw.forward_shared_ref_gated(*_jax(full), gapO, gapE,
                                               quirk), got)
        return
    word = common.batch_geometry(arrs[2], L, word=True).col_mask
    kw = {} if mode == "base" else dict(blockmax=True, valid_len=vl)
    if mode == "dual":
        kw["wmask"] = _t(word)
    got = wave.forward_shared(*t, gapO, gapE, quirk, **kw)
    want = _scan_want(arrs, gapO, gapE, quirk)
    if mode != "base":
        bm = _blocks(want[3], vl, nblk)
        if mode == "dual":
            ww = _scan_want(arrs[:3] + (word,) + arrs[4:], gapO, gapE)
            bm = np.stack([bm, _blocks(ww[3], vl, nblk)], axis=1)
        want = want[:3] + (bm,)
    else:
        _eq(pallas_sw.forward_shared_ref(*_jax(arrs), gapO, gapE, quirk),
            got)
    _eq(want, got)


@pytest.mark.parametrize("L,mat,word", [
    (448, BLOSUM62, False), (1088, BLOSUM50, True),
], ids=["K14_blosum62", "K34_blosum50_word"])
def test_wave_i32_quirk_long_rows(L, mat, word):
    """The quirk's restarted G chain at K = 14 and past 1024 rows (the
    global-row variant's width), read_len below L, against the scan path:
    the lane blocks are 16 (byte) or 8 (word) rows of seg_len each."""
    arrs = _protein(L, 3, L, 96, mat, word)
    assert int(arrs[2].max()) < L
    got = wave.forward_shared(*(_t(a) for a in arrs), 10, 1, True)
    _eq(_scan_want(arrs, 10, 1, True), got)


def test_wave_quirk_bound_and_contract():
    """Where the restarted G chain equals the biased scan: contiguous lane
    blocks (batch_geometry's) and L * max_sub <= SEG_BUMP.  The model
    raises outside them and the wrapper's rule sends such a launch to the
    column-scan body (quirk_wave_exact)."""
    assert cuda_sw.quirk_wave_exact(1088, None)
    assert cuda_sw.quirk_wave_exact(16512, None)
    assert not cuda_sw.quirk_wave_exact(16544, None)
    assert cuda_sw.quirk_wave_exact(16544, 15)
    arrs = _protein(5, 2, 64, 80, BLOSUM50)
    t = [_t(a) for a in arrs]
    sid = t[4].clone()
    sid[0, 40:] = 0                     # a block id that decreases
    with pytest.raises(ValueError, match="contiguous"):
        wave.forward_shared(*t[:4], sid, t[5], 3, 1, True)
    ss = t[5].clone()
    ss[0, 1] = True                     # a block start inside a block
    with pytest.raises(ValueError, match="seg_start"):
        wave.forward_shared(*t[:5], ss, 3, 1, True)
    big = t[0].clone()
    big[0, 0, 0] = 127                  # 64 * 127 is inside the bound
    wave.forward_shared(big, *t[1:], 3, 1, True)


def _perread(seed, B, L, W, mat, word=False):
    """Per-read windows with the read embedded (chip_smoke.py's
    make_perread), numpy."""
    rng = np.random.default_rng(seed)
    n = mat.shape[0]
    read_len = rng.integers(max(L // 3, 2), L - 16, B).astype(np.int32)
    reads = [rng.integers(0, n - 1, ln).astype(np.int32) for ln in read_len]
    refw = np.full((B, W), n, np.int32)
    for b in range(B):
        w = int(rng.integers(W // 2, W))
        refw[b, :w] = rng.integers(0, n - 1, w)
        s = int(rng.integers(0, max(1, w - read_len[b])))
        take = min(int(read_len[b]), w - s)
        refw[b, s:s + take] = reads[b][:take]
    prof = common.build_profile(common.pad_reads(reads, L, n), read_len,
                                common.extend_matrix(mat))
    geo = common.batch_geometry(read_len, L, word=word)
    return (prof, refw, read_len, geo.col_mask, geo.seg_id, geo.seg_start)


@pytest.mark.parametrize("quirk,term,emit", [
    (False, "none", False), (False, "score", False), (False, "mid", True),
    (True, "score", False), (True, "mid", False), (True, "none", True),
])
def test_wave_perread_matches_jax(quirk, term, emit):
    """The per-read wavefront against the scan path's forward_perread_ref
    and the Pallas per-read kernel in interpret mode (L 64): terminate at
    each read's score (the reverse pass), at a column maximum a third into
    the window (later columns beat it), or never; emit_maxcol."""
    mat = BLOSUM50 if quirk else _dna()
    arrs = _perread(31 + len(term) + emit, 6, 64, 150, mat)
    t = tuple(_t(a) for a in arrs)
    base = jax_scan.forward_perread_ref(*_jax(arrs), 3, 1, quirk,
                                        emit_maxcol=True)
    tv = None
    if term == "score":
        tv = np.asarray(base[0]).astype(np.int32)
        tv[::3] = -1
    elif term == "mid":
        tv = np.asarray(base[3])[:, 50].astype(np.int32)
    want = jax_scan.forward_perread_ref(
        *_jax(arrs), 3, 1, quirk, emit_maxcol=emit,
        terminate=None if tv is None else jnp.asarray(tv))
    got = wave.forward_perread(*t, 3, 1, quirk, emit_maxcol=emit,
                               terminate=None if tv is None else _t(tv))
    _eq(want, got)
    _eq(pallas_sw.forward_perread_ref(
        *_jax(arrs), 3, 1, quirk, emit_maxcol=emit,
        terminate=None if tv is None else jnp.asarray(tv)), got)


@pytest.mark.parametrize("quirk,emit", [(False, False), (False, True),
                                        (True, False), (True, True)])
def test_wave_perread_terminate_by_hand(quirk, emit):
    """terminate after the skew, on the hand-built windows of
    tools/_common.terminate_case: every distinct column maximum as
    terminate[b], so the column after the terminate column mostly holds a
    higher maximum (the trackers of lanes 0..30 take it before lane 31
    sees the terminate column), values tie across columns and two rows tie
    in one column.  Exact against the scan path; the re-run fires for most
    reads, and a read whose later columns never beat it needs none."""
    mat = BLOSUM62 if quirk else _dna()
    args, term = tools_common.terminate_case(
        torch.device("cpu"), mat=mat, word=quirk, seed=3 + emit,
        quirk=quirk)
    arrs = tuple(a.numpy() for a in args)
    reruns = []
    got = wave.forward_perread(*args, 3, 1, quirk, terminate=term,
                               emit_maxcol=emit, reruns=reruns)
    want = jax_scan.forward_perread_ref(*_jax(arrs), 3, 1, quirk,
                                        terminate=jnp.asarray(term.numpy()),
                                        emit_maxcol=emit)
    _eq(want, got)
    B = term.numel()
    assert 0 < len(reruns) < B
    assert 0 not in reruns and B - 1 not in reruns  # never / above all
