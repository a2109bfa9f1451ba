"""The anti-diagonal wavefront design (ssw_tpu_torch/ops/wave.py, the plain
model of csrc/sw_wave_i16.cu and csrc/sw_wave_packed.cu) against the JAX
package.

The model computes what the wavefront kernels compute in their order
(anti-diagonal steps, row-sequential F and G chains, values handed lane to
lane, per-lane best-hit trackers merged after the last step); here it is
held field by field against ssw_tpu's scan path and its Pallas kernel in
interpret mode (the int16 tier where the kernel chooses it, the packed
mode), in every mode the kernels run: base, blockmax, dual, owned, packed
slots of mixed lengths with the quirk off and on (16 and 8 lane blocks),
ties, a best hit only in pad rows, valid_len < R, and the shape of the
K = 14 int16 fault.  Integer DP: tolerance 0.  Inputs are made with numpy
from a seed.  The int16 runs also check that no intermediate leaves int16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssw_tpu.ops import common as jax_common
from ssw_tpu.ops import pallas_sw
from ssw_tpu.ops import scan_sw as jax_scan
from ssw_tpu_torch.ops import common, wave
from ssw_tpu_torch.tools import i16_fault

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
