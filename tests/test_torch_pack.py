"""The port's lane packing and dual tier against the JAX package's.

Packing puts several reads in one DP row, each in a slot of its tier-padded
length; the dual tier emits the byte-tier and the word-tier block maxima
from one pass.  Here, on the CPU, the plain versions stand in for the CUDA
kernels: the pack helpers, the packed forward and the dual mode are held
against the JAX package's functions (its Pallas kernel in interpret mode,
as tests/test_pack.py runs it), and the streaming pipeline with packing and
the dual tier against ssw_tpu.pipeline on its scan backend with
SSW_TPU_STREAM_SUBOPT=1, field by field with stderr (those tests, the
CLI's and the dual mode's against the Pallas kernel are in
tests/test_torch_pack_pipeline.py).  Integer DP: every
output must be exactly equal (tolerance 0).  Inputs are made with numpy from
a seed, at tests/test_pack.py's sizes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssw_tpu import pipeline as jax_pipeline
from ssw_tpu.ops import common as jax_common
from ssw_tpu.ops import pallas_sw
from ssw_tpu_torch import pipeline
from ssw_tpu_torch.ops import common, cuda_sw, pack, scan_sw


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy().astype(np.int64)
    return np.asarray(x).astype(np.int64)


def _eq(want, got, names):
    assert len(want) == len(got)
    for w, g, name in zip(want, got, names):
        np.testing.assert_array_equal(_np(w), _np(g), err_msg=name)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _dna_mat(match=2, mismatch=2):
    mat = np.zeros((5, 5), np.int8)
    for i in range(4):
        for j in range(4):
            mat[i, j] = match if i == j else -mismatch
    return mat


def _quirk_mat():
    """min -4 < -2*gapE at gapE = 1: the lane-block quirk is observable."""
    return _dna_mat(2, 4)


def _mk_reads(seed, R, B, lmax=220):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, R).astype(np.int32)
    read_len = rng.integers(20, lmax, B).astype(np.int32)
    reads = []
    for i, ln in enumerate(read_len):
        if i % 3 == 0:  # embedded high-identity reads: real hits
            off = int(rng.integers(0, R - ln))
            reads.append(ref[off:off + ln].copy())
        else:
            reads.append(rng.integers(0, 4, ln).astype(np.int32))
    return ref, reads, read_len


FWD = ("score", "end_ref", "end_read", "blockmax")

# --------------------------------------------------------------- helpers


def test_pack_plan_codes_tables_match_jax():
    rng = np.random.default_rng(3)
    slot_len = (rng.integers(0, 240, 100) + 15) // 16 * 16
    slot_len[::17] = 0  # zero-length reads occupy no lanes
    read_len = np.maximum(slot_len - rng.integers(0, 16, 100), 0)
    reads = [rng.integers(0, 4, int(n)).astype(np.int32) for n in read_len]
    rp = common.pad_reads(reads, 256, 4)
    for W, cap in ((512, 8), (1024, 64)):
        want = jax_common.pack_plan(slot_len, W, max_slots=cap)
        got = common.pack_plan(slot_len, W, max_slots=cap)
        for f in ("L", "n_rows", "S"):
            assert getattr(want, f) == getattr(got, f)
        for f in ("row", "slot", "off", "slot_len"):
            np.testing.assert_array_equal(getattr(want, f), getattr(got, f))
        np.testing.assert_array_equal(jax_common.pack_codes(want, rp, 4),
                                      common.pack_codes(got, rp, 4))
        for w, g in zip(jax_common.pack_tables(want, read_len),
                        common.pack_tables(got, read_len)):
            np.testing.assert_array_equal(w, g)


@pytest.mark.parametrize("args", [
    (np.full(2048, 100), np.zeros(2048, bool), 2048, 128),   # config 4
    (np.full(1024, 200), np.zeros(1024, bool), 1024, 256),   # wide rows
    (np.full(256, 100), np.zeros(256, bool), 256, 128),      # too few
    (np.arange(20, 260), np.arange(240) % 3 == 0, 240, 256),  # mixed tiers
    (np.full(64, 600), np.zeros(64, bool), 64, 640),          # 4096 only
], ids=["config4", "200bp", "small", "mixed", "long"])
def test_plan_pack_matches_jax(args):
    rl, word, Bp, L = args
    rl = rl.astype(np.int32)
    want = jax_pipeline._plan_pack(rl, word, Bp, L)
    got = pipeline._plan_pack(rl, word, Bp, L)
    assert (want is None) == (got is None)
    if want is not None:
        assert (want.L, want.S, want.n_rows) == (got.L, got.S, got.n_rows)
        np.testing.assert_array_equal(want.row, got.row)
        np.testing.assert_array_equal(want.off, got.off)


def test_plan_pack_width_sweep(monkeypatch):
    """tests/test_pack.py's width-sweep cases: config 4 packs at 1024 lanes
    with 9 slots, 200 bp reads at 4096, 256 reads not at all, and PACK_L
    pins the width."""
    p4 = pipeline._plan_pack(np.full(2048, 100, np.int32),
                             np.zeros(2048, bool), 2048, 128)
    assert p4 is not None and (p4.L, p4.S) == (1024, 9)
    p200 = pipeline._plan_pack(np.full(1024, 200, np.int32),
                               np.zeros(1024, bool), 1024, 256)
    assert p200 is not None and p200.L == 4096
    assert pipeline._plan_pack(np.full(256, 100, np.int32),
                               np.zeros(256, bool), 256, 128) is None
    monkeypatch.setattr(pipeline, "PACK_L", 2048)
    pinned = pipeline._plan_pack(np.full(2048, 100, np.int32),
                                 np.zeros(2048, bool), 2048, 128)
    assert pinned is not None and pinned.L == 2048


def test_pack_rule_packs_every_streaming_leaf(monkeypatch):
    """The card's rule packs every leaf at the narrowest width that holds
    two of its longest slots, however few its reads; slots over half the
    widest row stay unpacked."""
    one = pipeline._pack_rule(np.array([100], np.int32), np.zeros(1, bool),
                              64, 128)
    assert one is not None and (one.L, one.S) == (1024, 1)
    p4 = pipeline._pack_rule(np.full(2048, 100, np.int32),
                             np.zeros(2048, bool), 2048, 128)
    want = common.pack_plan(np.full(2048, 112, np.int32), 1024)
    assert (p4.L, p4.S, p4.n_rows) == (want.L, want.S, want.n_rows) == (
        1024, 9, 232)
    long = pipeline._pack_rule(np.array([600, 30], np.int32),
                               np.zeros(2, bool), 64, 640)
    assert long.L == 2048
    assert pipeline._pack_rule(np.array([2100], np.int32), np.zeros(1, bool),
                               64, 2176) is None
    monkeypatch.setattr(pipeline, "PACK_L", 512)
    assert pipeline._pack_rule(np.full(8, 200, np.int32), np.zeros(8, bool),
                               64, 256).L == 512


def _tables(seed, W=512, n=40):
    rng = np.random.default_rng(seed)
    slot_len = (rng.integers(0, 200, n) + 7) // 8 * 8
    slot_len[3] = 0
    read_len = np.maximum(slot_len - rng.integers(0, 8, n), 0)
    plan = common.pack_plan(slot_len, W)
    return plan, common.pack_tables(plan, read_len)


@pytest.mark.parametrize("nb", [16, 8])
def test_pack_geometry_matches_jax(nb):
    plan, (so, sl, rl) = _tables(5)
    want = pallas_sw._pack_geometry(jnp.asarray(so), jnp.asarray(sl),
                                    jnp.asarray(rl), plan.L, nb)
    got = pack.pack_geometry(_t(so), _t(sl), _t(rl), plan.L, nb)
    _eq(want, got, ("col_mask", "slot_id", "slot_start", "lane_off", "qseg",
                    "wcol"))


@pytest.mark.parametrize("dual", [False, True])
def test_pack_reconstruct_matches_jax(dual):
    """Per-lane trackers with planted ties between lanes and slots."""
    plan, (so, sl, rl) = _tables(9)
    rng = np.random.default_rng(2)
    geo = pack.pack_geometry(_t(so), _t(sl), _t(rl), plan.L)
    slot_id, lane_off = geo[1], geo[3]
    Br, L, S = plan.n_rows, plan.L, plan.S
    bv = rng.integers(0, 30, (Br, L)).astype(np.int32)
    bc = rng.integers(-1, 700, (Br, L)).astype(np.int32)
    bv[:, ::7] = 29
    bc[:, ::14] = 3
    nblk = 4
    maxcol = rng.integers(0, 50, (Br, nblk * S * (2 if dual else 1)))
    args = (bv, bc, maxcol.astype(np.int32))
    want = pallas_sw._pack_reconstruct(
        *(jnp.asarray(a) for a in args), jnp.asarray(slot_id.numpy()),
        jnp.asarray(lane_off.numpy()), jnp.asarray(rl), S, dual)
    got = pack.pack_reconstruct(*(_t(a) for a in args), slot_id, lane_off,
                                _t(rl), S, dual)
    _eq(want, got, ("gmax", "end_ref", "end_read", "maxcol"))


# ------------------------------------------------------------ the kernels


def _prep(ref, reads, read_len, word_rows, W, mat, max_slots=64):
    """Packed inputs of tests/test_pack.py's _packed, for both packages."""
    slot_len = np.where(word_rows, (read_len + 7) // 8 * 8,
                        (read_len + 15) // 16 * 16).astype(np.int32)
    plan = common.pack_plan(slot_len, W, max_slots=max_slots)
    L = common.bucket_size(max(common.pad_total(int(read_len.max()), False),
                               1), 64)
    rp = common.pad_reads(reads, L, 4)
    pc = common.pack_codes(plan, rp, 4)
    so, sl, rl_s = common.pack_tables(plan, read_len)
    pprof = common.build_profile(pc, None, common.extend_matrix(mat))
    flat_idx = (plan.row * plan.S + plan.slot).astype(np.int32)
    return plan, (pprof, ref, so, sl, rl_s, flat_idx)


def _both_packed(arrs, gapO, gapE, mat, **kw):
    R = len(arrs[1])
    want = pallas_sw.forward_shared_ref_packed(
        jnp.asarray(arrs[0]), jnp.asarray(arrs[1]), *arrs[2:], gapO, gapE,
        max_sub=int(np.abs(mat).max()), valid_len=R, **kw)
    got = cuda_sw.forward_shared_packed(
        *(_t(a) for a in arrs), gapO, gapE, max_sub=int(np.abs(mat).max()),
        valid_len=R, **kw)
    return want, got


@pytest.mark.parametrize("case", ["byte", "word_quirk", "byte_quirk",
                                  "mixed_m1x3"])
def test_packed_plain_matches_pallas(case):
    """Both tiers' slot geometry, the quirk on both tiers (the QBUMP
    sub-slot bias), mixed byte/word slots at m1/x3/o5/e2."""
    word = {"byte": False, "word_quirk": True, "byte_quirk": False,
            "mixed_m1x3": None}[case]
    quirk = case.endswith("quirk")
    mat = (_quirk_mat() if quirk else _dna_mat(1, 3) if case == "mixed_m1x3"
           else _dna_mat())
    gapO, gapE = (5, 2) if case == "mixed_m1x3" else (3, 1)
    ref, reads, read_len = _mk_reads(19 if quirk else 7, 768, 12)
    word_rows = (np.arange(12) % 2 == 0 if word is None
                 else np.full(12, word))
    plan, arrs = _prep(ref, reads, read_len, word_rows, 512, mat)
    assert plan.S > 1
    want, got = _both_packed(arrs, gapO, gapE, mat, quirk=quirk,
                             word=bool(word))
    _eq(want, got, FWD)


def test_packed_dual_and_degenerate_reads_match_pallas():
    """The dual channels on packed rows, with zero-length and 1-base reads
    (score 0, end_ref -1, end_read rl - 1)."""
    ref, reads, read_len = _mk_reads(53, 512, 8)
    reads[1], reads[4] = np.zeros(0, np.int32), ref[10:11].copy()
    read_len[1], read_len[4] = 0, 1
    plan, arrs = _prep(ref, reads, read_len, np.zeros(8, bool), 512,
                       _dna_mat())
    want, got = _both_packed(arrs, 3, 1, _dna_mat(), dual=True)
    assert tuple(got[3].shape) == (8, 2, 2)
    _eq(want, got, FWD)
    assert got[0][1] == 0 and got[1][1] == -1 and got[2][1] == -1


def test_packed_equals_unpacked_blockmax():
    """Per read, the packed outputs are the unpacked blockmax mode's (the
    port's own plain version), dual channel by channel."""
    ref, reads, read_len = _mk_reads(31, 700, 10)
    Rp = 768
    ref_p = np.full(Rp, 4, np.int32)
    ref_p[:700] = ref
    plan, arrs = _prep(ref_p, reads, read_len, np.zeros(10, bool), 1024,
                       _dna_mat())
    got = cuda_sw.forward_shared_packed(*(_t(a) for a in arrs), 3, 1,
                                        max_sub=2, valid_len=700, dual=True)
    L = 256
    prof = common.build_profile(common.pad_reads(reads, L, 4), read_len,
                                common.extend_matrix(_dna_mat()))
    gb = common.batch_geometry(read_len, L, word=False)
    gw = common.batch_geometry(read_len, L, word=True)
    want = scan_sw.forward_shared_ref(
        *(_t(a) for a in (prof, ref_p, read_len, gb.col_mask, gb.seg_id,
                          gb.seg_start)), 3, 1, False, blockmax=True,
        valid_len=700, wmask=_t(gw.col_mask))
    _eq(want, got, FWD)


def test_packed_quirk_span_guard():
    """The QBUMP guard rejects a slot span whose values could cross the
    block bias separation, in both packages."""
    rng = np.random.default_rng(5)
    ref = rng.integers(0, 4, 512).astype(np.int32)
    reads = [rng.integers(0, 4, 200).astype(np.int32) for _ in range(4)]
    read_len = np.full(4, 200, np.int32)
    big = _dna_mat(120, 120)  # span >> QBUMP
    _, arrs = _prep(ref, reads, read_len, np.zeros(4, bool), 512, big)
    with pytest.raises(AssertionError):
        pallas_sw.forward_shared_ref_packed(
            jnp.asarray(arrs[0]), jnp.asarray(ref), *arrs[2:], 3, 1,
            max_sub=120, quirk=True)
    with pytest.raises(ValueError, match="QBUMP"):
        cuda_sw.forward_shared_packed(*(_t(a) for a in arrs), 3, 1,
                                      max_sub=120, quirk=True)


def test_wrappers_count_no_cpu_launch():
    cuda_sw.reset_launches()
    test_packed_dual_and_degenerate_reads_match_pallas()
    assert not any(cuda_sw.launch_counts().values())


# ----------------------------------------------------------- the pipeline


@pytest.fixture
def routes(monkeypatch):
    """Streaming forced, packing by the JAX planner at 512 lanes; records
    which forward route each leaf took."""
    calls = []
    real_packed = cuda_sw.forward_shared_packed
    real_shared = cuda_sw.forward_shared

    def packed(*args, **kw):
        calls.append(("packed", kw.get("dual", False)))
        return real_packed(*args, **kw)

    def shared(*args, **kw):
        calls.append(("dual" if kw.get("wmask") is not None else "shared",
                      int(args[0].shape[0])))
        return real_shared(*args, **kw)

    monkeypatch.setattr(cuda_sw, "forward_shared_packed", packed)
    monkeypatch.setattr(cuda_sw, "forward_shared", shared)
    monkeypatch.setattr(pipeline, "STREAM_SUBOPT", True)
    monkeypatch.setattr(pipeline, "PACK", True)
    monkeypatch.setattr(pipeline, "PACK_L", 512)
    monkeypatch.setenv("SSW_TPU_STREAM_SUBOPT", "1")
    return calls
