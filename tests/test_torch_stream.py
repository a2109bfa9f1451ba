"""The port's streaming suboptimal path against the JAX package's.

Streaming replaces the (B, R) per-column maxima with the forward kernels'
per-256-column block maxima (blockmax mode) plus two bounded per-read
window re-runs (ops/subopt.py).  Here, on the CPU, the kernels' plain
versions stand in for them: the blockmax plain version is held against the
Pallas kernel's blockmax mode in interpret mode and against the scan path's
blockmax_reduce; ops/subopt.py against ssw_tpu.ops.subopt; and the whole
path (pipeline.STREAM_SUBOPT = True) against ssw_tpu.pipeline on its scan
backend with SSW_TPU_STREAM_SUBOPT=1, on the five inputs of
tests/test_stream_subopt.py, field by field with stderr.  Integer DP and
integer glue: every output must be exactly equal (tolerance 0)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ssw_tpu import pipeline as jax_pipeline
from ssw_tpu.core.cigar import cigar_to_string
from ssw_tpu.ops import common, pallas_sw
from ssw_tpu.ops import scan_sw as jax_scan
from ssw_tpu.ops import subopt as jax_subopt
from ssw_tpu_torch import pipeline
from ssw_tpu_torch.core.encoding import BLOSUM50
from ssw_tpu_torch.ops import cuda_sw, subopt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy().astype(np.int64)
    return np.asarray(x).astype(np.int64)


def _eq(want, got, names):
    assert len(want) == len(got)
    for w, g, name in zip(want, got, names):
        np.testing.assert_array_equal(_np(w), _np(g), err_msg=name)


def _dna_mat(match=2, mismatch=2):
    mat = np.zeros((5, 5), np.int8)
    for i in range(4):
        for j in range(4):
            mat[i, j] = match if i == j else -mismatch
    return mat


def _protein_mat():
    """BLOSUM-like: min -7 < -2*gapE turns the lane-block quirk on."""
    mat = np.zeros((6, 6), np.int8)
    for i in range(5):
        for j in range(5):
            mat[i, j] = 9 if i == j else -7
    return mat


# ----------------------------------------------------------- blockmax mode

def _blockmax_inputs(mat, seed, ref_len=1000, tail="pad", Rp=None):
    """B 8, L 128 reads against a target of ref_len columns padded to Rp
    (default: the 256-column bucket) with the virtual letter (the
    pipeline's padding) or, tail="random", with real letters."""
    rng = np.random.default_rng(seed)
    n = mat.shape[0]
    ref = rng.integers(0, n - 1, ref_len).astype(np.int32)
    Rp = Rp or common.bucket_size(ref_len, 256)
    ref_p = (np.full(Rp, n, np.int32) if tail == "pad"
             else rng.integers(0, n - 1, Rp).astype(np.int32))
    ref_p[:ref_len] = ref
    read_len = rng.integers(20, 100, 8).astype(np.int32)
    reads = []
    for b, ln in enumerate(read_len):
        if b % 2:  # embedded reads: real hits and suboptimal candidates
            s = int(rng.integers(0, ref_len - ln))
            reads.append(ref[s:s + ln].copy())
        else:
            reads.append(rng.integers(0, n - 1, ln).astype(np.int32))
    rp = common.pad_reads(reads, 128, n)
    prof = common.build_profile(rp, read_len, common.extend_matrix(mat))
    geo = common.batch_geometry(read_len, 128, word=False)
    arrs = (prof, ref_p, read_len, geo.col_mask, geo.seg_id, geo.seg_start)
    return (tuple(jnp.asarray(a) for a in arrs),
            tuple(torch.as_tensor(np.ascontiguousarray(a)) for a in arrs))


FWD = ("score", "end_ref", "end_read", "blockmax")


@pytest.mark.parametrize("case,quirk,gapO,gapE", [
    ("dna", False, 3, 1),      # DNA m2/x2/o3/e1: the int16-eligible case
    ("protein", True, 4, 1),   # the quirk: int32 only
])
def test_blockmax_plain_matches_pallas_and_scan(case, quirk, gapO, gapE):
    mat = _dna_mat() if case == "dna" else _protein_mat()
    max_sub = int(np.abs(mat).max())
    ref_len = 1000  # not a multiple of 256: validity gating is observable
    jx, tc = _blockmax_inputs(mat, seed=23 if case == "dna" else 7)
    got = cuda_sw.forward_shared(*tc, gapO, gapE, quirk, max_sub=max_sub,
                                 blockmax=True, valid_len=ref_len)
    assert got[3].dtype == torch.int32 and tuple(got[3].shape) == (8, 4)
    assert int(got[3][1::2].min()) > 0
    _eq(pallas_sw.forward_shared_ref(*jx, gapO, gapE, quirk, max_sub=max_sub,
                                     blockmax=True, valid_len=ref_len),
        got, FWD)
    s, er, ed, mc = jax_scan.forward_shared_ref(*jx, gapO, gapE, quirk)
    _eq((s, er, ed, jax_scan.blockmax_reduce(mc, ref_len)), got, FWD)


def test_blockmax_columns_past_valid_len():
    """Real letters past valid_len feed no block maximum, and the best hit
    is the base mode's on the same inputs (every column feeds it)."""
    mat = _dna_mat()
    jx, tc = _blockmax_inputs(mat, seed=31, ref_len=700, tail="random",
                              Rp=1024)
    got = cuda_sw.forward_shared(*tc, 3, 1, False, max_sub=2, blockmax=True,
                                 valid_len=700)
    base = cuda_sw.forward_shared(*tc, 3, 1, False, max_sub=2)
    _eq(base[:3], got[:3], FWD[:3])
    s, er, ed, mc = jax_scan.forward_shared_ref(*jx, 3, 1, False)
    _eq((s, er, ed, jax_scan.blockmax_reduce(mc, 700)), got, FWD)
    assert not got[3][:, 3].any()  # block 3 starts at column 768 >= 700


def test_blockmax_is_not_clamped():
    """Block maxima above the word kernel's 32767 stay as they are (the
    composition clamps); the per-column output clamps."""
    rng = np.random.default_rng(3)
    B, L, R = 3, 320, 512
    mat = np.full((4, 4), -100, np.int8)
    np.fill_diagonal(mat, 120)
    ref = rng.integers(0, 4, R).astype(np.int32)
    read_len = np.full(B, 300, np.int32)
    rp = common.pad_reads([ref[:300].copy()] * B, L, 4)
    prof = common.build_profile(rp, read_len, common.extend_matrix(mat))
    geo = common.batch_geometry(read_len, L, word=True)
    tc = tuple(torch.as_tensor(np.ascontiguousarray(a)) for a in (
        prof, ref, read_len, geo.col_mask, geo.seg_id, geo.seg_start))
    s, _, _, bm = cuda_sw.forward_shared(*tc, 3, 1, False, blockmax=True)
    mc = cuda_sw.forward_shared(*tc, 3, 1, False)[3]
    assert s.tolist() == [300 * 120] * B
    assert bm[:, 1].tolist() == s.tolist()
    assert int(mc.max()) == 32767


def test_blockmax_wrapper_counts_no_cpu_launch():
    cuda_sw.reset_launches()
    _, tc = _blockmax_inputs(_dna_mat(), seed=1)
    cuda_sw.forward_shared(*tc, 3, 1, False, max_sub=2, blockmax=True,
                           valid_len=1000)
    assert not any(cuda_sw.launch_counts().values())


# ----------------------------------------------------------- ops/subopt.py

def _subopt_inputs(seed):
    """Block maxima and window maxima with planted ties and values above
    32767, exclusion windows clipped at column 0 and at ref_len."""
    rng = np.random.default_rng(seed)
    B, ref_len, D, Wb, Wb2 = 12, 1900, 100, 1024, 512
    nblk = (ref_len + 255) // 256
    bm = rng.integers(0, 50, (B, nblk)).astype(np.int32)
    for b in range(B):  # ties between blocks
        bm[b, rng.choice(nblk, 3, replace=False)] = 60 + b % 4
    bm[2, 1] = bm[2, 6] = 40000  # clamped to 32767 before comparing
    bm[0] = 0  # no suboptimal score at all
    end_ref = rng.integers(0, ref_len, B).astype(np.int32)
    end_ref[1], end_ref[3] = 3, ref_len - 1  # windows clipped at 0 / ref_len
    mask_len = rng.integers(15, 400, B).astype(np.int32)
    word = np.arange(B) % 2 == 1
    lo = np.maximum(end_ref - mask_len, 0)
    ws = np.maximum(lo // 256 * 256 - D, 0).astype(np.int32)
    mc_win = rng.integers(0, 70, (B, Wb)).astype(np.int32)
    for b in range(B):  # ties inside the partial zone
        mc_win[b, rng.choice(Wb, 4, replace=False)] = 69
    mc_win[5, 10] = 50000
    mc_win[0] = 0
    return dict(bm=bm, mc_win=mc_win, ws=ws, end_ref=end_ref,
                mask_len=mask_len, word=word, ref_len=ref_len, D=D, Wb=Wb,
                Wb2=Wb2, rng=rng)


@pytest.mark.parametrize("seed", [1, 2])
def test_compose_and_resolve_match_jax(seed):
    d = _subopt_inputs(seed)
    args = (d["bm"], d["mc_win"], d["ws"], d["end_ref"], d["mask_len"],
            d["word"])
    want = jax_subopt.compose_window(*(jnp.asarray(a) for a in args),
                                     d["ref_len"])
    got = subopt.compose_window(*(torch.as_tensor(a) for a in args),
                                d["ref_len"])
    _eq(want, got, ("score2", "hasA", "hasP", "hasB", "firstP_i", "bstar"))
    assert int(got[0][2]) == 32767 and int(got[0][0]) == 0

    s2, bstar = _np(got[0]).astype(np.int32), _np(got[5]).astype(np.int32)
    ws2 = np.maximum(bstar * 256 - d["D"], 0).astype(np.int32)
    mc2 = d["rng"].integers(0, 70, (len(s2), d["Wb2"])).astype(np.int32)
    for b in range(len(s2)):  # the winning value, twice, inside the block
        k = int(bstar[b]) * 256 - int(ws2[b])
        mc2[b, k + 7] = mc2[b, k + 200] = s2[b]
    mc2[4] = 0  # no hit: argmax of an all-False row is 0
    args2 = (mc2, ws2, bstar, s2)
    want2 = jax_subopt.resolve_block(*(jnp.asarray(a) for a in args2),
                                     d["ref_len"])
    got2 = subopt.resolve_block(*(torch.as_tensor(a) for a in args2),
                                d["ref_len"])
    _eq((want2,), (got2,), ("resolve_block",))


def test_gather_windows_matches_jax():
    rng = np.random.default_rng(5)
    ref_ext = rng.integers(0, 5, 2048 + 768).astype(np.int32)
    starts = np.array([0, 1, 255, 1000, 2048], np.int32)
    want = jax_subopt.gather_windows(jnp.asarray(ref_ext),
                                     jnp.asarray(starts), 768)
    got = subopt.gather_windows(torch.as_tensor(ref_ext),
                                torch.as_tensor(starts), 768)
    assert got.dtype == torch.int32 and got.is_contiguous()
    _eq((want,), (got,), ("windows",))


# ----------------------------------------------------------- the whole path

def _mk_reads(rng, ref, n_reads, lmin, lmax, sub_rate, n):
    reads = []
    R = len(ref)
    for _ in range(n_reads):
        ln = int(rng.integers(lmin, lmax))
        off = int(rng.integers(0, max(R - ln, 1)))
        rd = ref[off:off + ln].copy()
        m = rng.random(ln) < sub_rate
        rd[m] = rng.integers(0, n - 1, int(m.sum()))
        reads.append(rd.astype(np.int32))
    return reads


def _req(reads, ref, mat, gapO, mask_len=None):
    return jax_pipeline.BatchRequest(
        reads=reads, ref=ref, mat=mat, gapO=gapO, gapE=1, flag=0x0F,
        mask_len=mask_len or [max(len(r) // 2, 15) for r in reads])


def _random_dna():
    rng = np.random.default_rng(11)
    ref = rng.integers(0, 4, 3000).astype(np.int32)
    return _req(_mk_reads(rng, ref, 24, 20, 180, 0.08, 5), ref, _dna_mat(), 3)


def _tandem_repeats():
    """Equal column maxima at many distant positions: first-index ties."""
    rng = np.random.default_rng(5)
    unit = rng.integers(0, 4, 97).astype(np.int32)
    ref = np.tile(unit, 40)
    reads = [unit.copy() for _ in range(8)]
    reads += _mk_reads(rng, ref, 8, 40, 90, 0.05, 5)
    return _req(reads, ref, _dna_mat(), 3)


def _quirk_protein():
    rng = np.random.default_rng(7)
    ref = rng.integers(0, 5, 2200).astype(np.int32)
    return _req(_mk_reads(rng, ref, 12, 15, 120, 0.1, 6), ref,
                _protein_mat(), 4)


def _mixed_tiers():
    """Long exact reads overflow the byte tier; short ones stay byte."""
    rng = np.random.default_rng(13)
    ref = rng.integers(0, 4, 2600).astype(np.int32)
    reads = (_mk_reads(rng, ref, 6, 140, 200, 0.0, 5)
             + _mk_reads(rng, ref, 6, 20, 60, 0.05, 5))
    return _req(reads, ref, _dna_mat(), 3)


def _target_edges():
    rng = np.random.default_rng(17)
    ref = rng.integers(0, 4, 777).astype(np.int32)
    reads = [ref[:50].copy(), ref[-50:].copy(), ref[300:360].copy()]
    reads += _mk_reads(rng, ref, 5, 30, 70, 0.05, 5)
    return _req(reads, ref, _dna_mat(), 3,
                [400, 400, 15] + [max(len(r) // 2, 15) for r in reads[3:]])


INPUTS = {"random_dna": _random_dna, "tandem_repeats": _tandem_repeats,
          "quirk_protein": _quirk_protein, "mixed_tiers": _mixed_tiers,
          "target_edges": _target_edges}


def _fields(r):
    if r is None:
        return None
    return (r.score1, r.score2, r.ref_begin1, r.ref_end1, r.read_begin1,
            r.read_end1, r.ref_end2, r.flag, cigar_to_string(r.cigar))


def _assert_same(want, got):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        assert _fields(a) == _fields(b), (i, _fields(a), _fields(b))


@pytest.fixture
def stream_calls(monkeypatch):
    """Counts the leaves that took the streaming suboptimal scan."""
    calls = []
    real = pipeline._second_best_streaming

    def spy(st, end_ref, word):
        calls.append(st.B)
        return real(st, end_ref, word)

    monkeypatch.setattr(pipeline, "_second_best_streaming", spy)
    return calls


def _port(req, monkeypatch, capsys, streaming):
    monkeypatch.setattr(pipeline, "STREAM_SUBOPT", streaming)
    got = pipeline.align_batch(pipeline.BatchRequest.from_fields(req),
                               device="cpu")
    return got, capsys.readouterr().err


# inputs whose leaf re-runs some reads in their final tier, so that the
# re-run's block maxima are spliced into the leaf's: byte rows for
# might-but-did-not-overflow reads (with the dual tier off, which would
# answer them in one pass, and packing off: tests/test_torch_pack.py), word
# geometry on the quirk path
RERUN = ("random_dna", "quirk_protein")


@pytest.mark.parametrize("name", list(INPUTS))
def test_streaming_matches_jax_and_full_scan(name, monkeypatch, capsys,
                                             stream_calls):
    req = INPUTS[name]()
    monkeypatch.setenv("SSW_TPU_STREAM_SUBOPT", "1")
    want = jax_pipeline.align_batch(req, "scan")
    err_want = capsys.readouterr().err
    forwards = []
    real_forward = pipeline._forward

    def forward(st, reads_d, *args):
        forwards.append(int(reads_d.shape[0]))
        return real_forward(st, reads_d, *args)

    monkeypatch.setattr(pipeline, "_forward", forward)
    monkeypatch.setattr(pipeline, "DUAL", False)
    monkeypatch.setattr(pipeline, "PACK", False)
    got, err = _port(req, monkeypatch, capsys, True)
    assert stream_calls == [len(req.reads)]
    assert (len(forwards) > 1) == (name in RERUN), forwards
    _assert_same(want, got)
    assert err == err_want
    full, err_full = _port(req, monkeypatch, capsys, False)
    assert stream_calls == [len(req.reads)]  # the full scan did not stream
    _assert_same(full, got)
    assert err_full == err


def test_async_streaming_matches_align_batch(monkeypatch, capsys,
                                             stream_calls):
    req = pipeline.BatchRequest.from_fields(_tandem_repeats())
    monkeypatch.setattr(pipeline, "STREAM_SUBOPT", True)
    assert all(s for _, _, s in pipeline._plan_leaves(req))
    sync = pipeline.align_batch(req, device="cpu")
    err_sync = capsys.readouterr().err
    pend = pipeline.align_batch_launch(req, device="cpu")
    assert pend.results is None and not stream_calls[1:]
    pipeline.align_batch_mid(pend)
    scores = pipeline.align_batch_scores(pend)
    got = pipeline.align_batch_finish(pend)
    assert capsys.readouterr().err == err_sync
    assert len(stream_calls) == 2
    assert scores.tolist() == [r.score1 for r in sync]
    _assert_same(sync, got)


# ----------------------------------------------------------- the rules

@pytest.mark.parametrize("L,mat,gapO,gapE", [
    (64, _dna_mat(), 3, 1), (128, _dna_mat(), 3, 1),
    (256, _dna_mat(1, 3), 5, 2), (128, BLOSUM50, 10, 1),
    (512, _protein_mat(), 4, 1)])
def test_restart_margin_matches_jax(L, mat, gapO, gapE):
    assert (pipeline._restart_margin(L, mat, gapO, gapE)
            == jax_pipeline._restart_margin(L, mat, gapO, gapE))


def test_use_streaming_rule(monkeypatch):
    monkeypatch.delenv("SSW_TPU_STREAM_SUBOPT", raising=False)
    assert pipeline.STREAM_SUBOPT is None
    rp_10m = common.bucket_size(10_000_010, 256)
    assert pipeline._use_streaming(rp_10m, 128)  # the memory rule
    assert jax_pipeline._use_streaming(rp_10m, 128, "scan")
    rp_1m = common.bucket_size(1_000_001, 256)
    assert pipeline._use_streaming(rp_1m, 128) == (
        rp_1m >= pipeline.STREAM_MIN_COLS)
    monkeypatch.setattr(pipeline, "STREAM_MIN_COLS", rp_1m + 1)
    assert not pipeline._use_streaming(rp_1m, 128)
    monkeypatch.setattr(pipeline, "STREAM_MIN_COLS", rp_1m)
    assert pipeline._use_streaming(rp_1m, 128)
    for forced in (True, False):
        monkeypatch.setattr(pipeline, "STREAM_SUBOPT", forced)
        assert pipeline._use_streaming(rp_10m, 128) is forced
        assert pipeline._use_streaming(4096, 64) is forced


def test_streaming_leaf_split_is_jax(monkeypatch):
    monkeypatch.setenv("SSW_TPU_STREAM_SUBOPT", "1")
    monkeypatch.setattr(pipeline, "STREAM_SUBOPT", True)
    rng = np.random.default_rng(2)
    ref = rng.integers(0, 4, 3000).astype(np.int32)
    reads = _mk_reads(rng, ref, 2100, 90, 110, 0.0, 5)
    req = _req(reads, ref, _dna_mat(), 3)
    assert [len(i) for i, _, _ in jax_pipeline._plan_async(req, "scan")] == \
        [len(i) for i, _, _ in pipeline._plan_leaves(
            pipeline.BatchRequest.from_fields(req))] == [1024, 1024, 52]
    for L in (64, 128, 256, 512, 1024):
        assert pipeline._rows_per_leaf(1 << 20, L, True) == max(
            1024, jax_pipeline._sweet_rows(L))
