"""ssw_tpu_torch.pipeline (device "cpu": the kernels' plain versions) against
ssw_tpu.pipeline on its scan backend.  One request, built with numpy from a
seed, goes to both packages; every AlignResult field and the captured
stderr must be equal."""

import numpy as np
import pytest

from ssw_tpu import pipeline as jax_pipeline
from ssw_tpu.core.cigar import cigar_to_string
from ssw_tpu.core.encoding import BLOSUM50, dna_matrix
from ssw_tpu_torch import pipeline


def _fields(r):
    if r is None:
        return None
    return (r.score1, r.score2, r.ref_begin1, r.ref_end1, r.read_begin1,
            r.read_end1, r.ref_end2, r.flag, cigar_to_string(r.cigar))


def _assert_same(want, got):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        assert _fields(a) == _fields(b), (i, _fields(a), _fields(b))


def _reads(rng, ref, n_reads, lmin, lmax, sub_rate, alphabet):
    reads = []
    for k in range(n_reads):
        ln = int(rng.integers(lmin, lmax))
        if k % 4 == 3:  # unrelated read
            reads.append(rng.integers(0, alphabet, ln).astype(np.int8))
            continue
        off = int(rng.integers(0, max(len(ref) - ln, 1)))
        rd = ref[off:off + ln].copy()
        m = rng.random(len(rd)) < sub_rate
        rd[m] = rng.integers(0, alphabet, int(m.sum()))
        reads.append(rd.astype(np.int8))
    return reads


def _dna_req(seed=1, mat=None, gapO=3, gapE=1, n_reads=24, lmin=20,
             lmax=100, sub_rate=0.08, R=700, **kw):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, R).astype(np.int8)
    reads = _reads(rng, ref, n_reads, lmin, lmax, sub_rate, 4)
    kw.setdefault("mask_len", [max(len(r) // 2, 15) for r in reads])
    return jax_pipeline.BatchRequest(
        reads=reads, ref=ref, mat=dna_matrix(2, 2) if mat is None else mat,
        gapO=gapO, gapE=gapE, **kw)


def _protein_req(seed=2, n_reads=16, lmin=12, lmax=90, sub_rate=0.2, R=400,
                 **kw):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 20, R).astype(np.int8)
    reads = _reads(rng, ref, n_reads, lmin, lmax, sub_rate, 20)
    kw.setdefault("mask_len", [max(len(r) // 2, 15) for r in reads])
    return jax_pipeline.BatchRequest(reads=reads, ref=ref, mat=BLOSUM50,
                                     gapO=3, gapE=1, **kw)


def _compare(req, capsys):
    want = jax_pipeline.align_batch(req, backend="scan")
    err_want = capsys.readouterr().err
    got = pipeline.align_batch(pipeline.BatchRequest.from_fields(req),
                               device="cpu")
    err_got = capsys.readouterr().err
    _assert_same(want, got)
    assert err_got == err_want
    return got, err_got


def test_from_fields_copies_every_request_field():
    req = _dna_req(flag=3, filters=7, filterd=9, score_size=1)
    port = pipeline.BatchRequest.from_fields(req)
    for f in ("reads", "ref", "mat", "gapO", "gapE", "flag", "filters",
              "filterd", "mask_len", "score_size"):
        assert getattr(port, f) is getattr(req, f)


@pytest.mark.parametrize("match,mismatch,gapO,gapE", [(2, 2, 3, 1),
                                                      (1, 3, 5, 2)])
def test_dna(match, mismatch, gapO, gapE, capsys):
    req = _dna_req(mat=dna_matrix(match, mismatch), gapO=gapO, gapE=gapE)
    got, _ = _compare(req, capsys)
    assert any(r.cigar for r in got)


def test_protein_blosum50_quirk(capsys):
    assert pipeline.needs_quirk(BLOSUM50, 1)
    got, _ = _compare(_protein_req(), capsys)
    assert any(r.cigar for r in got)


def test_mask_len_below_15(capsys):
    req = _dna_req(seed=3)
    req.mask_len = [5 + i % 12 for i in range(len(req.reads))]
    got, _ = _compare(req, capsys)
    assert all(r.ref_end2 == -1 for r, ml in zip(got, req.mask_len)
               if r.score1 > 0 and ml < 15)


@pytest.mark.parametrize("flag,filters,filterd", [
    (0, 0, 2 ** 31 - 1), (1, 0, 2 ** 31 - 1), (2, 60, 2 ** 31 - 1),
    (4, 0, 40), (8, 0, 2 ** 31 - 1), (6, 50, 30), (0x0F, 70, 45)])
def test_flags_and_filters(flag, filters, filterd, capsys):
    req = _dna_req(seed=4, flag=flag, filters=filters, filterd=filterd)
    _compare(req, capsys)


def test_gap_open_not_above_extend_uses_oracle(capsys):
    req = _dna_req(seed=5, gapO=1, gapE=2, n_reads=8)
    _compare(req, capsys)


def _mixed_lengths_req(n_long=8):
    """70 short reads fill the 64-row bucket on their own; the longer
    reads form a second length group (pipeline._length_groups)."""
    rng = np.random.default_rng(6)
    ref = rng.integers(0, 4, 700).astype(np.int8)
    reads = (_reads(rng, ref, 70, 15, 50, 0.08, 4)
             + _reads(rng, ref, n_long, 130, 180, 0.08, 4))
    return jax_pipeline.BatchRequest(
        reads=reads, ref=ref, mat=dna_matrix(2, 2), gapO=3, gapE=1,
        mask_len=[max(len(r) // 2, 15) for r in reads])


def test_mixed_lengths_several_groups(capsys):
    req = _mixed_lengths_req()
    Ls = [pipeline._lane_bucket(len(r)) for r in req.reads]
    assert len(pipeline._length_groups(Ls)) == 2
    _compare(req, capsys)


def _overflow_dna_req(score_size=2):
    """Long exact reads overflow the byte tier (score + bias >= 255); long
    reads with many substitutions might overflow but do not."""
    rng = np.random.default_rng(7)
    ref = rng.integers(0, 4, 700).astype(np.int8)
    reads = (_reads(rng, ref, 3, 150, 190, 0.0, 4)
             + _reads(rng, ref, 3, 150, 190, 0.3, 4)
             + _reads(rng, ref, 4, 30, 90, 0.05, 4))
    return jax_pipeline.BatchRequest(
        reads=reads, ref=ref, mat=dna_matrix(2, 2), gapO=3, gapE=1,
        mask_len=[max(len(r) // 2, 15) for r in reads],
        score_size=score_size)


@pytest.mark.parametrize("score_size", [0, 1, 2])
def test_score_size_and_byte_overflow(score_size, capsys):
    got, err = _compare(_overflow_dna_req(score_size), capsys)
    if score_size == 0:
        assert any(r is None for r in got)
        assert "score_size" in err
    else:
        assert max(r.score1 for r in got) + 2 >= 255


def test_protein_overflow_word_rerun(capsys):
    """Long high-identity protein reads overflow the byte tier on the quirk
    path: the word-geometry rerun changes the DP itself."""
    req = _protein_req(seed=8, n_reads=8, lmin=60, lmax=110, sub_rate=0.02)
    got, _ = _compare(req, capsys)
    assert max(r.score1 for r in got) >= 255


def test_async_detail_matches_align_batch(capsys):
    """launch / mid / scores / finish(detail) against align_batch and
    against the JAX package's own async stages: detail=False reads lose
    only the cigar; the stderr text is the same."""
    req = _dna_req(seed=9, n_reads=20)
    preq = pipeline.BatchRequest.from_fields(req)
    sync = pipeline.align_batch(preq, device="cpu")
    err_sync = capsys.readouterr().err
    detail = np.arange(len(req.reads)) % 2 == 0

    pend = pipeline.align_batch_launch(preq, device="cpu")
    assert pend.results is None
    pipeline.align_batch_mid(pend)
    scores = pipeline.align_batch_scores(pend)
    got = pipeline.align_batch_finish(pend, detail=detail)
    err_async = capsys.readouterr().err
    assert err_async == err_sync
    assert scores.tolist() == [r.score1 for r in sync]
    for i, (a, b) in enumerate(zip(sync, got)):
        fa, fb = _fields(a), _fields(b)
        if detail[i]:
            assert fa == fb, i
        else:
            assert b.cigar == [] and fa[:-1] == fb[:-1], i

    jpend = jax_pipeline.align_batch_launch(req, "scan")
    jax_pipeline.align_batch_mid(jpend)
    assert jax_pipeline.align_batch_scores(jpend).tolist() == scores.tolist()
    _assert_same(jax_pipeline.align_batch_finish(jpend, detail=detail), got)
    capsys.readouterr()


def test_async_sync_paths_complete_at_launch(monkeypatch, capsys):
    """score_size != 2, gapO <= gapE and a length group past the quirk
    value-range guard (an oracle leaf of the plan; here the long reads'
    group, by a stand-in guard) run synchronously inside launch, so stderr
    order stays that of the serial path."""
    mixed = pipeline.BatchRequest.from_fields(_mixed_lengths_req(n_long=2))
    unguarded = pipeline.align_batch(mixed, device="cpu")
    capsys.readouterr()
    for req, guard in ((_overflow_dna_req(score_size=0), None),
                       (_dna_req(seed=5, gapO=1, gapE=2, n_reads=8), None),
                       (mixed, lambda L, *a: L > 64)):
        if guard is not None:
            monkeypatch.setattr(pipeline, "_quirk_out_of_range", guard)
            assert [s for _, _, s in pipeline._plan_leaves(req)] == [
                False, None]
        preq = pipeline.BatchRequest.from_fields(req)
        sync = pipeline.align_batch(preq, device="cpu")
        err_sync = capsys.readouterr().err
        pend = pipeline.align_batch_launch(preq, device="cpu")
        assert pend.results is not None
        got = pipeline.align_batch_finish(pend)
        assert capsys.readouterr().err == err_sync
        _assert_same(sync, got)
    _assert_same(unguarded, got)  # the oracle leaf's reads kept their places


def test_memory_split_matches_jax_rules(monkeypatch, capsys):
    """The leaf-splitting rules are the JAX package's (same constants), so
    the leaves -- and with them the order of stderr warnings -- agree."""
    for Rp in (4096, 1 << 20, 10 << 20):
        for L in (64, 128, 256, 512):
            if jax_pipeline._use_streaming(Rp, L, "scan"):
                continue
            want = max(64, int(jax_pipeline.MAXCOL_BUDGET // (Rp * 2))
                       // 64 * 64)
            cap = max(64, int(jax_pipeline.MAXCOL_HARD_CAP // (Rp * 2))
                      // 64 * 64)
            want = max(want, min(jax_pipeline._sweet_rows(L), cap))
            assert pipeline._rows_per_leaf(Rp, L, False) == want
    # a small budget splits 150 reads into leaves of 64, 64 and 22 rows
    # (with the full scan: under that budget the memory rule would stream)
    req = _dna_req(seed=10, n_reads=150, lmin=15, lmax=50)
    for mod in (pipeline, jax_pipeline):
        monkeypatch.setattr(mod, "MAXCOL_BUDGET", 64 * 2 * 768)
        monkeypatch.setattr(mod, "MAXCOL_HARD_CAP", 64 * 2 * 768)
    monkeypatch.setattr(pipeline, "STREAM_SUBOPT", False)
    monkeypatch.setenv("SSW_TPU_STREAM_SUBOPT", "0")
    plan = pipeline._plan_leaves(pipeline.BatchRequest.from_fields(req))
    assert [len(idx) for idx, _, _ in plan] == [64, 64, 22]
    _compare(req, capsys)
