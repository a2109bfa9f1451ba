"""The port's pipeline.align_batch_sharded (the whole pipeline over a (data x
seq) mesh) against the JAX package's single-device align_batch on its scan
backend: every result field, CIGARs included, and the stderr warnings, on
CPU meshes of [cpu] * 8.  The cases of tests/test_pipeline_sharded.py:
quirk-free and quirk penalties, score_size 0 overflow, the data axis's
padding (no extra warnings), the word-tier re-run, and the re-run of a
minority of overflowing reads.  Integer outputs: exact equality."""

import contextlib
import io

import numpy as np
import pytest
import torch

from ssw_tpu import pipeline as jax_pipeline
from ssw_tpu_torch import pipeline
from ssw_tpu_torch.parallel import mesh as mesh_lib

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain DP here runs small tensors, on which torch's thread pool
    gains nothing and only competes with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(r):
    if r is None:
        return None
    return (r.score1, r.score2, r.ref_begin1, r.ref_end1, r.read_begin1,
            r.read_end1, r.ref_end2, r.flag, list(r.cigar or []))


def _dna(match, mismatch):
    mat = np.zeros((5, 5), np.int8)
    for i in range(4):
        for j in range(4):
            mat[i, j] = match if i == j else -mismatch
    return mat


def _mk_problem(seed=11, B=13, R=1500, mismatch=2):
    rng = np.random.default_rng(seed)
    mat = _dna(2, mismatch)
    ref = rng.integers(0, 4, R).astype(np.int32)
    reads = []
    for _ in range(B):
        ln = int(rng.integers(30, 120))
        off = int(rng.integers(0, R - ln))
        r = ref[off:off + ln].copy()
        m = rng.random(ln) < 0.1
        r[m] = rng.integers(0, 4, int(m.sum()))
        reads.append(r.astype(np.int32))
    return reads, ref, mat


def _run(fn):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        res = fn()
    return res, err.getvalue()


def _same(req, data, seq):
    """align_batch_sharded on a data x seq CPU mesh equals the JAX
    package's align_batch (scan backend), fields and stderr."""
    want, want_err = _run(lambda: jax_pipeline.align_batch(
        req, backend="scan"))
    m = mesh_lib.make_mesh(data=data, seq=seq, devices=CPU8)
    preq = pipeline.BatchRequest.from_fields(req)
    got, got_err = _run(lambda: pipeline.align_batch_sharded(preq, m))
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert _fields(w) == _fields(g)
    assert got_err == want_err
    return want, want_err


@pytest.mark.parametrize("data,seq,mismatch", [
    (2, 4, 2),   # quirk-free penalties
    (4, 2, 5),   # quirk path (min(mat) < -2*gapE)
    (1, 8, 2),
])
def test_sharded_pipeline_matches_single(data, seq, mismatch):
    reads, ref, mat = _mk_problem(mismatch=mismatch)
    req = jax_pipeline.BatchRequest(
        reads=reads, ref=ref, mat=mat, gapO=3, gapE=1, flag=0x0F,
        mask_len=[max(len(r) // 2, 15) for r in reads])
    _same(req, data, seq)


def test_sharded_score_size0_returns_none_on_overflow():
    """score_size=0: None for byte-overflowing reads, with the reference's
    warning (ref: NULL at src/ssw.c:887-891)."""
    rng = np.random.default_rng(2)
    mat = _dna(4, 2)
    ref = rng.integers(0, 4, 512).astype(np.int32)
    req = jax_pipeline.BatchRequest(
        reads=[ref[10:110].copy(), ref[200:240].copy()], ref=ref, mat=mat,
        gapO=3, gapE=1, flag=0x0F, mask_len=15, score_size=0)
    want, err = _same(req, 2, 2)
    assert want[0] is None and want[1] is not None
    assert err.count("score_size") == 1


def test_padding_duplicates_emit_no_extra_warnings():
    """B = 3 on a data axis of 2 pads one copy of read 0: its warnings and
    work must not show (stderr equals the single-device run's)."""
    reads, ref, mat = _mk_problem(seed=21, B=3)
    req = jax_pipeline.BatchRequest(
        reads=reads, ref=ref, mat=mat, gapO=3, gapE=1, flag=0x0F,
        mask_len=[max(len(r) // 2, 15) for r in reads])
    want, _ = _same(req, 2, 2)
    assert len(want) == 3


def test_sharded_pipeline_word_rerun():
    """A byte-tier overflow (long perfect read, score > 255): the word
    geometry re-run on the mesh."""
    rng = np.random.default_rng(5)
    mat = _dna(4, 2)
    ref = rng.integers(0, 4, 1024).astype(np.int32)
    noisy = ref[300:380].copy()
    noisy[::7] = (noisy[::7] + 1) % 4
    req = jax_pipeline.BatchRequest(
        reads=[ref[100:260].copy(), noisy], ref=ref, mat=mat, gapO=3,
        gapE=1, flag=0x0F, mask_len=[80, 40])
    want, _ = _same(req, 2, 2)
    assert want[0].score1 == 640


def test_sharded_minority_overflow_subset_rerun():
    """Only a few reads overflow the byte range: the speculative tier
    masks and the padded subset re-run."""
    rng = np.random.default_rng(5)
    mat = _dna(2, 2)
    R = 2000
    ref = rng.integers(0, 4, R).astype(np.int32)
    reads = []
    for i in range(11):
        ln = 200 if i < 3 else int(rng.integers(30, 100))
        off = int(rng.integers(0, R - ln))
        r = ref[off:off + ln].copy()
        if i >= 3:
            m = rng.random(ln) < 0.08
            r[m] = rng.integers(0, 4, int(m.sum()))
        reads.append(r.astype(np.int32))
    req = jax_pipeline.BatchRequest(
        reads=reads, ref=ref, mat=mat, gapO=3, gapE=1, flag=0x0F,
        mask_len=[max(len(r) // 2, 15) for r in reads])
    want, _ = _same(req, 2, 4)
    scores = [w.score1 for w in want]
    assert any(s >= 255 for s in scores) and any(s < 255 for s in scores)


def test_sharded_gate_rule_and_forced_tiers(monkeypatch):
    """The bounded-radius gate on the shards' forward launches (GATE =
    "tiers", and the JAX plan at -m1 -x3 -o5 -e2) changes no output."""
    reads, ref, mat = _mk_problem(seed=31, B=7, R=900)
    for g, m, gO, gE in (("tiers", _dna(2, 2), 3, 1),
                         (True, _dna(1, 3), 5, 2)):
        monkeypatch.setattr(pipeline, "GATE", g)
        req = jax_pipeline.BatchRequest(
            reads=reads, ref=ref, mat=m, gapO=gO, gapE=gE, flag=0x0F,
            mask_len=[max(len(r) // 2, 15) for r in reads])
        _same(req, 1, 4)


def test_sharded_needs_a_card_by_default(monkeypatch):
    """A mesh of CUDA devices without a card raises; so does make_mesh
    with its default devices."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        mesh_lib.make_mesh(seq=2)
    with pytest.raises(RuntimeError, match="is_available"):
        mesh_lib.make_mesh(devices=["cuda:0"] * 2, seq=2)
    reads, ref, mat = _mk_problem(B=2)
    req = pipeline.BatchRequest(reads=reads, ref=ref, mat=mat, gapO=3,
                                gapE=1)
    m = mesh_lib.Mesh(np.array([[torch.device("cuda", 0)] * 2], dtype=object))
    with pytest.raises(RuntimeError, match="is_available"):
        pipeline.align_batch_sharded(req, m)
