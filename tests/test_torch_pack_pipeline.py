"""The port's streaming pipeline with lane packing and the dual tier against
the JAX package's: ssw_tpu.pipeline on its scan backend with
SSW_TPU_STREAM_SUBOPT=1, field by field with stderr, on the CPU, where the
plain versions stand in for the CUDA kernels.  Integer DP: every output
must be exactly equal (tolerance 0).  With them, the dual mode's plain
version against the JAX package's Pallas kernel in interpret mode, and the
whole CLI with packing forced against the JAX package's CLI.  These tests
were in tests/test_torch_pack.py; they live in a file of their own so that
the test runner can give them to another worker than the kernel tests."""

import io

import jax.numpy as jnp
import numpy as np
import pytest

from ssw_tpu import cli as jax_cli
from ssw_tpu import pipeline as jax_pipeline
from ssw_tpu.core.cigar import cigar_to_string
from ssw_tpu.ops import pallas_sw
from ssw_tpu_torch import cli, pipeline
from ssw_tpu_torch.ops import common, cuda_sw
from test_torch_pack import (FWD, _dna_mat, _eq, _mk_reads, _quirk_mat,  # noqa: F401
                             _t, routes)


def _batch(seed, n_reads, mat, gapO=3):
    """tests/test_pack.py's pipeline batch: half the reads embedded with 5 %
    substitutions (long ones overflow the byte tier), half random (long
    ones might overflow and do not)."""
    rng = np.random.default_rng(seed)
    R = 2048
    ref = rng.integers(0, 4, R).astype(np.int32)
    reads = []
    for i in range(n_reads):
        ln = int(rng.integers(30, 249))
        if i % 2 == 0:
            off = int(rng.integers(0, R - ln))
            rd = ref[off:off + ln].copy()
            m = rng.random(ln) < 0.05
            rd[m] = rng.integers(0, 4, int(m.sum()))
        else:
            rd = rng.integers(0, 4, ln)
        reads.append(rd.astype(np.int32))
    return jax_pipeline.BatchRequest(
        reads=reads, ref=ref, mat=mat, gapO=gapO, gapE=1, flag=0x0F,
        mask_len=[max(len(r) // 2, 15) for r in reads])


def _fields(r):
    if r is None:
        return None
    return (r.score1, r.score2, r.ref_begin1, r.ref_end1, r.read_begin1,
            r.read_end1, r.ref_end2, r.flag, cigar_to_string(r.cigar))


def _assert_same(want, got):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        assert _fields(a) == _fields(b), (i, _fields(a), _fields(b))



def _jax(req, capsys):
    want = jax_pipeline.align_batch(req, "scan")
    return want, capsys.readouterr().err


def _port(req, capsys):
    got = pipeline.align_batch(pipeline.BatchRequest.from_fields(req),
                               device="cpu")
    return got, capsys.readouterr().err


def test_packed_dual_pipeline_matches_jax(routes, capsys, monkeypatch):
    """A DNA batch with word-tier reads and might-but-didn't reads: one
    packed dual pass, no re-run; then the same batch with packing and the
    dual tier off (the re-run route), and with the dual tier alone."""
    req = _batch(31, 40, _dna_mat())
    want, err_want = _jax(req, capsys)
    read_len = np.int32([len(r) for r in req.reads])
    might = read_len * 2 + 2 >= 255
    assert any(w.score1 + 2 >= 255 for w in want)          # word tier
    assert any(m and w.score1 + 2 < 255 for m, w in zip(might, want))
    got, err = _port(req, capsys)
    assert routes == [("packed", True)]  # a plan, dual, no re-run
    _assert_same(want, got)
    assert err == err_want
    for pack_on, dual_on, route in ((False, False, "shared"),
                                    (False, None, "dual")):
        routes.clear()
        monkeypatch.setattr(pipeline, "PACK", pack_on)
        monkeypatch.setattr(pipeline, "DUAL", dual_on)
        got, err = _port(req, capsys)
        assert routes[0][0] == route and len(routes) == (
            2 if route == "shared" else 1), routes  # the re-run
        _assert_same(want, got)
        assert err == err_want


def test_packed_quirk_pipeline_matches_jax(routes, capsys):
    """The quirk path packs (int32, QBUMP block bias); word-tier reads
    re-run unpacked in word geometry."""
    req = _batch(47, 40, _quirk_mat())
    assert pipeline.needs_quirk(req.mat, req.gapE)
    want, err_want = _jax(req, capsys)
    got, err = _port(req, capsys)
    assert routes[0] == ("packed", False) and routes[1][0] == "shared"
    _assert_same(want, got)
    assert err == err_want


def test_packed_async_matches_sync(routes, capsys):
    req = pipeline.BatchRequest.from_fields(_batch(31, 40, _dna_mat()))
    sync = pipeline.align_batch(req, device="cpu")
    err_sync = capsys.readouterr().err
    pend = pipeline.align_batch_launch(req, device="cpu")
    assert pend.results is None
    pipeline.align_batch_mid(pend)
    scores = pipeline.align_batch_scores(pend)
    got = pipeline.align_batch_finish(pend)
    assert capsys.readouterr().err == err_sync
    assert [r for r, _ in routes] == ["packed", "packed"]
    assert scores.tolist() == [r.score1 for r in sync]
    _assert_same(sync, got)


@pytest.mark.parametrize("forced", [True, False, None])
def test_outputs_do_not_depend_on_pack(forced, routes, capsys, monkeypatch):
    """PACK True, False and None (the card's rule, which packs every
    streaming leaf) give the same results, pinned to the JAX package's."""
    req = _batch(5, 24, _dna_mat())
    want, _ = _jax(req, capsys)
    monkeypatch.setattr(pipeline, "PACK", forced)
    got, _ = _port(req, capsys)
    assert (routes[0][0] == "packed") == (forced is not False)
    _assert_same(want, got)


@pytest.mark.parametrize("gapO,gapE,mat", [(3, 1, _dna_mat()),
                                           (5, 2, _dna_mat(1, 3))])
def test_dual_plain_matches_pallas(gapO, gapE, mat):
    ref, reads, read_len = _mk_reads(53, 1000, 10)
    ref[900:] = 4  # the pipeline's padding past valid_len: virtual letters
    rp = common.pad_reads(reads, 256, 4)
    prof = common.build_profile(rp, read_len, common.extend_matrix(mat))
    gb = common.batch_geometry(read_len, 256, word=False)
    wm = pipeline._word_mask(_t(read_len), 256)
    arrs = (prof, ref, read_len, gb.col_mask, gb.seg_id, gb.seg_start)
    want = pallas_sw.forward_shared_ref(
        *(jnp.asarray(a) for a in arrs), gapO, gapE, False,
        max_sub=int(np.abs(mat).max()), blockmax=True, valid_len=900,
        wmask=jax_pipeline._word_mask(jnp.asarray(read_len), 256))
    got = cuda_sw.forward_shared(*(_t(a) for a in arrs), gapO, gapE, False,
                                 max_sub=int(np.abs(mat).max()),
                                 blockmax=True, valid_len=900, wmask=wm)
    assert tuple(got[3].shape) == (10, 2, 4)
    _eq(want, got, FWD)


def test_cli_packed_matches_jax_cli(routes, tmp_path, monkeypatch):
    """The whole CLI (SAM with header, stderr) with packing forced, byte-
    equal to the JAX package's CLI."""
    rng = np.random.default_rng(99)
    R = 2048
    ref = rng.integers(0, 4, R)
    bases = np.array(list("ACGT"))
    tfa = tmp_path / "t.fa"
    tfa.write_text(">t\n" + "".join(bases[ref]) + "\n")
    lines = []
    for i in range(48):
        ln = int(rng.integers(30, 200))
        rd = (ref[(o := int(rng.integers(0, R - ln))):o + ln].copy()
              if i % 2 == 0 else rng.integers(0, 4, ln))
        lines.append(f">r{i}\n" + "".join(bases[rd]) + "\n")
    qfa = tmp_path / "q.fa"
    qfa.write_text("".join(lines))
    args = ["-c", "-s", "-h", str(tfa), str(qfa)]

    def strip(err):
        return [ln for ln in err.splitlines() if not ln.startswith("CPU")]

    out, err = io.StringIO(), io.StringIO()
    assert jax_cli.main(args, out=out, err=err) == 0
    want = (out.getvalue(), strip(err.getvalue()))
    out, err = io.StringIO(), io.StringIO()
    assert cli.main(args, out=out, err=err, device="cpu") == 0
    assert routes[0] == ("packed", True)
    assert (out.getvalue(), strip(err.getvalue())) == want
