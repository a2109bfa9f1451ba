"""ssw_tpu_torch.api on device "cpu" against ssw_tpu.api (JAX on the CPU,
backend "scan"), field for field (integer DP: tolerance 0): the cases of
tests/test_api.py, the Aligner Clear/ReBuild lifecycle cases of
tests/test_ssw_lib.py, seeded random pairs and mixed-length batches
(DNA, BLOSUM50, filters, a stored reference), the gapO <= gapE fallback
and the score_size = 0 overflow."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import ssw_tpu_torch
from ssw_tpu import api as japi
from ssw_tpu_torch import api, pipeline
from ssw_tpu_torch.core import oracle
from ssw_tpu_torch.core.encoding import AA_ORDER, AA_TABLE, BLOSUM50, \
    dna_matrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "CAGCCTTTCTGACCCGGAAATCAAAATAGGCACAACAAA"
READ = "CTGAGCCGGTAAATC"


def _plain(x):
    """Results of either package as plain Python values: dataclasses
    (Alignment, AlignResult) as dicts, numbers as ints."""
    if dataclasses.is_dataclass(x):
        return {k: _plain(v) for k, v in dataclasses.asdict(x).items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, np.integer):
        return int(x)
    return x


class Twin:
    """An ssw_tpu.api.Aligner and an ssw_tpu_torch.api.Aligner built and
    driven alike: each method call runs on both, holds the port's result
    equal to the JAX package's and returns it."""

    def __init__(self, *args, **kw):
        self.j = japi.Aligner(*args, backend="scan", **kw)
        self.t = api.Aligner(*args, device="cpu", **kw)

    def __getattr__(self, name):
        fj, ft = getattr(self.j, name), getattr(self.t, name)

        def call(*a, **k):
            want, got = fj(*a, **k), ft(*a, **k)
            assert _plain(got) == _plain(want), name
            return got
        return call

    def same_state(self):
        for f in ("gap_open", "gap_extend"):
            assert getattr(self.t, f) == getattr(self.j, f)
        for f in ("matrix", "table", "_reference"):
            a, b = getattr(self.t, f), getattr(self.j, f)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


def test_cpp_example_parity():
    """ref: src/example.cpp:22-53 — golden values from the compiled
    reference C++ wrapper."""
    flag, al = Twin().align(READ, REF, api.Filter(), mask_len=15)
    assert (al.sw_score, al.sw_score_next_best, al.ref_begin, al.ref_end,
            al.query_begin, al.query_end, al.ref_end_next_best,
            al.mismatches, al.cigar_string, flag) == (
        21, 8, 8, 21, 0, 14, 4, 2, "4=1X4=1I5=", 0)


def test_cpp_softclip_string():
    _, al = Twin().align("GGACGTACGTACGTGG", "TTTTTACGTACGTACGTTTTT",
                         api.Filter(), mask_len=15)
    assert al.cigar_string.startswith("2S")
    assert al.cigar_string.endswith("2S")
    assert al.sw_score == 2 * 12


def test_align_matches_oracle_and_jax():
    rng = np.random.default_rng(5)
    mat = dna_matrix(2, 2)
    ref = rng.integers(0, 4, 200).astype(np.int8)
    read = ref[50:120].copy()
    read[10] = (read[10] + 1) % 4
    got = api.align(read, ref, 3, 1, mat=mat, mask_len=35, device="cpu")
    want = oracle.ssw_align(read, ref, mat, 3, 1, mask_len=35)
    assert _plain(got) == _plain(want)
    assert _plain(got) == _plain(japi.align(read, ref, 3, 1, mat=mat,
                                            mask_len=35, backend="scan"))
    prof = api.Profile(read, mat.reshape(-1))
    assert prof.mat.shape == (5, 5) and prof.n == 5
    assert _plain(api.align(prof, ref, 3, 1, mask_len=35,
                            device="cpu")) == _plain(got)


def test_lazy_api_exports():
    for name in ("Aligner", "Alignment", "Filter", "Profile", "align",
                 "align_batch"):
        assert getattr(ssw_tpu_torch, name) is getattr(api, name)
    with pytest.raises(AttributeError):
        ssw_tpu_torch.no_such_name
    code = ("import sys, ssw_tpu_torch\n"
            "assert 'ssw_tpu_torch.pipeline' not in sys.modules\n"
            "assert ssw_tpu_torch.Aligner.__module__ == 'ssw_tpu_torch.api'\n"
            "assert 'ssw_tpu_torch.pipeline' in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_empty_query_fails_individually():
    """An empty query in a batch fails only that entry (flag 0, untouched
    Alignment); the rest of the batch still aligns (ref:
    src/ssw_cpp.cpp:301 checks per call)."""
    flags, als = Twin().align_batch(["CTGAGCCGGTAAATC", "", "ACGT"], REF,
                                    api.Filter(), mask_len=15)
    assert flags[1] == 0 and als[1].sw_score == 0
    assert als[0].sw_score == 21 and als[0].ref_begin == 8
    assert als[2].sw_score > 0
    # the per-query mask list keeps its alignment with the live queries
    Twin().align_batch(["", READ, "", "ACGTTTCTGA"], REF, api.Filter(),
                       mask_len=[40, 3, 7, 20])


# ---------------------------------------------------------------------------
# Aligner Clear / ReBuild lifecycle (ref: src/ssw_cpp.cpp:359-420)
# ---------------------------------------------------------------------------

def test_rebuild_fails_unless_cleared():
    a = Twin()
    assert a.rebuild() is False
    assert a.rebuild(1, 3, 5, 2) is False
    a.clear()
    assert a.rebuild() is True
    a.same_state()
    _, al = a.align(READ, REF)
    assert al.sw_score == 21


def test_rebuild_with_scores_resets_everything():
    a = Twin(match_score=9, mismatch_penalty=9, gap_opening_penalty=9,
             gap_extending_penalty=9)
    a.set_reference_sequence(REF)
    a.clear()
    assert a.rebuild(1, 3, 5, 2) is True
    a.same_state()
    assert a.t.gap_open == 5 and a.t.gap_extend == 2
    _, al = a.align(READ, REF)
    assert al.sw_score > 0
    a.set_gap_penalty(4, 1)
    a.same_state()
    a.align(READ, REF)


def test_rebuild_matrix_form_never_checks():
    """The custom-matrix ReBuild succeeds without a prior Clear (ref:
    src/ssw_cpp.cpp:394-407 has no empty check)."""
    a = Twin()
    assert a.rebuild(dna_matrix(2, 2)) is True
    a.same_state()
    _, al = a.align(READ, REF)
    assert al.sw_score > 0
    assert a.rebuild(BLOSUM50.reshape(-1), AA_TABLE) is True
    a.same_state()
    a.align("MKVLAAGIVGHWW", "PPMKVLAGGIVGHWWQQ")


def test_cleared_aligner_is_disabled():
    a = Twin()
    a.set_reference_sequence(REF)
    a.clear()
    a.same_state()
    assert a.set_reference_sequence(REF) == 0
    flag, al = a.align(READ, REF)
    assert flag == 0 and al.sw_score == 0 and al.cigar_string == ""


def test_align_without_reference_returns_false():
    a = Twin()
    flag, al = a.align(READ)
    assert flag == 0 and al.sw_score == 0
    assert a.set_reference_sequence(REF) == len(REF)
    _, al = a.align(READ)
    assert al.sw_score == 21
    a.clear_reference_sequence()
    a.same_state()
    flag, al = a.align(READ)
    assert flag == 0 and al.sw_score == 0


def test_empty_query_or_ref_returns_false():
    a = Twin()
    flag, al = a.align("", REF)
    assert flag == 0 and al.sw_score == 0
    flag, al = a.align(READ, "")
    assert flag == 0 and al.sw_score == 0


def test_empty_stored_reference_disables_align():
    """SetReferenceSequence("") leaves translated_reference_ empty, and
    Align-vs-stored-ref then returns false (ref: src/ssw_cpp.cpp:277-279)."""
    a = Twin()
    assert a.set_reference_sequence("") == 0
    flag, al = a.align(READ)
    assert flag == 0 and al.sw_score == 0


# ---------------------------------------------------------------------------
# seeded cases
# ---------------------------------------------------------------------------

def _mutate(rng, s, alphabet, rate):
    s = list(s)
    for i in range(len(s)):
        u = rng.random()
        if u < rate:
            s[i] = alphabet[rng.integers(len(alphabet))]
        elif u < rate * 1.3:
            s[i] = ""
        elif u < rate * 1.6:
            s[i] += alphabet[rng.integers(len(alphabet))]
    return "".join(s)


def _seeded(seed, alphabet, ref_len, n, lo, hi):
    """A random reference and n mixed-length queries: mutated substrings of
    it, a reverse copy and unrelated strings, with lowercase and an
    unknown letter among them."""
    rng = np.random.default_rng(seed)
    ref = "".join(alphabet[i] for i in rng.integers(0, len(alphabet),
                                                     ref_len))
    qs = []
    for k in range(n):
        ln = int(rng.integers(lo, hi))
        if k % 4 == 3:
            qs.append("".join(alphabet[i] for i in rng.integers(
                0, len(alphabet), ln)))
            continue
        s = int(rng.integers(0, ref_len - ln))
        q = _mutate(rng, ref[s:s + ln], alphabet, 0.06)
        qs.append(q[::-1] if k % 7 == 5 else q)
    qs[0] = qs[0].lower()
    qs[1] = qs[1][:5] + "J" + qs[1][6:]
    return ref, qs


@pytest.mark.parametrize("seed,kind", [
    (0, "dna"), (1, "dna"), (2, "dna_stored"), (3, "protein"),
    (4, "fallback"), (5, "filters"), (6, "scores")])
def test_seeded_batches_equal_jax(seed, kind):
    rng = np.random.default_rng(100 + seed)
    if kind == "protein":
        ref, qs = _seeded(seed, AA_ORDER[:20], 300, 12, 8, 90)
        a = Twin(score_matrix=BLOSUM50, translation_matrix=AA_TABLE,
                 gap_opening_penalty=10, gap_extending_penalty=2)
    else:
        ref, qs = _seeded(seed, "ACGT", 500, 16, 1, 140)
        a = {"fallback": lambda: Twin(2, 2, 1, 2),
             "scores": lambda: Twin(1, 3, 5, 2)}.get(kind, Twin)()
    masks = [int(m) for m in rng.integers(0, 60, len(qs))]
    filt = api.Filter()
    if kind == "filters":
        filt = api.Filter(report_begin_position=False, report_cigar=False)
        a.align_batch(qs, ref, api.Filter(score_filter=40), masks)
        a.align_batch(qs, ref, api.Filter(distance_filter=25), masks)
        a.align_batch(qs, ref, api.Filter(report_cigar=False), 15)
    if kind == "dna_stored":
        assert a.set_reference_sequence(ref) == len(ref)
        flags, als = a.align_batch(qs, None, filt, masks)
    else:
        flags, als = a.align_batch(qs, ref, filt, masks)
    assert len(als) == len(qs) and any(x.sw_score > 0 for x in als)
    for q, m in list(zip(qs, masks))[:3]:
        a.align(q, None if kind == "dna_stored" else ref, filt, m)


def test_gap_open_le_extend_takes_the_fallback(monkeypatch):
    """gapO <= gapE runs the per-pair striped oracle in both packages."""
    calls = []
    real = pipeline.pipeline_fallback
    monkeypatch.setattr(pipeline, "pipeline_fallback",
                        lambda req: calls.append(req) or real(req))
    ref, qs = _seeded(9, "ACGT", 300, 6, 20, 80)
    Twin(2, 2, 1, 1).align_batch(qs, ref)
    assert len(calls) == 1


@pytest.mark.parametrize("score_size,want_none", [(0, True), (1, False),
                                                  (2, False)])
def test_score_size_overflow_equals_jax(score_size, want_none):
    """score_size 0 and a score past the byte range: None, as the C API
    returns NULL (ref: src/ssw.c:887-891); the word tiers do not."""
    mat = dna_matrix(2, 2)
    read = np.zeros(200, np.int8)
    ref = np.zeros(300, np.int8)
    got = api.align(read, ref, 3, 1, mat=mat, score_size=score_size,
                    device="cpu")
    want = japi.align(read, ref, 3, 1, mat=mat, score_size=score_size,
                      backend="scan")
    assert (got is None) == want_none and _plain(got) == _plain(want)
    reads = [read, read[:50], np.array([0, 1, 2, 3] * 30, np.int8)]
    got = api.align_batch(reads, ref, mat, 3, 1, score_size=score_size,
                          mask_len=[15, 20, 30], device="cpu")
    want = japi.align_batch(reads, ref, mat, 3, 1, score_size=score_size,
                            mask_len=[15, 20, 30], backend="scan")
    assert _plain(got) == _plain(want)


def test_stored_reference_is_uploaded_once(monkeypatch):
    """Aligner keeps one translated reference, so the pipeline's device
    copy (cached by the host array's identity) is made once for every
    align against it."""
    a = api.Aligner(device="cpu")
    a.set_reference_sequence(REF * 3)
    stored = a._reference
    seen = []
    real = pipeline._device_ref

    def spy(ref_np, *args):
        t = real(ref_np, *args)
        seen.append((ref_np, t))
        return t

    monkeypatch.setattr(pipeline, "_device_ref", spy)
    for _ in range(3):
        _, al = a.align(READ)
        assert al.sw_score == 21
    assert a._reference is stored and len(seen) == 3
    assert all(r is stored and t is seen[0][1] for r, t in seen)
