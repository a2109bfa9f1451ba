"""The port's bounded-radius gate against the JAX package's.

The gate lets a column of the forward DP stop its lazy-F prefix-max scan
short of the whole row when no F carry can travel further (ops/gate.py; the
TPU kernel's gate, pallas_sw.py:314-359).  It changes no output.  Here, on
the CPU, the plain model of the gated scan (ops/scan_sw.py: the kernels'
thread layout, m of the 5 shuffle steps per column, the depth chosen from
the previous column's masked max) stands in for the CUDA kernels, and is
held against the JAX package: its gate_plan, its Pallas kernel with the
gate (interpret mode, with SSW_TPU_GATESCAN / SSW_TPU_GATE2 set through
monkeypatch, as tests/test_gatescan.py runs it), its scan baseline, and its
pipeline and CLI.  Integer DP: every output must be exactly equal
(tolerance 0).  Inputs come from numpy seeds at tests/test_gatescan.py's
sizes, plus hot reads with a read-side insertion that a gate opening too
freely gets wrong (the negative control shows that it does)."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssw_tpu import cli as jax_cli
from ssw_tpu import pipeline as jax_pipeline
from ssw_tpu.core.cigar import cigar_to_string
from ssw_tpu.ops import pallas_sw
from ssw_tpu.ops import scan_sw as jax_scan
from ssw_tpu_torch import cli, pipeline
from ssw_tpu_torch.ops import common, cuda_sw, gate, pack, scan_sw

FWD = ("score", "end_ref", "end_read", "maxcol")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain DP here runs small tensors, on which torch's thread pool
    gains nothing and only competes with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _eq(want, got, names=FWD):
    assert len(want) == len(got)
    for w, g, name in zip(want, got, names):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                      _t(g).numpy().astype(np.int64),
                                      err_msg=name)


def _dna_mat(match=2, mismatch=2):
    mat = np.zeros((5, 5), np.int8)
    for i in range(4):
        for j in range(4):
            mat[i, j] = match if i == j else -mismatch
    return mat


INS = ((60, 91), (33, 65))     # prefix and insertion lengths (half-open)
INS_TIGHT = ((28, 33), (33, 46))


def _reads(rng, ref, read_len, hot, ins, lens=INS):
    """test_gatescan.py's hot reads (exact copies of the target) and cold
    (random) ones; with ins, the hot reads after the first carry a
    read-side insertion (lens[1] random bases) after a prefix of lens[0]
    target bases, so the best path carries F across it."""
    R = len(ref)
    reads = []
    for i, ln in enumerate(read_len):
        ln = int(ln)
        if i >= hot:
            reads.append(rng.integers(0, 4, ln).astype(np.int32))
            continue
        off = int(rng.integers(0, R - ln))
        r = ref[off:off + ln].copy()
        if ins and i % 2:
            a, n = int(rng.integers(*lens[0])), int(rng.integers(*lens[1]))
            r = np.concatenate([ref[off:off + a],
                                rng.integers(0, 4, n).astype(np.int32),
                                ref[off + a:off + ln - n]])
        reads.append(r)
    return reads


def _mk_args(seed, R=1024, L=256, hot=2, cold=6, mat=None, ins=False,
             word=False, lens=INS):
    """tests/test_gatescan.py's _mk_args (hot reads 150-220 bp, cold 20-120
    bp), as (numpy arrays, R); ins: see _reads."""
    rng = np.random.default_rng(seed)
    mat_ext = common.extend_matrix(_dna_mat() if mat is None else mat)
    ref = rng.integers(0, 4, R).astype(np.int32)
    read_len = np.concatenate([
        rng.integers(150, 220, hot), rng.integers(20, 120, cold)
    ]).astype(np.int32)
    reads = _reads(rng, ref, read_len, hot, ins, lens)
    rp = common.pad_reads(reads, L, 5 if mat is None else mat.shape[0])
    prof = common.build_profile(rp, read_len, mat_ext)
    geo = common.batch_geometry(read_len, L, word=word)
    return (prof, ref, read_len, geo.col_mask, geo.seg_id, geo.seg_start), R


def _jax(args):
    return tuple(jnp.asarray(a) for a in args)


def _port(args):
    return tuple(_t(a) for a in args)


def _card(L, gapO, gapE, max_sub):
    return gate.card_thresholds(L // 32, L, gapO, gapE, max_sub)


def _plan(L, gapO, gapE, max_sub, mode="force", gate2=False, bound=None,
          K=None, monkeypatch=None):
    monkeypatch.setattr(gate, "GATESCAN", mode)
    monkeypatch.setattr(gate, "GATE2", gate2)
    return gate.plan_thresholds(K or L // 32, L, gapO, gapE, max_sub, bound)


# ------------------------------------------------------------- gate_plan


GRID = [(L, gO, gE, ms, pb)
        for L in (64, 128, 256, 4096)
        for gO, gE in ((3, 1), (5, 2), (10, 10), (5, 3), (11, 1))
        for ms in (None, 2, 3, 5, 15)
        for pb in (None, 64, 128, 256)]


@pytest.mark.parametrize("mode,gate2", [(m, g) for m in ("1", "0", "force")
                                        for g in (False, True)])
def test_gate_plan_matches_jax(mode, gate2, monkeypatch):
    """gate_plan and gate_sub_for equal the JAX package's on a grid of (L,
    gapO, gapE, max_sub, pack_bound) under every switch setting; the grid
    holds every case of test_gatescan.py's test_gate_threshold_guards,
    test_gate_plan_tiers and test_gate_noise_autodisable."""
    monkeypatch.setenv("SSW_TPU_GATESCAN", mode)
    monkeypatch.setenv("SSW_TPU_GATE2", "1" if gate2 else "0")
    monkeypatch.setattr(gate, "GATESCAN", mode)
    monkeypatch.setattr(gate, "GATE2", gate2)
    on = 0
    for L, gO, gE, ms, pb in GRID:
        want = pallas_sw.gate_plan(L, gO, gE, ms, pack_bound=pb)
        assert gate.gate_plan(L, gO, gE, ms, pack_bound=pb) == want, (
            L, gO, gE, ms, pb)
        assert (gate.gate_sub_for(L, gO, gE, ms)
                == pallas_sw.gate_sub_for(L, gO, gE, ms))
        on += want[0] is not None
    assert (on > 0) == (mode != "0")
    # the values test_gatescan.py pins
    if mode == "1" and not gate2:
        assert gate.gate_plan(256, 5, 2, 3) == (3, (64,))
        assert gate.gate_plan(256, 3, 1, 2) == (None, ())
        assert gate.gate_sub_for(256, 10, 10, 15) == 15
    if mode == "force" and gate2:
        assert gate.gate_plan(256, 5, 3, 15) == (15, (128,))
        assert gate.gate_plan(4096, 3, 1, 2, pack_bound=256) == (2, (64, 128))


def test_thresholds(monkeypatch):
    """The card's tiers (thr[m] = gapO + 2^m*K*gapE - max_sub, off where
    2^m*K covers the span or thr <= 0, made non-decreasing) and the JAX
    plan's radii mapped to the least depth that covers r - 1 lanes."""
    assert gate.card_thresholds(8, 256, 5, 2, 3) == (18, 34, 66, 130, 258)
    assert gate.card_thresholds(4, 128, 3, 1, 2) == (5, 9, 17, 33, 65)
    N = gate.NEG
    # BLOSUM50 (15) at o3e1, K = 8: depth 0 has no positive threshold
    assert gate.card_thresholds(8, 256, 3, 1, 15) == (N, 4, 20, 52, 116)
    # a 60-lane packed span at K = 4: depth 4 (64 lanes >= 60) off
    assert gate.card_thresholds(4, 60, 3, 1, 2)[4] == 33
    assert gate.card_thresholds(8, 256, 3, 1, None) is None
    assert gate.card_thresholds(4, 128, 1, 1, 80) is None
    # radius 64 at K = 8 -> depth 3 (64 >= 63), threshold 5 + 63*2 - 48
    assert _plan(256, 5, 2, 3, "1", monkeypatch=monkeypatch) == (
        N, N, N, 83, 83)
    assert _plan(256, 3, 1, 2, "1", monkeypatch=monkeypatch) is None
    assert _plan(256, 3, 1, 2, monkeypatch=monkeypatch) == (N, N, N, 34, 34)
    assert _plan(256, 3, 1, 2, gate2=True, monkeypatch=monkeypatch) == (
        N, N, N, 34, 98)
    # packed, slot bound 128 at W = 1024: K = 4 covers 63 lanes at depth 4,
    # K = 2 at no depth below 5
    assert _plan(1024, 3, 1, 2, bound=128, K=4, monkeypatch=monkeypatch) == (
        N, N, N, N, 34)
    assert _plan(1024, 3, 1, 2, bound=128, K=2,
                 monkeypatch=monkeypatch) is None
    assert _plan(4096, 3, 1, 2, bound=64, K=2,
                 monkeypatch=monkeypatch) is None


@pytest.mark.parametrize("case", [
    "int32_o5e2_L4096", "int32_quirk_blosum", "int32_x20", "int16_default",
    "packed_default",
])
def test_gate_rule_cases(case, monkeypatch):
    """pipeline._gate by GATE for a launch of each kind: None (the card's
    rule) gates none, not even the int32 launch at -o5 -e2 past the int16
    bound that the rule before the int32 wavefront gated with the card's
    tiers (where gate_plan's noise test passes); "tiers" takes the card's
    tiers, True the JAX plan, False nothing."""
    L, gapO, gapE, max_sub, slot_max = {
        "int32_o5e2_L4096": (4096, 5, 2, 3, None),
        "int32_quirk_blosum": (256, 10, 1, 15, None),
        "int32_x20": (320, 60, 20, 40, None),
        "int16_default": (128, 3, 1, 2, None),
        "packed_default": (1024, 3, 1, 2, 112),
    }[case]
    K = (L if slot_max is None else pack.packed_lanes(slot_max)) // 32
    span = L if slot_max is None else slot_max
    bound = None if slot_max is None else pack.pack_bound(slot_max)
    for forced, want in (
            (None, None), (False, None),
            ("tiers", gate.card_thresholds(K, span, gapO, gapE, max_sub)),
            (True, gate.plan_thresholds(K, L, gapO, gapE, max_sub, bound))):
        monkeypatch.setattr(pipeline, "GATE", forced)
        assert pipeline._gate(L, gapO, gapE, max_sub, slot_max) == want
    if case == "int32_o5e2_L4096":
        assert gate.card_thresholds(K, span, gapO, gapE, max_sub)
        assert not cuda_sw.i16_exact(L, gapO, gapE, max_sub, False)


def test_col_mask_is_a_prefix():
    """The gate's sample is over col_mask lanes and is exact only if they
    are a prefix of every row: batch_geometry (both tiers), the pipeline's
    mixed-tier _prep_core, and every packed slot (pack_geometry)."""
    rng = np.random.default_rng(4)
    read_len = rng.integers(0, 500, 200).astype(np.int32)
    L = 512

    def prefix(cm):
        cm = np.asarray(cm, bool)
        n = cm.sum(axis=1)
        return np.array_equal(cm, np.arange(cm.shape[1])[None, :]
                              < n[:, None])

    for word in (False, True):
        assert prefix(common.batch_geometry(read_len, L, word).col_mask)
    reads = _t(common.pad_reads([np.zeros(n, np.int32) for n in read_len],
                                L, 4)).to(torch.int8)
    mat = _t(common.extend_matrix(_dna_mat())).to(torch.int8)
    for col_word in (rng.random(200) < 0.5, np.zeros(200, bool)):
        cm = pipeline._prep_core(reads, _t(read_len), mat, _t(col_word),
                                 _t(col_word), L)[1]
        assert prefix(cm.numpy())
    slot_len = np.where(rng.random(200) < 0.5, (read_len + 7) // 8 * 8,
                        (read_len + 15) // 16 * 16).astype(np.int32)
    plan = common.pack_plan(slot_len, 2048)
    so, sl, rl = common.pack_tables(plan, read_len)
    cm = pack.pack_geometry(_t(so), _t(sl), _t(rl), plan.L)[0].numpy()
    for r in range(plan.n_rows):
        for s in range(plan.S):
            o, n = int(so[r, s]), int(sl[r, s])
            assert cm[r, o:o + n].all()


# ---------------------------------------------------- the gated plain model


def _model(args, gapO, gapE, quirk, thr, **kw):
    return scan_sw.forward_shared_ref(*_port(args), gapO, gapE, quirk,
                                      gate=thr, steps=True, **kw)


@pytest.mark.parametrize("mode", ["base", "dual"])
def test_gated_model_matches_pallas(mode, monkeypatch):
    """The JAX plan's radius-64 tier forced: the port's gated model (the
    plan's thresholds and the card's tiers) equals the Pallas kernel with
    its gate and the scan baseline; base mode on tests/test_gatescan.py's
    hot/cold input, dual mode (whose byte channel is the blockmax mode's)
    on the insertion input."""
    monkeypatch.setenv("SSW_TPU_GATESCAN", "force")
    args, R = _mk_args(3 if mode == "base" else 11, ins=mode == "dual")
    base = jax_scan.forward_shared_ref(*_jax(args), 3, 1, False)
    kw = {}
    if mode == "dual":
        vl = R - 100
        wm = jax_pipeline._word_mask(jnp.asarray(args[2]), 256)
        kw = dict(blockmax=True, valid_len=vl)
    want = pallas_sw.forward_shared_ref(
        *_jax(args), 3, 1, False, max_sub=2,
        **(dict(kw, wmask=wm) if kw else {}))
    if mode == "dual":
        _eq(base[:3] + (jax_scan.blockmax_reduce(base[3], vl),),
            want[:3] + (want[3][:, 0],))
        kw["wmask"] = _t(np.asarray(wm))
    else:
        _eq(base, want)
    for thr in (_plan(256, 3, 1, 2, monkeypatch=monkeypatch),
                _card(256, 3, 1, 2)):
        got, steps = _model(args, 3, 1, False, thr, **kw)
        _eq(want, got)
        assert steps[:5].sum() > 0 and steps.sum() == 8 * R


@pytest.mark.parametrize("case", ["hot_cold", "insertions", "all_cold",
                                  "wide_only", "m1x3o5e2", "blosum50"])
@pytest.mark.parametrize("quirk", [False, True])
def test_gated_model_matches_scan(case, quirk, monkeypatch):
    """Every mode (base, blockmax, dual with the quirk off), both the card's
    tiers and the JAX plan's forced thresholds (with the wide tier for
    max_sub = 5), on test_gatescan.py's inputs and the insertion input:
    equal to the JAX package's scan baseline."""
    from ssw_tpu_torch.core.encoding import BLOSUM50
    mat, gO, gE = {"m1x3o5e2": (_dna_mat(1, 3), 5, 2),
                   "wide_only": (_dna_mat(5, 5), 3, 1),
                   "blosum50": (BLOSUM50, 10, 2)}.get(case,
                                                      (_dna_mat(), 3, 1))
    ms = int(np.abs(mat).max())
    hot = 0 if case == "all_cold" else 2
    if case == "blosum50":
        rng = np.random.default_rng(8)
        R, L = 700, 256
        ref = rng.integers(0, 23, R).astype(np.int32)
        read_len = rng.integers(30, 240, 6).astype(np.int32)
        reads = [ref[s:s + n].copy() if i % 2 else
                 rng.integers(0, 23, n).astype(np.int32)
                 for i, (n, s) in enumerate(zip(read_len,
                                                rng.integers(0, 450, 6)))]
        geo = common.batch_geometry(read_len, L, word=False)
        args = (common.build_profile(common.pad_reads(reads, L, 24),
                                     read_len, common.extend_matrix(mat)),
                ref, read_len, geo.col_mask, geo.seg_id, geo.seg_start)
    else:
        args, R = _mk_args(17 + len(case), hot=hot, cold=8 - hot,
                           mat=None if case in ("hot_cold", "insertions",
                                                "all_cold") else mat,
                           ins=case in ("insertions", "m1x3o5e2"))
    want = jax_scan.forward_shared_ref(*_jax(args), gO, gE, quirk)
    vl = R - 37
    want_bm = jax_scan.blockmax_reduce(want[3], vl)
    thrs = [_card(256, gO, gE, ms),
            _plan(256, gO, gE, ms, gate2=case in ("wide_only", "blosum50"),
                  monkeypatch=monkeypatch)]
    assert all(t is not None for t in thrs)
    rl = _t(args[2])
    wm = (torch.arange(256)[None, :] < (rl[:, None] + 7) // 8 * 8)
    opened = 0
    for thr in thrs:
        got, steps = _model(args, gO, gE, quirk, thr)
        _eq(want, got)
        opened += int(steps[:5].sum())
        got, _ = _model(args, gO, gE, quirk, thr, blockmax=True,
                        valid_len=vl)
        _eq(want[:3] + (want_bm,), got)
        if not quirk:  # dual: channel 0 is blockmax, both as ungated
            got, _ = _model(args, gO, gE, quirk, thr, blockmax=True,
                            valid_len=vl, wmask=wm)
            _eq(want[:3] + (want_bm,), got[:3] + (got[3][:, 0],))
            _eq(scan_sw.forward_shared_ref(*_port(args), gO, gE, False,
                                           blockmax=True, valid_len=vl,
                                           wmask=wm), got)
    assert opened > 0


def test_gated_model_int16_pairs():
    """The int16 tier's warps hold two reads: one depth per pair, from the
    larger of the pair's two maxima, one step per pair and column (odd B:
    the last warp holds one read); outputs unchanged."""
    args, R = _mk_args(29, hot=3, cold=4, ins=True)
    thr = _card(256, 3, 1, 2)
    want = jax_scan.forward_shared_ref(*_jax(args), 3, 1, False)
    got, steps = _model(args, 3, 1, False, thr, pairs=True)
    _eq(want, got)
    assert int(steps.sum()) == 4 * R and steps[:5].sum() > 0


def test_negative_control_wrong_gate_differs():
    """The equality tests can fail.  On the insertion input (60-90 base
    prefixes, 33-64 base insertions) a model forced to depth 0 on every
    column (no shuffle step: F reaches the K lanes of the thread before)
    gives a different result.  A model one step shallower than the card's
    rule on every column (thresholds shifted by one depth) gives the same
    result there, since those prefixes score past the rule's thresholds
    with a level to spare; on reads whose prefix scores just under a
    threshold (28-32 base prefixes, 33-45 base insertions at K = 8) it
    differs too.  The card's rule is exact on both."""
    thr = _card(256, 3, 1, 2)
    big = 2 ** 27
    shallower = thr[1:] + (big,)
    for lens, wrong in ((INS, [(big,) * 5]),
                        (INS_TIGHT, [(big,) * 5, shallower])):
        args, R = _mk_args(41, hot=8, cold=0, ins=True, lens=lens)
        want = jax_scan.forward_shared_ref(*_jax(args), 3, 1, False)

        def differs(t):
            got = _model(args, 3, 1, False, t)[0]
            return any(not np.array_equal(np.asarray(w), g.numpy())
                       for w, g in zip(want, got))

        assert not differs(thr)
        for t in wrong:
            assert differs(t), (lens, t)
        if lens == INS:
            assert not differs(shallower)


def test_wrappers_count_plain_steps():
    """On the CPU the wrappers run the gated plain versions: no launch is
    counted, GATED stays 0, and the steps land in gate_steps()."""
    args, R = _mk_args(5)
    cuda_sw.reset_launches()
    cuda_sw.reset_gate_steps()
    thr = _card(256, 3, 1, 2)
    out = cuda_sw.forward_shared(*_port(args), 3, 1, False, max_sub=2,
                                 gate=thr)
    _eq(jax_scan.forward_shared_ref(*_jax(args), 3, 1, False), out)
    steps = cuda_sw.gate_steps()
    assert sum(steps) == 4 * R and sum(steps[:5]) > 0  # int16 pairs
    assert not any(cuda_sw.launch_counts().values())
    assert not any(cuda_sw.gated_counts().values())
    cuda_sw.forward_shared(*_port(args), 3, 1, False)
    assert sum(cuda_sw.gate_steps()) == 4 * R  # ungated: no steps


def _packed(seed, lens, W, mat, word_rows, vl, R=768):
    rng = np.random.default_rng(seed)
    ref = np.full(R, 4, np.int32)
    ref[:vl] = rng.integers(0, 4, vl)
    read_len = np.asarray(lens, np.int32)
    reads = _reads(rng, ref[:vl], read_len, len(lens) // 2, True)
    slot_len = np.where(word_rows, (read_len + 7) // 8 * 8,
                        (read_len + 15) // 16 * 16).astype(np.int32)
    plan = common.pack_plan(slot_len, W)
    rp = common.pad_reads(reads, 256, 4)
    so, sl, rl_s = common.pack_tables(plan, read_len)
    arrs = (common.build_profile(common.pack_codes(plan, rp, 4), None,
                                 common.extend_matrix(mat)),
            ref, so, sl, rl_s, (plan.row * plan.S + plan.slot).astype(
                np.int32))
    return plan, arrs


@pytest.mark.parametrize("case", ["byte_dual", "word_quirk", "mixed_m1x3"])
def test_gated_packed_matches_pallas(case, monkeypatch):
    """Packed rows with the gate: the port's gated model (one warp row per
    slot, as csrc/sw_forward_packed.cu runs them, thresholds against the
    slot bound) equals the JAX package's packed Pallas kernel with its gate
    forced (pack_bound from the slots) on byte slots with the dual tier,
    and the port's ungated model of the packed rows (held against that
    kernel in tests/test_torch_pack.py) on word slots with the quirk and
    on mixed tiers."""
    monkeypatch.setenv("SSW_TPU_GATESCAN", "force")
    quirk = case == "word_quirk"
    mat = {"word_quirk": _dna_mat(2, 4), "mixed_m1x3": _dna_mat(1, 3)}.get(
        case, _dna_mat())
    gO, gE = (5, 2) if case == "mixed_m1x3" else (3, 1)
    rng = np.random.default_rng(61)
    lens = rng.integers(100, 221, 10)
    word_rows = (np.arange(10) % 2 == 0 if case == "mixed_m1x3"
                 else np.full(10, quirk))
    plan, arrs = _packed(len(case), lens, 512, mat, word_rows, 700)
    ms = int(np.abs(mat).max())
    kw = dict(valid_len=700, quirk=quirk, word=bool(word_rows.all()),
              dual=case == "byte_dual")
    if case == "byte_dual":
        want = pallas_sw.forward_shared_ref_packed(
            jnp.asarray(arrs[0]), jnp.asarray(arrs[1]), *arrs[2:], gO, gE,
            max_sub=ms, **kw)
    else:
        want = scan_sw.forward_shared_ref_packed(*_port(arrs), gO, gE,
                                                 max_sub=ms, **kw)
    smax = int(plan.slot_len.max())
    K = pack.packed_lanes(smax) // 32
    for thr in (gate.card_thresholds(K, smax, gO, gE, ms),
                _plan(plan.L, gO, gE, ms, bound=pack.pack_bound(smax), K=K,
                      monkeypatch=monkeypatch)):
        got, steps = scan_sw.forward_shared_ref_packed(
            *_port(arrs), gO, gE, max_sub=ms, gate=thr, steps=True, **kw)
        _eq(want, got)
        assert steps[:5].sum() > 0


# ------------------------------------------------------------ the pipeline


def _batch(seed, n_reads, mat, gapO, gapE, R=1536):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, R).astype(np.int32)
    lens = rng.integers(30, 249, n_reads)
    reads = _reads(rng, ref, lens, n_reads // 2, True)
    for i in range(0, n_reads // 2, 2):  # 5 % substitutions on some hot
        m = rng.random(len(reads[i])) < 0.05
        reads[i][m] = rng.integers(0, 4, int(m.sum()))
    return jax_pipeline.BatchRequest(
        reads=reads, ref=ref, mat=mat, gapO=gapO, gapE=gapE, flag=0x0F,
        mask_len=[max(len(r) // 2, 15) for r in reads])


def _fields(r):
    if r is None:
        return None
    return (r.score1, r.score2, r.ref_begin1, r.ref_end1, r.read_begin1,
            r.read_end1, r.ref_end2, r.flag, cigar_to_string(r.cigar))


@pytest.mark.parametrize("setting", ["m1x3o5e2_stream_pack_dual",
                                     "default"])
def test_pipeline_gate_matches_jax(setting, capsys, monkeypatch):
    """align_batch on the CPU with GATE True (the JAX plan), None (the
    card's rule), "tiers" (the card's tiers everywhere) and False equals
    ssw_tpu.pipeline.align_batch(req, "scan") field by field, with stderr:
    a -m1 -x3 -o5 -e2 batch streaming, packed, with the dual tier, and a
    default-penalty batch (full scan)."""
    if setting == "default":
        req = _batch(7, 20, _dna_mat(), 3, 1)
    else:
        req = _batch(9, 20, _dna_mat(1, 3), 5, 2)
        monkeypatch.setattr(pipeline, "STREAM_SUBOPT", True)
        monkeypatch.setattr(pipeline, "PACK", True)
        monkeypatch.setattr(pipeline, "PACK_L", 512)
        monkeypatch.setenv("SSW_TPU_STREAM_SUBOPT", "1")
    want = jax_pipeline.align_batch(req, "scan")
    err_want = capsys.readouterr().err
    for forced in (True, None, "tiers", False):
        monkeypatch.setattr(pipeline, "GATE", forced)
        cuda_sw.reset_gate_steps()
        got = pipeline.align_batch(pipeline.BatchRequest.from_fields(req),
                                   device="cpu")
        assert capsys.readouterr().err == err_want
        assert [_fields(w) for w in want] == [_fields(g) for g in got]
        steps = cuda_sw.gate_steps()
        # the JAX plan gates at -o5 -e2, not at defaults; the card's rule
        # gates no launch (every ungated launch runs the wavefront)
        gated = forced == "tiers" or (forced is True
                                      and setting != "default")
        assert (sum(steps[:5]) > 0) == gated, (forced, steps)


def test_cli_gate_forced_matches_jax_cli(tmp_path, monkeypatch):
    """The whole CLI with -m1 -x3 -o5 -e2 and the JAX plan's gate
    (GATE = True, GATESCAN = "force"), byte-equal to the JAX package's CLI
    (SAM with header, stderr)."""
    monkeypatch.setattr(pipeline, "GATE", True)
    monkeypatch.setattr(gate, "GATESCAN", "force")
    rng = np.random.default_rng(98)
    R = 1536
    ref = rng.integers(0, 4, R)
    bases = np.array(list("ACGT"))
    (tmp_path / "t.fa").write_text(">t\n" + "".join(bases[ref]) + "\n")
    reads = _reads(rng, ref.astype(np.int32), rng.integers(30, 200, 16), 8,
                   True)
    (tmp_path / "q.fa").write_text("".join(
        f">r{i}\n" + "".join(bases[r]) + "\n" for i, r in enumerate(reads)))
    args = ["-m", "1", "-x", "3", "-o", "5", "-e", "2", "-c", "-s", "-h",
            str(tmp_path / "t.fa"), str(tmp_path / "q.fa")]

    def strip(err):
        return [ln for ln in err.splitlines() if not ln.startswith("CPU")]

    out, err = io.StringIO(), io.StringIO()
    assert jax_cli.main(args, out=out, err=err) == 0
    want = (out.getvalue(), strip(err.getvalue()))
    cuda_sw.reset_gate_steps()
    out, err = io.StringIO(), io.StringIO()
    assert cli.main(args, out=out, err=err, device="cpu") == 0
    assert (out.getvalue(), strip(err.getvalue())) == want
    assert sum(cuda_sw.gate_steps()[:5]) > 0
