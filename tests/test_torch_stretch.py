"""The split target of the packed wavefront (ops/pack.py stretches,
csrc/sw_wave_packed.cu): the rule that chooses the stretches, the waves
that count the split launch's blocks, and the plain twin run stretch by
stretch against itself run whole, on inputs built around the stretch
boundaries.  The kernel against the twin is in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from ssw_tpu_torch import pipeline
from ssw_tpu_torch.core.encoding import dna_matrix
from ssw_tpu_torch.ops import common, cuda_sw, pack, scan_sw

ION_LEN = 4_938_920  # the Ion Torrent headline's genome
H100_SMS = 132


def _mat22():
    return dna_matrix(2, 2)


# -- the rule -----------------------------------------------------------------

# The Ion Torrent headline's five leaves: (reads, lanes per warp).
ION_LEAVES = [(62, 448), (177, 320), (281, 256), (293, 192), (187, 128)]


def _wpb(lanes):
    """Warps per block of the packed wavefront's variant (sw_wave.cuh
    launch_shape: four unless four profiles pass 48 KB)."""
    return 2 if lanes >= 448 else 4


@pytest.mark.parametrize("B,L", ION_LEAVES)
def test_rule_splits_ion_leaves(B, L):
    """Each Ion leaf is far below the fill on an H100: it splits, and its
    warps reach the fill target unless the halo cap stops them first."""
    halo = pack.stretch_halo(L, 2, 3, 1)
    P = pack.stretch_rule(B, _wpb(L), H100_SMS, ION_LEN, halo)
    assert P > 1
    _, C = pack.stretch_bounds(ION_LEN, P)
    assert C >= pack.STRETCH_HALOS * halo
    capped = pack.stretch_bounds(ION_LEN, P + 1)[1] < \
        pack.STRETCH_HALOS * halo
    assert B * P >= pack.STRETCH_FILL * H100_SMS or capped
    assert B * (P - 1) < pack.STRETCH_FILL * H100_SMS


def test_rule_keeps_full_launches_whole():
    """A launch with a block on every SM (Illumina's and the 10 Mbp
    cell's 1,024-read leaves), any launch off a card, and a launch of no
    reads run the whole target in one warp per read."""
    assert pack.stretch_rule(1024, 4, H100_SMS, 1 << 20, 1024) == 1
    assert pack.stretch_rule(1024, 4, H100_SMS, 10 ** 7, 1024) == 1
    assert pack.stretch_rule(4 * H100_SMS, 4, H100_SMS, 10 ** 7, 1024) == 1
    assert pack.stretch_rule(2 * H100_SMS, 2, H100_SMS, 10 ** 7, 1024) == 1
    assert pack.stretch_rule(62, 2, 0, ION_LEN, 2304) == 1
    assert pack.stretch_rule(0, 4, H100_SMS, ION_LEN, 2304) == 1
    # one block short of every SM: split to the fill
    B = 4 * H100_SMS - 4
    P = pack.stretch_rule(B, 4, H100_SMS, 10 ** 7, 1024)
    assert P == -(-pack.STRETCH_FILL * H100_SMS // B)


def test_rule_halo_cap():
    """Short targets split no further than C >= STRETCH_HALOS * halo."""
    halo = pack.stretch_halo(448, 2, 3, 1)
    assert pack.stretch_rule(1, 2, H100_SMS, 64 * halo - 1, halo) == 1
    P = pack.stretch_rule(1, 2, H100_SMS, 3 * 64 * halo, halo)
    assert P == 3
    assert pack.stretch_bounds(3 * 64 * halo, P)[1] >= 64 * halo


@pytest.mark.parametrize("vl,P", [(1, 1), (700, 8), (4_938_920, 18),
                                  (5000, 3), (10 ** 7, 2), (256 * 7, 7)])
def test_stretches_on_blocks(vl, P):
    """Stretch starts fall on 256-column blocks, no stretch is empty, and
    the stretches own each column below valid_len once."""
    P2, C = pack.stretch_bounds(vl, P)
    assert 1 <= P2 <= P and C % scan_sw.BM == 0 and (P2 - 1) * C < vl
    halo = pack.stretch_halo(192, 2, 3, 1)
    spans = pack.stretch_spans(vl, P2, C, halo)
    assert spans[0][1] == 0 and spans[-1][2] == vl
    assert all(a[2] == b[1] for a, b in zip(spans[:-1], spans[1:]))
    for first, own, end in spans:
        assert own < end
        assert own % scan_sw.BM == 0 and first % scan_sw.BM == 0
        assert first == max(own - halo, 0)


@pytest.mark.parametrize("L,mat,gapO,gapE", [
    (448, dna_matrix(2, 2), 3, 1), (128, dna_matrix(2, 2), 3, 1),
    (192, dna_matrix(1, 3), 5, 2), (576, dna_matrix(2, 4), 3, 1)])
def test_halo_covers_restart_margin(L, mat, gapO, gapE):
    """The halo is at least the streaming re-runs' restart margin, in whole
    blocks."""
    halo = pack.stretch_halo(L, int(np.abs(mat).max()), gapO, gapE)
    assert halo >= pipeline._restart_margin(L, mat, gapO, gapE)
    assert halo % scan_sw.BM == 0


def test_packed_launch_off_card(monkeypatch):
    """Off a card the launch is the whole target, whatever the rule would
    answer on a card."""
    cpu = torch.device("cpu")
    whole = (1, pack.stretch_bounds(ION_LEN, 1)[1], 0, 16)
    assert cuda_sw.packed_launch(62, 448, 6, ION_LEN, 2, 3, 1, False, True,
                                 cpu) == whole
    monkeypatch.setattr(pack, "stretch_rule", lambda *a: 8)
    assert cuda_sw.packed_launch(62, 448, 6, ION_LEN, 2, 3, 1, False, True,
                                 cpu) == whole


# -- the waves ----------------------------------------------------------------

def test_forward_waves_split_blocks():
    """The Ion leaves split by the rule (two warps a block at K = 14, four
    below): each has a block per SM or more, so each is a wave of its own,
    longest lanes first; unsplit they shared two waves."""
    leaves = []
    for B, L in ION_LEAVES:
        P = pack.stretch_rule(B, _wpb(L), H100_SMS, ION_LEN,
                              pack.stretch_halo(L, 2, 3, 1))
        leaves.append((-(-B * P // _wpb(L)), L))
    assert all(blocks >= H100_SMS for blocks, _ in leaves)
    assert pipeline._forward_waves(leaves, H100_SMS) == [[0], [1], [2],
                                                          [3], [4]]
    unsplit = [(-(-B // 4), L) for B, L in ION_LEAVES]
    assert pipeline._forward_waves(unsplit, H100_SMS) == [[0, 1, 2],
                                                           [3, 4]]
    # beside a small unsplit leaf; the CPU: one wave in the plan's order
    assert pipeline._forward_waves([(264, 128), (3, 64)], H100_SMS) == [
        [0], [1]]
    assert pipeline._forward_waves(leaves, 0) == [[0, 1, 2, 3, 4]]


def test_forward_blocks_mirror_the_launch(monkeypatch):
    """_forward_blocks asks cuda_sw.packed_launch with the arguments the
    leaf's packed forward gives the wrapper."""
    rng = np.random.default_rng(5)
    ref = rng.integers(0, 4, 3000).astype(np.int8)
    reads = [ref[s:s + ln].copy() for s, ln in
             zip(rng.integers(0, 2000, 70), rng.integers(150, 190, 70))]
    req = pipeline.BatchRequest(reads=reads, ref=ref, mat=_mat22(), gapO=3,
                                gapE=1, flag=0, filters=0, filterd=0,
                                mask_len=15, score_size=2)
    seen = []

    def fake(B, slot_max, n1, valid_len, max_sub, gapO, gapE, quirk, dual,
             dev, gate=None, scan_body=False):
        seen.append((B, slot_max, n1, valid_len, max_sub, gapO, gapE,
                     quirk, dual, gate))
        return 4, 768, 1280, 71

    monkeypatch.setattr(pipeline, "STREAM_SUBOPT", True)
    monkeypatch.setattr(cuda_sw, "packed_launch", fake)
    st = pipeline._leaf_prepare(req, torch.device("cpu"), True)
    assert st.plan is not None
    assert pipeline._forward_blocks(st) == 71
    assert seen == [(70, int(st.plan.slot_len.max()), 6, 3000, 2, 3, 1,
                     False, st.dual, None)]


# -- the plain twin split against itself whole --------------------------------

def stretch_case(P, mode, seed=0, dev="cpu", lanes=None, vl=5077):
    """Packed inputs and keyword arguments of forward_shared_packed whose
    reads sit on the boundaries of P stretches (pack.stretch_bounds over
    valid_len): a hit straddling the first boundary; one ending in the
    first owned column after the second boundary's halo; the same segment
    at equal scores in stretches 0 and 1 (the lower column wins); a
    deletion of 100 columns up to the first boundary; a hit running into
    valid_len (default 5,077), which ends inside the last stretch and
    inside a block, with real target codes past it; reads whose lengths leave slot pad rows
    (which feed the byte tier's block maxima) and random reads.  mode:
    "blockmax", "dual" or "quirk" (dna_matrix(2, 4), the word geometry).
    lanes: add a read across the second boundary whose slot makes the
    kernel's lanes per warp `lanes` (the other reads fit in 128).
    Returns (args, kwargs, gapO, gapE)."""
    rng = np.random.default_rng(seed)
    quirk = mode == "quirk"
    mat = dna_matrix(2, 4) if quirk else _mat22()
    n = mat.shape[0]
    R = vl + 300
    ref = rng.integers(0, n - 1, R).astype(np.int32)
    P2, C = pack.stretch_bounds(vl, P)
    b1 = C if P2 > 1 else vl // 3
    b2 = 2 * C if P2 > 2 else 2 * vl // 3
    seg = rng.integers(0, n - 1, 90).astype(np.int32)
    ref[300:390] = seg
    ref[b1 + 300:b1 + 390] = seg
    h = 70 if lanes is None else 50  # the gap read's halves
    long = 143 if lanes is None else 111
    reads = [
        ref[b1 - 60:b1 + 41].copy(),                       # straddles b1
        ref[b2 - 98:b2 + 1].copy(),                        # ends at b2
        seg.copy(),                                        # tie: 389 wins
        np.concatenate([ref[b1 - 2 * h - 30:b1 - h - 30],
                        ref[b1:b1 + h]]),                  # gap up to b1
        ref[vl - 83:vl - 83 + long].copy(),                # into valid_len
        ref[b2 - 40:b2 + 71].copy(),
        rng.integers(0, n - 1, 17).astype(np.int32),
        rng.integers(0, n - 1, long).astype(np.int32),
        ref[b1 - 5:b1 + 1].copy(),
    ]
    if lanes is not None:
        w = lanes - 12
        reads.append(ref[b2 - w // 2:b2 - w // 2 + w].copy())
    for r in reads[4:6]:  # a few substitutions
        m = rng.random(len(r)) < 0.02
        r[m] = rng.integers(0, n - 1, int(m.sum()))
    read_len = np.array([len(r) for r in reads], np.int32)
    word = quirk
    L = common.bucket_size(common.pad_total(int(read_len.max()), False), 64)
    rp = common.pad_reads(reads, L, n)
    slot_len = ((read_len + 7) // 8 * 8 if word
                else (read_len + 15) // 16 * 16).astype(np.int32)
    plan = common.pack_plan(slot_len, 512 if L <= 256 else 2048)
    so, sl, rl_s = common.pack_tables(plan, read_len)
    if lanes is not None:
        assert pack.packed_lanes(int(sl.max())) == lanes
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)
    args = (t(common.build_profile(common.pack_codes(plan, rp, n), None,
                                   common.extend_matrix(mat))),
            t(ref), t(so), t(sl), t(rl_s),
            t((plan.row * plan.S + plan.slot).astype(np.int32)))
    kw = dict(max_sub=int(np.abs(mat).max()), valid_len=vl, quirk=quirk,
              word=word, dual=mode == "dual")
    return args, kw, 3, 1


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("mode", ["blockmax", "dual", "quirk"])
def test_twin_split_equals_whole(mode):
    args, kw, gapO, gapE = stretch_case(3, mode)
    whole = scan_sw.forward_shared_ref_packed(*args, gapO, gapE, **kw)
    split = scan_sw.forward_shared_ref_packed(*args, gapO, gapE, **kw,
                                              stretches=3)
    _same(split, whole)
    score, end_ref = whole[0], whole[1]
    # the inputs do what they are built for: the tie goes to the lower
    # column, and the hits sit where the stretches part
    vl = kw["valid_len"]
    _, C = pack.stretch_bounds(vl, 3)
    assert int(end_ref[2]) == 389 and int(score[2]) == 180
    assert int(end_ref[1]) == 2 * C
    assert int(end_ref[0]) == C + 40
    assert int(end_ref[3]) == C + 69 and int(score[3]) == 4 * 70 - 102
    assert int(end_ref[4]) == vl - 1 or int(end_ref[4]) > vl - 20


def test_twin_whole_target_matches_pallas():
    """The twin run whole, which the split runs are held to, is the JAX
    package's plain packed forward on the same inputs (the dual mode: both
    channels of block maxima): the restructured scan still computes every
    column.  A shorter target than the other cases: the JAX version runs
    interpreted."""
    import jax.numpy as jnp

    from ssw_tpu.ops import pallas_sw

    args, kw, gapO, gapE = stretch_case(3, "dual", seed=1, vl=1333)
    got = scan_sw.forward_shared_ref_packed(*args, gapO, gapE, **kw,
                                            stretches=1)
    a = [x.numpy() for x in args]
    want = pallas_sw.forward_shared_ref_packed(
        jnp.asarray(a[0]), jnp.asarray(a[1]), *a[2:], gapO, gapE, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
