"""The hand-written CUDA kernels on the card: built from ssw_tpu_torch/csrc
with nvcc, held exactly against their plain PyTorch versions, and the
pipeline on the card against the pipeline on the CPU.  These need an NVIDIA
card and skip without one; run them on a machine with a card with
`python -m pytest tests/test_torch_cuda.py -m cuda`."""

import numpy as np
import pytest
import torch

from ssw_tpu_torch import pipeline
from ssw_tpu_torch.core.encoding import BLOSUM50, dna_matrix
from ssw_tpu_torch.ops import common, cuda_sw, scan_sw

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


def _inputs(dev, B, L, R, mat, word, seed):
    rng = np.random.default_rng(seed)
    n = mat.shape[0]
    ref = rng.integers(0, n - 1, R).astype(np.int32)
    read_len = rng.integers(L // 3, L - 16, B).astype(np.int32)
    reads = [ref[s:s + ln].copy() if b % 2 else
             rng.integers(0, n - 1, ln).astype(np.int32)
             for b, (ln, s) in enumerate(zip(
                 read_len, rng.integers(0, R - L, B)))]
    rp = common.pad_reads(reads, L, n)
    prof = common.build_profile(rp, read_len, common.extend_matrix(mat))
    geo = common.batch_geometry(read_len, L, word=word)
    arrs = (prof, ref, read_len, geo.col_mask, geo.seg_id, geo.seg_start)
    return tuple(torch.as_tensor(np.ascontiguousarray(a)).to(dev)
                 for a in arrs)


def _equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("L,mat,gapO,gapE,quirk,word", [
    (128, dna_matrix(2, 2), 3, 1, False, False),
    (64, dna_matrix(1, 3), 5, 2, False, True),
    (256, BLOSUM50, 3, 1, True, False),
    (1088, dna_matrix(2, 2), 3, 1, False, False),
])
def test_forward_shared_kernel_equals_plain(card, L, mat, gapO, gapE, quirk,
                                            word):
    args = _inputs(card, 37, L, 1500, mat, word, seed=L)
    before = cuda_sw.launch_counts()["forward_shared"]
    got = cuda_sw.forward_shared(*args, gapO, gapE, quirk)
    assert cuda_sw.launch_counts()["forward_shared"] == before + 1
    _equal(got, scan_sw.forward_shared_ref(*args, gapO, gapE, quirk))


@pytest.mark.parametrize("L,B,mat,gapO,gapE", [
    (128, 37, dna_matrix(2, 2), 3, 1),
    (64, 36, dna_matrix(1, 3), 5, 2),
    (512, 5, dna_matrix(2, 2), 3, 1),
    (1088, 21, dna_matrix(2, 2), 3, 1),
])
def test_forward_shared_i16_kernel_equals_plain(card, L, B, mat, gapO, gapE):
    """The int16 tier (two reads per warp, packed s16x2): odd and even B,
    register and global-row variants."""
    args = _inputs(card, B, L, 1500, mat, False, seed=L + 1)
    max_sub = int(np.abs(mat).max())
    assert cuda_sw.i16_exact(L, gapO, gapE, max_sub, False)
    before = cuda_sw.launch_counts()
    got = cuda_sw.forward_shared(*args, gapO, gapE, False, max_sub=max_sub)
    after = cuda_sw.launch_counts()
    assert after["forward_shared_i16"] == before["forward_shared_i16"] + 1
    assert after["forward_shared"] == before["forward_shared"]
    _equal(got, scan_sw.forward_shared_ref(*args, gapO, gapE, False))


def test_i16_parity_gate_runs_once_uncounted(card):
    cuda_sw._I16_CHECKED.clear()
    before = cuda_sw.launch_counts()
    probes = cuda_sw.parity_counts()["_i16_parity"]
    cuda_sw._i16_parity(card)
    assert cuda_sw.launch_counts() == before
    assert cuda_sw.parity_counts()["_i16_parity"] == probes + 3
    assert card.index in cuda_sw._I16_CHECKED
    cuda_sw._i16_parity(card)
    assert cuda_sw.parity_counts()["_i16_parity"] == probes + 3


@pytest.mark.parametrize("L,B,mat,gapO,gapE,quirk,max_sub", [
    (128, 37, dna_matrix(2, 2), 3, 1, False, 2),      # int16 tier, odd B
    (64, 36, dna_matrix(1, 3), 5, 2, False, 3),       # int16 tier, even B
    (128, 37, dna_matrix(2, 2), 3, 1, False, None),   # int32
    (256, 21, BLOSUM50, 3, 1, True, 5),               # int32, quirk
    (1088, 21, dna_matrix(2, 2), 3, 1, False, 2),     # int16, global rows
    (1088, 13, dna_matrix(2, 2), 3, 1, False, None),  # int32, global rows
])
def test_forward_shared_blockmax_kernel_equals_plain(card, L, B, mat, gapO,
                                                     gapE, quirk, max_sub):
    """Blockmax mode: (B, ceil(R/256)) block maxima over the columns below
    valid_len (1270: not a multiple of 256, and R = 1500 runs past it), and
    the base mode's score/end_ref/end_read on the same inputs."""
    args = _inputs(card, B, L, 1500, mat, False, seed=L + B)
    i16 = cuda_sw.i16_exact(L, gapO, gapE, max_sub, quirk)
    name = cuda_sw.shared_kernel_name(i16, True)
    before = cuda_sw.launch_counts()
    got = cuda_sw.forward_shared(*args, gapO, gapE, quirk, max_sub=max_sub,
                                 blockmax=True, valid_len=1270)
    after = cuda_sw.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {name: 1}
    assert tuple(got[3].shape) == (B, 6)
    _equal(got, scan_sw.forward_shared_ref(*args, gapO, gapE, quirk,
                                           blockmax=True, valid_len=1270))
    assert not got[3][:, 5].any()  # block 5 starts at column 1280 >= 1270
    base = cuda_sw.forward_shared(*args, gapO, gapE, quirk, max_sub=max_sub)
    _equal(got[:3], base[:3])


@pytest.mark.parametrize("terminate,emit", [(False, False), (True, False),
                                            (True, True)])
def test_forward_perread_kernel_equals_plain(card, terminate, emit):
    prof, ref, rl, cm, sid, ss = _inputs(card, 29, 128, 400,
                                         dna_matrix(2, 2), False, seed=3)
    refw = torch.stack([torch.roll(ref[:300], 7 * b) for b in range(29)])
    args = (prof, refw.contiguous(), rl, cm, sid, ss, 3, 1, False)
    term = None
    if terminate:
        term = scan_sw.forward_perread_ref(*args)[0].clone()
        term[::2] = -1
    _equal(cuda_sw.forward_perread(*args, terminate=term, emit_maxcol=emit),
           scan_sw.forward_perread_ref(*args, terminate=term,
                                       emit_maxcol=emit))


def test_pipeline_on_card_equals_cpu(card):
    rng = np.random.default_rng(11)
    ref = rng.integers(0, 4, 3000).astype(np.int8)
    reads = []
    for _ in range(100):
        ln = int(rng.integers(30, 200))
        s = int(rng.integers(0, 3000 - ln))
        r = ref[s:s + ln].copy()
        m = rng.random(ln) < 0.05
        r[m] = rng.integers(0, 4, int(m.sum()))
        reads.append(r)
    req = pipeline.BatchRequest(reads=reads, ref=ref, mat=dna_matrix(2, 2),
                                gapO=3, gapE=1,
                                mask_len=[max(len(r) // 2, 15)
                                          for r in reads])
    cuda_sw.reset_launches()
    got = pipeline.align_batch(req)
    counts = cuda_sw.launch_counts()
    # DNA m2/x2/o3/e1: every forward launch takes the int16 tier
    assert counts["forward_shared_i16"] > 0 and counts["forward_perread"] > 0
    assert counts["forward_shared"] == 0
    want = pipeline.align_batch(req, device="cpu")
    assert [vars(a) for a in got] == [vars(b) for b in want]


def test_streaming_pipeline_on_card_equals_cpu(card, monkeypatch):
    """The streaming suboptimal path on the card (unpacked: the blockmax
    kernels in their dual mode + window re-runs) against the non-streaming
    path on the CPU."""
    rng = np.random.default_rng(12)
    unit = rng.integers(0, 4, 97).astype(np.int8)
    ref = np.concatenate([np.tile(unit, 12),
                          rng.integers(0, 4, 2000).astype(np.int8)])
    reads = [unit.copy() for _ in range(6)]
    for _ in range(60):
        ln = int(rng.integers(30, 200))
        s = int(rng.integers(0, len(ref) - ln))
        r = ref[s:s + ln].copy()
        m = rng.random(ln) < 0.05
        r[m] = rng.integers(0, 4, int(m.sum()))
        reads.append(r)
    req = pipeline.BatchRequest(reads=reads, ref=ref, mat=dna_matrix(2, 2),
                                gapO=3, gapE=1,
                                mask_len=[max(len(r) // 2, 15)
                                          for r in reads])
    monkeypatch.setattr(pipeline, "STREAM_SUBOPT", True)
    monkeypatch.setattr(pipeline, "PACK", False)
    cuda_sw.reset_launches()
    got = pipeline.align_batch(req)
    counts = cuda_sw.launch_counts()
    # reads of 127 bp and more might overflow the byte tier: the dual tier
    assert counts["forward_shared_i16_dual"] > 0
    assert counts["forward_shared_i16"] == counts["forward_shared"] == 0
    monkeypatch.setattr(pipeline, "STREAM_SUBOPT", False)
    want = pipeline.align_batch(req, device="cpu")
    assert [vars(a) for a in got] == [vars(b) for b in want]


def _packed_inputs(dev, lens, W, R, vl, mat, seed, word_rows=None):
    """Reads of the given lengths packed at W lanes, and unpacked."""
    rng = np.random.default_rng(seed)
    n = mat.shape[0]
    ref = np.full(R, n, np.int32)
    ref[:vl] = rng.integers(0, n - 1, vl)
    reads = []
    for b, ln in enumerate(lens):
        s = int(rng.integers(0, max(vl - ln, 1)))
        reads.append(ref[s:s + ln].copy() if b % 2 and ln < vl else
                     rng.integers(0, n - 1, ln).astype(np.int32))
    read_len = np.asarray(lens, np.int32)
    word_rows = (np.zeros(len(lens), bool) if word_rows is None
                 else word_rows)
    L = common.bucket_size(common.pad_total(int(read_len.max()), False), 64)
    rp = common.pad_reads(reads, L, n)
    slot_len = np.where(word_rows, (read_len + 7) // 8 * 8,
                        (read_len + 15) // 16 * 16).astype(np.int32)
    plan = common.pack_plan(slot_len, W)
    so, sl, rl_s = common.pack_tables(plan, read_len)
    mat_ext = common.extend_matrix(mat)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)
    packed = (t(common.build_profile(common.pack_codes(plan, rp, n), None,
                                     mat_ext)), t(ref), t(so), t(sl),
              t(rl_s), t((plan.row * plan.S + plan.slot).astype(np.int32)))
    gb = common.batch_geometry(read_len, L, word=False)
    gw = common.batch_geometry(read_len, L, word=True)
    seg = gw if word_rows.all() else gb
    unpacked = (t(common.build_profile(rp, read_len, mat_ext)), t(ref),
                t(read_len),
                t(np.where(word_rows[:, None], gw.col_mask, gb.col_mask)),
                t(seg.seg_id), t(seg.seg_start))
    return packed, unpacked, t(gw.col_mask)


@pytest.mark.parametrize("W,lens,mat,gapO,quirk,word,dual", [
    (1024, list(range(20, 221, 5)), dna_matrix(2, 2), 3, False, False,
     False),
    (1024, list(range(20, 221, 5)), dna_matrix(2, 2), 3, False, False, True),
    (512, list(range(20, 200, 9)), dna_matrix(2, 4), 3, True, True, False),
    (4096, [1100, 1300, 1499, 0, 1], dna_matrix(2, 2), 3, False, False,
     True),
])
def test_forward_shared_packed_kernel_equals_plain(card, W, lens, mat, gapO,
                                                   quirk, word, dual):
    """The packed kernel (one warp per slot of the packed rows) against its
    plain version, which runs the packed rows, and against the unpacked
    blockmax kernel on the same reads (int32)."""
    packed, unpacked, wmask = _packed_inputs(
        card, lens, W, 768, 700, mat, seed=W,
        word_rows=np.full(len(lens), word))
    kw = dict(max_sub=int(np.abs(mat).max()), valid_len=700, quirk=quirk,
              word=word, dual=dual)
    name = "forward_shared_packed" + ("_dual" if dual else "")
    before = cuda_sw.launch_counts()[name]
    got = cuda_sw.forward_shared_packed(*packed, gapO, 1, **kw)
    assert cuda_sw.launch_counts()[name] == before + 1
    _equal(got, scan_sw.forward_shared_ref_packed(*packed, gapO, 1, **kw))
    unp = cuda_sw.forward_shared(*unpacked, gapO, 1, quirk, blockmax=True,
                                 valid_len=700,
                                 wmask=wmask if dual else None)
    _equal(got, unp)


@pytest.mark.parametrize("L,B,max_sub", [(256, 37, 2), (256, 37, None),
                                         (1088, 9, 2), (1088, 9, None)])
def test_forward_shared_dual_kernel_equals_plain(card, L, B, max_sub):
    """The dual mode of both forward tiers (register and global-row
    variants, odd B): both tiers' block maxima from one pass, the word
    channel equal to the blockmax mode run with the word-tier mask."""
    args = _inputs(card, B, L, 1500, dna_matrix(2, 2), False, seed=L + B)
    rl = args[2]
    j = torch.arange(L, device=card)[None, :]
    wmask = (j < (rl[:, None] + 7) // 8 * 8).contiguous()
    name = cuda_sw.shared_kernel_name(max_sub is not None, True, True)
    before = cuda_sw.launch_counts()[name]
    got = cuda_sw.forward_shared(*args, 3, 1, False, max_sub=max_sub,
                                 blockmax=True, valid_len=1270, wmask=wmask)
    assert cuda_sw.launch_counts()[name] == before + 1
    assert tuple(got[3].shape) == (B, 2, 6)
    _equal(got, scan_sw.forward_shared_ref(*args, 3, 1, False, blockmax=True,
                                           valid_len=1270, wmask=wmask))
    word = cuda_sw.forward_shared(*args[:3], wmask, *args[4:], 3, 1, False,
                                  max_sub=max_sub, blockmax=True,
                                  valid_len=1270)
    _equal((got[3][:, 1].contiguous(),), (word[3],))


def test_packed_dual_pipeline_on_card_equals_cpu(card, monkeypatch):
    """The streaming pipeline with packing forced and the dual tier on the
    card against the re-run route on the CPU."""
    rng = np.random.default_rng(31)
    ref = rng.integers(0, 4, 2048).astype(np.int8)
    reads = []
    for i in range(48):
        ln = int(rng.integers(30, 249))
        s = int(rng.integers(0, 2048 - ln))
        r = ref[s:s + ln].copy() if i % 2 == 0 else rng.integers(
            0, 4, ln).astype(np.int8)
        reads.append(r)
    req = pipeline.BatchRequest(reads=reads, ref=ref, mat=dna_matrix(2, 2),
                                gapO=3, gapE=1,
                                mask_len=[max(len(r) // 2, 15)
                                          for r in reads])
    monkeypatch.setattr(pipeline, "STREAM_SUBOPT", True)
    monkeypatch.setattr(pipeline, "PACK", True)
    monkeypatch.setattr(pipeline, "PACK_L", 512)
    cuda_sw.reset_launches()
    got = pipeline.align_batch(req)
    assert cuda_sw.launch_counts()["forward_shared_packed_dual"] == 1
    monkeypatch.setattr(pipeline, "PACK", False)
    monkeypatch.setattr(pipeline, "DUAL", False)
    want = pipeline.align_batch(req, device="cpu")
    assert [vars(a) for a in got] == [vars(b) for b in want]


def _gate_inputs(dev, B, L, R, mat, seed):
    """Hot reads (target copies, and copies with a read-side insertion of
    K+1..64 bases after a 40-base prefix) and cold random ones."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, R).astype(np.int32)
    read_len = rng.integers(L // 3, L - 16, B).astype(np.int32)
    K = L // 32
    reads = []
    for b, ln in enumerate(read_len):
        ln = int(ln)
        s = int(rng.integers(0, R - ln))
        r = rng.integers(0, 4, ln).astype(np.int32)
        a, n = min(40, ln // 3), min(64, ln - min(40, ln // 3) - 8)
        if b % 4 == 0:
            r = ref[s:s + ln].copy()
        elif b % 4 == 1 and n > K:
            n = int(rng.integers(K + 1, n + 1))
            r = np.concatenate([ref[s:s + a], r[:n], ref[s + a:s + ln - n]])
        reads.append(r)
    rp = common.pad_reads(reads, L, 4)
    prof = common.build_profile(rp, read_len, common.extend_matrix(mat))
    geo = common.batch_geometry(read_len, L, word=False)
    arrs = (prof, ref, read_len, geo.col_mask, geo.seg_id, geo.seg_start)
    return tuple(torch.as_tensor(np.ascontiguousarray(a)).to(dev)
                 for a in arrs)


@pytest.mark.parametrize("L,mat,gapO,gapE,quirk,max_sub,mode", [
    (128, dna_matrix(2, 2), 3, 1, False, 2, "base"),       # int16 tier
    (256, dna_matrix(1, 3), 5, 2, False, 3, "dual"),       # int16 dual
    (256, dna_matrix(1, 3), 5, 2, False, None, "blockmax"),  # int32
    (128, dna_matrix(2, 4), 3, 1, True, None, "base"),     # int32 quirk
    (1088, dna_matrix(2, 2), 3, 1, False, None, "dual"),   # global rows
])
def test_forward_shared_gated_kernel_equals_plain(card, L, mat, gapO, gapE,
                                                  quirk, max_sub, mode):
    """The gate in both forward kernels: the gated launch equals the gated
    plain model and the ungated launch, is counted in GATED, and its
    histogram of column steps by scan depth equals the plain model's."""
    from ssw_tpu_torch.ops import gate

    args = _gate_inputs(card, 21, L, 1200, mat, seed=L + gapO)
    thr = gate.card_thresholds(L // 32, L, gapO, gapE, int(np.abs(mat).max()))
    rl = args[2]
    kw = {}
    if mode != "base":
        kw = dict(blockmax=True, valid_len=1100)
    if mode == "dual":
        j = torch.arange(L, device=card)[None, :]
        kw["wmask"] = (j < (rl[:, None] + 7) // 8 * 8).contiguous()
    i16 = cuda_sw.i16_exact(L, gapO, gapE, max_sub, quirk)
    name = cuda_sw.shared_kernel_name(i16, mode != "base", mode == "dual")
    before = cuda_sw.gated_counts()[name]
    cuda_sw.reset_gate_steps()
    got = cuda_sw.forward_shared(*args, gapO, gapE, quirk, max_sub=max_sub,
                                 gate=thr, **kw)
    steps = cuda_sw.gate_steps()
    assert cuda_sw.gated_counts()[name] == before + 1
    want, want_steps = scan_sw.forward_shared_ref(
        *args, gapO, gapE, quirk, gate=thr, pairs=i16, steps=True, **kw)
    _equal(got, want)
    _equal(got, cuda_sw.forward_shared(*args, gapO, gapE, quirk,
                                       max_sub=max_sub, **kw))
    assert steps == want_steps.tolist() and sum(steps[:5]) > 0


@pytest.mark.parametrize("dual", [False, True])
def test_forward_shared_packed_gated_kernel_equals_plain(card, dual):
    from ssw_tpu_torch.ops import gate, pack

    lens = list(range(20, 221, 5))
    packed, _, _ = _packed_inputs(card, lens, 1024, 768, 700,
                                  dna_matrix(2, 2), seed=5)
    smax = pack.slot_max(packed[3])
    thr = gate.card_thresholds(pack.packed_lanes(smax) // 32, smax, 3, 1, 2)
    kw = dict(max_sub=2, valid_len=700, dual=dual)
    cuda_sw.reset_gate_steps()
    got = cuda_sw.forward_shared_packed(*packed, 3, 1, gate=thr, **kw)
    steps = cuda_sw.gate_steps()
    want, want_steps = scan_sw.forward_shared_ref_packed(
        *packed, 3, 1, gate=thr, steps=True, **kw)
    _equal(got, want)
    _equal(got, cuda_sw.forward_shared_packed(*packed, 3, 1, **kw))
    assert steps == want_steps.tolist() and sum(steps[:5]) > 0


def test_gated_pipeline_on_card_equals_cpu(card, monkeypatch):
    """-m1 -x3 -o5 -e2, streaming, packed, dual: the card's gate tiers
    (GATE = "tiers"; the card's rule gates no launch) on the card against
    no gate on the CPU."""
    rng = np.random.default_rng(33)
    ref = rng.integers(0, 4, 2048).astype(np.int8)
    reads = []
    for i in range(40):
        ln = int(rng.integers(30, 249))
        s = int(rng.integers(0, 2048 - ln))
        reads.append(ref[s:s + ln].copy() if i % 2 == 0 else
                     rng.integers(0, 4, ln).astype(np.int8))
    req = pipeline.BatchRequest(reads=reads, ref=ref, mat=dna_matrix(1, 3),
                                gapO=5, gapE=2,
                                mask_len=[max(len(r) // 2, 15)
                                          for r in reads])
    monkeypatch.setattr(pipeline, "STREAM_SUBOPT", True)
    monkeypatch.setattr(pipeline, "GATE", "tiers")
    cuda_sw.reset_launches()
    got = pipeline.align_batch(req)
    assert cuda_sw.gated_counts()["forward_shared_packed_dual"] == 1
    monkeypatch.setattr(pipeline, "GATE", False)
    want = pipeline.align_batch(req, device="cpu")
    assert [vars(a) for a in got] == [vars(b) for b in want]


def _owned_cols(dev, R, seed):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(4 * R)[:R].astype(np.int32)
    own = rng.random(R) < 0.5
    return torch.as_tensor(idx).to(dev), torch.as_tensor(own).to(dev)


@pytest.mark.parametrize("L", [128, 448])
@pytest.mark.parametrize("i16", [False, True])
@pytest.mark.parametrize("gated", [False, True])
def test_forward_shared_owned_kernel_equals_plain(card, L, i16, gated):
    """The owned-column mode (cuda_sw.forward_shared_gated) at K = 4 and
    K = 14, int32 and the int16 tier, ungated and with the card's gate
    tiers, against scan_sw.forward_shared_ref_gated, the depth histogram
    count for count."""
    from ssw_tpu_torch.ops import gate

    B, R = 23, 800
    args = _inputs(card, B, L, R, dna_matrix(2, 2), False, seed=L + i16)
    idx, own = _owned_cols(card, R, seed=L)
    thr = gate.card_thresholds(L // 32, L, 3, 1, 2) if gated else None
    name = cuda_sw.owned_kernel_name(i16)
    before = cuda_sw.launch_counts()[name]
    cuda_sw.reset_gate_steps()
    got = cuda_sw.forward_shared_gated(*args[:2], idx, own, *args[2:], 3, 1,
                                       False, max_sub=2 if i16 else None,
                                       gate=thr)
    hist = cuda_sw.gate_steps()
    assert cuda_sw.launch_counts()[name] == before + 1
    want = scan_sw.forward_shared_ref_gated(*args[:2], idx, own, *args[2:],
                                            3, 1, False, gate=thr, pairs=i16,
                                            steps=gated)
    if gated:
        want, want_hist = want
        assert hist == want_hist.tolist()
    _equal(got, want)


def test_sharded_pipeline_on_card_equals_cpu(card):
    """pipeline.align_batch_sharded over a 1 x 2 mesh of [cuda:0] * 2 (the
    seq shards one after another on the card) against align_batch on the
    CPU."""
    from ssw_tpu_torch.parallel import mesh as mesh_lib

    rng = np.random.default_rng(12)
    ref = rng.integers(0, 4, 4000).astype(np.int8)
    reads = []
    for _ in range(60):
        ln = int(rng.integers(30, 200))
        s = int(rng.integers(0, 4000 - ln))
        r = ref[s:s + ln].copy()
        m = rng.random(ln) < 0.05
        r[m] = rng.integers(0, 4, int(m.sum()))
        reads.append(r)
    req = pipeline.BatchRequest(reads=reads, ref=ref, mat=dna_matrix(2, 2),
                                gapO=3, gapE=1,
                                mask_len=[max(len(r) // 2, 15)
                                          for r in reads])
    m = mesh_lib.make_mesh(data=1, seq=2, devices=[card] * 2)
    cuda_sw.reset_launches()
    got = pipeline.align_batch_sharded(req, m)
    counts = cuda_sw.launch_counts()
    assert counts["forward_shared_i16_owned"] + \
        counts["forward_shared_owned"] >= 2
    want = pipeline.align_batch(req, device="cpu")
    assert [vars(a) for a in got] == [vars(b) for b in want]


def test_sharded_pipeline_over_distinct_cards(card):
    """pipeline.align_batch_sharded over a 1 x n mesh of n distinct cards
    (up to four) against the same mesh on [cuda:0] * n and align_batch on
    the card, field by field; only the distinct cards copy between
    devices (peer_bytes) and both launch one forward per shard."""
    from ssw_tpu_torch import profiling
    from ssw_tpu_torch.parallel import mesh as mesh_lib

    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    rng = np.random.default_rng(13)
    ref = rng.integers(0, 4, 40000).astype(np.int8)
    reads = []
    for _ in range(300):
        ln = int(rng.integers(30, 200))
        s = int(rng.integers(0, len(ref) - ln))
        r = ref[s:s + ln].copy()
        m = rng.random(ln) < 0.05
        r[m] = rng.integers(0, 4, int(m.sum()))
        reads.append(r)
    req = pipeline.BatchRequest(reads=reads, ref=ref, mat=dna_matrix(2, 2),
                                gapO=3, gapE=1,
                                mask_len=[max(len(r) // 2, 15)
                                          for r in reads])
    got = {}
    for name, devs in (("distinct", [torch.device("cuda", i)
                                     for i in range(n)]),
                       ("one", [card] * n)):
        c = profiling.GcupsCounter()
        with pipeline.profiled(c):
            res = pipeline.align_batch_sharded(
                req, mesh_lib.make_mesh(data=1, seq=n, devices=devs))
        got[name] = ([vars(a) for a in res], c.counts)
    want = [vars(a) for a in pipeline.align_batch(req, device=card)]
    assert got["distinct"][0] == want and got["one"][0] == want
    assert got["distinct"][1]["peer_bytes"] > 0
    assert got["one"][1]["peer_bytes"] == 0
    assert got["distinct"][1]["shard_forwards"] == \
        got["one"][1]["shard_forwards"] >= n


def test_i16_k14_fault_input_pinned(card):
    """The input on which the int16 kernel at K = 14 once went wrong
    (ROADMAP §C: chip_smoke.py phase 3, seed 106, B 43, L 448, R 778): the
    production int16 base mode equals the plain twin."""
    from ssw_tpu_torch.tools import i16_fault

    args = i16_fault.failing_input(card)
    before = cuda_sw.launch_counts()["forward_shared_i16"]
    wave_before = cuda_sw.library_counts()["sw_wave_i16"]
    got = cuda_sw.forward_shared(*args, 3, 1, False, max_sub=2)
    assert cuda_sw.launch_counts()["forward_shared_i16"] == before + 1
    assert cuda_sw.library_counts()["sw_wave_i16"] == wave_before + 1
    _equal(got, scan_sw.forward_shared_ref(*args, 3, 1, False))
    _equal(got, cuda_sw.forward_shared(*args, 3, 1, False, max_sub=2,
                                       scan_body=True))


@pytest.mark.parametrize("mode", ["base", "blockmax", "dual", "owned"])
@pytest.mark.parametrize("L,B", [(64, 36), (448, 23), (1024, 9), (96, 11),
                                 (1088, 5)])
def test_wave_i16_kernel_equals_plain_and_scan_body(card, mode, L, B):
    """The int16 wavefront (csrc/sw_wave_i16.cu) in every mode, at register
    K (2, 14, 32) and global-row K (3, 34), odd B: equal to its plain twin
    and to the column-scan body of sw_forward_i16.cu on the same inputs,
    and counted in LIBRARY as sw_wave_i16."""
    R = 1500
    args = _inputs(card, B, L, R, dna_matrix(2, 2), False, seed=L + B)
    kw = {}
    if mode in ("blockmax", "dual"):
        kw = dict(blockmax=True, valid_len=1270)
    if mode == "dual":
        j = torch.arange(L, device=card)[None, :]
        kw["wmask"] = (j < (args[2][:, None] + 7) // 8 * 8).contiguous()
    if mode == "owned":
        idx, own = _owned_cols(card, R, seed=L)
        fn = lambda **k: cuda_sw.forward_shared_gated(  # noqa: E731
            *args[:2], idx, own, *args[2:], 3, 1, False, max_sub=2, **k)
        want = scan_sw.forward_shared_ref_gated(*args[:2], idx, own,
                                                *args[2:], 3, 1, False)
    else:
        fn = lambda **k: cuda_sw.forward_shared(  # noqa: E731
            *args, 3, 1, False, max_sub=2, **kw, **k)
        want = scan_sw.forward_shared_ref(*args, 3, 1, False, **kw)
    before = cuda_sw.library_counts()
    got = fn()
    after = cuda_sw.library_counts()
    assert after["sw_wave_i16"] == before["sw_wave_i16"] + 1
    assert after["sw_forward_i16"] == before["sw_forward_i16"]
    _equal(got, want)
    _equal(got, fn(scan_body=True))
    assert cuda_sw.library_counts()["sw_forward_i16"] == \
        after["sw_forward_i16"] + 1


@pytest.mark.parametrize("W,lens,mat,quirk,word,dual", [
    (1024, list(range(20, 221, 5)), dna_matrix(2, 2), False, False, False),
    (1024, list(range(20, 221, 5)), dna_matrix(2, 2), False, False, True),
    (512, list(range(20, 200, 9)), dna_matrix(2, 4), True, True, False),
    (1024, list(range(20, 221, 7)), dna_matrix(2, 4), True, False, False),
    (1024, [1000, 17, 250, 0, 1, 600], dna_matrix(2, 2), False, False,
     True),
    (4096, [1100, 1300, 1499, 0, 1], dna_matrix(2, 2), False, False, True),
])
def test_wave_packed_kernel_equals_plain_and_scan_body(card, W, lens, mat,
                                                       quirk, word, dual):
    """The packed wavefront (csrc/sw_wave_packed.cu): blockmax and dual, the
    quirk on 8 (word) and 16 (byte) lane blocks, register K up to 32 and
    slots past 1024 lanes; equal to its plain twin and to the column-scan
    body of sw_forward_packed.cu on the same inputs."""
    packed, _, _ = _packed_inputs(card, lens, W, 768, 700, mat, seed=W + 1,
                                  word_rows=np.full(len(lens), word))
    kw = dict(max_sub=int(np.abs(mat).max()), valid_len=700, quirk=quirk,
              word=word, dual=dual)
    before = cuda_sw.library_counts()["sw_wave_packed"]
    got = cuda_sw.forward_shared_packed(*packed, 3, 1, **kw)
    assert cuda_sw.library_counts()["sw_wave_packed"] == before + 1
    _equal(got, scan_sw.forward_shared_ref_packed(*packed, 3, 1, **kw))
    _equal(got, cuda_sw.forward_shared_packed(*packed, 3, 1, scan_body=True,
                                              **kw))


@pytest.mark.parametrize("mode,quirk", [
    ("base", False), ("base", True), ("blockmax", False), ("blockmax", True),
    ("dual", False), ("owned", False), ("owned", True),
])
@pytest.mark.parametrize("L,B", [(64, 36), (448, 23), (1024, 9), (96, 11),
                                 (1088, 5)])
def test_wave_i32_kernel_equals_plain_and_scan_body(card, mode, quirk, L, B):
    """The int32 wavefront (csrc/sw_wave_i32.cu) in every ungated mode, the
    quirk on BLOSUM50, at register K (2, 14, 32) and global-row K (3, 34):
    equal to its plain twin and to the column-scan body of sw_forward.cu
    on the same inputs, and counted in LIBRARY as sw_wave_i32."""
    R = 1500
    mat = BLOSUM50 if quirk else dna_matrix(2, 2)
    args = _inputs(card, B, L, R, mat, False, seed=L + B + quirk)
    kw = {}
    if mode in ("blockmax", "dual"):
        kw = dict(blockmax=True, valid_len=1270)
    if mode == "dual":
        j = torch.arange(L, device=card)[None, :]
        kw["wmask"] = (j < (args[2][:, None] + 7) // 8 * 8).contiguous()
    if mode == "owned":
        idx, own = _owned_cols(card, R, seed=L)
        fn = lambda **k: cuda_sw.forward_shared_gated(  # noqa: E731
            *args[:2], idx, own, *args[2:], 3, 1, quirk, **k)
        want = scan_sw.forward_shared_ref_gated(*args[:2], idx, own,
                                                *args[2:], 3, 1, quirk)
    else:
        fn = lambda **k: cuda_sw.forward_shared(  # noqa: E731
            *args, 3, 1, quirk, **kw, **k)
        want = scan_sw.forward_shared_ref(*args, 3, 1, quirk, **kw)
    before = cuda_sw.library_counts()
    got = fn()
    after = cuda_sw.library_counts()
    assert after["sw_wave_i32"] == before["sw_wave_i32"] + 1
    assert after["sw_forward"] == before["sw_forward"]
    _equal(got, want)
    _equal(got, fn(scan_body=True))
    assert cuda_sw.library_counts()["sw_forward"] == after["sw_forward"] + 1


@pytest.mark.parametrize("L,quirk,emit", [
    (128, False, False), (128, True, True), (64, False, True),
    (448, True, False), (1088, False, True),
])
def test_wave_perread_kernel_equals_plain_and_scan_body(card, L, quirk,
                                                        emit):
    """The per-read wavefront (csrc/sw_wave_perread.cu) with terminate at
    the score for half the reads and at a mid-window column maximum for
    the others (later columns beat it), emit_maxcol off and on, the quirk:
    equal to its plain twin and to sw_perread.cu's column-scan body."""
    mat = BLOSUM50 if quirk else dna_matrix(2, 2)
    prof, ref, rl, cm, sid, ss = _inputs(card, 29, L, 1400, mat, False,
                                         seed=L + 5)
    refw = torch.stack([torch.roll(ref[:300], 7 * b) for b in range(29)])
    args = (prof, refw.contiguous(), rl, cm, sid, ss, 3, 1, quirk)
    base = scan_sw.forward_perread_ref(*args, emit_maxcol=True)
    term = base[0].clone()
    term[::2] = base[3][::2, 100]
    before = cuda_sw.library_counts()["sw_wave_perread"]
    got = cuda_sw.forward_perread(*args, terminate=term, emit_maxcol=emit)
    assert cuda_sw.library_counts()["sw_wave_perread"] == before + 1
    _equal(got, scan_sw.forward_perread_ref(*args, terminate=term,
                                            emit_maxcol=emit))
    _equal(got, cuda_sw.forward_perread(*args, terminate=term,
                                        emit_maxcol=emit, scan_body=True))


@pytest.mark.parametrize("quirk,emit", [(False, False), (True, True)])
def test_wave_perread_terminate_by_hand(card, quirk, emit):
    """The hand-built terminate windows (tools/_common.terminate_case:
    every distinct column maximum as terminate[b]) on the card."""
    from ssw_tpu_torch.tools import _common as tools_common

    mat = BLOSUM50 if quirk else dna_matrix(2, 2)
    args, term = tools_common.terminate_case(card, mat=mat, word=quirk,
                                             seed=9, quirk=quirk)
    got = cuda_sw.forward_perread(*args, 3, 1, quirk, terminate=term,
                                  emit_maxcol=emit)
    _equal(got, scan_sw.forward_perread_ref(*args, 3, 1, quirk,
                                            terminate=term,
                                            emit_maxcol=emit))
    _equal(got, cuda_sw.forward_perread(*args, 3, 1, quirk, terminate=term,
                                        emit_maxcol=emit, scan_body=True))


def test_probe_swar_kernel_equals_plain(card):
    from ssw_tpu_torch.tools import _common, probe_swar

    before = _common.LAUNCHES["probe_swar"]
    probe_swar.check_exact(np.random.default_rng(0), card)
    errs = probe_swar.exactness(card)
    assert not any(errs.values()), errs
    assert _common.LAUNCHES["probe_swar"] > before


def test_probe_i16_kernels_equal_plain(card):
    from ssw_tpu_torch.tools import probe_i16

    for name in probe_i16.PROBES:
        assert probe_i16.check(name, card) == 0, name


@pytest.mark.parametrize("L,B,R", [(128, 37, 333), (256, 16, 512)])
def test_lab_variants_equal_their_comparisons(card, L, B, R):
    """Every kernel_lab variant with a comparison against its plain twin
    and its kernel-run comparison (full, the production kernel), the
    gatescan histogram count for count; tolerance 0."""
    from ssw_tpu_torch.tools import _common, kernel_lab

    args = _inputs(card, B, L, R, dna_matrix(2, 2), False, seed=R)
    gate = kernel_lab.card_gate(args)
    before = _common.LAUNCHES["sw_lab"]
    for v in kernel_lab.VARIANTS:
        for m in (range(5) if v == "shortscan" else (None,)):
            err = kernel_lab.verify(v, args, m=m, gate=gate)
            assert err == (None if v == "skeleton" else 0), (v, m, err)
    assert _common.LAUNCHES["sw_lab"] > before


# -- the front ends on the card (device None), against device "cpu" --------

def _wave_only(before):
    """Every launch since `before` (cuda_sw.library_counts()) ran a
    wavefront library."""
    after = cuda_sw.library_counts()
    diff = {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}
    assert diff and all(k.startswith("sw_wave_") for k in diff), diff


def test_front_end_api_on_card_equals_cpu(card):
    from ssw_tpu_torch import api

    rng = np.random.default_rng(21)
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 2000))
    qs = [ref[s:s + ln] for s, ln in zip(rng.integers(0, 1800, 40),
                                         rng.integers(20, 200, 40))]
    qs += ["".join("ACGT"[i] for i in rng.integers(0, 4, 90)), ""]
    before = cuda_sw.library_counts()
    a = api.Aligner()
    flag, al = a.align("CTGAGCCGGTAAATC",
                       "CAGCCTTTCTGACCCGGAAATCAAAATAGGCACAACAAA")
    assert (al.sw_score, al.sw_score_next_best, al.ref_begin,
            al.cigar_string, al.mismatches, flag) == (21, 8, 8, "4=1X4=1I5=",
                                                      2, 0)
    a.set_reference_sequence(ref)
    got = a.align_batch(qs, None, api.Filter(), [15, 40] * 21)
    _wave_only(before)
    c = api.Aligner(device="cpu")
    c.set_reference_sequence(ref)
    want = c.align_batch(qs, None, api.Filter(), [15, 40] * 21)
    assert got[0] == want[0]
    assert [vars(x) for x in got[1]] == [vars(x) for x in want[1]]


def test_front_end_ssw_lib_on_card_equals_cpu(card):
    from ssw_tpu_torch import ssw_lib
    from ssw_tpu_torch.core.encoding import NT_TABLE

    def enc(s):
        return [int(NT_TABLE[ord(c)]) for c in s]

    flat = [int(x) for x in dna_matrix(2, 2).reshape(-1)]
    before = cuda_sw.library_counts()
    out = []
    for ssw in (ssw_lib.CSsw(), ssw_lib.CSsw(device="cpu")):
        q, r = enc("CTGAGCCGGTAAATC"), enc(
            "CAGCCTTTCTGACCCGGAAATCAAAATAGGCACAACAAA")
        res = ssw.ssw_align(ssw.ssw_init(q, len(q), flat, 5, 2), r, len(r),
                            3, 1, 0x0F, 0, 2 ** 15, 15)
        c = res.contents
        out.append((c.nScore, c.nScore2, c.nRefBeg, c.nRefEnd, c.nQryBeg,
                    c.nQryEnd, c.nRefEnd2, list(c.sCigar)))
        big = ssw.ssw_init(enc("A" * 200), 200, flat, 5, 0)
        assert not ssw.ssw_align(big, enc("A" * 300), 300, 3, 1, 0, 0,
                                 2 ** 15, 15)
    _wave_only(before)
    assert out[0] == out[1] and out[0][0] == 21


@pytest.mark.parametrize("gold,args", [
    ("g_pyssw_r1_blast.txt", ["-c", "r1.fa", "r1_query.fq"]),
    ("g_pyssw_r1_sam.txt", ["-c", "-s", "-header", "r1.fa", "r1_query.fq"]),
    ("g_pyssw_prot_blast.txt", ["-c", "-p", "pRef.fa", "pRead.fa"]),
])
def test_front_end_pyssw_on_card_golden(card, gold, args):
    import io
    import os

    from ssw_tpu_torch import pyssw

    here = os.path.dirname(os.path.abspath(__file__))
    out = io.StringIO()
    rc = pyssw.main(args[:-2] + [os.path.join(here, "data", a)
                                 for a in args[-2:]],
                    out=out, err=io.StringIO())
    with open(os.path.join(here, "golden", gold)) as f:
        assert rc == 0 and out.getvalue() == f.read()


def test_front_end_bridge_on_card_equals_cpu(card):
    import io
    import json

    from ssw_tpu_torch import bridge

    rng = np.random.default_rng(5)
    ref = [int(x) for x in rng.integers(0, 4, 3000)]
    mat = [int(x) for x in dna_matrix(2, 2).reshape(-1)]

    def req(i, read, **kw):
        m = {"id": i, "read": read, "ref": ref, "matrix": mat, "n": 5,
             "gap_open": 3, "gap_extend": 1, "flag": 0x0F, "mask_len": 15}
        m.update(kw)
        return m

    reads = [ref[s:s + 100] for s in rng.integers(0, 2900, 64)]
    lines = [json.dumps(req(0, reads[0])), "not json",
             json.dumps({"id": 1, "batch": [req(None, r) for r in reads]}),
             json.dumps(req(2, reads[1][:60], score_size=0)),
             '{"op":"shutdown"}']
    outs = []
    before = cuda_sw.library_counts()
    for device in (None, "cpu"):
        out = io.StringIO()
        assert bridge.serve(io.StringIO("\n".join(lines) + "\n"), out,
                            device=device) == 0
        outs.append(out.getvalue())
        if device is None:
            _wave_only(before)
    assert outs[0] == outs[1] and '"error":"bad json"' in outs[0]
    assert outs[0].count('"error"') == 1


def test_bench_line_on_card(card, capsys):
    """`python -m ssw_tpu_torch.bench` in-process on the card: bench.py's
    four keys last, every launch the packed wavefront in the pipeline's
    mode; then the timed call on the card equals the plain version on the
    target's first 4096 columns, and its block maxima there."""
    import json

    from ssw_tpu_torch import bench

    assert bench.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    info, last = json.loads(lines[-2]), json.loads(lines[-1])
    assert list(last) == ["metric", "value", "unit", "vs_baseline"]
    assert last["value"] > 0
    assert abs(last["vs_baseline"] - last["value"] / 1.1) <= 0.01
    name = "forward_shared_packed" + ("_dual" if info["dual"] else "")
    n = info["launches"][name]
    assert n == 2 + bench.TIMED_CALLS
    assert {k: v for k, v in info["launches"].items() if v} == {name: n}
    assert {k: v for k, v in info["libraries"].items() if v} == {
        "sw_wave_packed": n}

    ref = bench.make_target(bench.CARD_R)
    leaf = bench.Leaf(ref, bench.READS, bench.READ_LEN, card)
    inputs = leaf.inputs(bench.make_reads(ref, 1, bench.READS))
    full = leaf.call(inputs)
    cols = 4096
    head = leaf.ref_d[:cols].contiguous()
    got = leaf.call(inputs, head, cols)
    pprof, tables = inputs
    want = scan_sw.forward_shared_ref_packed(
        pprof, head, *tables, bench.GAP_O, bench.GAP_E,
        max_sub=bench.MAX_SUB, valid_len=cols, dual=leaf.dual)
    _equal(got, want)
    assert torch.equal(full[3][..., :cols // 256], want[3])


def test_protein_leaf_wave_equals_scan_body(card):
    """Config 2 at scale (tools/bench_protein's workload): its largest
    leaf (L 128), the int32 base mode with the quirk, on the wavefront
    equals the column-scan body over the whole padded proteome (229,376
    columns) and the plain version on a slice."""
    from ssw_tpu_torch.tools import bench_protein

    reads, ref, mat = bench_protein.workload()
    group = [r for r in reads if 64 < common.pad_total(len(r), False) <= 128]
    L, n = 128, mat.shape[0]
    max_sub = int(np.abs(mat).max())
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(card)
    read_len = np.array([len(r) for r in group], np.int32)
    rl = t(read_len)
    prof, cm, seg, ss = pipeline._prep_device(
        t(common.pad_reads(group, L, n)).to(torch.int8), rl,
        t(common.extend_matrix(mat)).to(torch.int8),
        torch.zeros(len(group), dtype=torch.bool, device=card), L, False)
    Rp = common.bucket_size(len(ref), 256)
    ref_p = np.full(Rp, n, np.int32)
    ref_p[:len(ref)] = ref
    args = (prof, t(ref_p), rl, cm, seg, ss, 3, 1, True)
    assert cuda_sw.quirk_wave_exact(L, max_sub) and len(group) > 200
    before = cuda_sw.library_counts()["sw_wave_i32"]
    got = cuda_sw.forward_shared(*args, max_sub=max_sub)
    assert cuda_sw.library_counts()["sw_wave_i32"] == before + 1
    _equal(got, cuda_sw.forward_shared(*args, max_sub=max_sub,
                                       scan_body=True))
    sl = (prof, t(ref_p[:4096]), rl, cm, seg, ss, 3, 1, True)
    _equal(cuda_sw.forward_shared(*sl, max_sub=max_sub),
           scan_sw.forward_shared_ref(*sl))


def test_reverse_pass_l1024_equals_plain(card, monkeypatch):
    """spotcheck_revmem's reverse pass at L 1024 (the per-read wavefront's
    K = 32 template) and W 8192 with no early terminate, B 8: equal to the
    plain version on the card."""
    from ssw_tpu_torch.tools import spotcheck_revmem

    res, inp, got = spotcheck_revmem.run(8, 1024, 8192, card)
    assert res["peak_bytes_in_use"] > 0 and res["bytes_limit"] > 0
    monkeypatch.setattr(cuda_sw, "forward_perread",
                        scan_sw.forward_perread_ref)
    want = spotcheck_revmem.reverse(inp)
    assert torch.equal(got, want)


def test_spotcheck_cuda_cut_cases(card):
    """spotcheck_cuda's five cases and its sharded check, cut to 8 reads
    each: the card against the CPU, no mismatch."""
    from ssw_tpu_torch.tools import spotcheck_cuda

    assert spotcheck_cuda.run(card, n_reads=8) == 0


# -- the packed wavefront's split target (ops/pack.py stretches) --------------

@pytest.mark.parametrize("lanes,mode", [
    (lanes, mode) for lanes in (128, 192, 256, 320, 448, 1088)
    for mode in ("blockmax", "dual", "quirk")
    # slots past 1024 lanes break the quirk's span guard: never packed
    if not (lanes > 1024 and mode == "quirk")])
def test_wave_packed_stretches_equal_plain(card, lanes, mode, monkeypatch):
    """The packed wavefront split into P = 1, 2, 3, 8 stretches (the rule
    pinned) and at the rule's P, on inputs built around the boundaries of
    three stretches (tests/test_torch_stretch.py), against the plain twin
    and its own P = 1 launch bit for bit: score, end_ref, end_read and both
    channels of block maxima; K = 4 to 14 and a global-row width (K = 34).
    Each launch's warps are counted in `forward_stretches`, each split
    launch in SPLIT."""
    from test_torch_stretch import stretch_case

    from ssw_tpu_torch import profiling
    from ssw_tpu_torch.ops import pack

    args, kw, gapO, gapE = stretch_case(3, mode, seed=lanes, dev=card,
                                        lanes=lanes)
    B = int(args[5].shape[0])
    want = scan_sw.forward_shared_ref_packed(
        *(a.cpu() for a in args), gapO, gapE, **kw)
    with monkeypatch.context() as m:
        m.setattr(pack, "stretch_rule", lambda *a: 1)
        one = cuda_sw.forward_shared_packed(*args, gapO, gapE, **kw)
    _equal(one, tuple(w.to(card) for w in want))
    name = "forward_shared_packed" + ("_dual" if mode == "dual" else "")
    for P in (2, 3, 8, None):
        before = cuda_sw.library_counts()["sw_wave_packed"]
        split = cuda_sw.split_counts()[name]
        with monkeypatch.context() as m, \
                pipeline.profiled(profiling.GcupsCounter()) as c:
            if P is not None:
                m.setattr(pack, "stretch_rule", lambda *a: P)
            got = cuda_sw.forward_shared_packed(*args, gapO, gapE, **kw)
        assert cuda_sw.library_counts()["sw_wave_packed"] == before + 1
        _equal(got, one)
        P_eff = pack.stretch_bounds(kw["valid_len"], P)[0] if P else 1
        assert c.counts["forward_stretches"] == B * P_eff
        assert cuda_sw.split_counts()[name] == split + (P_eff > 1)


def test_wave_packed_refuses_uncovered_columns(card, monkeypatch):
    """The C entry point refuses stretches that leave columns below
    valid_len to no warp, or leave a stretch empty, and runs a C of its
    caller's choosing that covers them."""
    from test_torch_stretch import stretch_case

    from ssw_tpu_torch.ops import pack

    args, kw, gapO, gapE = stretch_case(3, "dual", dev=card)
    vl = kw["valid_len"]
    want = scan_sw.forward_shared_ref_packed(
        *(a.cpu() for a in args), gapO, gapE, **kw)
    for P, C in ((2, 256), (2, 2304), (3, 2560)):  # short; short; empty
        assert P * C < vl or (P - 1) * C >= vl
        monkeypatch.setattr(pack, "stretch_bounds", lambda *a: (P, C))
        with pytest.raises(RuntimeError, match="CUDA error"):
            cuda_sw.forward_shared_packed(*args, gapO, gapE, **kw)
    monkeypatch.setattr(pack, "stretch_bounds", lambda *a: (2, 2560))
    _equal(cuda_sw.forward_shared_packed(*args, gapO, gapE, **kw),
           tuple(w.to(card) for w in want))


def test_ion_headline_split_sam_equals_unsplit(card, tmp_path,
                                               monkeypatch):
    """The reference README's Ion Torrent headline (1,000 reads of 25-540
    bp against a 4,938,920-base genome, -c -s -h) through cli.main: the
    rule splits every packed leaf, and the SAM equals the run with every
    launch whole."""
    import io

    from ssw_tpu_torch import cli, profiling
    from ssw_tpu_torch.ops import pack

    rng = np.random.default_rng(4_938_920)
    bases = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.choice(bases, 4_938_920).astype(np.uint8)
    fa, fq = tmp_path / "ecoli_synth.fa", tmp_path / "ion.fastq"
    fa.write_bytes(b">ecoli_synth\n" + genome.tobytes() + b"\n")
    with open(fq, "wb") as f:
        for i in range(1000):
            ln = int(np.clip(rng.normal(200, 80), 25, 540))
            pos = int(rng.integers(0, len(genome) - ln))
            rd = genome[pos:pos + ln].copy()
            m = rng.random(ln) < 0.01
            rd[m] = rng.choice(bases, int(m.sum()))
            f.write(b"@ion_%d\n%s\n+\n%s\n" % (i, rd.tobytes(), b"I" * ln))

    def run():
        out, err = io.StringIO(), io.StringIO()
        with pipeline.profiled(profiling.GcupsCounter()) as c:
            assert cli.main(["-c", "-s", "-h", str(fa), str(fq)], out,
                            err) == 0
        return out.getvalue(), c.counts["forward_stretches"]

    split, n_split = run()
    monkeypatch.setattr(pack, "stretch_rule", lambda *a: 1)
    whole, n_whole = run()
    assert n_whole == 1000 < n_split
    assert split.count("\n") > 1000 and split == whole
