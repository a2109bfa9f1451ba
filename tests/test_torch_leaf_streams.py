"""One CUDA stream per in-flight leaf of the asynchronous pipeline
(align_batch_launch / _mid / _scores / _finish): the pool hands a live leaf
a stream no other live leaf holds and takes it back after the leaf's last
download, and the results and stderr equal align_batch's.  The synchronous
path (align_batch) and every CPU run pool nothing.

The tests marked cuda need a card and skip without one; this file imports
no JAX, so on the card run them with
`python -m pytest tests/test_torch_leaf_streams.py -m cuda --noconftest`."""

import contextlib
import gc
import io

import numpy as np
import pytest
import torch

from ssw_tpu_torch import pipeline, profiling
from ssw_tpu_torch.core.encoding import dna_matrix

MAT = dna_matrix(2, 2)  # ssw_test's defaults: -m 2 -x 2 -o 3 -e 1


def _reads(rng, ref, lengths, err):
    """Reads of `lengths` at uniform origins of ref, substitutions at err."""
    out = []
    for ln in lengths:
        ln = int(ln)
        pos = int(rng.integers(0, len(ref) - ln))
        rd = ref[pos:pos + ln].copy()
        m = rng.random(ln) < err
        rd[m] = rng.integers(0, 4, int(m.sum()))
        out.append(rd)
    return out


def _req(reads, ref):
    """The request cli.launch_batch makes for `-c` (flag 2, mask_len
    len // 2, score_size 2)."""
    return pipeline.BatchRequest(
        reads=reads, ref=ref, mat=MAT, gapO=3, gapE=1, flag=2, filters=0,
        filterd=0, mask_len=[len(r) // 2 for r in reads], score_size=2)


def _three_leaves(seed):
    """192 reads in three length buckets of 64 against 1,500 columns: three
    leaves on the asynchronous path."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 1500).astype(np.int8)
    lengths = np.concatenate([rng.integers(lo, hi, 64) for lo, hi in
                              ((20, 60), (70, 120), (130, 190))])
    req = _req(_reads(rng, ref, lengths, 0.05), ref)
    assert len(pipeline._plan_leaves(req)) == 3
    return req


def _run(fn):
    """fn()'s value and what it wrote on stderr."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = fn()
    return out, err.getvalue()


def _async(pend, detail=None):
    pipeline.align_batch_mid(pend)
    return pipeline.align_batch_finish(pend, detail=detail)


def _assert_same(want, got):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        if a is None or b is None:
            assert a is None and b is None, i
            continue
        assert vars(a) == vars(b), (i, vars(a), vars(b))


# -- the pool, with stand-in streams ----------------------------------------

@pytest.mark.parametrize("live", [1, 5, 8])
def test_pool_hands_distinct_streams_reuses_and_grows(live):
    made = []

    def make():
        made.append(object())
        return made[-1]

    pool = pipeline._StreamPool(make)
    held = [pool.take() for _ in range(live)]
    assert len({id(s) for s in held}) == live and len(made) == live
    released = held.pop(0)
    pool.give(released)
    assert pool.take() is released and len(made) == live
    pool.give(released)
    held += [pool.take(), pool.take()]  # the released one, then a new one
    assert held[-2] is released and len(made) == live + 1
    assert len({id(s) for s in held}) == len(held)


def test_cpu_async_pools_nothing_and_equals_align_batch():
    req = _three_leaves(5)
    assert pipeline._leaf_stream(torch.device("cpu"), None) is None
    want, want_err = _run(lambda: pipeline.align_batch(req, "cpu"))
    with pipeline.profiled(profiling.GcupsCounter()) as c:
        pend = pipeline.align_batch_launch(req, "cpu")
        assert all(st.stream is None for _, st in pend.parts)
        got, got_err = _run(lambda: _async(pend))
    assert "leaf_streams" not in c.counts
    _assert_same(want, got)
    assert got_err == want_err


class _Stream:
    """A stand-in stream: remembers the events it was made to wait for."""

    def __init__(self):
        self.waited = []

    def wait_event(self, ev):
        self.waited.append(ev)


class _Event:
    def record(self, stream):
        self.stream = stream


@pytest.mark.parametrize("sms", [0, 40])
def test_live_leaves_hold_their_streams_until_finish(monkeypatch, sms):
    """The pool's wiring on the CPU, with stand-in streams and events:
    every leaf of two requests in flight holds its own stream; mid and
    finish run each leaf under its own stream; finishing a request hands
    its streams back, and the next request takes them again.  With `sms`
    SMs the second wave's forwards wait for the first wave's."""
    pool = pipeline._StreamPool(_Stream)
    entered = []

    @contextlib.contextmanager
    def stream_ctx(s):
        entered.append(s)
        yield

    def take(dev, ref_d):
        profiling.count("leaf_streams")
        return pool.take()

    monkeypatch.setattr(pipeline, "_POOLS", {"cpu": pool})
    monkeypatch.setattr(pipeline, "_leaf_stream", take)
    monkeypatch.setattr(pipeline, "_sm_count", lambda dev: sms)
    monkeypatch.setattr(torch.cuda, "stream", stream_ctx)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    reqs = [_three_leaves(seed) for seed in (6, 7, 8)]
    with pipeline.profiled(profiling.GcupsCounter()) as c:
        a, b = (pipeline.align_batch_launch(r, "cpu") for r in reqs[:2])
        streams = [st.stream for p in (a, b) for _, st in p.parts]
        assert len({id(s) for s in streams}) == 6 and not pool.free
        assert {id(s) for s in entered} == {id(s) for s in streams}
        for p in (a, b):
            states = [st for _, st in p.parts]
            assert all(st.fwd_done.stream is st.stream for st in states)
            waves = pipeline._forward_waves(
                [(pipeline._forward_blocks(st), st.L) for st in states], sms)
            assert len(waves) == (1 if sms == 0 else 2)
            for prev, wave in zip([[]] + waves, waves):
                for i in wave:
                    assert states[i].stream.waited == [
                        states[j].fwd_done for j in prev]
        entered.clear()
        got_a = _async(a)
        assert all(st.stream is None for _, st in a.parts)
        assert {id(s) for s in pool.free} == {id(s) for s in streams[:3]}
        assert {id(s) for s in entered} == {id(s) for s in streams[:3]}
        c3 = pipeline.align_batch_launch(reqs[2], "cpu")
        assert {id(st.stream) for _, st in c3.parts} == \
            {id(s) for s in streams[:3]}
        got_b, got_c = _async(b), _async(c3)
    assert c.counts["leaf_streams"] == 9 and len(pool.free) == 6
    for r, got in zip(reqs, (got_a, got_b, got_c)):
        _assert_same(pipeline.align_batch(r, "cpu"), got)


@pytest.mark.parametrize("leaves,sms,want", [
    # the Ion Torrent headline's five leaves unsplit (blocks of four
    # reads, lane bucket)
    ([(47, 128), (74, 192), (71, 256), (45, 320), (16, 576)], 132,
     [[4, 3, 2], [1, 0]]),
    # Illumina's leaves: each has more blocks than the card has SMs
    ([(256, 128), (256, 128)], 132, [[0], [1]]),
    # exactly full, then one more block
    ([(64, 64), (68, 128), (1, 192)], 132, [[2, 1], [0]]),
    ([(132, 64), (1, 64)], 132, [[0], [1]]),
    # the CPU: one wave in the plan's order
    ([(47, 128), (74, 192), (16, 576)], 0, [[0, 1, 2]]),
])
def test_forward_waves(leaves, sms, want):
    assert pipeline._forward_waves(leaves, sms) == want


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


def _ion_headline():
    """tools/make_data.py's Ion Torrent run (the reference README's
    headline), drawn as make_iontorrent draws it: 1,000 reads of
    normal(200, 80) bp clipped to 25-540, 1 % substitutions, against its
    4,938,920-base genome (codes 0-3)."""
    rng = np.random.default_rng(4_938_920)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    code = np.zeros(256, np.int8)
    code[bases] = np.arange(4)
    genome = rng.choice(bases, 4_938_920).astype(np.uint8)
    reads = []
    for _ in range(1000):
        ln = int(np.clip(rng.normal(200, 80), 25, 540))
        pos = int(rng.integers(0, len(genome) - ln))
        rd = genome[pos:pos + ln].copy()
        m = rng.random(ln) < 0.01
        if m.any():
            rd[m] = rng.choice(bases, int(m.sum()))
        reads.append(code[rd])
    return _req(reads, code[genome])


def _streams_distinct(pends):
    handles = [st.stream.cuda_stream for p in pends for _, st in p.parts]
    return len(set(handles)) == len(handles)


@pytest.mark.cuda
def test_card_ion_headline_pooled_equals_align_batch(card):
    req = _ion_headline()
    leaves = len(pipeline._plan_leaves(req))
    assert leaves >= 2
    want, want_err = _run(lambda: pipeline.align_batch(req, card))
    with pipeline.profiled(profiling.GcupsCounter()) as c:
        pend = pipeline.align_batch_launch(req, card)
        assert _streams_distinct([pend])
        got, got_err = _run(lambda: _async(pend))
    assert c.counts["leaf_streams"] == leaves
    _assert_same(want, got)
    assert got_err == want_err


@pytest.mark.cuda
def test_card_double_buffer_with_rc_equals_one_stream(card, monkeypatch):
    """cli.main's double buffer under -r (cli.launch_batch /
    complete_batch): both strands of batch 2 are launched before batch 1's
    mid, and each batch is finished with the strand winners' detail masks.
    Pooled, it must give what the same calls give with every leaf on the
    caller's stream in the plan's order, and each strand what align_batch
    gives where its traceback ran."""
    rng = np.random.default_rng(2_333_444_555)
    ref = rng.integers(0, 4, (1 << 20) + 777).astype(np.int8)
    batches = []
    for _ in range(2):
        fwd = _reads(rng, ref, np.full(2048, 100), 0.005)
        rc = [(3 - r[::-1]).astype(np.int8) for r in fwd]
        batches.append((_req(fwd, ref), _req(rc, ref)))

    def double_buffered():
        pends = [[pipeline.align_batch_launch(q, card) for q in b]
                 for b in batches]
        out = []
        for pf, pr in pends:
            s_f = pipeline.align_batch_scores(pf)
            s_r = pipeline.align_batch_scores(pr)
            rc_wins = s_r > s_f  # cli.complete_batch's pick at -f 0
            out.append((rc_wins,
                        pipeline.align_batch_finish(pf, detail=~rc_wins),
                        pipeline.align_batch_finish(pr, detail=rc_wins)))
        return out

    with pipeline.profiled(profiling.GcupsCounter()) as c:
        got, got_err = _run(double_buffered)
    assert c.counts["leaf_streams"] == 8
    with monkeypatch.context() as m:  # the parent's one stream, in order
        m.setattr(pipeline, "_leaf_stream", lambda dev, ref_d: None)
        m.setattr(pipeline, "_sm_count", lambda dev: 0)
        want, want_err = _run(double_buffered)
    assert got_err == want_err
    for (w_win, wf, wr), (g_win, gf, gr), (f, r) in zip(want, got,
                                                         batches):
        assert (w_win == g_win).all()
        _assert_same(wf, gf)
        _assert_same(wr, gr)
        full_f = pipeline.align_batch(f, card)
        full_r = pipeline.align_batch(r, card)
        for i in range(len(gf)):
            a, b = (gr[i], full_r[i]) if g_win[i] else (gf[i], full_f[i])
            assert vars(a) == vars(b), i


@pytest.mark.cuda
def test_card_ref_cache_evicted_while_leaves_read(card):
    """Seven distinct targets in flight at once evict the first from the
    six-entry _REF_CACHE while its leaf still reads it; memory churned on
    the caller's stream meanwhile must not reach the leaves' targets."""
    rng = np.random.default_rng(7_000_000_007)
    reqs = []
    for t in range(7):
        # alternate the full suboptimal scan and the streaming one
        R = (1 << 18) + 313 * t if t % 2 else (1 << 20) + 313 * t
        ref = rng.integers(0, 4, R).astype(np.int8)
        lengths = rng.integers(60, 260, 300)
        reqs.append(_req(_reads(rng, ref, lengths, 0.02), ref))
    pipeline._REF_CACHE.clear()
    with pipeline.profiled(profiling.GcupsCounter()) as c:
        pends = [pipeline.align_batch_launch(r, card) for r in reqs]
        assert len(pipeline._REF_CACHE) == pipeline._REF_CACHE_CAP
        assert _streams_distinct(pends)
        gc.collect()
        for _ in range(4):  # churn on the caller's stream
            junk = torch.full((1 << 22,), -1, dtype=torch.int32, device=card)
            del junk
        got, got_err = _run(lambda: [_async(p) for p in pends])
    assert c.counts["leaf_streams"] == sum(
        len(pipeline._plan_leaves(r)) for r in reqs)
    want, want_err = _run(lambda: [pipeline.align_batch(r, card)
                                   for r in reqs])
    for w, g in zip(want, got):
        _assert_same(w, g)
    assert got_err == want_err
