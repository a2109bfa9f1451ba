"""Plain PyTorch versions of the batched striped-SW DP (one column per step).

These are the semantic twins of the CUDA kernels in ops/cuda_sw.py: the
CPU tests run them, and chip_smoke.py holds each kernel against them on the
card.  They are never on the main path when a card is present.  Semantics
are those of the JAX package's ops/scan_sw.py: Farrar's lazy-F correction
loop (ref: src/ssw.c:301-315) becomes a prefix max (torch.cummax) over the
read dimension, and the reference's E-update-before-lazy-F quirk is a
second prefix max that is segmented by SIMD lane block (see core/oracle.py;
exact for gapO > gapE).  All DP arithmetic is int32.

Shapes:
  profile   (B, n+1, L) int8/int32  per-read query profile incl. virtual pad row
  ref       (R,) int32              shared target, or refw (B, W) per-read windows
  outputs   scores/ends (B,) int32, max_column (B, R) int16 in [0, 32767],
            or per-block maxima (B, ceil(R/BM)) int32 in blockmax mode
"""

from __future__ import annotations

import torch

from ssw_tpu_torch.ops import gate as gate_mod
from ssw_tpu_torch.ops import pack

NEG = -(2 ** 28)
SEG_BUMP = 2 ** 21
BM = 256  # block width of the per-block maxima (blockmax_reduce)

_I32 = torch.int32


def _shift_right(x, fill: int):
    """x shifted one lane up the read dimension, lane 0 = fill."""
    col = torch.full((x.shape[0], 1), fill, dtype=x.dtype, device=x.device)
    return torch.cat([col, x[:, :-1]], dim=1)


def _truncated_prefix(c, depth):
    """The exclusive prefix max of c (B, L) along the row as a warp of 32
    threads of K = L/32 consecutive lanes computes it when read b's column
    runs depth[b] of the 5 shuffle steps (csrc/sw_dp.cuh dp_column): the
    thread totals, depth Hillis-Steele steps over them and the `run` shift
    give thread t the totals of threads t - 2^depth .. t - 1, and the
    in-thread sweep adds the lanes before p in its own thread.  Depth 5 is
    the whole prefix."""
    B, L = c.shape
    if L % 32:
        raise ValueError(f"L = {L}: the gated scan models 32 threads")
    K = L // 32
    ct = c.view(B, 32, K)
    tot = ct.amax(dim=2)
    for s in range(gate_mod.DEPTHS):
        y = torch.nn.functional.pad(tot[:, :-(1 << s)], (1 << s, 0),
                                    value=NEG)
        tot = torch.where((depth > s)[:, None], torch.maximum(tot, y), tot)
    run = _shift_right(tot, NEG)
    seq = torch.cat([run[:, :, None], ct], dim=2)
    return torch.cummax(seq, dim=2).values[:, :, :K].reshape(B, L)


def _column_update(sub, state, gapO, gapE, decay, seg_bias, seg_reset,
                   col_mask, col_idx, quirk=True, gate=True, depth=None):
    """One ref column for the whole batch.  sub: (B, L) substitution scores.

    quirk=False drops the lane-block E restriction; valid (bit-identical)
    whenever min(mat) >= -2*gapE, where an adjacent insertion+deletion can
    never beat the substitution it replaces (see core/oracle.py).  gate:
    (B,) bool, which reads may take a new best hit.  depth: (B,) scan
    depths of the bounded-radius gate (None: the whole prefix max)."""
    H, E, gmax, end_ref, h_best = state
    h_diag = _shift_right(H, 0) + sub
    h_tilde = torch.maximum(h_diag, E).clamp_min_(0)
    c = h_tilde - gapO + decay
    # prefix-max (full, or the gate's truncated scan) -> F -> H
    if depth is None:
        prev = _shift_right(torch.cummax(c, dim=1).values, NEG)
    else:
        prev = _truncated_prefix(c, depth)
    F = (prev - decay + gapE).clamp_min_(0)
    H = torch.maximum(h_tilde, F)
    if quirk:
        # lane-block segmented prefix-max -> F_loc -> the H the E-update sees
        cs = torch.cummax(c + seg_bias, dim=1).values - seg_bias
        F_loc = _shift_right(cs, NEG) - decay + gapE
        F_loc = torch.where(seg_reset, 0, F_loc.clamp_min_(0))
        h_fp = torch.maximum(h_tilde, F_loc)
    else:
        h_fp = H
    E = torch.maximum(E - gapE, h_fp - gapO).clamp_min_(0)

    colmax = torch.where(col_mask, H, 0).amax(dim=1)
    upd = (colmax > gmax) & gate
    gmax = torch.where(upd, colmax, gmax)
    end_ref = torch.where(upd, col_idx, end_ref)
    h_best = torch.where(upd[:, None], H, h_best)
    return (H, E, gmax, end_ref, h_best), colmax


def _init_state(B, L, device):
    z = torch.zeros((B, L), dtype=_I32, device=device)
    return (z, z.clone(), torch.zeros(B, dtype=_I32, device=device),
            torch.full((B,), -1, dtype=_I32, device=device), z.clone())


def _geometry(seg_id, seg_start, L, gapE, device):
    """decay (1, L), seg_bias (B, L) and seg_reset (B, L) of a batch."""
    decay = torch.arange(L, dtype=_I32, device=device)[None, :] * gapE
    sid = seg_id.to(_I32)
    seg_bias = sid * SEG_BUMP  # upcast BEFORE the bias
    seg_reset = seg_start.to(torch.bool) | (_shift_right(sid, -1) != sid)
    return decay, seg_bias, seg_reset


def _finalize(state, read_len, L):
    H, E, gmax, end_ref, h_best = state
    j = torch.arange(L, dtype=_I32, device=gmax.device)[None, :]
    rl = read_len.to(_I32)
    hit = ((h_best == gmax[:, None]) & (j < rl[:, None])
           & (gmax[:, None] > 0))
    end_read = torch.where(hit, j, L).amin(dim=1).to(_I32)
    end_read = torch.where(end_read == L, rl - 1, end_read)
    return gmax, end_ref, end_read


def forward_shared_ref(profile, ref, read_len, col_mask, seg_id, seg_start,
                       gapO: int, gapE: int, quirk: bool = True,
                       blockmax: bool = False, valid_len: int | None = None,
                       wmask=None, gate=None, pairs: bool = False,
                       steps: bool = False, idx=None, own=None):
    """Forward pass of a read batch against one shared target.

    Returns (score (B,), end_ref (B,), end_read (B,), max_column (B, R)
    int16 clamped at the reference word kernel's saturation, 32767).

    blockmax: instead of max_column, blockmax_reduce of the unclamped
    column maxima over the columns i < valid_len (default R): (B,
    ceil(R/BM)) int32, zero-floored and NOT clamped (the streaming
    composition clamps).  The other outputs are unchanged: every column
    still feeds the best hit.

    wmask (B, L) bool, blockmax with the quirk off only (the dual tier):
    col_mask is then the byte-tier mask and wmask the word tier's (a subset
    of it), and the block maxima come back (B, 2, ceil(R/BM)): channel 0
    over col_mask lanes, channel 1 over wmask lanes.  With the quirk off the
    two tiers differ only in which pad rows feed the column maxima, so one
    pass answers both.

    gate: per-depth thresholds of the bounded-radius gate (ops/gate.py):
    each read's column runs the truncated scan of the depth its previous
    column's masked max selects, as the kernels do; the outputs do not
    change.  pairs: the int16 tier's warps (reads 2p and 2p+1 share one
    depth, from the larger of their two maxima).  steps: also return the
    (6,) int64 count of warp-column steps by depth (one per pair with
    pairs), as the kernels' histogram counts them.

    idx (R,) int32 and own (R,) bool, together: the owned-column mode of
    forward_shared_ref_gated.  Only columns with own[j] may take a new best
    hit, and end_ref is idx[j] of its column; every column still emits its
    maximum and drives the gate."""
    B, _, L = profile.shape
    dev = profile.device
    dual = wmask is not None
    if dual and (quirk or not blockmax):
        raise ValueError("the dual tier is a blockmax mode with the quirk "
                         "off")
    prof_t = profile.to(_I32).permute(1, 0, 2).contiguous()  # (n+1, B, L)
    decay, seg_bias, seg_reset = _geometry(seg_id, seg_start, L, gapE, dev)
    col_mask = col_mask.to(torch.bool)
    R = int(ref.shape[0])
    codes = ref.tolist()
    cols = range(R) if idx is None else idx.tolist()
    owned = [True] * R if own is None else own.tolist()
    state = _init_state(B, L, dev)
    mc = torch.empty((R, B), dtype=_I32, device=dev)
    mcw = None
    if dual:
        wmask = wmask.to(torch.bool)
        mcw = torch.empty((R, B), dtype=_I32, device=dev)
    hist = torch.zeros(gate_mod.DEPTHS + 1, dtype=torch.int64, device=dev)
    hm = torch.zeros(B, dtype=_I32, device=dev)  # colmax(j - 1), lag 1
    depth = None
    if gate is not None:  # depth = #{m : hm > thr[m]}
        thr = torch.tensor(gate, dtype=_I32, device=dev)
    for j in range(R):
        if gate is not None:
            if pairs:  # one depth per warp of two reads
                hp = torch.nn.functional.pad(hm, (0, B % 2)).view(-1, 2)
                dp = torch.bucketize(hp.amax(dim=1), thr)
                depth = dp.repeat_interleave(2)[:B]
            else:
                dp = depth = torch.bucketize(hm, thr)
            if steps:
                hist += torch.bincount(dp, minlength=gate_mod.DEPTHS + 1)
        state, mc[j] = _column_update(prof_t[codes[j]], state, gapO, gapE,
                                      decay, seg_bias, seg_reset, col_mask,
                                      cols[j], quirk, gate=bool(owned[j]),
                                      depth=depth)
        hm = mc[j]
        if dual:
            mcw[j] = torch.where(wmask, state[0], 0).amax(dim=1)
    score, end_ref, end_read = _finalize(state, read_len, L)
    if blockmax:
        vl = R if valid_len is None else int(valid_len)
        bm = blockmax_reduce(mc.t(), vl)
        if dual:
            bm = torch.stack([bm, blockmax_reduce(mcw.t(), vl)], dim=1)
        out = (score, end_ref, end_read, bm)
    else:
        # clamp at the reference word kernel's saturation point before the
        # narrowing (ref: _mm_adds_epi16 saturates at 32767)
        out = (score, end_ref, end_read,
               mc.clamp_max(32767).to(torch.int16).t().contiguous())
    return (out, hist) if steps else out


def forward_shared_ref_gated(profile, ref, idxs, owned, read_len, col_mask,
                             seg_id, seg_start, gapO: int, gapE: int,
                             quirk: bool = True, gate=None,
                             pairs: bool = False, steps: bool = False):
    """forward_shared_ref with per-column global indices idxs (R,) int32
    and an owned (R,) bool gate on best-hit tracking: the counterpart of
    the JAX package's scan_sw.forward_shared_ref_gated, used by the
    sequence-parallel shards whose warm-up (halo) columns are inexact
    (parallel/dist.py).  Per-column maxima (B, R) int16 are emitted for
    every local column.  gate/pairs/steps as forward_shared_ref's (the
    bounded-radius gate, not this ownership gate)."""
    return forward_shared_ref(profile, ref, read_len, col_mask, seg_id,
                              seg_start, gapO, gapE, quirk, gate=gate,
                              pairs=pairs, steps=steps, idx=idxs, own=owned)


def forward_perread_ref(profile, refw, read_len, col_mask, seg_id, seg_start,
                        gapO: int, gapE: int, quirk: bool = True,
                        terminate=None, emit_maxcol: bool = False):
    """Forward pass where every read has its own reference window (B, W);
    used by the begin-finding reverse pass.

    terminate: optional (B,) int32 — stop recording new best hits after the
    column whose masked max equals the value (the reference kernels break
    out of the column loop there, ref: src/ssw.c:339-341), so the returned
    best is the best up to and including that column.  -1 disables.

    emit_maxcol: also return per-column maxima (B, W) int32 (>= 0, NOT
    clamped at 32767)."""
    B, _, L = profile.shape
    dev = profile.device
    prof = profile.to(_I32)
    decay, seg_bias, seg_reset = _geometry(seg_id, seg_start, L, gapE, dev)
    col_mask = col_mask.to(torch.bool)
    if terminate is None:
        terminate = torch.full((B,), -1, dtype=_I32, device=dev)
    W = int(refw.shape[1])
    codes = refw.to(torch.long)
    rows = torch.arange(B, device=dev)
    state = _init_state(B, L, dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    mc = torch.empty((W, B), dtype=_I32, device=dev) if emit_maxcol else None
    for w in range(W):
        state, colmax = _column_update(prof[rows, codes[:, w]], state, gapO,
                                       gapE, decay, seg_bias, seg_reset,
                                       col_mask, w, quirk, gate=~done)
        done = done | (colmax == terminate)
        if emit_maxcol:
            mc[w] = colmax
    out = _finalize(state, read_len, L)
    if emit_maxcol:
        return out + (mc.t().contiguous(),)
    return out


def forward_shared_ref_packed(profile, ref, so, sl, rl_s, flat_idx,
                              gapO: int, gapE: int,
                              max_sub: int | None = None,
                              valid_len: int | None = None,
                              quirk: bool = False, word: bool = False,
                              dual: bool = False, gate=None,
                              steps: bool = False, stretches: int = 1):
    """Forward pass of LANE-PACKED rows (ops/pack.py): the plain version of
    the JAX kernel's packed mode, run on the packed layout itself (with
    gate=, as the kernel runs it: _packed_slots_ref).

    profile (n_rows, n+1, W) over the packed codes (common.pack_codes);
    so/sl/rl_s (n_rows, S) slot tables (common.pack_tables); flat_idx (B,)
    = row * S + slot of each read.  Returns per read (score, end_ref,
    end_read) (B,) int32 and block maxima over the columns < valid_len
    (default and at most R): (B, ceil(R/BM)) int32, or (B, 2, ceil(R/BM))
    with dual (byte-tier slot lanes, then word-tier lanes: pack_geometry's
    wcol).  Only columns < valid_len feed the best hit (the JAX kernel's
    `own` gate).  Per read the outputs equal forward_shared_ref's blockmax
    mode on the unpacked layout.

    Each slot's lanes see exactly an unpacked row's DP: the slot bias
    (slot_id * PACK_BUMP) rides dmg and its removal gmd, so carries across a
    slot boundary land ~PACK_BUMP below any value of the slot they enter;
    h_diag is cut and F poisoned (gmd = NEG) at slot starts; the decay
    restarts at lane_off.  The quirk's lane-block scan adds qseg * QBUMP
    under the slot bias (word: the 8-block geometry), exact while
    check_quirk_span holds.

    stretches: run the columns as the kernel's split launch does (at most
    that many stretches, pack.stretch_bounds; ungated only): each stretch
    from zero state pack.stretch_halo columns before the columns it owns,
    taking best hits and block maxima in those alone, the lanes' trackers
    merged in column order.  The outputs are the same."""
    Br, n1, W = profile.shape
    S = int(so.shape[1])
    dev = profile.device
    if dual and quirk:
        raise ValueError("the dual tier needs the quirk off")
    if quirk:
        pack.check_quirk_span(pack.slot_max(sl), max_sub, gapO, gapE)
    if gate is not None:
        if stretches != 1:
            raise ValueError("a gated launch runs the whole target")
        return _packed_slots_ref(profile, ref, so, sl, rl_s, flat_idx, gapO,
                                 gapE, valid_len, quirk, word, dual, gate,
                                 steps)
    col_mask, slot_id, slot_start, lane_off, qseg, wcol = pack.pack_geometry(
        so, sl, rl_s, W, 8 if word else 16)
    seg_bias = slot_id * pack.PACK_BUMP
    slot_reset = slot_start | (_shift_right(slot_id, -1) != slot_id)
    decay = lane_off * gapE
    dmg = decay - gapO + seg_bias
    gmd = torch.where(slot_reset, NEG,
                      gapE - decay - _shift_right(seg_bias, 0))
    if quirk:
        qb = qseg * pack.QBUMP
        rst = slot_reset | (_shift_right(qb, -1) != qb)
        decay_q = gapE - gmd
    R = int(ref.shape[0])
    vl = R if valid_len is None else min(int(valid_len), R)
    nblk = (R + BM - 1) // BM
    S2 = 2 * S if dual else S
    prof_t = profile.to(_I32).permute(1, 0, 2).contiguous()  # (n+1, Br, W)
    codes = ref.tolist()
    bv = torch.zeros((Br, W), dtype=_I32, device=dev)
    bc = torch.full_like(bv, -1)
    run = torch.full_like(bv, NEG)  # per-lane max of the current block
    maxcol = torch.zeros((Br, nblk, S2), dtype=_I32, device=dev)
    ids = slot_id.long()

    def per_slot(x):
        out = torch.full((Br, S), NEG, dtype=_I32, device=dev)
        return out.scatter_reduce(1, ids, x, "amax").clamp_min(0)

    P, C = pack.stretch_bounds(vl, stretches)
    halo = pack.stretch_halo(pack.packed_lanes(pack.slot_max(sl)), max_sub,
                             gapO, gapE) if P > 1 else 0
    for first, own, end in pack.stretch_spans(vl, P, C, halo):
        H = torch.zeros_like(bv)
        E = torch.zeros_like(bv)
        sv = torch.zeros_like(bv)  # this stretch's trackers
        sc = torch.full_like(bv, -1)
        for j in range(first, end):
            h_tilde = torch.maximum(
                torch.where(slot_reset, 0, _shift_right(H, 0))
                + prof_t[codes[j]], E)
            c = h_tilde + dmg
            F = _shift_right(torch.cummax(c, dim=1).values, NEG) + gmd
            H = torch.maximum(h_tilde, F)
            if quirk:
                cs = torch.cummax(c + qb, dim=1).values - qb
                F_loc = _shift_right(cs, NEG) - decay_q + gapE
                F_loc = torch.where(rst, 0, F_loc.clamp_min(0))
                h_fp = torch.maximum(h_tilde, F_loc)
            else:
                h_fp = H
            E = torch.maximum(E - gapE, h_fp - gapO).clamp_min(0)
            if j < own:  # the halo: warm-up only
                continue
            Hv = torch.where(col_mask, H, NEG)
            imp = Hv > sv
            sv = torch.where(imp, Hv, sv)
            sc = torch.where(imp, j, sc)
            run = torch.maximum(run, Hv)
            if j % BM == BM - 1 or j == vl - 1:
                maxcol[:, j // BM, :S] = per_slot(run)
                if dual:
                    maxcol[:, j // BM, S:] = per_slot(
                        torch.where(wcol, run, NEG))
                run.fill_(NEG)
        imp = sv > bv  # a later stretch wins only with a higher value
        bv = torch.where(imp, sv, bv)
        bc = torch.where(imp, sc, bc)
    tables = pack.pack_reconstruct(bv, bc, maxcol.reshape(Br, nblk * S2),
                                   slot_id, lane_off, rl_s.to(dev), S, dual)
    return pack.gather_reads(*tables, flat_idx.to(dev), S, dual)


def _packed_slots_ref(profile, ref, so, sl, rl_s, flat_idx, gapO, gapE,
                      valid_len, quirk, word, dual, gate, steps):
    """forward_shared_ref_packed as csrc/sw_forward_packed.cu computes it,
    for the gated kernel: every read's slot cut out of its packed row into a
    row of its own, Lw = pack.packed_lanes(longest slot) lanes (lane j =
    the slot's lane j, the virtual letter's zero scores past the slot),
    col_mask j < sl, the quirk's nb lane blocks of sl/nb lanes as the lane
    segments, dual's word lanes j < min(sl, round_up(rl, 8)); then the
    unpacked blockmax pass over the columns < valid_len with the gate, and
    zero block maxima past them."""
    n1, W = profile.shape[1:]
    S = int(so.shape[1])
    dev = profile.device
    R = int(ref.shape[0])
    vl = R if valid_len is None else min(int(valid_len), R)
    fi = flat_idx.to(dev).long()
    row = fi // S
    o, ln, rl = (t.to(dev).reshape(-1)[fi].to(_I32) for t in (so, sl, rl_s))
    Lw = pack.packed_lanes(int(ln.max()) if ln.numel() else 0)
    j = torch.arange(Lw, dtype=_I32, device=dev)[None, :]
    inside = j < ln[:, None]
    src = (o[:, None] + j).clamp(max=W - 1).long()
    prof = torch.gather(profile[row], 2,
                        src[:, None, :].expand(-1, n1, -1))
    prof = torch.where(inside[:, None, :], prof, 0)
    nb = 8 if word else 16
    seg = (j * nb // ln.clamp_min(1)[:, None]).clamp(max=nb - 1)
    wmask = (j < torch.minimum(ln, (rl + 7) // 8 * 8)[:, None]) if dual \
        else None
    res = forward_shared_ref(
        prof, ref[:vl], rl, inside, seg.to(torch.int8),
        torch.zeros_like(inside), gapO, gapE, quirk, blockmax=True,
        valid_len=vl, wmask=wmask, gate=gate, steps=steps)
    out, hist = res if steps else (res, None)
    bm = out[3]
    nblk = (R + BM - 1) // BM
    pad = torch.zeros(bm.shape[:-1] + (nblk - bm.shape[-1],), dtype=_I32,
                      device=dev)
    out = out[:3] + (torch.cat([bm, pad], dim=-1).contiguous(),)
    return (out, hist) if steps else out


def blockmax_reduce(max_column, ref_len: int):
    """(B, R) per-column maxima -> (B, ceil(R/BM)) int32 per-block maxima
    over the valid columns (i < ref_len), zero-floored."""
    B, R = max_column.shape
    Rp = (R + BM - 1) // BM * BM
    mc = torch.zeros((B, Rp), dtype=_I32, device=max_column.device)
    mc[:, :R] = max_column.to(_I32)
    mc[:, min(ref_len, Rp):] = 0
    return mc.reshape(B, Rp // BM, BM).amax(dim=2)


# rows of a (B, R) maxima array reduced at once: bounds the (rows, R)
# temporaries of second_best_batch to ~0.5 GB at any target length
_SUBOPT_ELEMS = 1 << 26


def second_best_batch(max_column, end_ref, mask_len, ref_len, word_mask):
    """Suboptimal-score scan (ref: src/ssw.c:368-381, 570-583).

    max_column: (B, R) int16 (R may include bucket padding past ref_len);
    word_mask: (B,) bool selecting the word-tier window edge semantics.
    Returns (score2 (B,), ref_end2 (B,)) int32; ref_end2 is the FIRST index
    attaining score2 (ties never displace earlier winners).  Reduced in the
    maxima's own dtype and in row chunks, so the (B, R) masks never
    materialize whole."""
    B, R = max_column.shape
    dev = max_column.device
    end_ref = end_ref.to(_I32)
    mask_len = mask_len.to(_I32)
    lo_edge = (end_ref - mask_len).clamp_min(0)[:, None]
    hi_edge = (end_ref + mask_len).clamp_max(ref_len)[:, None]
    start_hi = torch.where(word_mask.to(torch.bool)[:, None], hi_edge,
                           hi_edge + 1)
    i = torch.arange(R, dtype=_I32, device=dev)[None, :]
    score2 = torch.empty(B, dtype=_I32, device=dev)
    ref_end2 = torch.empty(B, dtype=_I32, device=dev)
    step = max(1, _SUBOPT_ELEMS // max(R, 1))
    for lo in range(0, B, step):
        hi = min(lo + step, B)
        allowed = (((i < lo_edge[lo:hi]) | (i >= start_hi[lo:hi]))
                   & (i < ref_len))
        vals = torch.where(allowed, max_column[lo:hi], 0)
        s2 = vals.amax(dim=1)
        first = torch.where(vals == s2[:, None], i, R).amin(dim=1)
        score2[lo:hi] = s2
        ref_end2[lo:hi] = torch.where(s2 > 0, first, 0)
    return score2, ref_end2
