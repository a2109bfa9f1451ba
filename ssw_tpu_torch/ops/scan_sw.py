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
  outputs   scores/ends (B,) int32, max_column (B, R) int16 in [0, 32767]
"""

from __future__ import annotations

import torch

NEG = -(2 ** 28)
SEG_BUMP = 2 ** 21
BM = 256  # block width of the per-block maxima (blockmax_reduce)

_I32 = torch.int32


def _shift_right(x, fill: int):
    """x shifted one lane up the read dimension, lane 0 = fill."""
    col = torch.full((x.shape[0], 1), fill, dtype=x.dtype, device=x.device)
    return torch.cat([col, x[:, :-1]], dim=1)


def _column_update(sub, state, gapO, gapE, decay, seg_bias, seg_reset,
                   col_mask, col_idx, quirk=True, gate=True):
    """One ref column for the whole batch.  sub: (B, L) substitution scores.

    quirk=False drops the lane-block E restriction; valid (bit-identical)
    whenever min(mat) >= -2*gapE, where an adjacent insertion+deletion can
    never beat the substitution it replaces (see core/oracle.py)."""
    H, E, gmax, end_ref, h_best = state
    h_diag = _shift_right(H, 0) + sub
    h_tilde = torch.maximum(h_diag, E).clamp_min_(0)
    c = h_tilde - gapO + decay
    # full prefix-max -> F -> H
    cm = torch.cummax(c, dim=1).values
    F = (_shift_right(cm, NEG) - decay + gapE).clamp_min_(0)
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
                       gapO: int, gapE: int, quirk: bool = True):
    """Forward pass of a read batch against one shared target.

    Returns (score (B,), end_ref (B,), end_read (B,), max_column (B, R)
    int16 clamped at the reference word kernel's saturation, 32767)."""
    B, _, L = profile.shape
    dev = profile.device
    prof_t = profile.to(_I32).permute(1, 0, 2).contiguous()  # (n+1, B, L)
    decay, seg_bias, seg_reset = _geometry(seg_id, seg_start, L, gapE, dev)
    col_mask = col_mask.to(torch.bool)
    R = int(ref.shape[0])
    codes = ref.tolist()
    state = _init_state(B, L, dev)
    mc = torch.empty((R, B), dtype=torch.int16, device=dev)
    for j in range(R):
        state, colmax = _column_update(prof_t[codes[j]], state, gapO, gapE,
                                       decay, seg_bias, seg_reset, col_mask,
                                       j, quirk)
        # clamp at the reference word kernel's saturation point before the
        # narrowing (ref: _mm_adds_epi16 saturates at 32767)
        mc[j] = colmax.clamp_max(32767)
    score, end_ref, end_read = _finalize(state, read_len, L)
    return score, end_ref, end_read, mc.t().contiguous()


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
