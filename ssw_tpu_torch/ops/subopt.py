"""Streaming (bounded-memory) suboptimal-score scan.

The reference scans the full per-column maxima array outside the maskLen
window around the best hit (ref: src/ssw.c:358-381, 570-583).  Holding that
array is (B, R) int16: 2 GB for 1024 reads on 1 Mbp, 21 GB on 10 Mbp, which
caps a leaf's rows for long targets.  This module computes the identical
(score2, ref_end2) from

  1. per-BLOCK column maxima (B, ceil(R/BM)) from the forward kernel's
     blockmax mode (BM = 256 columns per block), and
  2. two bounded per-read window re-runs of the DP (the reverse kernel with
     emit_maxcol) that rebuild column-resolution maxima exactly where block
     resolution is not enough: the blocks straddling the exclusion window,
     and the first block that attains the winning value (for the
     first-index tie-break).

Exactness of the window re-runs rests on a restart bound: a DP dependency
chain can only look back D columns, because every chain step either moves
one lane up (at most L lane steps, including the zero-cost diagonal rides
through padded rows) or pays gapE from a cell value bounded by L*max|mat|.
So re-running the DP from zero state D columns before the region of
interest reproduces its column maxima exactly (pipeline._restart_margin).

All comparisons happen on values clamped to [0, 32767]: the reference word
kernel saturates at 32767 (_mm_adds_epi16) and the non-streaming path
clamps per column before its int16 narrowing, so the first-index tie-break
must see the clamped values here too.

Plain torch tensor ops (gathers, masked reductions); they run on the card
as glue around the kernels.  Semantics are those of the JAX package's
ops/subopt.py, tie-breaks included: jnp.argmax of a row returns its FIRST
maximal index, which _first reproduces without relying on torch.argmax's
tie order.
"""

from __future__ import annotations

import torch

BM = 256  # block width; the forward kernels' blockmax mode emits one
          # maximum per BM columns (csrc/sw_dp.cuh kBlockCols)

_I32 = torch.int32


def _clamp(x):
    return x.to(_I32).clamp(0, 32767)


def _first(hit):
    """Index of the first True of each row of hit (B, W); 0 for a row with
    none (jnp.argmax of a bool row)."""
    W = hit.shape[1]
    k = torch.arange(W, dtype=_I32, device=hit.device)[None, :]
    first = torch.where(hit, k, W).amin(dim=1)
    return torch.where(first == W, 0, first)


def _edges(end_ref, mask_len, word, ref_len: int):
    """The exclusion-window edges, exactly as scan_sw.second_best_batch
    (byte tier excludes [lo, hi_edge], word tier [lo, hi_edge): the
    reference kernels' scan-start asymmetry, ref: src/ssw.c:376 vs :578)."""
    lo = (end_ref - mask_len).clamp_min(0)
    hi_edge = (end_ref + mask_len).clamp_max(ref_len)
    start_hi = torch.where(word, hi_edge, hi_edge + 1)
    return lo, start_hi


def gather_windows(ref_ext, starts, Wb: int):
    """Per-read reference windows ref_ext[starts[b] : starts[b] + Wb]
    (B, Wb) int32.  ref_ext must be padded so starts + Wb never reaches the
    end (no clamping)."""
    k = torch.arange(Wb, dtype=torch.long, device=ref_ext.device)[None, :]
    return ref_ext[starts.long()[:, None] + k].to(_I32).contiguous()


def compose_window(blockmax, mc_win, ws, end_ref, mask_len, word,
                   ref_len: int):
    """First composition stage.

    blockmax: (B, nblk) int32 per-block maxima over valid columns.
    mc_win:   (B, Wb) int32 per-column maxima of the window re-run; column
              k of read b is global column ws[b] + k, exact inside the
              partial zone [blo*BM, (bhi+1)*BM).
    Returns score2 plus everything the tie-break needs:
      hasA/hasP/hasB: which ordered region (blocks before the window /
      partial zone / blocks after) first attains score2;
      firstP_i: first attaining global column inside the partial zone;
      bstar: first attaining block for the block regions (resolved to a
      column by a second window re-run)."""
    nblk = blockmax.shape[1]
    Wb = mc_win.shape[1]
    dev = blockmax.device
    bm = _clamp(blockmax)
    mw = _clamp(mc_win)
    lo, start_hi = _edges(end_ref, mask_len, word, ref_len)
    blo = lo // BM
    bhi = start_hi // BM
    idxb = torch.arange(nblk, dtype=_I32, device=dev)[None, :]
    bmA = torch.where(idxb < blo[:, None], bm, 0)
    bmB = torch.where(idxb > bhi[:, None], bm, 0)
    maxA = bmA.amax(dim=1)
    maxB = bmB.amax(dim=1)

    gi = ws[:, None] + torch.arange(Wb, dtype=_I32, device=dev)[None, :]
    allowed = ((gi >= (blo * BM)[:, None]) & (gi < ((bhi + 1) * BM)[:, None])
               & (gi < ref_len)
               & ((gi < lo[:, None]) | (gi >= start_hi[:, None])))
    pv = torch.where(allowed, mw, 0)
    maxP = pv.amax(dim=1)

    score2 = torch.maximum(maxA, torch.maximum(maxP, maxB))
    pos = score2 > 0
    hasA = (maxA == score2) & pos
    hasP = (maxP == score2) & pos
    hasB = (maxB == score2) & pos
    firstP_k = _first(pv == score2[:, None])
    firstP_i = torch.gather(gi, 1, firstP_k.long()[:, None])[:, 0]
    bstarA = _first(bmA == score2[:, None])
    bstarB = _first(bmB == score2[:, None])
    bstar = torch.where(hasA, bstarA, bstarB)
    return score2, hasA, hasP, hasB, firstP_i, bstar


def resolve_block(mc2, ws2, bstar, score2, ref_len: int):
    """First global column inside block bstar (valid columns only) whose
    per-column maximum equals score2.  Block-region columns are always
    outside the exclusion window, so no window predicate applies here."""
    Wb2 = mc2.shape[1]
    m2 = _clamp(mc2)
    gi = ws2[:, None] + torch.arange(Wb2, dtype=_I32,
                                     device=mc2.device)[None, :]
    inblk = ((gi >= (bstar * BM)[:, None])
             & (gi < ((bstar + 1) * BM)[:, None]) & (gi < ref_len))
    hit = inblk & (m2 == score2[:, None])
    fk = _first(hit)
    return torch.gather(gi, 1, fk.long()[:, None])[:, 0]
