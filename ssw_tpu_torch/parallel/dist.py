"""Distributed forward pass: data-parallel reads x sequence-parallel target.

The PyTorch counterpart of the JAX package's parallel/dist.py (its
shard_map becomes a loop over the mesh's cells):

  * reads are split over the `data` axis (no communication until the
    results are gathered);
  * the target is split over the `seq` axis: cell (d, s) runs the DP over
    its own C = R/S columns.  Column state depends on every earlier column,
    but a positive-score alignment spans at most `halo` columns (the bound
    of pipeline._window_len), so each cell first re-computes `halo` warm-up
    columns and its owned columns are then exact.  The forward kernel's
    owned-column mode (ops/cuda_sw.forward_shared_gated) keeps the warm-up
    columns out of the best hit and reports global column indices;
  * the best hit is merged over `seq` with the reference's tie-break (first
    column wins, ref: src/ssw.c:327-334): score descending, then index
    ascending;
  * the suboptimal score is a masked max over each cell's owned per-column
    maxima against the *global* best hit's window, with the single-device
    scan's window and tie semantics (ref: src/ssw.c:368-381), merged the
    same way.

Every cell's forward launch is queued before any result is read; the
per-cell candidates are gathered on mesh.devices[0, 0].  Each cell's (Bl,
halo + C) int16 maxima stay where they were computed, and live until the
global best hit is known; the suboptimal scan reduces them in int16 and in
row chunks (scan_sw.second_best_batch), so no (Bl, C) int32 copy is made.
"""

from __future__ import annotations

import torch

from ssw_tpu_torch.ops import cuda_sw, scan_sw

INT_MAX = 2 ** 31 - 1


def _merge_best(score_g, idx_g):
    """Reduce gathered (S, B) candidates by (score desc, idx asc), the
    reference's first-strict-max column tie-break.  Returns (best_score
    (B,), best_idx (B,), winner_row (B,), the S-index of the winner)."""
    best = score_g.amax(dim=0)
    cand = score_g == best[None, :]
    idx_best = torch.where(cand, idx_g, INT_MAX).amin(dim=0)
    # argmax takes no bool; on ties it returns the first maximum
    row = torch.argmax((cand & (idx_g == idx_best[None, :])).to(torch.int32),
                       dim=0)
    return best, idx_best, row


def sharded_forward(mesh, profile, ref_ext, read_len, col_mask, seg_id,
                    seg_start, gapO: int, gapE: int, mask_len, ref_len: int,
                    halo: int, quirk: bool = True, word_mask=None,
                    max_sub: int | None = None, gate=None):
    """Forward pass + suboptimal scan over a (data, seq) mesh.

    profile (B, n1, L) int8 with B divisible by the mesh's data size;
    ref_ext (halo + R,) int32 target codes, `halo` virtual-letter columns
    prepended (R divisible by the seq size); read_len (B,) int32,
    col_mask/seg_id/seg_start (B, L) as forward_shared takes them; mask_len
    (B,) int32; word_mask (B,) bool selects the word-tier suboptimal window
    edge (ref: src/ssw.c:578 scans i = edge, byte scans i = edge+1, :376).
    max_sub/gate: forward_shared's (the int16 tier, the bounded-radius
    gate).  Returns (score, end_ref, end_read, score2, ref_end2), each (B,)
    int32 on mesh.devices[0, 0]."""
    D, S = mesh.shape["data"], mesh.shape["seq"]
    B = int(profile.shape[0])
    R = int(ref_ext.shape[0]) - halo
    if B % D or R % S:
        raise ValueError(f"B = {B} over data = {D}, R = {R} over seq = {S}: "
                         f"not divisible")
    Bl, C = B // D, R // S
    home = mesh.devices[0, 0]
    mask_len = torch.as_tensor(mask_len, dtype=torch.int32).to(
        profile.device)
    if word_mask is None:
        word_mask = torch.zeros(B, dtype=torch.bool, device=profile.device)
    word_mask = torch.as_tensor(word_mask, dtype=torch.bool).to(
        profile.device)

    # queue every cell's forward launch before reading any result
    cells = []
    for d in range(D):
        rows = slice(d * Bl, (d + 1) * Bl)
        for s in range(S):
            dev = mesh.devices[d, s]
            start = s * C  # first owned global column
            put = lambda x: x[rows].to(dev, non_blocking=True)
            # global column index of each local column; warm-up gets
            # idx < start
            idxs = (torch.arange(halo + C, dtype=torch.int32, device=dev)
                    + (start - halo))
            owned = idxs >= start
            cells.append(list(cuda_sw.forward_shared_gated(
                put(profile), ref_ext[start:start + halo + C].to(dev),
                idxs, owned, put(read_len), put(col_mask), put(seg_id),
                put(seg_start), gapO, gapE, quirk, max_sub=max_sub,
                gate=gate)))

    outs = []
    for d in range(D):
        rows = slice(d * Bl, (d + 1) * Bl)
        mine = cells[d * S:(d + 1) * S]
        # merge the best hit over seq: (score desc, end_ref asc), payload
        # end_read
        gather = lambda k: torch.stack([c[k].to(home) for c in mine])
        g_score, g_end_ref, win = _merge_best(gather(0), gather(1))
        g_end_read = gather(2)[win, torch.arange(Bl, device=home)]
        # suboptimal scan on each cell's owned columns against the global
        # window: the scan over global columns start.. equals the scan over
        # local columns 0.. with every edge shifted by start
        s2_g, i2_g = [], []
        for s, cell in enumerate(mine):
            dev = mesh.devices[d, s]
            start = s * C
            s2, i2 = scan_sw.second_best_batch(
                cell[3][:, halo:], g_end_ref.to(dev) - start,
                mask_len[rows].to(dev), ref_len - start,
                word_mask[rows].to(dev))
            cell[3] = None  # the maxima are read; free them
            s2_g.append(s2.to(home))
            i2_g.append((i2 + start).to(home))
        score2, i2_best, _ = _merge_best(torch.stack(s2_g),
                                         torch.stack(i2_g))
        ref_end2 = torch.where(score2 > 0, i2_best, 0)
        no2 = mask_len[rows].to(home) < 15
        score2 = torch.where(no2, 0, score2)
        ref_end2 = torch.where(no2, -1, ref_end2)
        outs.append((g_score, g_end_ref, g_end_read, score2, ref_end2))
    return tuple(torch.cat([o[k] for o in outs]) for k in range(5))
