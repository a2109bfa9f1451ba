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

Every cell's inputs are staged on its device before any forward is
queued, and every forward before any result is read, so that on distinct
cards the cells' forwards run at once: a copy between two cards runs on
the source card's stream, and a copy queued behind the home cell's forward
would hold the other cards' forwards back until it ends.  For the same
reason the suboptimal scans' inputs are copied before any scan is queued,
and the home card's scan is queued last.  The per-cell candidates are
gathered on mesh.devices[0, 0].  Each cell's (Bl,
halo + C) int16 maxima stay where they were computed, and live until the
global best hit is known; the suboptimal scan reduces them in int16 and in
row chunks (scan_sw.second_best_batch), so no (Bl, C) int32 copy is made.

Spans and counts (profiling): `dist.launch` (the uploads and the D x S
forward enqueues), `dist.merge` (the gathers, the best-hit merge, the
suboptimal scans and their merge; enqueues only, the caller's download
waits), `shard_forwards` (one per cell's forward) and `peer_bytes` (bytes
copied between two distinct devices: 0 on a mesh of one device).
"""

from __future__ import annotations

import torch

from ssw_tpu_torch import profiling
from ssw_tpu_torch.ops import cuda_sw, scan_sw

INT_MAX = 2 ** 31 - 1


def _move(x, dev):
    """x on dev without blocking the host; a copy between two distinct
    devices adds its bytes to the `peer_bytes` count (any other adds 0)."""
    profiling.count("peer_bytes", x.numel() * x.element_size()
                    if x.device != dev else 0)
    return x.to(dev, non_blocking=True)


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

    with profiling.span("dist.launch"):
        # stage every cell's inputs, then queue every forward
        staged = []
        for d in range(D):
            rows = slice(d * Bl, (d + 1) * Bl)
            for s in range(S):
                dev = mesh.devices[d, s]
                start = s * C  # first owned global column
                put = lambda x: _move(x[rows], dev)
                # global column index of each local column; warm-up gets
                # idx < start
                idxs = (torch.arange(halo + C, dtype=torch.int32,
                                     device=dev) + (start - halo))
                staged.append((
                    put(profile), _move(ref_ext[start:start + halo + C], dev),
                    idxs, idxs >= start, put(read_len), put(col_mask),
                    put(seg_id), put(seg_start)))
        cells = [list(cuda_sw.forward_shared_gated(
            *args, gapO, gapE, quirk, max_sub=max_sub, gate=gate))
            for args in staged]
        profiling.count("shard_forwards", len(cells))

    with profiling.span("dist.merge"):
        outs = []
        for d in range(D):
            rows = slice(d * Bl, (d + 1) * Bl)
            mine = cells[d * S:(d + 1) * S]
            # merge the best hit over seq: (score desc, end_ref asc),
            # payload end_read
            gather = lambda k: torch.stack([_move(c[k], home) for c in mine])
            g_score, g_end_ref, win = _merge_best(gather(0), gather(1))
            g_end_read = gather(2)[win, torch.arange(Bl, device=home)]
            # suboptimal scan on each cell's owned columns against the
            # global window: the scan over global columns start.. equals
            # the scan over local columns 0.. with every edge shifted by
            # start.  Every cell's window inputs are copied before any
            # scan is queued, and the home card's scan is queued last: a
            # copy queued on the home stream behind a scan would hold the
            # other cards' scans back until that scan ends.
            devs = [mesh.devices[d, s] for s in range(S)]
            window = [(_move(g_end_ref, dev) - s * C,
                       _move(mask_len[rows], dev),
                       _move(word_mask[rows], dev))
                      for s, dev in enumerate(devs)]
            found = [None] * S
            for s in sorted(range(S), key=lambda s: devs[s] == home):
                end, ml, wm = window[s]
                s2, i2 = scan_sw.second_best_batch(
                    mine[s][3][:, halo:], end, ml, ref_len - s * C, wm)
                mine[s][3] = None  # the maxima are read; free them
                found[s] = (s2, i2 + s * C)
            s2_g = [_move(s2, home) for s2, _ in found]
            i2_g = [_move(i2, home) for _, i2 in found]
            score2, i2_best, _ = _merge_best(torch.stack(s2_g),
                                             torch.stack(i2_g))
            ref_end2 = torch.where(score2 > 0, i2_best, 0)
            no2 = _move(mask_len[rows], home) < 15
            score2 = torch.where(no2, 0, score2)
            ref_end2 = torch.where(no2, -1, ref_end2)
            outs.append((g_score, g_end_ref, g_end_read, score2, ref_end2))
        return tuple(torch.cat([o[k] for o in outs]) for k in range(5))
